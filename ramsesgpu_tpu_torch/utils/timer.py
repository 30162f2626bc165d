"""Wall-clock timers and the end-of-run performance report.

Equivalent of the reference's monitoring utilities
(reference: src/utils/monitoring/Timer.h:24-49, CudaTimer.h:18-58, and the
report of HydroRunGodunov.cpp:4030-4075). Device timing uses
``block_until_ready`` around jitted calls — the TPU analogue of cudaEvent
bracketing.

The port's own copy of ramsesgpu_tpu/utils/timer.py: the port imports nothing of
the JAX package.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class Timer:
    total: float = 0.0
    _start: float | None = None

    def start(self) -> None:
        self._start = time.perf_counter()

    def stop(self) -> float:
        if self._start is None:
            return self.total
        elapsed = time.perf_counter() - self._start
        self.total += elapsed
        self._start = None
        return self.total

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()


@dataclass
class PhaseTimers:
    """Named phase timers for the per-phase % report
    (HydroRunGodunov.cpp:4056-4062)."""

    timers: dict[str, Timer] = field(default_factory=dict)

    def __getitem__(self, name: str) -> Timer:
        return self.timers.setdefault(name, Timer())

    def report(self, total: float) -> str:
        lines = []
        for name, t in self.timers.items():
            pct = 100.0 * t.total / total if total > 0 else 0.0
            lines.append(f"  {name:<20s} : {t.total:9.3f} s ({pct:5.1f} %)")
        return "\n".join(lines)


def perf_report(
    n_steps: int,
    n_cells: int,
    elapsed: float,
    io_time: float = 0.0,
    phases: PhaseTimers | None = None,
) -> str:
    """The reference's canonical throughput metric: cell updates per second
    based on wall time minus I/O (HydroRunGodunov.cpp:4068-4073)."""
    compute = max(elapsed - io_time, 1e-30)
    ups = n_steps * n_cells / compute
    lines = [
        f"total wall time        : {elapsed:.3f} s (I/O {io_time:.3f} s)",
        f"number of time steps   : {n_steps}",
        f"cell updates per second: {ups:.4e} (based on wall time minus I/O)",
    ]
    if phases is not None:
        lines.append("per-phase breakdown:")
        lines.append(phases.report(elapsed))
    return "\n".join(lines)
