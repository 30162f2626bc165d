"""The driver of the alternative schemes (split Godunov, Kurganov-Tadmor,
Lax-Liu, relaxing TVD): the port's counterpart of
ramsesgpu_tpu/solvers/run2d_alt.py (reference HydroRunKT / HydroRunLaxLiu
/ HydroRunRelaxingTVD and the --scheme switch, euler_main.cpp:87-118).

A host loop of whole-array steps on the run's device (the JAX package
jits each per-parity step; here each is a plain function of tensors on
the device): KT and Lax-Liu advance by dt = xlambda dx, the split Godunov
and relaxing-TVD steps by the whole-array CFL of the state as it stands
(solvers/timestep.py compute_dt), t read back once a step as in the JAX
loop. The schemes are hydro only and run on one device; relaxing TVD
runs on a ghost width of 3, KT and Lax-Liu in 2D only. The kernel loops'
scope checks (solvers/step.py require_slice) do not apply: no kernel runs.
"""
from __future__ import annotations

import torch

from ..config.configmap import ConfigMap
from ..config.params import params_from_config
from ..utils.timer import Timer, perf_report
from .alt_laxliu import laxliu_step
from .alt_schemes import godunov_split_step, kt_step, relaxing_tvd_step
from .boundary import require_simple_bcs
from .run import Run
from .timestep import compute_dt

SCHEMES = ("godunov-split", "kurganov", "laxliu", "relaxingTVD")


class AltSchemeRun(Run):
    """Run of one alternative scheme on ``device``; ``scheme`` is one of
    SCHEMES (or "split")."""

    def __init__(self, config: ConfigMap, device="cuda", scheme: str = "kurganov"):
        params = params_from_config(config)
        if scheme == "relaxingTVD" and params.ghost_width != 3:
            # the reference forces ghostWidth=3 for relaxing TVD
            # (euler_main.cpp:112-113)
            params = params.replace(ghost_width=3)
        if scheme in ("kurganov", "laxliu") and params.dim != 2:
            raise ValueError(f"scheme {scheme} is 2D only (as in the reference)")
        if scheme not in SCHEMES + ("split",):
            raise ValueError(f"unknown scheme {scheme!r}")
        self.scheme = scheme
        super().__init__(config, device, params)

    def require_scope(self) -> None:
        if self.params.mhd:
            raise ValueError(f"scheme {self.scheme} is hydro only")
        require_simple_bcs(self.params)
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")

    def build_loop(self, restart: bool) -> None:
        self._chain = None

    def advance_fn(self):
        """``advance(U, t, k) -> (U', t')``: step k of the scheme, t a 0-d
        tensor of the state's dtype."""
        p = self.params
        if self.scheme == "kurganov":
            return lambda U, t, k: (kt_step(p, U, k % 2 == 1, p.xlambda, p.ylambda),
                                    t + p.xlambda * p.dx)
        if self.scheme == "laxliu":
            return lambda U, t, k: (laxliu_step(p, U), t + p.xlambda * p.dx)
        step = relaxing_tvd_step if self.scheme == "relaxingTVD" else godunov_split_step

        def advance(U, t, k):
            dt = compute_dt(p, U)
            return step(p, U, dt, k), t + dt

        return advance

    def start(self, max_steps: int | None = None, do_output: bool = True) -> None:
        p = self.params
        n_stepmax = p.n_stepmax if max_steps is None else min(p.n_stepmax, max_steps)
        n_output = p.n_output
        advance = self.advance_fn()
        wall = Timer()
        wall.start()
        t = torch.tensor(self.t, dtype=self.U.dtype, device=self.device)
        while self.n_step < n_stepmax and (p.t_end <= 0 or self.t < p.t_end):
            if do_output and n_output > 0 and self.n_step % n_output == 0:
                self.output()
            self.U, t = advance(self.U, t, self.n_step)
            self.n_step += 1
            self.t = float(t)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall.stop()
        if do_output:
            self.output()
        n_cells = p.nx * p.ny * (p.nz if p.dim == 3 else 1)
        print(perf_report(self.n_step, n_cells, wall.total, io_time=self.io_timer.total))
