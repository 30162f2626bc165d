"""Simulation driver: time loop, VTK / HDF5 outputs, perf report (the port's
counterpart of ramsesgpu_tpu/solvers/run.py:26-330; reference
HydroRunGodunov.cpp:3857-4079).

The hot loop is a chunk of device work per output interval with one host
sync per chunk; the host orchestrates output and logging. The turbulence
problems run the forced loop (solvers/step.py make_forced_chain; JAX
run.py:92-116), whose OU forcing state is written beside each output
(JAX run.py:178-185); ``[history] enabled`` appends a sample after each
chunk, every ``dtHist`` of simulated time (io/history.py; JAX
run.py:65-71, 289-300). Restart, the numerics guard and the other output
formats are not ported and raise when the INI asks for them.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..config.configmap import ConfigMap
from ..config.params import RunParams, params_from_config
from ..convert import torch_dtype
from ..io.hdf5 import output_hdf5
from ..io.history import HistoryWriter, compute_history
from ..io.vtk import output_vtk
from ..ops.forcing import OUForcing, save_ou_forcing
from ..problems import init_problem
from ..utils.timer import Timer, perf_report
from .boundary import make_boundaries
from .step import is_forced, make_forced_chain, make_packed_advance_chain, require_slice

# INI switches of the JAX Run that the port does not implement
_UNPORTED_FLAGS = (
    ("run", "restart"), ("run", "fpe_check"),
    ("debug", "dumpData"), ("output", "outputPng"),
    ("output", "outputNrrd"), ("output", "outputXsm"), ("output", "outputBin"),
    ("output", "outputFaces"), ("output", "outputNetcdf4"),
    ("output", "outputNetcdf"), ("output", "outputZarr"),
    ("structureFunctions", "enabled"),
)


def config_from_ini(text: str) -> tuple[ConfigMap, RunParams]:
    """The ConfigMap of INI text and its RunParams."""
    config = ConfigMap(text=text)
    return config, params_from_config(config)


class Run:
    """Owns config, state and the output machinery for one simulation on
    ``device``. ``self.U`` is the ghosted state between runs of start()."""

    def __init__(self, config: ConfigMap, device, params: RunParams | None = None):
        self.config = config
        self.params = params or params_from_config(config)
        self.device = torch.device(device)
        # (a forced run ignores [implementation] compensated, as the JAX one)
        require_slice(self.params.replace(compensated=False) if is_forced(self.params)
                      else self.params, self.device, config)
        for section, key in _UNPORTED_FLAGS:
            if config.get_bool(section, key, False):
                raise NotImplementedError(f"[{section}] {key} is not ported")
        topo = tuple(config.get_integer("mpi", k, 1) for k in ("mx", "my", "mz"))
        if topo != (1, 1, 1):
            raise NotImplementedError(f"[mpi] distributed runs are not ported {topo}")

        self.output_dir = config.get_string("output", "outputDir", "./")
        self.output_prefix = config.get_string("output", "outputPrefix", "output")
        self.output_vtk = config.get_bool("output", "outputVtk", True)
        self.output_hdf5 = config.get_bool("output", "outputHdf5", False)
        self.ghost_included = config.get_bool("output", "ghostIncluded", False)
        self.n_log = config.get_integer("run", "nlog", 0)

        # history ([history] section, HydroRunBase.cpp:7235+)
        self._history_writer = None
        self.dt_hist = config.get_float("history", "dtHist", 0.0)
        self._next_hist_time = 0.0
        if config.get_bool("history", "enabled", False):
            self._history_writer = HistoryWriter(self.params, self.output_dir,
                                                 self.output_prefix)

        self.t = 0.0
        self.n_step = 0
        self.io_timer = Timer()

        U0 = torch.from_numpy(init_problem(self.params, config))
        U0 = U0.to(device=self.device, dtype=torch_dtype(self.params))
        self.U = make_boundaries(self.params, U0)
        self.forcing = None  # the turbulence problems' forcing, its state on the device
        if is_forced(self.params):
            self._chain, self.forcing = make_forced_chain(self.params, self.device, config)
        else:
            self._chain = make_packed_advance_chain(self.params, self.device, config)
        self._S = None  # the chained loop state while start() runs

    def _host_ghosted(self) -> torch.Tensor:
        """The ghosted state for host-facing consumers; while start() runs
        chained it is unpacked from the loop state (which stays untouched)."""
        if self._S is not None:
            t = torch.tensor(self.t, dtype=self.U.dtype, device=self.device)
            return self._chain[2](self._S, t)
        return self.U

    def output(self) -> None:
        """VTK and/or HDF5 snapshots, and the OU forcing state's checkpoint
        (``<prefix>_forcing_<step>.npz``)."""
        with self.io_timer:
            if self.output_vtk or self.output_hdf5:
                U_host = self._host_ghosted().cpu().numpy()
                kw = dict(output_dir=self.output_dir, prefix=self.output_prefix,
                          ghost_included=self.ghost_included)
                if self.output_vtk:
                    output_vtk(self.params, U_host, self.n_step, **kw)
                if self.output_hdf5:
                    output_hdf5(self.params, U_host, self.n_step, total_time=self.t, **kw)
            if isinstance(self.forcing, OUForcing):
                save_ou_forcing(self.forcing.state, f"{self.output_dir}/{self.output_prefix}"
                                                    f"_forcing_{self.n_step:07d}.npz")

    def start(self, max_steps: int | None = None, do_output: bool = True) -> None:
        """Run to t_end / nstepmax, writing output every noutput steps."""
        p = self.params
        n_stepmax = p.n_stepmax if max_steps is None else min(p.n_stepmax, max_steps)
        n_output = p.n_output
        t_dev = torch.tensor(self.t, dtype=self.U.dtype, device=self.device)
        wall = Timer()
        wall.start()
        self._S = self._chain[0](self.U)
        try:
            while self.n_step < n_stepmax and (p.t_end <= 0 or self.t < p.t_end):
                if do_output and n_output > 0 and self.n_step % n_output == 0:
                    self.output()
                if n_output > 0:
                    chunk = min(n_output - self.n_step % n_output, n_stepmax - self.n_step)
                else:
                    chunk = n_stepmax - self.n_step
                self._S, t_dev, k = self._chain[1](self._S, t_dev, chunk)
                k = int(k)  # the one host sync per chunk
                self.t = float(t_dev)
                self.n_step += k
                if k == 0:
                    break  # t_end reached exactly
                if self.n_log > 0 and self.n_step % self.n_log == 0:
                    print(f"step {self.n_step:7d}  t={self.t:.6f}", file=sys.stderr)
                if self._history_writer is not None and (
                        self.dt_hist <= 0 or self.t >= self._next_hist_time):
                    sample = compute_history(p, self._host_ghosted(), self.t, 0.0)
                    with self.io_timer:
                        self._history_writer.append(sample)
                    if self.dt_hist > 0:
                        while self._next_hist_time <= self.t:
                            self._next_hist_time += self.dt_hist
        finally:
            # leave the chained loop state even when a chunk raised, so the
            # ghosted-state contract (self.U) holds afterwards
            self.U = self._host_ghosted()
            self._S = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall.stop()
        if do_output:
            self.output()
        print(self.perf_summary(wall.total))

    def perf_summary(self, elapsed: float) -> str:
        p = self.params
        return perf_report(self.n_step, p.nx * p.ny * p.nz, elapsed,
                           io_time=self.io_timer.total)

    def interior(self) -> np.ndarray:
        """Ghost-stripped conserved state on the host."""
        g = self.params.ghost_width
        return self.U[(slice(None),) + (slice(g, -g),) * self.params.dim].cpu().numpy()
