"""Simulation driver: time loop, snapshots, checkpoint / restart, the
numerics guard (the port's counterpart of ramsesgpu_tpu/solvers/run.py:26-330;
reference HydroRunGodunov.cpp:3857-4079).

The hot loop is a chunk of device work per output interval with one host
sync per chunk; the host orchestrates output and logging. The turbulence
problems run the forced loop (solvers/step.py make_forced_chain; JAX
run.py:92-116), whose OU forcing state is written beside each output
(JAX run.py:178-185); ``[history] enabled`` appends a sample after each
chunk, every ``dtHist`` of simulated time (io/history.py; JAX
run.py:65-71, 289-300).

Snapshots (JAX run.py:41-52, 166-225): VTK, HDF5, NetCDF (``[output]
outputNetcdf4`` or ``outputNetcdf``), PNG, NRRD, XSM (2D), BIN and the
face dumps, all from one host copy of the ghosted state. The JAX package
reads neither ``outputPnetcdf`` nor the ``[debug]`` hdf5 / vtk /
ghostIncluded keys, and the port follows it.

``[run] restart`` (JAX run.py:80-84, 102-115) loads the checkpoint
(io/restart.py: the state, t and the step), fills the ghosts and reloads
the OU forcing state ``<prefix>_forcing_<step>.npz`` when it exists. The
loop state is packed from the loaded state, as at any start, so a
compensated run resumes with a zero Kahan carry (as the JAX package's).

``[structureFunctions] enabled`` (JAX run.py:57, 226-229): at each
output the structure functions of the state on the run's device
(analysis/structure_functions.py), ``<prefix>_sf_<step>.npz``.

``[run] fpe_check`` or ``[debug] dumpData`` (JAX run.py:59-61, 278-288):
after each chunk utils/guard.py check_finite on the state, on its device;
on failure the state and its primitives are dumped (where h5py is
installed) and the NumericsError reaches the caller.
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..analysis.structure_functions import structure_functions_online
from ..config.configmap import ConfigMap
from ..config.params import RunParams, params_from_config
from ..convert import torch_dtype
from ..core.constants import var_names
from ..io.hdf5 import output_hdf5
from ..io.history import HistoryWriter, compute_history
from ..io.misc_formats import output_faces, write_bin, write_nrrd, write_xsm
from ..io.netcdf import output_netcdf
from ..io.png import output_png
from ..io.restart import load_restart
from ..io.vtk import output_vtk
from ..ops.forcing import OUForcing, load_ou_forcing, save_ou_forcing
from ..problems import init_problem
from ..utils.guard import NumericsError, check_finite, dump_debug_state
from ..utils.timer import Timer, perf_report
from .boundary import make_boundaries
from .step import is_forced, make_forced_chain, make_packed_advance_chain, require_slice

# INI switches of the JAX Run that the port does not implement, and the
# ROADMAP item that holds each
_UNPORTED_FLAGS = (
    ("output", "outputZarr", "ROADMAP Queue 1 item 8: the JAX writer needs tensorstore"),
)


def refuse_unported(config: ConfigMap) -> None:
    """Raise NotImplementedError for an INI switch of _UNPORTED_FLAGS."""
    for section, key, item in _UNPORTED_FLAGS:
        if config.get_bool(section, key, False):
            raise NotImplementedError(f"[{section}] {key} is not ported ({item})")


class OutputSettings:
    """The ``[output]`` switches of a run (HydroParameters.h:455-489) and
    the writers of a snapshot of the ghosted state on the host."""

    def __init__(self, config: ConfigMap) -> None:
        self.output_dir = config.get_string("output", "outputDir", "./")
        self.output_prefix = config.get_string("output", "outputPrefix", "output")
        self.output_vtk = config.get_bool("output", "outputVtk", True)
        self.output_hdf5 = config.get_bool("output", "outputHdf5", False)
        # the reference's outputNetcdf4 (HydroParameters.h:470), or the MPI
        # side's spelling outputNetcdf
        self.output_netcdf = (config.get_bool("output", "outputNetcdf4", False)
                              or config.get_bool("output", "outputNetcdf", False))
        self.output_png = config.get_bool("output", "outputPng", False)
        self.output_nrrd = config.get_bool("output", "outputNrrd", False)
        self.output_xsm = config.get_bool("output", "outputXsm", False)
        self.output_bin = config.get_bool("output", "outputBin", False)
        self.output_faces = config.get_bool("output", "outputFaces", False)
        self.ghost_included = config.get_bool("output", "ghostIncluded", False)

    def any_snapshot(self) -> bool:
        return any((self.output_vtk, self.output_hdf5, self.output_netcdf, self.output_png,
                    self.output_nrrd, self.output_xsm, self.output_bin, self.output_faces))

    def write_snapshots(self, params: RunParams, U_host: np.ndarray, n_step: int,
                        t: float, skip: tuple = ()) -> None:
        """Every snapshot format switched on, but those named in ``skip``
        ("vtk", "hdf5", "netcdf"), of the ghosted state U_host (numpy),
        with the JAX Run.output's file names."""
        g = params.ghost_width
        inner = (slice(g, -g),) * params.dim
        stem = f"{self.output_dir}/{self.output_prefix}"
        kw = dict(output_dir=self.output_dir, prefix=self.output_prefix,
                  ghost_included=self.ghost_included)
        if self.output_vtk and "vtk" not in skip:
            output_vtk(params, U_host, n_step, **kw)
        if self.output_hdf5 and "hdf5" not in skip:
            output_hdf5(params, U_host, n_step, total_time=t, **kw)
        if self.output_netcdf and "netcdf" not in skip:
            os.makedirs(self.output_dir, exist_ok=True)
            output_netcdf(params, U_host, n_step, f"{stem}_{n_step:07d}.nc", total_time=t,
                          ghost_included=self.ghost_included)
        if self.output_png:
            output_png(params, U_host, n_step, self.output_dir, self.output_prefix)
        if self.output_nrrd or self.output_xsm or self.output_bin or self.output_faces:
            os.makedirs(self.output_dir, exist_ok=True)
            for i, name in enumerate(var_names(params.nb_var)):
                if self.output_nrrd:
                    write_nrrd(f"{stem}_{name}_{n_step:07d}.nrrd", U_host[i][inner])
                if self.output_xsm and params.dim == 2:
                    write_xsm(f"{stem}_{name}_{n_step:07d}.xsm", U_host[i][inner])
            if self.output_bin:
                write_bin(f"{stem}_{n_step:07d}.bin", U_host[(slice(None),) + inner])
            if self.output_faces:
                output_faces(params, U_host, n_step, self.output_dir, self.output_prefix)


def guard_failed(params: RunParams, config: ConfigMap, U_g, n_step: int, output_dir: str) -> None:
    """After check_finite raised on the ghosted state U_g: dump it
    (utils/guard.py dump_debug_state, the JAX Run's dt of 0.0) where h5py
    is installed, saying on stderr when the dump is not written; the
    caller re-raises the NumericsError."""
    try:
        dump_debug_state(params, config, U_g, 0.0, n_step, output_dir)
    except Exception as exc:  # the guard's own error is what the caller gets
        print(f"numerics guard: debug dump not written ({exc!r})", file=sys.stderr)


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
        self.require_scope()
        refuse_unported(config)
        topo = tuple(config.get_integer("mpi", k, 1) for k in ("mx", "my", "mz"))
        if topo != (1, 1, 1):
            raise NotImplementedError(f"[mpi] distributed runs are not ported {topo}")

        self.out = OutputSettings(config)
        self.output_dir, self.output_prefix = self.out.output_dir, self.out.output_prefix
        self.ghost_included = self.out.ghost_included
        self.n_log = config.get_integer("run", "nlog", 0)
        # the numerics guard (the FPE-trap / debug-dump successor)
        self.fpe_check = (config.get_bool("run", "fpe_check", False)
                          or config.get_bool("debug", "dumpData", False))
        self.sf_enabled = config.get_bool("structureFunctions", "enabled", False)

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

        restart = config.get_bool("run", "restart", False)
        if restart:
            U0, self.t, self.n_step = load_restart(self.params, config)
        else:
            U0 = init_problem(self.params, config)
        U0 = torch.from_numpy(U0).to(device=self.device, dtype=torch_dtype(self.params))
        self.U = make_boundaries(self.params, U0)
        self.forcing = None  # the turbulence problems' forcing, its state on the device
        self._S = None  # the chained loop state while start() runs
        self.build_loop(restart)

    def require_scope(self) -> None:
        """Raise for a configuration outside the port's loops (a forced run
        ignores [implementation] compensated, as the JAX one)."""
        require_slice(self.params.replace(compensated=False) if is_forced(self.params)
                      else self.params, self.device, self.config)

    def build_loop(self, restart: bool) -> None:
        """The chained loop (and the forcing of a turbulence problem,
        reloaded on restart)."""
        if is_forced(self.params):
            self._chain, self.forcing = make_forced_chain(self.params, self.device, self.config)
            if restart:
                self.reload_forcing()
        else:
            self._chain = make_packed_advance_chain(self.params, self.device, self.config)

    def forcing_path(self) -> str:
        """The OU forcing state's checkpoint beside the step's snapshot."""
        return f"{self.output_dir}/{self.output_prefix}_forcing_{self.n_step:07d}.npz"

    def reload_forcing(self) -> None:
        """On restart, the OU forcing state of the restart's step where its
        checkpoint exists (JAX run.py:102-115), on the run's device."""
        if isinstance(self.forcing, OUForcing) and os.path.exists(self.forcing_path()):
            self.forcing.state = load_ou_forcing(self.forcing_path(), self.device,
                                                 torch_dtype(self.params))

    def _host_ghosted(self) -> torch.Tensor:
        """The ghosted state for host-facing consumers; while start() runs
        chained it is unpacked from the loop state (which stays untouched)."""
        if self._S is not None:
            t = torch.tensor(self.t, dtype=self.U.dtype, device=self.device)
            return self._chain[2](self._S, t)
        return self.U

    def output(self) -> None:
        """The snapshots switched on (OutputSettings), the structure
        functions (``[structureFunctions] enabled``: computed on the run's
        device, ``<prefix>_sf_<step>.npz``) and the OU forcing state's
        checkpoint (``<prefix>_forcing_<step>.npz``)."""
        with self.io_timer:
            U_g = self._host_ghosted() if self.out.any_snapshot() or self.sf_enabled else None
            if self.out.any_snapshot():
                self.out.write_snapshots(self.params, U_g.cpu().numpy(), self.n_step, self.t)
            if self.sf_enabled:
                structure_functions_online(self.params, self.config, U_g, self.n_step)
            if isinstance(self.forcing, OUForcing):
                save_ou_forcing(self.forcing.state, self.forcing_path())

    def check_numerics(self) -> None:
        """The numerics guard on the current state (utils/guard.py): on
        failure the debug dump, then the NumericsError."""
        U_g = self._host_ghosted()
        try:
            check_finite(self.params, U_g, self.n_step)
        except NumericsError:
            guard_failed(self.params, self.config, U_g, self.n_step, self.output_dir)
            raise

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
                if self.fpe_check:
                    self.check_numerics()
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
