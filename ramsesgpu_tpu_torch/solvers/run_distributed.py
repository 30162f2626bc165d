"""The distributed run: one process per rank over
torch.distributed (the port's counterpart of
ramsesgpu_tpu/solvers/run_distributed.py:40-277; reference
HydroRunGodunovMpi.cpp, MHDRunGodunovMpi.cpp, euler_mpi_main.cpp).

The same INI drives it: ``[mpi] mx, my, mz`` select the process grid
(HydroMpiParameters.cpp:59-69), and ``[mesh] nx, ny, nz`` are the GLOBAL
mesh, as JAX ``params_from_config`` reads them (the reference's comment
says "for each MPI process"). Every rank builds the same initial state
(the inits are deterministic) and keeps its own interior block; the loop
is parallel/sharded_step.py's. The distributed path never reads
``[implementation] compensated``, as the JAX one does not: the state is
plain.

Ported: the shearing box (the MRI, ideal or stratified) and the
periodic, walled and jet runs in 2D and 3D, hydro and MHD (with static
gravity; in 3D with nu or eta; parallel/sharded_step.py), and the
turbulence problems: the ranks' loop takes the forcing after each step
and keeps the forcing object across chunks (JAX run_distributed.py:62-69);
rank 0 writes the OU mode state beside each output as
``<prefix>_forcing_<step>.npz`` (JAX :179-188). ``[history] enabled``:
after each chunk, every ``dtHist`` of simulated time, every rank takes
part in the gather of ``_host_ghosted`` and rank 0 alone computes the
sample (io/history.py) and appends it (JAX run.py:290-300 through its
``_host_ghosted``, run_distributed.py:244-277). With ``[output] gatherOutput`` or
``ghostIncluded`` the snapshots gather the blocks onto rank 0, which fills
the ghosts at the current time (the sheared fill, or make_boundaries with
the jet) and writes every format switched on with the single-device
writers (solvers/run.py OutputSettings); otherwise every rank writes its
VTK piece and rank 0 the ``.pvti`` master, the one global HDF5 file and
the one global NetCDF file, block by block (io/sharded.py), as the JAX run
does (run_distributed.py:107-127 there), and PNG, NRRD, XSM, BIN and the
face dumps are written by rank 0 from the gathered state (JAX
run_distributed.py:131-170: its streamed PNG and faces equal the host
writers', tests/test_io_sharded.py:207). The perf report counts global
cells.

``[structureFunctions] enabled`` (JAX run_distributed.py:171-180): at
each output the sharded structure functions of the ranks' blocks
(analysis/structure_functions.py), written by rank 0.

``[run] restart``: every rank loads the checkpoint (io/restart.py) and
keeps its block, and reloads the OU forcing state where its checkpoint
exists (the JAX Run builds the global state and shards it,
run_distributed.py:40-77 there). The numerics guard (``fpe_check``,
``[debug] dumpData``): after each chunk each rank reduces its block on its
device, one all_reduce joins the flags, and only on failure are the blocks
gathered, rank 0 finds the first bad value of the global state and dumps
it, and every rank raises the JAX package's NumericsError text.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..analysis.structure_functions import structure_functions_online_sharded
from ..config.configmap import ConfigMap
from ..config.params import RunParams, params_from_config
from ..io.history import HistoryWriter, compute_history
from ..io.restart import load_restart
from ..io.sharded import output_hdf5_sharded, output_netcdf_sharded, output_vtk_pieces
from ..kernels.mhd_step import uses_shear
from ..ops.forcing import OUForcing, save_ou_forcing
from ..parallel.mesh import init_process_group, topology_from_config, validate_decomposition
from ..parallel.sharded_step import (gather_global_state, make_sharded_advance_n,
                                     require_sharded_scope, shard_global_state)
from ..problems import init_problem
from ..utils.guard import NumericsError, check_finite, interior_ok
from ..utils.timer import Timer
from .boundary import make_boundaries
from .run import OutputSettings, Run, guard_failed, refuse_unported
from .shear import make_all_boundaries_shear


class DistributedRun(Run):
    """Run over the ranks of a torch.distributed world: ``self.U`` is this
    rank's interior block [nvar, (lnz,) lny, lnx] on its device. Joins the
    world from the environment (parallel/mesh.py init_process_group)."""

    def __init__(self, config: ConfigMap, device, params: RunParams | None = None):
        self.config = config
        self.params = p = params or params_from_config(config)
        topo = topology_from_config(config)
        validate_decomposition(p, *topo)
        require_sharded_scope(p, device, config)
        refuse_unported(config)
        self.out = OutputSettings(config)
        self.output_dir, self.output_prefix = self.out.output_dir, self.out.output_prefix
        self.ghost_included = self.out.ghost_included
        self.gather = config.get_bool("output", "gatherOutput", False) or self.ghost_included
        self.n_log = config.get_integer("run", "nlog", 0)
        self.fpe_check = (config.get_bool("run", "fpe_check", False)
                          or config.get_bool("debug", "dumpData", False))
        self.sf_enabled = config.get_bool("structureFunctions", "enabled", False)
        self.t = 0.0
        self.n_step = 0
        self.io_timer = Timer()

        self.dt_hist = config.get_float("history", "dtHist", 0.0)
        self._next_hist_time = 0.0
        self._history = config.get_bool("history", "enabled", False)
        self._history_writer = None

        self.grid = init_process_group(device, topo)
        self.device = self.grid.device
        if self._history and self.is_root:
            self._history_writer = HistoryWriter(p, self.output_dir, self.output_prefix)
        restart = config.get_bool("run", "restart", False)
        if restart:
            U0, self.t, self.n_step = load_restart(p, config)
        else:
            U0 = init_problem(p, config)
        self.U = shard_global_state(p, self.grid, U0)
        del U0
        self._advance = make_sharded_advance_n(p, self.grid, config)
        self.forcing = self._advance.forcing
        if restart:
            self.reload_forcing()

    @property
    def is_root(self) -> bool:
        return self.grid.rank == 0

    def _host_ghosted(self) -> torch.Tensor | None:
        """The ghosted global state on rank 0 (CPU): the gathered interior,
        its ghosts filled at the current time, by the sheared fill on the
        shearing box, else by make_boundaries (the jet included; JAX
        run_distributed.py:253-265); None on the other ranks. Every rank
        must call it (a gather)."""
        glob = gather_global_state(self.params, self.grid, self.U)
        if glob is None:
            return None
        g = self.params.ghost_width
        Ug = torch.nn.functional.pad(glob, (g, g) * self.params.dim)
        if not uses_shear(self.params):
            return make_boundaries(self.params, Ug)
        return make_all_boundaries_shear(self.params, Ug, torch.tensor(self.t, dtype=glob.dtype))

    def output(self) -> None:
        """The snapshots switched on: of the gathered state, written by rank
        0, with ``gatherOutput`` or ``ghostIncluded``; else each rank's VTK
        piece and the one HDF5 and NetCDF files written block by block
        (io/sharded.py), and the other formats from the gathered state;
        rank 0 the OU forcing state's checkpoint. Every rank takes part."""
        if isinstance(self.forcing, OUForcing) and self.is_root:
            with self.io_timer:
                save_ou_forcing(self.forcing.state, self.forcing_path())
        out, p = self.out, self.params
        with self.io_timer:
            if self.sf_enabled:
                structure_functions_online_sharded(p, self.config, self.grid, self.U,
                                                   self.n_step)
            if not self.gather:
                kw = dict(output_dir=self.output_dir, prefix=self.output_prefix)
                if out.output_vtk:
                    output_vtk_pieces(p, self.grid, self.U, self.n_step, **kw)
                if out.output_hdf5:
                    output_hdf5_sharded(p, self.grid, self.U, self.n_step, total_time=self.t,
                                        **kw)
                if out.output_netcdf:
                    output_netcdf_sharded(p, self.grid, self.U, self.n_step,
                                          total_time=self.t, **kw)
            gathered = (out.output_png or out.output_nrrd or out.output_xsm or out.output_bin
                        or out.output_faces)
            if not (gathered or (self.gather and out.any_snapshot())):
                return
            Ug = self._host_ghosted()
            if Ug is not None:
                out.write_snapshots(p, Ug.numpy(), self.n_step, self.t,
                                    skip=() if self.gather else ("vtk", "hdf5", "netcdf"))

    def check_numerics(self) -> None:
        """The numerics guard: each rank's block reduced on its device, the
        flags joined by one all_reduce; on failure the gathered global state
        checked on rank 0 (utils/guard.py), dumped there, and the
        NumericsError raised on every rank with the JAX package's text."""
        bad = self.grid.all_max((~interior_ok(self.U)).to(torch.int32))
        if not bool(bad):
            return
        Ug = self._host_ghosted()
        message = [None]
        if Ug is not None:
            try:
                check_finite(self.params, Ug, self.n_step)
            except NumericsError as exc:
                message[0] = str(exc)
                guard_failed(self.params, self.config, Ug, self.n_step, self.output_dir)
        if self.grid.mx * self.grid.my * self.grid.mz > 1:
            torch.distributed.broadcast_object_list(message, src=0)
        raise NumericsError(message[0])

    def start(self, max_steps: int | None = None, do_output: bool = True) -> None:
        """Run to t_end / nstepmax, writing output every noutput steps; rank
        0 prints the perf report."""
        p = self.params
        n_stepmax = p.n_stepmax if max_steps is None else min(p.n_stepmax, max_steps)
        n_output = p.n_output
        t_dev = torch.tensor(self.t, dtype=self.U.dtype, device=self.device)
        wall = Timer()
        wall.start()
        while self.n_step < n_stepmax and (p.t_end <= 0 or self.t < p.t_end):
            if do_output and n_output > 0 and self.n_step % n_output == 0:
                self.output()
            if n_output > 0:
                chunk = min(n_output - self.n_step % n_output, n_stepmax - self.n_step)
            else:
                chunk = n_stepmax - self.n_step
            self.U, t_dev, k = self._advance(self.U, t_dev, chunk)
            self.t = float(t_dev)
            self.n_step += k
            if k == 0:
                break  # t_end reached exactly
            if self.is_root and self.n_log > 0 and self.n_step % self.n_log == 0:
                print(f"step {self.n_step:7d}  t={self.t:.6f}", file=sys.stderr)
            if self.fpe_check:
                self.check_numerics()
            if self._history and (self.dt_hist <= 0 or self.t >= self._next_hist_time):
                self.history()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall.stop()
        if do_output:
            self.output()
        if self.is_root:
            print(self.perf_summary(wall.total))

    def history(self) -> None:
        """One history sample of the gathered state, appended by rank 0;
        every rank takes part in the gather and keeps the cadence."""
        Ug = self._host_ghosted()
        if Ug is not None:
            sample = compute_history(self.params, Ug, self.t, 0.0)
            with self.io_timer:
                self._history_writer.append(sample)
        if self.dt_hist > 0:
            while self._next_hist_time <= self.t:
                self._next_hist_time += self.dt_hist

    def perf_summary(self, elapsed: float) -> str:
        """Global cells/s, then the process grid and per-rank throughput
        (the reference prints per rank, then the aggregate,
        HydroRunGodunovMpi.cpp:3834-3839)."""
        p = self.params
        n_ranks = self.grid.mx * self.grid.my * self.grid.mz
        n_cells = p.nx * p.ny * p.nz   # nz = 1 in 2D
        compute = max(elapsed - self.io_timer.total, 1e-30)
        return "\n".join([
            super().perf_summary(elapsed),
            f"process grid           : {self.grid.describe()}",
            f"per-rank throughput    : {self.n_step * n_cells / compute / n_ranks:.4e} "
            f"cell updates/s ({n_cells // n_ranks} cells/rank)",
        ])

    def interior(self) -> np.ndarray | None:
        """The gathered global interior on rank 0 (numpy); None on the
        other ranks. Every rank must call it."""
        glob = gather_global_state(self.params, self.grid, self.U)
        return None if glob is None else glob.numpy()


def cli_rank(argv: list[str]) -> None:
    """One rank of a CLI run that spawned its ranks (cli/main.py)."""
    from ..cli.main import main

    main(argv)
