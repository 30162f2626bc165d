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

Ported: the shearing box (the MRI, ideal or stratified). Snapshots gather
the blocks onto rank 0, which fills the ghosts at the current time (the
sheared fill) and writes with io/vtk.py and io/hdf5.py: JAX's path for
``[output] gatherOutput`` and ``ghostIncluded``, which both shipped MRI
``[mpi]`` inputs take. JAX's per-piece writers (io/sharded.py) are not
ported and raise (ROADMAP Queue 1 item 7). The perf report counts global
cells.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..config.configmap import ConfigMap
from ..config.params import RunParams, params_from_config
from ..io.hdf5 import output_hdf5
from ..io.vtk import output_vtk
from ..parallel.mesh import init_process_group, topology_from_config, validate_decomposition
from ..parallel.sharded_step import (ROADMAP_ITEM, gather_global_state, make_sharded_advance_n,
                                     require_sharded_scope, shard_global_state)
from ..problems import init_problem
from ..utils.timer import Timer
from .run import _UNPORTED_FLAGS, Run
from .shear import make_all_boundaries_shear


class DistributedRun(Run):
    """Run over the ranks of a torch.distributed world: ``self.U`` is this
    rank's interior block [8, lnz, lny, lnx] on its device. Joins the world
    from the environment (parallel/mesh.py init_process_group)."""

    def __init__(self, config: ConfigMap, device, params: RunParams | None = None):
        self.config = config
        self.params = p = params or params_from_config(config)
        topo = topology_from_config(config)
        validate_decomposition(p, *topo)
        require_sharded_scope(p, device, config)
        for section, key in _UNPORTED_FLAGS:
            if config.get_bool(section, key, False):
                raise NotImplementedError(f"[{section}] {key} is not ported")
        self.output_dir = config.get_string("output", "outputDir", "./")
        self.output_prefix = config.get_string("output", "outputPrefix", "output")
        self.output_vtk = config.get_bool("output", "outputVtk", True)
        self.output_hdf5 = config.get_bool("output", "outputHdf5", False)
        self.ghost_included = config.get_bool("output", "ghostIncluded", False)
        gather = config.get_bool("output", "gatherOutput", False) or self.ghost_included
        if (self.output_vtk or self.output_hdf5) and not gather:
            raise NotImplementedError(
                "the per-piece VTK / HDF5 writers of a distributed run (io/sharded.py) are not "
                f"ported; [output] gatherOutput=yes or ghostIncluded=yes gathers ({ROADMAP_ITEM})")
        self.n_log = config.get_integer("run", "nlog", 0)
        self.t = 0.0
        self.n_step = 0
        self.io_timer = Timer()

        self.grid = init_process_group(device, topo)
        self.device = self.grid.device
        self.U = shard_global_state(p, self.grid, init_problem(p, config))
        self._advance = make_sharded_advance_n(p, self.grid, config)

    @property
    def is_root(self) -> bool:
        return self.grid.rank == 0

    def _host_ghosted(self) -> torch.Tensor | None:
        """The ghosted global state on rank 0 (CPU): the gathered interior,
        its ghosts filled at the current time by the sheared fill (JAX
        run_distributed.py:253-265); None on the other ranks. Every rank
        must call it (a gather)."""
        glob = gather_global_state(self.params, self.grid, self.U)
        if glob is None:
            return None
        g = self.params.ghost_width
        Ug = torch.nn.functional.pad(glob, (g, g) * 3)
        return make_all_boundaries_shear(self.params, Ug, torch.tensor(self.t, dtype=glob.dtype))

    def output(self) -> None:
        """VTK and/or HDF5 snapshots of the gathered state, written by
        rank 0 (every rank takes part in the gather)."""
        if not (self.output_vtk or self.output_hdf5):
            return
        with self.io_timer:
            Ug = self._host_ghosted()
            if Ug is None:
                return
            U_host = Ug.numpy()
            kw = dict(output_dir=self.output_dir, prefix=self.output_prefix,
                      ghost_included=self.ghost_included)
            if self.output_vtk:
                output_vtk(self.params, U_host, self.n_step, **kw)
            if self.output_hdf5:
                output_hdf5(self.params, U_host, self.n_step, total_time=self.t, **kw)

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
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall.stop()
        if do_output:
            self.output()
        if self.is_root:
            print(self.perf_summary(wall.total))

    def perf_summary(self, elapsed: float) -> str:
        """Global cells/s, then the process grid and per-rank throughput
        (the reference prints per rank, then the aggregate,
        HydroRunGodunovMpi.cpp:3834-3839)."""
        p = self.params
        n_ranks = self.grid.mx * self.grid.my * self.grid.mz
        n_cells = p.nx * p.ny * p.nz
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
