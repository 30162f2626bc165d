"""The process grid of a distributed run over torch.distributed (the port's
counterpart of ramsesgpu_tpu/parallel/mesh.py:1-65 and
parallel/multihost.py; reference MpiCommCart.h:23-114,
HydroMpiParameters.cpp:59-124).

One process per rank. Rank r sits at (iz, iy, ix) of the grid [mz, my,
mx], in the JAX mesh's axis order ('z', 'y', 'x'): r = (iz my + iy) mx +
ix; a 2D run has mz = 1 (iz = 0) and (ny, nx) blocks. Its neighbours on each axis wrap periodically, as the JAX ppermute
rings do; every rank creates one process group per y column (the ranks
that share iz and ix), in the same order, for the shearing box's y
gathers.

The transport rule lives here and nowhere else (``choose_transport``):

- ``nccl`` when the device is CUDA and every rank has a card of its own
  (world_size <= torch.cuda.device_count()), rank r on cuda:r;
- otherwise ``gloo``: several ranks share a card (rank r on cuda:(r mod
  count)), as the reference's "several MPI processes on one GPU" runs do
  (data/mhd_mri_3d_mpi_debug.ini), or the ranks run on the CPU. With a
  CUDA device every exchanged slab is copied to host memory explicitly
  and back (``ProcessGrid.send_form`` / ``local_form``), the reference's
  own GPU+MPI staging through host buffers.

The rule reads device counts only, never a failure.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..config.configmap import ConfigMap
from ..config.params import RunParams

AXES = ("z", "y", "x")   # the JAX mesh's axis order


def topology_from_config(config: ConfigMap) -> tuple[int, int, int]:
    """(mx, my, mz) process-grid sizes from the [mpi] section."""
    return (
        config.get_integer("mpi", "mx", 1),
        config.get_integer("mpi", "my", 1),
        config.get_integer("mpi", "mz", 1),
    )


def validate_decomposition(params: RunParams, mx: int, my: int, mz: int) -> None:
    if params.nx % mx or params.ny % my or (params.dim == 3 and params.nz % mz):
        raise ValueError(
            f"grid {params.nx}x{params.ny}x{params.nz} not divisible by "
            f"topology {mx}x{my}x{mz}"
        )
    g = params.ghost_width
    if params.nx // mx < g or params.ny // my < g or (
        params.dim == 3 and params.nz // mz < g
    ):
        raise ValueError("per-shard block smaller than the ghost width")


def local_params(params: RunParams, grid: "ProcessGrid") -> RunParams:
    """The rank's block as RunParams: its extent, the global origin and
    cell size (JAX sharded_step.py:420-425); in 2D nz stays 1."""
    lnx, lny = params.nx // grid.mx, params.ny // grid.my
    lp = params.replace(nx=lnx, ny=lny, xmax=params.xmin + lnx * params.dx,
                        ymax=params.ymin + lny * params.dy)
    if params.dim == 2:
        return lp
    lnz = params.nz // grid.mz
    return lp.replace(nz=lnz, zmax=params.zmin + lnz * params.dz)


def block_slices(params: RunParams, grid: ProcessGrid, rank: int) -> tuple:
    """The slices of rank ``rank``'s block in the global interior
    [nvar, (nz,) ny, nx]."""
    dim = params.dim
    inner = (params.nz, params.ny, params.nx)[-dim:]
    sizes = (grid.mz, grid.my, grid.mx)[-dim:]
    coords = (rank // (grid.mx * grid.my), (rank // grid.mx) % grid.my, rank % grid.mx)[-dim:]
    return (slice(None),) + tuple(slice(i * (n // m), (i + 1) * (n // m))
                                  for i, n, m in zip(coords, inner, sizes))


def choose_transport(device, world_size: int, rank: int) -> tuple[str, torch.device]:
    """(backend, this rank's device) by the transport rule of the module
    note: device counts only."""
    device = torch.device(device)
    if device.type == "cpu":
        return "gloo", torch.device("cpu")
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("device cuda requested but torch.cuda.device_count() is 0")
    if world_size <= count:
        return "nccl", torch.device("cuda", rank)
    return "gloo", torch.device("cuda", rank % count)


def init_process_group(device, topology: tuple[int, int, int]) -> "ProcessGrid":
    """Join the world described by the environment and build this rank's
    ProcessGrid: ``RANK`` and ``WORLD_SIZE``, and ``RAMSES_DIST_INIT`` (an
    init_method URL such as ``file:///path`` or ``tcp://localhost:port``)
    or else ``MASTER_ADDR`` / ``MASTER_PORT`` (``env://``, as torchrun sets
    them). Raises when WORLD_SIZE is not mx * my * mz."""
    mx, my, mz = topology
    rank = int(os.environ["RANK"])
    world_size = int(os.environ["WORLD_SIZE"])
    if world_size != mx * my * mz:
        raise ValueError(f"WORLD_SIZE {world_size} != mx*my*mz = {mx}*{my}*{mz} "
                         f"of the [mpi] topology")
    backend, dev = choose_transport(device, world_size, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=os.environ.get("RAMSES_DIST_INIT", "env://"),
                                rank=rank, world_size=world_size)
    return ProcessGrid.create(topology, rank, world_size, backend, dev)


@dataclass
class ProcessGrid:
    """This rank's place in the grid [mz, my, mx] and its transport."""

    mx: int
    my: int
    mz: int
    rank: int
    backend: str
    device: torch.device
    y_group: object = None   # this rank's y column's process group (my > 1)

    @classmethod
    def create(cls, topology, rank: int, world_size: int, backend: str, device):
        mx, my, mz = topology
        if world_size != mx * my * mz:
            raise ValueError(f"world size {world_size} != {mx}*{my}*{mz}")
        grid = cls(mx, my, mz, rank, backend, torch.device(device))
        if my > 1:
            # every rank creates every column's group, in the same order
            for iz in range(mz):
                for ix in range(mx):
                    ranks = [grid.rank_of(iz, iy, ix) for iy in range(my)]
                    group = dist.new_group(ranks)
                    if rank in ranks:
                        grid.y_group = group
        return grid

    @property
    def coords(self) -> tuple[int, int, int]:
        """(iz, iy, ix) of this rank."""
        return (self.rank // (self.mx * self.my), (self.rank // self.mx) % self.my,
                self.rank % self.mx)

    def size(self, axis: str) -> int:
        return {"x": self.mx, "y": self.my, "z": self.mz}[axis]

    def index(self, axis: str) -> int:
        return self.coords[AXES.index(axis)]

    def rank_of(self, iz: int, iy: int, ix: int) -> int:
        return (iz * self.my + iy) * self.mx + ix

    def neighbour(self, axis: str, step: int) -> int:
        """The rank ``step`` away along ``axis``, wrapping periodically."""
        c = list(self.coords)
        k = AXES.index(axis)
        c[k] = (c[k] + step) % self.size(axis)
        return self.rank_of(*c)

    @property
    def staged(self) -> bool:
        """Whether exchanged slabs travel through host memory (gloo from a
        CUDA device)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def send_form(self, x: torch.Tensor) -> torch.Tensor:
        """x as the transport sends it: contiguous, in host memory when
        staged."""
        return x.contiguous().cpu() if self.staged else x.contiguous()

    def empty_like(self, x: torch.Tensor) -> torch.Tensor:
        """A receive buffer for a slab shaped like x."""
        return torch.empty(x.shape, dtype=x.dtype,
                           device="cpu" if self.staged else self.device)

    def local_form(self, x: torch.Tensor) -> torch.Tensor:
        """A received slab on this rank's device."""
        return x.to(self.device, non_blocking=False) if self.staged else x

    def all_max(self, x: torch.Tensor) -> torch.Tensor:
        """The max of the 0-d x over every rank (the JAX lax.pmax), on
        this rank's device."""
        if self.mx * self.my * self.mz == 1:
            return x
        buf = self.send_form(x)
        dist.all_reduce(buf, op=dist.ReduceOp.MAX)
        return self.local_form(buf)

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of x over every rank (the JAX lax.psum) in x's dtype, a
        new tensor on this rank's device; x itself on a one-rank grid."""
        if self.mx * self.my * self.mz == 1:
            return x
        buf = self.send_form(x.clone())
        dist.all_reduce(buf, op=dist.ReduceOp.SUM)
        return self.local_form(buf)

    def describe(self) -> str:
        return (f"{self.mx} x {self.my} x {self.mz} ranks over {self.backend}"
                f"{' (slabs staged through host memory)' if self.staged else ''}")


def single_rank_grid(device="cpu") -> ProcessGrid:
    """The grid of a one-rank world (no process group needed)."""
    return ProcessGrid(1, 1, 1, 0, "gloo", torch.device(device))
