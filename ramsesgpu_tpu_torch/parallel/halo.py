"""Halo exchange between ranks: ``torch.distributed`` point-to-point
messages replace the JAX package's ppermute rings
(ramsesgpu_tpu/parallel/halo.py:29-93; reference HydroRunBaseMpi.cpp:
3294-3760, pack -> MPI_Sendrecv -> unpack).

Works on interior-only local blocks: ``attach_halos`` grows the block by
the ghost width along x, then y, then z, each exchange on the block the
previous ones grew, so edge and corner ghosts come from the neighbours'
own ghosts, as in JAX; physical boundary fills then override the ghosts of
the ranks at the global domain's edge. Under the gloo transport from a
CUDA device each slab goes through host memory (parallel/mesh.py).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..config.params import RunParams
from ..core.constants import BoundaryConditionType as BCT
from ..solvers.boundary import _fill_side
from .mesh import ProcessGrid

AXIS_NAME = {-1: "x", -2: "y", -3: "z"}


def _take(U: torch.Tensor, axis: int, sl) -> torch.Tensor:
    idx = [slice(None)] * U.ndim
    idx[axis] = sl
    return U[tuple(idx)]


def exchange(grid: ProcessGrid, axis: str, to_next: torch.Tensor | None,
             to_prev: torch.Tensor | None):
    """(from_prev, from_next): every rank sends ``to_next`` to its +1
    neighbour along ``axis`` and ``to_prev`` to its -1 neighbour (wrapping
    periodically; None sends nothing that way), and receives what its -1
    and +1 neighbours sent, in one batch of messages (JAX halo.py
    ``_ring_shift``, both ways at once). On an axis of one rank the slabs
    come back as they are (the periodic wrap)."""
    if grid.size(axis) == 1:
        return to_next, to_prev
    ops, recv = [], [None, None]
    nxt, prv = grid.neighbour(axis, 1), grid.neighbour(axis, -1)
    # tag 0 travels up the ring, tag 1 down; with two ranks both
    # neighbours are one peer, and the tags keep the two messages apart
    if to_next is not None:
        ops.append(dist.P2POp(dist.isend, grid.send_form(to_next), nxt, tag=0))
        recv[0] = grid.empty_like(to_next)
        ops.append(dist.P2POp(dist.irecv, recv[0], prv, tag=0))
    if to_prev is not None:
        ops.append(dist.P2POp(dist.isend, grid.send_form(to_prev), prv, tag=1))
        recv[1] = grid.empty_like(to_prev)
        ops.append(dist.P2POp(dist.irecv, recv[1], nxt, tag=1))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return tuple(None if r is None else grid.local_form(r) for r in recv)


def attach_halos_axis(params: RunParams, grid: ProcessGrid, U: torch.Tensor, axis: int,
                      bc_min, bc_max) -> torch.Tensor:
    """Grow the local block by the ghost width on both sides of ``axis``:
    the neighbours' slabs, then the physical fill on the ranks at the
    domain's edge (periodic and BC_COPY faces keep the ring's slabs)."""
    g = params.ghost_width
    name = AXIS_NAME[axis]
    n = U.shape[axis]
    left, right = exchange(grid, name, _take(U, axis, slice(n - g, n)),
                           _take(U, axis, slice(0, g)))
    Ug = torch.cat([left, U, right], dim=axis)
    idx, size = grid.index(name), grid.size(name)
    if bc_min not in (BCT.BC_PERIODIC, BCT.BC_COPY) and idx == 0:
        _fill_side(params, Ug, axis, False, bc_min)
    if bc_max not in (BCT.BC_PERIODIC, BCT.BC_COPY) and idx == size - 1:
        _fill_side(params, Ug, axis, True, bc_max)
    return Ug


def attach_halos(params: RunParams, grid: ProcessGrid, U: torch.Tensor) -> torch.Tensor:
    """Interior-only local block -> the fully ghosted block: X, then Y,
    then Z (the reference's sequenced exchanges)."""
    bts = params.boundary_types
    Ug = attach_halos_axis(params, grid, U, -1, bts[0], bts[1])
    Ug = attach_halos_axis(params, grid, Ug, -2, bts[2], bts[3])
    return attach_halos_axis(params, grid, Ug, -3, bts[4], bts[5])


def strip_halos(params: RunParams, Ug: torch.Tensor) -> torch.Tensor:
    """The interior of a ghosted local block (a view)."""
    g = params.ghost_width
    return Ug[:, g:-g, g:-g, g:-g]
