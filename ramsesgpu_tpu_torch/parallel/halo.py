"""Halo exchange between ranks: ``torch.distributed`` point-to-point
messages replace the JAX package's ppermute rings
(ramsesgpu_tpu/parallel/halo.py:29-93; reference HydroRunBaseMpi.cpp:
3294-3760, pack -> MPI_Sendrecv -> unpack).

Works on 2D and 3D local blocks: ``attach_halos`` grows an interior-only
block by the ghost width along x, then y (then z), each exchange on the
block the previous ones grew, so edge and corner ghosts come from the
neighbours' own ghosts, as in JAX; physical boundary fills then override
the ghosts of the ranks at the global domain's edge, and the inflow jet
those of the ranks that hold its face (``attach_jet``; the JAX sharded
fill has none, ROADMAP Queue 3 item 15: the port follows the
single-device fill, solvers/boundary.py make_boundaries). ``fill_halos_``
and ``attach_jet`` are the same fill in place on a ghosted block whose
interior is current, the sharded loops' state. Under the gloo transport from a CUDA device each
slab goes through host memory (parallel/mesh.py).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..config.params import RunParams
from ..core.constants import BoundaryConditionType as BCT
from ..solvers.boundary import _fill_side, make_jet, uses_jet
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


def fill_halos_(params: RunParams, grid: ProcessGrid, Ug: torch.Tensor) -> torch.Tensor:
    """The ghosts of the ghosted local block Ug (2D or 3D), in place, from
    its interior: X, then Y, then Z, each exchange on the part of Ug that
    the axes before it have grown (the ghosts of those axes, the interior
    of the rest), then the physical fill of the ranks at the domain's edge
    (periodic faces keep the ring's slabs). The jet is ``attach_jet``'s,
    after it. Returns Ug."""
    g = params.ghost_width
    bts = params.boundary_types
    axes = (-1, -2, -3)[:params.dim]
    for k, axis in enumerate(axes):
        sl = [slice(None)] * Ug.ndim
        for later in axes[k + 1:]:
            sl[later] = slice(g, -g)
        V = Ug[tuple(sl)]
        n = V.shape[axis] - 2 * g
        name = AXIS_NAME[axis]
        left, right = exchange(grid, name, _take(V, axis, slice(n, n + g)),
                               _take(V, axis, slice(g, 2 * g)))
        _take(V, axis, slice(0, g)).copy_(left)
        _take(V, axis, slice(n + g, n + 2 * g)).copy_(right)
        bc_min, bc_max = bts[2 * k], bts[2 * k + 1]
        if bc_min not in (BCT.BC_PERIODIC, BCT.BC_COPY) and grid.index(name) == 0:
            _fill_side(params, V, axis, False, bc_min)
        if bc_max not in (BCT.BC_PERIODIC, BCT.BC_COPY) and grid.index(name) == grid.size(name) - 1:
            _fill_side(params, V, axis, True, bc_max)
    return Ug


def attach_jet(params: RunParams, grid: ProcessGrid, Ug: torch.Tensor) -> torch.Tensor:
    """The inflow jet (solvers/boundary.py make_jet) on the ranks that hold
    its face, YMIN in 2D (iy = 0) and ZMIN in 3D (iz = 0): its strip or
    square, in ghosted global indices, clipped to the rank's ghosted x
    (and y) window, ghost columns included, so that a rank's ghost corner
    holds what the single-device fill holds there. Other ranks and runs
    without a jet are left as they are. Returns Ug."""
    if not uses_jet(params) or grid.index("y" if params.dim == 2 else "z") != 0:
        return Ug
    g = params.ghost_width
    ny, nx = Ug.shape[-2] - 2 * g, Ug.shape[-1] - 2 * g
    _iz, iy, ix = grid.coords
    return make_jet(params, Ug, origin=(iy * ny, ix * nx))


def attach_halos(params: RunParams, grid: ProcessGrid, U: torch.Tensor) -> torch.Tensor:
    """Interior-only local block (2D or 3D) -> the fully ghosted block, a
    new tensor: ``fill_halos_`` then ``attach_jet`` on a copy."""
    g = params.ghost_width
    Ug = U.new_empty((U.shape[0], *(n + 2 * g for n in U.shape[1:])))
    strip_halos(params, Ug).copy_(U)
    return attach_jet(params, grid, fill_halos_(params, grid, Ug))


def strip_halos(params: RunParams, Ug: torch.Tensor) -> torch.Tensor:
    """The interior of a ghosted local block, 2D or 3D (a view)."""
    g = params.ghost_width
    return Ug[(slice(None),) + (slice(g, -g),) * (Ug.ndim - 1)]
