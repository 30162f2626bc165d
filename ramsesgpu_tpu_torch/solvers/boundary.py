"""Ghost-cell boundary fill of 3D states (the PyTorch twin of
ramsesgpu_tpu/solvers/boundary.py; reference make_boundary_base.h:709-1332).

Per face, the simple BC types:

  BC_DIRICHLET: mirror copy, normal velocity (and, for MHD, the normal
                face-centred field) sign-flipped; ghost g_i <- interior
                2*gw-1-i on the MIN side
  BC_NEUMANN:   copy of the first/last interior layer
  BC_PERIODIC:  wrap copy from the opposite interior

Faces are filled X, then Y, then Z, so corner ghosts pick up the already
filled transverse ghosts. The fill is copies and sign flips only, so it is
bitwise equal to the JAX package's. A BC_SHEARINGBOX x face is left as it
is here, as the JAX fill leaves it: solvers/shear.py fills it. COPY and
stratified faces are not ported and raise.
"""
from __future__ import annotations

import torch

from ..config.params import RunParams
from ..core.constants import IA, IB, IC, IU, IV, IW, BoundaryConditionType as BCT

_X, _Y, _Z = -1, -2, -3
_NORMAL_VEL = {_X: IU, _Y: IV, _Z: IW}
_NORMAL_B = {_X: IA, _Y: IB, _Z: IC}
_SIMPLE_BCS = (BCT.BC_DIRICHLET, BCT.BC_NEUMANN, BCT.BC_PERIODIC)


def require_periodic(params: RunParams) -> None:
    if any(b != BCT.BC_PERIODIC for b in params.boundary_types):
        names = [b.name for b in params.boundary_types]
        raise NotImplementedError(f"only fully periodic boundaries are ported here, got {names}")


def require_simple_bcs(params: RunParams) -> None:
    if any(b not in _SIMPLE_BCS for b in params.boundary_types):
        names = [b.name for b in params.boundary_types]
        raise NotImplementedError(
            f"only DIRICHLET / NEUMANN / PERIODIC boundaries are ported, got {names}")


def interior(params: RunParams, U: torch.Tensor) -> torch.Tensor:
    """The interior block [nvar, nz, ny, nx] of a ghosted 3D state (a view)."""
    g = params.ghost_width
    return U[:, g:-g, g:-g, g:-g]


def _take(U: torch.Tensor, axis: int, idx) -> torch.Tensor:
    sl = [slice(None)] * U.ndim
    sl[axis] = idx
    return U[tuple(sl)]


def _sign(params: RunParams, like: torch.Tensor, axis: int) -> torch.Tensor:
    """The DIRICHLET mirror's per-channel sign vector, broadcastable."""
    sign = torch.ones((like.shape[0],) + (1,) * (like.ndim - 1), dtype=like.dtype,
                      device=like.device)
    sign[_NORMAL_VEL[axis]] = -1.0
    if params.mhd:
        sign[_NORMAL_B[axis]] = -1.0
    return sign


def _fill_side(params: RunParams, U: torch.Tensor, axis: int, is_max: bool, bc) -> torch.Tensor:
    """Fill the ghost layers on one side of one axis (boundary.py:42), in
    place; returns U."""
    if bc == BCT.BC_SHEARINGBOX and axis == _X:
        return U
    gw = params.ghost_width
    n = U.shape[axis] - 2 * gw
    dst = _take(U, axis, slice(n + gw, n + 2 * gw) if is_max else slice(0, gw))
    if bc == BCT.BC_PERIODIC:
        dst.copy_(_take(U, axis, slice(gw, 2 * gw) if is_max else slice(n, n + gw)))
    elif bc == BCT.BC_NEUMANN:
        edge = n + gw - 1 if is_max else gw
        dst.copy_(_take(U, axis, slice(edge, edge + 1)).expand_as(dst))
    elif bc == BCT.BC_DIRICHLET:
        idx = (torch.arange(n + gw - 1, n - 1, -1) if is_max
               else torch.arange(2 * gw - 1, gw - 1, -1))
        dst.copy_(_sign(params, U, axis) * _take(U, axis, idx.to(U.device)))
    else:
        raise NotImplementedError(f"boundary type {BCT(bc).name} is not ported")
    return U


def make_boundaries(params: RunParams, U: torch.Tensor) -> torch.Tensor:
    """A copy of the ghosted 3D state U with every ghost layer filled, X
    then Y then Z (boundary.py:213; HydroRunBase.cpp:2223-2331)."""
    if params.dim != 3:
        raise NotImplementedError("only 3D is ported")
    bts = params.boundary_types
    U = U.clone()
    for k, axis in enumerate((_X, _Y, _Z)):
        _fill_side(params, U, axis, False, bts[2 * k])
        _fill_side(params, U, axis, True, bts[2 * k + 1])
    return U


def ghost_band(params: RunParams, mid: torch.Tensor, axis: int, bc, is_max: bool) -> torch.Tensor:
    """The ghost_width-wide band adjacent to one side of ``mid``, which has
    no ghost layers along ``axis`` (boundary.py:135); bitwise the band
    make_boundaries writes."""
    gw = params.ghost_width
    n = mid.shape[axis]
    if bc == BCT.BC_PERIODIC:
        return _take(mid, axis, slice(0, gw) if is_max else slice(n - gw, n))
    if bc == BCT.BC_NEUMANN:
        edge = _take(mid, axis, slice(n - 1, n) if is_max else slice(0, 1))
        return torch.cat([edge] * gw, dim=axis)
    if bc != BCT.BC_DIRICHLET:
        raise NotImplementedError(f"boundary type {BCT(bc).name} is not ported")
    idx = torch.arange(n - 1, n - gw - 1, -1) if is_max else torch.arange(gw - 1, -1, -1)
    return _sign(params, mid, axis) * _take(mid, axis, idx.to(mid.device))


def make_boundaries_concat(params: RunParams, U: torch.Tensor,
                           interior_only: bool = False) -> torch.Tensor:
    """make_boundaries built from one concatenation per axis, X then Y then
    Z (boundary.py:170); bitwise equal to it. With ``interior_only`` U has
    no ghost frame and each axis's concatenation adds its own: the
    ghosted state around a step's new interior."""
    require_simple_bcs(params)
    gw = params.ghost_width
    bts = params.boundary_types
    for k, axis in enumerate((_X, _Y, _Z)):
        mid = U if interior_only else _take(U, axis, slice(gw, U.shape[axis] - gw))
        U = torch.cat([ghost_band(params, mid, axis, bts[2 * k], False), mid,
                       ghost_band(params, mid, axis, bts[2 * k + 1], True)], dim=axis)
    return U
