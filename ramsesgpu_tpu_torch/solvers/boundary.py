"""Ghost-cell boundary fill of 3D states (the PyTorch twin of
ramsesgpu_tpu/solvers/boundary.py; reference make_boundary_base.h:709-1332).

Per face, the simple BC types:

  BC_DIRICHLET: mirror copy, normal velocity (and, for MHD, the normal
                face-centred field) sign-flipped; ghost g_i <- interior
                2*gw-1-i on the MIN side
  BC_NEUMANN:   copy of the first/last interior layer
  BC_PERIODIC:  wrap copy from the opposite interior

Faces are filled X, then Y, then Z, so corner ghosts pick up the already
filled transverse ghosts; then the inflow jet of the jet problem rewrites
its ZMIN ghost square (``make_jet``). The fill is copies, sign flips and
the jet's constants only, so it is bitwise equal to the JAX package's. A
BC_SHEARINGBOX x face is left as it is here, as the JAX fill leaves it:
solvers/shear.py fills it. A BC_Z_STRATIFIED z face takes the stratified
MRI's hydrostatic fill (solvers/stratified.py). COPY and UNDEFINED faces
are not ported and raise.

``fill_ghosts_`` is the same fill in place on a ghosted buffer (the walled
and jet loops' state, kernels/loop.py make_ghosted_loop); given the loop's
``active`` flag it writes each ghost band only where the flag is true, so
a step past t_end leaves the buffer as it was.
"""
from __future__ import annotations

import torch

from ..config.params import RunParams
from ..core.constants import IA, IB, IC, ID, IP, IU, IV, IW, BoundaryConditionType as BCT
from .stratified import make_boundary_z_stratified

_X, _Y, _Z = -1, -2, -3
_NORMAL_VEL = {_X: IU, _Y: IV, _Z: IW}
_NORMAL_B = {_X: IA, _Y: IB, _Z: IC}
_SIMPLE_BCS = (BCT.BC_DIRICHLET, BCT.BC_NEUMANN, BCT.BC_PERIODIC)


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


def _mirror(params: RunParams, band: torch.Tensor, axis: int) -> torch.Tensor:
    """The DIRICHLET ghost band of the ``gw`` layers ``band`` next to a
    face: reversed along ``axis`` (a flip, so no index tensor travels from
    the host), the normal velocity and, for MHD, the normal face-centred
    field negated (the JAX sign multiply by -1, exactly)."""
    out = band.flip(axis)
    out[_NORMAL_VEL[axis]].neg_()
    if params.mhd:
        out[_NORMAL_B[axis]].neg_()
    return out


def _set(dst: torch.Tensor, src: torch.Tensor, active: torch.Tensor | None) -> None:
    """dst <- src, or, given the 0-d bool ``active``, only where it is true."""
    dst.copy_(src if active is None else torch.where(active, src, dst))


def _fill_side(params: RunParams, U: torch.Tensor, axis: int, is_max: bool, bc,
               active: torch.Tensor | None = None) -> torch.Tensor:
    """Fill the ghost layers on one side of one axis (boundary.py:42), in
    place (where ``active``); returns U."""
    if bc == BCT.BC_SHEARINGBOX and axis == _X:
        return U
    if bc == BCT.BC_Z_STRATIFIED and axis == _Z:
        _set(U, make_boundary_z_stratified(params, U, side_max=is_max), active)
        return U
    gw = params.ghost_width
    n = U.shape[axis] - 2 * gw
    dst = _take(U, axis, slice(n + gw, n + 2 * gw) if is_max else slice(0, gw))
    if bc == BCT.BC_PERIODIC:
        src = periodic_band(_take(U, axis, slice(gw, n + gw)), axis, gw, is_max)
    elif bc == BCT.BC_NEUMANN:
        edge = n + gw - 1 if is_max else gw
        src = _take(U, axis, slice(edge, edge + 1)).expand_as(dst)
    elif bc == BCT.BC_DIRICHLET:
        # the layers n + gw - 1 .. n (max side) or 2 gw - 1 .. gw, reversed
        src = _mirror(params, _take(U, axis, slice(n, n + gw) if is_max else slice(gw, 2 * gw)),
                      axis)
    else:
        raise NotImplementedError(f"boundary type {BCT(bc).name} is not ported")
    _set(dst, src, active)
    return U


def uses_jet(params: RunParams) -> bool:
    """Whether the fill injects the inflow jet (boundary.py:228)."""
    return params.problem in ("jet", "Jet") and params.ijet > 0


def make_jet(params: RunParams, U: torch.Tensor, active: torch.Tensor | None = None
             ) -> torch.Tensor:
    """The inflow jet injected into the ghost zone (boundary.py:97-121;
    reference HydroRunBase.cpp make_jet), in place (where ``active``); 3D
    only: the ZMIN ghost square of width ijet at offsetJet in x and y,
    density djet, pressure pjet, velocity +z ujet; B is left as filled.
    Returns U."""
    if params.dim != 3:
        raise NotImplementedError("the 2D jet is not ported")
    g = params.ghost_width
    i0 = g + params.offset_jet
    i1 = i0 + params.ijet
    djet, ujet, pjet = params.djet, params.ujet, params.pjet
    e_jet = pjet / (params.gamma0 - 1.0) + 0.5 * djet * ujet * ujet
    sl = (slice(0, g), slice(i0, i1), slice(i0, i1))
    for ch, value in ((ID, djet), (IP, e_jet), (IU, 0.0), (IV, 0.0), (IW, djet * ujet)):
        dst = U[(ch,) + sl]
        _set(dst, torch.full_like(dst, value), active)
    return U


def fill_ghosts_(params: RunParams, U: torch.Tensor, active: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """make_boundaries in place on the ghosted 3D state U: every ghost
    layer filled X then Y then Z, then the jet; with the 0-d bool
    ``active``, each band written only where it is true. Returns U."""
    if params.dim != 3:
        raise NotImplementedError("only 3D is ported")
    bts = params.boundary_types
    for k, axis in enumerate((_X, _Y, _Z)):
        _fill_side(params, U, axis, False, bts[2 * k], active)
        _fill_side(params, U, axis, True, bts[2 * k + 1], active)
    if uses_jet(params):
        make_jet(params, U, active)
    return U


def periodic_band(mid: torch.Tensor, axis: int, g: int, is_max: bool) -> torch.Tensor:
    """The g-wide periodic ghost band beside one side of ``mid`` (no ghost
    layers along ``axis``), by modular index as jnp.pad(mode="wrap") takes
    it: a slice when the axis has at least g cells, else the wrap repeats
    (an axis of 2 cells under 3 ghost layers)."""
    n = mid.shape[axis]
    if g <= n:
        return mid.narrow(axis, 0 if is_max else n - g, g)
    start = n if is_max else -g
    idx = torch.arange(start, start + g, device=mid.device) % n
    return mid.index_select(axis, idx)


def make_boundaries(params: RunParams, U: torch.Tensor) -> torch.Tensor:
    """A copy of the ghosted 3D state U with every ghost layer filled, X
    then Y then Z, then the jet (boundary.py:213; HydroRunBase.cpp:2223-2331)."""
    return fill_ghosts_(params, U.clone())


def ghost_band(params: RunParams, mid: torch.Tensor, axis: int, bc, is_max: bool) -> torch.Tensor:
    """The ghost_width-wide band adjacent to one side of ``mid``, which has
    no ghost layers along ``axis`` (boundary.py:135); bitwise the band
    make_boundaries writes."""
    gw = params.ghost_width
    n = mid.shape[axis]
    if bc == BCT.BC_PERIODIC:
        return periodic_band(mid, axis, gw, is_max)
    if bc == BCT.BC_NEUMANN:
        edge = _take(mid, axis, slice(n - 1, n) if is_max else slice(0, 1))
        return torch.cat([edge] * gw, dim=axis)
    if bc != BCT.BC_DIRICHLET:
        raise NotImplementedError(f"boundary type {BCT(bc).name} is not ported")
    return _mirror(params, _take(mid, axis, slice(n - gw, n) if is_max else slice(0, gw)), axis)


def make_boundaries_concat(params: RunParams, U: torch.Tensor,
                           interior_only: bool = False) -> torch.Tensor:
    """make_boundaries built from one concatenation per axis, X then Y then
    Z (boundary.py:170), then the jet; bitwise equal to it. With
    ``interior_only`` U has no ghost frame and each axis's concatenation
    adds its own: the ghosted state around a step's new interior."""
    require_simple_bcs(params)
    gw = params.ghost_width
    bts = params.boundary_types
    for k, axis in enumerate((_X, _Y, _Z)):
        mid = U if interior_only else _take(U, axis, slice(gw, U.shape[axis] - gw))
        U = torch.cat([ghost_band(params, mid, axis, bts[2 * k], False), mid,
                       ghost_band(params, mid, axis, bts[2 * k + 1], True)], dim=axis)
    return make_jet(params, U) if uses_jet(params) else U
