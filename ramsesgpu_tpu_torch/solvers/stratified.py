"""Stratified-MRI vertical boundary (BC_Z_STRATIFIED): the PyTorch twin of
ramsesgpu_tpu/solvers/stratified.py (reference
src/hydro/make_boundary_base.h:1357-1647 make_boundary2_z_stratified).

The z ghosts extrapolate the density hydrostatically from the adjacent
interior row (a Gaussian profile of scale height H = cIso / omega0, or
flat with the floor option), keep the horizontal velocity (the momenta
scale with the density), let the vertical momentum flow out only, zero
the horizontal field and continue the vertical field.

``density_factors`` gives the factor of each ghost row as the JAX package
forms it (Python floats, the running product of the per-row ratios); the
CUDA kernels receive the same numbers (kernels/build.py param_block).
"""
from __future__ import annotations

import math

import torch

from ..config.params import RunParams
from ..core.constants import IA, IB, IC, ID, IP, IU, IV, IW, BoundaryConditionType as BCT

_Z = -3


def uses_stratified_z(params: RunParams) -> bool:
    return BCT.BC_Z_STRATIFIED in (params.boundary_zmin, params.boundary_zmax)


def _ratios(params: RunParams):
    """The hydrostatic density ratio of each successive ghost row, below and
    above the interior (stratified.py:34-48)."""
    g = params.ghost_width
    dz = params.dz
    H = params.c_iso / params.omega0
    factor = -dz / 2.0 / (H * H)
    ratios_min = [math.exp(factor * (-2 * (params.zmin + 0.5 * dz) + (2 * k + 1) * dz))
                  for k in range(g)]
    ratios_max = [math.exp(factor * (2 * (params.zmax - 0.5 * dz) + (2 * k + 1) * dz))
                  for k in range(g)]
    return ratios_min, ratios_max


def density_factors(params: RunParams, floor: bool = False):
    """(lo, hi): the density factor of the ghost rows walking away from the
    interior, below (z = -1, -2, ...) and above (z = nz, nz + 1, ...): the
    running products of the ratios, in the JAX package's order."""
    if floor:
        g = params.ghost_width
        return (1.0,) * g, (1.0,) * g
    out = []
    for ratios in _ratios(params):
        cumulative, cums = 1.0, []
        for r in ratios:
            cumulative *= r
            cums.append(cumulative)
        out.append(tuple(cums))
    return out[0], out[1]


def _ghost_planes(params: RunParams, src, factors, is_max: bool):
    """The ghost planes [nvar, ...] from the source row ``src`` (channel-
    first), one per factor, walking away from the interior."""
    rho_src = src[ID]
    zero = src.new_zeros(())
    w_src = torch.maximum(src[IW], zero) if is_max else torch.minimum(src[IW], zero)
    planes = []
    for cumulative in factors:
        rho_k = rho_src * cumulative
        planes.append(torch.stack([
            rho_k,
            src[IP],
            src[IU] / rho_src * rho_k,
            src[IV] / rho_src * rho_k,
            w_src,
            torch.zeros_like(rho_k),
            torch.zeros_like(rho_k),
            src[IC],
        ]))
    return planes


def make_boundary_z_stratified(params: RunParams, U: torch.Tensor, side_max: bool | None = None,
                               floor: bool = False) -> torch.Tensor:
    """Fill the stratified z ghosts of the ghosted state U ([nvar, nz+2g,
    ny+2g, nx+2g]); ``side_max`` selects one side (None = both). A new
    tensor. With the isothermal EOS (cIso > 0) the energy ghosts are left
    as they are, as the JAX package leaves them."""
    g = params.ghost_width
    kmax = U.shape[_Z]
    lo, hi = density_factors(params, floor)
    U = U.clone()
    for is_max, factors in ((False, lo), (True, hi)):
        if side_max is not None and side_max != is_max:
            continue
        src_k = kmax - g - 1 if is_max else g
        ghost_ks = range(kmax - g, kmax) if is_max else range(g - 1, -1, -1)
        src = U[:, src_k].clone()
        for k, plane in zip(ghost_ks, _ghost_planes(params, src, factors, is_max)):
            slots = [ID, IU, IV, IW, IA, IB, IC] + ([IP] if params.c_iso <= 0 else [])
            for slot in slots:
                U[slot, k] = plane[slot]
    return U


def stratified_ghost_slabs(params: RunParams, mid: torch.Tensor):
    """The BC_Z_STRATIFIED ghost slabs (zlo, zhi), each [nvar, g, ny, nxg],
    of an x-assembled block ``mid`` [nvar, nz, ny, nxg] (interior z and y,
    any x extent): ramsesgpu_tpu/solvers/shear.py:149
    ``_stratified_ghost_slabs``. zlo's rows are z = -g..-1, zhi's nz..nz+g-1."""
    lo, hi = density_factors(params)
    zlo = _ghost_planes(params, mid[:, 0], lo, False)[::-1]
    zhi = _ghost_planes(params, mid[:, params.nz - 1], hi, True)
    return torch.stack(zlo, dim=1), torch.stack(zhi, dim=1)
