"""Unsplit MUSCL-Hancock Godunov step for 3D hydrodynamics, whole-array
(the PyTorch twin of ramsesgpu_tpu/solvers/godunov.py; reference
HydroRunGodunov.cpp:1860-2500, godunov_unsplit.cuh):

  primitives -> slopes -> trace -> face Riemann problems -> flux update.

flux[c] is the flux through the *left* face of cell c, so
U_new[c] = U[c] + dtdx * (flux[c] - flux[c+1]). Shifts are rolls; on a
ghosted state (g = 2) the ghost layers absorb the wrap. Gravity is not
ported.
"""
from __future__ import annotations

import torch

from ..config.params import RunParams
from ..core.constants import ID, IP, IU, IV, IW
from ..ops.backend import xp
from ..ops.eos import constoprim_hydro
from ..ops.riemann import riemann_hydro
from ..ops.slopes import slopes_unsplit
from ..ops.trace import trace_unsplit_hydro
from .boundary import make_boundaries_concat

# spatial axis per direction index (0=x, 1=y, 2=z) for the [nvar, z, y, x] layout
_AXIS = (-1, -2, -3)


def _rotation(direction: int) -> list[int]:
    """Component permutation bringing the direction-normal velocity into
    the IU slot (godunov.py:30; HydroRunGodunov.cpp:2062-2068). Each is an
    involution."""
    perm = [ID, IP, IU, IV, IW]
    if direction == 1:
        perm[IU], perm[IV] = perm[IV], perm[IU]
    elif direction == 2:
        perm[IU], perm[IW] = perm[IW], perm[IU]
    return perm


def compute_fluxes(params: RunParams, qm, qp) -> list[torch.Tensor]:
    """flux[d][..., c]: the flux through the left face of cell c along
    direction d, from the Riemann problem (qm[d] at c-1, qp[d] at c)."""
    fluxes = []
    for d in range(3):
        perm = _rotation(d)
        ql = xp.shift_m(qm[d], _AXIS[d])[perm]
        qr = qp[d][perm]
        fluxes.append(riemann_hydro(params, ql, qr)[perm])
    return fluxes


def _fluxes(params: RunParams, U: torch.Tensor, dt):
    Q, _c = constoprim_hydro(params, U)
    qm, qp = trace_unsplit_hydro(params, Q, slopes_unsplit(params, Q), dt)
    return compute_fluxes(params, qm, qp)


def hydro_3d_interior_update(params: RunParams, U: torch.Tensor, dt) -> torch.Tensor:
    """The updated interior [5, nz, ny, nx] of a ghosted 3D hydro state
    (godunov.py:78): the body of the fused step kernels, summed in their
    order ((U + x part) + y part) + z part. The plain twin of the CUDA
    step kernel (kernels/hydro_step.py)."""
    g = params.ghost_width
    interior = (slice(None),) + (slice(g, -g),) * 3
    out = U[interior]
    for d, flux in enumerate(_fluxes(params, U, dt)):
        step = dt / (params.dx, params.dy, params.dz)[d]
        out = out + step * (flux - xp.shift_p(flux, _AXIS[d]))[interior]
    return out


def hydro_3d_state_update(params: RunParams, S: torch.Tensor, dt) -> torch.Tensor:
    """One step of the loops' interior-only state S [5, nz, ny, nx]: the
    update of its ghost fill. The plain twin of the CUDA step kernel's
    interior mode (kernels/hydro_step.py)."""
    return hydro_3d_interior_update(
        params, make_boundaries_concat(params, S, interior_only=True), dt)


def godunov_unsplit_hydro(params: RunParams, U: torch.Tensor, dt) -> torch.Tensor:
    """One unsplit MUSCL-Hancock update of a ghosted 3D hydro state whose
    ghosts are filled (godunov.py:111, without gravity): U with its
    interior advanced by dU = x part + y part + z part."""
    g = params.ghost_width
    interior = (slice(None),) + (slice(g, -g),) * 3
    dU = torch.zeros_like(U[interior])
    for d, flux in enumerate(_fluxes(params, U, dt)):
        step = dt / (params.dx, params.dy, params.dz)[d]
        dU = dU + step * (flux - xp.shift_p(flux, _AXIS[d]))[interior]
    U_new = U.clone()
    U_new[interior] += dU
    return U_new
