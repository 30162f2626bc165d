"""Unsplit MUSCL-Hancock Godunov step for 3D MHD with constrained
transport, whole-array (the PyTorch twin of
ramsesgpu_tpu/solvers/godunov_mhd.py; reference
mhd_godunov_unsplit_cpu_v1.cpp, godunov_unsplit_mhd.cuh):

  primitives -> trace (incl. induction half-step) -> 1D HLLD face fluxes
  -> conservative update of (rho, E, momenta)
  -> 2D HLLD corner EMFs -> CT curl update of the face-centred B.

Shifts are rolls, so on the port's interior-only periodic state
[8, nz, ny, nx] (``mhd_3d_periodic_update``) the wrap is the boundary
condition and every cell is valid: that function is the plain twin of the
CUDA step kernel (kernels/mhd_step.py). Gravity, the rotating frame, the
shearing-box remap, dissipation and Kahan compensation are not ported.
"""
from __future__ import annotations

import torch

from ..config.params import RunParams
from ..core.constants import IA, IB, IC, ID, IP, IU, IV, IW

from ..ops.backend import xp
from ..ops.eos import constoprim_mhd
from ..ops.riemann_mhd import compute_emf, riemann_mhd
from ..ops.trace_mhd3d import trace_unsplit_mhd_3d_parts

_X, _Y, _Z = -1, -2, -3

# component rotation for the y (z) sweep: normal velocity and normal field
# into the IU/IA slots (mhd_godunov_unsplit_cpu_v1.cpp:146-163)
_PERM_Y = (ID, IP, IV, IU, IW, IB, IA, IC)
_PERM_Z = (ID, IP, IW, IV, IU, IC, IB, IA)


def _permute(q, perm):
    return q[list(perm)]


def _riemann_dir(params: RunParams, qm, qp, axis, perm):
    """Face flux at each cell's left face along ``axis``: the Riemann
    problem between the previous cell's qm and this cell's qp."""
    ql = xp.shift_m(qm, axis)
    if perm is None:
        return riemann_mhd(params, ql, qp)
    return _permute(riemann_mhd(params, _permute(ql, perm), _permute(qp, perm)), perm)


def mhd_fluxes_emfs(params: RunParams, U: torch.Tensor, dt):
    """Face fluxes (x, y, z) and edge EMFs (z, y, x) of one 3D MHD step."""
    Q, _c = constoprim_mhd(params, U, dt)
    P = trace_unsplit_mhd_3d_parts(params, Q, U[IA], U[IB], U[IC], dt)

    flux_x = _riemann_dir(params, P["qm_x"](), P["qp_x"](), _X, None)
    flux_y = _riemann_dir(params, P["qm_y"](), P["qp_y"](), _Y, _PERM_Y)
    flux_z = _riemann_dir(params, P["qm_z"](), P["qp_z"](), _Z, _PERM_Z)

    # EMF_Z at edge (i-1/2, j-1/2, k)
    emf_z = compute_emf(
        params,
        xp.shift_m(xp.shift_m(P["qRT_z"](), _X), _Y),
        xp.shift_m(P["qRB_z"](), _X),
        xp.shift_m(P["qLT_z"](), _Y),
        P["qLB_z"](),
        "z",
    )
    # EMF_Y at edge (i-1/2, j, k-1/2); note the reference's RB/LT role swap
    # (mhd_godunov_unsplit_cpu_v1.cpp:519-522)
    emf_y = compute_emf(
        params,
        xp.shift_m(xp.shift_m(P["qRT_y"](), _X), _Z),
        xp.shift_m(P["qLT_y"](), _Z),
        xp.shift_m(P["qRB_y"](), _X),
        P["qLB_y"](),
        "y",
    )
    # EMF_X at edge (i, j-1/2, k-1/2)
    emf_x = compute_emf(
        params,
        xp.shift_m(xp.shift_m(P["qRT_x"](), _Y), _Z),
        xp.shift_m(P["qRB_x"](), _Y),
        xp.shift_m(P["qLT_x"](), _Z),
        P["qLB_x"](),
        "x",
    )
    return (flux_x, flux_y, flux_z), (emf_z, emf_y, emf_x)


def mhd_apply_update(params: RunParams, S, fluxes, emfs, dt):
    """Conservative + CT update of the periodic state [8, nz, ny, nx] from
    its face fluxes and edge EMFs."""
    dtdx, dtdy, dtdz = dt / params.dx, dt / params.dy, dt / params.dz
    (flux_x, flux_y, flux_z), (emf_z, emf_y, emf_x) = fluxes, emfs
    dU = (
        dtdx * (flux_x - xp.shift_p(flux_x, _X))
        + dtdy * (flux_y - xp.shift_p(flux_y, _Y))
        + dtdz * (flux_z - xp.shift_p(flux_z, _Z))
    )
    dbx = (xp.shift_p(emf_z, _Y) - emf_z) * dtdy - (xp.shift_p(emf_y, _Z) - emf_y) * dtdz
    dby = (xp.shift_p(emf_x, _Z) - emf_x) * dtdz - (xp.shift_p(emf_z, _X) - emf_z) * dtdx
    dbz = (xp.shift_p(emf_y, _X) - emf_y) * dtdx - (xp.shift_p(emf_x, _Y) - emf_x) * dtdy
    deltas = [dU[ID], dU[IP], dU[IU], dU[IV], dU[IW], dbx, dby, dbz]
    return torch.stack([S[c] + d for c, d in enumerate(deltas)])


def mhd_3d_periodic_update(params: RunParams, S: torch.Tensor, dt) -> torch.Tensor:
    """One 3D MHD+CT step of the interior-only periodic state [8, nz, ny, nx]."""
    if params.nu > 0 or params.eta > 0:
        raise NotImplementedError("viscosity / resistivity are not ported")
    fluxes, emfs = mhd_fluxes_emfs(params, S, dt)
    return mhd_apply_update(params, S, fluxes, emfs, dt)
