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
CUDA step kernel (kernels/mhd_step.py).

The shearing box (rotating frame, sheared-periodic x faces) runs on the
loop state (S, kept): ``mhd_3d_shear_update`` updates S with the sheared
x ghost slabs beside it and returns the x-face planes of the conservative
remap (the twin of the step kernel's shearing-box mode);
``shear_border_update`` remaps the density flux and emfY at the two domain
x faces, corrects the border columns, floors their density and updates
the kept Bx face by CT (the twin of the border kernel,
kernels/shear_border.py). Correcting after the update equals remapping
before it, as the JAX package's whole-array step does, because the
update is linear in the face flux and EMF. The step twins
(``mhd_3d_periodic_step``, ``mhd_3d_shear_step``) follow a dissipative
Godunov update with the viscous / resistive sub-step (solvers/dissipation.py).
Gravity and Kahan compensation are not ported.
"""
from __future__ import annotations

import torch

from ..config.params import RunParams
from ..core.constants import IA, IB, IC, ID, IP, IU, IV, IW

from ..ops.backend import xp
from ..ops.eos import constoprim_mhd
from ..ops.riemann_mhd import compute_emf, riemann_mhd
from ..ops.trace_mhd3d import trace_unsplit_mhd_3d_parts
from .dissipation import (kept_face_resistive_ct, mhd_dissipation_periodic_update,
                          mhd_dissipation_shear_update, uses_dissipation)
from .shear import roll_dynamic, shear_slabs

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


def xpos_array(params: RunParams, dtype, device=None) -> torch.Tensor:
    """Cell-centre x coordinates of the x-ghosted columns, [1, 1, nx + 2g]
    (godunov_mhd.py:44; column i holds xmin + dx/2 + (i - g) dx)."""
    i = torch.arange(params.isize, dtype=dtype, device=device).view(1, 1, -1)
    return params.xmin + params.dx / 2 + (i - params.ghost_width) * params.dx


def mhd_fluxes_emfs(params: RunParams, U: torch.Tensor, dt, xpos=None):
    """Face fluxes (x, y, z) and edge EMFs (z, y, x) of one 3D MHD step;
    ``xpos`` (cell-centre x, broadcastable) for the rotating frame."""
    Q, _c = constoprim_mhd(params, U, dt)
    P = trace_unsplit_mhd_3d_parts(params, Q, U[IA], U[IB], U[IC], dt, xpos)

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
        xpos,
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
        xpos,
    )
    # EMF_X at edge (i, j-1/2, k-1/2)
    emf_x = compute_emf(
        params,
        xp.shift_m(xp.shift_m(P["qRT_x"](), _Y), _Z),
        xp.shift_m(P["qRB_x"](), _Y),
        xp.shift_m(P["qLT_x"](), _Z),
        P["qLB_x"](),
        "x",
        xpos,
    )
    return (flux_x, flux_y, flux_z), (emf_z, emf_y, emf_x)


def mhd_apply_update(params: RunParams, S, fluxes, emfs, dt, x0: int = 0):
    """Conservative + CT update of the state [8, nz, ny, nx] from its face
    fluxes and edge EMFs. y and z wrap; the fluxes and EMFs extend ``x0``
    columns past S on each x side (0: x wraps too)."""
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
    if x0:
        deltas = [d[..., x0:x0 + params.nx] for d in deltas]
    return torch.stack([S[c] + d for c, d in enumerate(deltas)])


def mhd_3d_periodic_update(params: RunParams, S: torch.Tensor, dt) -> torch.Tensor:
    """One 3D MHD+CT Godunov update of the interior-only periodic state
    [8, nz, ny, nx] (the twin of the step kernel; no dissipation)."""
    fluxes, emfs = mhd_fluxes_emfs(params, S, dt)
    return mhd_apply_update(params, S, fluxes, emfs, dt)


def mhd_3d_periodic_step(params: RunParams, S: torch.Tensor, dt) -> torch.Tensor:
    """One periodic step: the Godunov update, then the dissipative sub-step
    when nu > 0 or eta > 0 (the roll is the inter-phase refill, as the JAX
    package's wrap pad; pallas/fused_mhd3d.py:457-463)."""
    S = mhd_3d_periodic_update(params, S, dt)
    if uses_dissipation(params):
        S = mhd_dissipation_periodic_update(params, S, dt)
    return S


# -------------------------------------------------------------------------
# shearing box
# -------------------------------------------------------------------------
def mhd_3d_shear_update(params: RunParams, S: torch.Tensor, slabs: torch.Tensor, dt):
    """One rotating-frame 3D MHD+CT step of the interior S [8, nz, ny, nx]
    with the sheared x ghost slabs [2, 8, nz, ny, g] beside it (y and z
    wrap). Returns (S_new, planes [5, nz, ny]): the density flux at the x
    faces 0 and nx, emfY there, and emfZ at face nx, unremapped
    (godunov_mhd.py:429-434 ``shear_planes``)."""
    g, nx = params.ghost_width, params.nx
    W = torch.cat([slabs[0], S, slabs[1]], dim=-1)
    xpos = xpos_array(params, S.dtype, S.device)
    fluxes, emfs = mhd_fluxes_emfs(params, W, dt, xpos)
    S_new = mhd_apply_update(params, S, fluxes, emfs, dt, x0=g)
    (flux_x, _fy, _fz), (emf_z, emf_y, _ex) = fluxes, emfs
    planes = torch.stack([flux_x[ID, ..., g], flux_x[ID, ..., g + nx],
                          emf_y[..., g], emf_y[..., g + nx], emf_z[..., g + nx]])
    return S_new, planes


def _remap_offset(params: RunParams, t, dt):
    dy = params.dy
    Ly = params.ymax - params.ymin
    Lx = params.xmax - params.xmin
    deltay = torch.remainder(1.5 * params.omega0 * Lx * (t + 0.5 * dt), Ly)
    jplus = torch.floor(deltay / dy).to(torch.int64)
    return jplus, torch.remainder(deltay, dy) / dy


def _shear_remap_pair_stacked(params: RunParams, f_xmin, f_xmax, t, dt):
    """Conservative remap of stacked [k, nz, ny] x-border face fields (y
    along the last axis) at deltay(t + dt/2) (godunov_mhd.py:574; reference
    shearingBox_utils.cuh:47-170): each side's value becomes the half-sum
    of its own and the other side's value interpolated at the sheared y."""
    jplus, w = _remap_offset(params, t, dt)
    one = torch.ones_like(jplus)
    rmax0 = roll_dynamic(f_xmax, jplus, -1)
    rmax1 = roll_dynamic(rmax0, one, -1)
    rmin0 = roll_dynamic(f_xmin, -jplus, -1)
    rmin1 = roll_dynamic(rmin0, -one, -1)
    interp_for_min = w * rmax1 + (1.0 - w) * rmax0
    interp_for_max = (1.0 - w) * rmin0 + w * rmin1
    return 0.5 * (f_xmin + interp_for_min), 0.5 * (f_xmax + interp_for_max)


def shear_border_update(params: RunParams, S, kept, planes, t, dt):
    """The conservative remap at the two domain x faces and what it changes
    (pallas/shear_packed.py:1117-1168): the density flux and emfY planes
    remapped at t + dt/2; density, Bx and Bz deltas on the border columns
    0 and nx-1; the density floor there; the CT update of the kept Bx face
    with the remapped emfY. Returns (S_new, kept_new, remapped [4, nz, ny]
    = fpl_min, fpl_max, eypl_min, eypl_max after the remap)."""
    dtdx, dtdy, dtdz = dt / params.dx, dt / params.dy, dt / params.dz
    fpl_min, fpl_max, eypl_min, eypl_max, ezpl_max = planes
    min_r, max_r = _shear_remap_pair_stacked(
        params, torch.stack([fpl_min, eypl_min]), torch.stack([fpl_max, eypl_max]), t, dt)
    fmin_r, emin_r = min_r[0], min_r[1]
    fmax_r, emax_r = max_r[0], max_r[1]
    d_emin = emin_r - eypl_min
    d_emax = emax_r - eypl_max
    S = S.clone()
    S[ID, ..., 0] = torch.maximum(S[ID, ..., 0] + dtdx * (fmin_r - fpl_min),
                                  S.new_full((), params.smallr))
    S[IA, ..., 0] = S[IA, ..., 0] + -dtdz * (torch.roll(d_emin, -1, 0) - d_emin)
    S[IC, ..., 0] = S[IC, ..., 0] + -dtdx * d_emin
    S[ID, ..., -1] = torch.maximum(S[ID, ..., -1] + -dtdx * (fmax_r - fpl_max),
                                   S.new_full((), params.smallr))
    S[IC, ..., -1] = S[IC, ..., -1] + dtdx * d_emax
    d_kept = (dtdy * (torch.roll(ezpl_max, -1, 1) - ezpl_max)
              - dtdz * (torch.roll(emax_r, -1, 0) - emax_r))
    return S, kept + d_kept, torch.stack([fmin_r, fmax_r, emin_r, emax_r])


def mhd_3d_shear_step(params: RunParams, S, kept, t, dt):
    """One shearing-box step on the loop state: the sheared slabs at t + dt
    (the reference fills for totalTime + dt, MHDRunGodunov.cpp:3551), the
    update, then the remap and border corrections at t. A dissipative run
    then refills the slabs at t + dt from the updated state (the sheared
    refill before the dissipative step, MHDRunGodunov.cpp:1968-1976; no
    flux remap applies to it), takes the dissipative sub-step and, with
    resistivity, the kept face's resistive CT
    (pallas/shear_packed.py:1178-1203). Returns (S_new, kept_new)."""
    slabs = shear_slabs(params, S, kept, t + dt)
    S_new, planes = mhd_3d_shear_update(params, S, slabs, dt)
    S_new, kept_new, _ = shear_border_update(params, S_new, kept, planes, t, dt)
    if uses_dissipation(params):
        slabs = shear_slabs(params, S_new, kept_new, t + dt)
        S_new, eypl, ezpl = mhd_dissipation_shear_update(params, S_new, slabs, dt)
        if params.eta > 0:
            kept_new = kept_face_resistive_ct(params, kept_new, eypl, ezpl, dt)
    return S_new, kept_new
