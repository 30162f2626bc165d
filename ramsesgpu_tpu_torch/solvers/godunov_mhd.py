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
CUDA step kernel (kernels/mhd_step.py). On a ghosted state whose ghosts a
fill has written (walls, the jet), ``mhd_3d_ghosted_update`` is the JAX
whole-array step itself, the twin of the kernel's ghosted mode.

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

Kahan-compensated state (``[implementation] compensated``): the loop
state carries 16 channels, the state and then a running carry c, and each
channel's increment d is added as y = d - c; u' = u + y; c' = (u' - u) - y
(JAX godunov_mhd.py:414-423); a shearing box's kept face becomes [2, nz,
ny], the face and its carry. The stratified MRI (BC_Z_STRATIFIED z faces,
solvers/stratified.py) adds the static vertical gravity g_z, one value per
z row: a half-dt kick of the traced states and the conservative source
with the time-centred momentum, chained through the carry when
compensated (godunov_mhd.py:213-218, 375-413). Divisions of dt by the
cell size go through a tensor (dissipation._div), as the kernels divide.
"""
from __future__ import annotations

import torch

from ..config.params import RunParams
from ..core.constants import IA, IB, IC, ID, IP, IU, IV, IW

from ..ops.backend import xp
from ..ops.eos import constoprim_mhd
from ..ops.riemann_mhd import compute_emf, riemann_mhd
from ..ops.trace_mhd3d import trace_unsplit_mhd_3d_parts
from .dissipation import (_div, kahan_add, kept_face_resistive_ct,
                          mhd_dissipation_periodic_update, mhd_dissipation_shear_update,
                          uses_dissipation)
from .shear import roll_dynamic, shear_slabs, stratified_zslabs

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


def _kick(q, dt, gz):
    """The half-dt vertical gravity kick of a traced state [8, ...]."""
    q = q.clone()
    q[IW] = q[IW] + 0.5 * dt * gz
    return q


def mhd_fluxes_emfs(params: RunParams, U: torch.Tensor, dt, xpos=None, gz=None):
    """Face fluxes (x, y, z) and edge EMFs (z, y, x) of one 3D MHD step;
    ``xpos`` (cell-centre x, broadcastable) for the rotating frame; ``gz``
    (g_z per z row of U, broadcastable) kicks every traced state."""
    Q, _c = constoprim_mhd(params, U, dt)
    P = trace_unsplit_mhd_3d_parts(params, Q, U[IA], U[IB], U[IC], dt, xpos)
    if gz is not None:
        P = {k: (lambda f=v: _kick(f(), dt, gz)) for k, v in P.items()}

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


def split_carry(S: torch.Tensor):
    """(state [8, ...], carry [8, ...] or None) of a loop state of 8 or 16
    channels."""
    return (S[:8], S[8:]) if S.shape[0] == 16 else (S, None)


def mhd_apply_update(params: RunParams, S, fluxes, emfs, dt, x0: int = 0, z0: int = 0,
                     comp=None, gz=None, y0: int = 0):
    """Conservative + CT update of the state [8, nz, ny, nx] from its face
    fluxes and edge EMFs. The fluxes and EMFs extend ``x0`` columns (``y0``
    rows, ``z0`` planes) past S on each x (y, z) side; 0: that axis wraps.
    ``comp``: the carry [8, nz, ny, nx]; then the update is Kahan-
    compensated and [16, ...] returns (state, then the new carry).
    ``gz``: g_z per z row of the fluxes' frame (broadcastable): the
    conservative gravity source with the time-centred momentum
    (JAX godunov_mhd.py:375-413)."""
    dtdx, dtdy, dtdz = _div(dt, params.dx), _div(dt, params.dy), _div(dt, params.dz)
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
    inner = (slice(z0, z0 + params.nz), slice(y0, y0 + params.ny), slice(x0, x0 + params.nx))
    if x0 or y0 or z0:
        deltas = [d[(..., *inner)] for d in deltas]
    g = None
    if gz is not None:
        g = torch.broadcast_to(gz, flux_x.shape[1:])[inner]
    if comp is None:
        outs = [S[c] + d for c, d in enumerate(deltas)]
        if g is not None:
            mom_half = 0.5 * (S[IW] + outs[IW])
            outs[IW] = outs[IW] + dt * S[ID] * g
            outs[IP] = outs[IP] + dt * mom_half * g
        return torch.stack(outs)
    outs, carries = map(list, zip(*(kahan_add(S[c], comp[c], d) for c, d in enumerate(deltas))))
    if g is not None:
        mom_half = 0.5 * (S[IW] + outs[IW])
        outs[IW], carries[IW] = kahan_add(outs[IW], carries[IW], dt * S[ID] * g)
        outs[IP], carries[IP] = kahan_add(outs[IP], carries[IP], dt * mom_half * g)
    return torch.stack(outs + carries)


def mhd_3d_periodic_update(params: RunParams, S: torch.Tensor, dt) -> torch.Tensor:
    """One 3D MHD+CT Godunov update of the interior-only periodic state
    [8, nz, ny, nx], or of a compensated one [16, ...] (the twin of the
    step kernel; no dissipation)."""
    S, comp = split_carry(S)
    fluxes, emfs = mhd_fluxes_emfs(params, S, dt)
    return mhd_apply_update(params, S, fluxes, emfs, dt, comp=comp)


def mhd_3d_ghosted_update(params: RunParams, U: torch.Tensor, dt) -> torch.Tensor:
    """One 3D MHD+CT Godunov step of a ghosted state [8, nz+2g, ny+2g,
    nx+2g] whose ghosts a fill has written: the JAX whole-array step
    (godunov_mhd.py:596-744) without gravity, shear or dissipation. Every
    stage runs on the whole array with rolls; the flux divergence updates
    the interior, and the CT curl the cube g .. n+g of every axis
    (:733-744, mhd_ct_update.cuh:124-213), so the max-side face layer n+g
    (Bx[nx+g], By[ny+g], Bz[nz+g] and the rest of that layer) changes too;
    every other ghost stays as filled. Returns the new ghosted array. The
    plain twin of the step kernel's ghosted mode (TPU row 3's interior is
    its interior)."""
    g = params.ghost_width
    dtdx, dtdy, dtdz = _div(dt, params.dx), _div(dt, params.dy), _div(dt, params.dz)
    (flux_x, flux_y, flux_z), (emf_z, emf_y, emf_x) = mhd_fluxes_emfs(params, U, dt)
    inner = (slice(None),) + (slice(g, -g),) * 3
    ct = tuple(slice(g, n - g + 1) for n in U.shape[1:])
    dU = (
        dtdx * (flux_x - xp.shift_p(flux_x, _X))
        + dtdy * (flux_y - xp.shift_p(flux_y, _Y))
        + dtdz * (flux_z - xp.shift_p(flux_z, _Z))
    )[inner]
    dbx = ((xp.shift_p(emf_z, _Y) - emf_z) * dtdy - (xp.shift_p(emf_y, _Z) - emf_y) * dtdz)[ct]
    dby = ((xp.shift_p(emf_x, _Z) - emf_x) * dtdz - (xp.shift_p(emf_z, _X) - emf_z) * dtdx)[ct]
    dbz = ((xp.shift_p(emf_y, _X) - emf_y) * dtdx - (xp.shift_p(emf_x, _Y) - emf_x) * dtdy)[ct]
    out = U.clone()
    out[(slice(0, 5),) + inner[1:]] = U[(slice(0, 5),) + inner[1:]] + dU[:5]
    for ch, d in ((IA, dbx), (IB, dby), (IC, dbz)):
        out[(ch,) + ct] = U[(ch,) + ct] + d
    return out


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
def mhd_3d_shear_update(params: RunParams, S: torch.Tensor, slabs: torch.Tensor, dt,
                        zslabs=None, gz=None):
    """One rotating-frame 3D MHD+CT step of the interior S [8, nz, ny, nx]
    (or compensated, [16, ...]) with the sheared x ghost slabs [2, 8, nz,
    ny, g] beside it (y wraps; z wraps, or, stratified, the z ghost slabs
    ``zslabs`` [2, 8, g, ny, nx + 2g] lie beside the block and ``gz``
    [nz + 2g] holds g_z of each row). Returns (S_new, planes [5, nz, ny]):
    the density flux at the x faces 0 and nx, emfY there, and emfZ at face
    nx, unremapped (godunov_mhd.py:429-434 ``shear_planes``)."""
    g, nx, nz = params.ghost_width, params.nx, params.nz
    S, comp = split_carry(S)
    W = torch.cat([slabs[0], S, slabs[1]], dim=-1)
    z0, gzw = 0, None
    if zslabs is not None:
        W = torch.cat([zslabs[0], W, zslabs[1]], dim=-3)
        z0, gzw = g, gz.view(-1, 1, 1)
    xpos = xpos_array(params, S.dtype, S.device)
    fluxes, emfs = mhd_fluxes_emfs(params, W, dt, xpos, gzw)
    S_new = mhd_apply_update(params, S, fluxes, emfs, dt, x0=g, z0=z0, comp=comp, gz=gzw)
    (flux_x, _fy, _fz), (emf_z, emf_y, _ex) = fluxes, emfs
    zi = slice(z0, z0 + nz)
    planes = torch.stack([flux_x[ID, zi, :, g], flux_x[ID, zi, :, g + nx],
                          emf_y[zi, :, g], emf_y[zi, :, g + nx], emf_z[zi, :, g + nx]])
    return S_new, planes


def mhd_3d_shear_window_update(params: RunParams, U: torch.Tensor, dt, x0: float, gz=None):
    """One rotating-frame MHD+CT step of a ghosted window U [8, nz+2g,
    ny+2g, nx+2g] (``params``: the window's extent) whose ghosts an
    exchange has written: JAX godunov_mhd.py:294 ``mhd_3d_interior_update(
    params, U, dt, margin=(g, g, g), shear_planes=True, xpos=..., gravity=
    ...)``, the body of TPU row 4 (pallas/fused_mhd3d.py:587
    make_fused_mhd_shear). ``x0``: the window's global x offset; ``gz``:
    g_z of the window's rows [nz + 2g], or None. Every stage runs on the
    window with rolls, whose wrap only the ghost margins see. Returns
    (interior [8, nz, ny, nx], planes [5, nz, ny]: the density flux at the
    x faces 0 and nx, emfY there, emfZ at face nx, unremapped). The plain
    twin of the step kernel's shear window mode (kernels/mhd_step.py)."""
    g, nx, ny, nz = params.ghost_width, params.nx, params.ny, params.nz
    # column i's centre: x0 + dx/2 + (i - g) dx (JAX godunov_mhd.py:190-203
    # with a shard's xpos)
    i = torch.arange(U.shape[-1], dtype=U.dtype, device=U.device).view(1, 1, -1)
    xpos = x0 + params.dx / 2 + (i - g) * params.dx
    gzw = None if gz is None else gz.view(-1, 1, 1)
    fluxes, emfs = mhd_fluxes_emfs(params, U, dt, xpos, gzw)
    S_new = mhd_apply_update(params, U[:, g:-g, g:-g, g:-g], fluxes, emfs, dt,
                             x0=g, y0=g, z0=g, gz=gzw)
    (flux_x, _fy, _fz), (emf_z, emf_y, _ex) = fluxes, emfs
    zi, yi = slice(g, g + nz), slice(g, g + ny)
    planes = torch.stack([flux_x[ID, zi, yi, g], flux_x[ID, zi, yi, g + nx],
                          emf_y[zi, yi, g], emf_y[zi, yi, g + nx], emf_z[zi, yi, g + nx]])
    return S_new, planes


def _remap_offset(params: RunParams, t, dt):
    dy = params.dy
    Ly = params.ymax - params.ymin
    Lx = params.xmax - params.xmin
    deltay = torch.remainder(1.5 * params.omega0 * Lx * (t + 0.5 * dt), Ly)
    jplus = torch.floor(_div(deltay, dy)).to(torch.int64)
    return jplus, _div(torch.remainder(deltay, dy), dy)


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
    with the remapped emfY. A compensated state (S [16, ...], kept [2, nz,
    ny]) takes each as a Kahan add, its carry reset where the floor fires
    (:1139-1147). Returns (S_new, kept_new, remapped [4, nz, ny] =
    fpl_min, fpl_max, eypl_min, eypl_max after the remap)."""
    dtdx, dtdy, dtdz = _div(dt, params.dx), _div(dt, params.dy), _div(dt, params.dz)
    fpl_min, fpl_max, eypl_min, eypl_max, ezpl_max = planes
    min_r, max_r = _shear_remap_pair_stacked(
        params, torch.stack([fpl_min, eypl_min]), torch.stack([fpl_max, eypl_max]), t, dt)
    fmin_r, emin_r = min_r[0], min_r[1]
    fmax_r, emax_r = max_r[0], max_r[1]
    d_emin = emin_r - eypl_min
    d_emax = emax_r - eypl_max
    # (column, slot, delta) in the JAX order (shear_packed.py:1128-1157)
    deltas = ((0, ID, dtdx * (fmin_r - fpl_min)),
              (0, IA, -dtdz * (torch.roll(d_emin, -1, 0) - d_emin)),
              (0, IC, -dtdx * d_emin),
              (-1, ID, -dtdx * (fmax_r - fpl_max)),
              (-1, IC, dtdx * d_emax))
    d_kept = (dtdy * (torch.roll(ezpl_max, -1, 1) - ezpl_max)
              - dtdz * (torch.roll(emax_r, -1, 0) - emax_r))
    floor = S.new_full((), params.smallr)
    S = S.clone()
    comp = S.shape[0] == 16
    for col, slot, delta in deltas:
        if not comp:
            v = S[slot, ..., col] + delta
            S[slot, ..., col] = torch.maximum(v, floor) if slot == ID else v
            continue
        v, c = kahan_add(S[slot, ..., col], S[8 + slot, ..., col], delta)
        if slot == ID:
            fl = torch.maximum(v, floor)
            c = torch.where(fl == v, c, torch.zeros_like(c))
            v = fl
        S[slot, ..., col] = v
        S[8 + slot, ..., col] = c
    kept_new = torch.stack(kahan_add(kept[0], kept[1], d_kept)) if comp else kept + d_kept
    return S, kept_new, torch.stack([fmin_r, fmax_r, emin_r, emax_r])


def kept_face(kept: torch.Tensor) -> torch.Tensor:
    """The kept Bx face [nz, ny] of a plain or compensated ([2, nz, ny])
    kept carry."""
    return kept[0] if kept.dim() == 3 else kept


def mhd_3d_shear_step(params: RunParams, S, kept, t, dt, gz=None):
    """One shearing-box step on the loop state: the sheared slabs at t + dt
    (the reference fills for totalTime + dt, MHDRunGodunov.cpp:3551), the
    update, then the remap and border corrections at t. A stratified run
    (``gz``, g_z of each z row [nz + 2g]) builds the z ghost slabs of the
    interior and of the x slabs first (pallas/shear_packed.py:963-975,
    1006-1021). A dissipative run then refills the slabs at t + dt from the
    updated state (the sheared refill before the dissipative step,
    MHDRunGodunov.cpp:1968-1976; no flux remap applies to it), takes the
    dissipative sub-step and, with resistivity, the kept face's resistive CT
    (pallas/shear_packed.py:1178-1203). S and kept may be compensated (16
    channels, [2, nz, ny]). Returns (S_new, kept_new)."""
    slabs = shear_slabs(params, S[:8], kept_face(kept), t + dt)
    zslabs = None if gz is None else stratified_zslabs(params, S[:8], slabs)
    S_new, planes = mhd_3d_shear_update(params, S, slabs, dt, zslabs, gz)
    S_new, kept_new, _ = shear_border_update(params, S_new, kept, planes, t, dt)
    if uses_dissipation(params):
        slabs = shear_slabs(params, S_new[:8], kept_face(kept_new), t + dt)
        S_new, eypl, ezpl = mhd_dissipation_shear_update(params, S_new, slabs, dt)
        if params.eta > 0:
            kept_new = kept_face_resistive_ct(params, kept_new, eypl, ezpl, dt)
    return S_new, kept_new
