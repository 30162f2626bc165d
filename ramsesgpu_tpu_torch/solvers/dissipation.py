"""Explicit dissipative terms of 3D MHD: viscosity and resistivity (the
PyTorch twin of ramsesgpu_tpu/solvers/dissipation.py; reference
src/hydro/viscosity.cuh:412+, resistivity.cuh:233-471).

The face-centred stress and energy fluxes are pre-scaled by dt/dh as the
reference's kernels scale them, so a cell gains flux[c] - flux[c+1] per
direction; the resistive EMF -eta J feeds the same CT curl as the Godunov
step, so divB stays exact. The JAX package's op order is kept (its
``dt / dh`` scaling, its 0.5 / 0.25 averages, ``_tavg4`` as the centred
difference of the face sum over 4 dh), so a formula the port gets wrong
cannot hide under a reordering's rounding.

Two forms:

- whole-array on a ghosted state (``apply_dissipation_mhd`` and its
  parts): the CT updates the interior and the first high ghost layer only,
  as the JAX package's ``ct`` range does;
- interior-only, the form the CUDA kernel computes
  (kernels/dissip_step.py): ``mhd_dissipation_interior_update`` applies
  the CT on the whole extent, so the resistive energy flux reads CT-updated
  B one cell outside the interior on both sides (JAX
  ``mhd_dissipation_interior_update``, the body of its fused kernel).
  ``mhd_dissipation_periodic_update`` is that form on the port's
  interior-only periodic state (neighbours by roll), and
  ``mhd_dissipation_shear_update`` on the shearing box's interior with its
  sheared x ghost slabs beside it; ``mhd_dissipation_ghosted_update`` on a
  refilled ghosted state (walls, the jet) with the whole-array form's CT
  range, so it is the interior of ``apply_dissipation_mhd``. The two forms differ in the energy of
  the cells next to a low face, by the resistive CT of one ghost layer: in
  the JAX package's own f64 runs of the 16^3 dissipative Orszag-Tang test
  (tests/test_torch_dissip.py), 2.2e-8 of the state after one step.

Compensated (a carry beside the state, solvers/godunov_mhd.py): the
interior forms collect each channel's whole increment, B's being the CT
delta, and make one Kahan add per channel against the carry; untouched
channels keep theirs (JAX dissipation.py:357-380).

Hydro viscosity (3D hydro with nu > 0) is ``apply_viscosity``, the JAX
package's whole-array step (solvers/step.py:273-277 there, after the
refill), on a ghosted state or a sharded rank's refilled ghosted block
(``viscosity_``, in place). The JAX package has no kernel for it: its
hydro kernels exclude nu (pallas/fused_hydro3d.py:39) and its
dissipation kernel is MHD only (pallas/fused_dissip3d.py:41-48). So on
the card it runs as whole-array PyTorch, as the 2D step does; it is not a
fallback from a kernel.

2D dissipation is not ported: every function raises NotImplementedError
for a 2D configuration.
"""
from __future__ import annotations

import torch

from ..config.params import RunParams
from ..core.constants import IA, IB, IC, ID, IP, IU, IV, IW
from ..ops.stencil import shift_m, shift_p

_X, _Y, _Z = -1, -2, -3


def kahan_add(u, c, d):
    """Kahan-compensated u + d with the running carry c: (u', c') with
    y = d - c; u' = u + y; c' = (u' - u) - y (JAX godunov_mhd.py:414-423)."""
    y = d - c
    t = u + y
    return t, (t - u) - y


def uses_dissipation(params: RunParams) -> bool:
    return params.nu > 0 or params.eta > 0


def _require_3d(params: RunParams) -> None:
    if params.dim != 3:
        raise NotImplementedError("2D viscosity / resistivity is not ported")


def _div(x, d):
    """x / d for a Python float d, rounded to x's dtype first: a true
    division on every device, as the CUDA kernel divides. (PyTorch's CUDA
    kernels multiply by the reciprocal of a Python scalar divisor, one
    rounding more, which the dissipative increment, a difference of nearly
    equal fluxes, would show at 1e-6 of its norm in f32.)"""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def _favg(f, axis):
    """Average to the left face along axis: 0.5*(f[i] + f[i-1])."""
    return 0.5 * (f + shift_m(f, axis))


def _bdiff(f, axis, d):
    """Backward difference at the left face along axis: (f[i]-f[i-1])/d."""
    return _div(f - shift_m(f, axis), d)


def _tavg4(f, face_axis, t_axis, d):
    """Transverse derivative at a face: the centred difference along t_axis
    of the face sum, ((f[i]+f[i-1])[t+1] - (..)[t-1]) / (4 d)."""
    g = f + shift_m(f, face_axis)
    return _div(shift_p(g, t_axis) - shift_m(g, t_axis), 4.0 * d)


def _apply_flux_update(params: RunParams, U, fluxes):
    """U[c] += flux[c] - flux[c+1] on the interior (a new tensor)."""
    g = params.ghost_width
    interior = (slice(g, -g),) * 3
    U = U.clone()
    for axis, comp in fluxes.items():
        for slot, flx in comp.items():
            U[(slot,) + interior] += (flx - shift_p(flx, axis))[interior]
    return U


def compute_viscosity_fluxes(params: RunParams, U, dt):
    """Navier-Stokes stress fluxes {axis: {slot: flux}} at each cell's left
    face (viscosity.cuh:412+); the energy flux only with cIso <= 0."""
    _require_3d(params)
    nu = params.nu
    two3rd = 2.0 / 3.0
    rho = U[ID]
    vels = (U[IU] / rho, U[IV] / rho, U[IW] / rho)
    with_energy = params.c_iso <= 0
    axes, dhs, vel_slots = (_X, _Y, _Z), (params.dx, params.dy, params.dz), (IU, IV, IW)

    fluxes: dict = {}
    for nvel, (axis, dh) in enumerate(zip(axes, dhs)):
        rho_f = _favg(rho, axis)
        # normal derivative of each velocity component at the face
        dnorm = [_bdiff(q, axis, dh) for q in vels]
        # transverse derivatives of each velocity at the face
        dtrans = {t_i: [_tavg4(q, axis, t_axis, t_dh) for q in vels]
                  for t_i, (t_axis, t_dh) in enumerate(zip(axes, dhs)) if t_axis != axis}
        div_t = sum(dtrans[t_i][t_i] for t_i in dtrans)
        t_norm = -two3rd * nu * rho_f * (2.0 * dnorm[nvel] - div_t)
        comp = {vel_slots[nvel]: _div(t_norm * dt, dh)}
        stresses = {nvel: t_norm}
        for t_i in dtrans:
            t_shear = -nu * rho_f * (dtrans[t_i][nvel] + dnorm[t_i])
            comp[vel_slots[t_i]] = _div(t_shear * dt, dh)
            stresses[t_i] = t_shear
        if with_energy:
            e_flux = sum(_favg(vels[k], axis) * s for k, s in stresses.items())
            comp[IP] = _div(e_flux * dt, dh)
        fluxes[axis] = comp
    return fluxes


def apply_viscosity(params: RunParams, U, dt):
    """The viscous sub-step of a ghosted state (MHD or hydro) whose ghosts
    a fill has written: a new tensor, its interior updated."""
    return _apply_flux_update(params, U, compute_viscosity_fluxes(params, U, dt))


def viscosity_(params: RunParams, U, dt, active=None):
    """``apply_viscosity`` in place on the ghosted U (its interior; the
    ghosts stay the fill's), when the 0-d bool ``active`` is true.
    Returns U."""
    g = params.ghost_width
    inner = (slice(None),) + (slice(g, -g),) * 3
    new = apply_viscosity(params, U, dt)[inner]
    U[inner] = new if active is None else torch.where(active, new, U[inner])
    return U


def compute_resistivity_emf(params: RunParams, U):
    """Resistive EMF -eta J at the edges (resistivity.cuh:233-330):
    (emf_z, emf_y, emf_x)."""
    _require_3d(params)
    eta = params.eta
    dx, dy, dz = params.dx, params.dy, params.dz
    bx, by, bz = U[IA], U[IB], U[IC]
    jx = _bdiff(bz, _Y, dy) - _bdiff(by, _Z, dz)
    jy = _bdiff(bx, _Z, dz) - _bdiff(bz, _X, dx)
    jz = _bdiff(by, _X, dx) - _bdiff(bx, _Y, dy)
    return -eta * jz, -eta * jy, -eta * jx


def _ct_deltas(params: RunParams, emfs, dt):
    """The CT curl (dbx, dby, dbz) of the edge EMFs (emf_z, emf_y, emf_x)."""
    emf_z, emf_y, emf_x = emfs
    dtdx, dtdy, dtdz = _div(dt, params.dx), _div(dt, params.dy), _div(dt, params.dz)
    dbx = (shift_p(emf_z, _Y) - emf_z) * dtdy - (shift_p(emf_y, _Z) - emf_y) * dtdz
    dby = (shift_p(emf_x, _Z) - emf_x) * dtdz - (shift_p(emf_z, _X) - emf_z) * dtdx
    dbz = (shift_p(emf_y, _X) - emf_y) * dtdx - (shift_p(emf_x, _Y) - emf_x) * dtdy
    return dbx, dby, dbz


def apply_resistivity_ct(params: RunParams, U, dt):
    """CT update with the resistive EMF on the interior and the first high
    ghost layer (the JAX ``ct`` range; a new tensor)."""
    g = params.ghost_width
    ct = tuple(slice(g, n - g + 1) for n in U.shape[1:])
    deltas = _ct_deltas(params, compute_resistivity_emf(params, U), dt)
    U = U.clone()
    for slot, d in zip((IA, IB, IC), deltas):
        U[(slot,) + ct] += d[ct]
    return U


def compute_resistivity_energy_fluxes(params: RunParams, U, dt):
    """Resistive Poynting energy fluxes {axis: {IP: flux}} at the faces
    (resistivity.cuh kernel_resistivity_energy_flux_3d)."""
    _require_3d(params)
    eta = params.eta
    dx, dy, dz = params.dx, params.dy, params.dz
    bx, by, bz = U[IA], U[IB], U[IC]
    jx_edge = _bdiff(bz, _Y, dy) - _bdiff(by, _Z, dz)
    jy_edge = _bdiff(bx, _Z, dz) - _bdiff(bz, _X, dx)
    jz_edge = _bdiff(by, _X, dx) - _bdiff(bx, _Y, dy)

    def pair(j_edge, axis):
        """An edge-centred current averaged to the face: (j + j[axis+1])/2."""
        return 0.5 * (j_edge + shift_p(j_edge, axis))

    def quad(f, face_axis, t_axis):
        return 0.25 * (f + shift_m(f, face_axis) + shift_p(f, t_axis)
                       + shift_p(shift_m(f, face_axis), t_axis))

    def flux(j1, b2, j2, b1, dh):
        """-eta (j1 b2 - j2 b1) dt / dh."""
        return _div(-eta * (j1 * b2 - j2 * b1) * dt, dh)

    fx = flux(pair(jy_edge, _Z), quad(bz, _X, _Z), pair(jz_edge, _Y), quad(by, _X, _Y), dx)
    fy = flux(pair(jz_edge, _X), quad(bx, _Y, _X), pair(jx_edge, _Z), quad(bz, _Y, _Z), dy)
    fz = flux(pair(jx_edge, _Y), quad(by, _Z, _Y), pair(jy_edge, _X), quad(bx, _Z, _X), dz)
    return {_X: {IP: fx}, _Y: {IP: fy}, _Z: {IP: fz}}


def apply_dissipation_mhd(params: RunParams, U, dt):
    """The dissipative sub-step on a ghosted state, sequenced as
    mhd_godunov_unsplit_cpu_v1.cpp:300-345: resistive EMF + CT, the
    resistive energy flux from the CT-updated B (cIso <= 0 only), then the
    viscous fluxes. A new tensor."""
    if params.eta > 0:
        U = apply_resistivity_ct(params, U, dt)
        if params.c_iso <= 0:
            U = _apply_flux_update(params, U, compute_resistivity_energy_fluxes(params, U, dt))
    if params.nu > 0:
        U = apply_viscosity(params, U, dt)
    return U


def _interior_update(params: RunParams, W, dt, margin, comp=None, cube: bool = False,
                     ey_rows: int = 0):
    """The interior-only dissipative update of the window W, whose interior
    starts ``margin`` = (mz, my, mx) cells in: (new interior [8, nz, ny, nx],
    emfY and emfZ at the interior's xmax face, or None without resistivity;
    emfY with ``ey_rows`` more rows above the interior's).
    ``comp``: the interior's carry [8, nz, ny, nx]; then the new interior
    is compensated, [16, nz, ny, nx] (state, then carry). ``cube``: the
    CT updates B on the interior and its max-side face layer only (the
    whole-array ``ct`` range), not on the whole extent."""
    _require_3d(params)
    mz, my, mx = margin

    def crop(f):
        return f[..., mz:mz + params.nz, my:my + params.ny, mx:mx + params.nx]

    W2 = W
    eypl = ezpl = None
    dB = {}
    if params.eta > 0:
        emfs = compute_resistivity_emf(params, W)
        # the CT on the whole extent: later stages read the updated B one
        # cell outside the interior
        W2 = W.clone()
        ct = (slice(mz, mz + params.nz + 1), slice(my, my + params.ny + 1),
              slice(mx, mx + params.nx + 1)) if cube else (slice(None),) * 3
        for slot, d in zip((IA, IB, IC), _ct_deltas(params, emfs, dt)):
            W2[(slot,) + ct] = W[(slot,) + ct] + d[ct]
            dB[slot] = crop(d)
        face = (mx + params.nx) % W.shape[-1]  # periodic: face nx is face 0
        eypl = emfs[1][mz:mz + params.nz + ey_rows, my:my + params.ny, face]
        ezpl = emfs[0][mz:mz + params.nz, my:my + params.ny, face]

    dU = {}
    if params.eta > 0 and params.c_iso <= 0:
        for axis, comps in compute_resistivity_energy_fluxes(params, W2, dt).items():
            for slot, flx in comps.items():
                dU[slot] = dU.get(slot, 0.0) + crop(flx - shift_p(flx, axis))
    if params.nu > 0:
        for axis, comps in compute_viscosity_fluxes(params, W2, dt).items():
            for slot, flx in comps.items():
                dU[slot] = dU.get(slot, 0.0) + crop(flx - shift_p(flx, axis))
    if comp is None:
        out = [crop(W2[c]) for c in range(8)]
        for slot, d in dU.items():
            out[slot] = out[slot] + d
        return torch.stack(out), eypl, ezpl
    deltas = {**dU, **dB}
    outs, carries = [], []
    for c in range(8):
        u, carry = crop(W[c]), comp[c]
        if c in deltas:
            u, carry = kahan_add(u, carry, deltas[c])
        outs.append(u)
        carries.append(carry)
    return torch.stack(outs + carries), eypl, ezpl


def mhd_dissipation_interior_update(params: RunParams, U, dt, shear_planes: bool = False,
                                    comp=None):
    """The new interior [8, nz, ny, nx] of a ghosted state after the
    dissipative sub-step in the kernel's form (CT on the whole extent);
    with ``shear_planes`` also the resistive emfY and emfZ at the xmax face
    (None without resistivity). ``comp``: a carry in U's layout (only its
    interior is read); then the result is compensated, [16, nz, ny, nx]."""
    g = params.ghost_width
    if comp is not None:
        comp = comp[:, g:g + params.nz, g:g + params.ny, g:g + params.nx]
    out, eypl, ezpl = _interior_update(params, U, dt, (g, g, g), comp)
    return (out, eypl, ezpl) if shear_planes else out


def mhd_dissipation_ghosted_update(params: RunParams, U, dt):
    """The dissipative sub-step of the JAX whole-array step on a ghosted
    state U [8, nz+2g, ny+2g, nx+2g] whose ghosts a fill has written
    (``apply_dissipation_mhd`` on the refilled array, godunov_mhd.py:748-761):
    the new interior, the energy and viscous fluxes summed in the kernel's
    order, and the resistive CT's new B on the max-side face layer (the
    whole-array ``ct`` range); every other ghost as U has it. A new
    tensor. The plain twin of the dissipation kernel's ghosted mode (walls,
    the jet)."""
    g = params.ghost_width
    out = apply_resistivity_ct(params, U, dt) if params.eta > 0 else U.clone()
    out[:, g:-g, g:-g, g:-g] = _interior_update(params, U, dt, (g, g, g), cube=True)[0]
    return out


def mhd_dissipation_periodic_update(params: RunParams, S, dt):
    """The dissipative sub-step of the interior-only periodic state
    [8, nz, ny, nx], or of a compensated one [16, ...]: the plain twin of
    the kernel's periodic mode."""
    comp = S[8:] if S.shape[0] == 16 else None
    return _interior_update(params, S[:8], dt, (0, 0, 0), comp)[0]


def mhd_dissipation_shear_update(params: RunParams, S, slabs, dt, zslabs=None):
    """The dissipative sub-step of the shearing box's interior S (8 or, with
    its carry, 16 channels) with the sheared x ghost slabs [2, 8, nz, ny, g]
    beside it (y and z wrap; stratified: ``zslabs`` [2, 8, g, ny, nx + 2g],
    the z ghost slabs of that block, below and above it, and y wraps):
    (S_new, eypl, ezpl), the twin of the kernel's shear mode before the
    kept face's update (``kept_face_resistive_ct``)."""
    comp = S[8:] if S.shape[0] == 16 else None
    W = torch.cat([slabs[0], S[:8], slabs[1]], dim=-1)
    g = params.ghost_width
    if zslabs is None:
        return _interior_update(params, W, dt, (0, 0, g), comp)
    W = torch.cat([zslabs[0], W, zslabs[1]], dim=-3)
    # (emfY's row above the interior: the kept face's CT reads it)
    return _interior_update(params, W, dt, (g, 0, g), comp, ey_rows=1)


def kept_face_resistive_ct(params: RunParams, kept, eypl, ezpl, dt):
    """The kept Bx face after the resistive CT with the xmax-face emfY and
    emfZ planes [nz, ny] (pallas/shear_packed.py:1191-1203; the whole-array
    ``ct`` range reaches that face); emfY [nz + 1, ny] carries its own +1 z
    row (the stratified box's, from the z ghosts), else that row wraps. A
    compensated kept carry [2, nz, ny] (face, carry) takes it as a Kahan
    add."""
    dtdy, dtdz = _div(dt, params.dy), _div(dt, params.dz)
    ey_up = eypl[1:] if eypl.shape[0] > ezpl.shape[0] else torch.roll(eypl, -1, 0)
    eypl = eypl[:ezpl.shape[0]]
    d = dtdy * (torch.roll(ezpl, -1, 1) - ezpl) - dtdz * (ey_up - eypl)
    if kept.dim() == 3:
        return torch.stack(kahan_add(kept[0], kept[1], d))
    return kept + d
