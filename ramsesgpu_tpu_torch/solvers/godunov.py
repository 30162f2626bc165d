"""Unsplit MUSCL-Hancock Godunov step for 2D and 3D hydrodynamics,
whole-array (the PyTorch twin of ramsesgpu_tpu/solvers/godunov.py;
reference HydroRunGodunov.cpp:1860-2500, godunov_unsplit.cuh):

  primitives -> slopes -> trace -> face Riemann problems -> flux update.

flux[c] is the flux through the *left* face of cell c, so
U_new[c] = U[c] + dtdx * (flux[c] - flux[c+1]). Shifts are rolls; on a
ghosted state (g = 2) the ghost layers absorb the wrap. The 3D interior
forms are the plain twins of the CUDA step kernels; the 2D step is
``godunov_unsplit_hydro`` itself (the JAX package has no 2D kernel).
Static gravity: the field (2D) or the constant vector (the 3D twins) kicks
the traced states by 0.5 dt g and adds the conservative source.
"""
from __future__ import annotations

import torch

from ..config.params import RunParams, static_gravity
from ..core.constants import ID, IP, IU, IV, IW
from ..ops.backend import xp
from ..ops.eos import constoprim_hydro
from ..ops.riemann import riemann_hydro
from ..ops.slopes import slopes_unsplit
from ..ops.trace import trace_unsplit_hydro
from .boundary import make_boundaries_concat
from .dissipation import _div

# spatial axis per direction index (0=x, 1=y, 2=z) for the [nvar, (z,) y, x] layout
_AXIS = (-1, -2, -3)


def _rotation(params: RunParams, direction: int) -> list[int]:
    """Component permutation bringing the direction-normal velocity into
    the IU slot (godunov.py:30; HydroRunGodunov.cpp:2062-2068). Each is an
    involution."""
    perm = [ID, IP, IU, IV, IW][: params.nb_var]
    if direction == 1:
        perm[IU], perm[IV] = perm[IV], perm[IU]
    elif direction == 2:
        perm[IU], perm[IW] = perm[IW], perm[IU]
    return perm


def permute(q: torch.Tensor, perm) -> torch.Tensor:
    """q's channels in the order ``perm``, stacked: indexing by a Python
    list would copy an index tensor from the host, a host sync on CUDA
    (the JAX package stacks too, godunov.py:57)."""
    return torch.stack([q[c] for c in perm])


def compute_fluxes(params: RunParams, qm, qp) -> list[torch.Tensor]:
    """flux[d][..., c]: the flux through the left face of cell c along
    direction d, from the Riemann problem (qm[d] at c-1, qp[d] at c)."""
    fluxes = []
    for d in range(params.dim):
        perm = _rotation(params, d)
        ql = permute(xp.shift_m(qm[d], _AXIS[d]), perm)
        qr = permute(qp[d], perm)
        fluxes.append(permute(riemann_hydro(params, ql, qr), perm))
    return fluxes


def _fluxes(params: RunParams, U: torch.Tensor, dt, gravity=None):
    Q, _c = constoprim_hydro(params, U)
    qm, qp = trace_unsplit_hydro(params, Q, slopes_unsplit(params, Q), dt)
    if gravity is not None:
        qm, qp = _kick(qm, gravity, dt), _kick(qp, gravity, dt)
    return compute_fluxes(params, qm, qp)


def _kick(states, gravity, dt):
    """The half-dt gravity predictor on the traced face states
    (godunov.py:132-140; HydroRunGodunov.cpp:1909-1921; MHD:
    godunov_mhd.py:75-85 _gravity_kick): each velocity d gains 0.5 dt
    g_d. ``gravity``: [dim, ...] broadcastable to the states, or one value
    per axis, None for an axis without gravity (the stratified g_z)."""
    out = []
    for q in states:
        q = q.clone()
        for d, slot in enumerate((IU, IV, IW)[:len(gravity)]):
            if gravity[d] is not None:
                q[slot] = q[slot] + 0.5 * dt * gravity[d]
        out.append(q)
    return tuple(out)


def gravity_source(U_old, U_new, gravity, dt):
    """The conservative gravity source on the interior U_new [nvar, ...]
    of the step from U_old's interior (godunov.py:145-158; gravity.cuh
    kernel_gravity_source_term): per axis d, the energy gains dt times the
    time-centred momentum 0.5 (m_old + m_new) times g_d, m_new before its
    own source, and the momentum dt rho_old g_d. A new tensor."""
    outs = list(U_new)
    for d, slot in enumerate((IU, IV, IW)[:len(gravity)]):
        mom_half = 0.5 * (U_old[slot] + outs[slot])
        outs[slot] = outs[slot] + dt * U_old[ID] * gravity[d]
        outs[IP] = outs[IP] + dt * mom_half * gravity[d]
    return torch.stack(outs)


def gravity_vector(params: RunParams, like: torch.Tensor):
    """``static_gravity`` as 0-d tensors of ``like``'s dtype on its
    device (the twins' form), or None."""
    gvec = static_gravity(params)
    if gvec is None:
        return None
    return tuple(torch.tensor(g, dtype=like.dtype, device=like.device) for g in gvec)


def hydro_3d_interior_update(params: RunParams, U: torch.Tensor, dt,
                             gravity=None) -> torch.Tensor:
    """The updated interior [5, nz, ny, nx] of a ghosted 3D hydro state
    (godunov.py:78): the body of the fused step kernels, summed in their
    order ((U + x part) + y part) + z part. ``gravity``: the constant
    vector (gx, gy, gz) or None; the traced states get the half-dt kick and
    the update the conservative source (godunov.py:115-160). The plain
    twin of the CUDA step kernel (kernels/hydro_step.py)."""
    g = params.ghost_width
    interior = (slice(None),) + (slice(g, -g),) * 3
    out = U[interior]
    for d, flux in enumerate(_fluxes(params, U, dt, gravity)):
        step = dt / (params.dx, params.dy, params.dz)[d]
        out = out + step * (flux - xp.shift_p(flux, _AXIS[d]))[interior]
    if gravity is not None:
        out = gravity_source(U[interior], out, gravity, dt)
    return out


def hydro_3d_state_update(params: RunParams, S: torch.Tensor, dt, gravity=None) -> torch.Tensor:
    """One step of the loops' interior-only state S [5, nz, ny, nx]: the
    update of its ghost fill. The plain twin of the CUDA step kernel's
    interior mode (kernels/hydro_step.py)."""
    return hydro_3d_interior_update(
        params, make_boundaries_concat(params, S, interior_only=True), dt, gravity)


def godunov_unsplit_hydro(params: RunParams, U: torch.Tensor, dt,
                          gravity: torch.Tensor | None = None) -> torch.Tensor:
    """One unsplit MUSCL-Hancock update of a ghosted 2D or 3D hydro state
    whose ghosts are filled (godunov.py:111): U with its interior advanced
    by dU = x part + y part (+ z part); dt over the cell size is a true
    division on every device. ``gravity``: the static field [dim, *U's
    spatial shape] or None: the half-dt kick of the traced states and the
    conservative source on the interior (godunov.py:115-160)."""
    g = params.ghost_width
    interior = (slice(None),) + (slice(g, -g),) * params.dim
    dU = torch.zeros_like(U[interior])
    for d, flux in enumerate(_fluxes(params, U, dt, gravity)):
        step = _div(dt, (params.dx, params.dy, params.dz)[d])
        dU = dU + step * (flux - xp.shift_p(flux, _AXIS[d]))[interior]
    U_new = U.clone()
    U_new[interior] += dU
    if gravity is not None:
        U_new[interior] = gravity_source(U[interior], U_new[interior],
                                         gravity[(slice(None),) + interior[1:]], dt)
    return U_new
