"""Equation of state and conservative <-> primitive conversion (the
PyTorch twin of ramsesgpu_tpu/ops/eos.py; reference constoprim.h:28-199).

Conserved state U layout: [nvar, (z,) y, x] with components ID, IP(=E),
IU, IV(, IW) (hydro: nvar 4 in 2D, 5 in 3D) and IW, IA, IB, IC (MHD: nvar
8 in 2D and 3D); the face-centred field sits at each cell's LEFT face. In
2D Bz is cell-centred (the DUMSES convention).
"""
from __future__ import annotations

import torch

from ..config.params import RunParams
from ..core.constants import IA, IB, IC, ID, IP, IU, IV, IW

from .backend import xp


def eos(params: RunParams, rho: torch.Tensor, eint: torch.Tensor):
    """Pressure and sound speed from density and specific internal energy
    (constoprim.h:29-33)."""
    p = xp.maximum((params.gamma0 - 1.0) * rho * eint, rho * params.smallp)
    c = xp.sqrt(params.gamma0 * p / rho)
    return p, c


def constoprim_hydro(params: RunParams, U: torch.Tensor):
    """Hydro conservative -> primitive (ramsesgpu_tpu ops/eos.py:28;
    constoprim.h:43-111). Returns (Q, c): Q = (rho, p, u, v[, w]) and the
    sound speed; the isothermal EOS when cIso > 0."""
    rho = xp.maximum(U[ID], params.smallr)
    inv_rho = 1.0 / rho
    velocities = [U[IU] * inv_rho, U[IV] * inv_rho]
    if params.dim == 3:
        velocities.append(U[IW] * inv_rho)
    eken = 0.5 * sum(v * v for v in velocities)

    if params.c_iso > 0:
        p = rho * params.c_iso * params.c_iso
        c = torch.full_like(rho, params.c_iso)
    else:
        eint = U[IP] * inv_rho - eken
        p = xp.maximum((params.gamma0 - 1.0) * rho * eint, rho * params.smallp)
        c = xp.sqrt(params.gamma0 * p * inv_rho)
    return torch.stack([rho, p, *velocities]), c


def prim_to_cons_hydro(params: RunParams, Q: torch.Tensor) -> torch.Tensor:
    """Primitive -> conservative, the inverse of constoprim_hydro
    (ramsesgpu_tpu ops/eos.py:107)."""
    rho, p = Q[ID], Q[IP]
    velocities = [Q[IU], Q[IV]] + ([Q[IW]] if params.dim == 3 else [])
    eken = 0.5 * rho * sum(v * v for v in velocities)
    e_tot = p / (params.gamma0 - 1.0) + eken
    return torch.stack([rho, e_tot, *[rho * v for v in velocities]])


def constoprim_mhd(params: RunParams, U: torch.Tensor, dt=None):
    """MHD conservative -> primitive (ramsesgpu_tpu ops/eos.py:56).

    The primitive cell-centred B is the average of the cell's left face and
    the next cell's left face (in 2D Bz is already cell-centred). Returns
    (Q, c). With omega0 > 0 the velocities get the Coriolis predictor
    half-kick over ``dt`` (constoprim.h:190-195)."""
    rho = xp.maximum(U[ID], params.smallr)
    inv_rho = 1.0 / rho
    u = U[IU] * inv_rho
    v = U[IV] * inv_rho
    w = U[IW] * inv_rho

    bx = 0.5 * (U[IA] + xp.shift_p(U[IA], -1))
    by = 0.5 * (U[IB] + xp.shift_p(U[IB], -2))
    bz = 0.5 * (U[IC] + xp.shift_p(U[IC], -3)) if params.dim == 3 else U[IC]

    eken = 0.5 * (u * u + v * v + w * w)
    emag = 0.5 * (bx * bx + by * by + bz * bz)

    if params.c_iso > 0:
        p = rho * params.c_iso * params.c_iso
        c = torch.full_like(rho, params.c_iso)
    else:
        eint = (U[IP] - emag) * inv_rho - eken
        p = xp.maximum((params.gamma0 - 1.0) * rho * eint, rho * params.smallp)
        c = xp.sqrt(params.gamma0 * p * inv_rho)

    if params.omega0 > 0:
        dvx = 2.0 * params.omega0 * v
        dvy = -0.5 * params.omega0 * u
        u = u + dvx * dt * 0.5
        v = v + dvy * dt * 0.5

    Q = torch.stack([rho, p, u, v, w, bx, by, bz])
    return Q, c
