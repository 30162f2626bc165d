"""MUSCL-Hancock trace (half-step predictor) of the unsplit hydro scheme,
whole-array (the PyTorch twin of ramsesgpu_tpu/ops/trace.py; reference
trace.h:332-661, trace_unsplit_hydro_2d/3d, the unsplitVersion=1 path).

Returns per-direction face states:
  qm[d]: left state at the *right* face of the cell along direction d
  qp[d]: right state at the *left* face of the cell along direction d
so the Riemann problem at face i-1/2 along x is (qm_x[i-1], qp_x[i]).
"""
from __future__ import annotations

import torch

from ..config.params import RunParams
from ..core.constants import ID, IP, IU, IV, IW
from .backend import xp


def trace_unsplit_hydro(params: RunParams, Q: torch.Tensor, dq: tuple, dt):
    """(qm, qp), each a tuple (x, y[, z]) of face states of Q's shape, from
    the primitive state Q [4, ny, nx] or [5, nz, ny, nx], its limited
    slopes (dqX, dqY[, dqZ]) and the time step ``dt`` (a 0-d tensor or a
    float)."""
    smallr, smallp, gamma = params.smallr, params.smallp, params.gamma0
    dtdx = dt / params.dx
    dtdy = dt / params.dy

    r, p, u, v = Q[ID], Q[IP], Q[IU], Q[IV]
    hx, hy = 0.5 * dq[0], 0.5 * dq[1]
    drx, dpx, dux, dvx = hx[ID], hx[IP], hx[IU], hx[IV]
    dry, dpy, duy, dvy = hy[ID], hy[IP], hy[IU], hy[IV]

    # source terms incl. transverse derivatives, one hoisted 1/r
    inv_r = 1.0 / r
    if params.dim == 2:
        # trace.h:365-372
        sr0 = (-u * drx - dux * r) * dtdx + (-v * dry - dvy * r) * dtdy
        su0 = (-u * dux - dpx * inv_r) * dtdx + (-v * duy) * dtdy
        sv0 = (-u * dvx) * dtdx + (-v * dvy - dpy * inv_r) * dtdy
        sp0 = (-u * dpx - dux * gamma * p) * dtdx + (-v * dpy - dvy * gamma * p) * dtdy
        r2, u2, v2, p2 = r + sr0, u + su0, v + sv0, p + sp0
        slopes = ((drx, dpx, dux, dvx), (dry, dpy, duy, dvy))
        moving = (u2, v2)
    else:
        dtdz = dt / params.dz
        w = Q[IW]
        hz = 0.5 * dq[2]
        dwx, dwy = hx[IW], hy[IW]
        drz, dpz, duz, dvz, dwz = hz[ID], hz[IP], hz[IU], hz[IV], hz[IW]
        sr0 = (-u * drx - dux * r) * dtdx + (-v * dry - dvy * r) * dtdy + (-w * drz - dwz * r) * dtdz
        su0 = (-u * dux - dpx * inv_r) * dtdx + (-v * duy) * dtdy + (-w * duz) * dtdz
        sv0 = (-u * dvx) * dtdx + (-v * dvy - dpy * inv_r) * dtdy + (-w * dvz) * dtdz
        sw0 = (-u * dwx) * dtdx + (-v * dwy) * dtdy + (-w * dwz - dpz * inv_r) * dtdz
        sp0 = (
            (-u * dpx - dux * gamma * p) * dtdx
            + (-v * dpy - dvy * gamma * p) * dtdy
            + (-w * dpz - dwz * gamma * p) * dtdz
        )
        r2, u2, v2, w2, p2 = r + sr0, u + su0, v + sv0, w + sw0, p + sp0
        slopes = ((drx, dpx, dux, dvx, dwx), (dry, dpy, duy, dvy, dwy),
                  (drz, dpz, duz, dvz, dwz))
        moving = (u2, v2, w2)

    def face(dr, dp, *dvel, sign):
        rho_f = xp.maximum(smallr, r2 + sign * dr)
        p_f = xp.maximum(smallp * rho_f, p2 + sign * dp)
        return torch.stack([rho_f, p_f, *(m + sign * d for m, d in zip(moving, dvel))])

    qp = tuple(face(*h, sign=-1.0) for h in slopes)
    qm = tuple(face(*h, sign=+1.0) for h in slopes)
    return qm, qp
