"""MUSCL-Hancock trace (half-step predictor) of the unsplit 3D hydro
scheme, whole-array (the PyTorch twin of ramsesgpu_tpu/ops/trace.py;
reference trace.h:544-661, the unsplitVersion=1 path).

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
    """(qm, qp), each a tuple (x, y, z) of [5, ...] face states, from the
    primitive state Q [5, nz, ny, nx], its limited slopes (dqX, dqY, dqZ)
    and the time step ``dt`` (a 0-d tensor or a float)."""
    if params.dim != 3:
        raise NotImplementedError("only the 3D hydro trace is ported")
    smallr, smallp, gamma = params.smallr, params.smallp, params.gamma0
    dtdx = dt / params.dx
    dtdy = dt / params.dy
    dtdz = dt / params.dz

    r, p, u, v, w = Q[ID], Q[IP], Q[IU], Q[IV], Q[IW]
    hx, hy, hz = 0.5 * dq[0], 0.5 * dq[1], 0.5 * dq[2]
    drx, dpx, dux, dvx, dwx = hx[ID], hx[IP], hx[IU], hx[IV], hx[IW]
    dry, dpy, duy, dvy, dwy = hy[ID], hy[IP], hy[IU], hy[IV], hy[IW]
    drz, dpz, duz, dvz, dwz = hz[ID], hz[IP], hz[IU], hz[IV], hz[IW]

    # source terms incl. transverse derivatives, one hoisted 1/r
    inv_r = 1.0 / r
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

    def face(dr, dp, du, dv, dw, sign):
        rho_f = xp.maximum(smallr, r2 + sign * dr)
        p_f = xp.maximum(smallp * rho_f, p2 + sign * dp)
        return torch.stack([rho_f, p_f, u2 + sign * du, v2 + sign * dv, w2 + sign * dw])

    qp = tuple(face(*h, -1.0) for h in ((drx, dpx, dux, dvx, dwx), (dry, dpy, duy, dvy, dwy),
                                         (drz, dpz, duz, dvz, dwz)))
    qm = tuple(face(*h, +1.0) for h in ((drx, dpx, dux, dvx, dwx), (dry, dpy, duy, dvy, dwy),
                                         (drz, dpz, duz, dvz, dwz)))
    return qm, qp
