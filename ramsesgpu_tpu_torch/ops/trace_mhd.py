"""MUSCL-Hancock trace for 2D MHD with constrained transport, whole-array
(the PyTorch twin of ramsesgpu_tpu/ops/trace_mhd.py; reference
trace_mhd.h:38-360 trace_unsplit_mhd_2d, from the DUMSES trace2d).

For every cell it gives the face states of the 1D Riemann problems
(qm[d], qp[d], d = x, y; the normal field slot holds the face-centred B
there) and the four corner states qRT, qRB, qLT, qLB of the 2D EMF
solver. The predictor advances the cell-centred primitives a half step,
magnetic tension and pressure cross terms included, and the four
face-centred field values with the corner-averaged electric field (the
induction equation's half step).
"""
from __future__ import annotations

import torch

from ..config.params import RunParams
from ..core.constants import IA, IB, IC, ID, IP, IU, IV, IW
from .backend import xp
from .slopes import slope_1d

_X, _Y = -1, -2


def trace_unsplit_mhd_2d(params: RunParams, Q: torch.Tensor, bfx: torch.Tensor,
                         bfy: torch.Tensor, dt, xpos: torch.Tensor):
    """``(qm_x, qm_y), (qp_x, qp_y), (qRT, qRB, qLT, qLB)``, each [8, ny, nx],
    from the cell-centred primitives Q [8, ny, nx], the face-centred Bx at
    each cell's left x face (``bfx`` = U[IA]) and By at its left y face
    (``bfy`` = U[IB]), the time step and the cell-centre x coordinates
    ``xpos`` (broadcastable; read only when omega0 > 0)."""
    smallr, smallp, gamma = params.smallr, params.smallp, params.gamma0
    omega0 = params.omega0
    dtdx = dt / params.dx
    dtdy = dt / params.dy
    sp, sm = xp.shift_p, xp.shift_m

    # corner electric field Ez at (i-1/2, j-1/2) (trace_mhd.h:70-99)
    def corner_avg4(f):
        return 0.25 * (f + sm(f, _X) + sm(f, _Y) + sm(sm(f, _X), _Y))

    u4 = corner_avg4(Q[IU])
    v4 = corner_avg4(Q[IV])
    A_c = 0.5 * (bfx + sm(bfx, _Y))
    B_c = 0.5 * (bfy + sm(bfy, _X))
    EzC = u4 * B_c - v4 * A_c  # the EMF at the cell's lower-left corner

    ELL = EzC
    ERL = sp(EzC, _X)
    ELR = sp(EzC, _Y)
    ERR = sp(sp(EzC, _X), _Y)

    # cell-centred values and half-slopes (trace_mhd.h:102-148)
    r, p = Q[ID], Q[IP]
    u, v, w = Q[IU], Q[IV], Q[IW]
    A, B, C = Q[IA], Q[IB], Q[IC]

    AL, AR = bfx, sp(bfx, _X)
    BL, BR = bfy, sp(bfy, _Y)

    hx = 0.5 * slope_1d(params, Q, _X)
    hy = 0.5 * slope_1d(params, Q, _Y)
    drx, dpx, dux, dvx, dwx = hx[ID], hx[IP], hx[IU], hx[IV], hx[IW]
    dBx, dCx = hx[IB], hx[IC]
    dry, dpy, duy, dvy, dwy = hy[ID], hy[IP], hy[IU], hy[IV], hy[IW]
    dAy, dCy = hy[IA], hy[IC]

    # transverse TVD slopes of the face-centred fields (slope_mhd.h:524-574)
    dbf_bx_y = slope_1d(params, bfx, _Y)  # d(bx)/dy at each cell's left x face
    dbf_by_x = slope_1d(params, bfy, _X)  # d(by)/dx at each cell's left y face
    dALy = 0.5 * dbf_bx_y
    dARy = 0.5 * sp(dbf_bx_y, _X)
    dBLx = 0.5 * dbf_by_x
    dBRx = 0.5 * sp(dbf_by_x, _Y)

    # normal-direction face-difference slopes
    dAx = 0.5 * (AR - AL)
    dBy = 0.5 * (BR - BL)

    # source terms incl. transverse derivatives (trace_mhd.h:201-226)
    sr0 = (-u * drx - dux * r) * dtdx + (-v * dry - dvy * r) * dtdy
    su0 = (-u * dux - dpx / r - B * dBx / r - C * dCx / r) * dtdx + (-v * duy + B * dAy / r) * dtdy
    sv0 = (-u * dvx + A * dBx / r) * dtdx + (-v * dvy - dpy / r - A * dAy / r - C * dCy / r) * dtdy
    sw0 = (-u * dwx + A * dCx / r) * dtdx + (-v * dwy + B * dCy / r) * dtdy
    sp0 = (-u * dpx - dux * gamma * p) * dtdx + (-v * dpy - dvy * gamma * p) * dtdy
    sA0 = (u * dBy + B * duy - v * dAy - A * dvy) * dtdy
    sB0 = (-u * dBx - B * dux + v * dAx + A * dvx) * dtdx
    sC0 = (w * dAx + A * dwx - u * dCx - C * dux) * dtdx + (
        -v * dCy - C * dvy + w * dBy + B * dwy
    ) * dtdy
    if omega0 > 0:
        shear = -1.5 * omega0 * xpos
        sC0 = sC0 + (shear * dAx - 1.5 * omega0 * A) * dtdx + shear * dBy * dtdy

    # face-centred field half step (induction with the corner EMFs)
    sAL0 = +(ELR - ELL) * 0.5 * dtdy
    sAR0 = +(ERR - ERL) * 0.5 * dtdy
    sBL0 = -(ERL - ELL) * 0.5 * dtdx
    sBR0 = -(ERR - ELR) * 0.5 * dtdx

    r2, u2, v2, w2, p2 = r + sr0, u + su0, v + sv0, w + sw0, p + sp0
    A2, B2, C2 = A + sA0, B + sB0, C + sC0
    AL2, AR2 = AL + sAL0, AR + sAR0
    BL2, BR2 = BL + sBL0, BR + sBR0

    def state(rho, pres, uu, vv, ww, a_, b_, c_):
        rho = xp.maximum(smallr, rho)
        pres = xp.maximum(smallp * rho, pres)
        return torch.stack([rho, pres, uu, vv, ww, a_, b_, c_])

    # face states (trace_mhd.h:244-290)
    qp_x = state(r2 - drx, p2 - dpx, u2 - dux, v2 - dvx, w2 - dwx, AL2, B2 - dBx, C2 - dCx)
    qm_x = state(r2 + drx, p2 + dpx, u2 + dux, v2 + dvx, w2 + dwx, AR2, B2 + dBx, C2 + dCx)
    qp_y = state(r2 - dry, p2 - dpy, u2 - duy, v2 - dvy, w2 - dwy, A2 - dAy, BL2, C2 - dCy)
    qm_y = state(r2 + dry, p2 + dpy, u2 + duy, v2 + dvy, w2 + dwy, A2 + dAy, BR2, C2 + dCy)

    # corner states (trace_mhd.h:293-359)
    qRT = state(r2 + drx + dry, p2 + dpx + dpy, u2 + dux + duy, v2 + dvx + dvy,
                w2 + dwx + dwy, AR2 + dARy, BR2 + dBRx, C2 + dCx + dCy)
    qRB = state(r2 + drx - dry, p2 + dpx - dpy, u2 + dux - duy, v2 + dvx - dvy,
                w2 + dwx - dwy, AR2 - dARy, BL2 + dBLx, C2 + dCx - dCy)
    qLB = state(r2 - drx - dry, p2 - dpx - dpy, u2 - dux - duy, v2 - dvx - dvy,
                w2 - dwx - dwy, AL2 - dALy, BL2 - dBLx, C2 - dCx - dCy)
    qLT = state(r2 - drx + dry, p2 - dpx + dpy, u2 - dux + duy, v2 - dvx + dvy,
                w2 - dwx + dwy, AL2 + dALy, BR2 - dBRx, C2 - dCx + dCy)

    return (qm_x, qm_y), (qp_x, qp_y), (qRT, qRB, qLT, qLB)
