"""MUSCL-Hancock trace for 3D MHD with constrained transport (the PyTorch
twin of ramsesgpu_tpu/ops/trace_mhd3d.py; reference trace_mhd.h:806-1418).

Produces, for every cell, the 6 face states qm/qp (x, y, z) of the 1D
Riemann problems and the 4 corner states of each of the 3 edge families
feeding the 2D EMF solvers — 18 stacks of 8 channels.

bfx/bfy/bfz hold B at each cell's LEFT x/y/z face (= U[IA]/U[IB]/U[IC]);
shift_p(bf, axis) is therefore this cell's right face. With omega0 > 0
the rotating-frame terms enter through ``xpos``, the cell-centre x
coordinate broadcastable over the state's last axis (shearing box).
"""
from __future__ import annotations

import torch

from ..config.params import RunParams
from ..core.constants import IA, IB, IC, ID, IP, IU, IV, IW

from .backend import xp
from .slopes import slope_1d

_X, _Y, _Z = -1, -2, -3

# state order of the 18 stacks (the CUDA trace stage writes the same order)
STATE_NAMES = (
    "qp_x", "qm_x", "qp_y", "qm_y", "qp_z", "qm_z",
    "qRT_x", "qRB_x", "qLT_x", "qLB_x",
    "qRT_y", "qRB_y", "qLT_y", "qLB_y",
    "qRT_z", "qRB_z", "qLT_z", "qLB_z",
)


def _corner_avg4(f, ax1, ax2):
    return 0.25 * (
        f
        + xp.shift_m(f, ax1)
        + xp.shift_m(f, ax2)
        + xp.shift_m(xp.shift_m(f, ax1), ax2)
    )


def trace_mhd3d_shared_precursors(params: RunParams, Q, bfx, bfy, bfz, xpos=None):
    """Edge-centred electric fields Ex (i, j-1/2, k-1/2) and Ey
    (i-1/2, j, k-1/2) (trace_mhd.h:850-905) and the in-plane transverse
    slopes of bfz — the precursors consumed at both z and z+1."""
    v4 = _corner_avg4(Q[IV], _Y, _Z)
    w4 = _corner_avg4(Q[IW], _Y, _Z)
    B_e = 0.5 * (bfy + xp.shift_m(bfy, _Z))
    C_e = 0.5 * (bfz + xp.shift_m(bfz, _Y))
    ExC = v4 * C_e - w4 * B_e
    if params.omega0 > 0:
        ExC = ExC + (-1.5 * params.omega0 * xpos) * C_e

    u4 = _corner_avg4(Q[IU], _X, _Z)
    w4b = _corner_avg4(Q[IW], _X, _Z)
    A_e = 0.5 * (bfx + xp.shift_m(bfx, _Z))
    C_e2 = 0.5 * (bfz + xp.shift_m(bfz, _X))
    EyC = w4b * A_e - u4 * C_e2

    s_bz_x = slope_1d(params, bfz, _X)
    s_bz_y = slope_1d(params, bfz, _Y)
    return ExC, EyC, s_bz_x, s_bz_y


def trace_mhd3d_local_precursors(params: RunParams, Q, bfx, bfy):
    """The z slopes of Q, bfx and bfy."""
    return (
        slope_1d(params, Q, _Z),
        slope_1d(params, bfx, _Z),
        slope_1d(params, bfy, _Z),
    )


def trace_unsplit_mhd_3d_parts(params: RunParams, Q, bfx, bfy, bfz, dt, xpos=None):
    """Lazy builders for the 18 face/edge state stacks: a dict
    name -> zero-argument callable returning an [8, ...] tensor."""
    shared = trace_mhd3d_shared_precursors(params, Q, bfx, bfy, bfz, xpos)
    shared_p = tuple(xp.shift_p(f, _Z) for f in shared)
    local = trace_mhd3d_local_precursors(params, Q, bfx, bfy)
    return trace_mhd3d_state_parts(
        params, Q, bfx, bfy, bfz, xp.shift_p(bfz, _Z),
        shared, shared_p, local, dt, xpos,
    )


def trace_mhd3d_state_parts(params: RunParams, Q, bfx, bfy, bfz, bfz_p,
                            shared, shared_p, local, dt, xpos=None):
    """In-plane half-step state assembly (trace_mhd.h:906-1418).
    ``bfz_p`` is bfz at z+1; ``shared``/``shared_p`` are the shared
    precursors at z and z+1; ``local`` the local precursors at z."""
    omega0 = params.omega0
    smallr, smallp, gamma = params.smallr, params.smallp, params.gamma0
    dtdx, dtdy, dtdz = dt / params.dx, dt / params.dy, dt / params.dz

    ExC, EyC, s_bz_x, s_bz_y = shared
    ExC_p, EyC_p, s_bz_x_p, s_bz_y_p = shared_p
    s_qz, s_bx_z, s_by_z = local

    # Ez at (i-1/2, j-1/2, k)
    u4c = _corner_avg4(Q[IU], _X, _Y)
    v4c = _corner_avg4(Q[IV], _X, _Y)
    A_e2 = 0.5 * (bfx + xp.shift_m(bfx, _Y))
    B_e2 = 0.5 * (bfy + xp.shift_m(bfy, _X))
    EzC = u4c * B_e2 - v4c * A_e2
    if omega0 > 0:
        EzC = EzC - (-1.5 * omega0 * (xpos - params.dx / 2)) * A_e2

    ELL, ELR = ExC, ExC_p
    ERL, ERR = xp.shift_p(ExC, _Y), xp.shift_p(ExC_p, _Y)
    FLL, FLR = EyC, EyC_p
    FRL, FRR = xp.shift_p(EyC, _X), xp.shift_p(EyC_p, _X)
    GLL, GLR = EzC, xp.shift_p(EzC, _Y)
    GRL, GRR = xp.shift_p(EzC, _X), xp.shift_p(xp.shift_p(EzC, _X), _Y)

    r, p = Q[ID], Q[IP]
    u, v, w = Q[IU], Q[IV], Q[IW]
    A, B, C = Q[IA], Q[IB], Q[IC]

    AL, AR = bfx, xp.shift_p(bfx, _X)
    BL, BR = bfy, xp.shift_p(bfy, _Y)
    CL, CR = bfz, bfz_p

    hx = 0.5 * slope_1d(params, Q, _X)
    hy = 0.5 * slope_1d(params, Q, _Y)
    hz = 0.5 * s_qz
    drx, dpx, dux, dvx, dwx = hx[ID], hx[IP], hx[IU], hx[IV], hx[IW]
    dBx, dCx = hx[IB], hx[IC]
    dry, dpy, duy, dvy, dwy = hy[ID], hy[IP], hy[IU], hy[IV], hy[IW]
    dAy, dCy = hy[IA], hy[IC]
    drz, dpz, duz, dvz, dwz = hz[ID], hz[IP], hz[IU], hz[IV], hz[IW]
    dAz, dBz = hz[IA], hz[IB]

    s_bx_y = slope_1d(params, bfx, _Y)
    s_by_x = slope_1d(params, bfy, _X)

    dALy, dALz = 0.5 * s_bx_y, 0.5 * s_bx_z
    dARy, dARz = 0.5 * xp.shift_p(s_bx_y, _X), 0.5 * xp.shift_p(s_bx_z, _X)
    dBLx, dBLz = 0.5 * s_by_x, 0.5 * s_by_z
    dBRx, dBRz = 0.5 * xp.shift_p(s_by_x, _Y), 0.5 * xp.shift_p(s_by_z, _Y)
    dCLx, dCLy = 0.5 * s_bz_x, 0.5 * s_bz_y
    dCRx, dCRy = 0.5 * s_bz_x_p, 0.5 * s_bz_y_p

    dAx = 0.5 * (AR - AL)
    dBy = 0.5 * (BR - BL)
    dCz = 0.5 * (CR - CL)

    # source terms (trace_mhd.h:1127-1155), one hoisted 1/r
    inv_r = 1.0 / r
    sr0 = (-u * drx - dux * r) * dtdx + (-v * dry - dvy * r) * dtdy + (-w * drz - dwz * r) * dtdz
    su0 = (
        (-u * dux - (dpx + B * dBx + C * dCx) * inv_r) * dtdx
        + (-v * duy + B * dAy * inv_r) * dtdy
        + (-w * duz + C * dAz * inv_r) * dtdz
    )
    sv0 = (
        (-u * dvx + A * dBx * inv_r) * dtdx
        + (-v * dvy - (dpy + A * dAy + C * dCy) * inv_r) * dtdy
        + (-w * dvz + C * dBz * inv_r) * dtdz
    )
    sw0 = (
        (-u * dwx + A * dCx * inv_r) * dtdx
        + (-v * dwy + B * dCy * inv_r) * dtdy
        + (-w * dwz - (dpz + A * dAz + B * dBz) * inv_r) * dtdz
    )
    sp0 = (
        (-u * dpx - dux * gamma * p) * dtdx
        + (-v * dpy - dvy * gamma * p) * dtdy
        + (-w * dpz - dwz * gamma * p) * dtdz
    )
    sA0 = (u * dBy + B * duy - v * dAy - A * dvy) * dtdy + (
        u * dCz + C * duz - w * dAz - A * dwz
    ) * dtdz
    sB0 = (v * dAx + A * dvx - u * dBx - B * dux) * dtdx + (
        v * dCz + C * dvz - w * dBz - B * dwz
    ) * dtdz
    sC0 = (w * dAx + A * dwx - u * dCx - C * dux) * dtdx + (
        w * dBy + B * dwy - v * dCy - C * dvy
    ) * dtdy

    if omega0 > 0:
        shear = -1.5 * omega0 * xpos
        sr0 = sr0 - shear * dry * dtdy
        su0 = su0 - shear * duy * dtdy
        sv0 = sv0 - shear * dvy * dtdy
        sw0 = sw0 - shear * dwy * dtdy
        sp0 = sp0 - shear * dpy * dtdy
        sA0 = sA0 - shear * dAy * dtdy
        sB0 = sB0 + (shear * dAx - 1.5 * omega0 * A * params.dx) * dtdx + shear * dBz * dtdz
        sC0 = sC0 - shear * dCy * dtdy

    # face-centred field half-step (induction; trace_mhd.h:1152-1158)
    sAL0 = +(GLR - GLL) * dtdy * 0.5 - (FLR - FLL) * dtdz * 0.5
    sAR0 = +(GRR - GRL) * dtdy * 0.5 - (FRR - FRL) * dtdz * 0.5
    sBL0 = -(GRL - GLL) * dtdx * 0.5 + (ELR - ELL) * dtdz * 0.5
    sBR0 = -(GRR - GLR) * dtdx * 0.5 + (ERR - ERL) * dtdz * 0.5
    sCL0 = +(FRL - FLL) * dtdx * 0.5 - (ERL - ELL) * dtdy * 0.5
    sCR0 = +(FRR - FLR) * dtdx * 0.5 - (ERR - ELR) * dtdy * 0.5

    r2, u2, v2, w2, p2 = r + sr0, u + su0, v + sv0, w + sw0, p + sp0
    A2, B2, C2 = A + sA0, B + sB0, C + sC0
    AL2, AR2 = AL + sAL0, AR + sAR0
    BL2, BR2 = BL + sBL0, BR + sBR0
    CL2, CR2 = CL + sCL0, CR + sCR0

    def chans(rho, pres, uu, vv, ww, a_, b_, c_):
        # the reference's 3D trace clamps pressure with smallp alone
        # (trace_mhd.h:1190)
        return (xp.maximum(smallr, rho), xp.maximum(smallp, pres),
                uu, vv, ww, a_, b_, c_)

    builders = {
        "qp_x": lambda: chans(r2 - drx, p2 - dpx, u2 - dux, v2 - dvx, w2 - dwx, AL2, B2 - dBx, C2 - dCx),
        "qm_x": lambda: chans(r2 + drx, p2 + dpx, u2 + dux, v2 + dvx, w2 + dwx, AR2, B2 + dBx, C2 + dCx),
        "qp_y": lambda: chans(r2 - dry, p2 - dpy, u2 - duy, v2 - dvy, w2 - dwy, A2 - dAy, BL2, C2 - dCy),
        "qm_y": lambda: chans(r2 + dry, p2 + dpy, u2 + duy, v2 + dvy, w2 + dwy, A2 + dAy, BR2, C2 + dCy),
        "qp_z": lambda: chans(r2 - drz, p2 - dpz, u2 - duz, v2 - dvz, w2 - dwz, A2 - dAz, B2 - dBz, CL2),
        "qm_z": lambda: chans(r2 + drz, p2 + dpz, u2 + duz, v2 + dvz, w2 + dwz, A2 + dAz, B2 + dBz, CR2),
        "qRT_x": lambda: chans(r2 + dry + drz, p2 + dpy + dpz, u2 + duy + duz, v2 + dvy + dvz,
                               w2 + dwy + dwz, A2 + dAy + dAz, BR2 + dBRz, CR2 + dCRy),
        "qRB_x": lambda: chans(r2 + dry - drz, p2 + dpy - dpz, u2 + duy - duz, v2 + dvy - dvz,
                               w2 + dwy - dwz, A2 + dAy - dAz, BR2 - dBRz, CL2 + dCLy),
        "qLT_x": lambda: chans(r2 - dry + drz, p2 - dpy + dpz, u2 - duy + duz, v2 - dvy + dvz,
                               w2 - dwy + dwz, A2 - dAy + dAz, BL2 + dBLz, CR2 - dCRy),
        "qLB_x": lambda: chans(r2 - dry - drz, p2 - dpy - dpz, u2 - duy - duz, v2 - dvy - dvz,
                               w2 - dwy - dwz, A2 - dAy - dAz, BL2 - dBLz, CL2 - dCLy),
        "qRT_y": lambda: chans(r2 + drx + drz, p2 + dpx + dpz, u2 + dux + duz, v2 + dvx + dvz,
                               w2 + dwx + dwz, AR2 + dARz, B2 + dBx + dBz, CR2 + dCRx),
        "qRB_y": lambda: chans(r2 + drx - drz, p2 + dpx - dpz, u2 + dux - duz, v2 + dvx - dvz,
                               w2 + dwx - dwz, AR2 - dARz, B2 + dBx - dBz, CL2 + dCLx),
        "qLT_y": lambda: chans(r2 - drx + drz, p2 - dpx + dpz, u2 - dux + duz, v2 - dvx + dvz,
                               w2 - dwx + dwz, AL2 + dALz, B2 - dBx + dBz, CR2 - dCRx),
        "qLB_y": lambda: chans(r2 - drx - drz, p2 - dpx - dpz, u2 - dux - duz, v2 - dvx - dvz,
                               w2 - dwx - dwz, AL2 - dALz, B2 - dBx - dBz, CL2 - dCLx),
        "qRT_z": lambda: chans(r2 + drx + dry, p2 + dpx + dpy, u2 + dux + duy, v2 + dvx + dvy,
                               w2 + dwx + dwy, AR2 + dARy, BR2 + dBRx, C2 + dCx + dCy),
        "qRB_z": lambda: chans(r2 + drx - dry, p2 + dpx - dpy, u2 + dux - duy, v2 + dvx - dvy,
                               w2 + dwx - dwy, AR2 - dARy, BL2 + dBLx, C2 + dCx - dCy),
        "qLT_z": lambda: chans(r2 - drx + dry, p2 - dpx + dpy, u2 - dux + duy, v2 - dvx + dvy,
                               w2 - dwx + dwy, AL2 + dALy, BR2 - dBRx, C2 - dCx + dCy),
        "qLB_z": lambda: chans(r2 - drx - dry, p2 - dpx - dpy, u2 - dux - duy, v2 - dvx - dvy,
                               w2 - dwx - dwy, AL2 - dALy, BL2 - dBLx, C2 - dCx - dCy),
    }
    return {k: (lambda f=v: torch.stack(list(f()))) for k, v in builders.items()}


def trace_unsplit_mhd_3d(params: RunParams, Q, bfx, bfy, bfz, dt, xpos=None):
    """Materialized form: (qm, qp, qedge_z, qedge_y, qedge_x), each edge
    family ordered (RT, RB, LT, LB)."""
    P = trace_unsplit_mhd_3d_parts(params, Q, bfx, bfy, bfz, dt, xpos)
    qm = (P["qm_x"](), P["qm_y"](), P["qm_z"]())
    qp = (P["qp_x"](), P["qp_y"](), P["qp_z"]())
    qedge_z = (P["qRT_z"](), P["qRB_z"](), P["qLT_z"](), P["qLB_z"]())
    qedge_y = (P["qRT_y"](), P["qRB_y"](), P["qLT_y"](), P["qLB_y"]())
    qedge_x = (P["qRT_x"](), P["qRB_x"](), P["qLT_x"](), P["qLB_x"]())
    return qm, qp, qedge_z, qedge_y, qedge_x
