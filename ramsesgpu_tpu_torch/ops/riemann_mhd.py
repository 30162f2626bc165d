"""MHD Riemann solvers: 1D HLLD face fluxes and the 2D HLLD corner solver
producing the EMF for constrained transport (the PyTorch twin of
ramsesgpu_tpu/ops/riemann_mhd.py; reference riemann_mhd.h:87-1193,
mhd_utils.h:29-318; Miyoshi & Kusano 2005).

State convention for the 1D solver (rotated order):
  [ID rho, IP p, IU vnormal, IV vt1, IW vt2, IA Bnormal, IB Bt1, IC Bt2]
For the 2D corner solver IU/IV are the in-plane velocities and IA/IB the
in-plane field; IW/IC are out of plane.

Only HLLD (faces) and 2D-HLLD (corners) are ported; the LLF/HLL face
solvers and the HLLA/HLLF/LLF corner solvers raise.
"""
from __future__ import annotations

import torch

from ..config.params import RunParams
from ..core.constants import (
    IA, IB, IC, ID, IP, IU, IV, IW, MagneticRiemannSolver, RiemannSolver,
)

from .backend import xp


def _fast_speed_precursors(params: RunParams, d, p, a, b, c):
    """The bn-independent part of the fast-speed formula: (d2, c2/d, 1/d)."""
    b2 = a * a + b * b + c * c
    inv_d = 1.0 / d
    c2 = params.gamma0 * p * inv_d
    d2 = 0.5 * (b2 * inv_d + c2)
    return d2, c2 * inv_d, inv_d


def _fast_speed_from_precursors(pre, bn):
    d2, cb, _ = pre
    return torch.sqrt(d2 + torch.sqrt(xp.maximum(d2 * d2 - cb * (bn * bn), 0.0)))


def _fast_speed_components(params: RunParams, d, p, a, b, c, bn=None):
    """Fast magnetosonic speed; ``bn`` defaults to ``a`` (mhd_utils.h:30-52)."""
    if bn is None:
        bn = a
    pre = _fast_speed_precursors(params, d, p, a, b, c)
    return _fast_speed_from_precursors(pre, bn)


def _pressure(params: RunParams, q):
    return q[ID] * params.c_iso**2 if params.c_iso > 0 else q[IP]


def riemann_hlld(params: RunParams, ql, qr):
    """HLLD MHD flux between left/right states [8, ...] (riemann_mhd.h:140-342)."""
    entho = 1.0 / (params.gamma0 - 1.0)

    a = 0.5 * (ql[IA] + qr[IA])
    sgnm = torch.where(a >= 0.0, 1.0, -1.0).to(a.dtype)

    def prep(q):
        r = q[ID]
        p = _pressure(params, q)
        u, v, w = q[IU], q[IV], q[IW]
        b, c = q[IB], q[IC]
        ecin = 0.5 * (u * u + v * v + w * w) * r
        emag = 0.5 * (a * a + b * b + c * c)
        etot = p * entho + ecin + emag
        ptot = p + emag
        vdotb = u * a + v * b + w * c
        cfast = _fast_speed_components(params, r, p, a, b, c)
        return r, p, u, v, w, b, c, etot, ptot, vdotb, cfast

    rl, pl, ul, vl, wl, bl, cl, etotl, ptotl, vdotbl, cfastl = prep(ql)
    rr, pr, ur, vr, wr, br, cr, etotr, ptotr, vdotbr, cfastr = prep(qr)

    sl = torch.minimum(ul, ur) - torch.maximum(cfastl, cfastr)
    sr = torch.maximum(ul, ur) + torch.maximum(cfastl, cfastr)

    rcl = rl * (ul - sl)
    rcr = rr * (sr - ur)

    inv_rc = 1.0 / (rcr + rcl)
    ustar = (rcr * ur + rcl * ul + (ptotl - ptotr)) * inv_rc
    ptotstar = (rcr * ptotl + rcl * ptotr + rcl * rcr * (ul - ur)) * inv_rc

    def star(r_, u_, v_, w_, b_, c_, etot_, ptot_, vdotb_, s_):
        inv_su = 1.0 / (s_ - ustar)
        rstar = r_ * (s_ - u_) * inv_su
        estar = r_ * (s_ - u_) * (s_ - ustar) - a * a
        el = r_ * (s_ - u_) * (s_ - u_) - a * a
        degenerate = torch.logical_and(
            a * a > 0, torch.abs(estar / (a * a + 1e-300) - 1.0) <= 1e-8
        )
        estar_safe = torch.where(estar == 0.0, 1.0, estar)
        inv_estar = 1.0 / estar_safe
        k = a * (ustar - u_) * inv_estar
        el_ratio = el * inv_estar
        vstar = torch.where(degenerate, v_, v_ - b_ * k)
        bstar = torch.where(degenerate, b_, b_ * el_ratio)
        wstar = torch.where(degenerate, w_, w_ - c_ * k)
        cstar = torch.where(degenerate, c_, c_ * el_ratio)
        vdotbstar = ustar * a + vstar * bstar + wstar * cstar
        etotstar = (
            (s_ - u_) * etot_ - ptot_ * u_ + ptotstar * ustar + a * (vdotb_ - vdotbstar)
        ) * inv_su
        inv_sqrtr = torch.rsqrt(rstar)
        sqrtr = rstar * inv_sqrtr
        calfven = torch.abs(a) * inv_sqrtr
        return rstar, vstar, wstar, bstar, cstar, vdotbstar, etotstar, sqrtr, calfven

    (rstarl, vstarl, wstarl, bstarl, cstarl, vdotbstarl, etotstarl, sqrl, calfl) = star(
        rl, ul, vl, wl, bl, cl, etotl, ptotl, vdotbl, sl
    )
    (rstarr, vstarr, wstarr, bstarr, cstarr, vdotbstarr, etotstarr, sqrr, calfr) = star(
        rr, ur, vr, wr, br, cr, etotr, ptotr, vdotbr, sr
    )
    sal = ustar - calfl
    sar = ustar + calfr

    inv_denom = 1.0 / (sqrl + sqrr)
    vss = (sqrl * vstarl + sqrr * vstarr + sgnm * (bstarr - bstarl)) * inv_denom
    wss = (sqrl * wstarl + sqrr * wstarr + sgnm * (cstarr - cstarl)) * inv_denom
    bss = (sqrl * bstarr + sqrr * bstarl + sgnm * sqrl * sqrr * (vstarr - vstarl)) * inv_denom
    css = (sqrl * cstarr + sqrr * cstarl + sgnm * sqrl * sqrr * (wstarr - wstarl)) * inv_denom
    vdotbss = ustar * a + vss * bss + wss * css
    etotssl = etotstarl - sgnm * sqrl * (vdotbstarl - vdotbss)
    etotssr = etotstarr + sgnm * sqrr * (vdotbstarr - vdotbss)

    # sample the 6-zone fan from the outside in
    zones = [
        (sl > 0, rl, ul, vl, wl, bl, cl, ptotl, etotl, vdotbl),
        (sal > 0, rstarl, ustar, vstarl, wstarl, bstarl, cstarl, ptotstar, etotstarl, vdotbstarl),
        (ustar > 0, rstarl, ustar, vss, wss, bss, css, ptotstar, etotssl, vdotbss),
        (sar > 0, rstarr, ustar, vss, wss, bss, css, ptotstar, etotssr, vdotbss),
        (sr > 0, rstarr, ustar, vstarr, wstarr, bstarr, cstarr, ptotstar, etotstarr, vdotbstarr),
    ]
    out = [rr, ur, vr, wr, br, cr, ptotr, etotr, vdotbr]
    for cond, *vals in reversed(zones):
        out = [torch.where(cond, v, o) for v, o in zip(vals, out)]
    ro, uo, vo, wo, bo, co, ptoto, etoto, vdotbo = out

    return torch.stack(
        [
            ro * uo,
            (etoto + ptoto) * uo - a * vdotbo,
            ro * uo * uo - a * a + ptoto,
            ro * uo * vo - a * bo,
            ro * uo * wo - a * co,
            torch.zeros_like(ro),
            bo * uo - a * vo,
            co * uo - a * wo,
        ]
    )


def riemann_mhd(params: RunParams, ql, qr):
    """Dispatch on [hydro] riemannSolver; only HLLD is ported."""
    if params.riemann_solver == RiemannSolver.HLLD:
        return riemann_hlld(params, ql, qr)
    raise NotImplementedError(
        f"MHD Riemann solver {params.riemann_solver.name} is not ported (HLLD only)"
    )


def _minmax4(*a):
    lo, hi = a[0], a[0]
    for x in a[1:]:
        lo = torch.minimum(lo, x)
        hi = torch.maximum(hi, x)
    return lo, hi


def mag_riemann2d_hlld(params: RunParams, qLL, qRL, qLR, qRR, eLL, eRL, eLR, eRR):
    """2D HLLD corner solver (riemann_mhd.h:616-828): the EMF at a corner
    from its four states (in-plane field continuity enforced by the caller)."""
    smallc = params.smallc

    def pre(q):
        return _fast_speed_precursors(params, q[ID], _pressure(params, q),
                                      q[IA], q[IB], q[IC])

    corners = (qLL, qLR, qRL, qRR)
    pres = [pre(q) for q in corners]
    cfx = [_fast_speed_from_precursors(pr, q[IA]) for pr, q in zip(pres, corners)]
    cfy = [_fast_speed_from_precursors(pr, q[IB]) for pr, q in zip(pres, corners)]

    ulo, uhi = _minmax4(qLL[IU], qLR[IU], qRL[IU], qRR[IU])
    vlo, vhi = _minmax4(qLL[IV], qLR[IV], qRL[IV], qRR[IV])
    _, cxmax = _minmax4(*cfx)
    _, cymax = _minmax4(*cfy)

    SL = ulo - cxmax
    SR = uhi + cxmax
    SB = vlo - cymax
    ST = vhi + cymax

    def ptot(q):
        return _pressure(params, q) + 0.5 * (q[IA] ** 2 + q[IB] ** 2 + q[IC] ** 2)

    PtotLL, PtotLR, PtotRL, PtotRR = ptot(qLL), ptot(qLR), ptot(qRL), ptot(qRR)

    rLL, uLL, vLL, aLL, bLL = qLL[ID], qLL[IU], qLL[IV], qLL[IA], qLL[IB]
    rLR, uLR, vLR, aLR, bLR = qLR[ID], qLR[IU], qLR[IV], qLR[IA], qLR[IB]
    rRL, uRL, vRL, aRL, bRL = qRL[ID], qRL[IU], qRL[IV], qRL[IA], qRL[IB]
    rRR, uRR, vRR, aRR, bRR = qRR[ID], qRR[IU], qRR[IV], qRR[IA], qRR[IB]

    rcLLx = rLL * (uLL - SL); rcRLx = rRL * (SR - uRL)  # noqa: E702
    rcLRx = rLR * (uLR - SL); rcRRx = rRR * (SR - uRR)  # noqa: E702
    rcLLy = rLL * (vLL - SB); rcLRy = rLR * (ST - vLR)  # noqa: E702
    rcRLy = rRL * (vRL - SB); rcRRy = rRR * (ST - vRR)  # noqa: E702

    ustar = (
        rcLLx * uLL + rcLRx * uLR + rcRLx * uRL + rcRRx * uRR
        + (PtotLL - PtotRL + PtotLR - PtotRR)
    ) / (rcLLx + rcLRx + rcRLx + rcRRx)
    vstar = (
        rcLLy * vLL + rcLRy * vLR + rcRLy * vRL + rcRRy * vRR
        + (PtotLL - PtotLR + PtotRL - PtotRR)
    ) / (rcLLy + rcLRy + rcRLy + rcRRy)

    def star(r, u, v, a_, b_, Sx, Sy):
        ratio_x = (Sx - u) / (Sx - ustar)
        ratio_y = (Sy - v) / (Sy - vstar)
        rstarx = r * ratio_x
        Bstar = b_ * ratio_x
        rstary = r * ratio_y
        Astar = a_ * ratio_y
        rstar = rstarx * ratio_y
        Estarx = ustar * Bstar - v * a_
        Estary = u * b_ - vstar * Astar
        Estar = ustar * Bstar - vstar * Astar
        return rstarx, Bstar, rstary, Astar, rstar, Estarx, Estary, Estar

    (rsLLx, BstarLL, rsLLy, AstarLL, rsLL, EstarLLx, EstarLLy, EstarLL) = star(
        rLL, uLL, vLL, aLL, bLL, SL, SB)
    (rsLRx, BstarLR, rsLRy, AstarLR, rsLR, EstarLRx, EstarLRy, EstarLR) = star(
        rLR, uLR, vLR, aLR, bLR, SL, ST)
    (rsRLx, BstarRL, rsRLy, AstarRL, rsRL, EstarRLx, EstarRLy, EstarRL) = star(
        rRL, uRL, vRL, aRL, bRL, SR, SB)
    (rsRRx, BstarRR, rsRRy, AstarRR, rsRR, EstarRRx, EstarRRy, EstarRR) = star(
        rRR, uRR, vRR, aRR, bRR, SR, ST)

    def max5(a0, a1, a2, a3, a4):
        return xp.maximum(torch.maximum(torch.maximum(a0, a1), torch.maximum(a2, a3)), a4)

    rq = torch.rsqrt
    rqLL, rqLR, rqRL, rqRR = rq(rsLL), rq(rsLR), rq(rsRL), rq(rsRR)
    ab = torch.abs
    calfvenL = max5(ab(aLR) * rq(rsLRx), ab(AstarLR) * rqLR,
                    ab(aLL) * rq(rsLLx), ab(AstarLL) * rqLL, smallc)
    calfvenR = max5(ab(aRR) * rq(rsRRx), ab(AstarRR) * rqRR,
                    ab(aRL) * rq(rsRLx), ab(AstarRL) * rqRL, smallc)
    calfvenB = max5(ab(bLL) * rq(rsLLy), ab(BstarLL) * rqLL,
                    ab(bRL) * rq(rsRLy), ab(BstarRL) * rqRL, smallc)
    calfvenT = max5(ab(bLR) * rq(rsLRy), ab(BstarLR) * rqLR,
                    ab(bRR) * rq(rsRRy), ab(BstarRR) * rqRR, smallc)

    SAL = xp.minimum(ustar - calfvenL, 0.0)
    SAR = xp.maximum(ustar + calfvenR, 0.0)
    SAB = xp.minimum(vstar - calfvenB, 0.0)
    SAT = xp.maximum(vstar + calfvenT, 0.0)

    inv_dsx = 1.0 / (SAR - SAL)
    inv_dsy = 1.0 / (SAT - SAB)
    AstarT = (SAR * AstarRR - SAL * AstarLR) * inv_dsx
    AstarB = (SAR * AstarRL - SAL * AstarLL) * inv_dsx
    BstarR = (SAT * BstarRR - SAB * BstarRL) * inv_dsy
    BstarL = (SAT * BstarLR - SAB * BstarLL) * inv_dsy

    E_center = (
        (SAL * SAB * EstarRR - SAL * SAT * EstarRL - SAR * SAB * EstarLR + SAR * SAT * EstarLL)
        * inv_dsx * inv_dsy
        - SAT * SAB * inv_dsy * (AstarT - AstarB)
        + SAR * SAL * inv_dsx * (BstarR - BstarL)
    )

    # supersonic-in-y branches collapse to 1D HLL problems in x (and vice versa)
    E_B = (SAR * EstarLLx - SAL * EstarRLx + SAR * SAL * (bRL - bLL)) * inv_dsx
    E_B = torch.where(SL > 0, eLL, torch.where(SR < 0, eRL, E_B))
    E_T = (SAR * EstarLRx - SAL * EstarRRx + SAR * SAL * (bRR - bLR)) * inv_dsx
    E_T = torch.where(SL > 0, eLR, torch.where(SR < 0, eRR, E_T))
    E_L = (SAT * EstarLLy - SAB * EstarLRy - SAT * SAB * (aLR - aLL)) * inv_dsy
    E_R = (SAT * EstarRLy - SAB * EstarRRy - SAT * SAB * (aRR - aRL)) * inv_dsy

    return torch.where(
        SB > 0,
        E_B,
        torch.where(
            ST < 0,
            E_T,
            torch.where(SL > 0, E_L, torch.where(SR < 0, E_R, E_center)),
        ),
    )


def mag_riemann2d(params: RunParams, qLL, qRL, qLR, qRR, eLL, eRL, eLR, eRR):
    """Dispatch on [MHD] magRiemannSolver; only HLLD is ported."""
    s = params.mag_riemann_solver
    if s == MagneticRiemannSolver.MAG_HLLD:
        return mag_riemann2d_hlld(params, qLL, qRL, qLR, qRR, eLL, eRL, eLR, eRR)
    raise NotImplementedError(
        f"magnetic Riemann solver {s.name} is not ported (HLLD only)"
    )


# component rotations used by compute_emf (riemann_mhd.h:1098-1109)
EMF_ROTATION = {
    "z": (IU, IV, IW, IA, IB, IC),
    "y": (IW, IU, IV, IC, IA, IB),
    "x": (IV, IW, IU, IB, IC, IA),
}


def compute_emf(params: RunParams, qRT, qRB, qLT, qLB, emf_dir: str, xpos=None):
    """EMF at cell corners from the four corner-aligned edge states
    (riemann_mhd.h:1056-1193): qRT from the lower-left diagonal cell,
    qRB/qLT from the adjacent cells, qLB from the current cell. ``xpos``
    (the cell-centre x coordinate, broadcastable) feeds the shearing-box
    upwind term when omega0 > 0."""
    iu, iv, iw, ia, ib, ic = EMF_ROTATION[emf_dir]

    def build(q):
        return [q[ID], _pressure(params, q), q[iu], q[iv], q[iw], None, None, q[ic]]

    # corner-quadrant mapping: qLL <- qRT, qRL <- qLT, qLR <- qRB, qRR <- qLB
    sLL, sRL, sLR, sRR = build(qRT), build(qLT), build(qRB), build(qLB)

    a_bottom = 0.5 * (qRT[ia] + qLT[ia])
    a_top = 0.5 * (qRB[ia] + qLB[ia])
    sLL[5] = sRL[5] = a_bottom
    sLR[5] = sRR[5] = a_top

    b_left = 0.5 * (qRT[ib] + qRB[ib])
    b_right = 0.5 * (qLT[ib] + qLB[ib])
    sLL[6] = sLR[6] = b_left
    sRL[6] = sRR[6] = b_right

    qLL, qRL, qLR, qRR = (torch.stack(s) for s in (sLL, sRL, sLR, sRR))

    eLL = qLL[IU] * qLL[IB] - qLL[IV] * qLL[IA]
    eRL = qRL[IU] * qRL[IB] - qRL[IV] * qRL[IA]
    eLR = qLR[IU] * qLR[IB] - qLR[IV] * qLR[IA]
    eRR = qRR[IU] * qRR[IB] - qRR[IV] * qRR[IA]

    emf = mag_riemann2d(params, qLL, qRL, qLR, qRR, eLL, eRL, eLR, eRR)

    if params.omega0 > 0 and xpos is not None:
        # shearing-box upwind correction (riemann_mhd.h:1172-1190)
        if emf_dir == "x":
            shear = -1.5 * params.omega0 * xpos
            emf = emf + torch.where(shear > 0, shear * qLL[IB], shear * qRR[IB])
        elif emf_dir == "z":
            shear = -1.5 * params.omega0 * (xpos - params.dx / 2)
            emf = emf - torch.where(shear > 0, shear * qLL[IA], shear * qRR[IA])
    return emf
