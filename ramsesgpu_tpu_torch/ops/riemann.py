"""Hydro Riemann solvers over whole interface arrays (the PyTorch twin of
ramsesgpu_tpu/ops/riemann.py; reference riemann.h:31-401, cmpflx.h:22-49):
the iterative two-shock "approx" solver, HLL and HLLC, in 3D.

Interface convention: ``ql``/``qr`` are primitive arrays [5, ...] in
*rotated* component order (IU holds the face-normal velocity); each solver
returns the flux [5, ...] in the same rotated order. The op forms are the
reference's: hoisted 1/pl, 1/pr and rsqrt in the Newton loop, shared
reciprocals in HLLC; parity with it is tolerance-based, never bitwise.
"""
from __future__ import annotations

import torch

from ..config.params import RunParams
from ..core.constants import ID, IP, IU, IV, IW, RiemannSolver
from .backend import xp


def cmpflx(params: RunParams, qgdnv: torch.Tensor) -> torch.Tensor:
    """Euler flux from a Godunov (interface) state (cmpflx.h:22-49)."""
    rho, p, u, v, w = qgdnv[ID], qgdnv[IP], qgdnv[IU], qgdnv[IV], qgdnv[IW]
    f_rho = rho * u
    f_mu = f_rho * u + p
    f_mv = f_rho * v
    f_mw = f_rho * w
    entho = 1.0 / (params.gamma0 - 1.0)
    ekin = 0.5 * rho * (u * u + v * v + w * w)
    etot = p * entho + ekin
    f_e = u * (etot + p)
    return torch.stack([f_rho, f_e, f_mu, f_mv, f_mw])


def riemann_approx(params: RunParams, ql: torch.Tensor, qr: torch.Tensor) -> torch.Tensor:
    """Iterative two-shock approximate solver (riemann.h:31-159): Newton on
    the star pressure over ``niter_riemann`` masked iterations (a face
    stops changing once its relative change is <= 1e-6)."""
    smallr, smallc, smallp = params.smallr, params.smallc, params.smallp
    smallpp, gamma, gamma6 = params.smallpp, params.gamma0, params.gamma6

    rl = xp.maximum(ql[ID], smallr)
    ul = ql[IU]
    pl = xp.maximum(ql[IP], rl * smallp)
    rr = xp.maximum(qr[ID], smallr)
    ur = qr[IU]
    pr = xp.maximum(qr[IP], rr * smallp)

    # Lagrangian sound speed squared
    cl = gamma * pl * rl
    cr = gamma * pr * rr
    wl = torch.sqrt(cl)
    wr = torch.sqrt(cr)
    pstar = xp.maximum(((wr * pl + wl * pr) + wl * wr * (ul - ur)) / (wl + wr), 0.0)
    pold = pstar
    conv = torch.ones_like(pstar)

    inv_pl = 1.0 / pl
    inv_pr = 1.0 / pr
    for _ in range(params.niter_riemann):
        active = conv > 1e-6
        wwl2 = cl * (1.0 + gamma6 * (pold - pl) * inv_pl)
        wwr2 = cr * (1.0 + gamma6 * (pold - pr) * inv_pr)
        rwl = torch.rsqrt(wwl2)
        rwr = torch.rsqrt(wwr2)
        wwl = wwl2 * rwl
        wwr = wwr2 * rwr
        qgl = 2.0 * wwl2 * wwl / (wwl2 + cl)
        qgr = 2.0 * wwr2 * wwr / (wwr2 + cr)
        usl = ul - (pold - pl) * rwl
        usr = ur + (pold - pr) * rwr
        delp = xp.maximum(qgr * qgl / (qgr + qgl) * (usl - usr), -pold)
        pnew = pold + delp
        cnew = torch.abs(delp / (pnew + smallpp))
        pold = torch.where(active, pnew, pold)
        conv = torch.where(active, cnew, conv)

    pstar = pold
    wwl2_f = cl * (1.0 + gamma6 * (pstar - pl) * inv_pl)
    wwr2_f = cr * (1.0 + gamma6 * (pstar - pr) * inv_pr)
    rwl_f = torch.rsqrt(wwl2_f)
    rwr_f = torch.rsqrt(wwr2_f)
    wl = wwl2_f * rwl_f
    wr = wwr2_f * rwr_f

    ustar = 0.5 * (ul + (pl - pstar) * rwl_f + ur - (pr - pstar) * rwr_f)
    sgnm = torch.where(ustar >= 0.0, 1.0, -1.0).to(ustar.dtype)
    left_going = sgnm > 0.0

    ro = torch.where(left_going, rl, rr)
    uo = torch.where(left_going, ul, ur)
    po = torch.where(left_going, pl, pr)
    wo = torch.where(left_going, wl, wr)
    inv_wo = torch.where(left_going, rwl_f, rwr_f)

    inv_ro = 1.0 / ro
    co = xp.maximum(smallc, torch.sqrt(torch.abs(gamma * po * inv_ro)))
    rstar = xp.maximum(ro / (1.0 + ro * (po - pstar) * (inv_wo * inv_wo)), smallr)
    cstar = xp.maximum(smallc, torch.sqrt(torch.abs(gamma * pstar / rstar)))

    spout = co - sgnm * uo
    spin = cstar - sgnm * ustar
    ushock = wo * inv_ro - sgnm * uo
    spin = torch.where(pstar >= po, ushock, spin)
    spout = torch.where(pstar >= po, ushock, spout)

    scr = xp.maximum(spout - spin, smallc + torch.abs(spout + spin))
    frac = 0.5 * (1.0 + (spout + spin) / scr)
    frac = torch.where(torch.isnan(frac), 0.0, torch.clamp(frac, 0.0, 1.0))

    g_rho = frac * rstar + (1.0 - frac) * ro
    g_u = frac * ustar + (1.0 - frac) * uo
    g_p = frac * pstar + (1.0 - frac) * po

    g_rho = torch.where(spout < 0.0, ro, g_rho)
    g_u = torch.where(spout < 0.0, uo, g_u)
    g_p = torch.where(spout < 0.0, po, g_p)

    g_rho = torch.where(spin > 0.0, rstar, g_rho)
    g_u = torch.where(spin > 0.0, ustar, g_u)
    g_p = torch.where(spin > 0.0, pstar, g_p)

    g_v = torch.where(left_going, ql[IV], qr[IV])
    g_w = torch.where(left_going, ql[IW], qr[IW])
    return cmpflx(params, torch.stack([g_rho, g_p, g_u, g_v, g_w]))


def riemann_hll(params: RunParams, ql: torch.Tensor, qr: torch.Tensor) -> torch.Tensor:
    """HLL solver (riemann.h:177-255; Toro ch. 10)."""
    smallr, smallp, gamma = params.smallr, params.smallp, params.gamma0
    entho = 1.0 / (gamma - 1.0)

    rl = xp.maximum(ql[ID], smallr)
    ul = ql[IU]
    pl = xp.maximum(ql[IP], rl * smallp)
    rr = xp.maximum(qr[ID], smallr)
    ur = qr[IU]
    pr = xp.maximum(qr[IP], rr * smallp)

    cl = torch.sqrt(gamma * pl / rl)
    cr = torch.sqrt(gamma * pr / rr)
    SL = xp.minimum(xp.minimum(ul, ur) - xp.maximum(cl, cr), 0.0)
    SR = xp.maximum(xp.maximum(ul, ur) + xp.maximum(cl, cr), 0.0)

    def cons_and_flux(q):
        rho, p, u, v, w = q[ID], q[IP], q[IU], q[IV], q[IW]
        e = p * entho + 0.5 * rho * (u * u + v * v)
        e = e + 0.5 * rho * w * w
        mu, mv, mw = rho * u, rho * v, rho * w
        return (torch.stack([rho, e, mu, mv, mw]),
                torch.stack([mu, u * (e + p), p + mu * u, mu * v, mu * w]))

    uleft, fleft = cons_and_flux(ql)
    uright, fright = cons_and_flux(qr)
    return (SR * fleft - SL * fright + SR * SL * (uright - uleft)) / (SR - SL)


def riemann_hllc(params: RunParams, ql: torch.Tensor, qr: torch.Tensor) -> torch.Tensor:
    """HLLC solver (riemann.h:271-371)."""
    smallr, smallp, smallc, gamma = params.smallr, params.smallp, params.smallc, params.gamma0
    entho = 1.0 / (gamma - 1.0)

    rl = xp.maximum(ql[ID], smallr)
    pl = xp.maximum(ql[IP], rl * smallp)
    ul = ql[IU]
    ecinl = 0.5 * rl * (ul * ul + ql[IV] * ql[IV])
    ecinl = ecinl + 0.5 * rl * ql[IW] * ql[IW]
    etotl = pl * entho + ecinl

    rr = xp.maximum(qr[ID], smallr)
    pr = xp.maximum(qr[IP], rr * smallp)
    ur = qr[IU]
    ecinr = 0.5 * rr * (ur * ur + qr[IV] * qr[IV])
    ecinr = ecinr + 0.5 * rr * qr[IW] * qr[IW]
    etotr = pr * entho + ecinr

    cfastl = torch.sqrt(xp.maximum(gamma * pl / rl, smallc * smallc))
    cfastr = torch.sqrt(xp.maximum(gamma * pr / rr, smallc * smallc))
    SL = xp.minimum(ul, ur) - xp.maximum(cfastl, cfastr)
    SR = xp.maximum(ul, ur) + xp.maximum(cfastl, cfastr)

    rcl = rl * (ul - SL)
    rcr = rr * (SR - ur)
    inv_rc = 1.0 / (rcr + rcl)
    ustar = (rcr * ur + rcl * ul + (pl - pr)) * inv_rc
    ptotstar = (rcr * pl + rcl * pr + rcl * rcr * (ul - ur)) * inv_rc

    inv_sl = 1.0 / (SL - ustar)
    inv_sr = 1.0 / (SR - ustar)
    rstarl = rl * (SL - ul) * inv_sl
    etotstarl = ((SL - ul) * etotl - pl * ul + ptotstar * ustar) * inv_sl
    rstarr = rr * (SR - ur) * inv_sr
    etotstarr = ((SR - ur) * etotr - pr * ur + ptotstar * ustar) * inv_sr

    # sample the fan: SL>0 -> left; ustar>0 -> left star; SR>0 -> right star; else right
    def sample(l, lstar, rstar_, r_):
        out = torch.where(SR > 0.0, rstar_, r_)
        out = torch.where(ustar > 0.0, lstar, out)
        return torch.where(SL > 0.0, l, out)

    ro = sample(rl, rstarl, rstarr, rr)
    uo = sample(ul, ustar, ustar, ur)
    ptoto = sample(pl, ptotstar, ptotstar, pr)
    etoto = sample(etotl, etotstarl, etotstarr, etotr)

    f_rho = ro * uo
    f_mu = f_rho * uo + ptoto
    f_e = (etoto + ptoto) * uo
    f_mv = torch.where(f_rho > 0.0, f_rho * ql[IV], f_rho * qr[IV])
    f_mw = torch.where(f_rho > 0.0, f_rho * ql[IW], f_rho * qr[IW])
    return torch.stack([f_rho, f_e, f_mu, f_mv, f_mw])


_SOLVERS = {
    RiemannSolver.APPROX: riemann_approx,
    RiemannSolver.HLL: riemann_hll,
    RiemannSolver.HLLC: riemann_hllc,
}


def riemann_hydro(params: RunParams, ql: torch.Tensor, qr: torch.Tensor) -> torch.Tensor:
    """Dispatch on the configured solver (riemann.h:390-401)."""
    solver = _SOLVERS.get(params.riemann_solver)
    if solver is None:
        raise NotImplementedError(
            f"hydro riemannSolver {params.riemann_solver!r} is not ported "
            "(approx, hll, hllc)")
    return solver(params, ql, qr)
