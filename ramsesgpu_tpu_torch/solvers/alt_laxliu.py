"""The Lax-Liu positive scheme (2D), whole-array PyTorch on the ghosted
state (the port's counterpart of ramsesgpu_tpu/solvers/alt_laxliu.py;
reference positiveScheme.h:36-260 limiter / eigs / central_diff_flux /
diffusive_flux, HydroRunLaxLiu.cpp:112-230 laxliu_evolve and :326
oneStepIntegration; Lax & Liu, SIAM J. Sci. Comput. 19, p. 319): the
central flux plus a diffusive flux limited in the Roe eigenbasis, two
half-sweeps averaged a step, dt = xlambda dx.

Inside, the components are in the paper's order (rho, mx, my, E), not the
state's (rho, E, mx, my); the step converts at its ends. Every square
root goes through ``ops.backend.sqrt``.
"""
from __future__ import annotations

import torch

from ..config.params import RunParams
from ..core.constants import ID, IP, IU, IV
from ..ops.backend import xp
from ..ops.stencil import shift_m, shift_p
from .boundary import make_boundaries

_X, _Y = -1, -2


def _to_ll(U):
    """(rho, E, mx, my) -> (rho, mx, my, E)."""
    return torch.stack([U[ID], U[IU], U[IV], U[IP]])


def _from_ll(V):
    return torch.stack([V[0], V[3], V[1], V[2]])


def _limiter(dw, dwup, k_is_acoustic: bool):
    """The positive scheme's limiter pair (positiveScheme.h:36-72):
    (phi0, phi1); for the acoustic characteristics phi0 takes the van Leer
    form."""
    same_sign = dw * dwup > 0.0
    theta = torch.where(same_sign, dwup / torch.where(dw == 0, 1.0, dw), 0.0)
    rising = (dw == 0.0) & (dwup > 0.0)
    if k_is_acoustic:
        phi0 = torch.where(same_sign, 2.0 * theta / (1.0 + theta), 0.0)
    else:
        phi0 = torch.where(
            same_sign,
            torch.where(theta <= 0.5, 2.0 * theta,
                        torch.where(theta <= 1.0, 1.0,
                                    torch.where(theta <= 2.0, theta, 2.0))),
            0.0)
    phi0 = torch.where(rising, 2.0, phi0)
    phi1 = torch.where(rising, 1.0, torch.where(same_sign, xp.minimum(theta, 1.0), 0.0))
    return phi0, phi1


def _eigs(params: RunParams, up, um):
    """The Roe-average eigensystem (positiveScheme.h:86-170) of states in
    (rho, mx, my, E) order: right eigenvectors r[4][4], left ri[4][4] and
    the eigenvalues eig[4], each entry an array."""
    gamma = params.gamma0
    r1 = xp.maximum(um[0], params.smallr)
    u1, v1 = um[1] / r1, um[2] / r1
    ek1 = 0.5 * (u1 * u1 + v1 * v1)
    H1 = (um[3] + (gamma - 1.0) * (um[3] - ek1 * r1)) / r1
    r2 = xp.maximum(up[0], params.smallr)
    u2, v2 = up[1] / r2, up[2] / r2
    ek2 = 0.5 * (u2 * u2 + v2 * v2)
    H2 = (up[3] + (gamma - 1.0) * (up[3] - ek2 * r2)) / r2
    s1, s2 = xp.sqrt(r1), xp.sqrt(r2)
    w1 = s1 + s2
    u = (s1 * u1 + s2 * u2) / w1
    v = (s1 * v1 + s2 * v2) / w1
    H = (s1 * H1 + s2 * H2) / w1
    q2 = u * u + v * v
    c2 = (gamma - 1.0) * (H - 0.5 * q2)
    c = torch.where(c2 < 0, params.smallc, xp.sqrt(xp.maximum(c2, 0.0)))

    one = torch.ones_like(u)
    zero = torch.zeros_like(u)
    r = [
        [one, zero, one, one],
        [u - c, zero, u, u + c],
        [v, one, v, v],
        [H - u * c, v, 0.5 * q2, H + u * c],
    ]
    b1 = xp.maximum(1.0 / xp.maximum(H - 0.5 * q2, 1e-30), 1e-10)
    b2 = 0.5 * q2 * b1
    ri = [
        [0.5 * (b2 + u / c), -0.5 / c - 0.5 * b1 * u, -0.5 * b1 * v, 0.5 * b1],
        [-v, zero, one, zero],
        [1.0 - b2, b1 * u, b1 * v, -b1],
        [0.5 * (b2 - u / c), 0.5 / c - 0.5 * b1 * u, -0.5 * b1 * v, 0.5 * b1],
    ]
    return r, ri, [u - c, u, u, u + c]


def _central_flux(params: RunParams, up, um):
    gamma = params.gamma0
    rl = xp.maximum(um[0], params.smallr)
    rr = xp.maximum(up[0], params.smallr)
    pl = (gamma - 1.0) * (um[3] - 0.5 * (um[1] ** 2 + um[2] ** 2) / rl)
    pr = (gamma - 1.0) * (up[3] - 0.5 * (up[1] ** 2 + up[2] ** 2) / rr)
    return torch.stack([
        0.5 * (um[1] + up[1]),
        0.5 * (um[1] ** 2 / rl + pl + up[1] ** 2 / rr + pr),
        0.5 * (um[1] * um[2] / rl + up[1] * up[2] / rr),
        0.5 * ((um[3] + pl) * um[1] / rl + (up[3] + pr) * up[1] / rr),
    ])


def _diffusive_flux(params: RunParams, up, um, du, dup, dum):
    r, ri, eig = _eigs(params, up, um)
    mu = xp.maximum(torch.abs(eig[0]), torch.abs(eig[3]))
    alpha, beta = params.alpha_ll, params.beta_ll

    dwf = []
    for k in range(4):
        dw_k = sum(ri[k][m] * du[m] for m in range(4))
        dw_up = sum(ri[k][m] * dup[m] for m in range(4))
        dw_dn = sum(ri[k][m] * dum[m] for m in range(4))
        dwup = torch.where(eig[k] >= 0.0, dw_dn, dw_up)
        phi0, phi1 = _limiter(dw_k, dwup, k_is_acoustic=k in (0, 3))
        dwf.append(-0.5 * (alpha * (1.0 - phi0) * torch.abs(eig[k])
                           + beta * (1.0 - phi1) * mu) * dw_k)
    return torch.stack([sum(r[k][m] * dwf[m] for m in range(4)) for k in range(4)])


def _interface_flux(params: RunParams, V, axis, swap_xy: bool):
    """The flux F(i) through the interface (i, i+1) along ``axis``, the
    components (rho, m_normal, m_transverse, E) by the optional swap."""
    if swap_xy:
        V = torch.stack([V[0], V[2], V[1], V[3]])
    um = V
    up = shift_p(V, axis)
    F = _central_flux(params, up, um) + _diffusive_flux(
        params, up, um, up - um, shift_p(up, axis) - up, um - shift_m(V, axis))
    if swap_xy:
        F = torch.stack([F[0], F[2], F[1], F[3]])
    return F


def laxliu_evolve(params: RunParams, U):
    """One Lax-Liu half-step (HydroRunLaxLiu.cpp:112-230): the x and the y
    flux differences, both from the state before the sweep. U is not
    changed."""
    U = make_boundaries(params, U)
    V = _to_ll(U)
    Fx = _interface_flux(params, V, _X, swap_xy=False)
    Fy = _interface_flux(params, V, _Y, swap_xy=True)
    V_new = V - params.xlambda * (Fx - shift_m(Fx, _X)) - params.ylambda * (Fy - shift_m(Fy, _Y))
    # the positivity clamp of density and energy (HydroRunLaxLiu.cpp:198-205)
    V_new[0] = xp.maximum(V_new[0], params.smallr)
    V_new[3] = xp.maximum(V_new[3], params.smallr)
    g = params.ghost_width
    inner = (slice(None), slice(g, -g), slice(g, -g))
    U[inner] = _from_ll(V_new)[inner]
    return U


def laxliu_step(params: RunParams, U):
    """Two half-sweeps averaged with the state before them
    (HydroRunLaxLiu.cpp oneStepIntegration + averageArray)."""
    return 0.5 * (U + laxliu_evolve(params, laxliu_evolve(params, U)))
