"""The alternative 2D / 3D schemes, whole-array PyTorch on the ghosted
state (the port's counterpart of ramsesgpu_tpu/solvers/alt_schemes.py):
the directionally split Godunov scheme, Kurganov-Tadmor and relaxing TVD.

- split Godunov (reference godunov.cuh + trace.h:32-129): RAMSES's
  directionally split MUSCL-Hancock with characteristic tracing, the sweep
  order permuted by the step's parity (HydroRunGodunov.cpp:321-360);
- Kurganov-Tadmor (HydroRunKT.cpp): the staggered central scheme (FD2,
  odd and even grids), 2D only, dt = xlambda dx;
- relaxing TVD (relaxingTVD.h, HydroRunRelaxingTVD.cpp): the Jin-Xin
  relaxation with the van Leer limiter, on a ghost width of 3.

The JAX package has no kernel for any of them: they are whole-array jnp
there, and the same whole-array steps run here on the state's device.
Each op keeps the JAX function's order; divisions of a tensor by a Python
float are true divisions (``solvers.dissipation._div``) and every square
root goes through ``ops.backend.sqrt``. The Lax-Liu scheme is
alt_laxliu.py.
"""
from __future__ import annotations

import torch

from ..config.params import RunParams
from ..core.constants import ID, IP, IU, IV, IW, Scheme
from ..ops.backend import xp
from ..ops.eos import constoprim_hydro
from ..ops.riemann import riemann_hydro
from ..ops.slopes import slope_1d
from ..ops.stencil import shift_m, shift_p
from .boundary import make_boundaries
from .dissipation import _div
from .godunov import _rotation, permute

_AXIS = {0: -1, 1: -2, 2: -3}
_SWEEP_ORDERS_2D = [(0, 1), (1, 0)]
_SWEEP_ORDERS_3D = [
    (0, 1, 2), (1, 2, 0), (2, 1, 0), (0, 1, 2), (1, 2, 0), (2, 0, 1),
]


def sweep_order(params: RunParams, n_step: int) -> tuple:
    """The directions of step ``n_step``'s sweeps (HydroRunGodunov.cpp:321-360)."""
    if params.dim == 2:
        return _SWEEP_ORDERS_2D[n_step % 2]
    return _SWEEP_ORDERS_3D[n_step % 6]


def _interior(params: RunParams) -> tuple:
    return (slice(None),) + (slice(params.ghost_width, -params.ghost_width),) * params.dim


# -------------------------------------------------------------------------
# directionally split Godunov
# -------------------------------------------------------------------------
def _trace_split(params: RunParams, Q, c, dtdx, axis):
    """The characteristic trace along one direction (trace.h:32-129) of the
    component-rotated primitives Q (IU the sweep-normal velocity):
    (qxm, qxp), the left and right edge states of each cell."""
    dq = slope_1d(params, Q, axis) if params.iorder != 1 else torch.zeros_like(Q)

    if params.scheme == Scheme.MUSCL:
        zerol = dtdx.new_full((), -100.0) / dtdx
        zeror = dtdx.new_full((), 100.0) / dtdx
        project = 1.0
    elif params.scheme == Scheme.PLMDE:
        zerol = zeror = 0.0
        project = 1.0
    else:  # Collela
        zerol = zeror = 0.0
        project = 0.0

    cc = c
    csq = cc * cc
    r, p, u, v = Q[ID], Q[IP], Q[IU], Q[IV]
    dr, dp, du, dv = dq[ID], dq[IP], dq[IU], dq[IV]

    alpham = 0.5 * (dp / (r * cc) - du) * r / cc
    alphap = 0.5 * (dp / (r * cc) + du) * r / cc
    alpha0r = dr - dp / csq
    alpha0v = dv

    def state(right: bool):
        if right:
            spminus = torch.where((u - cc) < zeror, (u - cc) * dtdx + 1.0, project)
            spplus = torch.where((u + cc) < zeror, (u + cc) * dtdx + 1.0, project)
            spzero = torch.where(u < zeror, u * dtdx + 1.0, project)
        else:
            spminus = torch.where((u - cc) > zerol, (u - cc) * dtdx - 1.0, -project)
            spplus = torch.where((u + cc) > zerol, (u + cc) * dtdx - 1.0, -project)
            spzero = torch.where(u > zerol, u * dtdx - 1.0, -project)
        ap = -0.5 * spplus * alphap
        am = -0.5 * spminus * alpham
        azr = -0.5 * spzero * alpha0r
        azv = -0.5 * spzero * alpha0v
        out = [r + ap + am + azr, p + (ap + am) * csq, u + (ap - am) * cc / r, v + azv]
        if params.dim == 3:
            out.append(Q[IW] - 0.5 * spzero * dq[IW])
        return torch.stack(out)

    return state(False), state(True)


def _split_sweep(params: RunParams, U, dt, direction):
    """One 1D Godunov sweep along ``direction`` (godunov.cuh semantics)."""
    axis = _AXIS[direction]
    dtdx = _div(dt, [params.dx, params.dy, params.dz][direction])

    U = make_boundaries(params, U)
    Q, c = constoprim_hydro(params, U)
    perm = _rotation(params, direction)
    qxm, qxp = _trace_split(params, permute(Q, perm), c, dtdx, axis)
    flux = permute(riemann_hydro(params, shift_m(qxm, axis), qxp), perm)

    inner = _interior(params)
    U[inner] += (dtdx * (flux - shift_p(flux, axis)))[inner]
    return U


def godunov_split_step(params: RunParams, U, dt, n_step: int):
    """The directionally split update with the parity-permuted sweep order
    of step ``n_step`` (an int); U is not changed."""
    for d in sweep_order(params, n_step):
        U = _split_sweep(params, U, dt, d)
    return U


# -------------------------------------------------------------------------
# Kurganov-Tadmor central scheme (2D)
# -------------------------------------------------------------------------
def _minmod3(a, b, c):
    def mm(x, y):
        return torch.where(x * y <= 0, 0.0, torch.where(torch.abs(x) < torch.abs(y), x, y))

    return mm(a, mm(b, c))


def _kt_flux(params: RunParams, U):
    """The cell-centred Euler fluxes along x and y (kurganov-tadmor.h get_flux)."""
    rho = U[ID]
    p = xp.maximum((params.gamma0 - 1.0) * (U[IP] - 0.5 * (U[IU] ** 2 + U[IV] ** 2) / rho),
                   rho * params.smallp)
    fx = torch.stack([U[IU], (U[IP] + p) * (U[IU] / rho), U[IU] ** 2 / rho + p,
                      U[IU] * U[IV] / rho])
    fy = torch.stack([U[IV], (U[IP] + p) * (U[IV] / rho), U[IU] * U[IV] / rho,
                      U[IV] ** 2 / rho + p])
    return fx, fy


def _kt_limited_derivative(a, axis, alpha):
    return _minmod3(alpha * (shift_p(a, axis) - a), 0.5 * (shift_p(a, axis) - shift_m(a, axis)),
                    alpha * (a - shift_m(a, axis)))


def kt_step(params: RunParams, U, odd: bool, xlam: float, ylam: float):
    """One staggered KT step (HydroRunKT.cpp kt_evolve /
    reconstruction_2d_FD2 / predictor_corrector_2d_FD2) with dt = xlam dx;
    ``odd`` selects the staggering offset. U is not changed."""
    alpha = torch.tensor(params.alpha_kt, dtype=U.dtype, device=U.device)  # in [1, 2]
    U = make_boundaries(params, U)
    X, Y = -1, -2
    sp, sm = shift_p, shift_m

    up = _kt_limited_derivative(U, X, alpha)  # x derivatives
    uq = _kt_limited_derivative(U, Y, alpha)  # y derivatives

    if odd:
        # the staggered average centred at (i+1/2, j+1/2)
        uhalf = 0.25 * (
            U + sp(U, X) + sp(U, Y) + sp(sp(U, X), Y)
            + 0.25 * ((up - sp(up, X)) + (sp(up, Y) - sp(sp(up, X), Y))
                      + (uq - sp(uq, Y)) + (sp(uq, X) - sp(sp(uq, X), Y))))
    else:
        uhalf = 0.25 * (
            sm(U, Y) + sm(sm(U, X), Y) + U + sm(U, X)
            + 0.25 * ((sm(sm(up, X), Y) - sm(up, Y)) + (sm(up, X) - up)
                      + (sm(sm(uq, X), Y) - sm(uq, X)) + (sm(uq, Y) - uq)))

    fx, fy = _kt_flux(params, U)
    fpr = _kt_limited_derivative(fx, X, alpha)
    gqr = _kt_limited_derivative(fy, Y, alpha)

    # predictor
    ustar = U - 0.5 * (xlam * fpr + ylam * gqr)
    fsx, fsy = _kt_flux(params, ustar)

    if odd:
        unew = uhalf - 0.5 * (
            xlam * ((sp(fsx, X) - fsx) + (sp(sp(fsx, X), Y) - sp(fsx, Y)))
            + ylam * ((sp(fsy, Y) - fsy) + (sp(sp(fsy, X), Y) - sp(fsy, X))))
    else:
        unew = uhalf - 0.5 * (
            xlam * ((sm(fsx, Y) - sm(sm(fsx, X), Y)) + (fsx - sm(fsx, X)))
            + ylam * ((sm(fsy, X) - sm(sm(fsy, X), Y)) + (fsy - sm(fsy, Y))))

    inner = _interior(params)
    U[inner] = unew[inner]
    return U


# -------------------------------------------------------------------------
# relaxing TVD (Jin-Xin relaxation, van Leer limiter)
# -------------------------------------------------------------------------
def _average_flux(params: RunParams, Ur):
    """The cell-centred flux and freezing speed of the rotated state Ur
    (relaxingTVD.h averageFlux)."""
    rho = xp.maximum(Ur[ID], 1e-9)
    v = Ur[IU] / rho
    ek = 0.5 * sum(Ur[c] ** 2 for c in range(2, Ur.shape[0])) / rho
    P = xp.maximum(0.0, (params.gamma0 - 1.0) * (Ur[IP] - ek))
    c = torch.abs(v) + xp.maximum(xp.sqrt(params.gamma0 * P / rho), 1e-5)
    w = [rho * v, (Ur[IP] + P) * v, Ur[IU] * v + P]
    w += [Ur[comp] * v for comp in range(3, Ur.shape[0])]
    return torch.stack(w), c


def _vanleer(f, a, b):
    c = a * b
    return f + torch.where(c > 0, 2 * c / torch.where(a + b == 0, 1.0, a + b), 0.0)


def _relaxing_sweep(params: RunParams, U, dt, direction):
    """One relaxing-TVD sweep (HydroRunRelaxingTVD.cpp:219-380)."""
    axis = _AXIS[direction]
    dtdx = _div(dt, [params.dx, params.dy, params.dz][direction])

    U = make_boundaries(params, U)
    perm = _rotation(params, direction)
    Ur0 = permute(U, perm)

    def fluxes(Ur):
        w, c = _average_flux(params, Ur)
        fr = (Ur * c + w) / 2                     # right-movers at the cell centres
        fl = shift_p((Ur * c - w) / 2, axis)      # fl(i): the left-mover of cell i+1
        return fr, fl

    # half step: first-order upwind
    fr, fl = fluxes(Ur0)
    fu = fr - fl
    u1 = Ur0 - (fu - shift_m(fu, axis)) * dtdx / 2

    # full step: second-order TVD on the half-step state
    fr, fl = fluxes(u1)
    # right-moving waves: dfl(i) = (fr(i) - fr(i-1)) / 2, dfr(i) = dfl(i+1)
    dfl_r = (fr - shift_m(fr, axis)) / 2
    fr = _vanleer(fr, dfl_r, shift_p(dfl_r, axis))
    # left-moving waves: dfl(i) = (fl(i-1) - fl(i)) / 2, dfr(i) = dfl(i+1)
    dfl_l = (shift_m(fl, axis) - fl) / 2
    fl = _vanleer(fl, dfl_l, shift_p(dfl_l, axis))

    fu = fr - fl
    dU = permute(-(fu - shift_m(fu, axis)) * dtdx, perm)
    inner = _interior(params)
    U[inner] += dU[inner]
    return U


def relaxing_tvd_step(params: RunParams, U, dt, n_step: int):
    """The relaxing-TVD sweeps in step ``n_step``'s order, as the split
    scheme's; U is not changed."""
    for d in sweep_order(params, n_step):
        U = _relaxing_sweep(params, U, dt, d)
    return U
