"""The 2D path: hydro (approx / HLL / HLLC) and ideal MHD with constrained
transport (HLLD, LLF or HLL faces; HLLD, HLLA, HLLF or LLF corner EMFs;
the rotating frame), whole-array
PyTorch on the ghosted state (the counterpart of the JAX package's 2D
``make_step_fn`` / ``make_advance_n``, solvers/step.py:207-228, 258-280 and
the jitted while loop at :359-376 there).

Every Pallas kernel of the JAX package is gated on ``params.dim == 3``,
so its 2D runs are this whole-array step under XLA on every backend. The port's
2D path is the same step in PyTorch on the run's device: there is no TPU
kernel for a hand-written one to replace, and this is no fallback.

Each step, as the JAX step: the CFL reduction on the state as it stands
(before the fill), the ghost fill in place (solvers/boundary.py
fill_ghosts_: any mix of DIRICHLET / NEUMANN / PERIODIC faces, the 2D
jet's YMIN strip), then the Godunov update (solvers/godunov.py
godunov_unsplit_hydro, solvers/godunov_mhd.py godunov_unsplit_mhd, whose
CT also writes the face layer n+g), with the static gravity field where
the run has one (uniform, or the Keplerian disk's: the half-dt kick of
the traced states and the conservative source). The chunk loop is kernels/loop.py
make_ghosted_loop: dt, t, the step count and the ``t < t_end`` flag stay
device tensors and a step past t_end leaves the state as it was, so a
chunk makes no host sync.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..config.params import RunParams
from ..core.constants import RiemannSolver
from ..kernels.loop import make_ghosted_loop
from .boundary import make_boundaries, require_simple_bcs
from .godunov import godunov_unsplit_hydro
from .godunov_mhd import godunov_unsplit_mhd
from .timestep import dt_from_inv, inv_dt_ghosted

_HYDRO_SOLVERS = (RiemannSolver.APPROX, RiemannSolver.HLL, RiemannSolver.HLLC)


def require_2d_scope(params: RunParams) -> None:
    """Raise NotImplementedError for the 2D configurations the port does
    not compute (ROADMAP Queue 1 items 3 and 4). ``[implementation]
    compensated`` selects nothing in 2D: the state is plain, as in the JAX
    package, which reads the switch only on its 3D MHD paths."""
    reasons = []
    if params.mhd:
        if params.nu > 0 or params.eta > 0:
            reasons.append("2D viscosity / resistivity")
    else:
        if params.riemann_solver not in _HYDRO_SOLVERS:
            reasons.append(f"riemannSolver {params.riemann_solver.name} (approx, hll, hllc)")
        if params.nu > 0:
            reasons.append("2D viscosity (nu > 0)")
    if reasons:
        raise NotImplementedError("not ported: " + "; ".join(reasons))
    require_simple_bcs(params)


def _update(params: RunParams) -> Callable:
    return godunov_unsplit_mhd if params.mhd else godunov_unsplit_hydro


def make_step_fn(params: RunParams, gravity: torch.Tensor | None = None) -> Callable:
    """``step(U, t) -> (U_new, dt)`` on the ghosted 2D state: dt from U as
    it stands, then the update of a filled copy (U is not changed).
    ``gravity``: the static field [2, ny+2g, nx+2g] on U's device
    (solvers/step.py make_gravity_field) or None."""
    require_2d_scope(params)
    update = _update(params)

    def step(U, t):
        dt = dt_from_inv(params, inv_dt_ghosted(params, U))
        return update(params, make_boundaries(params, U), dt, gravity), dt

    return step


def make_advance_n(params: RunParams, device, packed_form: bool = False,
                   gravity: torch.Tensor | None = None):
    """The 2D chunk loop (kernels/loop.py make_ghosted_loop): the loop
    state is a copy of the ghosted state; see make_kernel_loop there for
    ``advance_n`` and the ``packed_form`` triple. ``gravity``: the static
    field on ``device``, or None."""
    require_2d_scope(params)
    update = _update(params)

    def step_(params, U, dt, active, _buf):
        U.copy_(torch.where(active, update(params, U, dt, gravity), U))

    return make_ghosted_loop(params, device, lambda U: inv_dt_ghosted(params, U), step_,
                             lambda U: None, packed_form=packed_form)
