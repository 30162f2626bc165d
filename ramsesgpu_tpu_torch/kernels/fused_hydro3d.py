"""3D hydro on the CUDA kernels (the port's counterpart of
ramsesgpu_tpu/pallas/fused_hydro3d.py): the chunk loop and the ghosted
step.

- ``make_advance_n`` is the loop of every hydro run the kernels cover. It
  stands for both JAX loops, the fully periodic one
  (``make_pallas_hydro_advance_n``, :204) and the walled padded-carry one
  (``make_pallas_hydro_bc_advance_n``, :302): the port's loop state is the
  interior-only S [5, nz, ny, nx] for any mix of DIRICHLET / NEUMANN /
  PERIODIC faces (kernels/packed_bc.py), so one loop serves both. Each
  step launches the CFL kernel (kernels/cfl_hydro.py) and the step
  kernel's interior mode (kernels/hydro_step.py), which writes the new
  state into a second buffer (the two take turns, kernels/loop.py
  streamed_step). With ``[implementation] kernel=zcarry`` a fully periodic
  run takes the folded-CFL step instead (kernels/zcarry_hydro3d.py: the
  same streamed body, the CFL folded in, the JAX inv-carry loop of
  fused_hydro3d.py:243-260); a walled run keeps the step kernel's wall
  rules, as the JAX package takes its whole-array step there
  (scripts/perf_table.py:113-114).
- ``make_step_fn`` is ``make_pallas_hydro_step_fn`` (:393): one step of a
  ghosted state through the step kernel's ghosted mode (the TPU kernel
  ``make_fused_hydro_update``, :46), then the boundary fill around the new
  interior.
- The inflow jet (``problem=jet``) rewrites ghosts, which the interior
  mode's load rules cannot express, so its loop runs on the ghosted state
  itself (kernels/loop.py make_ghosted_loop): each step the CFL kernel on
  the ghosted state with the jet's floor, the in-place fill with the jet,
  and the step kernel's ghosted mode in place (``hydro_step.ghosted_``).
  Its ``make_step_fn`` is the JAX whole-array step (the JAX package takes
  no kernel for the jet, fused_hydro3d.py:42): the same three on a copy.
- Viscosity (nu > 0) takes the same ghosted loop and step (``ghosted_step_``),
  the JAX whole-array step with its viscous sub-step (solvers/step.py:
  257-277 there: dt, the fill, the step, make_boundaries, apply_viscosity):
  after the step kernel's ghosted mode the in-place fill again (the jet
  included) and ``solvers.dissipation.viscosity_``, whole-array PyTorch
  (the JAX package has no kernel for it; the module note there). A forced
  run takes the forcing after that, on the interior.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..config.params import RunParams
from ..solvers.boundary import fill_ghosts_, make_boundaries_concat, uses_jet
from ..solvers.dissipation import viscosity_
from ..solvers.timestep import dt_from_inv
from .cfl_hydro import cfl_hydro
from .hydro_step import hydro_step, require_hydro_scope
from .loop import make_ghosted_loop, make_kernel_loop, streamed_step
from .packed_bc import pack_state, unpack_state
from .zcarry_hydro3d import zcarry_hydro, zcarry_hydro_supported


def make_advance_n(params: RunParams, device, packed_form: bool = False,
                   post_step: Callable | None = None):
    """The hydro chunk loop; see kernels/loop.py make_kernel_loop. Ghosts
    need not be valid on entry: pack keeps the interior only (the jet:
    make_ghosted_loop, on the ghosted state as it is). ``post_step``: the
    forcing of a turbulence run (the loop then takes the CFL kernel's
    inverse dt each step, not the folded one)."""
    require_hydro_scope(params)
    g = params.ghost_width
    if uses_ghosted_hydro(params):
        if post_step is not None and uses_jet(params):
            raise NotImplementedError("forcing with the jet")
        return make_ghosted_loop(
            params, device, lambda U: cfl_hydro(params, U, ghost=g), ghosted_step_,
            lambda U: hydro_step.scratch(params, U), packed_form=packed_form,
            post_step=post_step)

    folded = params.kernel == "zcarry" and zcarry_hydro_supported(params)

    def step_into(S, out, dt, active, t):
        if folded:
            return zcarry_hydro(params, S, out, dt, active)
        hydro_step(params, S, out, dt, active)
        return None

    return make_kernel_loop(
        params, device, lambda S: cfl_hydro(params, S), lambda S: streamed_step(S, step_into),
        pack=lambda U: pack_state(params, U),
        unpack=lambda S, t: unpack_state(params, S),
        packed_form=packed_form, post_step=post_step,
    )


def uses_ghosted_hydro(params: RunParams) -> bool:
    """Whether a hydro run takes the ghosted loop: the inflow jet, or
    viscosity."""
    return uses_jet(params) or params.nu > 0


def ghosted_step_(params: RunParams, U, dt, active, buf) -> torch.Tensor:
    """One step of the ghosted state U in place when ``active`` (``buf``:
    ``hydro_step.scratch``), its ghosts filled: the step kernel's ghosted
    mode; with nu > 0 then the in-place fill again and the viscous
    sub-step. Returns U."""
    hydro_step.ghosted_(params, U, dt, active, buf)
    if params.nu > 0:
        viscosity_(params, fill_ghosts_(params, U, active), dt, active)
    return U


def make_step_fn(params: RunParams, device) -> Callable:
    """``step(U, t) -> (U_new, dt)`` on the ghosted state, whose ghosts
    must be valid on entry (every step returns them filled)."""
    require_hydro_scope(params)
    g = params.ghost_width
    buf = None  # the in-place step's interior buffer (the ghosted loop's), allocated once

    def step(U, t):
        nonlocal buf
        U = U.contiguous()
        dt = dt_from_inv(params, cfl_hydro(params, U, ghost=g))
        if uses_ghosted_hydro(params):
            U = fill_ghosts_(params, U.clone())
            if buf is None:
                buf = hydro_step.scratch(params, U)
            always = torch.ones((), dtype=torch.bool, device=U.device)
            return ghosted_step_(params, U, dt, always, buf), dt
        new_interior = hydro_step.ghosted(params, U, dt)
        return make_boundaries_concat(params, new_interior, interior_only=True), dt

    return step
