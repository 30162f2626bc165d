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
  kernel's interior mode (kernels/hydro_step.py).
- ``make_step_fn`` is ``make_pallas_hydro_step_fn`` (:393): one step of a
  ghosted state through the step kernel's ghosted mode (the TPU kernel
  ``make_fused_hydro_update``, :46), then the boundary fill around the new
  interior.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..config.params import RunParams
from ..solvers.boundary import make_boundaries_concat
from ..solvers.timestep import dt_from_inv
from .cfl_hydro import cfl_hydro
from .hydro_step import hydro_step, require_hydro_scope
from .loop import make_kernel_loop
from .packed_bc import pack_state, unpack_state


def make_advance_n(params: RunParams, device, packed_form: bool = False):
    """The hydro chunk loop; see kernels/loop.py make_kernel_loop. Ghosts
    need not be valid on entry: pack keeps the interior only."""
    require_hydro_scope(params)

    def bind_step(S):
        scratch = hydro_step.scratch(params, S)
        return lambda S, dt, active, t: hydro_step(params, S, dt, active, scratch)

    return make_kernel_loop(
        params, device, lambda S: cfl_hydro(params, S), bind_step,
        pack=lambda U: pack_state(params, U),
        unpack=lambda S, t: unpack_state(params, S),
        packed_form=packed_form,
    )


def make_step_fn(params: RunParams, device) -> Callable:
    """``step(U, t) -> (U_new, dt)`` on the ghosted state, whose ghosts
    must be valid on entry (every step returns them filled)."""
    require_hydro_scope(params)
    g = params.ghost_width
    scratch = None  # the step kernel's stage buffer, allocated once

    def step(U, t):
        nonlocal scratch
        U = U.contiguous()
        if scratch is None:
            scratch = hydro_step.scratch(params, U, ghosted=True)
        dt = dt_from_inv(params, cfl_hydro(params, U, ghost=g))
        new_interior = hydro_step.ghosted(params, U, dt, scratch)
        return make_boundaries_concat(params, new_interior, interior_only=True), dt

    return step
