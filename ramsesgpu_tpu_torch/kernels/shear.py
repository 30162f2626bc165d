"""The shearing-box (MRI) advance loop on the CUDA kernels (the port's
counterpart of ramsesgpu_tpu/pallas/shear_packed.py:1210-1325
``pack_shear`` / ``unpack_shear`` / ``make_shear_packed_step_fn`` /
``make_pallas_shear_advance_n``).

Loop state: the pair (S [8, nz, ny, nx], kept [nz, ny]): the interior and
the kept Bx face at x = nx, the last interior cell's right face, which the
sheared fill leaves alone and only the CT updates. Each step launches
four kernels: the CFL reduction with the kept face (kernels/cfl_mhd.py),
the sheared ghost slabs at t + dt (kernels/shear_border.py), the step
kernel's shearing-box mode (kernels/mhd_step.py), and the remap, border
corrections and kept-face CT (kernels/shear_border.py). A dissipative run
(nu > 0 or eta > 0) launches two more: the slabs again at t + dt, from the
updated state, and the dissipation kernel's shearing-box mode, which also
takes the kept face's resistive CT (kernels/dissip_step.py; the JAX loop's
pallas/shear_packed.py:1178-1203). The device t feeds the slabs and the
remap, so a chunk makes no host sync.

``[implementation] stripFused`` (the JAX package's fused border strip,
pallas/shear_packed.py:432, its default for a dissipative MRI when
ny % 128 == 0) selects nothing here: the port has no strip. What the fused
strip computes in one launch (the slab build, the flux and emfY remap,
the density floor, the kept-Bx CT delta, and in its "dissip" mode the
resistive kept-face planes) these kernels compute for every value of the
key, on every ny.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..config.params import RunParams
from ..core.constants import IA
from ..solvers.dissipation import uses_dissipation
from ..solvers.shear import wrap_yz
from ..solvers.timestep import dt_from_inv
from .cfl_mhd import cfl_mhd
from .dissip_step import dissip_step
from .loop import make_kernel_loop
from .mhd_step import NPLANE, SLAB, mhd_step, require_step_scope, uses_shear
from .shear_border import shear_border, shear_slabs


def require_shear(params: RunParams) -> None:
    if not uses_shear(params):
        raise ValueError("not a shearing-box configuration")
    require_step_scope(params)


def pack(params: RunParams, U: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Ghosted state -> the loop state (S, kept): new contiguous tensors
    (pallas/shear_packed.py:1210 pack_shear without its ghost bands)."""
    g = params.ghost_width
    S = U[:, g:-g, g:-g, g:g + params.nx].contiguous()
    kept = U[IA, g:-g, g:-g, params.nx + g].contiguous()
    return S, kept


def unpack(params: RunParams, state, t: torch.Tensor) -> torch.Tensor:
    """The loop state -> the ghosted state with a fresh sheared fill at
    time t (pallas/shear_packed.py:1234 unpack_shear): the slabs at t (the
    slab kernel at t + 0, the kept face written as the XMAX slab's first
    Bx column), beside the interior in x, then the y and z wraps."""
    S, kept = state
    slabs = shear_slabs(params, S, kept, t, torch.zeros_like(t))
    return wrap_yz(params, torch.cat([slabs[0], S, slabs[1]], dim=-1))


def bind_step(params: RunParams, state) -> Callable:
    """The shearing-box step with its buffers for this state's shapes:
    ``step(state, dt, active, t)`` advances (S, kept) in place from t."""
    S, _kept = state
    scratch = mhd_step.scratch(params, S)
    slabs = torch.empty((2, 8, params.nz, params.ny, SLAB), dtype=S.dtype, device=S.device)
    planes = torch.zeros((NPLANE, params.nz, params.ny), dtype=S.dtype, device=S.device)
    remapped = torch.zeros((4, params.nz, params.ny), dtype=S.dtype, device=S.device)

    def step(state, dt, active, t):
        S, kept = state
        # the reference fills the shear ghosts for totalTime + dt
        # (MHDRunGodunov.cpp:3551)
        shear_slabs(params, S, kept, t, dt, out=slabs)
        mhd_step(params, S, dt, active, scratch, shear=(slabs, planes))
        shear_border(params, S, kept, planes, t, dt, active, remapped)
        if uses_dissipation(params):
            # the sheared refill at t + dt from the updated state before the
            # dissipative sub-step (MHDRunGodunov.cpp:1968-1976); the step
            # kernel's stage buffer is idle by then
            shear_slabs(params, S, kept, t, dt, out=slabs)
            dissip_step(params, S, dt, active, scratch, shear=(slabs, kept))

    return step


def make_advance_n(params: RunParams, device, packed_form: bool = False):
    """The shearing-box chunk loop; see kernels/loop.py make_kernel_loop.
    The loop state is the pair (S, kept)."""
    require_shear(params)
    return make_kernel_loop(
        params, device, lambda st: cfl_mhd(params, st[0], kept=st[1]),
        lambda st: bind_step(params, st),
        pack=lambda U: pack(params, U),
        unpack=lambda st, t: unpack(params, st, t),
        packed_form=packed_form,
    )


def make_step_fn(params: RunParams, device) -> Callable:
    """``step(U, t) -> (U_new, dt)`` on the ghosted state: pack, one step,
    and the fresh sheared fill at t + dt
    (pallas/shear_packed.py:1248 make_shear_packed_step_fn)."""
    require_shear(params)
    step = None  # bound to the buffers of the first state

    def step_fn(U, t):
        nonlocal step
        state = pack(params, U)
        if step is None:
            step = bind_step(params, state)
        dt = dt_from_inv(params, cfl_mhd(params, state[0], kept=state[1]))
        active = torch.ones((), dtype=torch.bool, device=U.device)
        step(state, dt, active, t)
        return unpack(params, state, t + dt), dt

    return step_fn
