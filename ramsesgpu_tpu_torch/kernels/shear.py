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
updated state (stratified: with the z slabs), and the dissipation
kernel's shearing-box mode, which also takes the kept face's resistive CT
(kernels/dissip_step.py; the JAX loop's pallas/shear_packed.py:1178-1203);
it writes the new state into the other
of two state buffers, which take turns. The device t feeds the slabs and
the remap, so a chunk makes no host sync.

Compensated (``[implementation] compensated``): S is [16, nz, ny, nx] (the
state, then its Kahan carry) and kept [2, nz, ny] (the face, then its
carry); pack appends zero carries and unpack drops them
(pallas/shear_packed.py:1210-1245). Stratified (BC_Z_STRATIFIED z faces
and the static vertical gravity, TPU row A′-stratified): the slab launch
also builds the z ghost slabs of the interior and of the x slabs
(kernels/shear_border.py) before the step kernel, which reads them and
g_z, one value per z row (``gz``, the run's gravity field column).

``[implementation] kernel=zcarry`` (pallas/shear_packed.py:880-895) runs
the streamed step kernel's shear modes (kernels/zcarry_mhd3d.py) as the
main kernel: the same slabs, border and CFL launches around it, the state
in two buffers that take turns (kept stays one), no stage buffer; a
dissipative run's sub-step writes back into the step's input buffer.

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
from ..solvers.shear import wrap_axis, wrap_yz
from ..solvers.stratified import uses_stratified_z
from ..solvers.timestep import dt_from_inv
from .cfl_mhd import cfl_mhd
from .dissip_step import dissip_step
from .loop import make_kernel_loop, streamed_step
from .mhd_step import NPLANE, SLAB, mhd_step, require_step_scope, uses_shear, zslab_shape
from .shear_border import shear_border, shear_slabs
from .zcarry_mhd3d import zcarry_mhd


def require_shear(params: RunParams) -> None:
    if not uses_shear(params):
        raise ValueError("not a shearing-box configuration")
    require_step_scope(params)


def pack(params: RunParams, U: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Ghosted state -> the loop state (S, kept): new contiguous tensors
    (pallas/shear_packed.py:1210 pack_shear without its ghost bands), with
    zero Kahan carries when compensated."""
    g = params.ghost_width
    S = U[:, g:-g, g:-g, g:g + params.nx]
    kept = U[IA, g:-g, g:-g, params.nx + g]
    if params.compensated:
        S = torch.cat([S, torch.zeros_like(S)])
        kept = torch.stack([kept, torch.zeros_like(kept)])
    return S.contiguous(), kept.contiguous()


def unpack(params: RunParams, state, t: torch.Tensor) -> torch.Tensor:
    """The loop state -> the ghosted state with a fresh sheared fill at
    time t (pallas/shear_packed.py:1234 unpack_shear): the slabs at t (the
    slab kernel at t + 0, the kept face written as the XMAX slab's first
    Bx column), beside the interior in x, then the y and z wraps (or,
    stratified, the z ghost slabs of that block and the y wrap). Carries
    are dropped."""
    S, kept = state
    strat = uses_stratified_z(params)
    zslabs = torch.empty(zslab_shape(params), dtype=S.dtype, device=S.device) if strat else None
    slabs = shear_slabs(params, S, kept, t, torch.zeros_like(t), zout=zslabs)
    mid = torch.cat([slabs[0], S[:8], slabs[1]], dim=-1)
    if not strat:
        return wrap_yz(params, mid)
    mid = torch.cat([zslabs[0], mid, zslabs[1]], dim=-3)
    return wrap_axis(params, mid, -2)


def bind_step(params: RunParams, state, gz: torch.Tensor | None = None) -> Callable:
    """The shearing-box step with its buffers for this state's shapes:
    ``step(state, dt, active, t) -> (state', None)`` advances (S, kept)
    from t (kernels/loop.py): in place; into S's other buffer with
    kernel=zcarry or with nu / eta (the dissipation kernel writes into it
    after the staged step); both, and back into S, with kernel=zcarry and
    nu / eta. kept is updated in place. ``gz``: g_z of each z row [nz +
    6], for stratified z faces."""
    S = state[0]
    strat = uses_stratified_z(params)
    if strat and (gz is None or tuple(gz.shape) != (params.nz + 2 * SLAB,)):
        raise ValueError("stratified z faces need gz, g_z of each z row [nz + 6]")
    dissip = uses_dissipation(params)
    streamed = params.kernel == "zcarry"
    scratch = None if streamed else mhd_step.scratch(params, S)
    slabs = torch.empty((2, 8, params.nz, params.ny, SLAB), dtype=S.dtype, device=S.device)
    planes = torch.zeros((NPLANE, params.nz, params.ny), dtype=S.dtype, device=S.device)
    remapped = torch.zeros((4, params.nz, params.ny), dtype=S.dtype, device=S.device)
    zslabs = torch.empty(zslab_shape(params), dtype=S.dtype, device=S.device) if strat else None
    gz = None if gz is None else gz.to(device=S.device, dtype=S.dtype).contiguous()

    def step_into(S, kept, out, dt, active, t):
        # the reference fills the shear ghosts for totalTime + dt
        # (MHDRunGodunov.cpp:3551)
        shear_slabs(params, S, kept, t, dt, out=slabs, zout=zslabs)
        shear = (slabs, planes, zslabs, gz) if strat else (slabs, planes)
        if streamed:
            zcarry_mhd(params, S, out, dt, active, shear=shear)
        else:
            mhd_step(params, S, dt, active, scratch, shear=shear)
        shear_border(params, out, kept, planes, t, dt, active, remapped)

    def dissip_into(S, kept, out, dt, active, t):
        # the sheared refill at t + dt from the updated state S before the
        # dissipative sub-step into out (MHDRunGodunov.cpp:1968-1976; the
        # stratified z slabs of that block too, as the JAX whole-array
        # step's make_all_boundaries_shear)
        shear_slabs(params, S, kept, t, dt, out=slabs, zout=zslabs)
        dissip_step(params, S, out, dt, active,
                    shear=(slabs, kept, zslabs) if strat else (slabs, kept))

    if streamed and dissip:
        # the step into the other buffer, the sub-step back into S
        other = torch.empty_like(S)

        def step(state, dt, active, t):
            step_into(state[0], state[1], other, dt, active, t)
            dissip_into(other, state[1], state[0], dt, active, t)
            return state, None

        return step
    if streamed or dissip:
        # the streamed step, or the staged step in place and the sub-step
        # into the other buffer: the two buffers take turns
        def into(st, out, dt, active, t):
            if streamed:
                step_into(st[0], st[1], out, dt, active, t)
            else:
                step_into(st[0], st[1], st[0], dt, active, t)
                dissip_into(st[0], st[1], out, dt, active, t)

        return streamed_step(state, into)

    def step(state, dt, active, t):
        step_into(state[0], state[1], state[0], dt, active, t)
        return state, None

    return step


def make_advance_n(params: RunParams, device, packed_form: bool = False,
                   gz: torch.Tensor | None = None):
    """The shearing-box chunk loop; see kernels/loop.py make_kernel_loop.
    The loop state is the pair (S, kept); ``gz`` as in bind_step."""
    require_shear(params)
    return make_kernel_loop(
        params, device, lambda st: cfl_mhd(params, st[0], kept=st[1]),
        lambda st: bind_step(params, st, gz),
        pack=lambda U: pack(params, U),
        unpack=lambda st, t: unpack(params, st, t),
        packed_form=packed_form,
    )


def make_step_fn(params: RunParams, device, gz: torch.Tensor | None = None) -> Callable:
    """``step(U, t) -> (U_new, dt)`` on the ghosted state: pack (zero
    carries when compensated), one step, and the fresh sheared fill at
    t + dt (pallas/shear_packed.py:1248 make_shear_packed_step_fn)."""
    require_shear(params)
    step = None  # bound to the buffers of the first state

    def step_fn(U, t):
        nonlocal step
        state = pack(params, U)
        if step is None:
            step = bind_step(params, state, gz)
        dt = dt_from_inv(params, cfl_mhd(params, state[0], kept=state[1]))
        active = torch.ones((), dtype=torch.bool, device=U.device)
        state, _ = step(state, dt, active, t)
        return unpack(params, state, t + dt), dt

    return step_fn
