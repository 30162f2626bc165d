"""The periodic 3D MHD advance loop on the CUDA kernels (the port's
counterpart of ramsesgpu_tpu/pallas/fused_mhd3d.py:274-488
``pallas_packed_supported`` / ``make_pallas_advance_n``).

Loop state: the interior-only periodic state S [8, nz, ny, nx]; the
kernels find periodic neighbours by index wrap, so pack is a slice of the
ghosted state and unpack the periodic ghost fill. Each step launches the
CFL kernel (kernels/cfl_mhd.py) and the step kernel (kernels/mhd_step.py)
through the shared chunk loop (kernels/loop.py); with nu > 0 or eta > 0
also the dissipation kernel (kernels/dissip_step.py) on the updated state,
whose index wrap is the inter-phase refill (the JAX loop's second
packed-io launch, pallas/fused_mhd3d.py:457-463), writing the new state
into the other of two state buffers, which take turns. A compensated run
carries [16, nz, ny, nx], the state and its Kahan carry (TPU row
A′-compensated, pallas/fused_mhd3d.py:247-259): pack appends a zero
carry, unpack drops it.

``[implementation] kernel=zcarry`` (pallas/fused_mhd3d.py:321-349) runs
the streamed step instead (kernels/zcarry_mhd3d.py: one launch, no stage
buffer, the state in two buffers that take turns), which folds the next
step's CFL into the step where there is no dissipation; a dissipative run
keeps the separate CFL launch, as the JAX loop does, because the folded
reduction would see the state before the dissipation kernel, whose output
goes back into the step's input buffer (no third buffer).

Walls (any mix of DIRICHLET / NEUMANN / PERIODIC faces that is not fully
periodic) and the inflow jet take the ghosted route, the JAX package's
``make_pallas_step_fn`` non-periodic branch (:538-548: compute_dt, the
fill, TPU row 3 ``make_fused_mhd_update``, the interior merge) with the
whole-array step's semantics: the loop state is the ghosted array
(kernels/loop.py make_ghosted_loop), and each step launches the CFL
kernel's ghosted mode on the state as it stands, fills the ghosts in
place (the jet too) and launches the step kernel's ghosted mode, which
writes the interior and the CT face layer n+g. ``kernel=zcarry`` runs
the same staged kernel there, as the JAX package takes its whole-array
step (solvers/step.py:326-358); ``compensated=yes`` runs the plain
update, as the JAX ``make_step_fn`` has no compensated branch.
``make_fused_mhd_update`` is row 3 with its outside contract, for the
sharded step of a later slice. ``make_fused_mhd_shear`` is TPU row 4
(pallas/fused_mhd3d.py:587) with its outside contract: a rank's step of
the sharded shearing box (parallel/sharded_step.py).
"""
from __future__ import annotations

from typing import Callable

import torch

from ..config.params import RunParams
from ..solvers.boundary import fill_ghosts_, interior, make_boundaries_concat
from ..solvers.dissipation import uses_dissipation
from ..solvers.timestep import dt_from_inv
from .cfl_mhd import cfl_mhd
from .dissip_step import dissip_step
from .loop import make_ghosted_loop, make_kernel_loop, streamed_step
from .mhd_step import (mhd_step, mhd_window, require_step_scope, require_window_scope,
                       uses_ghosted, uses_shear)
from .zcarry_mhd3d import zcarry_mhd


def packed_supported(params: RunParams) -> bool:
    """Whether the kernel loop covers this configuration."""
    try:
        require_step_scope(params)
    except NotImplementedError:
        return False
    return True


def make_advance_n(params: RunParams, device, packed_form: bool = False):
    """The MHD chunk loop; see kernels/loop.py make_kernel_loop (walls
    or the jet: make_ghosted_loop)."""
    require_step_scope(params)
    if uses_ghosted(params):
        return make_ghosted_loop(
            params, device, lambda U: cfl_mhd(params, U, ghost=params.ghost_width),
            mhd_step.ghosted, lambda U: mhd_step.scratch(params, U, ghosted=True),
            packed_form=packed_form)

    return make_kernel_loop(
        params, device, lambda S: cfl_mhd(params, S), lambda S: bind_step(params, S),
        pack=lambda U: pack(params, U),
        unpack=lambda S, t: unpack(params, S),
        packed_form=packed_form,
    )


def pack(params: RunParams, U) -> torch.Tensor:
    """Ghosted state -> the loop state (a new contiguous tensor): the
    interior, and a zero Kahan carry after it when compensated
    (pallas/packed_io.py pack_state with nvar = 16)."""
    S = interior(params, U)
    if params.compensated:
        S = torch.cat([S, torch.zeros_like(S)])
    return S.contiguous()


def unpack(params: RunParams, S) -> torch.Tensor:
    """The loop state -> the ghosted state (the periodic fill); the carry
    is dropped."""
    return make_boundaries_concat(params, S[:8], interior_only=True)


def bind_step(params: RunParams, S):
    """``step(S, dt, active, t) -> (S', inv)`` (kernels/loop.py) with the
    buffers for S's shape: the staged step on S in place (dissipative: then
    the dissipation kernel from S into the other buffer, the two taking
    turns); or, with kernel=zcarry, the streamed step into the other buffer
    and the folded inverse dt (dissipative: the dissipation kernel from
    that buffer back into S, and no folded reduction)."""
    dissip = uses_dissipation(params)
    if params.kernel == "zcarry":
        if not dissip:
            return streamed_step(S, lambda S, out, dt, active, t: zcarry_mhd(
                params, S, out, dt, active, fold=True))
        other = torch.empty_like(S)

        def step(S, dt, active, t):
            zcarry_mhd(params, S, other, dt, active, fold=False)
            dissip_step(params, other, S, dt, active)
            return S, None

        return step
    scratch = mhd_step.scratch(params, S)
    if not dissip:
        def step(S, dt, active, t):
            mhd_step(params, S, dt, active, scratch)
            return S, None

        return step

    def step_into(S, out, dt, active, t):
        mhd_step(params, S, dt, active, scratch)
        dissip_step(params, S, out, dt, active)

    return streamed_step(S, step_into)


def make_ghosted_step_fn(params: RunParams, device) -> Callable:
    """``step(U, t) -> (U_new, dt)`` of a walled or jet run on the ghosted
    state: the JAX whole-array step (solvers/step.py:208-243 there):
    compute_dt on U as it stands, the fill, the ghosted step; U_new's
    ghosts are that fill's but for the CT face layer. U is not changed."""
    require_step_scope(params)
    scratch = None  # the stage buffer, allocated once

    def step(U, t):
        nonlocal scratch
        U = U.clone(memory_format=torch.contiguous_format)
        if scratch is None:
            scratch = mhd_step.scratch(params, U, ghosted=True)
        dt = dt_from_inv(params, cfl_mhd(params, U, ghost=params.ghost_width))
        mhd_step.ghosted(params, fill_ghosts_(params, U), dt,
                         torch.ones((), dtype=torch.bool, device=U.device), scratch)
        return U, dt

    return step


def make_fused_mhd_update(params: RunParams, device) -> Callable:
    """``update(U_ghosted, dt) -> U_interior_new``: TPU row 3
    (pallas/fused_mhd3d.py:80) with its outside contract, for any face
    types: one MHD+CT step of a ghosted state whose ghosts a fill has
    written, and the new interior [8, nz, ny, nx]. ``dt``: a number or a
    0-d tensor. On a CUDA state it launches the step kernel's ghosted
    mode on a copy of U; on a CPU state the twin runs."""
    require_step_scope(params)
    if uses_shear(params):
        raise NotImplementedError("row 3 does not cover the rotating frame")
    device = torch.device(device)
    scratch = None  # the stage buffer, allocated once

    def update(U, dt):
        nonlocal scratch
        if U.device.type != device.type:
            raise ValueError(f"state on {U.device}, update built for {device}")
        W = U.clone(memory_format=torch.contiguous_format)
        if scratch is None:
            scratch = mhd_step.scratch(params, W, ghosted=True)
        dt = torch.as_tensor(dt, dtype=W.dtype, device=W.device)
        mhd_step.ghosted(params, W, dt, torch.ones((), dtype=torch.bool, device=W.device),
                         scratch)
        return interior(params, W).contiguous()

    return update


def make_fused_mhd_shear(params: RunParams, device, gravity_z: Callable | None = None
                         ) -> Callable:
    """``update(U_ghosted, dt, x0=None, z0=None) -> (new_int, fpl, eypl,
    ezpl)``: TPU row 4 (pallas/fused_mhd3d.py:587 make_fused_mhd_shear)
    with its outside contract. One rotating-frame MHD+CT step of a ghosted
    window [8, nz+2g, ny+2g, nx+2g] (``params``: the window's extent) whose
    ghosts an exchange has written; x0, z0 are the window's global offsets
    (default xmin, zmin). Returns the new interior [8, nz, ny, nx], the
    density flux at the two x faces fpl [2, nz, ny], emfY there eypl
    [2, nz, ny] and emfZ at the xmax face ezpl [nz, ny], all before the
    remap. ``gravity_z``: the analytic profile g_z(z) of the stratified
    MRI (solvers/step.py mri_gz_profile), evaluated on the window's row
    centres z0 + dz/2 + (r - g) dz as the JAX ``update`` does (:733-745).
    ``dt``: a number or a 0-d tensor. On a CUDA window it launches the
    step kernel's shear window mode (kernels/mhd_step.py mhd_window); on a
    CPU window the twin runs."""
    require_window_scope(params)
    device = torch.device(device)
    g = params.ghost_width
    scratch = None  # the stage buffer, allocated once

    def update(U, dt, x0=None, z0=None):
        nonlocal scratch
        if U.device.type != device.type:
            raise ValueError(f"window on {U.device}, update built for {device}")
        x0 = params.xmin if x0 is None else float(x0)
        z0 = params.zmin if z0 is None else float(z0)
        if scratch is None:
            scratch = mhd_window.scratch(params, U)
        dt = torch.as_tensor(dt, dtype=U.dtype, device=U.device)
        gz = None
        if gravity_z is not None:
            rows = torch.arange(U.shape[1], dtype=U.dtype, device=U.device)
            zc = torch.tensor(z0, dtype=U.dtype, device=U.device) + params.dz / 2 + (
                rows - g) * params.dz
            gz = gravity_z(zc).contiguous()
        new_int, planes = mhd_window(params, U, dt, x0, gz, scratch)
        return new_int, planes[0:2], planes[2:4], planes[4]

    return update
