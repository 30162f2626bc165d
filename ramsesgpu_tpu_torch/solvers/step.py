"""Step and chunk-advance builders (the port's counterpart of
ramsesgpu_tpu/solvers/step.py:107-452), for the ported slices: fully
periodic 3D MHD with HLLD fluxes and 2D-HLLD EMFs; the shearing box (MRI:
rotating frame, sheared-periodic x faces, isothermal or adiabatic, same
solvers); both with or without viscosity and resistivity (nu, eta) and
with or without the Kahan-compensated state ([implementation]
compensated); the stratified MRI (BC_Z_STRATIFIED z faces and its static
vertical gravity, ideal); ideal 3D MHD with any mix of DIRICHLET /
NEUMANN / PERIODIC faces and the inflow jet (the ghosted route,
kernels/fused_mhd3d.py); and 3D hydro (approx / HLL / HLLC, inviscid)
with any mix of DIRICHLET / NEUMANN / PERIODIC faces and the jet.

    step(U, t)          -> (U', dt)       one step on the ghosted state
    advance_n(U, t, n)  -> (U', t', k)    up to n steps, stopping at t_end
    make_packed_advance_chain -> (pack, advance_packed, unpack(S, t))

Each of them runs the kernel path (kernels/fused_mhd3d.py,
kernels/shear.py, kernels/fused_hydro3d.py): on a CUDA device its
wrappers launch the hand-written kernels, on a CPU tensor they run their
plain twins. ``[implementation] kernel`` = ``auto`` or ``pallas`` is
accepted everywhere; ``jnp`` only on the CPU (the twins must not stand in
for the kernels on CUDA). ``zcarry`` selects the z-streaming step kernels
(kernels/zcarry_mhd3d.py, kernels/zcarry_hydro3d.py: one launch per step,
no stage buffer) on the periodic and shearing-box MHD paths (plain,
compensated, dissipative, stratified) and the folded-CFL step on fully
periodic hydro; hydro with walls keeps the step kernel's wall rules under
it, MHD with walls or the jet and the hydro jet the ghosted kernels, which
compute the
same function, as the JAX package falls back to its whole-array step
there, and the ghosted one-step hydro ``make_step_fn`` keeps the ghosted
kernel for every choice. Of the JAX package's refusals of zcarry
("configuration outside the zcarry kernel") only its TPU tile conditions
are left on the ported paths, and the port's kernels take any nx, ny, nz.
``[implementation] zSlabNb`` has no effect on this path, as in the JAX
package. Of the
problems with a static gravity field (problems.has_gravity_field) only the
stratified MRI is ported: its g_z column (problems.gravity_field, the
field the JAX whole-array path uses, in the state's dtype) goes to the
shear loop; the builders take the run's ConfigMap to decide that, as the
JAX ones do.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..config.configmap import ConfigMap
from ..config.params import RunParams
from ..kernels import fused_hydro3d, fused_mhd3d, shear
from ..kernels.cfl_mhd import cfl_mhd
from ..kernels.hydro_step import require_hydro_scope
from ..kernels.mhd_step import require_step_scope, uses_ghosted, uses_shear
from ..problems import gravity_field, has_gravity_field
from .stratified import uses_stratified_z
from .timestep import dt_from_inv


def require_slice(params: RunParams, device, config: ConfigMap | None = None) -> None:
    """Raise for configurations outside the port and for kernel choices
    it refuses on ``device``. ``config`` (the run's INI) decides whether
    the problem carries a static gravity field; without it the INI
    defaults do."""
    if params.mhd:
        require_step_scope(params)
    else:
        require_hydro_scope(params)
    gravity = has_gravity_field(params, config if config is not None else ConfigMap(text=""))
    strat = params.mhd and uses_shear(params) and uses_stratified_z(params)
    if gravity and not strat:
        raise NotImplementedError(
            f"problem {params.problem!r} with a static gravity field is not ported "
            f"(only the stratified MRI's, with BC_Z_STRATIFIED z faces)")
    if strat and not gravity:
        raise NotImplementedError(
            "BC_Z_STRATIFIED z faces without the stratified MRI's gravity field are not ported")
    device = torch.device(device)
    kernel = params.kernel
    if kernel not in ("auto", "pallas", "jnp", "zcarry"):
        raise ValueError(f"unknown [implementation] kernel={kernel!r}")
    if device.type == "cuda" and kernel == "jnp":
        raise ValueError(
            "kernel=jnp would run the whole-array PyTorch step on the GPU; "
            "use kernel=auto or pallas there"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")


def gravity_z(params: RunParams, config: ConfigMap | None, device) -> torch.Tensor | None:
    """g_z of each z row [nz + 2g] of a stratified run on ``device`` (the
    JAX package's ``mri_gravity_field`` column, step.py:53-97), else None."""
    if not (params.mhd and uses_stratified_z(params)):
        return None
    field = gravity_field(params, config if config is not None else ConfigMap(text=""))
    return torch.from_numpy(np.ascontiguousarray(field[2, :, 0, 0])).to(device)


def mri_gz_profile(params: RunParams, config: ConfigMap | None) -> Callable:
    """The stratified MRI's vertical gravity as a function g_z(z) of a
    tensor of cell-centre z (JAX solvers/step.py:53 ``_mri_gz_profile``,
    the formula of problems/mhd_inits.py mri_gravity_field): -omega0^2 z,
    with the smooth cutoff near the vertical boundaries when
    ``[MRI] smoothGravity``. Evaluated in z's dtype."""
    config = config if config is not None else ConfigMap(text="")
    smooth = config.get_bool("MRI", "smoothGravity", False)
    z_floor = config.get_float("MRI", "zFloor", 5.0)
    om2 = params.omega0 ** 2
    H = params.c_iso / params.omega0 if params.omega0 > 0 else 1.0

    def profile(zc: torch.Tensor) -> torch.Tensor:
        gz = -om2 * zc
        if smooth:
            gz = gz * torch.exp(-((torch.abs(zc) / (z_floor * H)) ** 8))
        return gz

    return profile


def make_step_fn(params: RunParams, device, config: ConfigMap | None = None) -> Callable:
    """``step(U, t) -> (U_new, dt)`` on the ghosted state (a compensated
    run packs a zero carry on each call)."""
    require_slice(params, device, config)
    if not params.mhd:
        return fused_hydro3d.make_step_fn(params, device)
    if uses_shear(params):
        return shear.make_step_fn(params, device, gravity_z(params, config, device))
    if uses_ghosted(params):
        return fused_mhd3d.make_ghosted_step_fn(params, device)
    step_S = None  # bound to the buffers of the first state

    def step(U, t):
        nonlocal step_S
        S = fused_mhd3d.pack(params, U)
        if step_S is None:
            step_S = fused_mhd3d.bind_step(params, S)
        dt = dt_from_inv(params, cfl_mhd(params, S))
        active = torch.ones((), dtype=torch.bool, device=S.device)
        S, _ = step_S(S, dt, active, t)
        return fused_mhd3d.unpack(params, S), dt

    return step


def _loop(params: RunParams, device, config: ConfigMap | None, packed_form: bool):
    if not params.mhd:
        return fused_hydro3d.make_advance_n(params, device, packed_form=packed_form)
    if uses_shear(params):
        return shear.make_advance_n(params, device, packed_form=packed_form,
                                    gz=gravity_z(params, config, device))
    return fused_mhd3d.make_advance_n(params, device, packed_form=packed_form)


def make_advance_n(params: RunParams, device, config: ConfigMap | None = None) -> Callable:
    """``advance_n(U, t, n) -> (U', t', k)``: up to n steps on the ghosted
    state, stopping once t >= t_end, with t and k device tensors."""
    require_slice(params, device, config)
    return _loop(params, device, config, packed_form=False)


def make_packed_advance_chain(params: RunParams, device, config: ConfigMap | None = None):
    """``(pack, advance_packed, unpack(S, t))`` carrying the port's loop
    state across chunks (a tensor, or the pair (S, kept) of a shearing
    box; with their Kahan carries when compensated). ``advance_packed``
    updates it in place; ``unpack`` takes the current time (the sheared
    fill needs it)."""
    require_slice(params, device, config)
    return _loop(params, device, config, packed_form=True)
