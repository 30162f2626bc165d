"""Step and chunk-advance builders (the port's counterpart of
ramsesgpu_tpu/solvers/step.py:107-452), for the ported slices: fully
periodic 3D MHD with any of the JAX package's MHD solver pairs (HLLD, LLF
or HLL fluxes; 2D-HLLD, HLLA, HLLF or LLF EMFs), on every MHD path below;
the shearing box (MRI: rotating frame, sheared-periodic x faces,
isothermal or adiabatic); both with or without viscosity and resistivity
(nu, eta) and with or without the Kahan-compensated state
([implementation] compensated); the stratified MRI (BC_Z_STRATIFIED z
faces and its static vertical gravity, isothermal, with or without nu and
eta); ideal 3D MHD with any mix of DIRICHLET /
NEUMANN / PERIODIC faces and the inflow jet (the ghosted route,
kernels/fused_mhd3d.py); 3D hydro (approx / HLL / HLLC, inviscid)
with any mix of DIRICHLET / NEUMANN / PERIODIC faces and the jet; and 2D
hydro and ideal 2D MHD+CT with those faces and the jet (solvers/step2d.py).

2D has no TPU kernel in the reference: every Pallas kernel of the JAX
package is gated on dim == 3, and it runs 2D as its whole-array step
(step.py:207-228, 258-280 there). The port's 2D path is that step in whole-array PyTorch on
the run's device, under every ``[implementation] kernel`` value and on
both devices, as the JAX package takes it; it is therefore not a fallback
from a kernel.

    step(U, t)          -> (U', dt)       one step on the ghosted state
    advance_n(U, t, n)  -> (U', t', k)    up to n steps, stopping at t_end
    make_packed_advance_chain -> (pack, advance_packed, unpack(S, t))
    make_forced_advance_n, make_forced_chain -> (the above, forcing)

The turbulence problems (static-spectrum and Ornstein-Uhlenbeck forcing)
run the forced loops, the counterpart of the JAX make_forced_step_fn /
make_forced_advance_n (solvers/step.py:466-528 there): the same kernel
loop with the forcing as its post-step hook (ops/forcing.py; a CFL launch
every step, on the forced state). The forcing state stays on the device
in the returned forcing object across chunks. As the JAX forced step,
which has no compensated branch, a forced run with ``compensated=yes``
runs the plain state.

Each of them runs the kernel path (kernels/fused_mhd3d.py,
kernels/shear.py, kernels/fused_hydro3d.py): on a CUDA device its
wrappers launch the hand-written kernels, on a CPU tensor they run their
plain twins. ``[implementation] kernel`` = ``auto`` or ``pallas`` is
accepted everywhere; in 3D ``jnp`` only on the CPU (the twins must not
stand in for the kernels on CUDA). ``zcarry`` selects the z-streaming step
kernels (kernels/zcarry_mhd3d.py, kernels/zcarry_hydro3d.py: one launch per step,
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
package.

Static gravity (``make_gravity_field``, the JAX package's): in 2D the
field, uniform or the Keplerian disk's, goes to the whole-array step
(solvers/step2d.py); in 3D a uniform [gravity] static_field_* is one
constant vector (``config.params.static_gravity``), which the step kernels
take as three scalars of the launch: the hydro step's interior and ghosted modes
(kernels/hydro_step.py) and the MHD step's ghosted mode, which every MHD
run with gravity outside a shearing box takes (kernels/mhd_step.py
uses_ghosted). The stratified MRI's g_z column (problems.gravity_field,
in the state's dtype) goes to the shear loop. A non-uniform field in 3D
other than the stratified MRI's is refused. The builders take the run's
ConfigMap to decide that, as the JAX ones do.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..config.configmap import ConfigMap
from ..config.params import RunParams, static_gravity
from ..convert import torch_dtype
from ..kernels import fused_hydro3d, fused_mhd3d, shear
from ..kernels.cfl_mhd import cfl_mhd
from ..kernels.hydro_step import require_hydro_scope
from ..kernels.mhd_step import require_step_scope, uses_ghosted, uses_shear
from ..ops.forcing import FORCED_PROBLEMS, make_forcing
from ..problems import gravity_field, has_gravity_field
from . import step2d
from .stratified import uses_stratified_z
from .timestep import dt_from_inv


def require_slice(params: RunParams, device, config: ConfigMap | None = None) -> None:
    """Raise for configurations outside the port and for kernel choices
    it refuses on ``device``. ``config`` (the run's INI) decides whether
    the problem carries a static gravity field; without it the INI
    defaults do."""
    if params.dim == 2:
        step2d.require_2d_scope(params)
    elif params.mhd:
        require_step_scope(params)
    else:
        require_hydro_scope(params)
    gravity = has_gravity_field(params, config if config is not None else ConfigMap(text=""))
    strat = params.mhd and uses_shear(params) and uses_stratified_z(params)
    if gravity and not strat and params.dim == 3:
        raise NotImplementedError(
            f"problem {params.problem!r} with a non-uniform static gravity field in 3D is not "
            f"ported (only the stratified MRI's, with BC_Z_STRATIFIED z faces; a uniform "
            f"[gravity] static_field_* runs)")
    if strat and not gravity:
        raise NotImplementedError(
            "BC_Z_STRATIFIED z faces without the stratified MRI's gravity field are not ported")
    device = torch.device(device)
    kernel = params.kernel
    if kernel not in ("auto", "pallas", "jnp", "zcarry"):
        raise ValueError(f"unknown [implementation] kernel={kernel!r}")
    if device.type == "cuda" and kernel == "jnp" and params.dim == 3:
        raise ValueError(
            "kernel=jnp would run the whole-array PyTorch step on the GPU; "
            "use kernel=auto or pallas there"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")


def make_gravity_field(params: RunParams, config: ConfigMap | None = None,
                       device="cpu") -> torch.Tensor | None:
    """The static gravity field [dim, *ghosted shape] in the state's dtype
    on ``device`` (JAX solvers/step.py:31-50 make_gravity_field): the
    problem's own (problems.gravity_field: the Keplerian disk, the
    stratified MRI) first; else the uniform [gravity] static_field_*; None
    when all three components are 0."""
    field = gravity_field(params, config if config is not None else ConfigMap(text=""))
    if field is None:
        gvec = static_gravity(params)
        if gvec is None:
            return None
        dtype = np.float64 if params.dtype == "float64" else np.float32
        field = np.stack([np.full(params.shape[1:], g, dtype=dtype) for g in gvec[:params.dim]])
    return torch.from_numpy(np.ascontiguousarray(field)).to(device)


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
    if params.dim == 2:
        return step2d.make_step_fn(params, make_gravity_field(params, config, device))
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


def _loop(params: RunParams, device, config: ConfigMap | None, packed_form: bool,
          post_step: Callable | None = None):
    if params.dim == 2:
        if post_step is not None:
            raise NotImplementedError("forcing in 2D")
        return step2d.make_advance_n(params, device, packed_form=packed_form,
                                     gravity=make_gravity_field(params, config, device))
    if not params.mhd:
        return fused_hydro3d.make_advance_n(params, device, packed_form=packed_form,
                                            post_step=post_step)
    if uses_shear(params):
        if post_step is not None:
            raise NotImplementedError("forcing in a shearing box")
        return shear.make_advance_n(params, device, packed_form=packed_form,
                                    gz=gravity_z(params, config, device))
    return fused_mhd3d.make_advance_n(params, device, packed_form=packed_form,
                                      post_step=post_step)


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


def is_forced(params: RunParams) -> bool:
    """Whether the problem drives turbulence (the JAX Run's ``_forced``)."""
    return params.problem in FORCED_PROBLEMS


def _forced(params: RunParams, device, config: ConfigMap, packed_form: bool):
    if not is_forced(params):
        raise ValueError(f"problem {params.problem!r} has no forcing")
    params = params.replace(compensated=False)
    require_slice(params, device, config)
    forcing = make_forcing(params, config, device, torch_dtype(params))
    return _loop(params, device, config, packed_form, post_step=forcing), forcing


def make_forced_advance_n(params: RunParams, device, config: ConfigMap):
    """``(advance_n, forcing)``: advance_n(U, t, n) -> (U', t', k) as
    make_advance_n's, each step followed by the forcing kick; ``forcing``
    (ops/forcing.py StaticForcing or OUForcing) carries the forcing state
    across calls (``forcing.state``: the OU modes, None for the static
    field)."""
    return _forced(params, device, config, packed_form=False)


def make_forced_chain(params: RunParams, device, config: ConfigMap):
    """``((pack, advance_packed, unpack(S, t)), forcing)``: the forced loop
    in make_packed_advance_chain's form."""
    return _forced(params, device, config, packed_form=True)
