"""Step and chunk-advance builders (the port's counterpart of
ramsesgpu_tpu/solvers/step.py:107-452), for the ported slices: fully
periodic 3D MHD with HLLD fluxes and 2D-HLLD EMFs; the shearing box (MRI:
rotating frame, sheared-periodic x faces, isothermal or adiabatic, same
solvers); both with or without viscosity and resistivity (nu, eta); and 3D
hydro (approx / HLL / HLLC, inviscid) with any mix of DIRICHLET / NEUMANN /
PERIODIC faces.

    step(U, t)          -> (U', dt)       one step on the ghosted state
    advance_n(U, t, n)  -> (U', t', k)    up to n steps, stopping at t_end
    make_packed_advance_chain -> (pack, advance_packed, unpack(S, t))

Each of them runs the kernel path (kernels/fused_mhd3d.py,
kernels/shear.py, kernels/fused_hydro3d.py): on a CUDA device its
wrappers launch the hand-written kernels, on a CPU tensor they run their
plain twins. ``[implementation] kernel`` = ``auto`` or ``pallas`` is
accepted everywhere; ``jnp`` only on the CPU (the twins must not stand in
for the kernels on CUDA); ``zcarry`` is not ported. ``[implementation]
zSlabNb`` has no effect on this path, as in the JAX package. A problem
with a static gravity field (problems.has_gravity_field: Keplerian-disk,
stratified MRI) is not ported; the builders take the run's ConfigMap to
decide that, as the JAX ones do.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..config.configmap import ConfigMap
from ..config.params import RunParams
from ..kernels import fused_hydro3d, fused_mhd3d, shear
from ..kernels.cfl_mhd import cfl_mhd
from ..kernels.hydro_step import require_hydro_scope
from ..kernels.mhd_step import require_step_scope, uses_shear
from ..problems import has_gravity_field
from .boundary import interior, make_boundaries_concat
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
    if params.problem in ("jet", "Jet"):
        raise NotImplementedError(f"problem {params.problem!r} is not ported")
    if has_gravity_field(params, config if config is not None else ConfigMap(text="")):
        raise NotImplementedError(
            f"problem {params.problem!r} with a static gravity field is not ported")
    device = torch.device(device)
    kernel = params.kernel
    if kernel == "zcarry":
        raise NotImplementedError("[implementation] kernel=zcarry is not ported")
    if kernel not in ("auto", "pallas", "jnp"):
        raise ValueError(f"unknown [implementation] kernel={kernel!r}")
    if device.type == "cuda" and kernel == "jnp":
        raise ValueError(
            "kernel=jnp would run the whole-array PyTorch step on the GPU; "
            "use kernel=auto or pallas there"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")


def make_step_fn(params: RunParams, device, config: ConfigMap | None = None) -> Callable:
    """``step(U, t) -> (U_new, dt)`` on the ghosted state."""
    require_slice(params, device, config)
    if not params.mhd:
        return fused_hydro3d.make_step_fn(params, device)
    if uses_shear(params):
        return shear.make_step_fn(params, device)
    step_S = None  # bound to the stage buffer of the first state

    def step(U, t):
        nonlocal step_S
        S = interior(params, U).contiguous()
        if step_S is None:
            step_S = fused_mhd3d.bind_periodic_step(params, S)
        dt = dt_from_inv(params, cfl_mhd(params, S))
        active = torch.ones((), dtype=torch.bool, device=S.device)
        step_S(S, dt, active, t)
        return make_boundaries_concat(params, S, interior_only=True), dt

    return step


def _loop_module(params: RunParams):
    if not params.mhd:
        return fused_hydro3d
    return shear if uses_shear(params) else fused_mhd3d


def make_advance_n(params: RunParams, device, config: ConfigMap | None = None) -> Callable:
    """``advance_n(U, t, n) -> (U', t', k)``: up to n steps on the ghosted
    state, stopping once t >= t_end, with t and k device tensors."""
    require_slice(params, device, config)
    return _loop_module(params).make_advance_n(params, device)


def make_packed_advance_chain(params: RunParams, device, config: ConfigMap | None = None):
    """``(pack, advance_packed, unpack(S, t))`` carrying the port's loop
    state across chunks (a tensor, or the pair (S, kept) of a shearing
    box). ``advance_packed`` updates it in place; ``unpack`` takes the
    current time (the sheared fill needs it)."""
    require_slice(params, device, config)
    return _loop_module(params).make_advance_n(params, device, packed_form=True)
