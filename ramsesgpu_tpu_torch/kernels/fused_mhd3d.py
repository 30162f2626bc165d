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
packed-io launch, pallas/fused_mhd3d.py:457-463).
"""
from __future__ import annotations

from ..config.params import RunParams
from ..solvers.boundary import interior, make_boundaries_concat
from ..solvers.dissipation import uses_dissipation
from .cfl_mhd import cfl_mhd
from .dissip_step import dissip_step
from .loop import make_kernel_loop
from .mhd_step import mhd_step, require_step_scope


def packed_supported(params: RunParams) -> bool:
    """Whether the kernel loop covers this configuration."""
    try:
        require_step_scope(params)
    except NotImplementedError:
        return False
    return params.problem not in ("jet", "Jet")


def make_advance_n(params: RunParams, device, packed_form: bool = False):
    """The MHD chunk loop; see kernels/loop.py make_kernel_loop."""
    require_step_scope(params)

    return make_kernel_loop(
        params, device, lambda S: cfl_mhd(params, S), lambda S: bind_periodic_step(params, S),
        pack=lambda U: interior(params, U).contiguous(),
        unpack=lambda S, t: make_boundaries_concat(params, S, interior_only=True),
        packed_form=packed_form,
    )


def bind_periodic_step(params: RunParams, S):
    """``step(S, dt, active, t)``: the periodic step on S in place with the
    stage buffer for S's shape; the dissipation kernel reuses the step
    kernel's buffer, idle by then on the same stream."""
    scratch = mhd_step.scratch(params, S)

    def step(S, dt, active, t):
        mhd_step(params, S, dt, active, scratch)
        if uses_dissipation(params):
            dissip_step(params, S, dt, active, scratch)

    return step
