"""The periodic 3D MHD advance loop on the CUDA kernels (the port's
counterpart of ramsesgpu_tpu/pallas/fused_mhd3d.py:274-488
``pallas_packed_supported`` / ``make_pallas_advance_n``).

Loop state: the interior-only periodic state S [8, nz, ny, nx]; the
kernels find periodic neighbours by index wrap, so pack is a slice of the
ghosted state and unpack the periodic ghost fill. Each step launches the
CFL kernel (kernels/cfl_mhd.py) and the step kernel (kernels/mhd_step.py)
through the shared chunk loop (kernels/loop.py).
"""
from __future__ import annotations

from ..config.params import RunParams
from ..solvers.boundary import interior, make_boundaries_concat
from .cfl_mhd import cfl_mhd
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

    def bind_step(S):
        scratch = mhd_step.scratch(params, S)
        return lambda S, dt, active, t: mhd_step(params, S, dt, active, scratch)

    return make_kernel_loop(
        params, device, lambda S: cfl_mhd(params, S), bind_step,
        pack=lambda U: interior(params, U).contiguous(),
        unpack=lambda S, t: make_boundaries_concat(params, S, interior_only=True),
        packed_form=packed_form,
    )
