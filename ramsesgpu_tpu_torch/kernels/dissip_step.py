"""The viscous and resistive sub-step of 3D MHD: the CUDA kernel
``csrc/dissip_step.cu`` and its plain PyTorch twins, in two modes.

- Periodic: replaces the TPU kernels ramsesgpu_tpu/pallas/fused_dissip3d.py:51
  ``make_fused_mhd_dissipation`` and the dissipative second launch of
  the packed-io loop (pallas/fused_mhd3d.py:351-373). Twin:
  ``solvers.dissipation.mhd_dissipation_periodic_update``.
- Shearing box: replaces the MRI loop's dissipative sub-step
  (pallas/shear_packed.py:917) with the border strip's mode "dissip". It
  reads the sheared x ghost slabs at t + dt, built from the post-Godunov
  state, and updates the kept Bx face by the resistive CT. Twins:
  ``solvers.dissipation.mhd_dissipation_shear_update`` and
  ``kept_face_resistive_ct``.

Compensated (``[implementation] compensated``): the state is [16, nz, ny,
nx] (the state, then its Kahan carry) and a shearing box's kept face [2,
nz, ny]; each channel's whole increment (B's the resistive CT delta) is
Kahan-added (the compensated form of dissipation.py:357-380).

The kernel updates the interior-only state [8, nz, ny, nx] in place. Its
stage intermediates (25 values per stage-grid cell; the shearing box's
stage grid has nx + 4 columns) need less room than the step kernel's, so
the loops hand it the step kernel's buffer, idle by then on the same
stream; ``DissipStepKernel.scratch`` allocates one of its own.
"""
from __future__ import annotations

import torch

from ..config.params import RunParams
from ..core.constants import IA
from ..solvers.dissipation import (kept_face_resistive_ct, mhd_dissipation_periodic_update,
                                   mhd_dissipation_shear_update)
from .build import load_library, param_block
from .cfl_mhd import check_plane, check_state, kept_lead
from .mhd_step import SLAB, check_buffer, require_step_scope, uses_shear

_FN = {torch.float32: "ramses_dissip_step_f32", torch.float64: "ramses_dissip_step_f64"}


class DissipStepKernel:
    """``kernel(params, S, dt, active, scratch, shear=None)`` takes the
    dissipative sub-step of S in place when the 0-d bool ``active`` is
    true, and returns S. ``dt`` is a 0-d tensor of S's dtype on S's device.
    A shearing-box state passes ``shear=(slabs, kept)``: the sheared ghost
    slabs [2, 8, nz, ny, 3] it reads, whose XMAX slab's first Bx column
    holds the kept face, and the kept face [nz, ny] ([2, nz, ny] with its
    carry when compensated) it writes when eta > 0. On a CPU tensor the
    twin runs; on a CUDA tensor the kernel launches."""

    def __init__(self) -> None:
        self.launches = 0

    @staticmethod
    def scratch(params: RunParams, S: torch.Tensor) -> torch.Tensor | None:
        """A stage buffer for S's shape and device (None on the CPU)."""
        if S.device.type == "cpu":
            return None
        size = DissipStepKernel.scratch_size(load_library("cuda"), params)
        return torch.empty(size, dtype=S.dtype, device=S.device)

    @staticmethod
    def scratch_size(lib, params: RunParams) -> int:
        return lib.ramses_dissip_step_scratch(params.nx, params.ny, params.nz,
                                              int(uses_shear(params)))

    def __call__(self, params, S, dt, active, scratch=None, shear=None) -> torch.Tensor:
        require_step_scope(params)
        if not (params.nu > 0 or params.eta > 0):
            raise ValueError("the dissipation kernel needs nu > 0 or eta > 0")
        check_state(params, S)
        for name, x, dtype in (("dt", dt, S.dtype), ("active", active, torch.bool)):
            if x.shape != () or x.dtype != dtype or x.device != S.device:
                raise ValueError(
                    f"{name} must be a 0-d {dtype} tensor on {S.device}, "
                    f"got {tuple(x.shape)} {x.dtype} on {x.device}"
                )
        if (shear is not None) != uses_shear(params):
            raise ValueError("shear=(slabs, kept) is given exactly for a shearing-box state")
        if shear is not None:
            slabs, kept = shear
            check_buffer(S, "slabs", slabs, (2, 8, params.nz, params.ny, SLAB))
            check_plane(params, S, "kept", kept, kept_lead(params))
        if S.device.type == "cpu":
            if shear is None:
                S.copy_(torch.where(active, mhd_dissipation_periodic_update(params, S, dt), S))
            else:
                S_new, eypl, ezpl = mhd_dissipation_shear_update(params, S, slabs, dt)
                S.copy_(torch.where(active, S_new, S))
                if params.eta > 0:
                    # the face's old value: the XMAX slab's first Bx column
                    face = slabs[1, IA, ..., 0]
                    old = torch.stack([face, kept[1]]) if params.compensated else face
                    kept_new = kept_face_resistive_ct(params, old, eypl, ezpl, dt)
                    kept.copy_(torch.where(active, kept_new, kept))
            return S
        if S.device.type != "cuda":
            raise ValueError(f"unsupported device {S.device}")
        lib = load_library("cuda")
        need = self.scratch_size(lib, params)
        if (scratch is None or scratch.device != S.device or scratch.dtype != S.dtype
                or scratch.numel() < need or not scratch.is_contiguous()):
            raise ValueError(f"scratch must be a contiguous {S.dtype} buffer of "
                             f">= {need} values on {S.device} (DissipStepKernel.scratch)")
        slab_ptr, kept_ptr = (None, None) if shear is None else (slabs.data_ptr(),
                                                                  kept.data_ptr())
        err = getattr(lib, _FN[S.dtype])(
            S.data_ptr(), scratch.data_ptr(), slab_ptr, kept_ptr, dt.data_ptr(),
            active.data_ptr(), int(params.compensated), params.nx, params.ny, params.nz,
            param_block(params), torch.cuda.current_stream(S.device).cuda_stream)
        if err:
            raise RuntimeError(f"dissip_step launch failed: CUDA error {err}")
        self.launches += 1
        return S


dissip_step = DissipStepKernel()
