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

The kernel reads the interior-only state S [8, nz, ny, nx] and writes the
new state into another buffer S_out of S's shape, every channel: one
launch, whose intermediates stay in shared memory (a block reads the old
values of its neighbours' cells, so it cannot update S in place). The
loops hand it the step's other state buffer.
"""
from __future__ import annotations

import ctypes

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
    """``kernel(params, S, S_out, dt, active, shear=None)`` writes the
    dissipative sub-step of S into S_out (another tensor of S's shape) when
    the 0-d bool ``active`` is true, else S itself, and returns S_out. ``dt``
    is a 0-d tensor of S's dtype on S's device. A shearing-box state passes
    ``shear=(slabs, kept)``: the sheared ghost slabs [2, 8, nz, ny, 3] it
    reads, whose XMAX slab's first Bx column holds the kept face, and the
    kept face [nz, ny] ([2, nz, ny] with its carry when compensated) it
    updates in place when eta > 0. On a CPU tensor the twin runs; on a CUDA
    tensor the kernel launches."""

    def __init__(self) -> None:
        self.launches = 0

    def __call__(self, params, S, S_out, dt, active, shear=None) -> torch.Tensor:
        require_step_scope(params)
        if not (params.nu > 0 or params.eta > 0):
            raise ValueError("the dissipation kernel needs nu > 0 or eta > 0")
        check_state(params, S)
        check_state(params, S_out)
        if S_out.dtype != S.dtype or S_out.device != S.device:
            raise ValueError(f"S_out must be a {S.dtype} tensor on {S.device}")
        if S_out.data_ptr() == S.data_ptr():
            raise ValueError("S_out must be another buffer than S")
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
                S_out.copy_(torch.where(active, mhd_dissipation_periodic_update(params, S, dt), S))
            else:
                S_new, eypl, ezpl = mhd_dissipation_shear_update(params, S, slabs, dt)
                S_out.copy_(torch.where(active, S_new, S))
                if params.eta > 0:
                    # the face's old value: the XMAX slab's first Bx column
                    face = slabs[1, IA, ..., 0]
                    old = torch.stack([face, kept[1]]) if params.compensated else face
                    kept_new = kept_face_resistive_ct(params, old, eypl, ezpl, dt)
                    kept.copy_(torch.where(active, kept_new, kept))
            return S_out
        if S.device.type != "cuda":
            raise ValueError(f"unsupported device {S.device}")
        lib = load_library("cuda")
        slab_ptr, kept_ptr = (None, None) if shear is None else (slabs.data_ptr(),
                                                                  kept.data_ptr())
        err = getattr(lib, _FN[S.dtype])(
            S.data_ptr(), S_out.data_ptr(), slab_ptr, kept_ptr, dt.data_ptr(),
            active.data_ptr(), int(params.compensated), params.nx, params.ny, params.nz,
            param_block(params), torch.cuda.current_stream(S.device).cuda_stream)
        if err:
            raise RuntimeError(f"dissip_step launch failed: CUDA error {err}")
        self.launches += 1
        return S_out


def launch_info(lib, params: RunParams, dtype: torch.dtype) -> dict:
    """The kernel's launch for a run's mode: its tile's x and y extent, the
    threads and ring bytes of a block, the registers of a thread and the
    blocks an SM holds (the last two 0 in the host build)."""
    out = (ctypes.c_longlong * 6)()
    err = lib.ramses_dissip_step_launch(int(dtype == torch.float64), int(uses_shear(params)),
                                        int(params.c_iso > 0), int(params.compensated), out)
    if err:
        raise RuntimeError(f"dissip_step launch query failed: CUDA error {err}")
    return dict(zip(("tx", "ty", "threads", "ring_bytes", "registers", "blocks_per_sm"), out))


dissip_step = DissipStepKernel()
