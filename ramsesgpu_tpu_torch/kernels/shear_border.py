"""The shearing box's x borders: the CUDA kernels of ``csrc/shear_border.cu``
and their plain PyTorch twins.

- ``shear_slabs``: the sheared x ghost slabs at t + dt from the loop state
  (S, kept); twin ``solvers.shear.shear_slabs``.
- ``shear_border``: the conservative remap of the step kernel's x-face
  planes at t + dt/2, the border-column corrections, the density floor
  and the CT update of the kept Bx face; twin
  ``solvers.godunov_mhd.shear_border_update``.

With the step kernel's shearing-box mode (kernels/mhd_step.py) they
replace the TPU border strip kernel ramsesgpu_tpu/pallas/shear_packed.py:237
``_make_strip_kernel`` and the XLA glue around it (:952-1004, :1108-1174).
"""
from __future__ import annotations

import torch

from ..config.params import RunParams
from ..solvers.godunov_mhd import shear_border_update
from ..solvers.shear import shear_slabs as shear_slabs_twin
from .build import load_library, param_block
from .cfl_mhd import check_plane, check_state
from .mhd_step import NPLANE, SLAB

_SLABS = {torch.float32: "ramses_shear_slabs_f32", torch.float64: "ramses_shear_slabs_f64"}
_BORDER = {torch.float32: "ramses_shear_border_f32", torch.float64: "ramses_shear_border_f64"}


def _check_scalars(S: torch.Tensor, **scalars) -> None:
    for name, x in scalars.items():
        dtype = torch.bool if name == "active" else S.dtype
        if x.shape != () or x.dtype != dtype or x.device != S.device:
            raise ValueError(f"{name} must be a 0-d {dtype} tensor on {S.device}, "
                             f"got {tuple(x.shape)} {x.dtype} on {x.device}")


def _stream(S: torch.Tensor) -> int:
    return torch.cuda.current_stream(S.device).cuda_stream


class ShearSlabsKernel:
    """``slabs = kernel(params, S, kept, t, dt, out=None)``: the sheared x
    ghost slabs [2, 8, nz, ny, 3] (XMIN, XMAX) at time t + dt, written
    into ``out`` when given. On a CPU tensor the twin runs; on a CUDA
    tensor the kernel launches."""

    def __init__(self) -> None:
        self.launches = 0

    def __call__(self, params: RunParams, S, kept, t, dt, out=None) -> torch.Tensor:
        check_state(params, S)
        check_plane(params, S, "kept", kept)
        _check_scalars(S, t=t, dt=dt)
        shape = (2, 8, params.nz, params.ny, SLAB)
        if out is None:
            out = torch.empty(shape, dtype=S.dtype, device=S.device)
        elif (tuple(out.shape) != shape or out.dtype != S.dtype or out.device != S.device
              or not out.is_contiguous()):
            raise ValueError(f"out must be a contiguous {shape} {S.dtype} tensor on {S.device}")
        if S.device.type == "cpu":
            return out.copy_(shear_slabs_twin(params, S, kept, t + dt))
        if S.device.type != "cuda":
            raise ValueError(f"unsupported device {S.device}")
        err = getattr(load_library("cuda"), _SLABS[S.dtype])(
            S.data_ptr(), kept.data_ptr(), out.data_ptr(), t.data_ptr(), dt.data_ptr(),
            params.nx, params.ny, params.nz, param_block(params), _stream(S))
        if err:
            raise RuntimeError(f"shear_slabs launch failed: CUDA error {err}")
        self.launches += 1
        return out


class ShearBorderKernel:
    """``remapped = kernel(params, S, kept, planes, t, dt, active,
    remapped=None)``: when ``active``, the remap of the step's x-face
    planes [5, nz, ny] at t + dt/2 and its corrections, in place on S's
    border columns and on the kept face; returns the four remapped planes
    [4, nz, ny] (density flux and emfY at faces 0 and nx). On a CPU tensor
    the twin runs; on a CUDA tensor the kernel launches."""

    def __init__(self) -> None:
        self.launches = 0

    def __call__(self, params: RunParams, S, kept, planes, t, dt, active,
                 remapped=None) -> torch.Tensor:
        check_state(params, S)
        check_plane(params, S, "kept", kept)
        check_plane(params, S, "planes", planes, (NPLANE,))
        _check_scalars(S, t=t, dt=dt, active=active)
        if remapped is None:
            remapped = torch.zeros((4, params.nz, params.ny), dtype=S.dtype, device=S.device)
        check_plane(params, S, "remapped", remapped, (4,))
        if S.device.type == "cpu":
            S_new, kept_new, rem = shear_border_update(params, S, kept, planes, t, dt)
            S.copy_(torch.where(active, S_new, S))
            kept.copy_(torch.where(active, kept_new, kept))
            return remapped.copy_(torch.where(active, rem, remapped))
        if S.device.type != "cuda":
            raise ValueError(f"unsupported device {S.device}")
        err = getattr(load_library("cuda"), _BORDER[S.dtype])(
            S.data_ptr(), kept.data_ptr(), planes.data_ptr(), remapped.data_ptr(),
            t.data_ptr(), dt.data_ptr(), active.data_ptr(),
            params.nx, params.ny, params.nz, param_block(params), _stream(S))
        if err:
            raise RuntimeError(f"shear_border launch failed: CUDA error {err}")
        self.launches += 1
        return remapped


shear_slabs = ShearSlabsKernel()
shear_border = ShearBorderKernel()
