"""The shearing box's x borders: the CUDA kernels of ``csrc/shear_border.cu``
and their plain PyTorch twins.

- ``shear_slabs``: the sheared x ghost slabs at t + dt from the loop state
  (S, kept); twin ``solvers.shear.shear_slabs``. Given ``zout`` (the
  stratified z faces, BC_Z_STRATIFIED), the same launch builds the z ghost
  slabs of the interior and of the x slabs beside it; twin
  ``solvers.shear.stratified_zslabs``.
- ``shear_border``: the conservative remap of the step kernel's x-face
  planes at t + dt/2, the border-column corrections, the density floor
  and the CT update of the kept Bx face; twin
  ``solvers.godunov_mhd.shear_border_update``. Compensated: Kahan adds,
  the carry reset where the floor fires, the kept face's carry.
- ``shear_zslabs``: the stratified z ghost slabs alone, from given x slabs:
  the twin's entry point, for CPU tensors (on the card the slab kernel
  builds them).

With the step kernel's shearing-box mode (kernels/mhd_step.py) they
replace the TPU border strip kernel ramsesgpu_tpu/pallas/shear_packed.py:237
``_make_strip_kernel`` and the XLA glue around it (:952-1004, :1108-1174;
stratified, the slab z extension and the z band refills :963-975,
:1006-1021).
"""
from __future__ import annotations

import torch

from ..config.params import RunParams
from ..solvers.godunov_mhd import kept_face, shear_border_update
from ..solvers.shear import shear_slabs as shear_slabs_twin
from ..solvers.shear import stratified_zslabs
from .build import load_library, param_block
from .cfl_mhd import check_plane, check_state, kept_lead
from .mhd_step import NPLANE, SLAB, check_buffer, zslab_shape

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
    """``slabs = kernel(params, S, kept, t, dt, out=None, zout=None)``: the
    sheared x ghost slabs [2, 8, nz, ny, 3] (XMIN, XMAX) at time t + dt,
    written into ``out`` when given; with ``zout`` [2, 8, 3, ny, nx + 6]
    (stratified z faces), the z ghost slabs of the block [XMIN slab | S |
    XMAX slab] too, in the same launch. On a CPU tensor the twins run; on a
    CUDA tensor the kernel launches."""

    def __init__(self) -> None:
        self.launches = 0

    def __call__(self, params: RunParams, S, kept, t, dt, out=None, zout=None) -> torch.Tensor:
        check_state(params, S)
        check_plane(params, S, "kept", kept, kept_lead(params))
        _check_scalars(S, t=t, dt=dt)
        shape = (2, 8, params.nz, params.ny, SLAB)
        if out is None:
            out = torch.empty(shape, dtype=S.dtype, device=S.device)
        check_buffer(S, "out", out, shape)
        if zout is not None:
            check_buffer(S, "zout", zout, zslab_shape(params))
        if S.device.type == "cpu":
            out.copy_(shear_slabs_twin(params, S[:8], kept_face(kept), t + dt))
            if zout is not None:
                zout.copy_(stratified_zslabs(params, S[:8], out))
            return out
        if S.device.type != "cuda":
            raise ValueError(f"unsupported device {S.device}")
        err = getattr(load_library("cuda"), _SLABS[S.dtype])(
            S.data_ptr(), kept.data_ptr(), out.data_ptr(),
            None if zout is None else zout.data_ptr(), t.data_ptr(), dt.data_ptr(),
            params.nx, params.ny, params.nz, param_block(params), _stream(S))
        if err:
            raise RuntimeError(f"shear_slabs launch failed: CUDA error {err}")
        self.launches += 1
        return out


def shear_zslabs(params: RunParams, S, slabs, out=None) -> torch.Tensor:
    """The stratified z ghost slabs [2, 8, 3, ny, nx + 6] (ZMIN, ZMAX) of
    the block [XMIN slab | S | XMAX slab] from the x slabs ``slabs``,
    written into ``out`` when given: the twin, on CPU tensors. On the card
    the slab kernel builds them (``shear_slabs(..., zout=...)``)."""
    check_state(params, S)
    check_buffer(S, "slabs", slabs, (2, 8, params.nz, params.ny, SLAB))
    if out is None:
        out = torch.empty(zslab_shape(params), dtype=S.dtype, device=S.device)
    check_buffer(S, "out", out, zslab_shape(params))
    if S.device.type != "cpu":
        raise ValueError("on the card the slab kernel builds the z slabs: "
                         "shear_slabs(params, S, kept, t, dt, zout=...)")
    return out.copy_(stratified_zslabs(params, S[:8], slabs))


class ShearBorderKernel:
    """``remapped = kernel(params, S, kept, planes, t, dt, active,
    remapped=None)``: when ``active``, the remap of the step's x-face
    planes [5, nz, ny] at t + dt/2 and its corrections, in place on S's
    border columns and on the kept face (compensated: Kahan adds on S's and
    kept's carries too); returns the four remapped planes [4, nz, ny]
    (density flux and emfY at faces 0 and nx). On a CPU tensor the twin
    runs; on a CUDA tensor the kernel launches."""

    def __init__(self) -> None:
        self.launches = 0

    def __call__(self, params: RunParams, S, kept, planes, t, dt, active,
                 remapped=None) -> torch.Tensor:
        check_state(params, S)
        check_plane(params, S, "kept", kept, kept_lead(params))
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
            t.data_ptr(), dt.data_ptr(), active.data_ptr(), int(params.compensated),
            params.nx, params.ny, params.nz, param_block(params), _stream(S))
        if err:
            raise RuntimeError(f"shear_border launch failed: CUDA error {err}")
        self.launches += 1
        return remapped


shear_slabs = ShearSlabsKernel()
shear_border = ShearBorderKernel()
