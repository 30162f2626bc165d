"""The MHD CFL reduction: the CUDA kernel ``csrc/cfl_mhd.cu`` and its
plain PyTorch twins.

Replaces the TPU kernels ramsesgpu_tpu/pallas/packed_io.py:51
``make_packed_cfl_mhd`` (formula: solvers/timestep.py:114
``_inv_dt_mhd_fields``), twin ``solvers.timestep.inv_dt_mhd_periodic``,
and, given the kept Bx face, pallas/shear_packed.py:716
``make_shear_cfl_kernel`` (shearing box: isothermal or adiabatic, the
rotating frame's vy offset; stratified z faces), twin
``solvers.timestep.inv_dt_mhd_shear``.

A compensated state (``[implementation] compensated``) is [16, nz, ny, nx],
the state and then its Kahan carry, and a shearing box's kept face [2, nz,
ny]; the reduction reads channels 0-7 and the face, as the JAX kernel reads
its packed state's first nvar channels (pallas/packed_io.py:190).
"""
from __future__ import annotations

import torch

from ..config.params import RunParams

from ..solvers.timestep import inv_dt_mhd_periodic, inv_dt_mhd_shear
from .build import load_library, param_block

_FN = {torch.float32: "ramses_cfl_mhd_f32", torch.float64: "ramses_cfl_mhd_f64"}
_FN_SHEAR = {torch.float32: "ramses_cfl_mhd_shear_f32", torch.float64: "ramses_cfl_mhd_shear_f64"}


def state_channels(params: RunParams) -> int:
    """Channels of the MHD loop state: 8, or 16 with the Kahan carry."""
    return 16 if params.compensated else 8


def kept_lead(params: RunParams) -> tuple:
    """Leading dims of the kept face: (), or (2,) with its carry."""
    return (2,) if params.compensated else ()


def check_state(params: RunParams, S: torch.Tensor) -> None:
    """The port's loop state: a contiguous [8, nz, ny, nx] f32/f64 tensor
    ([16, ...] when compensated)."""
    want = (state_channels(params), params.nz, params.ny, params.nx)
    if tuple(S.shape) != want:
        raise ValueError(f"state shape {tuple(S.shape)} != {want}")
    if S.dtype not in _FN:
        raise TypeError(f"state dtype {S.dtype} is not float32/float64")
    if not S.is_contiguous():
        raise ValueError("state must be contiguous")


def check_plane(params: RunParams, S: torch.Tensor, name: str, x: torch.Tensor,
                lead: tuple = ()) -> None:
    """A contiguous [*lead, nz, ny] tensor of S's dtype on S's device."""
    want = (*lead, params.nz, params.ny)
    if (tuple(x.shape) != want or x.dtype != S.dtype or x.device != S.device
            or not x.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous {want} {S.dtype} tensor on {S.device}, "
                         f"got {tuple(x.shape)} {x.dtype} on {x.device}")


class CflMhdKernel:
    """``inv = kernel(params, S, kept=None)``: the 0-d device tensor
    max over cells of the MHD inverse time step; with the kept Bx face
    [nz, ny] ([2, nz, ny] compensated) of a shearing-box state, its
    shearing-box mode. On a CPU tensor it returns the twin's value; on a
    CUDA tensor it launches the kernel."""

    def __init__(self) -> None:
        self.launches = 0

    def __call__(self, params: RunParams, S: torch.Tensor,
                 kept: torch.Tensor | None = None) -> torch.Tensor:
        if kept is None and (params.omega0 > 0 or params.c_iso > 0):
            raise NotImplementedError(
                "the periodic CFL covers the ideal adiabatic, non-rotating case; "
                "a rotating or isothermal state needs the kept face (shearing box)"
            )
        check_state(params, S)
        if kept is not None:
            check_plane(params, S, "kept", kept, kept_lead(params))
        if S.device.type == "cpu":
            if kept is None:
                return inv_dt_mhd_periodic(params, S[:8])
            return inv_dt_mhd_shear(params, S, kept[0] if params.compensated else kept)
        if S.device.type != "cuda":
            raise ValueError(f"unsupported device {S.device}")
        lib = load_library("cuda")
        partial = torch.empty(lib.ramses_cfl_mhd_partials(), dtype=S.dtype, device=S.device)
        out = torch.empty((), dtype=S.dtype, device=S.device)
        stream = torch.cuda.current_stream(S.device).cuda_stream
        dims = (params.nx, params.ny, params.nz, param_block(params), stream)
        if kept is None:
            err = getattr(lib, _FN[S.dtype])(S.data_ptr(), partial.data_ptr(), out.data_ptr(),
                                             *dims)
        else:
            err = getattr(lib, _FN_SHEAR[S.dtype])(S.data_ptr(), kept.data_ptr(),
                                                   partial.data_ptr(), out.data_ptr(), *dims)
        if err:
            raise RuntimeError(f"cfl_mhd launch failed: CUDA error {err}")
        self.launches += 1
        return out


cfl_mhd = CflMhdKernel()
