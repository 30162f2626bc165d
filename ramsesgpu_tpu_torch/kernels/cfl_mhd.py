"""The MHD CFL reduction: the CUDA kernel ``csrc/cfl_mhd.cu`` and its
plain PyTorch twin.

Replaces the TPU kernel ramsesgpu_tpu/pallas/packed_io.py:51
``make_packed_cfl_mhd`` (formula: solvers/timestep.py:114
``_inv_dt_mhd_fields``). The twin is ``solvers.timestep.inv_dt_mhd_periodic``.
"""
from __future__ import annotations

import torch

from ..config.params import RunParams

from ..solvers.timestep import inv_dt_mhd_periodic
from .build import load_library, param_block

_FN = {torch.float32: "ramses_cfl_mhd_f32", torch.float64: "ramses_cfl_mhd_f64"}


def check_state(params: RunParams, S: torch.Tensor) -> None:
    """The port's loop state: a contiguous [8, nz, ny, nx] f32/f64 tensor."""
    want = (8, params.nz, params.ny, params.nx)
    if tuple(S.shape) != want:
        raise ValueError(f"state shape {tuple(S.shape)} != {want}")
    if S.dtype not in _FN:
        raise TypeError(f"state dtype {S.dtype} is not float32/float64")
    if not S.is_contiguous():
        raise ValueError("state must be contiguous")


class CflMhdKernel:
    """``inv = kernel(params, S)``: the 0-d device tensor
    max over cells of the MHD inverse time step. On a CPU tensor it
    returns the twin's value; on a CUDA tensor it launches the kernel."""

    def __init__(self) -> None:
        self.launches = 0

    def __call__(self, params: RunParams, S: torch.Tensor) -> torch.Tensor:
        if params.omega0 > 0 or params.c_iso > 0:
            raise NotImplementedError(
                "the CFL kernel covers the ideal adiabatic, non-rotating case"
            )
        check_state(params, S)
        if S.device.type == "cpu":
            return inv_dt_mhd_periodic(params, S)
        if S.device.type != "cuda":
            raise ValueError(f"unsupported device {S.device}")
        lib = load_library("cuda")
        partial = torch.empty(lib.ramses_cfl_mhd_partials(), dtype=S.dtype, device=S.device)
        out = torch.empty((), dtype=S.dtype, device=S.device)
        err = getattr(lib, _FN[S.dtype])(
            S.data_ptr(), partial.data_ptr(), out.data_ptr(),
            params.nx, params.ny, params.nz, param_block(params),
            torch.cuda.current_stream(S.device).cuda_stream,
        )
        if err:
            raise RuntimeError(f"cfl_mhd launch failed: CUDA error {err}")
        self.launches += 1
        return out


cfl_mhd = CflMhdKernel()
