"""The hydro CFL reduction: the CUDA kernel ``csrc/cfl_hydro.cu`` and its
plain PyTorch twin.

Replaces the TPU kernel ramsesgpu_tpu/pallas/packed_bc.py:408
``make_packed_cfl_hydro`` (formula: solvers/timestep.py:33
``compute_inv_dt_hydro``). The twin is ``solvers.timestep.compute_inv_dt_hydro``,
which the kernel equals bitwise on the same state.
"""
from __future__ import annotations

import torch

from ..config.params import RunParams
from ..solvers.timestep import compute_inv_dt_hydro
from .build import load_library, param_block

_FN = {torch.float32: "ramses_cfl_hydro_f32", torch.float64: "ramses_cfl_hydro_f64"}


def check_hydro_state(params: RunParams, A: torch.Tensor, ghost: int) -> None:
    """A hydro state of the port: contiguous f32/f64 [5, nz, ny, nx] plus a
    ghost frame of width ``ghost`` on each side."""
    want = (5, params.nz + 2 * ghost, params.ny + 2 * ghost, params.nx + 2 * ghost)
    if tuple(A.shape) != want:
        raise ValueError(f"state shape {tuple(A.shape)} != {want}")
    if A.dtype not in _FN:
        raise TypeError(f"state dtype {A.dtype} is not float32/float64")
    if not A.is_contiguous():
        raise ValueError("state must be contiguous")


class CflHydroKernel:
    """``inv = kernel(params, A, ghost=0)``: the 0-d device tensor max over
    the interior cells of the hydro inverse time step, for the loops'
    interior-only state (``ghost`` 0) or a ghosted state (``ghost`` =
    ghost_width). On a CPU tensor it returns the twin's value; on a CUDA
    tensor it launches the kernel."""

    def __init__(self) -> None:
        self.launches = 0

    def __call__(self, params: RunParams, A: torch.Tensor, ghost: int = 0) -> torch.Tensor:
        if params.mhd or params.dim != 3:
            raise NotImplementedError("the hydro CFL kernel covers 3D hydro")
        check_hydro_state(params, A, ghost)
        if A.device.type == "cpu":
            return compute_inv_dt_hydro(params, A, ghost=ghost)
        if A.device.type != "cuda":
            raise ValueError(f"unsupported device {A.device}")
        lib = load_library("cuda")
        partial = torch.empty(lib.ramses_cfl_hydro_partials(), dtype=A.dtype, device=A.device)
        out = torch.empty((), dtype=A.dtype, device=A.device)
        err = getattr(lib, _FN[A.dtype])(
            A.data_ptr(), partial.data_ptr(), out.data_ptr(),
            params.nx, params.ny, params.nz, ghost, param_block(params),
            torch.cuda.current_stream(A.device).cuda_stream,
        )
        if err:
            raise RuntimeError(f"cfl_hydro launch failed: CUDA error {err}")
        self.launches += 1
        return out


cfl_hydro = CflHydroKernel()
