"""The hydro CFL reduction: the CUDA kernel ``csrc/cfl_hydro.cu`` and its
plain PyTorch twin.

Replaces the TPU kernel ramsesgpu_tpu/pallas/packed_bc.py:408
``make_packed_cfl_hydro`` (formula: solvers/timestep.py:33
``compute_inv_dt_hydro``). The twin is ``solvers.timestep.compute_inv_dt_hydro``,
which the kernel equals bitwise on the same state. With the inflow jet the
result is at least the jet's (ujet + cjet) / dx (``solvers.timestep.with_jet``
on the CPU; on the card the kernel's floor).

One launch a reduction: the row walk of ``csrc/cfl_rows.cuh``, through its
partials and block counter (``kernels.cfl_rows.workspace``, allocated once
per device and dtype and shared with the MHD CFL kernel).
"""
from __future__ import annotations

import torch

from ..config.params import RunParams
from ..solvers.timestep import compute_inv_dt_hydro, jet_inv_dt, with_jet
from .build import load_library, param_block
from .cfl_rows import workspace

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
    ghost_width), at least the inflow jet's inverse dt. On a CPU tensor it
    returns the twin's value; on a CUDA tensor it launches the kernel."""

    def __init__(self) -> None:
        self.launches = 0
        self.ghosted_launches = 0   # those on a ghosted state, among launches

    def __call__(self, params: RunParams, A: torch.Tensor, ghost: int = 0) -> torch.Tensor:
        if params.mhd or params.dim != 3:
            raise NotImplementedError("the hydro CFL kernel covers 3D hydro")
        check_hydro_state(params, A, ghost)
        if A.device.type == "cpu":
            return with_jet(params, compute_inv_dt_hydro(params, A, ghost=ghost))
        if A.device.type != "cuda":
            raise ValueError(f"unsupported device {A.device}")
        lib = load_library("cuda")
        out = torch.empty((), dtype=A.dtype, device=A.device)
        jet = jet_inv_dt(params)
        err = getattr(lib, _FN[A.dtype])(
            A.data_ptr(), *workspace(lib, A), out.data_ptr(), params.nx, params.ny, params.nz,
            ghost, float("-inf") if jet is None else jet, param_block(params),
            torch.cuda.current_stream(A.device).cuda_stream,
        )
        if err:
            raise RuntimeError(f"cfl_hydro launch failed: CUDA error {err}")
        self.launches += 1
        self.ghosted_launches += int(ghost != 0)
        return out


cfl_hydro = CflHydroKernel()
