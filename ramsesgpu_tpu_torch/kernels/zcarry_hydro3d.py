"""One 3D hydro step of a fully periodic state streamed over z, with the
next step's CFL folded in (``[implementation] kernel=zcarry``): the CUDA
kernel ``csrc/zcarry_hydro.cu`` and its plain PyTorch twin.

Replaces the TPU kernel ramsesgpu_tpu/pallas/zcarry_hydro3d.py:58
``make_zcarry_hydro_packed_io`` (``with_inv_dt=True``): the step of
kernels/hydro_step.py's interior PERIODIC mode (the same streamed block
body, csrc/hydro_stream.cuh, so bitwise its new state) in one launch,
writing the new state into a second buffer and returning the inverse dt
of it, reduced in the same launch. Twin:
``solvers.godunov.hydro_3d_state_update``, then
``solvers.timestep.compute_inv_dt_hydro`` on its result.
"""
from __future__ import annotations

import torch

from ..config.params import RunParams
from ..core.constants import BoundaryConditionType as BCT
from ..solvers.godunov import hydro_3d_state_update
from ..solvers.timestep import compute_inv_dt_hydro
from .build import load_library, param_block
from .cfl_hydro import check_hydro_state
from .hydro_step import check_out, check_scalars, require_hydro_scope

_FN = {torch.float32: "ramses_zcarry_hydro_f32", torch.float64: "ramses_zcarry_hydro_f64"}


def zcarry_hydro_supported(params: RunParams) -> bool:
    """Whether the streamed kernel covers the run: fully periodic faces
    (pallas/zcarry_hydro3d.py:46 without the TPU's tile conditions). A
    walled run takes the step kernel's wall rules and the CFL kernel, as
    the JAX package takes its whole-array step there."""
    return all(b == BCT.BC_PERIODIC for b in params.boundary_types)


class ZcarryHydroKernel:
    """``inv = kernel(params, S, S_out, dt, active)`` writes one step of the
    periodic state S into S_out (another buffer) when the 0-d bool
    ``active`` is true, else a copy of S, and returns the 0-d inverse dt of
    S_out. On a CPU tensor the twin runs; on a CUDA tensor the kernel
    launches (its ring lives in shared memory)."""

    def __init__(self) -> None:
        self.launches = 0
        self._blocks = {}   # (device, dtype) -> the persistent grid

    def blocks(self, S: torch.Tensor) -> int:
        """The persistent grid for S's device and dtype: as many blocks as
        the card holds at once (asked once)."""
        key = (S.device, S.dtype)
        if key not in self._blocks:
            blocks = load_library("cuda").ramses_zcarry_hydro_blocks(int(S.dtype == torch.float64))
            if blocks <= 0:
                raise RuntimeError(f"zcarry_hydro occupancy query failed: CUDA error {-blocks}")
            self._blocks[key] = blocks
        return self._blocks[key]

    def __call__(self, params, S, S_out, dt, active) -> torch.Tensor:
        require_hydro_scope(params)
        if not zcarry_hydro_supported(params):
            raise ValueError("configuration outside the hydro zcarry kernel")
        check_hydro_state(params, S, 0)
        check_out(params, S, S_out)
        check_scalars(S, dt=(dt, S.dtype), active=(active, torch.bool))
        if S.device.type == "cpu":
            S_out.copy_(torch.where(active, hydro_3d_state_update(params, S, dt), S))
            return compute_inv_dt_hydro(params, S_out, ghost=0)
        if S.device.type != "cuda":
            raise ValueError(f"unsupported device {S.device}")
        inv = torch.empty((), dtype=S.dtype, device=S.device)
        err = getattr(load_library("cuda"), _FN[S.dtype])(
            S.data_ptr(), S_out.data_ptr(), self.blocks(S), inv.data_ptr(), dt.data_ptr(),
            active.data_ptr(), params.nx, params.ny, params.nz, param_block(params),
            torch.cuda.current_stream(S.device).cuda_stream)
        if err:
            raise RuntimeError(f"zcarry_hydro launch failed: CUDA error {err}")
        self.launches += 1
        return inv


zcarry_hydro = ZcarryHydroKernel()
