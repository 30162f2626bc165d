"""One periodic 3D MHD+CT step: the CUDA kernel ``csrc/mhd_step.cu`` and
its plain PyTorch twin.

Replaces the TPU kernel ramsesgpu_tpu/pallas/packed_io.py:148
``make_packed_io_step`` with the MHD body pallas/fused_mhd3d.py:228 ->
solvers/godunov_mhd.py:437. The twin is
``solvers.godunov_mhd.mhd_3d_periodic_update``.

The kernel updates the interior-only periodic state [8, nz, ny, nx] in
place. Its stage intermediates live in one scratch buffer
(``scratch_per_cell`` values per cell, ~11.6 GB at 256^3 f32) that the
caller allocates once per advance with ``MhdStepKernel.scratch``.
"""
from __future__ import annotations

import torch

from ..config.params import RunParams
from ..core.constants import MagneticRiemannSolver, RiemannSolver

from ..solvers.boundary import require_periodic
from ..solvers.godunov_mhd import mhd_3d_periodic_update
from .build import load_library, param_block
from .cfl_mhd import check_state

_FN = {torch.float32: "ramses_mhd_step_f32", torch.float64: "ramses_mhd_step_f64"}


def require_step_scope(params: RunParams) -> None:
    """Raise NotImplementedError for what the step kernel does not compute."""
    reasons = []
    if params.dim != 3 or not params.mhd:
        reasons.append("only 3D MHD")
    if params.riemann_solver != RiemannSolver.HLLD:
        reasons.append(f"riemannSolver {params.riemann_solver.name} (HLLD only)")
    if params.mag_riemann_solver != MagneticRiemannSolver.MAG_HLLD:
        reasons.append(f"magRiemannSolver {params.mag_riemann_solver.name} (HLLD only)")
    if params.omega0 > 0:
        reasons.append("rotating frame (omega0 > 0)")
    if params.c_iso > 0:
        reasons.append("isothermal EOS (cIso > 0)")
    if params.nu > 0 or params.eta > 0:
        reasons.append("viscosity / resistivity")
    if params.compensated:
        reasons.append("Kahan-compensated state")
    if params.gravity_x or params.gravity_y or params.gravity_z:
        reasons.append("static gravity")
    if reasons:
        raise NotImplementedError("not ported: " + "; ".join(reasons))
    require_periodic(params)


class MhdStepKernel:
    """``kernel(params, S, dt, active, scratch)`` advances S by one step in
    place when the 0-d bool ``active`` is true, and returns S. ``dt`` is a
    0-d tensor of S's dtype on S's device. On a CPU tensor the twin runs;
    on a CUDA tensor the kernel launches."""

    def __init__(self) -> None:
        self.launches = 0

    @staticmethod
    def scratch(params: RunParams, S: torch.Tensor) -> torch.Tensor | None:
        """The stage buffer for S's shape and device (None on the CPU)."""
        if S.device.type == "cpu":
            return None
        per_cell = load_library("cuda").ramses_mhd_step_scratch_per_cell()
        n = params.nx * params.ny * params.nz
        return torch.empty(per_cell * n, dtype=S.dtype, device=S.device)

    def __call__(self, params, S, dt, active, scratch=None) -> torch.Tensor:
        require_step_scope(params)
        check_state(params, S)
        for name, x, dtype in (("dt", dt, S.dtype), ("active", active, torch.bool)):
            if x.shape != () or x.dtype != dtype or x.device != S.device:
                raise ValueError(
                    f"{name} must be a 0-d {dtype} tensor on {S.device}, "
                    f"got {tuple(x.shape)} {x.dtype} on {x.device}"
                )
        if S.device.type == "cpu":
            S.copy_(torch.where(active, mhd_3d_periodic_update(params, S, dt), S))
            return S
        if S.device.type != "cuda":
            raise ValueError(f"unsupported device {S.device}")
        lib = load_library("cuda")
        need = lib.ramses_mhd_step_scratch_per_cell() * S[0].numel()
        if (scratch is None or scratch.device != S.device or scratch.dtype != S.dtype
                or scratch.numel() < need or not scratch.is_contiguous()):
            raise ValueError(f"scratch must be a contiguous {S.dtype} buffer of "
                             f">= {need} values on {S.device} (MhdStepKernel.scratch)")
        err = getattr(lib, _FN[S.dtype])(
            S.data_ptr(), scratch.data_ptr(), dt.data_ptr(), active.data_ptr(),
            params.nx, params.ny, params.nz, param_block(params),
            torch.cuda.current_stream(S.device).cuda_stream,
        )
        if err:
            raise RuntimeError(f"mhd_step launch failed: CUDA error {err}")
        self.launches += 1
        return S


mhd_step = MhdStepKernel()
