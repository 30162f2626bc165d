"""One 3D hydro MUSCL-Hancock step: the CUDA kernel ``csrc/hydro_step.cu``
and its plain PyTorch twin.

Replaces the TPU kernels that run the hydro body
ramsesgpu_tpu/solvers/godunov.py:78: ramsesgpu_tpu/pallas/packed_io.py:148
``make_packed_io_step`` with pallas/fused_hydro3d.py:182 (the periodic
loop), pallas/fused_hydro3d.py:46 ``make_fused_hydro_update`` (the ghosted
step) and pallas/packed_bc.py:126 ``make_packed_bc_step`` (the walled loop).

Two modes, one kernel source:

- ``hydro_step(params, S, dt, active, scratch)`` advances the loops'
  interior-only state S [5, nz, ny, nx] in place, for any mix of
  DIRICHLET / NEUMANN / PERIODIC faces. Twin:
  ``solvers.godunov.hydro_3d_state_update``.
- ``hydro_step.ghosted(params, U, dt, scratch)`` reads a ghosted state
  [5, nz+4, ny+4, nx+4] as it is and returns its new interior. Twin:
  ``solvers.godunov.hydro_3d_interior_update``.

The stage intermediates live in one scratch buffer (~20 values per cell)
that the caller allocates once with ``HydroStepKernel.scratch``.
"""
from __future__ import annotations

import torch

from ..config.params import RunParams
from ..core.constants import RiemannSolver
from ..solvers.boundary import require_simple_bcs
from ..solvers.godunov import hydro_3d_interior_update, hydro_3d_state_update
from .build import load_library, param_block
from .cfl_hydro import check_hydro_state
from .packed_bc import bc_codes

_FN = {torch.float32: "ramses_hydro_step_f32", torch.float64: "ramses_hydro_step_f64"}
_SOLVERS = (RiemannSolver.APPROX, RiemannSolver.HLL, RiemannSolver.HLLC)


def require_hydro_scope(params: RunParams) -> None:
    """Raise NotImplementedError for what the hydro step kernel does not
    compute (as pallas/fused_hydro3d.py:35-43 and solvers/step.py:326-356
    exclude it from the JAX kernel path)."""
    reasons = []
    if params.dim != 3 or params.mhd:
        reasons.append("only 3D hydro")
    if params.riemann_solver not in _SOLVERS:
        reasons.append(f"riemannSolver {params.riemann_solver.name} (approx, hll, hllc)")
    if params.nu > 0:
        reasons.append("viscosity (nu > 0)")
    if params.gravity_x or params.gravity_y or params.gravity_z:
        reasons.append("static gravity")
    if params.compensated:
        reasons.append("Kahan-compensated state")
    if params.ghost_width != 2:
        reasons.append(f"ghostWidth {params.ghost_width} (2 only)")
    if min(params.nx, params.ny, params.nz) < params.ghost_width:
        reasons.append("fewer cells along an axis than ghost layers")
    if reasons:
        raise NotImplementedError("not ported: " + "; ".join(reasons))
    require_simple_bcs(params)


def _check_scalars(S: torch.Tensor, **scalars) -> None:
    for name, (x, dtype) in scalars.items():
        if x.shape != () or x.dtype != dtype or x.device != S.device:
            raise ValueError(f"{name} must be a 0-d {dtype} tensor on {S.device}, "
                             f"got {tuple(x.shape)} {x.dtype} on {x.device}")


class HydroStepKernel:
    """See the module note. ``dt`` is a 0-d tensor of the state's dtype on
    its device, ``active`` a 0-d bool (the step is skipped when false). On
    a CPU tensor the twin runs; on a CUDA tensor the kernel launches."""

    def __init__(self) -> None:
        self.launches = 0

    @staticmethod
    def scratch(params: RunParams, S: torch.Tensor, ghosted: bool = False):
        """The stage buffer for this shape and S's device (None on the CPU)."""
        if S.device.type == "cpu":
            return None
        n = load_library("cuda").ramses_hydro_step_scratch(
            params.nx, params.ny, params.nz, int(ghosted))
        return torch.empty(n, dtype=S.dtype, device=S.device)

    def __call__(self, params: RunParams, S: torch.Tensor, dt: torch.Tensor,
                 active: torch.Tensor, scratch=None, newton=None) -> torch.Tensor:
        """Advance S in place; returns S. ``newton``, an optional 0-d int64
        CUDA tensor, accumulates the approx solver's Newton iterations."""
        require_hydro_scope(params)
        check_hydro_state(params, S, 0)
        _check_scalars(S, dt=(dt, S.dtype), active=(active, torch.bool))
        if S.device.type == "cpu":
            S.copy_(torch.where(active, hydro_3d_state_update(params, S, dt), S))
            return S
        self._launch(params, S, S, dt, active, scratch, False, newton)
        return S

    def ghosted(self, params: RunParams, U: torch.Tensor, dt: torch.Tensor,
                scratch=None) -> torch.Tensor:
        """The new interior [5, nz, ny, nx] of the ghosted state U, whose
        ghosts must be filled."""
        require_hydro_scope(params)
        check_hydro_state(params, U, params.ghost_width)
        _check_scalars(U, dt=(dt, U.dtype))
        if U.device.type == "cpu":
            return hydro_3d_interior_update(params, U, dt)
        out = torch.empty((5, params.nz, params.ny, params.nx), dtype=U.dtype, device=U.device)
        active = torch.ones((), dtype=torch.bool, device=U.device)
        self._launch(params, U, out, dt, active, scratch, True, None)
        return out

    def _launch(self, params, src, out, dt, active, scratch, ghosted, newton) -> None:
        if src.device.type != "cuda":
            raise ValueError(f"unsupported device {src.device}")
        lib = load_library("cuda")
        need = lib.ramses_hydro_step_scratch(params.nx, params.ny, params.nz, int(ghosted))
        if (scratch is None or scratch.device != src.device or scratch.dtype != src.dtype
                or scratch.numel() < need or not scratch.is_contiguous()):
            raise ValueError(f"scratch must be a contiguous {src.dtype} buffer of >= {need} "
                             f"values on {src.device} (HydroStepKernel.scratch)")
        if newton is not None and (newton.shape != () or newton.dtype != torch.int64
                                   or newton.device != src.device):
            raise ValueError("newton must be a 0-d int64 tensor on the state's device")
        err = getattr(lib, _FN[src.dtype])(
            src.data_ptr(), out.data_ptr(), scratch.data_ptr(), dt.data_ptr(), active.data_ptr(),
            params.nx, params.ny, params.nz, int(ghosted), bc_codes(params), param_block(params),
            None if newton is None else newton.data_ptr(),
            torch.cuda.current_stream(src.device).cuda_stream,
        )
        if err:
            raise RuntimeError(f"hydro_step launch failed: CUDA error {err}")
        self.launches += 1


hydro_step = HydroStepKernel()
