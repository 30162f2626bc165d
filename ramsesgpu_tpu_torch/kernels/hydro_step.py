"""One 3D hydro MUSCL-Hancock step: the CUDA kernel ``csrc/hydro_step.cu``
and its plain PyTorch twin.

Replaces the TPU kernels that run the hydro body
ramsesgpu_tpu/solvers/godunov.py:78: ramsesgpu_tpu/pallas/packed_io.py:148
``make_packed_io_step`` with pallas/fused_hydro3d.py:182 (the periodic
loop), pallas/fused_hydro3d.py:46 ``make_fused_hydro_update`` (the ghosted
step) and pallas/packed_bc.py:126 ``make_packed_bc_step`` (the walled loop).

Three modes, one kernel (the streamed block body, csrc/hydro_stream.cuh):

- ``hydro_step(params, S, S_out, dt, active)`` writes the step of the
  loops' interior-only state S [5, nz, ny, nx] into S_out, another buffer
  (a copy of S when ``active`` is false), for any mix of DIRICHLET /
  NEUMANN / PERIODIC faces. Twin: ``solvers.godunov.hydro_3d_state_update``.
- ``hydro_step.ghosted(params, U, dt)`` reads a ghosted state
  [5, nz+4, ny+4, nx+4] as it is and returns its new interior. Twin:
  ``solvers.godunov.hydro_3d_interior_update``. ``hydro_step.ghosted_(params,
  U, dt, active, buf)`` writes that interior into U itself when ``active``
  (the jet's loop on the ghosted state), through the interior buffer
  ``buf`` that the caller allocates once with ``HydroStepKernel.scratch``.

A uniform static gravity ([gravity] static_field_*, a constant vector:
config/params.py static_gravity) selects the kernel's gravity instance in
every mode, chosen at launch from the parameter block (the half-dt kick of
the traced states, the conservative source); the twins take the vector
(``solvers.godunov.gravity_vector``).

The kernel's intermediates live in shared memory; it runs on a persistent
grid of as many blocks as the card holds at once.
"""
from __future__ import annotations

import torch

from ..config.params import RunParams
from ..core.constants import RiemannSolver
from ..solvers.boundary import interior, require_simple_bcs
from ..solvers.godunov import gravity_vector, hydro_3d_interior_update, hydro_3d_state_update
from .build import load_library, param_block
from .cfl_hydro import check_hydro_state
from .packed_bc import bc_codes

_FN = {torch.float32: "ramses_hydro_step_f32", torch.float64: "ramses_hydro_step_f64"}
_SOLVERS = (RiemannSolver.APPROX, RiemannSolver.HLL, RiemannSolver.HLLC)


def require_hydro_scope(params: RunParams) -> None:
    """Raise NotImplementedError for what the hydro step kernel does not
    compute (as pallas/fused_hydro3d.py:35-43 and solvers/step.py:326-356
    exclude it from the JAX kernel path). Viscosity (nu > 0) is taken: the
    kernel computes the inviscid step and the loops add the whole-array
    viscous sub-step after it (kernels/fused_hydro3d.py). ``[implementation]
    compensated`` selects nothing in hydro: the state is plain, as the JAX
    package reads the switch only on its MHD paths."""
    reasons = []
    if params.dim != 3 or params.mhd:
        reasons.append("only 3D hydro")
    if params.riemann_solver not in _SOLVERS:
        reasons.append(f"riemannSolver {params.riemann_solver.name} (approx, hll, hllc)")
    if params.ghost_width != 2:
        reasons.append(f"ghostWidth {params.ghost_width} (2 only)")
    if min(params.nx, params.ny, params.nz) < params.ghost_width:
        reasons.append("fewer cells along an axis than ghost layers")
    if reasons:
        raise NotImplementedError("not ported: " + "; ".join(reasons))
    require_simple_bcs(params)


def check_scalars(S: torch.Tensor, **scalars) -> None:
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
        self.ghosted_launches = 0   # those of the ghosted modes, among launches
        self._blocks = {}   # (device, dtype) -> the persistent grid

    @staticmethod
    def scratch(params: RunParams, U: torch.Tensor):
        """The in-place ghosted step's interior buffer for U's dtype and
        device (None on the CPU)."""
        if U.device.type == "cpu":
            return None
        return torch.empty((5, params.nz, params.ny, params.nx), dtype=U.dtype, device=U.device)

    def blocks(self, S: torch.Tensor) -> int:
        """The persistent grid for S's device and dtype (asked once)."""
        key = (S.device, S.dtype)
        if key not in self._blocks:
            blocks = load_library("cuda").ramses_hydro_step_blocks(int(S.dtype == torch.float64))
            if blocks <= 0:
                raise RuntimeError(f"hydro_step occupancy query failed: CUDA error {-blocks}")
            self._blocks[key] = blocks
        return self._blocks[key]

    def __call__(self, params: RunParams, S: torch.Tensor, S_out: torch.Tensor,
                 dt: torch.Tensor, active: torch.Tensor, newton=None) -> torch.Tensor:
        """Write the step of S into S_out; returns S_out. ``newton``, an
        optional 0-d int64 CUDA tensor, accumulates the approx solver's
        Newton iterations."""
        require_hydro_scope(params)
        check_hydro_state(params, S, 0)
        check_out(params, S, S_out)
        check_scalars(S, dt=(dt, S.dtype), active=(active, torch.bool))
        if S.device.type == "cpu":
            S_out.copy_(torch.where(
                active, hydro_3d_state_update(params, S, dt, gravity_vector(params, S)), S))
            return S_out
        self._launch(params, S, S_out, dt, active, 0, newton)
        return S_out

    def ghosted(self, params: RunParams, U: torch.Tensor, dt: torch.Tensor) -> torch.Tensor:
        """The new interior [5, nz, ny, nx] of the ghosted state U, whose
        ghosts must be filled."""
        require_hydro_scope(params)
        check_hydro_state(params, U, params.ghost_width)
        check_scalars(U, dt=(dt, U.dtype))
        if U.device.type == "cpu":
            return hydro_3d_interior_update(params, U, dt, gravity_vector(params, U))
        out = torch.empty((5, params.nz, params.ny, params.nx), dtype=U.dtype, device=U.device)
        active = torch.ones((), dtype=torch.bool, device=U.device)
        self._launch(params, U, out, dt, active, 1, None)
        return out

    def ghosted_(self, params: RunParams, U: torch.Tensor, dt: torch.Tensor,
                 active: torch.Tensor, buf=None) -> torch.Tensor:
        """The ghosted step in place: U's interior becomes the new interior
        when ``active``; its ghosts stay. ``buf``: the interior buffer
        (``scratch``). Returns U."""
        require_hydro_scope(params)
        check_hydro_state(params, U, params.ghost_width)
        check_scalars(U, dt=(dt, U.dtype), active=(active, torch.bool))
        if U.device.type == "cpu":
            inner = interior(params, U)
            inner.copy_(torch.where(
                active, hydro_3d_interior_update(params, U, dt, gravity_vector(params, U)), inner))
            return U
        if buf is None:
            raise ValueError("the in-place ghosted step needs its interior buffer "
                             "(HydroStepKernel.scratch)")
        check_out(params, U, buf)
        self._launch(params, U, buf, dt, active, 2, None)
        return U

    def _launch(self, params, src, out, dt, active, ghosted, newton) -> None:
        """ghosted: 0 interior mode, 1 ghosted into out, 2 ghosted in place
        (through the buffer out)."""
        if src.device.type != "cuda":
            raise ValueError(f"unsupported device {src.device}")
        if newton is not None and (newton.shape != () or newton.dtype != torch.int64
                                   or newton.device != src.device):
            raise ValueError("newton must be a 0-d int64 tensor on the state's device")
        err = getattr(load_library("cuda"), _FN[src.dtype])(
            src.data_ptr(), out.data_ptr(), self.blocks(src), dt.data_ptr(), active.data_ptr(),
            params.nx, params.ny, params.nz, ghosted, bc_codes(params), param_block(params),
            None if newton is None else newton.data_ptr(),
            torch.cuda.current_stream(src.device).cuda_stream,
        )
        if err:
            raise RuntimeError(f"hydro_step launch failed: CUDA error {err}")
        self.launches += 1
        self.ghosted_launches += int(ghosted != 0)


def check_out(params: RunParams, S: torch.Tensor, out: torch.Tensor) -> None:
    """``out`` must be another contiguous interior-shaped buffer of S's
    dtype on its device."""
    check_hydro_state(params, out, 0)
    if out.dtype != S.dtype or out.device != S.device or out.data_ptr() == S.data_ptr():
        raise ValueError("the output must be another buffer of the state's dtype on its device")


hydro_step = HydroStepKernel()
