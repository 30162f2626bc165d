"""One 3D MHD+CT step: the CUDA kernel ``csrc/mhd_step.cu`` and its plain
PyTorch twins, in three modes.

- Periodic: replaces the TPU kernel ramsesgpu_tpu/pallas/packed_io.py:148
  ``make_packed_io_step`` with the MHD body pallas/fused_mhd3d.py:228 ->
  solvers/godunov_mhd.py:437. Twin:
  ``solvers.godunov_mhd.mhd_3d_periodic_update``.
- Shearing box (rotating frame, sheared-periodic x faces): replaces the
  MRI main kernel pallas/shear_packed.py:89 ``_make_main_kernel`` and the
  border strip kernel :237 ``_make_strip_kernel``. It reads the sheared x
  ghost slabs (kernels/shear_border.py) and writes the five unremapped
  x-face planes. Twin: ``solvers.godunov_mhd.mhd_3d_shear_update``.
- Stratified MRI (the shearing box with BC_Z_STRATIFIED z faces and the
  static vertical gravity): replaces the MRI main kernel with its
  ``gravity_z`` aux plane (shear_packed.py:89, :117-131) and the strip's
  gravity. z loads outside the interior read the stratified z slabs
  (kernels/shear_border.py), the traced states get the half-dt gravity
  kick and the update the conservative source. Twin: the same, with
  ``zslabs`` and ``gz``.

Compensated (``[implementation] compensated``, both modes; TPU row
A′-compensated, fused_mhd3d.py:247-259): the state is [16, nz, ny, nx],
the state and then its Kahan carry, and the update stage Kahan-adds each
channel's increment.

The kernel updates the interior-only state [8, nz, ny, nx] in place. Its
stage intermediates live in one scratch buffer (~11.6 GB at 256^3 f32;
the shearing box's stage grid has nx + 4 columns, the stratified one
nz + 4 rows too) that the caller allocates once per advance with
``MhdStepKernel.scratch``.
"""
from __future__ import annotations

import torch

from ..config.params import RunParams
from ..core.constants import BoundaryConditionType as BCT, MagneticRiemannSolver, RiemannSolver

from ..solvers.boundary import require_periodic
from ..solvers.godunov_mhd import mhd_3d_periodic_update, mhd_3d_shear_update
from ..solvers.stratified import uses_stratified_z
from .build import load_library, param_block
from .cfl_mhd import check_plane, check_state

_FN = {torch.float32: "ramses_mhd_step_f32", torch.float64: "ramses_mhd_step_f64"}
_FN_SHEAR = {torch.float32: "ramses_mhd_step_shear_f32",
             torch.float64: "ramses_mhd_step_shear_f64"}
SLAB = 3     # columns of each sheared ghost slab (csrc/mhd_step.cu SLAB)
NPLANE = 5   # x-face planes of the shearing-box mode


def uses_shear(params: RunParams) -> bool:
    return BCT.BC_SHEARINGBOX in (params.boundary_xmin, params.boundary_xmax)


def require_step_scope(params: RunParams) -> None:
    """Raise NotImplementedError for what the step kernels (this one and,
    with nu > 0 or eta > 0, kernels/dissip_step.py) do not compute.
    ``[implementation] stripFused`` is accepted with every value: the
    port's shear path has no border strip (kernels/shear.py). Stratified z
    faces (BC_Z_STRATIFIED) are taken on the shearing box, isothermal and
    without viscosity or resistivity; whether the run carries the gravity
    field they need is solvers/step.py require_slice's test."""
    reasons = []
    if params.dim != 3 or not params.mhd:
        reasons.append("only 3D MHD")
    if params.riemann_solver != RiemannSolver.HLLD:
        reasons.append(f"riemannSolver {params.riemann_solver.name} (HLLD only)")
    if params.mag_riemann_solver != MagneticRiemannSolver.MAG_HLLD:
        reasons.append(f"magRiemannSolver {params.mag_riemann_solver.name} (HLLD only)")
    if params.gravity_x or params.gravity_y or params.gravity_z:
        reasons.append("static gravity")
    if uses_shear(params):
        bts = params.boundary_types
        if bts[:2] != (BCT.BC_SHEARINGBOX, BCT.BC_SHEARINGBOX):
            reasons.append("a shearing box needs both x faces BC_SHEARINGBOX")
        if uses_stratified_z(params):
            if bts[2:4] != (BCT.BC_PERIODIC, BCT.BC_PERIODIC) or bts[4] != bts[5]:
                reasons.append("stratified z needs both z faces BC_Z_STRATIFIED and periodic y")
            if params.c_iso <= 0:
                reasons.append("stratified z faces with the adiabatic EOS (cIso = 0)")
            if params.nu > 0 or params.eta > 0:
                reasons.append("viscosity or resistivity with stratified z faces")
        elif any(b != BCT.BC_PERIODIC for b in bts[2:]):
            reasons.append("a shearing box with non-periodic y or z faces")
        if params.omega0 <= 0:
            reasons.append("a shearing box without rotation (omega0 = 0)")
        if params.ghost_width != SLAB or params.nx < 2 * SLAB:
            reasons.append(f"ghost width {params.ghost_width}, nx {params.nx} "
                           f"(the shear mode needs 3 and nx >= 6)")
    else:
        if params.omega0 > 0:
            reasons.append("rotating frame (omega0 > 0) without a shearing box")
        if params.c_iso > 0:
            reasons.append("isothermal EOS (cIso > 0) outside the shearing box")
    if reasons:
        raise NotImplementedError("not ported: " + "; ".join(reasons))
    if not uses_shear(params):
        require_periodic(params)


class MhdStepKernel:
    """``kernel(params, S, dt, active, scratch, shear=None)`` advances S by
    one step in place when the 0-d bool ``active`` is true, and returns S
    ([8, nz, ny, nx], or [16, ...] with its Kahan carry when compensated).
    ``dt`` is a 0-d tensor of S's dtype on S's device. A shearing-box
    state passes ``shear=(slabs, planes)``: the sheared ghost slabs
    [2, 8, nz, ny, 3] it reads and the planes [5, nz, ny] it writes; a
    stratified one ``shear=(slabs, planes, zslabs, gz)`` with the z ghost
    slabs [2, 8, 3, ny, nx + 6] and g_z of each row [nz + 6]. On a CPU
    tensor the twin runs; on a CUDA tensor the kernel launches."""

    def __init__(self) -> None:
        self.launches = 0

    @staticmethod
    def scratch(params: RunParams, S: torch.Tensor) -> torch.Tensor | None:
        """The stage buffer for S's shape and device (None on the CPU)."""
        if S.device.type == "cpu":
            return None
        size = MhdStepKernel.scratch_size(load_library("cuda"), params)
        return torch.empty(size, dtype=S.dtype, device=S.device)

    def __call__(self, params, S, dt, active, scratch=None, shear=None) -> torch.Tensor:
        require_step_scope(params)
        check_state(params, S)
        for name, x, dtype in (("dt", dt, S.dtype), ("active", active, torch.bool)):
            if x.shape != () or x.dtype != dtype or x.device != S.device:
                raise ValueError(
                    f"{name} must be a 0-d {dtype} tensor on {S.device}, "
                    f"got {tuple(x.shape)} {x.dtype} on {x.device}"
                )
        if (shear is not None) != uses_shear(params):
            raise ValueError("shear=(slabs, planes) is given exactly for a shearing-box state")
        zslabs = gz = None
        if shear is not None:
            strat = uses_stratified_z(params)
            if len(shear) != (4 if strat else 2):
                raise ValueError("a stratified state passes shear=(slabs, planes, zslabs, gz), "
                                 "another shearing-box state shear=(slabs, planes)")
            slabs, planes = shear[:2]
            check_buffer(S, "slabs", slabs, (2, 8, params.nz, params.ny, SLAB))
            check_plane(params, S, "planes", planes, (NPLANE,))
            if strat:
                zslabs, gz = shear[2:]
                check_buffer(S, "zslabs", zslabs, zslab_shape(params))
                check_buffer(S, "gz", gz, (params.nz + 2 * SLAB,))
        if S.device.type == "cpu":
            if shear is None:
                S.copy_(torch.where(active, mhd_3d_periodic_update(params, S, dt), S))
            else:
                S_new, planes_new = mhd_3d_shear_update(params, S, slabs, dt, zslabs, gz)
                S.copy_(torch.where(active, S_new, S))
                planes.copy_(torch.where(active, planes_new, planes))
            return S
        if S.device.type != "cuda":
            raise ValueError(f"unsupported device {S.device}")
        lib = load_library("cuda")
        need = self.scratch_size(lib, params)
        if (scratch is None or scratch.device != S.device or scratch.dtype != S.dtype
                or scratch.numel() < need or not scratch.is_contiguous()):
            raise ValueError(f"scratch must be a contiguous {S.dtype} buffer of "
                             f">= {need} values on {S.device} (MhdStepKernel.scratch)")
        tail = (dt.data_ptr(), active.data_ptr(), int(params.compensated), params.nx, params.ny,
                params.nz, param_block(params), torch.cuda.current_stream(S.device).cuda_stream)
        if shear is None:
            err = getattr(lib, _FN[S.dtype])(S.data_ptr(), scratch.data_ptr(), *tail)
        else:
            err = getattr(lib, _FN_SHEAR[S.dtype])(
                S.data_ptr(), scratch.data_ptr(), slabs.data_ptr(), planes.data_ptr(),
                None if zslabs is None else zslabs.data_ptr(),
                None if gz is None else gz.data_ptr(), *tail)
        if err:
            raise RuntimeError(f"mhd_step launch failed: CUDA error {err}")
        self.launches += 1
        return S

    @staticmethod
    def scratch_size(lib, params: RunParams) -> int:
        if uses_shear(params):
            return lib.ramses_mhd_step_shear_scratch(params.nx, params.ny, params.nz,
                                                     int(uses_stratified_z(params)))
        return lib.ramses_mhd_step_scratch_per_cell() * params.nx * params.ny * params.nz


def scratch_fluxes(params: RunParams, scratch: torch.Tensor):
    """The face fluxes (x, y, z; [5, ...] each) and edge EMFs (z, y, x) the
    last launch left in its stage buffer, on the stage grid, and the
    (x0, z0) offset of the state's first cell there: the inputs of the
    update stage, for holding it against the twin's update
    (solvers/godunov_mhd.py mhd_apply_update) on the same fluxes."""
    shear, strat = uses_shear(params), uses_stratified_z(params)
    x0, z0 = (2 if shear else 0), (2 if strat else 0)   # csrc/mhd_step.cu XH, ZH
    grid = (params.nz + 2 * z0, params.ny, params.nx + 2 * x0)
    ne = grid[0] * grid[1] * grid[2]
    base = (8 + 3 + 18 * 8) * ne   # after Q, E and the 18 face / edge states
    fl = scratch[base:base + 15 * ne].view(3, 5, *grid)
    emf = scratch[base + 15 * ne:base + 18 * ne].view(3, *grid)
    return tuple(fl), tuple(emf), x0, z0


def zslab_shape(params: RunParams) -> tuple:
    """The stratified z ghost slabs: [2 (ZMIN, ZMAX), 8, 3 rows, ny, nx + 6]."""
    return (2, 8, SLAB, params.ny, params.nx + 2 * SLAB)


def check_buffer(S: torch.Tensor, name: str, x: torch.Tensor, want: tuple) -> None:
    """A contiguous tensor of shape ``want``, S's dtype, on S's device."""
    if (tuple(x.shape) != want or x.dtype != S.dtype or x.device != S.device
            or not x.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous {want} {S.dtype} tensor on {S.device}, "
                         f"got {tuple(x.shape)} {x.dtype} on {x.device}")


mhd_step = MhdStepKernel()
