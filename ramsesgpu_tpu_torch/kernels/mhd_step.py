"""One 3D MHD+CT step: the CUDA kernel ``csrc/mhd_step.cu`` and its plain
PyTorch twins, in five modes.

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

- Ghosted (``MhdStepKernel.ghosted``): a ghosted state [8, nz+2g, ny+2g,
  nx+2g] whose ghosts a fill has written, for any mix of DIRICHLET /
  NEUMANN / PERIODIC faces and the inflow jet, updated in place with the
  JAX whole-array step's semantics: its interior, and the CT curl of the
  max-side face layer n+g. Replaces the TPU kernel
  pallas/fused_mhd3d.py:80 ``make_fused_mhd_update`` (whose interior is
  this one's). Twin: ``solvers.godunov_mhd.mhd_3d_ghosted_update``. A
  uniform static gravity ([gravity] static_field_*) runs its gravity
  instance (the kick of every traced state and the conservative source,
  the vector from the parameter block); every MHD run with such a gravity
  outside a shearing box takes this mode (``uses_ghosted``).

- Shear window (``MhdWindowKernel``, ``mhd_window``): one rank's ghosted
  block of the sharded shearing box, its ghosts written by the halo
  exchange and the sheared x fill (parallel/shear_dist.py), stepped in the
  rotating frame out of place: the new interior and the five x-face
  planes of the remap. Replaces the TPU kernel pallas/fused_mhd3d.py:587
  ``make_fused_mhd_shear`` (TPU row 4). Twin:
  ``solvers.godunov_mhd.mhd_3d_shear_window_update``.

Isothermal (cIso > 0): the periodic and ghosted modes run their
isothermal instances (the solvers' gas pressure rho cIso^2), chosen in
the launch from the parameter block; the shear modes read it from there
too.

Compensated (``[implementation] compensated``, the periodic and shear
modes; TPU row A′-compensated, fused_mhd3d.py:247-259): the state is [16,
nz, ny, nx], the state and then its Kahan carry, and the update stage
Kahan-adds each channel's increment. The ghosted mode has no compensated
form: the JAX package's walled step has none either.

The kernel updates the interior-only state [8, nz, ny, nx] in place. Its
stage intermediates live in one scratch buffer of 77 values per
stage-grid cell (~5.2 GB at 256^3 f32; the shearing box's stage grid has
nx + 4 columns, the stratified one nz + 4 rows too, and 85 values a cell;
the ghosted mode's is the ghosted array, ~5.5 GB at 256^3) that the
caller allocates once per advance with ``MhdStepKernel.scratch``
(``ghosted=True`` for the ghosted mode); the shear window mode's stage
grid is the interior and 2 cells a side (``MhdWindowKernel.scratch``,
~0.37 GB for a 64x128x128 f32 block).
"""
from __future__ import annotations

import torch

from ..config.params import RunParams, static_gravity
from ..core.constants import BoundaryConditionType as BCT
from ..ops.riemann_mhd import check_solvers

from ..solvers.boundary import require_simple_bcs, uses_jet
from ..solvers.godunov import gravity_vector
from ..solvers.godunov_mhd import (mhd_3d_ghosted_update, mhd_3d_periodic_update,
                                   mhd_3d_shear_update, mhd_3d_shear_window_update)
from ..solvers.stratified import uses_stratified_z
from .build import load_library, param_block, window_block
from .cfl_mhd import check_ghosted, check_plane, check_state
from .hydro_step import check_scalars

_FN = {torch.float32: "ramses_mhd_step_f32", torch.float64: "ramses_mhd_step_f64"}
_FN_GHOSTED = {torch.float32: "ramses_mhd_step_ghosted_f32",
               torch.float64: "ramses_mhd_step_ghosted_f64"}
_FN_SHEAR = {torch.float32: "ramses_mhd_step_shear_f32",
             torch.float64: "ramses_mhd_step_shear_f64"}
_FN_WINDOW = {torch.float32: "ramses_mhd_step_window_f32",
              torch.float64: "ramses_mhd_step_window_f64"}
SLAB = 3     # columns of each sheared ghost slab (csrc/mhd_step.cu SLAB)
NPLANE = 5   # x-face planes of the shearing-box mode
NPRE = 48    # precursors of the traced states per stage-grid cell (csrc/mhd_stages.cuh)


def uses_shear(params: RunParams) -> bool:
    return BCT.BC_SHEARINGBOX in (params.boundary_xmin, params.boundary_xmax)


def uses_ghosted(params: RunParams) -> bool:
    """Whether an MHD run without a shearing box takes the ghosted step:
    a face that is not periodic, the inflow jet, or a uniform static
    gravity (the ghosted mode's gravity instance; the JAX package runs
    every such field on its whole-array step)."""
    return (not uses_shear(params)
            and (uses_jet(params) or static_gravity(params) is not None
                 or any(b != BCT.BC_PERIODIC for b in params.boundary_types)))


def require_step_scope(params: RunParams) -> None:
    """Raise NotImplementedError for what the step kernels (this one and,
    with nu > 0 or eta > 0, kernels/dissip_step.py) do not compute.
    ``[implementation] stripFused`` is accepted with every value: the
    port's shear path has no border strip (kernels/shear.py). Stratified z
    faces (BC_Z_STRATIFIED) are taken on the shearing box, isothermal and
    without viscosity or resistivity; whether the run carries the gravity
    field they need is solvers/step.py require_slice's test. Without a
    shearing box any mix of DIRICHLET / NEUMANN / PERIODIC faces and the
    jet are taken, adiabatic or isothermal (cIso > 0: the isothermal
    instances of the periodic and ghosted modes), ideal or viscous and
    resistive (walls and the jet: the dissipation kernel's ghosted mode),
    with or without a uniform static gravity (the ghosted mode's gravity
    instance)."""
    reasons = []
    if params.dim != 3 or not params.mhd:
        reasons.append("only 3D MHD")
    else:
        check_solvers(params)
    if uses_shear(params):
        if static_gravity(params) is not None:
            reasons.append("a uniform static gravity in a shearing box")
        bts = params.boundary_types
        if bts[:2] != (BCT.BC_SHEARINGBOX, BCT.BC_SHEARINGBOX):
            reasons.append("a shearing box needs both x faces BC_SHEARINGBOX")
        if uses_stratified_z(params):
            if bts[2:4] != (BCT.BC_PERIODIC, BCT.BC_PERIODIC) or bts[4] != bts[5]:
                reasons.append("stratified z needs both z faces BC_Z_STRATIFIED and periodic y")
            if params.c_iso <= 0:
                reasons.append("stratified z faces with the adiabatic EOS (cIso = 0)")
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
    if reasons:
        raise NotImplementedError("not ported: " + "; ".join(reasons))
    if not uses_shear(params):
        require_simple_bcs(params)


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
        self.ghosted_launches = 0   # those of the ghosted mode, among launches

    @staticmethod
    def scratch(params: RunParams, S: torch.Tensor, ghosted: bool = False
                ) -> torch.Tensor | None:
        """The stage buffer for S's shape and device (None on the CPU);
        ``ghosted``: the ghosted mode's."""
        if S.device.type == "cpu":
            return None
        size = MhdStepKernel.scratch_size(load_library("cuda"), params, ghosted)
        return torch.empty(size, dtype=S.dtype, device=S.device)

    def __call__(self, params, S, dt, active, scratch=None, shear=None) -> torch.Tensor:
        require_step_scope(params)
        if uses_ghosted(params):
            raise ValueError("a walled or jet state steps through MhdStepKernel.ghosted")
        check_state(params, S)
        check_scalars(S, dt=(dt, S.dtype), active=(active, torch.bool))
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
        lib = self._cuda_lib(S, self.scratch_size, params, scratch, False)
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

    def ghosted(self, params: RunParams, U: torch.Tensor, dt: torch.Tensor,
                active: torch.Tensor, scratch=None) -> torch.Tensor:
        """One step of the ghosted state U [8, nz+2g, ny+2g, nx+2g], whose
        ghosts must be filled, in place when ``active``: the interior and
        the CT face layer n+g (see the module note); returns U. A
        compensated run takes this plain update, as the JAX package's
        walled step does. ``scratch``: ``MhdStepKernel.scratch(params, U,
        ghosted=True)``."""
        require_step_scope(params)
        if uses_shear(params):
            raise NotImplementedError("the ghosted mode covers runs without a shearing box")
        check_ghosted(params, U)
        check_scalars(U, dt=(dt, U.dtype), active=(active, torch.bool))
        if U.device.type == "cpu":
            U.copy_(torch.where(
                active, mhd_3d_ghosted_update(params, U, dt, gravity_vector(params, U)), U))
            return U
        lib = self._cuda_lib(U, self.scratch_size, params, scratch, True)
        err = getattr(lib, _FN_GHOSTED[U.dtype])(
            U.data_ptr(), scratch.data_ptr(), dt.data_ptr(), active.data_ptr(), params.nx,
            params.ny, params.nz, params.ghost_width, param_block(params),
            torch.cuda.current_stream(U.device).cuda_stream)
        if err:
            raise RuntimeError(f"mhd_step ghosted launch failed: CUDA error {err}")
        self.launches += 1
        self.ghosted_launches += 1
        return U

    @staticmethod
    def _cuda_lib(S, size, params, scratch, ghosted: bool):
        """The CUDA library, after checking S's device and the scratch."""
        if S.device.type != "cuda":
            raise ValueError(f"unsupported device {S.device}")
        lib = load_library("cuda")
        need = size(lib, params, ghosted)
        if (scratch is None or scratch.device != S.device or scratch.dtype != S.dtype
                or scratch.numel() < need or not scratch.is_contiguous()):
            raise ValueError(f"scratch must be a contiguous {S.dtype} buffer of "
                             f">= {need} values on {S.device} (MhdStepKernel.scratch)")
        return lib

    @staticmethod
    def scratch_size(lib, params: RunParams, ghosted: bool = False) -> int:
        if ghosted:
            return lib.ramses_mhd_step_ghosted_scratch(params.nx, params.ny, params.nz,
                                                       params.ghost_width)
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
    base = (8 + 3 + NPRE) * ne   # after Q, E and the precursors
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


def require_window_scope(params: RunParams) -> None:
    """Raise NotImplementedError for what the shear window mode does not
    compute: it is the ideal rotating-frame 3D MHD step (any face and
    corner solver pair, ops/riemann_mhd.py check_solvers), isothermal or
    adiabatic, on a window of ghost width 3; with g_z (stratified) only
    isothermal."""
    reasons = []
    if params.dim != 3 or not params.mhd:
        reasons.append("only 3D MHD")
    else:
        check_solvers(params)
    if params.omega0 <= 0:
        reasons.append("no rotating frame (omega0 = 0)")
    if params.ghost_width != SLAB:
        reasons.append(f"ghost width {params.ghost_width} (3 only)")
    if params.nu > 0 or params.eta > 0:
        reasons.append("viscosity or resistivity")
    if reasons:
        raise NotImplementedError("not ported: " + "; ".join(reasons))


class MhdWindowKernel:
    """``out, planes = kernel(params, U, dt, x0, gz=None, scratch=None)``:
    one rotating-frame step of the ghosted window U [8, nz+2g, ny+2g,
    nx+2g] (``params``: the window's extent; its ghosts filled), out of
    place: the new interior [8, nz, ny, nx] and the planes [5, nz, ny]
    (fpl_min, fpl_max, eypl_min, eypl_max, ezpl_max, unremapped). ``dt``
    is a 0-d tensor of U's dtype on its device, ``x0`` the window's global
    x offset, ``gz`` g_z of its rows [nz + 2g] (stratified, isothermal) or
    None. On a CPU tensor the twin runs; on a CUDA tensor the kernel
    launches (TPU row 4)."""

    def __init__(self) -> None:
        self.launches = 0
        self._true = {}  # a 0-d true flag per device (the stages' ``active``)

    @staticmethod
    def scratch(params: RunParams, U: torch.Tensor) -> torch.Tensor | None:
        """The stage buffer for the window's extent on U's device (None on
        the CPU)."""
        if U.device.type == "cpu":
            return None
        size = load_library("cuda").ramses_mhd_step_window_scratch(params.nx, params.ny,
                                                                   params.nz)
        return torch.empty(size, dtype=U.dtype, device=U.device)

    def __call__(self, params: RunParams, U: torch.Tensor, dt: torch.Tensor, x0: float,
                 gz: torch.Tensor | None = None, scratch=None):
        require_window_scope(params)
        check_ghosted(params, U)
        check_scalars(U, dt=(dt, U.dtype))
        if gz is not None:
            if params.c_iso <= 0:
                raise NotImplementedError("g_z with the adiabatic EOS (cIso = 0)")
            check_buffer(U, "gz", gz, (params.nz + 2 * SLAB,))
        if U.device.type == "cpu":
            return mhd_3d_shear_window_update(params, U, dt, x0, gz)
        if U.device.type != "cuda":
            raise ValueError(f"unsupported device {U.device}")
        lib = load_library("cuda")
        need = lib.ramses_mhd_step_window_scratch(params.nx, params.ny, params.nz)
        if (scratch is None or scratch.device != U.device or scratch.dtype != U.dtype
                or scratch.numel() < need or not scratch.is_contiguous()):
            raise ValueError(f"scratch must be a contiguous {U.dtype} buffer of >= {need} "
                             f"values on {U.device} (MhdWindowKernel.scratch)")
        if U.device not in self._true:
            self._true[U.device] = torch.ones((), dtype=torch.bool, device=U.device)
        out = torch.empty((8, params.nz, params.ny, params.nx), dtype=U.dtype, device=U.device)
        planes = torch.empty((NPLANE, params.nz, params.ny), dtype=U.dtype, device=U.device)
        err = getattr(lib, _FN_WINDOW[U.dtype])(
            U.data_ptr(), out.data_ptr(), planes.data_ptr(), scratch.data_ptr(),
            None if gz is None else gz.data_ptr(), dt.data_ptr(),
            self._true[U.device].data_ptr(), params.nx, params.ny, params.nz,
            params.ghost_width, window_block(params, x0),
            torch.cuda.current_stream(U.device).cuda_stream)
        if err:
            raise RuntimeError(f"mhd_step window launch failed: CUDA error {err}")
        self.launches += 1
        return out, planes


mhd_step = MhdStepKernel()
mhd_window = MhdWindowKernel()
