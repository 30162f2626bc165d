"""The MHD CFL reduction: the CUDA kernel ``csrc/cfl_mhd.cu`` and its
plain PyTorch twins.

Replaces the TPU kernels ramsesgpu_tpu/pallas/packed_io.py:51
``make_packed_cfl_mhd`` (formula: solvers/timestep.py:114
``_inv_dt_mhd_fields``), twin ``solvers.timestep.inv_dt_mhd_periodic``,
and, given the kept Bx face, pallas/shear_packed.py:716
``make_shear_cfl_kernel`` (shearing box: isothermal or adiabatic, the
rotating frame's vy offset; stratified z faces), twin
``solvers.timestep.inv_dt_mhd_shear``.

Given ``ghost=g``, its ghosted mode reads a ghosted state [8, nz+2g,
ny+2g, nx+2g] as it stands (the walled and jet loops run it before the
fill, as JAX compute_dt runs before make_boundaries): the +1 faces come
from the ghost frame, and the jet's inverse dt is the floor of the max
(solvers/timestep.py:257-262 in the JAX package). Twin:
``solvers.timestep.inv_dt_mhd_ghosted``.

``cfl_mhd_window`` is the ghosted form with the shearing box's pressure
and vy offset, on a rank's ghosted block of the sharded shearing box as it
stands (JAX parallel/sharded_step.py:551-556 compute_inv_dt_mhd on the
block). Twin: ``solvers.timestep.inv_dt_mhd_ghosted_shear``.

The periodic and ghosted modes take the isothermal pressure rho cIso^2
where cIso > 0 (solvers/timestep.py:117-118 of the JAX package): an
instance of their own in the kernel, chosen at launch from the parameter
block, so the adiabatic instances are the ones earlier builds ran.

Each reduction is one launch: the blocks walk whole x rows and the last
block to finish forms the max from the blocks' partials, through a counter
in device memory that it sets back to 0 (``kernels.cfl_rows.workspace``: the
partials and the counter, allocated once per device and dtype).

A compensated state (``[implementation] compensated``) is [16, nz, ny, nx],
the state and then its Kahan carry, and a shearing box's kept face [2, nz,
ny]; the reduction reads channels 0-7 and the face, as the JAX kernel reads
its packed state's first nvar channels (pallas/packed_io.py:190).
"""
from __future__ import annotations

import torch

from ..config.params import RunParams

from ..solvers.timestep import (inv_dt_mhd_ghosted, inv_dt_mhd_ghosted_shear,
                                inv_dt_mhd_periodic, inv_dt_mhd_shear, jet_inv_dt)
from .build import load_library, param_block
from .cfl_rows import workspace

_FN = {torch.float32: "ramses_cfl_mhd_f32", torch.float64: "ramses_cfl_mhd_f64"}
_FN_GHOSTED = {torch.float32: "ramses_cfl_mhd_ghosted_f32",
               torch.float64: "ramses_cfl_mhd_ghosted_f64"}
_FN_SHEAR = {torch.float32: "ramses_cfl_mhd_shear_f32", torch.float64: "ramses_cfl_mhd_shear_f64"}
_FN_GHOSTED_SHEAR = {torch.float32: "ramses_cfl_mhd_ghosted_shear_f32",
                     torch.float64: "ramses_cfl_mhd_ghosted_shear_f64"}


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


def check_ghosted(params: RunParams, U: torch.Tensor) -> None:
    """A ghosted MHD state: a contiguous [8, nz+2g, ny+2g, nx+2g] f32/f64
    tensor."""
    if tuple(U.shape) != params.shape or U.shape[0] != 8:
        raise ValueError(f"ghosted state shape {tuple(U.shape)} != {params.shape}")
    if U.dtype not in _FN:
        raise TypeError(f"state dtype {U.dtype} is not float32/float64")
    if not U.is_contiguous():
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
    """``inv = kernel(params, S, kept=None, ghost=0)``: the 0-d device
    tensor max over cells of the MHD inverse time step; with the kept Bx
    face [nz, ny] ([2, nz, ny] compensated) of a shearing-box state, its
    shearing-box mode; with ``ghost`` = ghost_width, its ghosted mode on a
    ghosted state. On a CPU tensor it returns the twin's value; on a CUDA
    tensor it launches the kernel."""

    def __init__(self) -> None:
        self.launches = 0
        self.ghosted_launches = 0   # those of the ghosted mode, among launches

    def __call__(self, params: RunParams, S: torch.Tensor,
                 kept: torch.Tensor | None = None, ghost: int = 0) -> torch.Tensor:
        if ghost:
            return self._ghosted(params, S, ghost)
        if jet_inv_dt(params) is not None:
            raise NotImplementedError("the jet runs on the ghosted state (ghost=ghost_width)")
        if kept is None and params.omega0 > 0:
            raise NotImplementedError(
                "the periodic CFL covers the non-rotating case; a rotating state "
                "needs the kept face (shearing box)"
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
        work = workspace(lib, S)
        out = torch.empty((), dtype=S.dtype, device=S.device)
        stream = torch.cuda.current_stream(S.device).cuda_stream
        dims = (params.nx, params.ny, params.nz, param_block(params), stream)
        if kept is None:
            err = getattr(lib, _FN[S.dtype])(S.data_ptr(), *work, out.data_ptr(), *dims)
        else:
            err = getattr(lib, _FN_SHEAR[S.dtype])(S.data_ptr(), kept.data_ptr(), *work,
                                                   out.data_ptr(), *dims)
        if err:
            raise RuntimeError(f"cfl_mhd launch failed: CUDA error {err}")
        self.launches += 1
        return out

    def _ghosted(self, params: RunParams, U: torch.Tensor, ghost: int) -> torch.Tensor:
        if ghost != params.ghost_width:
            raise ValueError(f"ghost {ghost} != ghost_width {params.ghost_width}")
        if params.omega0 > 0:
            raise NotImplementedError("the ghosted CFL covers the non-rotating case")
        check_ghosted(params, U)
        if U.device.type == "cpu":
            return inv_dt_mhd_ghosted(params, U)
        if U.device.type != "cuda":
            raise ValueError(f"unsupported device {U.device}")
        lib = load_library("cuda")
        out = torch.empty((), dtype=U.dtype, device=U.device)
        jet = jet_inv_dt(params)
        err = getattr(lib, _FN_GHOSTED[U.dtype])(
            U.data_ptr(), *workspace(lib, U), out.data_ptr(), params.nx, params.ny, params.nz,
            ghost, float("-inf") if jet is None else jet, param_block(params),
            torch.cuda.current_stream(U.device).cuda_stream)
        if err:
            raise RuntimeError(f"cfl_mhd ghosted launch failed: CUDA error {err}")
        self.launches += 1
        self.ghosted_launches += 1
        return out


class CflMhdWindowKernel:
    """``inv = kernel(params, U)``: the 0-d device tensor max inverse time
    step of a rank's ghosted block U [8, nz+2g, ny+2g, nx+2g] of the
    sharded shearing box as it stands (``params``: the block's extent):
    the ghosted shearing-box form of csrc/cfl_mhd.cu, JAX
    compute_inv_dt_mhd(local_params, Ug) (parallel/sharded_step.py:551-556).
    On a CPU tensor it returns the twin's value
    (solvers.timestep.inv_dt_mhd_ghosted_shear); on a CUDA tensor it
    launches the kernel."""

    def __init__(self) -> None:
        self.launches = 0

    def __call__(self, params: RunParams, U: torch.Tensor) -> torch.Tensor:
        if params.omega0 <= 0:
            raise NotImplementedError("the ghosted shearing-box CFL needs the rotating frame")
        check_ghosted(params, U)
        if U.device.type == "cpu":
            return inv_dt_mhd_ghosted_shear(params, U)
        if U.device.type != "cuda":
            raise ValueError(f"unsupported device {U.device}")
        lib = load_library("cuda")
        out = torch.empty((), dtype=U.dtype, device=U.device)
        err = getattr(lib, _FN_GHOSTED_SHEAR[U.dtype])(
            U.data_ptr(), *workspace(lib, U), out.data_ptr(), params.nx, params.ny, params.nz,
            params.ghost_width, param_block(params),
            torch.cuda.current_stream(U.device).cuda_stream)
        if err:
            raise RuntimeError(f"cfl_mhd ghosted shear launch failed: CUDA error {err}")
        self.launches += 1
        return out


cfl_mhd = CflMhdKernel()
cfl_mhd_window = CflMhdWindowKernel()
