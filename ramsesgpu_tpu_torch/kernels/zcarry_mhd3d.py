"""One 3D MHD+CT step streamed over z (``[implementation] kernel=zcarry``):
the CUDA kernel ``csrc/zcarry_mhd.cu`` and its plain PyTorch twin.

Replaces the TPU kernel ramsesgpu_tpu/pallas/zcarry_mhd3d.py:102
``make_zcarry_mhd_packed_io``: the step of kernels/mhd_step.py (periodic,
shearing-box and stratified modes, plain or compensated, adiabatic or
isothermal, any face and corner solver pair) in one launch,
with no stage buffer that grows with the grid: its intermediates live in
a ring of z planes per block in shared memory. It reads S and
writes the new state into a second buffer. In the periodic mode it also
reduces the next step's inverse dt over the new state (the JAX kernel's
``with_inv_dt``; the loops fold it where there is no dissipation). Twin:
the step's twin (solvers/godunov_mhd.py) and, folded,
``solvers.timestep.inv_dt_mhd_periodic`` on its result.
"""
from __future__ import annotations

import torch

from ..config.params import RunParams
from ..solvers.godunov_mhd import mhd_3d_periodic_update, mhd_3d_shear_update
from ..solvers.stratified import uses_stratified_z
from ..solvers.timestep import inv_dt_mhd_periodic
from .build import load_library, param_block
from .cfl_mhd import check_plane, check_state
from .mhd_step import NPLANE, SLAB, check_buffer, require_step_scope, uses_shear, zslab_shape

_FN = {torch.float32: "ramses_zcarry_mhd_f32", torch.float64: "ramses_zcarry_mhd_f64"}


class ZcarryMhdKernel:
    """``inv = kernel(params, S, S_out, dt, active, shear=None, fold=False)``
    writes one step of S into S_out (another buffer of S's
    shape) when the 0-d bool ``active`` is true, else a copy of S. ``shear``
    as kernels/mhd_step.py's (the slabs it reads, the planes it writes).
    With ``fold`` (periodic mode) it returns the 0-d inverse dt of S_out,
    else None. On a CPU tensor the twin runs; on a CUDA tensor the kernel
    launches."""

    def __init__(self) -> None:
        self.launches = 0
        # (device, dtype, shear, stratified, isothermal, solvers) -> blocks
        self._blocks = {}

    def blocks(self, params: RunParams, S: torch.Tensor) -> int:
        """The persistent grid of S's mode and dtype: as many blocks as the
        card holds at once (asked once per device, dtype, mode and solver
        pair: another pair than HLLD / 2D-HLLD runs the general instance)."""
        shear, strat = uses_shear(params), uses_stratified_z(params)
        key = (S.device, S.dtype, shear, strat, params.c_iso > 0, params.riemann_solver,
               params.mag_riemann_solver)
        if key not in self._blocks:
            blocks = load_library("cuda").ramses_zcarry_mhd_blocks(
                int(shear), int(strat), int(S.dtype == torch.float64), param_block(params))
            if blocks <= 0:
                raise RuntimeError(f"zcarry_mhd occupancy query failed: CUDA error {-blocks}")
            self._blocks[key] = blocks
        return self._blocks[key]

    def __call__(self, params, S, S_out, dt, active, shear=None, fold=False):
        require_step_scope(params)
        check_state(params, S)
        check_buffer(S, "S_out", S_out, tuple(S.shape))
        if S_out.data_ptr() == S.data_ptr():
            raise ValueError("S_out must be another buffer than S")
        for name, x, dtype in (("dt", dt, S.dtype), ("active", active, torch.bool)):
            if x.shape != () or x.dtype != dtype or x.device != S.device:
                raise ValueError(f"{name} must be a 0-d {dtype} tensor on {S.device}, "
                                 f"got {tuple(x.shape)} {x.dtype} on {x.device}")
        shearing = uses_shear(params)
        if (shear is not None) != shearing:
            raise ValueError("shear=(slabs, planes) is given exactly for a shearing-box state")
        if fold and shearing:
            raise ValueError("the shearing-box modes keep their CFL launch (no fold)")
        slabs = planes = zslabs = gz = None
        if shearing:
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
            if shearing:
                S_new, planes_new = mhd_3d_shear_update(params, S, slabs, dt, zslabs, gz)
                planes.copy_(torch.where(active, planes_new, planes))
            else:
                S_new = mhd_3d_periodic_update(params, S, dt)
            S_out.copy_(torch.where(active, S_new, S))
            return inv_dt_mhd_periodic(params, S_out[:8]) if fold else None
        if S.device.type != "cuda":
            raise ValueError(f"unsupported device {S.device}")
        inv = torch.empty((), dtype=S.dtype, device=S.device) if fold else None

        def ptr(x):
            return None if x is None else x.data_ptr()

        err = getattr(load_library("cuda"), _FN[S.dtype])(
            S.data_ptr(), S_out.data_ptr(), self.blocks(params, S), ptr(slabs), ptr(planes),
            ptr(zslabs), ptr(gz), ptr(inv), dt.data_ptr(), active.data_ptr(),
            int(params.compensated), params.nx, params.ny, params.nz, param_block(params),
            torch.cuda.current_stream(S.device).cuda_stream)
        if err:
            raise RuntimeError(f"zcarry_mhd launch failed: CUDA error {err}")
        self.launches += 1
        return inv


zcarry_mhd = ZcarryMhdKernel()
