"""The viscous and resistive sub-step of 3D MHD: the CUDA kernel
``csrc/dissip_step.cu`` and its plain PyTorch twins, in three modes.

- Periodic: replaces the TPU kernels ramsesgpu_tpu/pallas/fused_dissip3d.py:51
  ``make_fused_mhd_dissipation`` and the dissipative second launch of
  the packed-io loop (pallas/fused_mhd3d.py:351-373). Twin:
  ``solvers.dissipation.mhd_dissipation_periodic_update``.
- Shearing box: replaces the MRI loop's dissipative sub-step
  (pallas/shear_packed.py:917) with the border strip's mode "dissip". It
  reads the sheared x ghost slabs at t + dt, built from the post-Godunov
  state, and updates the kept Bx face by the resistive CT. On a stratified
  box (isothermal) it reads the z ghost slabs of that block too, built in
  the same slab launch (kernels/shear_border.py ``shear_slabs(...,
  zout=)``), where the periodic box wraps in z. Twins:
  ``solvers.dissipation.mhd_dissipation_shear_update`` and
  ``kept_face_resistive_ct``.
- Ghosted (``DissipStepKernel.ghosted_``; walls and the jet): a ghosted
  state whose ghosts the fill after the Godunov step has written, updated
  in place with the JAX whole-array step's semantics (its interior, and
  the resistive CT's B on the max-side face layer) through a buffer that
  the kernel writes and the wrapper copies back. Replaces the TPU kernel
  above on the ghosted array of the walled step (pallas/fused_mhd3d.py:
  545-547), and on the refilled block of each rank of a sharded run
  (``interior_only``: the interior alone copied back, shearing-box blocks
  included; JAX parallel/sharded_step.py:276-283, 567-574). Twin:
  ``solvers.dissipation.mhd_dissipation_ghosted_update``.

Compensated (``[implementation] compensated``): the state is [16, nz, ny,
nx] (the state, then its Kahan carry) and a shearing box's kept face [2,
nz, ny]; each channel's whole increment (B's the resistive CT delta) is
Kahan-added (the compensated form of dissipation.py:357-380).

The kernel reads the interior-only state S [8, nz, ny, nx] and writes the
new state into another buffer S_out of S's shape, every channel: one
launch, whose intermediates stay in shared memory (a block reads the old
values of its neighbours' cells, so it cannot update S in place). The
loops hand it the step's other state buffer.
"""
from __future__ import annotations

import ctypes

import torch

from ..config.params import RunParams
from ..core.constants import IA
from ..solvers.dissipation import (kept_face_resistive_ct, mhd_dissipation_ghosted_update,
                                   mhd_dissipation_periodic_update, mhd_dissipation_shear_update)
from ..solvers.stratified import uses_stratified_z
from .build import load_library, param_block
from .cfl_mhd import check_ghosted, check_plane, check_state, kept_lead
from .hydro_step import check_scalars
from .mhd_step import SLAB, check_buffer, require_step_scope, uses_shear, zslab_shape

_FN = {torch.float32: "ramses_dissip_step_f32", torch.float64: "ramses_dissip_step_f64"}
_FN_STRAT = {torch.float32: "ramses_dissip_step_strat_f32",
             torch.float64: "ramses_dissip_step_strat_f64"}
_FN_GHOSTED = {torch.float32: "ramses_dissip_step_ghosted_f32",
               torch.float64: "ramses_dissip_step_ghosted_f64"}


class DissipStepKernel:
    """``kernel(params, S, S_out, dt, active, shear=None)`` writes the
    dissipative sub-step of S into S_out (another tensor of S's shape) when
    the 0-d bool ``active`` is true, else S itself, and returns S_out. ``dt``
    is a 0-d tensor of S's dtype on S's device. A shearing-box state passes
    ``shear=(slabs, kept)``: the sheared ghost slabs [2, 8, nz, ny, 3] it
    reads, whose XMAX slab's first Bx column holds the kept face, and the
    kept face [nz, ny] ([2, nz, ny] with its carry when compensated) it
    updates in place when eta > 0; a stratified one ``shear=(slabs, kept,
    zslabs)`` with the z ghost slabs [2, 8, 3, ny, nx + 6]. On a CPU tensor
    the twin runs; on a CUDA tensor the kernel launches."""

    def __init__(self) -> None:
        self.launches = 0
        self.ghosted_launches = 0   # those of the ghosted mode, among launches

    def __call__(self, params, S, S_out, dt, active, shear=None) -> torch.Tensor:
        require_step_scope(params)
        if not (params.nu > 0 or params.eta > 0):
            raise ValueError("the dissipation kernel needs nu > 0 or eta > 0")
        check_state(params, S)
        check_state(params, S_out)
        if S_out.dtype != S.dtype or S_out.device != S.device:
            raise ValueError(f"S_out must be a {S.dtype} tensor on {S.device}")
        if S_out.data_ptr() == S.data_ptr():
            raise ValueError("S_out must be another buffer than S")
        for name, x, dtype in (("dt", dt, S.dtype), ("active", active, torch.bool)):
            if x.shape != () or x.dtype != dtype or x.device != S.device:
                raise ValueError(
                    f"{name} must be a 0-d {dtype} tensor on {S.device}, "
                    f"got {tuple(x.shape)} {x.dtype} on {x.device}"
                )
        if (shear is not None) != uses_shear(params):
            raise ValueError("shear=(slabs, kept) is given exactly for a shearing-box state")
        zslabs = None
        if shear is not None:
            strat = uses_stratified_z(params)
            if len(shear) != (3 if strat else 2):
                raise ValueError("a stratified state passes shear=(slabs, kept, zslabs), "
                                 "another shearing-box state shear=(slabs, kept)")
            slabs, kept = shear[:2]
            check_buffer(S, "slabs", slabs, (2, 8, params.nz, params.ny, SLAB))
            check_plane(params, S, "kept", kept, kept_lead(params))
            if strat:
                zslabs = shear[2]
                check_buffer(S, "zslabs", zslabs, zslab_shape(params))
        if S.device.type == "cpu":
            if shear is None:
                S_out.copy_(torch.where(active, mhd_dissipation_periodic_update(params, S, dt), S))
            else:
                S_new, eypl, ezpl = mhd_dissipation_shear_update(params, S, slabs, dt, zslabs)
                S_out.copy_(torch.where(active, S_new, S))
                if params.eta > 0:
                    # the face's old value: the XMAX slab's first Bx column
                    face = slabs[1, IA, ..., 0]
                    old = torch.stack([face, kept[1]]) if params.compensated else face
                    kept_new = kept_face_resistive_ct(params, old, eypl, ezpl, dt)
                    kept.copy_(torch.where(active, kept_new, kept))
            return S_out
        if S.device.type != "cuda":
            raise ValueError(f"unsupported device {S.device}")
        lib = load_library("cuda")
        slab_ptr, kept_ptr = (None, None) if shear is None else (slabs.data_ptr(),
                                                                  kept.data_ptr())
        zslab = () if zslabs is None else (zslabs.data_ptr(),)
        err = getattr(lib, (_FN if zslabs is None else _FN_STRAT)[S.dtype])(
            S.data_ptr(), S_out.data_ptr(), slab_ptr, kept_ptr, *zslab, dt.data_ptr(),
            active.data_ptr(), int(params.compensated), params.nx, params.ny, params.nz,
            param_block(params), torch.cuda.current_stream(S.device).cuda_stream)
        if err:
            raise RuntimeError(f"dissip_step launch failed: CUDA error {err}")
        self.launches += 1
        return S_out

    @staticmethod
    def scratch(params: RunParams, U: torch.Tensor):
        """The ghosted mode's output buffer for U's dtype and device: the
        cube [8, nz+1, ny+1, nx+1] (None on the CPU)."""
        if U.device.type == "cpu":
            return None
        return U.new_empty((8, params.nz + 1, params.ny + 1, params.nx + 1))

    def ghosted_(self, params: RunParams, U, dt, active, buf=None,
                 interior_only: bool = False) -> torch.Tensor:
        """The dissipative sub-step of the ghosted state U [8, nz+2g, ny+2g,
        nx+2g], whose ghosts must be filled, in place when ``active``: its
        interior and, with eta > 0, the resistive CT's B on the max-side
        face layer (the whole-array step's); the other ghosts stay. On a
        CUDA tensor the kernel writes them into ``buf`` (``scratch``), which
        is copied back into U. ``interior_only``: a sharded rank's block
        (JAX sharded_step.py:282-283, 572-574): the interior alone is
        written back and every ghost stays that of the fill; a
        shearing-box block, whose sheared fill has filled it, is taken
        only so. Returns U."""
        require_step_scope(params)
        if not (params.nu > 0 or params.eta > 0):
            raise ValueError("the dissipation kernel needs nu > 0 or eta > 0")
        if uses_shear(params) and not interior_only:
            raise NotImplementedError("the ghosted mode takes a shearing-box block with "
                                      "interior_only=True (a sharded rank's) only")
        check_ghosted(params, U)
        check_scalars(U, dt=(dt, U.dtype), active=(active, torch.bool))
        g, nx, ny, nz = params.ghost_width, params.nx, params.ny, params.nz
        inner = U[:, g:g + nz, g:g + ny, g:g + nx]
        if U.device.type == "cpu":
            new = mhd_dissipation_ghosted_update(params, U, dt)
            if interior_only:
                inner.copy_(torch.where(active, new[:, g:g + nz, g:g + ny, g:g + nx], inner))
            else:
                U.copy_(torch.where(active, new, U))
            return U
        if U.device.type != "cuda":
            raise ValueError(f"unsupported device {U.device}")
        if buf is None:
            raise ValueError("the ghosted mode needs its buffer (DissipStepKernel.scratch)")
        check_buffer(U, "buf", buf, (8, nz + 1, ny + 1, nx + 1))
        err = getattr(load_library("cuda"), _FN_GHOSTED[U.dtype])(
            U.data_ptr(), buf.data_ptr(), dt.data_ptr(), active.data_ptr(), nx, ny, nz, g,
            param_block(params), torch.cuda.current_stream(U.device).cuda_stream)
        if err:
            raise RuntimeError(f"dissip_step ghosted launch failed: CUDA error {err}")
        self.launches += 1
        self.ghosted_launches += 1
        inner.copy_(buf[:, :nz, :ny, :nx])
        if params.eta > 0 and not interior_only:
            U[5:, g:g + nz + 1, g:g + ny + 1, g:g + nx + 1].copy_(buf[5:])
        return U


def launch_info(lib, params: RunParams, dtype: torch.dtype) -> dict:
    """The kernel's launch for a run's mode: its tile's x and y extent, the
    threads and ring bytes of a block, the registers of a thread and the
    blocks an SM holds (the last two 0 in the host build)."""
    out = (ctypes.c_longlong * 6)()
    err = lib.ramses_dissip_step_launch(int(dtype == torch.float64), int(uses_shear(params)),
                                        int(params.c_iso > 0), int(params.compensated), out)
    if err:
        raise RuntimeError(f"dissip_step launch query failed: CUDA error {err}")
    return dict(zip(("tx", "ty", "threads", "ring_bytes", "registers", "blocks_per_sm"), out))


dissip_step = DissipStepKernel()
