"""Operation and byte accounting of the step (the port's counterpart of
ramsesgpu_tpu/utils/flops.py; reference PapiInfo.{h,cpp}, the "total flop
per cell per time step" report at HydroRunGodunov.cpp:4041-4049).

This is not XLA's cost analysis, which has no PyTorch counterpart. The
floating-point operations are those of the kernels the configuration
launches each step, counted by the counting build (kernels/build.py
``build("count")``, csrc/op_count.cuh: a kernel's own per-cell code run
on the state with every operation counted) on a block of at most 32^3 of
the initial state and scaled to the mesh; ``bytes_accessed`` is the bytes
the kernels' roofline bounds move: each input value read once, each
output written once. chip_smoke.py's bounds use the same figures (row A:
2979 flop a cell on the Orszag-Tang state). Counted: the periodic and
walled 3D MHD steps (with the dissipation kernel when nu or eta > 0) and
the 3D hydro step's interior mode, with their CFL reductions.
"""
from __future__ import annotations

import ctypes

import numpy as np

from ..config.params import RunParams

BLOCK = 32  # the counted block's edge


def _block(params: RunParams, config):
    """(block params, the initial interior's corner block as float64, dt
    of the whole initial state by the whole-array CFL)."""
    import torch

    from ..config.configmap import ConfigMap
    from ..problems import init_problem
    from ..solvers.boundary import make_boundaries
    from ..solvers.timestep import compute_dt

    config = config if config is not None else ConfigMap(text="")
    U = make_boundaries(params, torch.from_numpy(init_problem(params, config)).double())
    dt = float(compute_dt(params.replace(dtype="float64"), U))
    g = params.ghost_width
    m = [min(n, BLOCK) for n in (params.nz, params.ny, params.nx)]
    p = params.replace(nx=m[2], ny=m[1], nz=m[0], xmax=params.xmin + m[2] * params.dx,
                       ymax=params.ymin + m[1] * params.dy, zmax=params.zmin + m[0] * params.dz)
    return p, U, g, m, dt


def step_cost(params: RunParams, config=None) -> dict[str, float]:
    """{'flops', 'bytes_accessed', 'flops_per_cell', 'kernels'} of one step
    of this 3D configuration on its initial state ('kernels': the counted
    flops a cell of each kernel launched). Raises NotImplementedError for a
    configuration outside the counted ones (see the module note)."""
    from ..kernels.build import load_library, param_block
    from ..kernels.mhd_step import uses_ghosted, uses_shear
    from ..kernels.packed_bc import bc_codes
    from ..solvers.dissipation import uses_dissipation

    if params.dim != 3 or (params.mhd and uses_shear(params)) or params.compensated:
        raise NotImplementedError("counted: the periodic and walled 3D MHD steps and the 3D "
                                  "hydro step (one device, plain state)")
    if not params.mhd and (params.nu > 0 or params.problem in ("jet", "Jet")):
        raise NotImplementedError("counted: the hydro step kernel's interior mode "
                                  "(no viscosity, no jet)")
    lib = load_library("count")
    p, U, g, (mz, my, mx), dt = _block(params, config)
    cells = mx * my * mz
    n_cells = params.nx * params.ny * params.nz
    bpe = 8 if params.dtype == "float64" else 4
    per_cell, nbytes = {}, 0
    if params.mhd and uses_ghosted(params):
        # the ghosted modes read the block with its ghost frame
        W = np.ascontiguousarray(U[:, :mz + 2 * g, :my + 2 * g, :mx + 2 * g].numpy())
        ptr = W.ctypes.data
        per_cell["mhd_step_ghosted"] = lib.ramses_mhd_step_ghosted_ops(
            ptr, mx, my, mz, g, param_block(p), dt) / cells
        per_cell["cfl_mhd_ghosted"] = lib.ramses_cfl_mhd_ghosted_ops(
            ptr, mx, my, mz, g, param_block(p)) / cells
        ghosted = (params.nx + 2 * g) * (params.ny + 2 * g) * (params.nz + 2 * g)
        nbytes = 8 * bpe * (2 * ghosted + n_cells)
    elif params.mhd:
        S = np.ascontiguousarray(U[:, g:g + mz, g:g + my, g:g + mx].numpy())
        per_cell["mhd_step"] = lib.ramses_mhd_step_ops(S.ctypes.data, 0, mx, my, mz,
                                                       param_block(p), dt) / cells
        per_cell["cfl_mhd"] = lib.ramses_cfl_mhd_ops(S.ctypes.data, mx, my, mz,
                                                     param_block(p)) / cells
        nbytes = 3 * 8 * bpe * n_cells
    else:
        S = np.ascontiguousarray(U[:, g:g + mz, g:g + my, g:g + mx].numpy())
        parts = (ctypes.c_longlong * 4)()
        newton = (ctypes.c_ulonglong * 1)()
        lib.ramses_hydro_step_ops(S.ctypes.data, mx, my, mz, bc_codes(p), param_block(p), dt,
                                  parts, newton)
        per_cell["hydro_step"] = sum(parts) / cells
        per_cell["cfl_hydro"] = lib.ramses_cfl_hydro_ops(S.ctypes.data, mx, my, mz, 0,
                                                         param_block(p)) / cells
        nbytes = 3 * 5 * bpe * n_cells
    if params.mhd and uses_dissipation(params):
        per_cell["dissip_step"] = lib.ramses_dissip_step_ops(
            None, None, 0, mx, my, mz, param_block(p), dt) / cells
        nbytes += 2 * 8 * bpe * n_cells
    flops_per_cell = sum(per_cell.values())
    return {"flops": flops_per_cell * n_cells, "bytes_accessed": float(nbytes),
            "flops_per_cell": flops_per_cell, "kernels": per_cell}


def report(params: RunParams, config=None) -> str:
    c = step_cost(params, config)
    return (f"step flops           : {c['flops']:.3e}\n"
            f"flops per cell       : {c['flops_per_cell']:.1f}\n"
            f"bytes accessed       : {c['bytes_accessed']:.3e}")
