"""Chip smoke test of the PyTorch + CUDA port (ramsesgpu_tpu_torch) on one
NVIDIA GPU.

Phases, in order; any failure raises and no result line is printed:
  1. the card, its power limit, torch / CUDA / nvcc versions;
  2. build csrc/ with nvcc for sm_90a (one nvcc per source, all started
     together; prints build time and the ptxas report), and, beside it,
     the operation-counting host build (g++) the bounds of phase 11 use;
  3. MHD CFL kernel vs its twin on a random physical state at 64^3,
     f32 + f64, and NaN propagation;
  4. MHD step kernel vs its twin at 64^3 (Orszag-Tang), 1 step and 10
     chained steps, f32 + f64;
  5. the MHD main path: make_packed_advance_chain on the bench.py workload
     (3D MHD+CT Orszag-Tang, HLLD, 256^3 f32): 2 warm-up + 3 timed chunks
     of 10 steps; launch counts, no twin call, finiteness, divB and
     conservation; then one more chunk under torch.profiler: device time by
     kernel and the device's idle share of the chunk;
  6. at 256^3 f32, the step kernel's stage buffer (values per cell, GB),
     each MHD kernel against its twin on the same inputs, then each
     kernel's time against its twin's (128^3 for a twin whose estimated
     memory does not fit);
  7. hydro CFL kernel vs its twin at 64^3 on a random physical state, f32 +
     f64, on both state layouts; the isothermal EOS; NaN propagation;
  8. hydro step kernel vs its twin at 64^3, f32 + f64: implode (reflecting
     walls) and blast (periodic), each Riemann solver, 1 step and 10
     chained steps; the kernel's interior mode == its ghosted mode;
  9. the two hydro main paths at 256^3 f32 through make_packed_advance_chain:
     implode (data/implode3d.ini, approx, cfl 0.8) and blast
     (scripts/perf_table.py's overrides), each 2 warm-up + 3 timed chunks
     of 10 steps; launch counts, no twin call, finite state, rho > 0,
     p > 0, mass (and for blast total energy) conserved; one profiled chunk;
 10. at 256^3 f32 on the implode state, each hydro kernel against its twin
     and its time against the twin's; the step kernel's ghosted mode
     (make_step_fn's) timed on the filled ghosted state and held bitwise
     equal to the interior mode;
 11. each kernel's bound at the timed inputs: the larger of its bytes over
     the card's memory rate and the floating-point operations its function
     needs (counted by the counting build on a 32^3 block of the same
     state, plus the approx solver's Newton iterations counted by the
     kernel on the card) over the card's f32 rate;
 12. the shearing box (data/mhd_mri_3d.ini, compensated=no) at 64x128x64,
     f32 + f64, with the JAX tests' coefficients (omega0 = cIso = 1) and
     the ini's (0.001), from a t0 whose shear offset is 2.5 cells: each
     shear kernel against its twin on the same inputs (the CFL with the
     kept face, and its NaN propagation; the sheared slabs; the step's
     shear mode and its five x-face planes before the remap; the remap,
     border columns and kept face), then 1 and 10 chained steps of the
     loop against the twins' loop;
 13. the MRI main path: make_packed_advance_chain at 128x256x128 f32
     (scripts/perf_table.py's flagship MRI size): 2 warm-up + 3 timed
     chunks of 10 steps, one launch of each of the four kernels per step,
     no twin call, finite state, divB (with the kept face) and mass; one
     profiled chunk;
 14. at 128x256x128 f32 on the MRI path's state, each shear kernel against
     its twin, each of its outputs on its own (as 12), and its time
     against the twin's; the step kernel's stages in
     the shear mode beside the periodic mode's on the Orszag-Tang state of
     the same shape;
 15. the shear kernels' bounds (as 11, counted on an 8x32x128 block);
 16. the viscous-resistive sub-step (csrc/dissip_step.cu) against its twin:
     periodic at 64^3 (Orszag-Tang) and shear at 64x128x64 (MRI,
     isothermal and adiabatic), f32 + f64, each coefficient set of
     DISSIP_COEFFS: the increment S_out - S_in and the kept face's change,
     each on its own against the twin's; the inactive kernel writes S_in
     into S_out and leaves the kept face; then 1 and 10 chained steps of
     each dissipative loop against the twins' loop;
 17. the dissipative periodic main path: phase 5's workload with the JAX
     dissipation tests' nu = 2e-3, eta = 1e-3, three kernels per step, and
     nu dt (1/dx^2 + 1/dy^2 + 1/dz^2) and eta dt (...) of the first, the
     timed and the next step (the CFL has no viscous or resistive limit);
 18. the viscous-resistive MRI main path: phase 13's workload with
     scripts/perf_table.py's nu = 4e-5, eta = 1e-5 (Re = 25000, Pm = 4),
     five kernels per step (the slab kernel twice), and the same numbers;
 19. the dissipation kernel at full width on the states of phases 17 and
     18: increment and kept face against the twin, its time against the
     twin's and its bound (as 11 and 15), and its launch in each mode (one
     a sub-step): tile, threads, ring bytes, registers, blocks an SM;
 20. the Kahan-compensated kernels against their twins from non-zero
     carries (periodic OT 64^3, MRI 64x128x64; f32 + f64): the step's
     state and compensated value, its update stage on its own fluxes
     bitwise, the border kernel and the dissipative sub-step (every
     DISSIP_COEFFS set) bitwise, 1 and 10 chained loop steps;
 21. the stratified kernels against their twins (data/mhd_mri_3d_stratified.ini
     at 64x128x64, f32 + f64): CFL, x and z slabs, step, border, loop;
 22. the compensated OT main path (phase 5's workload, compensated=yes),
     and (22d) its dissipative variant (phase 17's coefficients);
 23. the flagship MRI exactly as shipped (data/mhd_mri_3d.ini, compensated)
     at 128x256x128 f32;
 24. the stratified MRI as shipped at 128x256x128 f32 (five kernels per
     step), and (24m) its mass change against its z-face outflow;
 25. the new kernel modes at full width on those paths' states: against
     their twins, their times against the twins', their bounds;
 26. long horizon: 500 steps of OT 64^3 (and MRI 64x128x64) in f64, plain
     f32 and compensated f32 on one dt sequence; err_comp < 0.6 err_plain;
     the MRI again with t carried in f64 (the shear offset formed in
     double), and where its error sits (by channel, the f32 rounding of
     the f64 end state, the compensated value with its carry);
 27. the z-streaming step kernels ([implementation] kernel=zcarry) against
     their twins and the staged kernels at 64^3 / 64x128x64, f32 + f64:
     periodic MHD (plain, compensated), the blast (approx, HLLC), the MRI
     (isothermal, adiabatic, compensated), the stratified MRI; 1 step, the
     folded inverse dt against the CFL kernel on the step's output, an
     inactive step, and 10 chained loop steps against the twins' loop;
 28. the blast main path (phase 9's) with kernel=zcarry;
 29. the OT main path (phase 5's) with kernel=zcarry, and (29c) compensated;
 30. the MRI main path (phase 13's) with kernel=zcarry, (30c) as shipped,
     (30v) viscous-resistive, (30s) the stratified MRI as shipped (each
     MRI path prints its peak device memory); each
     zcarry path checks that its profiled chunk ran the streamed kernel,
     once per step, and no stage of a staged step kernel;
 32. the streamed kernels at full width on those paths' states: against
     their twins, their times against the twins', their bounds;
 31. one 10-step chunk of OT at 512^3 f32 with kernel=zcarry: peak device
     memory (bound 24 GB) and the kernel's rings (in shared memory; bound
     1 GB), divB, mass; the streamed kernel's ring bytes, tile and blocks
     per SM in f32 and f64;
 33. the ghosted modes (walls and the inflow jet; TPU row 3) against their
     twins at 64x48x40, f32 + f64: the 3D Brio-Wu under NEUMANN, DIRICHLET
     and mixed faces and the MHD jet: the CFL with the jet's floor, one step
     on the whole ghosted array and on its CT face layer n+g alone, an
     inactive step, make_fused_mhd_update, 10 chained loop steps; the hydro
     jet's in-place ghosted step and loop;
 34. the walled main path: data/testRiemannHLLD.ini's physics at 256^3 f32
     (six NEUMANN faces) through make_packed_advance_chain, 2 warm-up + 3
     timed chunks of 10 steps: launches, peak memory, finite state, rho,
     p > 0, max|divB|; one profiled chunk (device time by step, CFL and
     fill); the ghosted step and CFL kernels with CUDA events against their
     twins and their bounds;
 35. data/testRiemannHLLD.ini, data/mhd_jet3d.ini and data/jet3d_gpu.ini as
     shipped through Run on CUDA, at most 50 steps each, with 34's gates;
 36. TPU row 4 (the step kernel's shear window mode) and the ghosted-shear
     CFL against their twins on one rank's ghosted window, x0 != xmin, f32
     + f64: the ideal MRI (data/mhd_mri_3d_mpi_debug.ini's physics, a
     2x2x1 block of a 32x64x32 box) and the stratified one
     (data/mhd_mri_3d_stratified_mpi.ini's, a 2x1x2 block: g_z, z0 !=
     zmin); then at the sharded MRI's local size, 64x128x128 f32, against
     the twins, with CUDA-event times and bounds;
 37. the sharded MRI: data/mhd_mri_3d_mpi_debug.ini's physics at
     128x256x128 f32 (scripts/perf_table.py's MRI mesh), four ranks
     (2x2x1) of torch.distributed on the one card, spawned as processes
     running parallel/sharded_step.py rank_advance: 2 warm-up + 3 timed
     chunks of 10 steps: ms/step, cells/s, the transport, the share of a
     step outside the kernels; launches (row 4 and its CFL once per rank
     and step, the single-device shear step never), finite state, mass,
     divB with the rebuilt xmax face; then 10 steps from the initial state
     with each rank's step sections and row-4 and CFL CUDA-event times
     profiled, against the single-rank MRI path: each channel's relative
     L2 within SHARDED_REL_L2, JAX's budget (tests/test_parallel.py:444)
     printed beside it;
 38. both shipped MRI [mpi] inputs as shipped through the CLI's main() in
     four spawned ranks, at most 50 steps each (no HDF5 snapshots where
     h5py is not installed), with 37's gates and its comparison with the
     single-rank path; the stratified box's mass change is the
     single-rank path's (its z faces let mass out);
 then the MHD step kernel's rows (A, A', 3, 4, 12) with their times and
 bounds, the kernels JSON line, the card line, and the result line.
Imports nothing of JAX; of this repo it imports only ramsesgpu_tpu_torch.
"""
from __future__ import annotations

import contextlib
import ctypes
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

# the workload of bench.py:27-59 (3D MHD+CT Orszag-Tang, HLLD, fully periodic)
INI = """
[run]
tend=100.0
[mesh]
nx={n}
ny={n}
nz={n}
xmin=-0.5
xmax=0.5
ymin=-0.5
ymax=0.5
zmin=-0.5
zmax=0.5
boundary_xmin=3
boundary_xmax=3
boundary_ymin=3
boundary_ymax=3
boundary_zmin=3
boundary_zmax=3
[hydro]
problem=Orszag-Tang
cfl=0.4
gamma0=1.666
slope_type=2.0
riemannSolver=hlld
smallr=1e-7
smallc=1e-7
[MHD]
enable=true
magRiemannSolver=hlld
[implementation]
dtype={dtype}
"""

# relative-error tolerances of kernel vs twin on the same card. The kernels
# differ from the twins at ULP level per operation (FMA contraction,
# rsqrtf, reciprocal forms), never bitwise.
TOL_CFL = {"float32": 1e-6, "float64": 1e-13}
TOL_STEP1 = {"float32": 1e-6, "float64": 1e-13}
TOL_STEP10 = {"float32": 1e-5, "float64": 1e-12}
# the shear step's five x-face planes before the remap are differences of
# much larger terms (on the noflux MRI box, whose Bz vanishes at the x
# faces, the x-face EMFs are ~1e-6 of |v||B| and the density fluxes ~1e-3
# of rho c_s): relative to their own norm their rounding is the terms'
# scaled up by that cancellation (PERF.md)
TOL_PLANES = {"float32": 1e-4, "float64": 1e-12}
KERNELS = {
    "mhd_step": ("ramsesgpu_tpu_torch/csrc/mhd_step.cu",
                 "ramsesgpu_tpu/pallas/packed_io.py:148"),
    "cfl_mhd": ("ramsesgpu_tpu_torch/csrc/cfl_mhd.cu",
                "ramsesgpu_tpu/pallas/packed_io.py:51"),
    "mhd_step_shear": ("ramsesgpu_tpu_torch/csrc/mhd_step.cu",
                       "ramsesgpu_tpu/pallas/shear_packed.py:89 (MRI main kernel), "
                       "ramsesgpu_tpu/pallas/shear_packed.py:237 (border strip)"),
    "cfl_mhd_shear": ("ramsesgpu_tpu_torch/csrc/cfl_mhd.cu",
                      "ramsesgpu_tpu/pallas/shear_packed.py:716"),
    "shear_slabs": ("ramsesgpu_tpu_torch/csrc/shear_border.cu",
                    "ramsesgpu_tpu/pallas/shear_packed.py:237 (the strip's sheared ghosts, "
                    "built by :952-1004)"),
    "shear_border": ("ramsesgpu_tpu_torch/csrc/shear_border.cu",
                     "ramsesgpu_tpu/pallas/shear_packed.py:237 (the strip's planes, remapped "
                     "and applied by :1108-1174)"),
    "hydro_step": ("ramsesgpu_tpu_torch/csrc/hydro_step.cu",
                   "ramsesgpu_tpu/pallas/packed_io.py:148 (hydro body fused_hydro3d.py:182), "
                   "ramsesgpu_tpu/pallas/fused_hydro3d.py:46, "
                   "ramsesgpu_tpu/pallas/packed_bc.py:126"),
    "cfl_hydro": ("ramsesgpu_tpu_torch/csrc/cfl_hydro.cu",
                  "ramsesgpu_tpu/pallas/packed_bc.py:408"),
    "dissip_step": ("ramsesgpu_tpu_torch/csrc/dissip_step.cu",
                    "ramsesgpu_tpu/pallas/fused_dissip3d.py:51 (make_pallas_step_fn's "
                    "dissipation kernel), ramsesgpu_tpu/pallas/fused_mhd3d.py:369 (the "
                    "packed-io loop's dissipative launch)"),
    "dissip_step_shear": ("ramsesgpu_tpu_torch/csrc/dissip_step.cu",
                          "ramsesgpu_tpu/pallas/shear_packed.py:917 (the MRI loop's dissipative "
                          "launch), ramsesgpu_tpu/pallas/shear_packed.py:237 and :432 (the "
                          "strips' mode dissip)"),
    "mhd_step_comp": ("ramsesgpu_tpu_torch/csrc/mhd_step.cu",
                      "ramsesgpu_tpu/pallas/fused_mhd3d.py:247 (the packed-io step on 2*nvar "
                      "channels: state + Kahan carry)"),
    "dissip_step_comp": ("ramsesgpu_tpu_torch/csrc/dissip_step.cu",
                         "ramsesgpu_tpu/pallas/fused_mhd3d.py:360 (the dissipative launch on "
                         "2*nvar channels)"),
    "mhd_step_shear_comp": ("ramsesgpu_tpu_torch/csrc/mhd_step.cu",
                            "ramsesgpu_tpu/pallas/shear_packed.py:89 (the MRI main kernel on "
                            "2*nvar channels)"),
    "shear_border_comp": ("ramsesgpu_tpu_torch/csrc/shear_border.cu",
                          "ramsesgpu_tpu/pallas/shear_packed.py:237 (the strip's planes, "
                          "Kahan-applied by :1108-1168)"),
    "mhd_step_strat": ("ramsesgpu_tpu_torch/csrc/mhd_step.cu",
                       "ramsesgpu_tpu/pallas/shear_packed.py:89 with the gravity_z aux "
                       "(:117-131), ramsesgpu_tpu/pallas/shear_packed.py:237 (the strip with "
                       "gravity)"),
    "shear_zslabs": ("ramsesgpu_tpu_torch/csrc/shear_border.cu",
                     "ramsesgpu_tpu/pallas/shear_packed.py:237 (the strip's stratified slab z "
                     "extension, built by :963-975) and the z band refill :1006-1021"),
    "zcarry_mhd": ("ramsesgpu_tpu_torch/csrc/zcarry_mhd.cu",
                   "ramsesgpu_tpu/pallas/zcarry_mhd3d.py:102 (with_inv_dt: the periodic loop, "
                   "pallas/fused_mhd3d.py:341)"),
    "zcarry_hydro": ("ramsesgpu_tpu_torch/csrc/zcarry_hydro.cu",
                     "ramsesgpu_tpu/pallas/zcarry_hydro3d.py:58"),
    "zcarry_mhd_shear": ("ramsesgpu_tpu_torch/csrc/zcarry_mhd.cu",
                         "ramsesgpu_tpu/pallas/zcarry_mhd3d.py:102 (the MRI main kernel, "
                         "pallas/shear_packed.py:891)"),
    "mhd_step_ghosted": ("ramsesgpu_tpu_torch/csrc/mhd_step.cu",
                         "ramsesgpu_tpu/pallas/fused_mhd3d.py:80 (make_fused_mhd_update, "
                         "pallas_call at :173)"),
    "cfl_mhd_ghosted": ("ramsesgpu_tpu_torch/csrc/cfl_mhd.cu",
                        "ramsesgpu_tpu/pallas/packed_io.py:51 (its reduction, on the ghosted "
                        "state; the JAX walled path runs it in XLA, solvers/timestep.py:245)"),
    "mhd_window": ("ramsesgpu_tpu_torch/csrc/mhd_step.cu",
                   "ramsesgpu_tpu/pallas/fused_mhd3d.py:587 (make_fused_mhd_shear, pallas_call "
                   "at :691)"),
    "cfl_mhd_window": ("ramsesgpu_tpu_torch/csrc/cfl_mhd.cu",
                       "ramsesgpu_tpu/pallas/packed_io.py:51 (its reduction on a rank's ghosted "
                       "shearing-box block; the JAX sharded path runs it in XLA, "
                       "parallel/sharded_step.py:551-556)"),
}
# ms/step of these paths in the version before the compensated and
# stratified modes, on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section
# 5), printed beside this run's with no claim of speed
EARLIER_MS_PER_STEP = {"5": 10.876, "9 implode": 5.251, "9 blast": 5.274, "13": 2.847,
                       "17": 14.885, "18": 3.448}
# the dissipative coefficient sets (nu, eta): the JAX dissipation tests'
# (tests/test_pallas_dissip.py:46), each term alone, and the viscous-
# resistive MRI's (scripts/perf_table.py:93-102: Re = 25000, Pm = 4)
DISSIP_COEFFS = {"nu=2e-3 eta=1e-3": (2e-3, 1e-3), "nu=0 eta=1e-3": (0.0, 1e-3),
                 "nu=2e-3 eta=0": (2e-3, 0.0), "nu=4e-5 eta=1e-5": (4e-5, 1e-5)}
# the shipped MRI inputs: the flagship and the stratified box, both
# Kahan-compensated as shipped ([implementation] compensated=yes)
MRI_INI = "data/mhd_mri_3d.ini"
STRAT_INI = "data/mhd_mri_3d_stratified.ini"
# the card's peaks (NVIDIA's H100 SXM data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
F64_FLOP_PER_S = 34e12


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def setup(n: int, dtype: str, ny: int | None = None, nz: int | None = None):
    """The Orszag-Tang workload at n^3 (or n x ny x nz): params and the
    interior state on the card."""
    from ramsesgpu_tpu_torch.convert import torch_dtype
    from ramsesgpu_tpu_torch.problems import init_problem
    from ramsesgpu_tpu_torch.solvers.boundary import interior
    from ramsesgpu_tpu_torch.solvers.run import config_from_ini

    text = INI.format(n=n, dtype=dtype)
    text = text.replace(f"ny={n}", f"ny={ny or n}").replace(f"nz={n}", f"nz={nz or n}")
    config, params = config_from_ini(text)
    U0 = torch.from_numpy(init_problem(params, config))
    S = interior(params, U0).to(device="cuda", dtype=torch_dtype(params)).contiguous()
    return params, S


def hydro_setup(problem: str, n: int, dtype: str, solver: str = "approx"):
    """data/implode3d.ini at n^3 (approx, niter_riemann 10, cfl 0.8,
    slope_type 1), or its blast variant of scripts/perf_table.py:64-76:
    params and the ghosted initial state on the card, ghosts filled."""
    from ramsesgpu_tpu_torch.config.configmap import ConfigMap
    from ramsesgpu_tpu_torch.config.params import params_from_config
    from ramsesgpu_tpu_torch.convert import torch_dtype
    from ramsesgpu_tpu_torch.problems import init_problem
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries

    config = ConfigMap(Path("data/implode3d.ini"))
    for axis in ("nx", "ny", "nz"):
        config.set_integer("mesh", axis, n)
    config.set_string("implementation", "dtype", dtype)
    config.set_string("hydro", "riemannSolver", solver)
    if problem == "blast":
        config.set_string("hydro", "problem", "blast")
        config.set_float("blast", "radius", 0.2)
        for face in ("xmin", "xmax", "ymin", "ymax", "zmin", "zmax"):
            config.set_integer("mesh", f"boundary_{face}", 3)
    params = params_from_config(config)
    U0 = torch.from_numpy(init_problem(params, config))
    U = make_boundaries(params, U0.to(device="cuda", dtype=torch_dtype(params)))
    return params, U


def block_params(params, m: int):
    """params of an m^3 block of the mesh, with the same cell size."""
    return params.replace(nx=m, ny=m, nz=m, xmax=params.xmin + m * params.dx,
                          ymax=params.ymin + m * params.dy, zmax=params.zmin + m * params.dz)


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.norm((a - b).flatten()) / torch.linalg.norm(b.flatten()))


def time_ms(fn, reps: int) -> float:
    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def wrappers():
    from ramsesgpu_tpu_torch.kernels.cfl_hydro import cfl_hydro
    from ramsesgpu_tpu_torch.kernels.cfl_mhd import cfl_mhd, cfl_mhd_window
    from ramsesgpu_tpu_torch.kernels.dissip_step import dissip_step
    from ramsesgpu_tpu_torch.kernels.hydro_step import hydro_step
    from ramsesgpu_tpu_torch.kernels.mhd_step import mhd_step, mhd_window
    from ramsesgpu_tpu_torch.kernels.shear_border import shear_border, shear_slabs, shear_zslabs
    from ramsesgpu_tpu_torch.kernels.zcarry_hydro3d import zcarry_hydro
    from ramsesgpu_tpu_torch.kernels.zcarry_mhd3d import zcarry_mhd

    return {"mhd_step": mhd_step, "cfl_mhd": cfl_mhd, "hydro_step": hydro_step,
            "cfl_hydro": cfl_hydro, "shear_slabs": shear_slabs, "shear_border": shear_border,
            "dissip_step": dissip_step, "shear_zslabs": shear_zslabs,
            "zcarry_mhd": zcarry_mhd, "zcarry_hydro": zcarry_hydro,
            "mhd_window": mhd_window, "cfl_mhd_window": cfl_mhd_window}


@contextlib.contextmanager
def counted_main_path(name: str, expect: dict):
    """Drive one main path with every launch count set to 0 just before and
    read just after; fails unless the counts equal ``expect`` (0 for the
    kernels not named) or a plain twin ran meanwhile. Yields the dict the
    counts are read into."""
    from ramsesgpu_tpu_torch.kernels import (cfl_hydro, cfl_mhd, dissip_step, hydro_step,
                                             mhd_step, shear_border, zcarry_hydro3d,
                                             zcarry_mhd3d)

    twins = [(mhd_step, "mhd_3d_periodic_update"), (cfl_mhd, "inv_dt_mhd_periodic"),
             (hydro_step, "hydro_3d_state_update"), (hydro_step, "hydro_3d_interior_update"),
             (cfl_hydro, "compute_inv_dt_hydro"), (mhd_step, "mhd_3d_shear_update"),
             (cfl_mhd, "inv_dt_mhd_shear"), (shear_border, "shear_slabs_twin"),
             (shear_border, "shear_border_update"), (shear_border, "stratified_zslabs"),
             (dissip_step, "mhd_dissipation_periodic_update"),
             (dissip_step, "mhd_dissipation_shear_update"),
             (dissip_step, "kept_face_resistive_ct"),
             (zcarry_mhd3d, "mhd_3d_periodic_update"), (zcarry_mhd3d, "mhd_3d_shear_update"),
             (zcarry_mhd3d, "inv_dt_mhd_periodic"), (zcarry_hydro3d, "hydro_3d_state_update"),
             (zcarry_hydro3d, "compute_inv_dt_hydro"), (mhd_step, "mhd_3d_ghosted_update"),
             (cfl_mhd, "inv_dt_mhd_ghosted"), (mhd_step, "mhd_3d_shear_window_update"),
             (cfl_mhd, "inv_dt_mhd_ghosted_shear")]
    twin_calls = []

    def guard(module, attr, fn):
        def counted(*args, **kw):
            twin_calls.append(f"{module.__name__}.{attr}")
            return fn(*args, **kw)
        return counted

    saved = [(m, a, getattr(m, a)) for m, a in twins]
    for m, a, fn in saved:
        setattr(m, a, guard(m, a, fn))
    kernels = wrappers()
    for k in kernels.values():
        k.launches = 0
    counts: dict = {}
    try:
        torch.cuda.synchronize()
        yield counts
        torch.cuda.synchronize()
        counts.update({n: k.launches for n, k in kernels.items()})
    finally:
        for m, a, fn in saved:
            setattr(m, a, fn)
    want = {n: expect.get(n, 0) for n in kernels}
    print(f"[{name}] launches during the main path: {counts}")
    if counts != want:
        raise AssertionError(f"{name}: launch counts {counts}, expected {want}")
    if twin_calls:
        raise AssertionError(f"{name}: plain twins ran on the main path: {sorted(set(twin_calls))}")


def phase1() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this test needs a GPU")
    card = card_line()
    print(f"[1] card: {card}")
    print(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device 0: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    from ramsesgpu_tpu_torch.kernels.build import find_nvcc

    nvcc = subprocess.run([find_nvcc(), "--version"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[-1]
    print(f"[1] nvcc: {nvcc}")
    return card


def phase2() -> None:
    from ramsesgpu_tpu_torch.kernels.build import build

    with ThreadPoolExecutor(2) as pool:
        cuda, count = pool.map(build, ("cuda", "count"))
    print(f"[2] built {cuda.path.name} in {cuda.seconds:.1f} s (nvcc), "
          f"{count.path.name} in {count.seconds:.1f} s (g++, operation counting)")
    entry = None
    for line in cuda.log.splitlines():
        if "Compiling entry" in line:
            entry = line.split("entry function")[-1].strip().strip("'")[:80]
        elif "registers" in line or ("spill" in line and " 0 bytes spill" not in line):
            print(f"[2] ptxas {entry}: {line.split(':', 1)[-1].strip()}")


def phase3() -> None:
    from ramsesgpu_tpu_torch.kernels.cfl_mhd import cfl_mhd
    from ramsesgpu_tpu_torch.solvers.timestep import inv_dt_mhd_periodic

    for dtype in ("float32", "float64"):
        params, S = setup(64, dtype)
        gen = torch.Generator(device="cuda").manual_seed(1234)
        # a physical random state: the OT state with 5 % multiplicative noise
        # (rho and p stay positive)
        S = (S * (1 + 0.05 * torch.randn(S.shape, generator=gen, device="cuda",
                                          dtype=S.dtype))).contiguous()
        got = cfl_mhd(params, S)
        want = inv_dt_mhd_periodic(params, S)
        rel = abs(float(got) - float(want)) / abs(float(want))
        print(f"[3] cfl_mhd {dtype} 64^3: kernel {float(got)!r} twin {float(want)!r} "
              f"rel err {rel:.3e} (tol {TOL_CFL[dtype]:.0e})")
        if not rel <= TOL_CFL[dtype]:
            raise AssertionError(f"cfl_mhd {dtype} disagrees with its twin: {rel}")
        # NaN propagation: one NaN cell must give a NaN inverse dt
        S_nan = S.clone()
        S_nan[1, 7, 9, 11] = float("nan")
        if not torch.isnan(cfl_mhd(params, S_nan)):
            raise AssertionError("cfl_mhd does not propagate NaN")
    print("[3] cfl_mhd propagates NaN")


def phase4() -> int:
    """Returns the twin step's peak device memory at 64^3 (bytes)."""
    from ramsesgpu_tpu_torch.kernels.fused_mhd3d import make_advance_n
    from ramsesgpu_tpu_torch.kernels.mhd_step import mhd_step
    from ramsesgpu_tpu_torch.solvers.godunov_mhd import mhd_3d_periodic_update
    from ramsesgpu_tpu_torch.solvers.timestep import dt_from_inv, inv_dt_mhd_periodic

    twin_peak = 0
    for dtype in ("float32", "float64"):
        params, S0 = setup(64, dtype)
        dt = dt_from_inv(params, inv_dt_mhd_periodic(params, S0))
        active = torch.ones((), dtype=torch.bool, device="cuda")
        S_k = S0.clone()
        mhd_step(params, S_k, dt, active, mhd_step.scratch(params, S_k))
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        S_t = mhd_3d_periodic_update(params, S0, dt)
        torch.cuda.synchronize()
        twin_peak = max(twin_peak, torch.cuda.max_memory_allocated() - base)
        rel1 = rel_l2(S_k, S_t)
        print(f"[4] mhd_step {dtype} 64^3 1 step: rel L2 {rel1:.3e} "
              f"(tol {TOL_STEP1[dtype]:.0e}), max abs {float((S_k - S_t).abs().max()):.3e}")
        if not rel1 <= TOL_STEP1[dtype]:
            raise AssertionError(f"mhd_step {dtype} disagrees with its twin: {rel1}")

        pack, advance, unpack = make_advance_n(params, "cuda", packed_form=True)
        S_k = S0.clone()
        t0 = torch.zeros((), dtype=S0.dtype, device="cuda")
        S_k, t_k, k = advance(S_k, t0, 10)
        S_t, t_t = S0.clone(), t0.clone()
        for _ in range(10):
            dt = dt_from_inv(params, inv_dt_mhd_periodic(params, S_t))
            S_t = mhd_3d_periodic_update(params, S_t, dt)
            t_t = t_t + dt
        rel10 = rel_l2(S_k, S_t)
        print(f"[4] mhd_step {dtype} 64^3 10 chained steps: k={int(k)} t kernel {float(t_k)!r} "
              f"twin {float(t_t)!r}, rel L2 {rel10:.3e} (tol {TOL_STEP10[dtype]:.0e})")
        if int(k) != 10 or not rel10 <= TOL_STEP10[dtype]:
            raise AssertionError(f"10-step {dtype} run disagrees with the twin: {rel10}")
    return twin_peak


def div_b_max(params, S: torch.Tensor) -> float:
    bx, by, bz = (S[c].double() for c in (5, 6, 7))
    div = ((torch.roll(bx, -1, -1) - bx) / params.dx + (torch.roll(by, -1, -2) - by) / params.dy
           + (torch.roll(bz, -1, -3) - bz) / params.dz)
    return float(div.abs().max())


def run_chunks(label: str, card: str, advance, S, t, n, chunk: int = 10,
               cells: int | None = None):
    """2 warm-up and 3 timed chunks of ``chunk`` steps on the n^3 mesh (or
    ``cells`` cells of the mesh named n); prints ms/step and cells/s;
    returns (S, t, the mean dt of the timed steps)."""
    cells = n ** 3 if cells is None else cells
    for _ in range(2):
        S, t, k = advance(S, t, chunk)
        torch.cuda.synchronize()
        if int(k) != chunk:
            raise AssertionError(f"{label}: warm-up chunk stopped early: {int(k)}")
    times = []
    t_timed = float(t)
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        S, t, k = advance(S, t, chunk)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if int(k) != chunk:
            raise AssertionError(f"{label}: timed chunk stopped early: {int(k)}")
    best, mean = min(times), sum(times) / len(times)
    size = f"{n}^3" if isinstance(n, int) else n
    print(f"[{label}] main path {size} f32 on {card}: best chunk {best * 1e3 / chunk:.3f} ms/step, "
          f"{cells * chunk / best:.4e} cells/s (mean {mean * 1e3 / chunk:.3f} ms/step, "
          f"chunks {[round(x * 1e3 / chunk, 3) for x in times]} ms/step)"
          + (f"; earlier version (PERF.md): {EARLIER_MS_PER_STEP[label]} ms/step"
             if label in EARLIER_MS_PER_STEP else ""))
    return S, t, (float(t) - t_timed) / (3 * chunk)


def diffusion_numbers(label: str, params, dts: dict) -> None:
    """nu dt (1/dx^2 + 1/dy^2 + 1/dz^2), and the same with eta, for each dt
    of ``dts``: the explicit sub-step is stable up to 1/2, and the CFL has
    no viscous or resistive limit (nor has the JAX package's)."""
    inv_h2 = 1 / params.dx ** 2 + 1 / params.dy ** 2 + 1 / params.dz ** 2
    print(f"[{label}] diffusion numbers (explicit limit 0.5): " + "; ".join(
        f"{name}: dt {dt!r}, nu {params.nu * dt * inv_h2:.5f}, eta {params.eta * dt * inv_h2:.5f}"
        for name, dt in dts.items()))


def phase5(card: str, label: str = "5", nu: float = 0.0, eta: float = 0.0,
           compensated: bool = False, kernel: str = "auto"):
    """The periodic MHD main path, ideal or (phase 17) with viscosity nu and
    resistivity eta, plain or (phases 22, 22d) with the Kahan-compensated
    state, on the staged step kernel or (kernel=zcarry, phases 29, 29c)
    the streamed one; returns its launch counts and (params, S, t) at its
    end."""
    from ramsesgpu_tpu_torch.kernels.cfl_mhd import cfl_mhd
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries_concat
    from ramsesgpu_tpu_torch.solvers.step import make_packed_advance_chain
    from ramsesgpu_tpu_torch.solvers.timestep import dt_from_inv

    n, chunk = 256, 10
    params, S_init = setup(n, "float32")
    dt_first = float(dt_from_inv(params, cfl_mhd(params, S_init)))
    params = params.replace(nu=nu, eta=eta, compensated=compensated, kernel=kernel)
    U = make_boundaries_concat(params, S_init, interior_only=True)
    del S_init
    mass0 = float(U[0, 3:-3, 3:-3, 3:-3].double().sum())
    energy0 = float(U[1, 3:-3, 3:-3, 3:-3].double().sum())
    pack, advance, unpack = make_packed_advance_chain(params, "cuda")
    t = torch.zeros((), dtype=torch.float32, device="cuda")

    steps = 5 * chunk
    dissipative = nu > 0 or eta > 0
    if kernel == "zcarry":
        # the CFL folded into the streamed step: one CFL launch per chunk
        expect = {"zcarry_mhd": steps, "cfl_mhd": steps if dissipative else 5}
    else:
        expect = {"mhd_step": steps, "cfl_mhd": steps}
    if dissipative:
        expect["dissip_step"] = steps
    with counted_main_path(label, expect) as launches:
        S = pack(U)
        del U
        S, t, dt_timed = run_chunks(label, card, advance, S, t, n, chunk)

    if not bool(torch.isfinite(S).all()):
        raise AssertionError("non-finite state after the main path")
    if nu > 0 or eta > 0:
        diffusion_numbers(label, params, {
            "first step": dt_first, "timed steps (mean)": dt_timed,
            "next step": float(dt_from_inv(params, cfl_mhd(params, S)))})
    b_over_dx = max(float(S[5].abs().max()), 1e-10) / params.dx
    divb = div_b_max(params, S)
    mass = float(S[0].double().sum())
    energy = float(S[1].double().sum())
    print(f"[{label}] {steps} steps at {n}^3 f32: t={float(t)!r}, max|divB|={divb:.3e} "
          f"(bound {1e-3 * b_over_dx:.3e}), mass rel {abs(mass - mass0) / abs(mass0):.3e} "
          f"(1e-5), energy rel {abs(energy - energy0) / abs(energy0):.3e} (1e-4)")
    if not divb < 1e-3 * b_over_dx:
        raise AssertionError("divB bound violated")
    if not abs(mass - mass0) <= 1e-5 * abs(mass0) or not abs(energy - energy0) <= 1e-4 * abs(energy0):
        raise AssertionError("conservation bound violated")
    U_out = unpack(S, t)
    if tuple(U_out.shape) != params.shape:
        raise AssertionError(f"unpacked shape {tuple(U_out.shape)} != {params.shape}")
    check_streamed(f"{label}p", kernel, profile_chunk(f"{label}p", card, advance, S, t, chunk))
    return launches, (params, S, t)


def phase6(card: str, twin_peak_64: int) -> dict:
    from ramsesgpu_tpu_torch.kernels.cfl_mhd import cfl_mhd
    from ramsesgpu_tpu_torch.kernels.mhd_step import mhd_step
    from ramsesgpu_tpu_torch.solvers.godunov_mhd import mhd_3d_periodic_update
    from ramsesgpu_tpu_torch.solvers.timestep import dt_from_inv, inv_dt_mhd_periodic

    torch.cuda.empty_cache()
    free, _total = torch.cuda.mem_get_info()
    n_twin = 256 if twin_peak_64 * 64 < 0.8 * free else 128
    if n_twin != 256:
        print(f"[6] twin estimated at {twin_peak_64 * 64 / 2**30:.1f} GiB does not fit "
              f"({free / 2**30:.1f} GiB free): twins checked and timed at 128^3")
    params, S = setup(256, "float32")
    stage_buffer(params)
    bound_input = S[:, :32, :32, :32].contiguous()  # phase 11 counts the operations here
    active = torch.ones((), dtype=torch.bool, device="cuda")
    scratch = mhd_step.scratch(params, S)
    inv = cfl_mhd(params, S)
    dt = dt_from_inv(params, inv)
    S_k = mhd_step(params, S.clone(), dt, active, scratch)
    ms = {
        "mhd_step": time_ms(lambda: mhd_step(params, S, dt, active, scratch), 10),
        "cfl_mhd": time_ms(lambda: cfl_mhd(params, S), 50),
    }
    del scratch
    if n_twin != 256:
        params, S = setup(n_twin, "float32")
        inv = cfl_mhd(params, S)
        dt = dt_from_inv(params, inv)
        S_k = mhd_step(params, S.clone(), dt, active, mhd_step.scratch(params, S))
    else:
        params, S = setup(256, "float32")  # the state the kernel launches started from
    torch.cuda.empty_cache()

    # kernel vs twin on the same inputs at the main path's shape
    inv_t = inv_dt_mhd_periodic(params, S)
    S_t = mhd_3d_periodic_update(params, S, dt)
    errs = {"cfl_mhd": abs(float(inv) - float(inv_t)),
            "mhd_step": float((S_k - S_t).abs().max())}
    rel = {"cfl_mhd": errs["cfl_mhd"] / abs(float(inv_t)), "mhd_step": rel_l2(S_k, S_t)}
    tol = {"cfl_mhd": TOL_CFL["float32"], "mhd_step": TOL_STEP1["float32"]}
    del S_k, S_t
    plain = {
        "mhd_step": time_ms(lambda: mhd_3d_periodic_update(params, S, dt), 3),
        "cfl_mhd": time_ms(lambda: inv_dt_mhd_periodic(params, S), 10),
    }
    for name in ("mhd_step", "cfl_mhd"):
        print(f"[6] {name} at {n_twin}^3 f32: kernel vs twin rel err {rel[name]:.3e} "
              f"(tol {tol[name]:.0e}), max abs {errs[name]:.3e}")
        if not rel[name] <= tol[name]:
            raise AssertionError(f"{name} disagrees with its twin at {n_twin}^3: {rel[name]}")
        print(f"[6] {name}: kernel {ms[name]:.3f} ms at 256^3, twin {plain[name]:.3f} ms "
              f"at {n_twin}^3 (f32, {card})")
    return {"ms": ms, "plain_ms": plain, "max_abs_err": errs, "n_twin": n_twin,
            "bound_input": (block_params(params, 32), bound_input.cpu(), float(dt))}


def stage_buffer(params) -> None:
    """The staged step's stage buffer: its values per stage-grid cell and
    its size at the OT path's 256^3 f32 (kernels/mhd_step.py)."""
    from ramsesgpu_tpu_torch.kernels.build import load_library
    from ramsesgpu_tpu_torch.kernels.mhd_step import MhdStepKernel

    lib = load_library("cuda")
    per_cell = lib.ramses_mhd_step_scratch_per_cell()
    size = MhdStepKernel.scratch_size(lib, params)
    print(f"[6] stage buffer: {per_cell} values per stage-grid cell ({per_cell + 8} in the "
          f"shear modes), {size * 4 / 1e9:.3f} GB at {params.nx}x{params.ny}x{params.nz} f32")


def phase7() -> None:
    from ramsesgpu_tpu_torch.kernels.cfl_hydro import cfl_hydro
    from ramsesgpu_tpu_torch.solvers.boundary import interior, make_boundaries
    from ramsesgpu_tpu_torch.solvers.timestep import compute_inv_dt_hydro

    for dtype, ciso in (("float32", 0.0), ("float64", 0.0), ("float32", 0.7)):
        params, U = hydro_setup("implode", 64, dtype)
        params = params.replace(c_iso=ciso)
        gen = torch.Generator(device="cuda").manual_seed(4321)
        # a physical random state: implode with 5 % multiplicative noise and
        # random velocities (rho and the internal energy stay positive)
        noise = 1 + 0.05 * torch.randn(U.shape, generator=gen, device="cuda", dtype=U.dtype)
        U = U * noise
        U[2:] = 0.3 * U[0] * torch.randn(U[2:].shape, generator=gen, device="cuda", dtype=U.dtype)
        U[1] = U[1] + 0.5 * (U[2:] ** 2).sum(0) / U[0]
        U = make_boundaries(params, U)
        S = interior(params, U).contiguous()
        want = compute_inv_dt_hydro(params, S, ghost=0)
        for layout, got in (("interior", cfl_hydro(params, S)),
                            ("ghosted", cfl_hydro(params, U, ghost=params.ghost_width))):
            rel = abs(float(got) - float(want)) / abs(float(want))
            print(f"[7] cfl_hydro {dtype} cIso={ciso} 64^3 {layout}: kernel {float(got)!r} "
                  f"twin {float(want)!r} rel err {rel:.3e} (tol {TOL_CFL[dtype]:.0e})")
            if not rel <= TOL_CFL[dtype]:
                raise AssertionError(f"cfl_hydro {dtype} disagrees with its twin: {rel}")
        S[2, 7, 9, 11] = float("nan")  # a momentum: read by the isothermal chain too
        if not torch.isnan(cfl_hydro(params, S)):
            raise AssertionError("cfl_hydro does not propagate NaN")
    print("[7] cfl_hydro propagates NaN")


def phase8() -> int:
    """Returns the hydro twin step's peak device memory at 64^3 (bytes)."""
    from ramsesgpu_tpu_torch.kernels.fused_hydro3d import make_advance_n
    from ramsesgpu_tpu_torch.kernels.hydro_step import hydro_step
    from ramsesgpu_tpu_torch.solvers.boundary import interior
    from ramsesgpu_tpu_torch.solvers.godunov import hydro_3d_state_update
    from ramsesgpu_tpu_torch.solvers.timestep import compute_inv_dt_hydro, dt_from_inv

    twin_peak = 0
    for dtype in ("float32", "float64"):
        for problem in ("implode", "blast"):
            for solver in ("approx", "hll", "hllc"):
                params, U = hydro_setup(problem, 64, dtype, solver)
                S0 = interior(params, U).contiguous()
                dt = dt_from_inv(params, compute_inv_dt_hydro(params, S0, ghost=0))
                active = torch.ones((), dtype=torch.bool, device="cuda")
                S_k = hydro_step(params, S0, torch.empty_like(S0), dt, active)
                S_g = hydro_step.ghosted(params, U, dt)
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                S_t = hydro_3d_state_update(params, S0, dt)
                torch.cuda.synchronize()
                twin_peak = max(twin_peak, torch.cuda.max_memory_allocated() - base)
                rel1 = rel_l2(S_k, S_t)
                same = torch.equal(S_k, S_g)
                label = f"hydro_step {dtype} {problem} {solver} 64^3"
                print(f"[8] {label} 1 step: rel L2 {rel1:.3e} (tol {TOL_STEP1[dtype]:.0e}), "
                      f"max abs {float((S_k - S_t).abs().max()):.3e}; interior mode == ghosted "
                      f"mode: {same}")
                if not rel1 <= TOL_STEP1[dtype]:
                    raise AssertionError(f"{label} disagrees with its twin: {rel1}")
                if not same:
                    raise AssertionError(f"{label}: interior and ghosted modes differ by "
                                         f"{float((S_k - S_g).abs().max())}")

                pack, advance, unpack = make_advance_n(params, "cuda", packed_form=True)
                t0 = torch.zeros((), dtype=S0.dtype, device="cuda")
                S_k, t_k, k = advance(pack(U), t0, 10)
                S_t, t_t = S0.clone(), t0.clone()
                for _ in range(10):
                    dt = dt_from_inv(params, compute_inv_dt_hydro(params, S_t, ghost=0))
                    S_t = hydro_3d_state_update(params, S_t, dt)
                    t_t = t_t + dt
                rel10 = rel_l2(S_k, S_t)
                print(f"[8] {label} 10 chained steps: k={int(k)} t kernel {float(t_k)!r} twin "
                      f"{float(t_t)!r}, rel L2 {rel10:.3e} (tol {TOL_STEP10[dtype]:.0e})")
                if int(k) != 10 or not rel10 <= TOL_STEP10[dtype]:
                    raise AssertionError(f"{label}: 10-step run disagrees with the twin: {rel10}")
    return twin_peak


def hydro_pressure(params, S: torch.Tensor) -> torch.Tensor:
    rho = S[0].double()
    ekin = 0.5 * (S[2:5].double() ** 2).sum(0) / rho
    return (params.gamma0 - 1.0) * (S[1].double() - ekin)


def phase9(card: str, problems=("implode", "blast"), kernel: str = "auto",
           phase: str = "9") -> tuple[dict, torch.Tensor]:
    """The hydro main paths (kernel=zcarry: the streamed step, phase 28);
    returns the summed launch counts and the end state of the first."""
    from ramsesgpu_tpu_torch.solvers.step import make_packed_advance_chain

    n, chunk, steps = 256, 10, 50
    total = {}
    kept = None
    for problem in problems:
        label = f"{phase} {problem}"
        params, U = hydro_setup(problem, n, "float32")
        params = params.replace(kernel=kernel)
        mass0 = float(U[0, 2:-2, 2:-2, 2:-2].double().sum())
        energy0 = float(U[1, 2:-2, 2:-2, 2:-2].double().sum())
        pack, advance, unpack = make_packed_advance_chain(params, "cuda")
        t = torch.zeros((), dtype=torch.float32, device="cuda")
        expect = ({"zcarry_hydro": steps, "cfl_hydro": 5} if kernel == "zcarry"
                  else {"hydro_step": steps, "cfl_hydro": steps})
        with counted_main_path(label, expect) as launches:
            S = pack(U)
            del U
            S, t, _dt = run_chunks(label, card, advance, S, t, n, chunk)
        for name, c in launches.items():
            total[name] = total.get(name, 0) + c

        if not bool(torch.isfinite(S).all()):
            raise AssertionError(f"{problem}: non-finite state after the main path")
        rho_min, p_min = float(S[0].min()), float(hydro_pressure(params, S).min())
        mass, energy = float(S[0].double().sum()), float(S[1].double().sum())
        mass_rel, energy_rel = abs(mass - mass0) / abs(mass0), abs(energy - energy0) / abs(energy0)
        print(f"[{label}] {steps} steps at {n}^3 f32: t={float(t)!r}, min rho {rho_min:.4e}, "
              f"min p {p_min:.4e}, mass rel {mass_rel:.3e} (1e-5), energy rel {energy_rel:.3e}"
              + (" (1e-4)" if problem == "blast" else ""))
        if not (rho_min > 0 and p_min > 0):
            raise AssertionError(f"{problem}: non-positive density or pressure")
        if not mass_rel <= 1e-5 or (problem == "blast" and not energy_rel <= 1e-4):
            raise AssertionError(f"{problem}: conservation bound violated")
        U_out = unpack(S, t)
        if tuple(U_out.shape) != params.shape:
            raise AssertionError(f"unpacked shape {tuple(U_out.shape)} != {params.shape}")
        del U_out
        check_streamed(f"{label}p", kernel, profile_chunk(f"{label}p", card, advance, S, t, chunk))
        if kept is None:
            kept = (params, S)
        else:
            del S
    return total, kept


def hydro_stream_report(label: str, card: str, dtype: str, mode: str, ms: float,
                        bound_ms: float, by: str) -> None:
    """One line of the streamed hydro body's shape and time for a mode and
    dtype: the tile, the warps of each group, the blocks an SM holds, the
    ring bytes and the z chunk depth at 256^3 (csrc/hydro_stream.cuh)."""
    from ramsesgpu_tpu_torch.kernels.build import load_library

    lib = load_library("cuda")
    f64 = int(dtype == "float64")
    tile = (ctypes.c_int * 6)()
    lib.ramses_hydro_stream_tile(f64, tile)
    blocks = lib.ramses_hydro_step_blocks(f64)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"[{label}] {mode} {dtype} 256^3: tile {tile[0]}x{tile[1]}, {tile[3] // 32} + "
          f"{tile[4] // 32} warps (producer + consumer), {blocks / sms:g} blocks/SM "
          f"({blocks} blocks), ring {lib.ramses_hydro_stream_ring_bytes(f64)} B, z chunks "
          f"{lib.ramses_hydro_stream_chunk_depth(f64, 256, 256, 256, blocks)} deep; "
          f"{ms:.4f} ms against a bound of {bound_ms:.4f} ms ({by}): {ms / bound_ms:.1f}x ({card})")


def hydro_ops(params, S: torch.Tensor, dt: float, newton: int) -> dict:
    """The operations one 256^3 hydro step needs on the state S: the
    counting build on its 32^3 corner with the kernels' own per-cell
    functions (one trace per cell, one Riemann solve per face, per Newton
    iteration), with the Newton iterations ``newton`` the card counted on
    the whole state."""
    from ramsesgpu_tpu_torch.kernels.build import load_library, param_block
    from ramsesgpu_tpu_torch.kernels.packed_bc import bc_codes

    lib = load_library("count")
    p_sub = block_params(params, 32)
    S_sub = S[:, :32, :32, :32].double().contiguous().cpu()
    parts, fixed = (ctypes.c_longlong * 4)(), (ctypes.c_longlong * 4)()
    iters = torch.zeros((), dtype=torch.int64)
    lib.ramses_hydro_step_ops(S_sub.data_ptr(), 32, 32, 32, bc_codes(p_sub), param_block(p_sub),
                              dt, parts, iters.data_ptr())
    p0 = p_sub.replace(niter_riemann=0)  # the same code path without the Newton loop
    lib.ramses_hydro_step_ops(S_sub.data_ptr(), 32, 32, 32, bc_codes(p0), param_block(p0), dt,
                              fixed, None)
    n, faces_sub, faces = 256 ** 3, 3 * 32 * 32 * 33, 3 * 256 * 256 * 257
    out = {"per_iter": (parts[2] - fixed[2]) / max(int(iters), 1),
           "per_cell": (fixed[0] + fixed[1] + fixed[3]) / 32 ** 3,
           "per_face": fixed[2] / faces_sub,
           "parts": [fixed[i] / 32 ** 3 for i in (0, 1, 3)],
           "cfl": lib.ramses_cfl_hydro_ops(S_sub.data_ptr(), 32, 32, 32, 0,
                                           param_block(p_sub)) / 32 ** 3 * n}
    out["ops"] = out["per_cell"] * n + out["per_face"] * faces + out["per_iter"] * newton
    return out


def hydro_bound(nbytes: float, ops: float, dtype: str) -> tuple:
    """(bound_ms, bound_by): bytes over the memory rate against operations
    over the dtype's peak (f32 67, f64 34 TFLOP/s outside the tensor cores,
    NVIDIA's H100 SXM data sheet)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / (F32_FLOP_PER_S if dtype == "float32" else F64_FLOP_PER_S) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase10(card: str, implode, twin_peak_64: int) -> dict:
    """The hydro kernels at 256^3 on the implode main path's state; the
    step kernel's interior mode (walls), its ghosted mode (make_step_fn's,
    TPU row 5) and its in-place ghosted mode (the jet's), f32 and f64 (the
    f32 end state in f64), each with the streamed body's shape and its time
    against its bound."""
    from ramsesgpu_tpu_torch.kernels.cfl_hydro import cfl_hydro
    from ramsesgpu_tpu_torch.kernels.hydro_step import hydro_step
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries_concat
    from ramsesgpu_tpu_torch.solvers.godunov import (hydro_3d_interior_update,
                                                     hydro_3d_state_update)
    from ramsesgpu_tpu_torch.solvers.timestep import compute_inv_dt_hydro, dt_from_inv

    params, S0 = implode
    torch.cuda.empty_cache()
    free, _total = torch.cuda.mem_get_info()
    full = twin_peak_64 * 64 < 0.8 * free
    if not full:
        print(f"[10] hydro twin estimated at {twin_peak_64 * 64 / 2**30:.1f} GiB does not fit "
              f"({free / 2**30:.1f} GiB free): twins checked and timed on a 128^3 block")
    active = torch.ones((), dtype=torch.bool, device="cuda")
    inv = cfl_hydro(params, S0)
    dt = dt_from_inv(params, inv)
    newton = torch.zeros((), dtype=torch.int64, device="cuda")
    S_k = hydro_step(params, S0, torch.empty_like(S0), dt, active, newton=newton)
    ms = {"cfl_hydro": time_ms(lambda: cfl_hydro(params, S0), 50)}
    # each mode and dtype of the step kernel, against its bound
    n = 256 ** 3
    modes = {}
    for dtype in ("float32", "float64"):
        S = S0 if dtype == "float32" else S0.double()
        dt_m = dt if dtype == "float32" else dt.double()
        count = torch.zeros((), dtype=torch.int64, device="cuda")
        hydro_step(params, S, torch.empty_like(S), dt_m, active, newton=count)
        ops = hydro_ops(params, S, float(dt_m), int(count))["ops"]
        U = make_boundaries_concat(params, S, interior_only=True)
        out, Uw, buf = torch.empty_like(S), U.clone(), hydro_step.scratch(params, U)
        size = S.element_size()
        for mode, fn, nbytes in (
                ("interior (walls)", lambda: hydro_step(params, S, out, dt_m, active),
                 2 * 5 * size * n),
                ("ghosted", lambda: hydro_step.ghosted(params, U, dt_m), 5 * size * (n + 260 ** 3)),
                ("ghosted in place", lambda: hydro_step.ghosted_(params, Uw, dt_m, active, buf),
                 5 * size * (n + 260 ** 3))):
            t = time_ms(fn, 10)
            modes[(mode, dtype)] = (t, *hydro_bound(nbytes, ops, dtype))
            hydro_stream_report("10", card, dtype, mode, *modes[(mode, dtype)])
        del S, U, out, Uw, buf
    ms["hydro_step"] = modes[("interior (walls)", "float32")][0]
    ms["hydro_step_ghosted"] = modes[("ghosted", "float32")][0]
    # the ghosted mode on the filled ghosted state: the same kernel as the
    # interior mode on a copy of the same state values, so bitwise equal
    U = make_boundaries_concat(params, S0, interior_only=True)
    S_g = hydro_step.ghosted(params, U, dt)
    differ = (S_g != S_k).any(0)
    print(f"[10] hydro_step ghosted mode at 256^3 f32 on make_boundaries(implode state) against "
          f"the interior mode: equal {not bool(differ.any())}, {int(differ.sum())} cells differ, "
          f"rel L2 {rel_l2(S_g, S_k):.3e}, max abs {float((S_g - S_k).abs().max()):.3e}")
    if bool(differ.any()):
        raise AssertionError("hydro_step: the ghosted and the interior mode differ at 256^3")
    del U, differ
    if not full:
        params = block_params(params, 128)
        S0 = S0[:, :128, :128, :128].contiguous()
        inv = cfl_hydro(params, S0)
        S_k = hydro_step(params, S0, torch.empty_like(S0), dt, active)
    U = make_boundaries_concat(params, S0, interior_only=True)
    if not full:
        S_g = hydro_step.ghosted(params, U, dt)
    torch.cuda.empty_cache()
    inv_t = compute_inv_dt_hydro(params, S0, ghost=0)
    S_t = hydro_3d_state_update(params, S0, dt)
    errs = {"cfl_hydro": abs(float(inv) - float(inv_t)),
            "hydro_step": float((S_k - S_t).abs().max()),
            "hydro_step_ghosted": float((S_g - S_t).abs().max())}
    rel = {"cfl_hydro": errs["cfl_hydro"] / abs(float(inv_t)), "hydro_step": rel_l2(S_k, S_t),
           "hydro_step_ghosted": rel_l2(S_g, S_t)}
    tol = {"cfl_hydro": TOL_CFL["float32"], "hydro_step": TOL_STEP1["float32"],
           "hydro_step_ghosted": TOL_STEP1["float32"]}
    del S_k, S_t, S_g
    plain = {
        "hydro_step": time_ms(lambda: hydro_3d_state_update(params, S0, dt), 3),
        "cfl_hydro": time_ms(lambda: compute_inv_dt_hydro(params, S0, ghost=0), 10),
        "hydro_step_ghosted": time_ms(lambda: hydro_3d_interior_update(params, U, dt), 3),
    }
    del U
    n_twin = params.nx
    for name in ("hydro_step", "cfl_hydro", "hydro_step_ghosted"):
        print(f"[10] {name} at {n_twin}^3 f32 (implode state): kernel vs twin rel err "
              f"{rel[name]:.3e} (tol {tol[name]:.0e}), max abs {errs[name]:.3e}")
        if not rel[name] <= tol[name]:
            raise AssertionError(f"{name} disagrees with its twin at {n_twin}^3: {rel[name]}")
    for name in ("hydro_step", "cfl_hydro", "hydro_step_ghosted"):
        print(f"[10] {name}: kernel {ms[name]:.3f} ms at 256^3, twin {plain[name]:.3f} ms "
              f"at {n_twin}^3 (f32, {card})")
    print(f"[10] approx solver Newton iterations in one 256^3 step: {int(newton)} "
          f"({int(newton) / (3 * 256 ** 3):.4f} per face)")
    return {"ms": ms, "plain_ms": plain, "max_abs_err": errs, "newton": int(newton),
            "params": implode[0], "dt": float(dt),
            "state": implode[1][:, :32, :32, :32].contiguous()}


def phase11(mhd: dict, hydro: dict) -> dict:
    """bound_ms and bound_by of every kernel at the inputs phases 6 and 10
    timed: max(bytes / memory rate, flops / f32 rate). Bytes: each input
    value read once and each output written once. Flops: the arithmetic the
    function needs, counted by the counting build on a 32^3 block of those
    inputs with the kernels' own per-cell functions (for hydro_step: one
    trace per cell, one Riemann solve per face, per Newton iteration),
    scaled to 256^3 with the Newton iterations the card counted."""
    from ramsesgpu_tpu_torch.kernels.build import load_library, param_block

    lib = load_library("count")
    n = 256 ** 3
    ops = {}

    p_sub, S_sub, dt = mhd["bound_input"]
    S_sub = S_sub.double().contiguous()
    ops["mhd_step"] = lib.ramses_mhd_step_ops(S_sub.data_ptr(), 0, 32, 32, 32, param_block(p_sub),
                                              dt) / 32 ** 3 * n
    ops["cfl_mhd"] = lib.ramses_cfl_mhd_ops(S_sub.data_ptr(), 32, 32, 32,
                                            param_block(p_sub)) / 32 ** 3 * n

    # [prim, trace, face fluxes, update]
    h = hydro_ops(hydro["params"], hydro["state"], hydro["dt"], hydro["newton"])
    per_cell, per_face, per_iter = h["per_cell"], h["per_face"], h["per_iter"]
    ops["hydro_step"] = h["ops"]
    ops["hydro_step_ghosted"] = ops["hydro_step"]
    ops["cfl_hydro"] = h["cfl"]
    print(f"[11] counted flops: hydro_step {per_cell:.1f}/cell (prim {h['parts'][0]:.1f}, "
          f"trace {h['parts'][1]:.1f}, update {h['parts'][2]:.1f}) + {per_face:.1f}/face "
          f"+ {per_iter:.1f}/Newton iteration = {ops['hydro_step'] / n:.1f}/cell; "
          f"mhd_step {ops['mhd_step'] / n:.1f}/cell; cfl_mhd {ops['cfl_mhd'] / n:.1f}/cell; "
          f"cfl_hydro {ops['cfl_hydro'] / n:.1f}/cell")

    nbytes = {"mhd_step": 2 * 8 * 4 * n, "cfl_mhd": 8 * 4 * n,
              "hydro_step": 2 * 5 * 4 * n, "cfl_hydro": 5 * 4 * n,
              "hydro_step_ghosted": 5 * 4 * (n + 260 ** 3)}
    bounds = {}
    for name in nbytes:
        t_bytes = nbytes[name] / HBM_BYTES_PER_S * 1e3
        t_ops = ops[name] / F32_FLOP_PER_S * 1e3
        bounds[name] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
        print(f"[11] {name} at 256^3 f32: {nbytes[name] / 1e9:.3f} GB -> {t_bytes:.4f} ms, "
              f"{ops[name] / 1e9:.3f} GFLOP -> {t_ops:.4f} ms: bound {bounds[name][0]:.4f} ms "
              f"by {bounds[name][1]}")
    bounds["ops"] = ops  # the operation counts, for the streamed kernels' bounds (phase 32)
    return bounds


def mri_setup(nx: int, ny: int, nz: int, dtype: str, coeffs: float | None = None,
              nu: float = 0.0, eta: float = 0.0, compensated: bool | None = False,
              ini: str = MRI_INI):
    """``ini`` (data/mhd_mri_3d.ini) at nx x ny x nz with compensated=no (or
    yes; None: as the file says); with ``coeffs``, omega0 = cIso = coeffs
    (the JAX package's shear tests use 1); viscosity nu and resistivity eta
    (when not 0). Returns params, the config and the loop state (S, kept)
    on the card (with zero carries when compensated)."""
    from ramsesgpu_tpu_torch.config.configmap import ConfigMap
    from ramsesgpu_tpu_torch.config.params import params_from_config
    from ramsesgpu_tpu_torch.convert import torch_dtype
    from ramsesgpu_tpu_torch.kernels.shear import pack
    from ramsesgpu_tpu_torch.problems import init_problem
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries

    config = ConfigMap(Path(ini))
    for axis, n in (("nx", nx), ("ny", ny), ("nz", nz)):
        config.set_integer("mesh", axis, n)
    config.set_string("implementation", "dtype", dtype)
    if compensated is not None:
        config.set_string("implementation", "compensated", "yes" if compensated else "no")
    if coeffs is not None:
        config.set_float("MHD", "omega0", coeffs)
        config.set_float("hydro", "cIso", coeffs)
    if nu or eta:
        config.set_float("hydro", "nu", nu)
        config.set_float("MHD", "eta", eta)
    params = params_from_config(config)
    U0 = torch.from_numpy(init_problem(params, config))
    U = make_boundaries(params, U0.to(device="cuda", dtype=torch_dtype(params)))
    return params, config, pack(params, U)


def shear_t0(params, dtype) -> torch.Tensor:
    """A time whose sheared-fill offset is 2.5 cells (jplus 2, fraction
    0.5): at t = 0 the fill is periodic and would test nothing."""
    t0 = 2.5 * params.dy / (1.5 * params.omega0 * params.dx * params.nx)
    return torch.tensor(t0, dtype=dtype, device="cuda")


def state_rel(a, b) -> float:
    """Relative L2 of two loop states (S, kept) as one vector."""
    num = torch.linalg.norm((a[0] - b[0]).double()) ** 2 + torch.linalg.norm((a[1] - b[1]).double()) ** 2
    den = torch.linalg.norm(b[0].double()) ** 2 + torch.linalg.norm(b[1].double()) ** 2
    return float((num / den).sqrt())


def check(label: str, rel: float, tol: float, extra: str = "") -> None:
    print(f"[{label}] rel err {rel:.3e} (tol {tol:.0e}){extra}")
    if not rel <= tol:
        raise AssertionError(f"{label}: kernel disagrees with its twin: {rel}")


PLANES = ("fpl_min", "fpl_max", "eypl_min", "eypl_max", "ezpl_max")


def shear_outputs(params, planes, S2, kept2, rem) -> dict:
    """Each output of the two shear-step kernels on its own, with its
    tolerance table: the step's five unremapped x-face planes; the border
    kernel's four remapped planes, the three channels it changes on the
    border columns 0 and nx-1 (density, Bx, Bz), and the kept face. On its
    own, so that a small output (an emfY plane beside the density-flux
    planes, 2 border columns of nx) cannot hide under a larger one's norm."""
    cols = (0, params.nx - 1)
    out = {f"plane {name} before the remap": (planes[i], TOL_PLANES)
           for i, name in enumerate(PLANES)}
    out.update({f"plane {name} after the remap": (rem[i], TOL_STEP1)
                for i, name in enumerate(PLANES[:4])})
    out.update({f"border columns {name}": (S2[c][..., cols], TOL_STEP1)
                for name, c in (("rho", 0), ("Bx", 5), ("Bz", 7))})
    out["kept face"] = (kept2, TOL_STEP1)
    return out


def check_shear_outputs(label: str, got: dict, want: dict, dtype: str) -> None:
    for name, (value, tol) in got.items():
        check(f"{label} {name}", rel_l2(value, want[name][0]), tol[dtype])


def phase12() -> None:
    from ramsesgpu_tpu_torch.kernels.cfl_mhd import cfl_mhd
    from ramsesgpu_tpu_torch.kernels.mhd_step import mhd_step
    from ramsesgpu_tpu_torch.kernels.shear import make_advance_n
    from ramsesgpu_tpu_torch.kernels.shear_border import shear_border, shear_slabs
    from ramsesgpu_tpu_torch.solvers.godunov_mhd import (mhd_3d_shear_step, mhd_3d_shear_update,
                                                         shear_border_update)
    from ramsesgpu_tpu_torch.solvers.shear import shear_offset
    from ramsesgpu_tpu_torch.solvers.shear import shear_slabs as slabs_twin
    from ramsesgpu_tpu_torch.solvers.timestep import dt_from_inv, inv_dt_mhd_shear

    for name, coeffs in (("omega0=cIso=1", 1.0), ("ini omega0=cIso=0.001", None)):
        for dtype in ("float32", "float64"):
            params, _config, (S, kept) = mri_setup(64, 128, 64, dtype, coeffs)
            tag = f"12 {name} {dtype} 64x128x64"
            t0 = shear_t0(params, S.dtype)
            jplus, epsi = shear_offset(params, t0)
            print(f"[{tag}] t0 {float(t0)!r}: jplus {int(jplus)}, fraction "
                  f"{float(epsi) / params.dy:.3f}")
            tol1, tol10 = TOL_STEP1[dtype], TOL_STEP10[dtype]
            inv, inv_t = cfl_mhd(params, S, kept=kept), inv_dt_mhd_shear(params, S, kept)
            check(f"{tag} cfl_mhd shear", abs(float(inv) - float(inv_t)) / float(inv_t),
                  TOL_CFL[dtype])
            S_nan = S.clone()
            S_nan[3, 5, 7, 9] = float("nan")
            if not torch.isnan(cfl_mhd(params, S_nan, kept=kept)):
                raise AssertionError("cfl_mhd's shear mode does not propagate NaN")
            dt = dt_from_inv(params, inv_t)
            active = torch.ones((), dtype=torch.bool, device="cuda")

            slabs_t = slabs_twin(params, S, kept, t0 + dt)
            check(f"{tag} shear_slabs", rel_l2(shear_slabs(params, S, kept, t0, dt), slabs_t),
                  tol1)
            planes = torch.zeros((5, params.nz, params.ny), dtype=S.dtype, device="cuda")
            S1 = mhd_step(params, S.clone(), dt, active, mhd_step.scratch(params, S),
                          shear=(slabs_t, planes))
            S1_t, planes_t = mhd_3d_shear_update(params, S, slabs_t, dt)
            check(f"{tag} mhd_step shear", rel_l2(S1, S1_t), tol1)
            check(f"{tag} the 5 x-face planes before the remap", rel_l2(planes, planes_t), tol1)
            S2, kept2 = S1_t.clone(), kept.clone()
            rem = shear_border(params, S2, kept2, planes_t, t0, dt, active)
            S2_t, kept2_t, rem_t = shear_border_update(params, S1_t, kept, planes_t, t0, dt)
            check(f"{tag} shear_border", state_rel((S2, kept2), (S2_t, kept2_t)), tol1)
            check_shear_outputs(tag, shear_outputs(params, planes, S2, kept2, rem),
                                shear_outputs(params, planes_t, S2_t, kept2_t, rem_t), dtype)

            _pack, advance, _unpack = make_advance_n(params, "cuda", packed_form=True)
            state, t_k, k = advance((S.clone(), kept.clone()), t0.clone(), 1)
            twin = mhd_3d_shear_step(params, S, kept, t0, dt)
            check(f"{tag} 1 step of the loop", state_rel(state, twin), tol1)
            state, t_k, k = advance(state, t_k, 9)
            twin_t = t0 + dt
            for _ in range(9):
                dt_t = dt_from_inv(params, inv_dt_mhd_shear(params, *twin))
                twin = mhd_3d_shear_step(params, *twin, twin_t, dt_t)
                twin_t = twin_t + dt_t
            check(f"{tag} 10 chained steps", state_rel(state, twin), tol10,
                  f": t kernel {float(t_k)!r} twin {float(twin_t)!r}")
    print("[12] cfl_mhd's shear mode propagates NaN")


def div_b_shear(params, S: torch.Tensor, kept: torch.Tensor) -> float:
    """max |divB| of the loop state: Bx's +1 x face of the last column is
    the kept face, y and z wrap."""
    bx, by, bz = (S[c].double() for c in (5, 6, 7))
    bx_r = torch.cat([bx[..., 1:], kept.double()[..., None]], dim=-1)
    div = ((bx_r - bx) / params.dx + (torch.roll(by, -1, -2) - by) / params.dy
           + (torch.roll(bz, -1, -3) - bz) / params.dz)
    return float(div.abs().max())


def phase13(card: str, label: str = "13", nu: float = 0.0, eta: float = 0.0,
            compensated: bool | None = False, ini: str = MRI_INI, kernel: str = "auto"):
    """The MRI main path, ideal or (phase 18) with viscosity nu and
    resistivity eta; with ``compensated`` None and ``ini`` (phases 23, 24)
    a shipped input exactly as shipped but for the mesh; with kernel=zcarry
    (phases 30-30s) on the streamed step kernel. Returns its launch counts
    and its final state."""
    from ramsesgpu_tpu_torch.kernels.cfl_mhd import cfl_mhd
    from ramsesgpu_tpu_torch.solvers.step import make_packed_advance_chain
    from ramsesgpu_tpu_torch.solvers.stratified import uses_stratified_z
    from ramsesgpu_tpu_torch.solvers.timestep import dt_from_inv

    nx, ny, nz, chunk = 128, 256, 128, 10
    params, config, (S0, kept0) = mri_setup(nx, ny, nz, "float32", nu=nu, eta=eta,
                                            compensated=compensated, ini=ini)
    params = params.replace(kernel=kernel)
    strat = uses_stratified_z(params)
    print(f"[{label}] {ini} at {nx}x{ny}x{nz}: compensated={params.compensated}, slope_type "
          f"{params.slope_type}, cIso {params.c_iso}, omega0 {params.omega0}, z faces "
          f"{[b.name for b in params.boundary_types[4:]]}")
    dt_first = float(dt_from_inv(params, cfl_mhd(params, S0, kept=kept0)))
    mass0 = float(S0[0].double().sum())
    v_max = float((S0[2:5] / S0[0]).abs().max())
    print(f"[{label}] initial state: first dt {dt_first!r}, max |v| {v_max:.4e} "
          f"({v_max / max(params.c_iso, 1e-30):.3g} cIso), min rho {float(S0[0].min()):.4e}")
    pack, advance, unpack = make_packed_advance_chain(params, "cuda", config)
    U = unpack((S0, kept0), torch.zeros((), device="cuda"))  # the ghosted state a Run holds
    del S0, kept0
    t = torch.zeros((), dtype=torch.float32, device="cuda")
    steps = 5 * chunk
    step_kernel = "zcarry_mhd" if kernel == "zcarry" else "mhd_step"
    expect = {step_kernel: steps, "cfl_mhd": steps, "shear_slabs": steps, "shear_border": steps}
    if nu > 0 or eta > 0:
        expect.update(shear_slabs=2 * steps, dissip_step=steps)
    if strat:
        expect["shear_zslabs"] = steps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with counted_main_path(label, expect) as launches:
        state = pack(U)
        del U
        state, t, dt_timed = run_chunks(label, card, advance, state, t, f"{nx}x{ny}x{nz}",
                                        chunk, cells=nx * ny * nz)
    S, kept = state
    print(f"[{label}] peak device memory of the path: "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB (the state {S.nbytes / 1e9:.3f} GB; "
          f"kernel={kernel}, {card})")
    if nu > 0 or eta > 0:
        diffusion_numbers(label, params, {
            "first step": dt_first, "timed steps (mean)": dt_timed,
            "next step": float(dt_from_inv(params, cfl_mhd(params, S, kept=kept)))})
    if not (bool(torch.isfinite(S).all()) and bool(torch.isfinite(kept).all())):
        raise AssertionError("non-finite state after the MRI main path")
    face = kept[0] if params.compensated else kept
    b_over_dx = max(float(S[5:8].abs().max()), float(face.abs().max()), 1e-30) / params.dx
    divb = div_b_shear(params, S, face)
    mass = float(S[0].double().sum())
    # the stratified box loses mass through its z faces (bounded in phase 24m)
    mass_tol = MASS_STRAT_TOL if strat else 1e-5
    print(f"[{label}] {steps} steps at {nx}x{ny}x{nz} f32: t={float(t)!r}, max|divB|={divb:.3e} "
          f"(bound {1e-3 * b_over_dx:.3e}), mass rel {abs(mass - mass0) / abs(mass0):.3e} "
          f"({mass_tol:.0e}), min rho {float(S[0].min()):.4e}")
    if not divb < 1e-3 * b_over_dx:
        raise AssertionError("divB bound violated on the MRI path")
    if not abs(mass - mass0) <= mass_tol * abs(mass0) or not float(S[0].min()) > 0:
        raise AssertionError("mass bound violated on the MRI path")
    U_out = unpack(state, t)
    if tuple(U_out.shape) != params.shape:
        raise AssertionError(f"unpacked shape {tuple(U_out.shape)} != {params.shape}")
    del U_out
    check_streamed(f"{label}p", kernel, profile_chunk(f"{label}p", card, advance, state, t, chunk))
    return launches, (params, S, kept, t, config)


def phase14(card: str, mri) -> dict:
    """The shear kernels at 128x256x128 f32 on the MRI path's state, each
    against its twin and its time against the twin's."""
    from ramsesgpu_tpu_torch.kernels.cfl_mhd import cfl_mhd
    from ramsesgpu_tpu_torch.kernels.mhd_step import mhd_step
    from ramsesgpu_tpu_torch.kernels.shear_border import shear_border, shear_slabs
    from ramsesgpu_tpu_torch.solvers.godunov_mhd import mhd_3d_shear_update, shear_border_update
    from ramsesgpu_tpu_torch.solvers.shear import shear_slabs as slabs_twin
    from ramsesgpu_tpu_torch.solvers.timestep import dt_from_inv, inv_dt_mhd_shear

    params, S, kept, t, _config = mri
    active = torch.ones((), dtype=torch.bool, device="cuda")
    inv = cfl_mhd(params, S, kept=kept)
    dt = dt_from_inv(params, inv)
    slabs = shear_slabs(params, S, kept, t, dt)
    scratch = mhd_step.scratch(params, S)
    planes = torch.zeros((5, params.nz, params.ny), dtype=S.dtype, device="cuda")
    S1 = mhd_step(params, S.clone(), dt, active, scratch, shear=(slabs, planes))
    S2, kept2 = S1.clone(), kept.clone()
    rem = shear_border(params, S2, kept2, planes, t, dt, active)
    # timing buffers, overwritten by the timed launches
    Sw, kw, slabs_w, planes_w = S.clone(), kept.clone(), slabs.clone(), planes.clone()
    rem_w = rem.clone()
    ms = {
        "cfl_mhd_shear": time_ms(lambda: cfl_mhd(params, S, kept=kept), 50),
        "shear_slabs": time_ms(lambda: shear_slabs(params, S, kept, t, dt, out=slabs_w), 50),
        "mhd_step_shear": time_ms(lambda: mhd_step(params, Sw, dt, active, scratch,
                                                   shear=(slabs_w, planes_w)), 10),
        "shear_border": time_ms(lambda: shear_border(params, Sw, kw, planes_w, t, dt, active,
                                                     rem_w), 50),
    }
    del scratch, Sw, kw, slabs_w, planes_w, rem_w
    torch.cuda.empty_cache()
    # the twins on the kernels' inputs
    inv_t = inv_dt_mhd_shear(params, S, kept)
    slabs_t = slabs_twin(params, S, kept, t + dt)
    S1_t, planes_t = mhd_3d_shear_update(params, S, slabs, dt)
    S2_t, kept2_t, rem_t = shear_border_update(params, S1, kept, planes, t, dt)
    errs = {"cfl_mhd_shear": abs(float(inv) - float(inv_t)),
            "shear_slabs": float((slabs - slabs_t).abs().max()),
            "mhd_step_shear": float((S1 - S1_t).abs().max()),
            "shear_border": max(float((S2 - S2_t).abs().max()),
                                float((kept2 - kept2_t).abs().max()))}
    rel = {"cfl_mhd_shear": errs["cfl_mhd_shear"] / abs(float(inv_t)),
           "shear_slabs": rel_l2(slabs, slabs_t), "mhd_step_shear": rel_l2(S1, S1_t),
           "shear_border": state_rel((S2, kept2), (S2_t, kept2_t))}
    twin_out = shear_outputs(params, planes_t, S2_t, kept2_t, rem_t)
    check_shear_outputs("14 128x256x128 f32", shear_outputs(params, planes, S2, kept2, rem),
                        twin_out, "float32")
    # the yardstick of TOL_PLANES: each output's own f32 rounding, the f32
    # twin against the f64 twin on the same inputs
    p64 = params.replace(dtype="float64")
    S1_64, planes_64 = mhd_3d_shear_update(p64, S.double(), slabs.double(), dt.double())
    del S1_64
    ref = shear_outputs(p64, planes_64, *shear_border_update(
        p64, S1.double(), kept.double(), planes.double(), t.double(), dt.double()))
    for name, (value, _tol) in twin_out.items():
        print(f"[14] {name}: f32 twin against f64 twin {rel_l2(value, ref[name][0]):.3e}")
    del ref, planes_64
    torch.cuda.empty_cache()
    plain = {
        "cfl_mhd_shear": time_ms(lambda: inv_dt_mhd_shear(params, S, kept), 10),
        "shear_slabs": time_ms(lambda: slabs_twin(params, S, kept, t + dt), 10),
        "mhd_step_shear": time_ms(lambda: mhd_3d_shear_update(params, S, slabs, dt), 3),
        "shear_border": time_ms(lambda: shear_border_update(params, S1, kept, planes, t, dt), 10),
    }
    stage_breakdown(card, params, S, kept, t, dt)
    tol = {"cfl_mhd_shear": TOL_CFL["float32"]}
    for name in ms:
        check(f"14 {name} 128x256x128 f32", rel[name], tol.get(name, TOL_STEP1["float32"]),
              f", max abs {errs[name]:.3e}")
        print(f"[14] {name}: kernel {ms[name]:.4f} ms, twin {plain[name]:.3f} ms "
              f"(128x256x128 f32, {card})")
    return {"ms": ms, "plain_ms": plain, "max_abs_err": errs, "params": params, "dt": float(dt),
            "t": float(t), "S": S, "kept": kept, "planes": planes}


def stage_times(fn, reps: int = 5) -> dict:
    """Device ms per call of each CUDA kernel fn launches (torch.profiler),
    by its stage name in the namespace ``mhd::``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key.split("mhd::")[1].split("<")[0] if "mhd::" in e.key else e.key[:40]:
            e.self_device_time_total / reps / 1e3
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def stage_breakdown(card: str, params, S, kept, t, dt) -> None:
    """The step kernel's stages, shear mode on the MRI state against the
    periodic mode on the Orszag-Tang state of the same 128x256x128 shape."""
    from ramsesgpu_tpu_torch.kernels.mhd_step import mhd_step
    from ramsesgpu_tpu_torch.kernels.shear_border import shear_slabs

    active = torch.ones((), dtype=torch.bool, device="cuda")
    slabs = shear_slabs(params, S, kept, t, dt)
    planes = torch.zeros((5, params.nz, params.ny), dtype=S.dtype, device="cuda")
    Sw, scratch = S.clone(), mhd_step.scratch(params, S)
    shear = stage_times(lambda: mhd_step(params, Sw, dt, active, scratch, shear=(slabs, planes)))
    del Sw, scratch
    p_ot, S_ot = setup(params.nx, "float32", ny=params.ny, nz=params.nz)
    scratch = mhd_step.scratch(p_ot, S_ot)
    periodic = stage_times(lambda: mhd_step(p_ot, S_ot, dt, active, scratch))
    del scratch, S_ot
    torch.cuda.empty_cache()
    print(f"[14] step kernel stages at 128x256x128 f32 ({card}): shear mode (MRI) "
          f"{sum(shear.values()):.3f} ms, periodic mode (Orszag-Tang) "
          f"{sum(periodic.values()):.3f} ms")
    for name in sorted(shear, key=shear.get, reverse=True):
        print(f"[14]   {name:12s} shear {shear[name]:.4f} ms, periodic "
              f"{periodic.get(name, 0.0):.4f} ms")


def phase15(shear: dict) -> dict:
    """bound_ms and bound_by of the shear kernels at phase 14's inputs, as
    phase 11: bytes each input read once and each output written once;
    flops counted by the counting build on an 8x32x128 block of the state
    (the full x extent: the shear mode's work depends on nx), scaled to
    the mesh."""
    from ramsesgpu_tpu_torch.kernels.build import load_library, param_block
    from ramsesgpu_tpu_torch.solvers.shear import shear_slabs as slabs_twin

    lib = load_library("count")
    params = shear["params"]
    nx, ny, nz = params.nx, params.ny, params.nz
    bz, by = 8, 32
    blk = params.replace(nz=bz, zmax=params.zmin + bz * params.dz,
                         ny=by, ymax=params.ymin + by * params.dy)
    S = shear["S"][:, :bz, :by].double().contiguous().cpu()
    kept = shear["kept"][:bz, :by].double().contiguous().cpu()
    planes = shear["planes"][:, :bz, :by].double().contiguous().cpu()
    t, dt = shear["t"], shear["dt"]
    slabs = slabs_twin(blk, S, kept, torch.tensor(t + dt, dtype=torch.float64)).contiguous()
    scale = (ny * nz) / (by * bz)
    pb = param_block(blk)
    ops = {
        "mhd_step_shear": lib.ramses_mhd_step_shear_ops(S.data_ptr(), slabs.data_ptr(), None, None,
                                                        0, nx, by, bz, pb, dt) * scale,
        "cfl_mhd_shear": lib.ramses_cfl_mhd_shear_ops(S.data_ptr(), kept.data_ptr(), nx, by, bz,
                                                      pb) * scale,
    }
    border = (ctypes.c_longlong * 3)()
    lib.ramses_shear_border_ops(S.data_ptr(), kept.data_ptr(), planes.data_ptr(), 0, nx, by, bz,
                                pb, t, dt, border)
    ops["shear_slabs"], ops["shear_border"] = border[0] * scale, border[1] * scale
    n, rows = nx * ny * nz, ny * nz
    nbytes = {"mhd_step_shear": 4 * (2 * 8 * n + 2 * 8 * 3 * rows + 5 * rows),
              "cfl_mhd_shear": 4 * (8 * n + rows),
              "shear_slabs": 4 * (2 * 8 * 3 * rows + rows + 2 * 8 * 3 * rows),
              "shear_border": 4 * (5 * rows + 2 * 5 * rows + 2 * rows + 4 * rows)}
    print(f"[15] counted flops: mhd_step_shear {ops['mhd_step_shear'] / n:.1f}/cell, "
          f"cfl_mhd_shear {ops['cfl_mhd_shear'] / n:.1f}/cell, shear_slabs "
          f"{ops['shear_slabs'] / rows:.1f} and shear_border {ops['shear_border'] / rows:.1f} "
          f"per (z, y) row")
    bounds = {}
    for name in ops:
        t_bytes = nbytes[name] / HBM_BYTES_PER_S * 1e3
        t_ops = ops[name] / F32_FLOP_PER_S * 1e3
        bounds[name] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
        print(f"[15] {name} at {nx}x{ny}x{nz} f32: {nbytes[name] / 1e9:.4f} GB -> {t_bytes:.5f} ms, "
              f"{ops[name] / 1e9:.4f} GFLOP -> {t_ops:.5f} ms: bound {bounds[name][0]:.5f} ms "
              f"by {bounds[name][1]}")
    return bounds


def increment_rel(got: torch.Tensor, want: torch.Tensor, start: torch.Tensor) -> float:
    """Relative L2 of the kernel's increment against the twin's, over the
    twin's increment: the dissipative change is orders of magnitude below
    the state, whose norm would hide a wrong term. Where the twin changes
    nothing, 0 if the kernel changes nothing either, else inf."""
    if torch.equal(want, start):
        return 0.0 if torch.equal(got, start) else float("inf")
    return rel_l2(got - start, want - start)


def dissip_mri(nx: int, ny: int, nz: int, dtype: str, ciso: float, nu: float, eta: float,
               noise: bool, compensated: bool = False):
    """The MRI box with omega0 = 1 stepped with cIso = ciso (its state is
    the isothermal box's: with cIso = 0 the MRI init is a state at rest),
    viscosity nu and resistivity eta: params, S, kept and a t0 whose shear
    offset is 2.5 cells. ``noise``: 20 % noise on B and the kept face (the
    initial field varies in x only, so its resistive change of the kept face
    would vanish)."""
    params, _config, (S, kept) = mri_setup(nx, ny, nz, dtype, 1.0, compensated=compensated)
    params = params.replace(c_iso=ciso, nu=nu, eta=eta)
    if noise:
        gen = torch.Generator(device="cuda").manual_seed(5)
        scale = 0.2 * float(S[7].abs().max())
        S[5:] += scale * torch.randn(S[5:].shape, generator=gen, device="cuda", dtype=S.dtype)
        kept += scale * torch.randn(kept.shape, generator=gen, device="cuda", dtype=S.dtype)
    return params, S, kept, shear_t0(params, S.dtype)


def phase16() -> None:
    from ramsesgpu_tpu_torch.kernels import fused_mhd3d, shear
    from ramsesgpu_tpu_torch.kernels.dissip_step import dissip_step
    from ramsesgpu_tpu_torch.solvers.dissipation import (kept_face_resistive_ct,
                                                          mhd_dissipation_periodic_update,
                                                          mhd_dissipation_shear_update)
    from ramsesgpu_tpu_torch.solvers.godunov_mhd import mhd_3d_periodic_step, mhd_3d_shear_step
    from ramsesgpu_tpu_torch.solvers.shear import shear_slabs as slabs_twin
    from ramsesgpu_tpu_torch.solvers.timestep import (dt_from_inv, inv_dt_mhd_periodic,
                                                      inv_dt_mhd_shear)

    active = torch.ones((), dtype=torch.bool, device="cuda")
    idle = torch.zeros((), dtype=torch.bool, device="cuda")
    modes = (("periodic 64^3 adiabatic", None), ("shear 64x128x64 isothermal", 1.0),
             ("shear 64x128x64 adiabatic", 0.0))
    for dtype in ("float32", "float64"):
        tol1, tol10 = TOL_STEP1[dtype], TOL_STEP10[dtype]
        for mode, ciso in modes:
            for cname, (nu, eta) in DISSIP_COEFFS.items():
                tag = f"16 dissip_step {mode} {dtype} {cname}"
                # one call against the twin on the same inputs
                if ciso is None:
                    params, S = setup(64, dtype)
                    params = params.replace(nu=nu, eta=eta)
                    dt = dt_from_inv(params, inv_dt_mhd_periodic(params, S))
                    want = mhd_dissipation_periodic_update(params, S, dt)
                    got = dissip_step(params, S, torch.empty_like(S), dt, active)
                    unchanged = torch.equal(
                        dissip_step(params, S, torch.full_like(S, float("nan")), dt, idle), S)
                else:
                    params, S, kept, t0 = dissip_mri(64, 128, 64, dtype, ciso, nu, eta, True)
                    dt = dt_from_inv(params, inv_dt_mhd_shear(params, S, kept))
                    slabs = slabs_twin(params, S, kept, t0 + dt)
                    want, eypl, ezpl = mhd_dissipation_shear_update(params, S, slabs, dt)
                    got, kept_got = torch.empty_like(S), kept.clone()
                    dissip_step(params, S, got, dt, active, shear=(slabs, kept_got))
                    S_idle, kept_idle = torch.full_like(S, float("nan")), kept.clone()
                    dissip_step(params, S, S_idle, dt, idle, shear=(slabs, kept_idle))
                    unchanged = torch.equal(S_idle, S) and torch.equal(kept_idle, kept)
                    if eta > 0:
                        kept_want = kept_face_resistive_ct(params, kept, eypl, ezpl, dt)
                        check(f"{tag} kept-face change", increment_rel(kept_got, kept_want, kept),
                              tol1)
                    elif not torch.equal(kept_got, kept):
                        raise AssertionError(f"{tag}: the kept face changed without resistivity")
                check(f"{tag} increment", increment_rel(got, want, S), tol1,
                      f", max abs {float((got - want).abs().max()):.3e}, increment norm / state "
                      f"norm {rel_l2(want, S):.3e}")
                if not unchanged:
                    raise AssertionError(f"{tag}: the inactive kernel changed its inputs")

                # 1 and 10 chained loop steps against the twins' loop
                if ciso is None:
                    _pack, advance, _unpack = fused_mhd3d.make_advance_n(params, "cuda",
                                                                          packed_form=True)
                    state0, t0, rel = S, torch.zeros((), dtype=S.dtype, device="cuda"), rel_l2

                    def twin_step(st, t):
                        dt = dt_from_inv(params, inv_dt_mhd_periodic(params, st))
                        return mhd_3d_periodic_step(params, st, dt), t + dt
                else:
                    params, S, kept, t0 = dissip_mri(64, 128, 64, dtype, ciso, nu, eta, False)
                    _pack, advance, _unpack = shear.make_advance_n(params, "cuda",
                                                                    packed_form=True)
                    state0, rel = (S, kept), state_rel

                    def twin_step(st, t):
                        dt = dt_from_inv(params, inv_dt_mhd_shear(params, *st))
                        return mhd_3d_shear_step(params, *st, t, dt), t + dt
                start = (tuple(x.clone() for x in state0) if isinstance(state0, tuple)
                         else state0.clone())
                state, t_k, k = advance(start, t0.clone(), 1)
                twin, t_t = twin_step(state0, t0)
                check(f"{tag} 1 loop step", rel(state, twin), tol1)
                state, t_k, k = advance(state, t_k, 9)
                for _ in range(9):
                    twin, t_t = twin_step(twin, t_t)
                check(f"{tag} 10 chained loop steps", rel(state, twin), tol10,
                      f": t kernel {float(t_k)!r} twin {float(t_t)!r}")
                if int(k) != 9:
                    raise AssertionError(f"{tag}: the loop stopped early")


def dissip_bytes(params, shear: bool) -> int:
    """The bytes the f32 sub-step must move: each channel it reads once (rho
    and the momenta with nu > 0, B with eta > 0, E unless isothermal), each
    it changes written once (the momenta with nu, B with eta, E unless
    isothermal); the shear mode also reads the XH = 2 slab columns per side
    its stencil reaches and writes the kept face (with eta)."""
    iso, visc, resist = params.c_iso > 0, params.nu > 0, params.eta > 0
    read = 4 * visc + 3 * resist + (not iso)
    written = 3 * visc + 3 * resist + (not iso)
    n, rows = params.nx * params.ny * params.nz, params.ny * params.nz
    values = (read + written) * n
    if shear:
        values += 2 * 2 * read * rows + resist * rows
    return 4 * values


def phase19(card: str, ot, mri) -> dict:
    """The dissipation kernel at full width on the end states of phases 17
    (periodic, 256^3) and 18 (shear, 128x256x128): its increment and kept
    face against the twin's on the same inputs, its time against the
    twin's, its launch (tile, threads, ring bytes, registers, blocks an
    SM), and its bound: max(bytes / memory rate, the operations counted
    by the counting build on a 32^3 block (periodic) or an 8x32x128 block
    (shear) of the state, scaled / f32 rate)."""
    from ramsesgpu_tpu_torch.kernels.build import load_library, param_block
    from ramsesgpu_tpu_torch.kernels.cfl_mhd import cfl_mhd
    from ramsesgpu_tpu_torch.kernels.dissip_step import dissip_step, launch_info
    from ramsesgpu_tpu_torch.kernels.shear_border import shear_slabs
    from ramsesgpu_tpu_torch.solvers.dissipation import (kept_face_resistive_ct,
                                                          mhd_dissipation_periodic_update,
                                                          mhd_dissipation_shear_update)
    from ramsesgpu_tpu_torch.solvers.shear import shear_slabs as slabs_twin
    from ramsesgpu_tpu_torch.solvers.timestep import dt_from_inv

    lib = load_library("count")
    lib_cuda = load_library("cuda")
    active = torch.ones((), dtype=torch.bool, device="cuda")
    out = {"ms": {}, "plain_ms": {}, "max_abs_err": {}, "bounds": {}}
    tol = TOL_STEP1["float32"]

    params, S, _t = ot
    name, size = "dissip_step", f"{params.nx}x{params.ny}x{params.nz}"
    dt = dt_from_inv(params, cfl_mhd(params, S))
    got = dissip_step(params, S, torch.empty_like(S), dt, active)
    Sw = torch.empty_like(S)
    out["ms"][name] = time_ms(lambda: dissip_step(params, S, Sw, dt, active), 10)
    launches = {"periodic": launch_info(lib_cuda, params, S.dtype)}
    del Sw
    torch.cuda.empty_cache()
    want = mhd_dissipation_periodic_update(params, S, dt)
    out["max_abs_err"][name] = float((got - want).abs().max())
    check(f"19 {name} {size} f32 increment", increment_rel(got, want, S), tol,
          f", max abs {out['max_abs_err'][name]:.3e}, increment norm / state norm "
          f"{rel_l2(want, S):.3e}")
    del got, want
    torch.cuda.empty_cache()
    out["plain_ms"][name] = time_ms(lambda: mhd_dissipation_periodic_update(params, S, dt), 3)
    blk = block_params(params, 32)
    S_sub = S[:, :32, :32, :32].double().contiguous().cpu()
    ops = lib.ramses_dissip_step_ops(S_sub.data_ptr(), None, 0, 32, 32, 32, param_block(blk),
                                     float(dt)) / 32 ** 3 * (params.nx * params.ny * params.nz)
    rows = {name: (params, ops, dissip_bytes(params, False), size)}

    params, S, kept, t, _config = mri
    name, size = "dissip_step_shear", f"{params.nx}x{params.ny}x{params.nz}"
    dt = dt_from_inv(params, cfl_mhd(params, S, kept=kept))
    slabs = shear_slabs(params, S, kept, t, dt)
    got, kept_got = torch.empty_like(S), kept.clone()
    dissip_step(params, S, got, dt, active, shear=(slabs, kept_got))
    Sw, kw = torch.empty_like(S), kept.clone()
    out["ms"][name] = time_ms(lambda: dissip_step(params, S, Sw, dt, active, shear=(slabs, kw)),
                              10)
    launches["shear"] = launch_info(lib_cuda, params, S.dtype)
    del Sw, kw
    torch.cuda.empty_cache()

    def twin():
        S_new, eypl, ezpl = mhd_dissipation_shear_update(params, S, slabs, dt)
        return S_new, kept_face_resistive_ct(params, kept, eypl, ezpl, dt)

    want, kept_want = twin()
    out["max_abs_err"][name] = max(float((got - want).abs().max()),
                                   float((kept_got - kept_want).abs().max()))
    check(f"19 {name} {size} f32 increment", increment_rel(got, want, S), tol,
          f", increment norm / state norm {rel_l2(want, S):.3e}")
    check(f"19 {name} {size} f32 kept-face change", increment_rel(kept_got, kept_want, kept),
          tol, f", change norm / kept norm {rel_l2(kept_want, kept):.3e}")
    del got, want
    torch.cuda.empty_cache()
    out["plain_ms"][name] = time_ms(twin, 3)
    bz, by = 8, 32
    blk = params.replace(nz=bz, zmax=params.zmin + bz * params.dz,
                         ny=by, ymax=params.ymin + by * params.dy)
    S_sub = S[:, :bz, :by].double().contiguous().cpu()
    kept_sub = kept[:bz, :by].double().contiguous().cpu()
    slabs_sub = slabs_twin(blk, S_sub, kept_sub,
                           torch.tensor(float(t + dt), dtype=torch.float64)).contiguous()
    ops = lib.ramses_dissip_step_ops(S_sub.data_ptr(), slabs_sub.data_ptr(), 0, params.nx, by, bz,
                                     param_block(blk), float(dt))
    rows[name] = (params, ops * (params.ny * params.nz) / (by * bz), dissip_bytes(params, True),
                  size)

    for mode, li in launches.items():
        print(f"[19] dissip_step launch, {mode} mode f32: tile {li['tx']}x{li['ty']}, "
              f"{li['threads']} threads, rings {li['ring_bytes']} B, {li['registers']} registers "
              f"a thread, {li['blocks_per_sm']} block(s) an SM (one launch a sub-step, no "
              f"scratch in device memory)")
    for name, (p, ops, nbytes, size) in rows.items():
        n = p.nx * p.ny * p.nz
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F32_FLOP_PER_S * 1e3
        out["bounds"][name] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
        print(f"[19] {name} at {size} f32: {nbytes / n:.1f} B/cell, {nbytes / 1e9:.4f} GB -> "
              f"{t_bytes:.5f} ms; {ops / n:.1f} flop/cell, {ops / 1e9:.4f} GFLOP -> {t_ops:.5f} ms: "
              f"bound {out['bounds'][name][0]:.5f} ms by {out['bounds'][name][1]}")
        print(f"[19] {name}: kernel {out['ms'][name]:.4f} ms, twin {out['plain_ms'][name]:.3f} ms "
              f"({size} f32, {card})")
    return out


# ---------------------------------------------------------------------------
# the Kahan-compensated state and the stratified MRI (phases 20-26)
# ---------------------------------------------------------------------------
# the stratified box's mass changes by its z-face outflow: phase 24m holds
# the change against the outflow the step kernel's own z fluxes give, to
# MASS_ACCOUNT_TOL of the mass; the main path's total change is bounded
# by MASS_STRAT_TOL
MASS_ACCOUNT_TOL = 1e-8
MASS_STRAT_TOL = 1e-4


def with_carry(S: torch.Tensor, seed: int) -> torch.Tensor:
    """S ([8, ...]) with a non-zero Kahan carry after it ([16, ...]): a
    random rounding-sized amount, eps |u| N(0, 1), per value."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    eps = torch.finfo(S.dtype).eps
    C = eps * S * torch.randn(S.shape, generator=gen, device="cuda", dtype=S.dtype)
    return torch.cat([S, C]).contiguous()


def max_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def comp_sum(S: torch.Tensor) -> torch.Tensor:
    """The value a compensated state stands for, u - c, in f64."""
    return S[:8].double() - S[8:].double()


def check_equal(label: str, got: torch.Tensor, want: torch.Tensor) -> None:
    """Bitwise equality of a kernel output and its twin's (FMA-free code)."""
    same = torch.equal(got, want)
    extra = "" if same else (f" (rel {rel_l2(got, want):.3e}, max abs "
                             f"{float((got.double() - want.double()).abs().max()):.3e})")
    print(f"[{label}] bitwise equal: {same}{extra}")
    if not same:
        raise AssertionError(f"{label}: kernel and twin differ")


def check_step_comp(tag: str, S, S_k, S_t, tol) -> None:
    """One compensated step against the twin's on the same inputs: the
    state and the compensated value u - c within ``tol``. The increment and
    the carry against the twin's are printed: each carry is a rounding
    error of its value, so it follows the increment's last bits, which the
    kernel's FMA contractions in the stages before the update move (the
    update stage is held on its own by check_update_stage; PERF.md)."""
    check(f"{tag} state", rel_l2(S_k[:8], S_t[:8]), tol)
    check(f"{tag} compensated value u - c", rel_l2(comp_sum(S_k), comp_sum(S_t)), tol)
    print(f"[{tag}] against the twin's step: increment rel "
          f"{rel_l2(S_k[:8] - S[:8], S_t[:8] - S[:8]):.3e}, carry rel {rel_l2(S_k[8:], S_t[8:]):.3e}")


def check_update_stage(tag: str, params, S, S_k, scratch, dt, gz=None) -> None:
    """The compensated update stage held on its own, right after the launch
    that took S to S_k: the twin's update on the kernel's own fluxes and
    EMFs (left in its stage buffer) gives bitwise the kernel's state and
    carry (the stage is FMA-free, csrc/mhd_step.cu)."""
    from ramsesgpu_tpu_torch.kernels.mhd_step import scratch_fluxes
    from ramsesgpu_tpu_torch.solvers.godunov_mhd import mhd_apply_update

    fluxes, emfs, x0, z0 = scratch_fluxes(params, scratch)
    gzw = None if gz is None else gz[3 - z0:3 - z0 + fluxes[0].shape[1]].view(-1, 1, 1)
    own = mhd_apply_update(params, S[:8], fluxes, emfs, dt, x0, z0, comp=S[8:], gz=gzw)
    check_equal(f"{tag} update stage on its own fluxes: state", S_k[:8], own[:8])
    check_equal(f"{tag} update stage on its own fluxes: carry", S_k[8:], own[8:])


def strat_setup(nx: int, ny: int, nz: int, dtype: str, seed: int | None = None):
    """data/mhd_mri_3d_stratified.ini at nx x ny x nz, as shipped
    (compensated, slope_type 3): params, config, the loop state (S, kept)
    (with ``seed``, non-zero carries) and g_z of each z row on the card."""
    from ramsesgpu_tpu_torch.solvers.step import gravity_z

    params, config, (S, kept) = mri_setup(nx, ny, nz, dtype, compensated=None, ini=STRAT_INI)
    if seed is not None:
        S, kept = comp_state(S, kept, seed)
    return params, config, (S, kept), gravity_z(params, config, "cuda")


def comp_state(S, kept, seed: int):
    """A compensated loop state (S [16, ...], kept [2, nz, ny]) with
    non-zero carries."""
    S = with_carry(S[:8], seed)
    kept = with_carry(kept[0][None], seed + 1).view(2, *kept.shape[1:])
    return S, kept.contiguous()


def phase20() -> None:
    """The compensated kernels against their twins on the same inputs,
    from non-zero carries: the step (periodic OT 64^3, MRI 64x128x64 with
    the ini's coefficients), the border kernel (state, carries, kept face
    and its carry bitwise), the dissipative sub-step (every DISSIP_COEFFS
    set, both modes, bitwise), then 1 and 10 chained loop steps."""
    from ramsesgpu_tpu_torch.kernels import fused_mhd3d, shear
    from ramsesgpu_tpu_torch.kernels.cfl_mhd import cfl_mhd
    from ramsesgpu_tpu_torch.kernels.dissip_step import dissip_step
    from ramsesgpu_tpu_torch.kernels.mhd_step import mhd_step
    from ramsesgpu_tpu_torch.kernels.shear_border import shear_border, shear_slabs
    from ramsesgpu_tpu_torch.solvers.dissipation import (kept_face_resistive_ct,
                                                          mhd_dissipation_periodic_update,
                                                          mhd_dissipation_shear_update)
    from ramsesgpu_tpu_torch.solvers.godunov_mhd import (mhd_3d_periodic_step,
                                                         mhd_3d_periodic_update,
                                                         mhd_3d_shear_step, mhd_3d_shear_update,
                                                         shear_border_update)
    from ramsesgpu_tpu_torch.solvers.shear import shear_slabs as slabs_twin
    from ramsesgpu_tpu_torch.solvers.timestep import (dt_from_inv, inv_dt_mhd_periodic,
                                                      inv_dt_mhd_shear)

    active = torch.ones((), dtype=torch.bool, device="cuda")
    for dtype in ("float32", "float64"):
        tol1, tol10 = TOL_STEP1[dtype], TOL_STEP10[dtype]
        # periodic Orszag-Tang
        tag = f"20 comp OT {dtype} 64^3"
        params, S8 = setup(64, dtype)
        params = params.replace(compensated=True)
        S = with_carry(S8, 20)
        inv = cfl_mhd(params, S)
        check_equal(f"{tag} cfl_mhd on the 16-channel state", inv,
                    cfl_mhd(params.replace(compensated=False), S8))
        dt = dt_from_inv(params, inv_dt_mhd_periodic(params, S8))
        scratch = mhd_step.scratch(params, S)
        S_k = mhd_step(params, S.clone(), dt, active, scratch)
        check_update_stage(f"{tag} mhd_step", params, S, S_k, scratch, dt)
        check_step_comp(f"{tag} mhd_step", S, S_k, mhd_3d_periodic_update(params, S, dt), tol1)
        for cname, (nu, eta) in DISSIP_COEFFS.items():
            p = params.replace(nu=nu, eta=eta)
            got = dissip_step(p, S_k, torch.empty_like(S_k), dt, active)
            check_equal(f"{tag} dissip_step {cname}", got,
                        mhd_dissipation_periodic_update(p, S_k, dt))
        for cname, (nu, eta) in (("ideal", (0.0, 0.0)),
                                 ("nu=2e-3 eta=1e-3", DISSIP_COEFFS["nu=2e-3 eta=1e-3"])):
            p = params.replace(nu=nu, eta=eta)
            _pack, advance, _unpack = fused_mhd3d.make_advance_n(p, "cuda", packed_form=True)
            t0 = torch.zeros((), dtype=S.dtype, device="cuda")
            state, t_k, _k = advance(S.clone(), t0.clone(), 1)
            twin, t_t = S, t0
            for n in (1, 10):
                if n == 10:
                    state, t_k, _k = advance(state, t_k, 9)
                for _ in range(1 if n == 1 else 9):
                    dt_t = dt_from_inv(p, inv_dt_mhd_periodic(p, twin[:8]))
                    twin, t_t = mhd_3d_periodic_step(p, twin, dt_t), t_t + dt_t
                check(f"{tag} {cname} {n} loop steps", rel_l2(state[:8], twin[:8]),
                      tol1 if n == 1 else tol10,
                      f", u - c {rel_l2(comp_sum(state), comp_sum(twin)):.3e}, carry max abs "
                      f"diff {max_diff(state[8:], twin[8:]):.3e}, t kernel {float(t_k)!r} twin "
                      f"{float(t_t)!r}")
        del scratch

        # the MRI shearing box (the ini's coefficients), compensated as shipped
        tag = f"20 comp MRI {dtype} 64x128x64"
        params, _config, (S, kept) = mri_setup(64, 128, 64, dtype, compensated=True)
        S, kept = comp_state(S, kept, 21)
        t0 = shear_t0(params, S.dtype)
        inv, inv_t = cfl_mhd(params, S, kept=kept), inv_dt_mhd_shear(params, S, kept[0])
        check(f"{tag} cfl_mhd shear", abs(float(inv) - float(inv_t)) / float(inv_t), TOL_CFL[dtype])
        dt = dt_from_inv(params, inv_t)
        slabs_t = slabs_twin(params, S[:8], kept[0], t0 + dt)
        check(f"{tag} shear_slabs", rel_l2(shear_slabs(params, S, kept, t0, dt), slabs_t), tol1)
        planes = torch.zeros((5, params.nz, params.ny), dtype=S.dtype, device="cuda")
        scratch = mhd_step.scratch(params, S)
        S1 = mhd_step(params, S.clone(), dt, active, scratch, shear=(slabs_t, planes))
        S1_t, planes_t = mhd_3d_shear_update(params, S, slabs_t, dt)
        check_update_stage(f"{tag} mhd_step shear", params, S, S1, scratch, dt)
        check_step_comp(f"{tag} mhd_step shear", S, S1, S1_t, tol1)
        check(f"{tag} the 5 x-face planes before the remap", rel_l2(planes, planes_t), tol1)
        S2, kept2 = S1_t.clone(), kept.clone()
        rem = shear_border(params, S2, kept2, planes_t, t0, dt, active)
        S2_t, kept2_t, rem_t = shear_border_update(params, S1_t, kept, planes_t, t0, dt)
        check_equal(f"{tag} shear_border state and carry", S2, S2_t)
        check_equal(f"{tag} shear_border kept face and its carry", kept2, kept2_t)
        check_equal(f"{tag} shear_border remapped planes", rem, rem_t)
        del scratch
        for ciso in (1.0, 0.0):
            for cname, (nu, eta) in DISSIP_COEFFS.items():
                p, Sd, keptd, td = dissip_mri(64, 128, 64, dtype, ciso, nu, eta, True, True)
                Sd, keptd = comp_state(Sd, keptd, 22)
                dtd = dt_from_inv(p, inv_dt_mhd_shear(p, Sd, keptd[0]))
                slabs = slabs_twin(p, Sd[:8], keptd[0], td + dtd)
                got, kept_got = torch.empty_like(Sd), keptd.clone()
                dissip_step(p, Sd, got, dtd, active, shear=(slabs, kept_got))
                want, eypl, ezpl = mhd_dissipation_shear_update(p, Sd, slabs, dtd)
                kept_want = (kept_face_resistive_ct(p, torch.stack([slabs[1, 5, ..., 0], keptd[1]]),
                                                    eypl, ezpl, dtd) if eta > 0 else keptd)
                label = f"20 comp dissip_step shear cIso={ciso} {dtype} {cname}"
                check_equal(f"{label} state and carry", got, want)
                check_equal(f"{label} kept face and its carry", kept_got, kept_want)
        _pack, advance, _unpack = shear.make_advance_n(params, "cuda", packed_form=True)
        state, t_k, _k = advance((S.clone(), kept.clone()), t0.clone(), 1)
        twin, t_t = (S, kept), t0
        for n in (1, 10):
            if n == 10:
                state, t_k, _k = advance(state, t_k, 9)
            for _ in range(1 if n == 1 else 9):
                dt_t = dt_from_inv(params, inv_dt_mhd_shear(params, twin[0], twin[1][0]))
                twin, t_t = mhd_3d_shear_step(params, *twin, t_t, dt_t), t_t + dt_t
            check(f"{tag} {n} loop steps", state_rel((state[0][:8], state[1][0]),
                                                     (twin[0][:8], twin[1][0])),
                  tol1 if n == 1 else tol10,
                  f", u - c {rel_l2(comp_sum(state[0]), comp_sum(twin[0])):.3e}, kept carry max abs "
                  f"diff {max_diff(state[1][1], twin[1][1]):.3e}, t kernel {float(t_k)!r} twin "
                  f"{float(t_t)!r}")


def phase21() -> None:
    """The stratified kernels against their twins on the same inputs, at
    64x128x64 with the shipped ini's coefficients (compensated, slope_type
    3), f32 and f64, from non-zero carries: the CFL with the stratified top
    row, the x slabs, the z slabs (bitwise), the step (its update stage on
    its own fluxes bitwise), the border, then 1 and 10 chained loop steps."""
    from ramsesgpu_tpu_torch.kernels import shear
    from ramsesgpu_tpu_torch.kernels.cfl_mhd import cfl_mhd
    from ramsesgpu_tpu_torch.kernels.mhd_step import mhd_step
    from ramsesgpu_tpu_torch.kernels.shear_border import shear_border, shear_slabs, shear_zslabs
    from ramsesgpu_tpu_torch.solvers.godunov_mhd import (mhd_3d_shear_step, mhd_3d_shear_update,
                                                         shear_border_update)
    from ramsesgpu_tpu_torch.solvers.shear import shear_slabs as slabs_twin
    from ramsesgpu_tpu_torch.solvers.shear import stratified_zslabs
    from ramsesgpu_tpu_torch.solvers.timestep import dt_from_inv, inv_dt_mhd_shear

    active = torch.ones((), dtype=torch.bool, device="cuda")
    for dtype in ("float32", "float64"):
        tol1, tol10 = TOL_STEP1[dtype], TOL_STEP10[dtype]
        tag = f"21 stratified MRI {dtype} 64x128x64"
        params, _config, (S, kept), gz = strat_setup(64, 128, 64, dtype, seed=23)
        t0 = shear_t0(params, S.dtype)
        inv, inv_t = cfl_mhd(params, S, kept=kept), inv_dt_mhd_shear(params, S, kept[0])
        check(f"{tag} cfl_mhd shear", abs(float(inv) - float(inv_t)) / float(inv_t), TOL_CFL[dtype])
        dt = dt_from_inv(params, inv_t)
        slabs_t = slabs_twin(params, S[:8], kept[0], t0 + dt)
        check(f"{tag} shear_slabs", rel_l2(shear_slabs(params, S, kept, t0, dt), slabs_t), tol1)
        zslabs_t = stratified_zslabs(params, S[:8], slabs_t)
        check_equal(f"{tag} shear_zslabs", shear_zslabs(params, S, slabs_t), zslabs_t)
        planes = torch.zeros((5, params.nz, params.ny), dtype=S.dtype, device="cuda")
        scratch = mhd_step.scratch(params, S)
        S1 = mhd_step(params, S.clone(), dt, active, scratch, shear=(slabs_t, planes, zslabs_t, gz))
        S1_t, planes_t = mhd_3d_shear_update(params, S, slabs_t, dt, zslabs_t, gz)
        check_update_stage(f"{tag} mhd_step", params, S, S1, scratch, dt, gz)
        check_step_comp(f"{tag} mhd_step", S, S1, S1_t, tol1)
        check(f"{tag} the 5 x-face planes before the remap", rel_l2(planes, planes_t), tol1)
        del scratch
        S2, kept2 = S1_t.clone(), kept.clone()
        rem = shear_border(params, S2, kept2, planes_t, t0, dt, active)
        S2_t, kept2_t, rem_t = shear_border_update(params, S1_t, kept, planes_t, t0, dt)
        check_equal(f"{tag} shear_border state and carry", S2, S2_t)
        check_equal(f"{tag} shear_border kept face and its carry", kept2, kept2_t)
        check_equal(f"{tag} shear_border remapped planes", rem, rem_t)
        _pack, advance, _unpack = shear.make_advance_n(params, "cuda", packed_form=True, gz=gz)
        state, t_k, _k = advance((S.clone(), kept.clone()), t0.clone(), 1)
        twin, t_t = (S, kept), t0
        for n in (1, 10):
            if n == 10:
                state, t_k, _k = advance(state, t_k, 9)
            for _ in range(1 if n == 1 else 9):
                dt_t = dt_from_inv(params, inv_dt_mhd_shear(params, twin[0], twin[1][0]))
                twin, t_t = mhd_3d_shear_step(params, *twin, t_t, dt_t, gz), t_t + dt_t
            check(f"{tag} {n} loop steps", state_rel((state[0][:8], state[1][0]),
                                                     (twin[0][:8], twin[1][0])),
                  tol1 if n == 1 else tol10,
                  f", u - c {rel_l2(comp_sum(state[0]), comp_sum(twin[0])):.3e}, t kernel "
                  f"{float(t_k)!r} twin {float(t_t)!r}")


def phase24m(card: str, strat) -> None:
    """Mass accounting of the stratified box: 5 steps of the loop's kernels
    from the main path's end state, each step's mass change (f64 sums)
    against the outflow through the z faces that the step kernel's own z
    density fluxes give, dt/dz (sum F_z(z=0) - sum F_z(z=nz)) (the x faces'
    remapped fluxes cancel; y is periodic)."""
    from ramsesgpu_tpu_torch.kernels.cfl_mhd import cfl_mhd
    from ramsesgpu_tpu_torch.kernels.mhd_step import mhd_step, scratch_fluxes
    from ramsesgpu_tpu_torch.kernels.shear_border import shear_border, shear_slabs, shear_zslabs
    from ramsesgpu_tpu_torch.solvers.step import gravity_z
    from ramsesgpu_tpu_torch.solvers.timestep import dt_from_inv

    params, S, kept, t, config = strat
    S, kept = S.clone(), kept.clone()
    gz = gravity_z(params, config, "cuda")
    scratch = mhd_step.scratch(params, S)
    planes = torch.zeros((5, params.nz, params.ny), dtype=S.dtype, device="cuda")
    active = torch.ones((), dtype=torch.bool, device="cuda")
    mass = float(S[0].double().sum())
    mass0, predicted, worst = mass, 0.0, 0.0
    for _ in range(5):
        dt = dt_from_inv(params, cfl_mhd(params, S, kept=kept))
        slabs = shear_slabs(params, S, kept, t, dt)
        mhd_step(params, S, dt, active, scratch,
                 shear=(slabs, planes, shear_zslabs(params, S, slabs), gz))
        shear_border(params, S, kept, planes, t, dt, active)
        t = t + dt
        fluxes, _emfs, x0, z0 = scratch_fluxes(params, scratch)
        fz = fluxes[2][0][:, :, x0:x0 + params.nx].double()
        gain = float(dt) / params.dz * float(fz[z0].sum() - fz[z0 + params.nz].sum())
        new = float(S[0].double().sum())
        worst = max(worst, abs((new - mass) - gain) / mass0)
        predicted += gain
        mass = new
    print(f"[24m] stratified mass over 5 steps at {params.nx}x{params.ny}x{params.nz} f32: change "
          f"{mass - mass0:.6e} ({(mass - mass0) / mass0:.3e} of the mass), z-face outflow from the "
          f"kernel's fluxes {predicted:.6e}; worst step |change - outflow| / mass {worst:.3e} "
          f"(tol {MASS_ACCOUNT_TOL:.0e})")
    if not worst <= MASS_ACCOUNT_TOL:
        raise AssertionError("the stratified box's mass change is not its z-face outflow")


def bound(label: str, name: str, nbytes: float, ops: float, size: str, n: int) -> tuple:
    """(bound_ms, bound_by) of one kernel call: max(bytes / memory rate,
    operations / f32 rate), printed."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOP_PER_S * 1e3
    out = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
    print(f"[{label}] {name} at {size} f32: {nbytes / n:.1f} B/cell, {nbytes / 1e9:.4f} GB -> "
          f"{t_bytes:.5f} ms; {ops / n:.1f} flop/cell, {ops / 1e9:.4f} GFLOP -> {t_ops:.5f} ms: "
          f"bound {out[0]:.5f} ms by {out[1]}")
    return out


def phase25(card: str, ot_comp, ot_comp_d, mri_comp, strat) -> dict:
    """The compensated and stratified kernel modes at full width, on the end
    states of paths 22 (compensated OT, 256^3), 22d (its dissipative
    variant), 23 (the flagship MRI as shipped) and 24 (the stratified MRI
    as shipped, 128x256x128): each against its twin on the same inputs
    (the update stage on its own fluxes bitwise, the FMA-free kernels
    bitwise), its time against the twin's, and its bound: max(bytes /
    memory rate, the operations the counting build counts on a block of
    the state, scaled / f32 rate)."""
    from ramsesgpu_tpu_torch.kernels.build import load_library, param_block
    from ramsesgpu_tpu_torch.kernels.cfl_mhd import cfl_mhd
    from ramsesgpu_tpu_torch.kernels.dissip_step import dissip_step, launch_info
    from ramsesgpu_tpu_torch.kernels.mhd_step import mhd_step
    from ramsesgpu_tpu_torch.kernels.shear_border import shear_border, shear_slabs, shear_zslabs
    from ramsesgpu_tpu_torch.solvers.dissipation import mhd_dissipation_periodic_update
    from ramsesgpu_tpu_torch.solvers.godunov_mhd import (mhd_3d_periodic_update,
                                                         mhd_3d_shear_update, shear_border_update)
    from ramsesgpu_tpu_torch.solvers.shear import shear_slabs as slabs_twin
    from ramsesgpu_tpu_torch.solvers.shear import stratified_zslabs
    from ramsesgpu_tpu_torch.solvers.step import gravity_z
    from ramsesgpu_tpu_torch.solvers.timestep import dt_from_inv

    lib = load_library("count")
    lib_cuda = load_library("cuda")
    active = torch.ones((), dtype=torch.bool, device="cuda")
    out = {"ms": {}, "plain_ms": {}, "max_abs_err": {}, "bounds": {}}
    tol = TOL_STEP1["float32"]

    # the periodic step on 16 channels
    params, S, _t = ot_comp
    n = params.nx * params.ny * params.nz
    dt = dt_from_inv(params, cfl_mhd(params, S))
    scratch = mhd_step.scratch(params, S)
    S_k = mhd_step(params, S.clone(), dt, active, scratch)
    check_update_stage("25 mhd_step_comp 256^3 f32", params, S, S_k, scratch, dt)
    Sw = S.clone()
    out["ms"]["mhd_step_comp"] = time_ms(lambda: mhd_step(params, Sw, dt, active, scratch), 10)
    del Sw, scratch
    torch.cuda.empty_cache()
    S_t = mhd_3d_periodic_update(params, S, dt)
    check_step_comp("25 mhd_step_comp 256^3 f32", S, S_k, S_t, tol)
    out["max_abs_err"]["mhd_step_comp"] = float((S_k[:8] - S_t[:8]).abs().max())
    del S_k, S_t
    torch.cuda.empty_cache()
    out["plain_ms"]["mhd_step_comp"] = time_ms(lambda: mhd_3d_periodic_update(params, S, dt), 3)
    S_sub = S[:, :32, :32, :32].double().contiguous().cpu()
    ops = lib.ramses_mhd_step_ops(S_sub.data_ptr(), 1, 32, 32, 32,
                                    param_block(block_params(params, 32)), float(dt)) / 32 ** 3 * n
    out["bounds"]["mhd_step_comp"] = bound("25", "mhd_step_comp", 2 * 16 * 4 * n, ops, "256^3", n)
    print(f"[25] mhd_step_comp: kernel {out['ms']['mhd_step_comp']:.3f} ms, twin "
          f"{out['plain_ms']['mhd_step_comp']:.3f} ms (256^3 f32, {card})")
    # the dissipative sub-step on 16 channels (FMA-free: bitwise)
    params, S, _t = ot_comp_d
    dt = dt_from_inv(params, cfl_mhd(params, S))
    got = dissip_step(params, S, torch.empty_like(S), dt, active)
    Sw = torch.empty_like(S)
    out["ms"]["dissip_step_comp"] = time_ms(lambda: dissip_step(params, S, Sw, dt, active), 10)
    del Sw
    torch.cuda.empty_cache()
    want = mhd_dissipation_periodic_update(params, S, dt)
    check_equal("25 dissip_step_comp 256^3 f32 state and carry", got, want)
    out["max_abs_err"]["dissip_step_comp"] = float((got - want).abs().max())
    del got, want
    torch.cuda.empty_cache()
    out["plain_ms"]["dissip_step_comp"] = time_ms(
        lambda: mhd_dissipation_periodic_update(params, S, dt), 3)
    S_sub = S[:, :32, :32, :32].double().contiguous().cpu()
    ops = lib.ramses_dissip_step_ops(S_sub.data_ptr(), None, 1, 32, 32, 32,
                                       param_block(block_params(params, 32)), float(dt))
    # the plain sub-step's bytes, and each changed channel's carry read and written
    changed = 3 * (params.nu > 0) + 3 * (params.eta > 0) + (params.c_iso <= 0)
    nbytes = dissip_bytes(params, False) + 4 * 2 * changed * n
    out["bounds"]["dissip_step_comp"] = bound("25", "dissip_step_comp", nbytes,
                                              ops / 32 ** 3 * n, "256^3", n)
    li = launch_info(load_library("cuda"), params, S.dtype)
    print(f"[25] dissip_step_comp: kernel {out['ms']['dissip_step_comp']:.3f} ms against its "
          f"bound {out['bounds']['dissip_step_comp'][0]:.4f} ms, twin "
          f"{out['plain_ms']['dissip_step_comp']:.3f} ms (256^3 f32, {card}); tile "
          f"{li['tx']}x{li['ty']}, {li['threads']} threads, rings {li['ring_bytes']} B, "
          f"{li['registers']} registers a thread, {li['blocks_per_sm']} block(s) an SM")

    # the shear step on 16 channels and the compensated border (the flagship)
    params, S, kept, t, _config = mri_comp
    nx, ny, nz = params.nx, params.ny, params.nz
    n, rows, size = nx * ny * nz, ny * nz, f"{nx}x{ny}x{nz}"
    dt = dt_from_inv(params, cfl_mhd(params, S, kept=kept))
    slabs = shear_slabs(params, S, kept, t, dt)
    scratch = mhd_step.scratch(params, S)
    planes = torch.zeros((5, nz, ny), dtype=S.dtype, device="cuda")
    S1 = mhd_step(params, S.clone(), dt, active, scratch, shear=(slabs, planes))
    check_update_stage(f"25 mhd_step_shear_comp {size} f32", params, S, S1, scratch, dt)
    S1_t, planes_t = mhd_3d_shear_update(params, S, slabs, dt)
    check_step_comp(f"25 mhd_step_shear_comp {size} f32", S, S1, S1_t, tol)
    out["max_abs_err"]["mhd_step_shear_comp"] = float((S1[:8] - S1_t[:8]).abs().max())
    S2, kept2 = S1.clone(), kept.clone()
    rem = shear_border(params, S2, kept2, planes, t, dt, active)
    S2_t, kept2_t, rem_t = shear_border_update(params, S1, kept, planes, t, dt)
    check_equal(f"25 shear_border_comp {size} f32 state and carry", S2, S2_t)
    check_equal(f"25 shear_border_comp {size} f32 kept face and its carry", kept2, kept2_t)
    out["max_abs_err"]["shear_border_comp"] = max(float((S2 - S2_t).abs().max()),
                                                  float((kept2 - kept2_t).abs().max()))
    del S1_t, S2_t, kept2_t, rem_t
    Sw, kw, planes_w, rem_w = S.clone(), kept.clone(), planes.clone(), rem.clone()
    out["ms"]["mhd_step_shear_comp"] = time_ms(
        lambda: mhd_step(params, Sw, dt, active, scratch, shear=(slabs, planes_w)), 10)
    out["ms"]["shear_border_comp"] = time_ms(
        lambda: shear_border(params, Sw, kw, planes_w, t, dt, active, rem_w), 50)
    del Sw, kw, planes_w, rem_w, scratch
    torch.cuda.empty_cache()
    out["plain_ms"]["mhd_step_shear_comp"] = time_ms(
        lambda: mhd_3d_shear_update(params, S, slabs, dt), 3)
    out["plain_ms"]["shear_border_comp"] = time_ms(
        lambda: shear_border_update(params, S1, kept, planes, t, dt), 10)
    bz, by = 8, 32
    blk = params.replace(nz=bz, zmax=params.zmin + bz * params.dz, ny=by,
                         ymax=params.ymin + by * params.dy)
    Sb = S[:, :bz, :by].double().contiguous().cpu()
    kb = kept[:, :bz, :by].double().contiguous().cpu()
    pb = planes[:, :bz, :by].double().contiguous().cpu()
    sb = slabs_twin(blk, Sb[:8], kb[0], torch.tensor(float(t + dt), dtype=torch.float64)).contiguous()
    scale = rows / (by * bz)
    ops = lib.ramses_mhd_step_shear_ops(Sb.data_ptr(), sb.data_ptr(), None, None, 1, nx, by, bz,
                                          param_block(blk), float(dt)) * scale
    out["bounds"]["mhd_step_shear_comp"] = bound(
        "25", "mhd_step_shear_comp", 4 * (2 * 16 * n + 2 * 8 * 3 * rows + 5 * rows), ops, size, n)
    counts = (ctypes.c_longlong * 3)()
    lib.ramses_shear_border_ops(Sb.data_ptr(), kb.data_ptr(), pb.data_ptr(), 1, nx, by, bz,
                                param_block(blk), float(t), float(dt), counts)
    # planes 5 read, remapped 4 written; 5 border values, 2 kept values and
    # their carries read and written
    out["bounds"]["shear_border_comp"] = bound(
        "25", "shear_border_comp", 4 * rows * (5 + 4 + 2 * 2 * 7), counts[1] * scale, size, n)
    for name in ("mhd_step_shear_comp", "shear_border_comp"):
        print(f"[25] {name}: kernel {out['ms'][name]:.4f} ms, twin {out['plain_ms'][name]:.3f} ms "
              f"({size} f32, {card})")
    del S1, slabs
    torch.cuda.empty_cache()

    # the stratified step and the z slabs (the stratified box as shipped)
    params, S, kept, t, config = strat
    gz = gravity_z(params, config, "cuda")
    dt = dt_from_inv(params, cfl_mhd(params, S, kept=kept))
    slabs = shear_slabs(params, S, kept, t, dt)
    zslabs = shear_zslabs(params, S, slabs)
    zslabs_t = stratified_zslabs(params, S[:8], slabs)
    check_equal(f"25 shear_zslabs {size} f32", zslabs, zslabs_t)
    out["max_abs_err"]["shear_zslabs"] = float((zslabs - zslabs_t).abs().max())
    scratch = mhd_step.scratch(params, S)
    S1 = mhd_step(params, S.clone(), dt, active, scratch, shear=(slabs, planes, zslabs, gz))
    check_update_stage(f"25 mhd_step_strat {size} f32", params, S, S1, scratch, dt, gz)
    S1_t, _planes_t = mhd_3d_shear_update(params, S, slabs, dt, zslabs, gz)
    check_step_comp(f"25 mhd_step_strat {size} f32", S, S1, S1_t, tol)
    out["max_abs_err"]["mhd_step_strat"] = float((S1[:8] - S1_t[:8]).abs().max())
    del S1, S1_t, _planes_t
    Sw, zw = S.clone(), zslabs.clone()
    out["ms"]["mhd_step_strat"] = time_ms(
        lambda: mhd_step(params, Sw, dt, active, scratch, shear=(slabs, planes, zslabs, gz)), 10)
    out["ms"]["shear_zslabs"] = time_ms(lambda: shear_zslabs(params, S, slabs, out=zw), 50)
    del Sw, zw, scratch
    torch.cuda.empty_cache()
    out["plain_ms"]["mhd_step_strat"] = time_ms(
        lambda: mhd_3d_shear_update(params, S, slabs, dt, zslabs, gz), 3)
    out["plain_ms"]["shear_zslabs"] = time_ms(lambda: stratified_zslabs(params, S[:8], slabs), 10)
    # counted on a full-z block of 8 y rows: the stratified work depends on nz
    by = 8
    blk = params.replace(ny=by, ymax=params.ymin + by * params.dy)
    Sb = S[:, :, :by].double().contiguous().cpu()
    kb = kept[:, :, :by].double().contiguous().cpu()
    pb = planes[:, :, :by].double().contiguous().cpu()
    sb = slabs_twin(blk, Sb[:8], kb[0], torch.tensor(float(t + dt), dtype=torch.float64)).contiguous()
    zb = stratified_zslabs(blk, Sb[:8], sb).contiguous()
    gzb = gz.double().cpu().contiguous()
    scale = ny / by
    ops = lib.ramses_mhd_step_shear_ops(Sb.data_ptr(), sb.data_ptr(), zb.data_ptr(), gzb.data_ptr(),
                                          1, nx, by, nz, param_block(blk), float(dt)) * scale
    zvals = 2 * 8 * 3 * ny * (nx + 6)
    out["bounds"]["mhd_step_strat"] = bound(
        "25", "mhd_step_strat", 4 * (2 * 16 * n + 2 * 8 * 3 * rows + 5 * rows + zvals + nz + 6),
        ops, size, n)
    lib.ramses_shear_border_ops(Sb.data_ptr(), kb.data_ptr(), pb.data_ptr(), 1, nx, by, nz,
                                param_block(blk), float(t), float(dt), counts)
    # the two source rows' six channels it reads (of the interior and of the
    # x slabs), the three ghost rows of eight it writes, per side
    out["bounds"]["shear_zslabs"] = bound(
        "25", "shear_zslabs", 4 * 2 * (6 + 24) * ny * (nx + 6), counts[2] * scale, size, n)
    for name in ("mhd_step_strat", "shear_zslabs"):
        print(f"[25] {name}: kernel {out['ms'][name]:.4f} ms, twin {out['plain_ms'][name]:.3f} ms "
              f"({size} f32, {card})")
    return out


def phase26(card: str) -> None:
    """Long horizon: 500 steps of Orszag-Tang at 64^3 in f64, plain f32
    and compensated f32, all on the same dt sequence (each step's dt from
    the f64 state's CFL, rounded to f32), and the relative L2 of each f32
    run against f64: tests/test_compensated.py's criterion err_comp < 0.6
    err_plain; the same for the MRI at 64x128x64 (the ini's coefficients),
    printed only."""
    from ramsesgpu_tpu_torch.kernels import fused_mhd3d
    from ramsesgpu_tpu_torch.kernels.cfl_mhd import cfl_mhd
    from ramsesgpu_tpu_torch.kernels.shear import bind_step
    from ramsesgpu_tpu_torch.solvers.timestep import dt_from_inv

    steps = 500
    active = torch.ones((), dtype=torch.bool, device="cuda")
    for case in ("OT 64^3", "MRI 64x128x64"):
        runs = {}
        if case.startswith("OT"):
            p64, S64 = setup(64, "float64")
            p32 = setup(64, "float32")[0]
            states = {"f64": S64, "f32": S64.float().contiguous(),
                      "f32 comp": torch.cat([S64.float(), torch.zeros_like(S64.float())])}
            params = {"f64": p64, "f32": p32, "f32 comp": p32.replace(compensated=True)}
            steps_of = {k: fused_mhd3d.bind_step(params[k], states[k]) for k in states}
            cfl = lambda: cfl_mhd(p64, states["f64"])
            t = {k: torch.zeros((), dtype=states[k].dtype, device="cuda") for k in states}
        else:
            p64, _c, (S64, k64) = mri_setup(64, 128, 64, "float64")
            p32 = p64.replace(dtype="float32")
            S32, k32 = S64.float().contiguous(), k64.float().contiguous()
            def comp(S, k):
                return (torch.cat([S, torch.zeros_like(S)]), torch.stack([k, torch.zeros_like(k)]))

            states = {"f64": (S64, k64), "f32": (S32, k32), "f32 comp": comp(S32, k32)}
            params = {"f64": p64, "f32": p32, "f32 comp": p32.replace(compensated=True)}
            steps_of = {k: bind_step(params[k], states[k]) for k in states}
            cfl = lambda: cfl_mhd(p64, states["f64"][0], kept=states["f64"][1])
            t0 = shear_t0(p64, torch.float64)
            t = {k: t0.to(states[k][0].dtype) for k in states}
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(steps):
            dt32 = dt_from_inv(p64, cfl()).float()
            for k, st in states.items():
                dt = dt32 if k != "f64" else dt32.double()
                steps_of[k](st, dt, active, t[k])
                t[k] = t[k] + dt
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        ref = states["f64"][0] if isinstance(states["f64"], tuple) else states["f64"]

        def err(k):
            S = states[k][0] if isinstance(states[k], tuple) else states[k]
            return rel_l2(S[:8], ref)

        err_plain, err_comp = err("f32"), err("f32 comp")
        print(f"[26] {case}, {steps} steps on one dt sequence (t = {float(t['f64']):.6g}, {wall:.1f} s "
              f"on {card}): rel L2 against f64: plain f32 {err_plain:.4e}, compensated f32 "
              f"{err_comp:.4e}, ratio {err_comp / err_plain:.3f}"
              + (" (criterion < 0.6)" if case.startswith("OT") else " (not asserted)"))
        if not case.startswith("OT"):
            # where the error sits: each channel's share of it, against the
            # norm of all channels, and the f32 rounding of the start
            norm = float(torch.linalg.norm(ref.double()))
            for k in ("f32", "f32 comp"):
                S = states[k][0][:8].double()
                print(f"[26] {case} {k}: error by channel / |f64 state| "
                      + ", ".join(f"{float(torch.linalg.norm(S[c] - ref[c].double())) / norm:.3e}"
                                  for c in range(8)))
            start = mri_setup(64, 128, 64, "float64")[2][0]
            comp_value = states["f32 comp"][0][:8].double() - states["f32 comp"][0][8:].double()
            print(f"[26] {case}: the f32 rounding of the start {rel_l2(start.float(), start):.3e}, "
                  f"of the f64 end state {rel_l2(ref.float(), ref):.3e}; the compensated run's "
                  f"value with its carry (u - c, in f64) {rel_l2(comp_value, ref):.3e}")
        if case.startswith("OT") and not err_comp < 0.6 * err_plain:
            raise AssertionError("compensated f32 is not closer to f64 than plain f32 by 40 %")


# ---------------------------------------------------------------------------
# the z-streaming step kernels ([implementation] kernel=zcarry, phases 27-32)
# ---------------------------------------------------------------------------
# after 10 chained steps in f64 the streamed kernels stay within the one-step
# bound (its ULP-level differences do not grow in 10 steps)
TOL_Z10 = {"float32": 1e-5, "float64": 1e-13}
# the folded inverse dt against the CFL kernel on the step's output: the
# same per-cell function (cfl_mhd.cuh, cfl_hydro.cuh) on the same values,
# compiled in another kernel, so FMA contraction may differ in the last bit
ULP_FOLD = 4


def ulps(a: torch.Tensor, b: torch.Tensor) -> float:
    """|a - b| in units of the last place of b (0-d tensors)."""
    return abs(float(a) - float(b)) / (torch.finfo(b.dtype).eps * abs(float(b)))


def zcarry_case(name: str, dtype: str, n: int = 64):
    """(params, loop state, t0, gz) of one phase-27 case on the card:
    Orszag-Tang at n^3 (plain or compensated), the periodic blast at n^3,
    the MRI at n x 2n x n (isothermal, adiabatic, compensated as shipped)
    or the stratified MRI as shipped."""
    from ramsesgpu_tpu_torch.kernels.packed_bc import pack_state
    from ramsesgpu_tpu_torch.solvers.step import gravity_z

    t0 = torch.zeros((), dtype=getattr(torch, dtype), device="cuda")
    if name in ("ot", "ot comp"):
        params, S = setup(n, dtype)
        params = params.replace(kernel="zcarry", compensated=name == "ot comp")
        if name == "ot comp":
            S = with_carry(S, 31)
        return params, S, t0, None
    if name.startswith("blast"):
        params, U = hydro_setup("blast", n, dtype, name.split()[-1])
        params = params.replace(kernel="zcarry")
        return params, pack_state(params, U), t0, None
    ini = STRAT_INI if name == "strat" else MRI_INI
    comp = None if name in ("mri comp", "strat") else False
    params, config, (S, kept) = mri_setup(n, 2 * n, n, dtype, compensated=comp, ini=ini)
    params = params.replace(kernel="zcarry", c_iso=0.0 if name == "mri adiabatic" else params.c_iso)
    if params.compensated:
        S, kept = comp_state(S, kept, 33)
    gz = gravity_z(params, config, "cuda") if name == "strat" else None
    return params, (S, kept), shear_t0(params, S.dtype), (None if gz is None else gz.to(S.dtype))


ZCARRY_CASES = ["ot", "ot comp", "blast approx", "blast hllc", "mri", "mri adiabatic",
                "mri comp", "strat"]


def zcarry_one_step(params, state, t0, gz) -> dict:
    """One step of the streamed kernel against its twin and the staged
    kernel on the same inputs; the folded inverse dt against the CFL kernel
    on its output; an inactive step copies. Returns the errors."""
    from ramsesgpu_tpu_torch.kernels.cfl_hydro import cfl_hydro
    from ramsesgpu_tpu_torch.kernels.cfl_mhd import cfl_mhd
    from ramsesgpu_tpu_torch.kernels.hydro_step import hydro_step
    from ramsesgpu_tpu_torch.kernels.mhd_step import mhd_step
    from ramsesgpu_tpu_torch.kernels.shear_border import shear_slabs, shear_zslabs
    from ramsesgpu_tpu_torch.kernels.zcarry_hydro3d import zcarry_hydro
    from ramsesgpu_tpu_torch.kernels.zcarry_mhd3d import zcarry_mhd
    from ramsesgpu_tpu_torch.solvers.godunov import hydro_3d_state_update
    from ramsesgpu_tpu_torch.solvers.godunov_mhd import mhd_3d_periodic_update, mhd_3d_shear_update
    from ramsesgpu_tpu_torch.solvers.timestep import (compute_inv_dt_hydro, dt_from_inv,
                                                      inv_dt_mhd_periodic, inv_dt_mhd_shear)

    dtype = str(params.dtype)
    active = torch.ones((), dtype=torch.bool, device="cuda")
    idle = torch.zeros_like(active)
    out = {}
    if not params.mhd:
        S = state
        dt = dt_from_inv(params, compute_inv_dt_hydro(params, S, ghost=0))
        S1 = torch.empty_like(S)
        inv = zcarry_hydro(params, S, S1, dt, active)
        twin = hydro_3d_state_update(params, S, dt)
        staged = hydro_step(params, S, torch.empty_like(S), dt, active)
        inv_cfl = cfl_hydro(params, S1)
    else:
        S, kept = state if isinstance(state, tuple) else (state, None)
        shear = None
        if kept is None:
            dt = dt_from_inv(params, inv_dt_mhd_periodic(params, S[:8]))
        else:
            dt = dt_from_inv(params, inv_dt_mhd_shear(params, S, kept[0] if params.compensated
                                                      else kept))
            slabs = shear_slabs(params, S, kept, t0, dt)
            shear = (slabs, torch.zeros((5, params.nz, params.ny), dtype=S.dtype, device="cuda"))
            if gz is not None:
                shear = shear + (shear_zslabs(params, S, slabs), gz)
        S1 = torch.empty_like(S)
        inv = zcarry_mhd(params, S, S1, dt, active, shear=shear, fold=shear is None)
        if shear is None:
            twin = mhd_3d_periodic_update(params, S, dt)
            inv_cfl = cfl_mhd(params, S1)
            staged_shear = None
        else:
            twin, planes_t = mhd_3d_shear_update(params, S, shear[0], dt, *shear[2:])
            out["planes"] = max(rel_l2(p, q) for p, q in zip(shear[1], planes_t))
            staged_shear = (shear[0], torch.zeros_like(shear[1])) + shear[2:]
        staged = mhd_step(params, S.clone(), dt, active, mhd_step.scratch(params, S),
                          shear=staged_shear)
        twin, staged = twin[:8], staged[:8]
    out["twin"] = rel_l2(S1[:8], twin)
    out["staged"] = rel_l2(S1[:8], staged)
    out["max_abs"] = float((S1[:8] - twin).abs().max())
    if inv is not None:
        out["fold_ulps"] = ulps(inv, inv_cfl)
    # the inactive step: its output is its input
    S2 = torch.full_like(S, float("nan"))
    if not params.mhd:
        zcarry_hydro(params, S, S2, dt, idle)
    else:
        zcarry_mhd(params, S, S2, dt, idle, shear=shear, fold=shear is None)
    out["idle_copy"] = bool(torch.equal(S2, S))
    return out


def twin_loop(params, state, t0, gz, n: int):
    """n steps of the twins on the card from the loop state: (S, t)."""
    from ramsesgpu_tpu_torch.solvers.godunov import hydro_3d_state_update
    from ramsesgpu_tpu_torch.solvers.godunov_mhd import mhd_3d_periodic_update, mhd_3d_shear_step
    from ramsesgpu_tpu_torch.solvers.timestep import (compute_inv_dt_hydro, dt_from_inv,
                                                      inv_dt_mhd_periodic, inv_dt_mhd_shear)

    t = t0.clone()
    for _ in range(n):
        if not params.mhd:
            dt = dt_from_inv(params, compute_inv_dt_hydro(params, state, ghost=0))
            state = hydro_3d_state_update(params, state, dt)
        elif not isinstance(state, tuple):
            dt = dt_from_inv(params, inv_dt_mhd_periodic(params, state[:8]))
            state = mhd_3d_periodic_update(params, state, dt)
        else:
            face = state[1][0] if params.compensated else state[1]
            dt = dt_from_inv(params, inv_dt_mhd_shear(params, state[0], face))
            state = mhd_3d_shear_step(params, *state, t, dt, gz)
        t = t + dt
    return (state[0] if isinstance(state, tuple) else state), t


def phase27() -> None:
    """Each streamed kernel mode against its twin and the staged kernel, 1
    step and 10 chained steps of its loop against the twins' loop, f32 and
    f64."""
    from ramsesgpu_tpu_torch.solvers.step import make_packed_advance_chain

    for dtype in ("float32", "float64"):
        for name in ZCARRY_CASES:
            params, state, t0, gz = zcarry_case(name, dtype)
            e = zcarry_one_step(params, state, t0, gz)
            tag = f"[27] {name} {dtype}"
            print(f"{tag} 1 step: vs twin rel L2 {e['twin']:.3e}, vs staged {e['staged']:.3e} "
                  f"(tol {TOL_STEP1[dtype]:.0e}), max abs {e['max_abs']:.3e}"
                  + (f", x-face planes {e['planes']:.3e} (tol {TOL_PLANES[dtype]:.0e})"
                     if "planes" in e else "")
                  + (f", folded inv dt vs CFL kernel {e['fold_ulps']:.2f} ULP (bound {ULP_FOLD})"
                     if "fold_ulps" in e else "") + f", inactive copies: {e['idle_copy']}")
            if not (e["twin"] <= TOL_STEP1[dtype] and e["staged"] <= TOL_STEP1[dtype]
                    and e.get("planes", 0) <= TOL_PLANES[dtype]
                    and e.get("fold_ulps", 0) <= ULP_FOLD and e["idle_copy"]):
                raise AssertionError(f"{tag}: the streamed step disagrees: {e}")
            # 10 chained steps of the loop against the twins' loop
            config = None
            if name == "strat":
                config = mri_setup(64, 128, 64, dtype, compensated=None, ini=STRAT_INI)[1]
            _pack, advance, _unpack = make_packed_advance_chain(params, "cuda", config)
            st = tuple(x.clone() for x in state) if isinstance(state, tuple) else state.clone()
            st, t_k, k = advance(st, t0.clone(), 10)
            want, t_t = twin_loop(params, state, t0, gz, 10)
            got = st[0] if isinstance(st, tuple) else st
            rel10 = rel_l2(got[:8], want[:8])
            print(f"{tag} 10 chained steps: k={int(k)}, t {float(t_k)!r} (twins {float(t_t)!r}), "
                  f"rel L2 {rel10:.3e} (tol {TOL_Z10[dtype]:.0e})")
            if int(k) != 10 or not rel10 <= TOL_Z10[dtype]:
                raise AssertionError(f"{tag}: 10 chained steps disagree with the twins: {rel10}")
            del state, st


def phase31(card: str) -> None:
    """One 10-step chunk of Orszag-Tang at 512^3 f32 with kernel=zcarry:
    the state built on the card, its peak memory and the rings' bytes, in
    shared memory (the staged step's stage buffer would be 173 values per
    cell, ~93 GB)."""
    from ramsesgpu_tpu_torch.kernels.build import load_library
    from ramsesgpu_tpu_torch.kernels.zcarry_mhd3d import zcarry_mhd
    from ramsesgpu_tpu_torch.solvers.step import make_packed_advance_chain

    n, chunk = 512, 10
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params, S = setup(n, "float32")
    params = params.replace(kernel="zcarry")
    print(f"[31] Orszag-Tang {n}^3 f32 set up in {time.perf_counter() - t0:.1f} s "
          f"(host init, copy to the card)")
    blocks = zcarry_mhd.blocks(params, S)
    ring_bytes = blocks * load_library("cuda").ramses_zcarry_mhd_ring_bytes(0)
    zcarry_ring(params)
    b_over_dx = max(float(S[5].abs().max()), 1e-10) / params.dx
    mass0 = float(S[0].double().sum())
    _pack, advance, _unpack = make_packed_advance_chain(params, "cuda")
    with counted_main_path("31", {"zcarry_mhd": chunk, "cfl_mhd": 1}):
        t = torch.zeros((), device="cuda")
        torch.cuda.synchronize()
        start = time.perf_counter()
        S, t, k = advance(S, t, chunk)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated() - base
    divb = div_b_max(params, S)
    mass = float(S[0].double().sum())
    print(f"[31] {n}^3 f32 zcarry chunk on {card}: k={int(k)}, {wall * 1e3 / chunk:.3f} ms/step "
          f"(first chunk, build and warm-up included), {n ** 3 * chunk / wall:.4e} cells/s; "
          f"peak allocated {peak / 1e9:.3f} GB (bound 24 GB), the kernel's rings "
          f"{ring_bytes / 1e9:.4f} GB in shared memory ({blocks} blocks), none in device "
          f"memory (bound 1 GB); state {S.numel() * 4 / 1e9:.3f} GB; "
          f"max|divB| {divb:.3e} (bound {1e-3 * b_over_dx:.3e}), mass rel "
          f"{abs(mass - mass0) / abs(mass0):.3e} (1e-5)")
    if not (int(k) == chunk and bool(torch.isfinite(S).all())):
        raise AssertionError("512^3: non-finite state or a short chunk")
    if not (divb < 1e-3 * b_over_dx and abs(mass - mass0) <= 1e-5 * abs(mass0)):
        raise AssertionError("512^3: divB or mass bound violated")
    if not (peak < 24e9 and ring_bytes < 1e9):
        raise AssertionError(f"512^3: peak {peak} B or rings {ring_bytes} B above their bounds")


def zcarry_ring(params) -> None:
    """Row 12's tile and ring per dtype: its tile, the threads of its
    producer and consumer warp groups, the blocks an SM holds, the bytes of
    a block's ring in shared memory, and the depth of the z chunks it takes
    on the main paths' grids."""
    from ramsesgpu_tpu_torch.kernels.build import load_library, param_block

    lib = load_library("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for f64, name in ((0, "f32"), (1, "f64")):
        tile = (ctypes.c_int * 5)()
        lib.ramses_zcarry_mhd_tile(f64, tile)
        blocks = lib.ramses_zcarry_mhd_blocks(0, 0, f64, param_block(params))
        depths = ", ".join(
            f"{nx}x{ny}x{nz}: {lib.ramses_zcarry_mhd_chunk_depth(f64, nx, ny, nz, blocks)}"
            for nx, ny, nz in ((512, 512, 512), (256, 256, 256), (128, 256, 128)))
        print(f"[31] zcarry_mhd {name}: tile {tile[0]}x{tile[1]}, {tile[2]} threads: producer "
              f"{tile[3] // 32} warps, consumer {tile[4] // 32} warps; ring "
              f"{lib.ramses_zcarry_mhd_ring_bytes(f64)} B a block, {blocks / sms:g} blocks per SM "
              f"({blocks} on {sms} SMs); z chunk depth {depths}")


def phase32(card: str, ot, blast, mri, bounds: dict, twin_n: int, staged: dict, ot_comp,
            strat) -> dict:
    """The streamed kernels at full width on the end states of paths 29
    (Orszag-Tang 256^3), 28 (blast 256^3) and 30 (MRI 128x256x128):
    against their twins (the step's twin, then the CFL twin on its
    result), their times against the twins', and their bounds: the staged
    kernels' (phases 11, 15) bytes, read once and written once, and their
    operations plus the folded CFL's. Then row 12's other modes on the end
    states of paths 29c (compensated OT) and 30s (the stratified MRI), and
    each mode's time against its bound and against the staged step's
    (``staged``: phases 6, 14 and 25) on the same grid."""
    from ramsesgpu_tpu_torch.kernels.cfl_mhd import cfl_mhd
    from ramsesgpu_tpu_torch.kernels.hydro_step import hydro_step
    from ramsesgpu_tpu_torch.kernels.shear_border import shear_slabs, shear_zslabs
    from ramsesgpu_tpu_torch.kernels.zcarry_hydro3d import zcarry_hydro
    from ramsesgpu_tpu_torch.kernels.zcarry_mhd3d import zcarry_mhd
    from ramsesgpu_tpu_torch.solvers.godunov import hydro_3d_state_update
    from ramsesgpu_tpu_torch.solvers.godunov_mhd import mhd_3d_periodic_update, mhd_3d_shear_update
    from ramsesgpu_tpu_torch.solvers.timestep import (compute_inv_dt_hydro, dt_from_inv,
                                                      inv_dt_mhd_periodic, inv_dt_mhd_shear)

    res = {"ms": {}, "plain_ms": {}, "max_abs_err": {}, "bounds": {}}
    active = torch.ones((), dtype=torch.bool, device="cuda")

    # periodic MHD (with the folded CFL)
    params, S, _t = ot
    dt = dt_from_inv(params, inv_dt_mhd_periodic(params, S))
    S1 = torch.empty_like(S)
    res["ms"]["zcarry_mhd"] = time_ms(lambda: zcarry_mhd(params, S, S1, dt, active, fold=True),
                                      10)
    Sw = S if twin_n == 256 else S[:, :twin_n, :twin_n, :twin_n].contiguous()
    pw = params if twin_n == 256 else block_params(params, twin_n)
    S1 = torch.empty_like(Sw)
    inv = zcarry_mhd(pw, Sw, S1, dt, active, fold=True)
    S_t = mhd_3d_periodic_update(pw, Sw, dt)
    inv_t = inv_dt_mhd_periodic(pw, S_t)
    res["max_abs_err"]["zcarry_mhd"] = float((S1 - S_t).abs().max())
    rel, inv_rel = rel_l2(S1, S_t), abs(float(inv) - float(inv_t)) / float(inv_t)
    del S_t
    torch.cuda.empty_cache()
    res["plain_ms"]["zcarry_mhd"] = time_ms(
        lambda: inv_dt_mhd_periodic(pw, mhd_3d_periodic_update(pw, Sw, dt)), 2)
    print(f"[32] zcarry_mhd at {twin_n}^3 f32 (Orszag-Tang, path 29's end state): vs twin rel L2 "
          f"{rel:.3e} (tol {TOL_STEP1['float32']:.0e}), folded inv dt rel {inv_rel:.3e} "
          f"(tol {TOL_CFL['float32']:.0e}); kernel {res['ms']['zcarry_mhd']:.3f} ms at 256^3, "
          f"twin {res['plain_ms']['zcarry_mhd']:.3f} ms at {twin_n}^3 ({card})")
    if not (rel <= TOL_STEP1["float32"] and inv_rel <= TOL_CFL["float32"]):
        raise AssertionError("zcarry_mhd disagrees with its twin at full width")
    del Sw, S1
    # the bound: the state read and written once, and the step's operations
    # plus the folded CFL's (phase 11's counts on a 32^3 block)
    n = 256 ** 3
    res["bounds"]["zcarry_mhd"] = bound("32", "zcarry_mhd", 2 * 8 * 4 * n,
                                        bounds["ops"]["mhd_step"] + bounds["ops"]["cfl_mhd"],
                                        "256^3", n)

    # periodic hydro (folded CFL), the blast
    params, S = blast
    dt = dt_from_inv(params, compute_inv_dt_hydro(params, S, ghost=0))
    S1 = torch.empty_like(S)
    res["ms"]["zcarry_hydro"] = time_ms(lambda: zcarry_hydro(params, S, S1, dt, active), 10)
    inv = zcarry_hydro(params, S, S1, dt, active)
    S_t = hydro_3d_state_update(params, S, dt)
    inv_t = compute_inv_dt_hydro(params, S_t, ghost=0)
    res["max_abs_err"]["zcarry_hydro"] = float((S1 - S_t).abs().max())
    rel, inv_rel = rel_l2(S1, S_t), abs(float(inv) - float(inv_t)) / float(inv_t)
    del S_t
    torch.cuda.empty_cache()
    res["plain_ms"]["zcarry_hydro"] = time_ms(
        lambda: compute_inv_dt_hydro(params, hydro_3d_state_update(params, S, dt), ghost=0), 2)
    print(f"[32] zcarry_hydro at 256^3 f32 (blast, path 28's end state): vs twin rel L2 "
          f"{rel:.3e}, inv dt rel {inv_rel:.3e}; kernel {res['ms']['zcarry_hydro']:.3f} ms, "
          f"twin {res['plain_ms']['zcarry_hydro']:.3f} ms ({card})")
    if not (rel <= TOL_STEP1["float32"] and inv_rel <= TOL_CFL["float32"]):
        raise AssertionError("zcarry_hydro disagrees with its twin at full width")
    # its operations on this state: the counting build on a 32^3 block (one
    # trace per cell, one Riemann solve per face) and the Newton iterations
    # of this step, counted by the step kernel on the card, plus the CFL's
    n = 256 ** 3
    for dtype in ("float32", "float64"):
        Sd = S if dtype == "float32" else S.double()
        dtd = dt if dtype == "float32" else dt.double()
        newton = torch.zeros((), dtype=torch.int64, device="cuda")
        hydro_step(params, Sd, torch.empty_like(Sd), dtd, active, newton=newton)
        h = hydro_ops(params, Sd, float(dtd), int(newton))
        size = Sd.element_size()
        if dtype == "float32":
            res["bounds"]["zcarry_hydro"] = bound("32", "zcarry_hydro", 2 * 5 * size * n,
                                                  h["ops"] + h["cfl"], "256^3", n)
        # the streamed body's two uses on the periodic state: the step
        # kernel's interior mode (row A'-hydro) and row 13
        out = torch.empty_like(Sd)
        t_step = time_ms(lambda: hydro_step(params, Sd, out, dtd, active), 10)
        t_fold = (res["ms"]["zcarry_hydro"] if dtype == "float32" else
                  time_ms(lambda: zcarry_hydro(params, Sd, out, dtd, active), 10))
        hydro_stream_report("32", card, dtype, "interior (periodic)", t_step,
                            *hydro_bound(2 * 5 * size * n, h["ops"], dtype))
        hydro_stream_report("32", card, dtype, "row 13 (folded CFL)", t_fold,
                            *hydro_bound(2 * 5 * size * n, h["ops"] + h["cfl"], dtype))
        if dtype == "float32":
            print(f"[32] zcarry_hydro against the step kernel's periodic interior mode and the "
                  f"CFL kernel on the same state: {t_fold:.3f} ms against {t_step:.3f} + "
                  f"{staged['cfl_hydro']:.3f} ms ({card})")
        del Sd, out
    del S1

    # the shearing box (no folded CFL): the MRI path's end state
    params, S, kept, t, _config = mri
    dt = dt_from_inv(params, inv_dt_mhd_shear(params, S, kept))
    slabs = shear_slabs(params, S, kept, t, dt)
    planes = torch.zeros((5, params.nz, params.ny), device="cuda")
    S1 = torch.empty_like(S)
    res["ms"]["zcarry_mhd_shear"] = time_ms(
        lambda: zcarry_mhd(params, S, S1, dt, active, shear=(slabs, planes)), 10)
    zcarry_mhd(params, S, S1, dt, active, shear=(slabs, planes))
    S_t, planes_t = mhd_3d_shear_update(params, S, slabs, dt)
    res["max_abs_err"]["zcarry_mhd_shear"] = float((S1 - S_t).abs().max())
    rel = rel_l2(S1, S_t)
    rel_p = max(rel_l2(p, q) for p, q in zip(planes, planes_t))
    del S_t
    torch.cuda.empty_cache()
    res["plain_ms"]["zcarry_mhd_shear"] = time_ms(
        lambda: mhd_3d_shear_update(params, S, slabs, dt), 2)
    print(f"[32] zcarry_mhd_shear at 128x256x128 f32 (MRI, path 30's end state): vs twin rel L2 "
          f"{rel:.3e}, x-face planes {rel_p:.3e} (tol {TOL_PLANES['float32']:.0e}); kernel "
          f"{res['ms']['zcarry_mhd_shear']:.3f} ms, twin {res['plain_ms']['zcarry_mhd_shear']:.3f} "
          f"ms ({card})")
    if not (rel <= TOL_STEP1["float32"] and rel_p <= TOL_PLANES["float32"]):
        raise AssertionError("zcarry_mhd_shear disagrees with its twin at full width")
    res["bounds"]["zcarry_mhd_shear"] = bounds["mhd_step_shear"]
    print(f"[32] zcarry_mhd_shear: bound {bounds['mhd_step_shear'][0]:.5f} ms by "
          f"{bounds['mhd_step_shear'][1]} (the staged shear step's, phase 15: the same function)")
    del S1

    # the compensated periodic mode (folded CFL) and the stratified mode
    from ramsesgpu_tpu_torch.solvers.step import gravity_z

    params, S, _t = ot_comp
    dt = dt_from_inv(params, cfl_mhd(params, S))
    S1 = torch.empty_like(S)
    comp_ms = time_ms(lambda: zcarry_mhd(params, S, S1, dt, active, fold=True), 10)
    del S1
    params, S, kept, t, config = strat
    gz = gravity_z(params, config, "cuda").to(S.dtype)
    dt = dt_from_inv(params, cfl_mhd(params, S, kept=kept))
    slabs = shear_slabs(params, S, kept, t, dt)
    sh = (slabs, torch.zeros((5, params.nz, params.ny), dtype=S.dtype, device="cuda"),
          shear_zslabs(params, S, slabs), gz)
    S1 = torch.empty_like(S)
    strat_ms = time_ms(lambda: zcarry_mhd(params, S, S1, dt, active, shear=sh), 10)
    del S1
    # the compensated step's bound (phase 25, by its operations) with the
    # folded CFL's operations added
    comp_bound, by = bounds["mhd_step_comp"]
    if by == "operations":
        comp_bound += bounds["ops"]["cfl_mhd"] / F32_FLOP_PER_S * 1e3
    modes = {"periodic, folded CFL, 256^3": (res["ms"]["zcarry_mhd"], res["bounds"]["zcarry_mhd"][0],
                                             staged["mhd_step"]),
             "compensated, folded CFL, 256^3": (comp_ms, comp_bound, staged["mhd_step_comp"]),
             "shear, 128x256x128": (res["ms"]["zcarry_mhd_shear"], bounds["mhd_step_shear"][0],
                                    staged["mhd_step_shear"]),
             "stratified, 128x256x128": (strat_ms, bounds["mhd_step_strat"][0],
                                         staged["mhd_step_strat"])}
    for mode, (ms, bound_ms, staged_ms) in modes.items():
        print(f"[32] row 12 {mode} f32: {ms:.3f} ms, {ms / bound_ms:.1f}x its bound "
              f"({bound_ms:.4f} ms), {ms / staged_ms:.2f}x the staged step ({staged_ms:.3f} ms) "
              f"({card})")
    return res


# ---------------------------------------------------------------------------
# walls and the inflow jet: the ghosted modes of the step and CFL kernels
# (TPU row 3, pallas/fused_mhd3d.py:80; phases 33-35)
# ---------------------------------------------------------------------------
# the face types (xmin, xmax, ymin, ymax, zmin, zmax) of each walled case:
# the shipped 3D Brio-Wu under NEUMANN, DIRICHLET and a mix; and the MHD jet
# (its DIRICHLET walls)
WALL_CASES = {"neumann": (2,) * 6, "dirichlet": (1,) * 6, "mixed": (2, 2, 3, 3, 1, 1),
              "jet": None}
FACE_KEYS = ("boundary_xmin", "boundary_xmax", "boundary_ymin", "boundary_ymax",
             "boundary_zmin", "boundary_zmax")
HLLD_INI = "data/testRiemannHLLD.ini"
MHD_JET_INI = "data/mhd_jet3d.ini"
HYDRO_JET_INI = "data/jet3d_gpu.ini"


def shipped(path: str, dtype: str = "float32", mesh=None, faces=None, jet=None,
            bamb: float | None = None):
    """A shipped INI's ConfigMap and params, cut to ``mesh`` (nx, ny, nz)
    and, where given, with the faces, the jet's (ijet, offsetJet) and an
    ambient field bamb."""
    from ramsesgpu_tpu_torch.config.configmap import ConfigMap
    from ramsesgpu_tpu_torch.config.params import params_from_config

    config = ConfigMap(Path(path))
    for key, value in zip(("nx", "ny", "nz"), mesh or ()):
        config.set_integer("mesh", key, value)
    for key, value in zip(FACE_KEYS, faces or ()):
        config.set_integer("mesh", key, value)
    for key, value in zip(("ijet", "offsetJet"), jet or ()):
        config.set_integer("jet", key, value)
    if bamb is not None:
        config.set_float("jet", "bamb", bamb)
    config.set_string("implementation", "dtype", dtype)
    return config, params_from_config(config)


def ghosted_state(config, params, seed: int | None = None) -> torch.Tensor:
    """The filled ghosted initial state on the card; with ``seed``, the
    initial state times 1 + 0.05 N(0, 1) before the fill."""
    from ramsesgpu_tpu_torch.convert import torch_dtype
    from ramsesgpu_tpu_torch.problems import init_problem
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries

    U = torch.from_numpy(init_problem(params, config)).to(device="cuda",
                                                          dtype=torch_dtype(params))
    if seed is not None:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        U = U * (1 + 0.05 * torch.randn(U.shape, generator=gen, device="cuda", dtype=U.dtype))
    return make_boundaries(params, U).contiguous()


def wall_case(case: str, dtype: str, mesh, seed: int | None = None):
    """params and the filled ghosted state of one WALL_CASES case (the jet:
    ijet 4, offsetJet 5 and an ambient field 0.7, so that B varies)."""
    if case == "jet":
        config, params = shipped(MHD_JET_INI, dtype, mesh, jet=(4, 5), bamb=0.7)
    else:
        config, params = shipped(HLLD_INI, dtype, mesh, faces=WALL_CASES[case])
    return params, ghosted_state(config, params, seed)


def layer_mask(params) -> torch.Tensor:
    """The CT face layer of a ghosted state: the cube g .. n+g of every
    axis minus the interior, [nz+2g, ny+2g, nx+2g] on the card."""
    g = params.ghost_width
    shape = params.shape[1:]
    cube = torch.zeros(shape, dtype=torch.bool, device="cuda")
    cube[g:shape[0] - g + 1, g:shape[1] - g + 1, g:shape[2] - g + 1] = True
    cube[g:-g, g:-g, g:-g] = False
    return cube


def phase33() -> None:
    """The ghosted modes against their twins at 64x48x40, f32 + f64: for
    every face mix and the MHD jet, the CFL (the jet's floor in the
    kernel), one step on the whole ghosted array and on its CT face layer
    alone, an inactive step, make_fused_mhd_update (row 3's contract), and
    10 chained steps of the walled loop against the twins' loop; then the
    hydro jet's in-place ghosted step and its loop."""
    from ramsesgpu_tpu_torch.kernels.cfl_hydro import cfl_hydro
    from ramsesgpu_tpu_torch.kernels.cfl_mhd import cfl_mhd
    from ramsesgpu_tpu_torch.kernels.fused_mhd3d import make_fused_mhd_update
    from ramsesgpu_tpu_torch.kernels.hydro_step import hydro_step
    from ramsesgpu_tpu_torch.kernels.mhd_step import mhd_step
    from ramsesgpu_tpu_torch.solvers.boundary import fill_ghosts_, interior
    from ramsesgpu_tpu_torch.solvers.godunov import hydro_3d_interior_update
    from ramsesgpu_tpu_torch.solvers.godunov_mhd import mhd_3d_ghosted_update
    from ramsesgpu_tpu_torch.solvers.step import make_advance_n
    from ramsesgpu_tpu_torch.solvers.timestep import (compute_inv_dt_hydro, dt_from_inv,
                                                      inv_dt_mhd_ghosted, with_jet)

    mesh = (64, 48, 40)
    on = torch.ones((), dtype=torch.bool, device="cuda")
    off = torch.zeros_like(on)
    for dtype in ("float32", "float64"):
        for case in WALL_CASES:
            label = f"33 {case} {dtype}"
            params, U = wall_case(case, dtype, mesh, seed=33)
            g = params.ghost_width
            inv, inv_t = cfl_mhd(params, U, ghost=g), inv_dt_mhd_ghosted(params, U)
            check(f"{label} cfl_mhd ghosted", abs(float(inv) - float(inv_t)) / float(inv_t),
                  TOL_CFL[dtype], f"; kernel {float(inv)!r}, twin {float(inv_t)!r}")
            dt = dt_from_inv(params, inv_t)
            want = mhd_3d_ghosted_update(params, U, dt)
            scratch = mhd_step.scratch(params, U, ghosted=True)
            got = U.clone()
            mhd_step.ghosted(params, got, dt, off, scratch)
            if not torch.equal(got, U):
                raise AssertionError(f"{label}: an inactive step changed the state")
            mhd_step.ghosted(params, got, dt, on, scratch)
            layer = layer_mask(params)
            check(f"{label} mhd_step ghosted 1 step, whole ghosted array", rel_l2(got, want),
                  TOL_STEP1[dtype], f", max abs {float((got - want).abs().max()):.3e}")
            check(f"{label} mhd_step ghosted 1 step, CT face layer n+g alone",
                  rel_l2(got[5:, layer], want[5:, layer]), TOL_STEP1[dtype])
            fused = make_fused_mhd_update(params, "cuda")(U, dt)
            check(f"{label} make_fused_mhd_update (row 3's contract)",
                  rel_l2(fused, interior(params, want)), TOL_STEP1[dtype])
            t0 = torch.zeros((), dtype=U.dtype, device="cuda")
            got, t, k = make_advance_n(params, "cuda")(U, t0, 10)
            want, t_ref = U.clone(), t0.clone()
            for _ in range(10):
                dt = dt_from_inv(params, inv_dt_mhd_ghosted(params, want))
                want = mhd_3d_ghosted_update(params, fill_ghosts_(params, want), dt)
                t_ref = t_ref + dt
            t_rel = abs(float(t) - float(t_ref)) / float(t_ref)
            check(f"{label} 10 chained steps of the walled loop", rel_l2(got, want),
                  TOL_STEP10[dtype], f"; k={int(k)}, t rel {t_rel:.3e}")
            if int(k) != 10 or not t_rel <= TOL_STEP10[dtype]:
                raise AssertionError(f"{label}: k={int(k)}, t rel {t_rel}")
            del scratch, got, want
        # the hydro jet: the in-place ghosted step, its CFL with the jet's floor
        label = f"33 hydro jet {dtype}"
        config, params = shipped(HYDRO_JET_INI, dtype, mesh, jet=(8, 10))
        U = ghosted_state(config, params, seed=34)
        g = params.ghost_width
        inv = cfl_hydro(params, U, ghost=g)
        inv_t = with_jet(params, compute_inv_dt_hydro(params, U, ghost=g))
        check(f"{label} cfl_hydro ghosted", abs(float(inv) - float(inv_t)) / float(inv_t),
              TOL_CFL[dtype])
        dt = dt_from_inv(params, inv_t)
        want = U.clone()
        interior(params, want).copy_(hydro_3d_interior_update(params, U, dt))
        buf = hydro_step.scratch(params, U)
        got = U.clone()
        hydro_step.ghosted_(params, got, dt, off, buf)
        if not torch.equal(got, U):
            raise AssertionError(f"{label}: an inactive step changed the state")
        hydro_step.ghosted_(params, got, dt, on, buf)
        check(f"{label} hydro_step ghosted in place, 1 step", rel_l2(got, want), TOL_STEP1[dtype])
        t0 = torch.zeros((), dtype=U.dtype, device="cuda")
        got, t, k = make_advance_n(params, "cuda")(U, t0, 10)
        want = U.clone()
        for _ in range(10):
            dt = dt_from_inv(params, with_jet(params, compute_inv_dt_hydro(params, want, ghost=g)))
            fill_ghosts_(params, want)
            interior(params, want).copy_(hydro_3d_interior_update(params, want, dt))
        check(f"{label} 10 chained steps of the jet loop", rel_l2(got, want), TOL_STEP10[dtype],
              f"; k={int(k)}")
        if int(k) != 10:
            raise AssertionError(f"{label}: k={int(k)}")


def div_b_ghosted(params, U: torch.Tensor) -> float:
    """max|divB| over the interior of a ghosted state, each cell's +1 faces
    from the array (the last cell's from the CT face layer n+g)."""
    g = params.ghost_width
    zi, yi, xi = (slice(g, g + n) for n in (params.nz, params.ny, params.nx))
    zp, yp, xp = (slice(g + 1, g + n + 1) for n in (params.nz, params.ny, params.nx))
    bx, by, bz = (U[c].double() for c in (5, 6, 7))
    div = ((bx[zi, yi, xp] - bx[zi, yi, xi]) / params.dx
           + (by[zi, yp, xi] - by[zi, yi, xi]) / params.dy
           + (bz[zp, yi, xi] - bz[zi, yi, xi]) / params.dz)
    return float(div.abs().max())


def mhd_pressure(params, U: torch.Tensor) -> torch.Tensor:
    """The gas pressure of a ghosted MHD state's interior (cell-centred B)."""
    g = params.ghost_width
    zi, yi, xi = (slice(g, g + n) for n in (params.nz, params.ny, params.nx))
    zp, yp, xp = (slice(g + 1, g + n + 1) for n in (params.nz, params.ny, params.nx))
    W = U[:, zi, yi, xi].double()
    bx = 0.5 * (W[5] + U[5, zi, yi, xp].double())
    by = 0.5 * (W[6] + U[6, zi, yp, xi].double())
    bz = 0.5 * (W[7] + U[7, zp, yi, xi].double())
    ekin = 0.5 * (W[2:5] ** 2).sum(0) / W[0]
    return (params.gamma0 - 1.0) * (W[1] - ekin - 0.5 * (bx * bx + by * by + bz * bz))


def check_walled_state(label: str, params, U: torch.Tensor) -> str:
    """The gates of a walled or jet run's ghosted state: finite, rho > 0,
    p > 0 on the interior, and for MHD max|divB| < 1e-3 max|Bx| / dx
    (PERF.md section 2). Returns the numbers as text."""
    from ramsesgpu_tpu_torch.solvers.boundary import interior

    if not bool(torch.isfinite(U).all()):
        raise AssertionError(f"{label}: non-finite state")
    inner = interior(params, U)
    rho_min = float(inner[0].min())
    if params.mhd:
        p_min = float(mhd_pressure(params, U).min())
        divb = div_b_ghosted(params, U)
        b_over_dx = max(float(inner[5].abs().max()), 1e-10) / params.dx
        text = (f"min rho {rho_min:.4e}, min p {p_min:.4e}, max|divB| {divb:.3e} "
                f"(bound {1e-3 * b_over_dx:.3e})")
        if not divb < 1e-3 * b_over_dx:
            raise AssertionError(f"{label}: divB bound violated: {text}")
    else:
        p_min = float(hydro_pressure(params, inner).min())
        text = f"min rho {rho_min:.4e}, min p {p_min:.4e}"
    if not (rho_min > 0 and p_min > 0):
        raise AssertionError(f"{label}: non-positive density or pressure: {text}")
    return text


def phase34(card: str, n_twin: int) -> dict:
    """The walled MHD main path: data/testRiemannHLLD.ini's physics (3D
    Brio-Wu, six NEUMANN faces) at 256^3 f32 through
    make_packed_advance_chain, 2 warm-up + 3 timed chunks of 10 steps; its
    launches, peak memory, gates and one profiled chunk (device time by
    kernel: step, CFL, fill); then the ghosted step and CFL kernels with
    CUDA events on the path's end state, against their twins (at n_twin^3,
    phase 6's choice) and their bounds (bytes read and written once, the
    operations of the interior counted by build("count") on a 32^3 block)."""
    from ramsesgpu_tpu_torch.kernels.build import load_library, param_block
    from ramsesgpu_tpu_torch.kernels.cfl_mhd import cfl_mhd
    from ramsesgpu_tpu_torch.kernels.mhd_step import mhd_step
    from ramsesgpu_tpu_torch.solvers.boundary import fill_ghosts_
    from ramsesgpu_tpu_torch.solvers.godunov_mhd import mhd_3d_ghosted_update
    from ramsesgpu_tpu_torch.solvers.step import make_packed_advance_chain
    from ramsesgpu_tpu_torch.solvers.timestep import dt_from_inv, inv_dt_mhd_ghosted

    n, chunk, steps = 256, 10, 50
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    config, params = shipped(HLLD_INI, "float32", (n, n, n))
    U = ghosted_state(config, params)
    g = params.ghost_width
    pack, advance, unpack = make_packed_advance_chain(params, "cuda")
    t = torch.zeros((), dtype=torch.float32, device="cuda")
    with counted_main_path("34", {"mhd_step": steps, "cfl_mhd": steps}) as launches:
        S = pack(U)
        del U
        S, t, _dt = run_chunks("34", card, advance, S, t, n, chunk)
    peak = torch.cuda.max_memory_allocated() - base
    gates = check_walled_state("34", params, S)
    print(f"[34] {steps} steps at {n}^3 f32 (six NEUMANN faces) on {card}: t={float(t)!r}, "
          f"{gates}; launches per step: mhd_step {launches['mhd_step'] / steps:g}, cfl_mhd "
          f"{launches['cfl_mhd'] / steps:g}; peak allocated {peak / 1e9:.3f} GB (ghosted state "
          f"{S.numel() * 4 / 1e9:.3f} GB, stage buffer "
          f"{mhd_step.scratch_size(load_library('cuda'), params, True) * 4 / 1e9:.3f} GB)")
    if tuple(unpack(S, t).shape) != params.shape:
        raise AssertionError("34: unpacked shape")
    rows = profile_chunk("34p", card, advance, S, t, chunk)
    parts = {"step": 0.0, "cfl": 0.0, "fill": 0.0}
    for key, (us, _count) in rows.items():
        part = "step" if "mhd::" in key else "cfl" if "max_" in key else "fill"
        parts[part] += us
    busy = sum(parts.values())
    print("[34p] device time per step by part: " + ", ".join(
        f"{k} {v / 1e3 / chunk:.4f} ms ({100 * v / busy:.1f} %)" for k, v in parts.items()))

    # the kernels on the path's end state, filled as the loop fills it
    on = torch.ones((), dtype=torch.bool, device="cuda")
    W = fill_ghosts_(params, S.clone())
    del S
    inv = cfl_mhd(params, W, ghost=g)
    dt = dt_from_inv(params, inv)
    scratch = mhd_step.scratch(params, W, ghosted=True)
    got = mhd_step.ghosted(params, W.clone(), dt, on, scratch)
    W_t = W.clone()
    ms = {"mhd_step_ghosted": time_ms(lambda: mhd_step.ghosted(params, W_t, dt, on, scratch), 10),
          "cfl_mhd_ghosted": time_ms(lambda: cfl_mhd(params, W, ghost=g), 50)}
    del W_t, scratch
    bound_input = W[:, :32 + 2 * g, :32 + 2 * g, :32 + 2 * g].double().cpu().contiguous()
    if n_twin != n:
        config, params = shipped(HLLD_INI, "float32", (n_twin,) * 3)
        W = ghosted_state(config, params, seed=35)
        inv = cfl_mhd(params, W, ghost=g)
        dt = dt_from_inv(params, inv)
        got = mhd_step.ghosted(params, W.clone(), dt, on, mhd_step.scratch(params, W, True))
    torch.cuda.empty_cache()
    inv_t = inv_dt_mhd_ghosted(params, W)
    want = mhd_3d_ghosted_update(params, W, dt)
    errs = {"mhd_step_ghosted": float((got - want).abs().max()),
            "cfl_mhd_ghosted": abs(float(inv) - float(inv_t))}
    rel = {"mhd_step_ghosted": rel_l2(got, want),
           "cfl_mhd_ghosted": errs["cfl_mhd_ghosted"] / float(inv_t)}
    del got, want
    plain = {"mhd_step_ghosted": time_ms(lambda: mhd_3d_ghosted_update(params, W, dt), 3),
             "cfl_mhd_ghosted": time_ms(lambda: inv_dt_mhd_ghosted(params, W), 10)}
    tol = {"mhd_step_ghosted": TOL_STEP1["float32"], "cfl_mhd_ghosted": TOL_CFL["float32"]}
    for name in ms:
        check(f"34 {name} at {n_twin}^3 f32 (the path's state)", rel[name], tol[name],
              f", max abs {errs[name]:.3e}")
        print(f"[34] {name}: kernel {ms[name]:.3f} ms at {n}^3 (CUDA events), twin "
              f"{plain[name]:.3f} ms at {n_twin}^3 (f32, {card})")
    del W

    # bounds: the operations of the interior, counted on a 32^3 block of the
    # end state (its first 32 + 2g layers on each axis: a ghosted block)
    lib = load_library("count")
    p_blk = block_params(params, 32)
    cells, ng = n ** 3, (n + 2 * g) ** 3
    ops = {"mhd_step_ghosted": lib.ramses_mhd_step_ghosted_ops(
               bound_input.data_ptr(), 32, 32, 32, g, param_block(p_blk), float(dt)) / 32 ** 3,
           "cfl_mhd_ghosted": lib.ramses_cfl_mhd_ghosted_ops(
               bound_input.data_ptr(), 32, 32, 32, g, param_block(p_blk)) / 32 ** 3}
    # the ghosted state read once, the interior and the CT face layer's
    # three face fields written once; the CFL reads the interior's 8 values
    nbytes = {"mhd_step_ghosted": 4 * (8 * ng + 8 * cells + 3 * ((n + 1) ** 3 - cells)),
              "cfl_mhd_ghosted": 4 * 8 * cells}
    bounds = {name: bound("34", name, nbytes[name], ops[name] * cells, f"{n}^3", cells)
              for name in ms}
    for name in ms:
        print(f"[34] {name}: {ms[name]:.3f} ms against its bound {bounds[name][0]:.4f} ms "
              f"({ms[name] / bounds[name][0]:.1f}x)")
    return {"ms": ms, "plain_ms": plain, "max_abs_err": errs, "bounds": bounds,
            "launches": {"mhd_step_ghosted": launches["mhd_step"],
                         "cfl_mhd_ghosted": launches["cfl_mhd"]}}


def phase35(card: str) -> None:
    """data/testRiemannHLLD.ini, data/mhd_jet3d.ini and data/jet3d_gpu.ini
    as shipped, through Run on CUDA for at most 50 steps each (nstepmax
    permitting): one step kernel and one CFL launch per step, no twin, and
    the gates of phase 34."""
    from ramsesgpu_tpu_torch.config.configmap import ConfigMap
    from ramsesgpu_tpu_torch.config.params import params_from_config
    from ramsesgpu_tpu_torch.solvers.run import Run

    for path in (HLLD_INI, MHD_JET_INI, HYDRO_JET_INI):
        config = ConfigMap(Path(path))
        params = params_from_config(config)
        steps = min(50, params.n_stepmax)
        label = f"35 {Path(path).name}"
        expect = ({"mhd_step": steps, "cfl_mhd": steps} if params.mhd
                  else {"hydro_step": steps, "cfl_hydro": steps})
        with counted_main_path(label, expect):
            run = Run(config, "cuda", params)
            run.start(max_steps=50, do_output=False)
        print(f"[{label}] {params.nx}x{params.ny}x{params.nz} {params.dtype} as shipped on "
              f"{card}: {run.n_step} steps, t={run.t!r}, "
              + check_walled_state(label, params, run.U))
        if run.n_step != steps:
            raise AssertionError(f"{label}: {run.n_step} steps, expected {steps}")


# ---------------------------------------------------------------------------
# the sharded shearing box (TPU row 4): phases 36-38
# ---------------------------------------------------------------------------
DEBUG_INI = "data/mhd_mri_3d_mpi_debug.ini"
STRAT_MPI_INI = "data/mhd_mri_3d_stratified_mpi.ini"
# JAX's sharded-vs-single budget (tests/test_parallel.py:444), printed
# beside the gate: its atol is a quarter of the debug input's field and
# larger than its velocity perturbation
SHARDED_RTOL, SHARDED_ATOL = 1e-4, 2e-5
# the gate: each channel's relative L2 against the single-rank path, per
# phase, set between the clean run's reading and what a planted fault reads
# (PERF.md section 6, PR 8)
SHARDED_REL_L2 = {"37": 1e-6, "38": 5e-4}
# the window stage grid's cells of each stage, beyond the interior n per
# axis (csrc/mhd_step.cu, the shear window mode): prim, efield, precursors,
# fluxes and EMFs, update
WINDOW_STAGE_EXTRA = (4, 3, 2, 1, 0)


def window_of(params, U: torch.Tensor, topo, rank):
    """The ghosted window of rank (iz, iy, ix) of the grid ``topo`` (mx, my,
    mz) cut from the ghosted global state U, and the window's params, x0
    and z0."""
    mx, my, mz = topo
    iz, iy, ix = rank
    g = params.ghost_width
    lnx, lny, lnz = params.nx // mx, params.ny // my, params.nz // mz
    W = U[:, iz * lnz:iz * lnz + lnz + 2 * g, iy * lny:iy * lny + lny + 2 * g,
          ix * lnx:ix * lnx + lnx + 2 * g].contiguous()
    lp = params.replace(nx=lnx, ny=lny, nz=lnz, xmax=params.xmin + lnx * params.dx,
                        ymax=params.ymin + lny * params.dy, zmax=params.zmin + lnz * params.dz)
    return lp, W, params.xmin + ix * lnx * params.dx, params.zmin + iz * lnz * params.dz


def window_gz(params, config, lp, z0: float, W: torch.Tensor):
    """g_z of the window's rows as kernels/fused_mhd3d.py make_fused_mhd_shear
    forms them, or None without static gravity."""
    from ramsesgpu_tpu_torch.solvers.step import mri_gz_profile
    from ramsesgpu_tpu_torch.solvers.stratified import uses_stratified_z

    if not uses_stratified_z(params):
        return None
    rows = torch.arange(W.shape[1], dtype=W.dtype, device=W.device)
    zc = torch.tensor(z0, dtype=W.dtype, device=W.device) + lp.dz / 2 + (
        rows - lp.ghost_width) * lp.dz
    return mri_gz_profile(params, config)(zc).contiguous()


def window_case36(ini: str, mesh, topo, rank, dtype: str, seed: int):
    """``ini`` at ``mesh`` (compensated=no), its sheared fill at a t0 whose
    offset is 2.5 cells, times (1 + 0.01 N(0, 1)); rank ``rank``'s window of
    the grid ``topo``: (params, config, lp, W, x0, z0, gz)."""
    from ramsesgpu_tpu_torch.kernels.shear import unpack

    params, config, state = mri_setup(*mesh, dtype, ini=ini)
    U = unpack(params, state, shear_t0(params, state[0].dtype))
    if seed is not None:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        U = U * (1 + 0.01 * torch.randn(U.shape, generator=gen, device="cuda",
                                        dtype=torch.float64).to(U.dtype))
    lp, W, x0, z0 = window_of(params, U, topo, rank)
    return params, config, lp, W, x0, z0, window_gz(params, config, lp, z0, W)


def phase36(card: str) -> dict:
    """Row 4 and the ghosted-shear CFL against their twins on one rank's
    window, then their times and bounds at the sharded MRI's local size."""
    from ramsesgpu_tpu_torch.kernels.build import load_library, param_block, window_block
    from ramsesgpu_tpu_torch.kernels.cfl_mhd import cfl_mhd_window
    from ramsesgpu_tpu_torch.kernels.mhd_step import mhd_window
    from ramsesgpu_tpu_torch.solvers.godunov_mhd import mhd_3d_shear_window_update
    from ramsesgpu_tpu_torch.solvers.timestep import dt_from_inv, inv_dt_mhd_ghosted_shear

    cases = {"ideal": (DEBUG_INI, (32, 64, 32), (2, 2, 1), (0, 1, 1)),
             "stratified": (STRAT_MPI_INI, (32, 64, 32), (2, 1, 2), (1, 0, 1))}
    for name, (ini, mesh, topo, rank) in cases.items():
        for dtype in ("float32", "float64"):
            _p, _c, lp, W, x0, z0, gz = window_case36(ini, mesh, topo, rank, dtype, seed=36)
            label = f"36 {name} {dtype}"
            inv, inv_t = cfl_mhd_window(lp, W), inv_dt_mhd_ghosted_shear(lp, W)
            u = ulps(inv, inv_t)
            print(f"[{label}] window {lp.nx}x{lp.ny}x{lp.nz} at x0={x0!r}, z0={z0!r} of "
                  f"{mesh}: CFL {u:.2f} ULP (bound 4)")
            if not u <= 4:
                raise AssertionError(f"{label}: the ghosted-shear CFL disagrees: {u} ULP")
            dt = dt_from_inv(lp, inv_t)
            out, planes = mhd_window(lp, W, dt, x0, gz, mhd_window.scratch(lp, W))
            want, want_p = mhd_3d_shear_window_update(lp, W, dt, x0, gz)
            check(label, rel_l2(out, want), TOL_STEP1[dtype],
                  f", max abs {float((out - want).abs().max()):.3e}")
            for c in range(5):
                check(f"{label} plane {c}", rel_l2(planes[c], want_p[c]), TOL_PLANES[dtype])
    # at the sharded MRI's local size: rank (0, 0, 1) of 2x2x1 at 128x256x128
    params, config, lp, W, x0, z0, gz = window_case36(DEBUG_INI, (128, 256, 128), (2, 2, 1),
                                                      (0, 0, 1), "float32", seed=None)
    inv = cfl_mhd_window(lp, W)
    inv_t = inv_dt_mhd_ghosted_shear(lp, W)
    dt = dt_from_inv(lp, inv_t)
    scratch = mhd_window.scratch(lp, W)
    out, planes = mhd_window(lp, W, dt, x0, gz, scratch)
    want, want_p = mhd_3d_shear_window_update(lp, W, dt, x0, gz)
    size = f"{lp.nx}x{lp.ny}x{lp.nz}"
    errs = {"mhd_window": float((out - want).abs().max()),
            "cfl_mhd_window": abs(float(inv) - float(inv_t))}
    check(f"36 row 4 at {size} f32", rel_l2(out, want), TOL_STEP1["float32"])
    u = ulps(inv, inv_t)
    print(f"[36] ghosted-shear CFL at {size} f32: {u:.2f} ULP")
    if not u <= 4:
        raise AssertionError(f"36: the ghosted-shear CFL disagrees at {size}: {u} ULP")
    del out, planes, want, want_p
    ms = {"mhd_window": time_ms(lambda: mhd_window(lp, W, dt, x0, gz, scratch), 20),
          "cfl_mhd_window": time_ms(lambda: cfl_mhd_window(lp, W), 50)}
    plain = {"mhd_window": time_ms(lambda: mhd_3d_shear_window_update(lp, W, dt, x0, gz), 3),
             "cfl_mhd_window": time_ms(lambda: inv_dt_mhd_ghosted_shear(lp, W), 10)}
    for name in ms:
        print(f"[36] {name} at {size} f32 (window {tuple(W.shape[1:])}): kernel "
              f"{ms[name]:.4f} ms (CUDA events), twin {plain[name]:.3f} ms ({card})")
    # bounds: each stage's operations per cell, counted on a 16x32x32 window
    # of the same state, times its cells at this size; the window read once,
    # the interior and the five planes written once
    lib = load_library("count")
    m = (16, 32, 32)
    g = lp.ghost_width
    small = W[:, :m[2] + 2 * g, :m[1] + 2 * g, :m[0] + 2 * g].double().cpu().contiguous()
    p_small = lp.replace(nx=m[0], ny=m[1], nz=m[2], xmax=lp.xmin + m[0] * lp.dx,
                         ymax=lp.ymin + m[1] * lp.dy, zmax=lp.zmin + m[2] * lp.dz)
    per = (ctypes.c_longlong * len(WINDOW_STAGE_EXTRA))()
    lib.ramses_mhd_step_window_ops(small.data_ptr(), None, *m, g, window_block(p_small, x0),
                                   float(dt), per)
    n_small = [(m[0] + e) * (m[1] + e) * (m[2] + e) for e in WINDOW_STAGE_EXTRA]
    n_full = [(lp.nx + e) * (lp.ny + e) * (lp.nz + e) for e in WINDOW_STAGE_EXTRA]
    ops_row4 = sum(p / ns * nf for p, ns, nf in zip(per, n_small, n_full))
    ops_cfl = lib.ramses_cfl_mhd_ghosted_shear_ops(small.data_ptr(), *m, g,
                                                   param_block(p_small)) / (m[0] * m[1] * m[2])
    cells = lp.nx * lp.ny * lp.nz
    nbytes = {"mhd_window": 4 * (W.numel() + 8 * cells + 5 * lp.nz * lp.ny),
              "cfl_mhd_window": 4 * 8 * cells}
    bounds = {"mhd_window": bound("36", "mhd_window", nbytes["mhd_window"], ops_row4, size,
                                  cells),
              "cfl_mhd_window": bound("36", "cfl_mhd_window", nbytes["cfl_mhd_window"],
                                      ops_cfl * cells, size, cells)}
    for name in ms:
        print(f"[36] {name}: {ms[name]:.4f} ms against its bound {bounds[name][0]:.5f} ms "
              f"({ms[name] / bounds[name][0]:.1f}x)")
    del W, scratch
    torch.cuda.empty_cache()
    return {"ms": ms, "plain_ms": plain, "max_abs_err": errs, "bounds": bounds}


def sharded_ini(path: str, mesh=None) -> str:
    """The INI text of ``path``, at ``mesh`` (nx, ny, nz) when given."""
    import re

    text = Path(path).read_text()
    for key, value in zip(("nx", "ny", "nz"), mesh or ()):
        text, n = re.subn(rf"^{key}=.*$", f"{key}={value}", text, flags=re.M)
        if n != 1:
            raise AssertionError(f"{path}: {key}")
    return text


def div_b_rebuilt(params, S: torch.Tensor) -> float:
    """max |divB| of a gathered shearing-box interior, the xmax face of the
    last column rebuilt from divB = 0 as parallel/shear_dist.py
    fix_xmax_bx_face rebuilds it (the y and z +1 faces wrap)."""
    S = S.double()
    by, bz = S[6], S[7]
    dby = (torch.roll(by, -1, -2) - by)[..., -1] / params.dy
    dbz = (torch.roll(bz, -1, -3) - bz)[..., -1] / params.dz
    face = S[5][..., -1] - params.dx * (dby + dbz)
    return div_b_shear(params, S, face)


def sharded_gates(label: str, params, S: torch.Tensor, S0: torch.Tensor,
                  single: torch.Tensor | None = None) -> str:
    """Finite state, mass within 1e-5, max|divB| < 1e-3 max|B|/dx with the
    rebuilt face. A stratified box lets mass out through its z faces, so
    there the mass change is held against the single-rank path's
    (``single``) within 1e-6 of the mass."""
    if not bool(torch.isfinite(S).all()):
        raise AssertionError(f"{label}: non-finite state")
    mass0, mass = float(S0[0].double().sum()), float(S[0].double().sum())
    rel = abs(mass - mass0) / abs(mass0)
    tol = 1e-5
    if single is not None:
        rel = abs(mass - float(single[0].double().sum())) / abs(mass0)
        tol = 1e-6
    divb = div_b_rebuilt(params, S)
    b_over_dx = max(float(S[5:8].abs().max()), 1e-30) / params.dx
    if not rel <= tol or not float(S[0].min()) > 0:
        raise AssertionError(f"{label}: mass {rel} (tol {tol}), min rho {float(S[0].min())}")
    if not divb < 1e-3 * b_over_dx:
        raise AssertionError(f"{label}: divB {divb} (bound {1e-3 * b_over_dx})")
    what = "mass rel" if single is None else (
        f"mass change {abs(mass - mass0) / abs(mass0):.3e}, against the single-rank path's")
    return (f"finite, {what} {rel:.3e} (tol {tol:.0e}), max|divB| {divb:.3e} (bound "
            f"{1e-3 * b_over_dx:.3e}), min rho {float(S[0].min()):.4e}")


def check_rank_counts(label: str, ranks: list, steps: int) -> None:
    want = {"mhd_window": steps, "cfl_mhd_window": steps, "mhd_step": 0, "cfl_mhd": 0}
    for r in ranks:
        print(f"[{label}] rank {r['rank']} ({r['device']}): launches {r['counts']}")
        if r["counts"] != want:
            raise AssertionError(f"{label}: rank {r['rank']} launches {r['counts']}, "
                                 f"expected {want}")


def phase37(card: str, row4: dict) -> dict:
    """The sharded MRI at 128x256x128 f32 on four ranks sharing the card:
    in one world, 5 chunks of 10 steps from the initial state (2 warm-up,
    3 timed), then 10 steps from the initial state again with each step's
    sections profiled, held against the single-rank path."""
    from ramsesgpu_tpu_torch.config.configmap import ConfigMap
    from ramsesgpu_tpu_torch.parallel.launch import spawn_ranks
    from ramsesgpu_tpu_torch.parallel.sharded_step import rank_jobs
    from ramsesgpu_tpu_torch.problems import init_problem

    nx, ny, nz, chunk, compare = 128, 256, 128, 10, 10
    text = sharded_ini(DEBUG_INI, (nx, ny, nz))
    torch.cuda.empty_cache()
    jobs = [dict(config_text=text, device="cuda", n_steps=chunk, chunks=5),
            dict(config_text=text, device="cuda", n_steps=compare, profile=True)]
    per_rank = spawn_ranks(rank_jobs, 4, (jobs,))
    ranks, profiled = [r[0] for r in per_rank], [r[1] for r in per_rank]
    r0 = ranks[0]
    print(f"[37] {DEBUG_INI} at {nx}x{ny}x{nz} f32: {r0['transport']}, devices "
          f"{[r['device'] for r in ranks]}")
    if any(r["k"] != chunk for r in ranks):
        raise AssertionError(f"37: a chunk stopped early: {[r['k'] for r in ranks]}")
    per_chunk = [max(r["chunk_s"][i] for r in ranks) for i in range(2, 5)]
    best = min(per_chunk)
    cells = nx * ny * nz
    ms_step = best * 1e3 / chunk
    print(f"[37] main path {nx}x{ny}x{nz} f32 on {card}: best chunk {ms_step:.3f} ms/step, "
          f"{cells * chunk / best:.4e} cells/s (chunks "
          f"{[round(x * 1e3 / chunk, 3) for x in per_chunk]} ms/step, slowest rank each)")
    kernels_per_step = 4 * (row4["ms"]["mhd_window"] + row4["ms"]["cfl_mhd_window"])
    print(f"[37] kernel work per global step from phase 36's times: 4 x (row 4 "
          f"{row4['ms']['mhd_window']:.4f} + CFL {row4['ms']['cfl_mhd_window']:.4f}) = "
          f"{kernels_per_step:.4f} ms; share of the step outside the kernels (staging, "
          f"collectives, the fill and the post-correction): {1 - kernels_per_step / ms_step:.4f}")
    print(f"[37] {compare} steps from the initial state profiled on {card} (each section ends "
          f"in a device sync; CUDA events around each launch hold the other ranks' work that "
          f"the card time-sliced in), ms per step:")
    for r in profiled:
        prof = r["profile"]
        walls = ", ".join(f"{k} {v / compare:.3f}" for k, v in prof["wall_ms"].items())
        events = ", ".join(f"{k} {v / compare:.4f}" for k, v in prof["kernel_ms"].items())
        print(f"[37p] rank {r['rank']}: step {r['chunk_s'][0] * 1e3 / compare:.3f}; sections: "
              f"{walls}; kernel events: {events}")
    check_rank_counts("37", ranks, 5 * chunk)
    check_rank_counts("37p", profiled, compare)
    params = params_from_text(text)
    g = params.ghost_width
    S0 = torch.from_numpy(init_problem(params, ConfigMap(text=text)))[:, g:-g, g:-g, g:-g]
    S = torch.from_numpy(r0["U"])
    print(f"[37] {5 * chunk} steps: t={r0['t']!r}; " + sharded_gates("37", params, S, S0))
    # the single-rank MRI path on the same global mesh, 10 steps from t = 0
    p0 = profiled[0]
    compare_single("37", text, torch.from_numpy(p0["U"]), S0, p0["t"], p0["k"], compare,
                   SHARDED_REL_L2["37"])
    return {"launches": {"mhd_window": sum(r["counts"]["mhd_window"] for r in ranks),
                         "cfl_mhd_window": sum(r["counts"]["cfl_mhd_window"] for r in ranks)}}


def single_rank(text: str, steps: int):
    """(interior, t, k) of the single-rank MRI path (make_packed_advance_chain
    on the card) from the INI's initial state at t = 0, compensated=no as
    the distributed path runs."""
    from ramsesgpu_tpu_torch.config.configmap import ConfigMap
    from ramsesgpu_tpu_torch.convert import torch_dtype
    from ramsesgpu_tpu_torch.problems import init_problem
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries
    from ramsesgpu_tpu_torch.solvers.step import make_packed_advance_chain

    config = ConfigMap(text=text.replace("compensated=yes", "compensated=no"))
    params = params_from_text(text.replace("compensated=yes", "compensated=no"))
    pack, advance, _unpack = make_packed_advance_chain(params, "cuda", config)
    U0 = torch.from_numpy(init_problem(params, config)).to("cuda", torch_dtype(params))
    state, t, k = advance(pack(make_boundaries(params, U0)),
                          torch.zeros((), dtype=U0.dtype, device="cuda"), steps)
    return state[0].cpu(), float(t), int(k)


def compare_single(label: str, text: str, got: torch.Tensor, S0: torch.Tensor, t_got: float,
                   k_got: int, steps: int, tol: float) -> torch.Tensor:
    """The gathered sharded state after ``steps`` against the single-rank
    path's: each channel's relative L2 within ``tol`` (SHARDED_REL_L2), and
    JAX's sharded-vs-single budget printed beside it; returns the latter."""
    single, t1, k1 = single_rank(text, steps)
    diff = (got - single).double()
    rel = [float(diff[c].norm() / single[c].double().norm()) for c in range(single.shape[0])]
    vs_change = [float(diff[c].norm() / (single[c] - S0[c]).double().norm())
                 for c in range(single.shape[0])]
    excess = float((diff.abs() - (SHARDED_ATOL + SHARDED_RTOL * single.abs())).max())
    print(f"[{label}] {steps} steps, 4 ranks against the single-rank MRI path: t {t_got!r} vs "
          f"{t1!r}; relative L2 per channel {[f'{x:.3e}' for x in rel]} (<= {tol:.0e}); "
          f"against each channel's change from the initial state "
          f"{[f'{x:.3e}' for x in vs_change]}; max |diff| {float(diff.abs().max()):.3e}, max "
          f"excess over JAX's rtol {SHARDED_RTOL} / atol {SHARDED_ATOL}: {excess:.3e}")
    if not (max(rel) <= tol and k1 == k_got == steps and abs(t1 - t_got) <= 1e-6 * t1):
        raise AssertionError(f"{label}: the sharded MRI disagrees with the single-rank path")
    torch.cuda.empty_cache()
    return single


def params_from_text(text: str):
    from ramsesgpu_tpu_torch.config.configmap import ConfigMap
    from ramsesgpu_tpu_torch.config.params import params_from_config

    return params_from_config(ConfigMap(text=text))


def cli_rank_checked(argv: list, workdir: str) -> dict:
    """One rank of phase 38 (a spawned process): the CLI's main(argv) in
    ``workdir``, as the CLI's own spawned ranks run it, with the
    DistributedRun it builds kept for the gates: launch counts, steps, t,
    and on rank 0 the gathered state and the initial one."""
    import os

    from ramsesgpu_tpu_torch.cli.main import main
    from ramsesgpu_tpu_torch.parallel.sharded_step import launch_counts
    from ramsesgpu_tpu_torch.problems import init_problem
    from ramsesgpu_tpu_torch.solvers.run_distributed import DistributedRun

    os.chdir(workdir)
    runs = []
    start = DistributedRun.start

    def kept_start(self, *args, **kw):
        runs.append(self)
        return start(self, *args, **kw)

    DistributedRun.start = kept_start
    before = launch_counts()
    rc = main(argv)
    counts = {name: n - before[name] for name, n in launch_counts().items()}
    run = runs[0]
    out = {"rank": run.grid.rank, "rc": rc, "counts": counts, "n_step": run.n_step,
           "t": run.t, "backend": run.grid.describe(), "device": str(run.device)}
    S = run.interior()
    if S is not None:
        g = run.params.ghost_width
        out.update(U=S, U0=init_problem(run.params, run.config)[:, g:-g, g:-g, g:-g])
    return out


def phase38(card: str) -> None:
    """Both shipped MRI [mpi] inputs as shipped through the CLI's main() on
    four spawned ranks, at most 50 steps each."""
    import importlib.util
    import tempfile

    from ramsesgpu_tpu_torch.parallel.launch import spawn_ranks
    from ramsesgpu_tpu_torch.solvers.stratified import uses_stratified_z

    for ini in (DEBUG_INI, STRAT_MPI_INI):
        label = f"38 {Path(ini).name}"
        params = params_from_text(Path(ini).read_text())
        steps = min(50, params.n_stepmax)
        argv = ["--param", str(Path(ini).resolve()), "--max-steps", str(steps)]
        if importlib.util.find_spec("h5py") is None and "outputHdf5=yes" in Path(ini).read_text():
            print(f"[{label}] h5py is not installed here: its HDF5 snapshots are skipped "
                  f"(--no-output)")
            argv.append("--no-output")
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory(prefix="smoke38_") as workdir:
            ranks = spawn_ranks(cli_rank_checked, 4, (argv, workdir))
            written = sorted(p.name for p in Path(workdir).iterdir())
        r0 = ranks[0]
        print(f"[{label}] {params.nx}x{params.ny}x{params.nz} {params.dtype} as shipped on "
              f"{card}: {r0['backend']}, {r0['n_step']} steps, t={r0['t']!r}, files {written}")
        if any(r["rc"] != 0 or r["n_step"] != steps for r in ranks):
            raise AssertionError(f"{label}: {[(r['rc'], r['n_step']) for r in ranks]}")
        check_rank_counts(label, ranks, steps)
        got, S0 = torch.from_numpy(r0["U"]), torch.from_numpy(r0["U0"])
        single = compare_single(label, Path(ini).read_text(), got, S0, r0["t"], r0["n_step"],
                                steps, SHARDED_REL_L2["38"])
        print(f"[{label}] " + sharded_gates(label, params, got, S0,
                                            single if uses_stratified_z(params) else None))


def profile_chunk(label: str, card: str, advance, S: torch.Tensor, t: torch.Tensor,
                  chunk: int) -> None:
    """Device time by kernel over one more chunk of a main path, and the
    device's idle share of the chunk's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        S, t, k = advance(S, t, chunk)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    if int(k) != chunk:
        raise AssertionError(f"profiled chunk stopped early: {int(k)}")
    rows = [(e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(r[0] for r in rows)
    if not rows:
        raise AssertionError("the profiler saw no device time")
    grid = S[0] if isinstance(S, tuple) else S
    size = "x".join(str(d) for d in reversed(grid.shape[1:]))
    print(f"[{label}] one {chunk}-step chunk at {size} f32 on {card}: "
          f"wall {wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms, "
          f"idle share {1 - busy / wall_us:.4f}")
    for us, count, key in sorted(rows, reverse=True):
        print(f"[{label}] {us / 1e3:9.3f} ms {100 * us / busy:5.1f} % {count:4d}x  {key[:110]}")
    return {key: (us, count) for us, count, key in rows}


# the step kernels that kernel=zcarry replaces, as the profiler names them:
# the staged MHD step's stages and the hydro step kernel
STAGED_STEP_KERNELS = ("mhd::PrimStage", "mhd::PrecursorStage", "mhd::FluxEmfStage",
                       "mhd::UpdateStage", "hydro::hydro_step_kernel")


# the rows of the step, dissipation and MHD CFL kernels (PERF.md section
# 6) and their names here: each kernel's time beside its bound
ROWS = (("A", "mhd_step"), ("A'-compensated", "mhd_step_comp"),
        ("A'-shear-main", "mhd_step_shear"), ("A'-stratified", "mhd_step_strat"),
        ("3", "mhd_step_ghosted"), ("4", "mhd_window"), ("12", "zcarry_mhd"),
        ("12 shear", "zcarry_mhd_shear"), ("A'-hydro / 6", "hydro_step"),
        ("5", "hydro_step_ghosted"), ("13", "zcarry_hydro"),
        ("A'-dissipation / 8", "dissip_step"), ("A'-shear-dissipation / 10", "dissip_step_shear"),
        ("A'-compensated dissipation", "dissip_step_comp"), ("B", "cfl_mhd"),
        ("11", "cfl_mhd_shear"), ("CFL of 3", "cfl_mhd_ghosted"), ("CFL of 4", "cfl_mhd_window"))


def check_streamed(label: str, kernel: str, rows: dict) -> None:
    """With kernel=zcarry the profiled chunk ran the streamed step kernel,
    one launch per step, and no stage of a staged step kernel."""
    if kernel != "zcarry":
        return
    streamed = {k: c for k, (_us, c) in rows.items() if "zcarry" in k}
    staged = [k for k in rows if any(s in k for s in STAGED_STEP_KERNELS)]
    print(f"[{label}] streamed step launches in the profiled chunk: "
          f"{sum(streamed.values())} ({len(streamed)} kernel(s)); staged stages: {len(staged)}")
    if not streamed or staged:
        raise AssertionError(f"{label}: the profiled chunk ran {sorted(streamed)} and staged "
                             f"stages {staged[:3]}")


def main() -> int:
    start = time.perf_counter()

    def lap(phase: str) -> None:
        print(f"[time] phase {phase} done at {time.perf_counter() - start:.1f} s", flush=True)

    card = phase1()
    lap("1")
    phase2()
    lap("2")
    phase3()
    lap("3")
    twin_peak = phase4()
    lap("4")
    launches, _ot = phase5(card)
    lap("5")
    del _ot
    timing = phase6(card, twin_peak)
    lap("6")
    phase7()
    lap("7")
    hydro_twin_peak = phase8()
    lap("8")
    hydro_launches, implode = phase9(card)
    lap("9")
    hydro_timing = phase10(card, implode, hydro_twin_peak)
    lap("10")
    del implode
    bounds = phase11(timing, hydro_timing)
    lap("11")
    phase12()
    lap("12")
    shear_launches, mri = phase13(card)
    lap("13")
    shear_timing = phase14(card, mri)
    lap("14")
    del mri
    bounds.update(phase15(shear_timing))
    lap("15")
    phase16()
    lap("16")
    dissip_launches, ot_dissip = phase5(card, "17", *DISSIP_COEFFS["nu=2e-3 eta=1e-3"])
    lap("17")
    mri_dissip_launches, mri_dissip = phase13(card, "18", *DISSIP_COEFFS["nu=4e-5 eta=1e-5"])
    lap("18")
    dissip_timing = phase19(card, ot_dissip, mri_dissip)
    lap("19")
    del ot_dissip, mri_dissip
    bounds.update(dissip_timing["bounds"])
    phase20()
    lap("20")
    phase21()
    lap("21")
    comp_launches, ot_comp = phase5(card, "22", compensated=True)
    lap("22")
    comp_d_launches, ot_comp_d = phase5(card, "22d", *DISSIP_COEFFS["nu=2e-3 eta=1e-3"],
                                        compensated=True)
    lap("22d")
    flagship_launches, mri_comp = phase13(card, "23", compensated=None)
    lap("23")
    strat_launches, strat = phase13(card, "24", compensated=None, ini=STRAT_INI)
    lap("24")
    phase24m(card, strat)
    lap("24m")
    new_timing = phase25(card, ot_comp, ot_comp_d, mri_comp, strat)
    lap("25")
    del ot_comp, ot_comp_d, mri_comp, strat
    bounds.update(new_timing["bounds"])
    phase26(card)
    lap("26")
    phase27()
    lap("27")
    zc_hydro_launches, blast = phase9(card, ("blast",), "zcarry", "28")
    lap("28")
    zc_launches, ot_zc = phase5(card, "29", kernel="zcarry")
    lap("29")
    _l, ot_zc_comp = phase5(card, "29c", compensated=True, kernel="zcarry")
    lap("29c")
    zc_shear_launches, mri_zc = phase13(card, "30", kernel="zcarry")
    lap("30")
    phase13(card, "30c", compensated=None, kernel="zcarry")
    lap("30c")
    phase13(card, "30v", *DISSIP_COEFFS["nu=4e-5 eta=1e-5"], kernel="zcarry")
    lap("30v")
    _l, strat_zc = phase13(card, "30s", compensated=None, ini=STRAT_INI, kernel="zcarry")
    lap("30s")
    staged = {**timing["ms"], **hydro_timing["ms"], **shear_timing["ms"], **new_timing["ms"]}
    zc_timing = phase32(card, ot_zc, blast, mri_zc, bounds, timing["n_twin"], staged, ot_zc_comp,
                        strat_zc)
    lap("32")
    del ot_zc, blast, mri_zc, ot_zc_comp, strat_zc
    bounds.update(zc_timing["bounds"])
    phase31(card)
    lap("31")
    phase33()
    lap("33")
    wall_timing = phase34(card, timing["n_twin"])
    lap("34")
    bounds.update(wall_timing["bounds"])
    phase35(card)
    lap("35")
    row4 = phase36(card)
    lap("36")
    sharded = phase37(card, row4)
    lap("37")
    phase38(card)
    lap("38")
    if "jax" in sys.modules or any(m.startswith("ramsesgpu_tpu.") for m in sys.modules):
        raise AssertionError("the port imported jax or the JAX package")

    launches = {**{k: launches[k] for k in ("mhd_step", "cfl_mhd")},
                **{k: hydro_launches[k] for k in ("hydro_step", "cfl_hydro")},
                "mhd_step_shear": shear_launches["mhd_step"],
                "cfl_mhd_shear": shear_launches["cfl_mhd"],
                **{k: shear_launches[k] for k in ("shear_slabs", "shear_border")},
                "dissip_step": dissip_launches["dissip_step"],
                "dissip_step_shear": mri_dissip_launches["dissip_step"],
                "mhd_step_comp": comp_launches["mhd_step"],
                "dissip_step_comp": comp_d_launches["dissip_step"],
                "mhd_step_shear_comp": flagship_launches["mhd_step"],
                "shear_border_comp": flagship_launches["shear_border"],
                "mhd_step_strat": strat_launches["mhd_step"],
                "shear_zslabs": strat_launches["shear_zslabs"],
                "zcarry_mhd": zc_launches["zcarry_mhd"],
                "zcarry_hydro": zc_hydro_launches["zcarry_hydro"],
                "zcarry_mhd_shear": zc_shear_launches["zcarry_mhd"],
                **wall_timing["launches"], **sharded["launches"]}
    bounds.update(row4["bounds"])
    measured = {key: {**timing[key], **hydro_timing[key], **shear_timing[key],
                      **dissip_timing[key], **new_timing[key], **zc_timing[key],
                      **wall_timing[key], **row4[key]}
                for key in ("ms", "plain_ms", "max_abs_err")}
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": measured["max_abs_err"][name],
         "ms": measured["ms"][name], "plain_ms": measured["plain_ms"][name],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1], "library_ms": None}
        for name, (src, rep) in KERNELS.items()
    ]
    for row, name in ROWS:
        ms, (bound_ms, by) = measured["ms"][name], bounds[name]
        print(f"[rows] {row} ({name}): {ms:.4f} ms, bound {bound_ms:.4f} ms ({by}), "
              f"{ms / bound_ms:.1f}x ({card})")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
