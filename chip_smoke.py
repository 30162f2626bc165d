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
     f64, on both state layouts, bitwise; the isothermal EOS; the jet's
     floor taken in the kernel; NaN propagation;
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
     its twin, each of its outputs on its own (as 12; the slab and border
     kernels bitwise), and its time against the twin's (CUDA events; the
     slab and border kernels' device time by torch.profiler beside it:
     they run for less time than their launch takes on the host, and the
     kernels line gives it as device_ms); the step kernel's stages in
     the shear mode beside the periodic mode's on the Orszag-Tang state of
     the same shape;
 15. the shear kernels' bounds (as 11, counted on an 8x32x128 block), each
     beside its time;
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
 24. the stratified MRI as shipped at 128x256x128 f32 (four kernels per
     step: one slab launch builds the x and the z slabs), and (24m) its
     mass change against its z-face outflow;
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
 39. the isothermal instances (cIso > 0) of rows A (plain, compensated), B,
     3 and 12 against their twins on an isothermal turbulence state at
     64^3 (data/turbulence_mhd_ou.ini's physics, a Mach 1 flow, a
     divergence-free field), f32 + f64: the CFL (periodic, ghosted; the
     adiabatic instance reads another pressure there), one step streamed
     and staged, the folded inverse dt against the CFL kernel, an inactive
     step, 10 chained loop steps (kernel=auto and zcarry) against the twins'
     loop, the dissipation kernel's isothermal periodic mode, the ghosted
     step;
 40. both forcings (ops/forcing.py) on the card against their CPU results
     on the same tensors and draws (3 kicks at 64^3, f32 + f64), and 10
     steps of the forced loops (static and OU MHD, OU hydro) against the
     twins' forced loop with the same draws;
 41. the forced paths at 256^3 f32 through make_forced_chain: the physics
     of data/turbulence_mhd.ini (41a; 41z with kernel=zcarry),
     turbulence_mhd_ou.ini (41b), turbulence_hydro.ini (41h) and
     turbulence_hydro_ou.ini (41o): 2 warm-up + 3 timed chunks of 10 steps,
     ms/step, cells/s, launches per step (one CFL launch a step, kernel=zcarry
     too), peak memory; finite, rho > 0, mass within 1e-5, MHD max|divB|,
     the static kick's kinetic energy = n_cells dt edot within 1e-4; a
     profiled chunk's idle share and the forcing's share of device time;
     41c: phase 5's workload isothermal (cIso = 1) and compensated; 41w:
     phase 34's walled path isothermal (cIso = 1, rows 3 and its CFL); 41k:
     the isothermal instances of rows A, B, 12 and A' at 256^3 against their
     twins, their times and bounds;
 42. the four turbulence inputs as shipped through the CLI's main(), at
     most 50 steps each (no HDF5 snapshots where h5py is not installed):
     launches, and turbulence_mhd_ou.ini's history file (written, parsed,
     its mass column constant to 1e-5);
 43. the 19 single-device 2D inputs without gravity as shipped through the
     CLI's main() on the card, at most 10 steps each (the 2D path is
     whole-array PyTorch: the JAX package has no 2D kernel, so no kernel
     launches and no twin runs): finite, rho > 0 (hydro: p > 0), mass on
     periodic faces within 1e-5, MHD max|divB| < 1e-3 max|Bx| / dx;
 44. the two timed 2D cells, f32: Orszag-Tang at 2048^2 and
     data/kelvin_helmholtz_gpu_2d_large.ini as shipped (1200^2), 2 warm-up
     and 3 timed chunks of 10 steps: ms/step, cells/s, peak memory, and a
     profiled chunk's launches a step and idle share;
 45. the 2D path on the card against the CPU (OT and the Sod tube at 64^2,
     f64, 10 steps): relative L2 <= 1e-12, no host sync in the chunk;
 46. the new kernel instances and mode against their twins at 64^3 and
     50x50x72, f32 + f64, 1 step and 10 loop steps: hydro_step.cu's gravity
     instance (interior mode with walls, ghosted mode), mhd_step.cu's
     ghosted gravity instance, dissip_step.cu's ghosted mode (walled
     Brio-Wu with nu, eta);
 47. the six single-device gravity inputs as shipped through the CLI's
     main() on the card (at most 10 steps; gates, kernel launches a step);
     make_step_fn of the 3D hydro Rayleigh-Taylor (the ghosted gravity
     mode), counted; the four 2D ones in f64 at their shipped mesh, card
     against CPU within 1e-12;
 48. three timed cells at 256^3 f32 (2 warm-up + 3 timed chunks of 10
     steps, peak memory, a profiled chunk's idle share and launches): the
     3D hydro and MHD Rayleigh-Taylor physics, and the walled Brio-Wu with
     nu and eta; the new instances and mode against their twins, their
     times and bounds;
 49. the sharded periodic, walled and jet runs (parallel/sharded_step.py,
     JAX make_local_step): the nine [mpi] inputs the slice runs, as shipped
     through the CLI's main() on their spawned ranks (a world of 4 ranks and
     one of 8 sharing the card over gloo), at most 20 steps each (no
     snapshots where an input writes HDF5 and h5py is not installed):
     per-rank launches (in 3D one ghosted step and one ghosted CFL a step,
     no other mode; in 2D none), finite, rho > 0, MHD divB, each gathered
     state against the single-rank path within SHARDED_REL_L2["49"], the
     VTK pieces reassembled bitwise; three timed cells (49h the 3D implode
     at 256^3 on 2x2x1, 49m the 3D MHD jet at 128x128x256 on 2x2x2, 49o 2D
     Orszag-Tang at 2048^2 on 2x2): 2 warm-up + 3 timed chunks of 10 steps
     (slowest rank), 10 profiled steps (StepProfile sections, CUDA events,
     the share of a step outside the kernels) held against the single-rank
     path, whose ms/step at the same mesh is printed beside;
 50. the sharded dissipation and forcing: dissip_step.cu's ghosted mode as
     a rank runs it (the interior alone written back) on rank-size blocks
     (64x64x128 and 15x15x30, walled and shearing-box, f32 + f64) against
     its twin, every ghost unchanged; in one world of 4 ranks sharing the
     card, both turbulence [mpi] inputs as shipped through the CLI's main()
     (per-rank launches, finite, rho > 0, mass within MASS_TOL, MHD divB,
     the gathered state against the single-rank path within
     SHARDED_REL_L2["49"]), 10 OU MHD steps at 64^3 on 2x2x1 against the
     single-rank path (the same draws), and two timed cells as in 49: 50f
     turbulence_mhd_mpi.ini's physics (static forcing) at 256^3, 50d the
     walled Brio-Wu with nu and eta at 256^3, both on 2x2x1 (StepProfile
     sections dissip and force), each beside its single-rank ms/step; 50d's
     one resistive step held against the single-rank path outside the
     internal block faces' band (resistive_step);
 51. the MHD solvers other than HLLD and the stratified box with nu, eta:
     the step kernels' general instances against their twins (rows A and
     12 on Orszag-Tang 32^3 for (hll, hlla), (llf, llf) and (hlld, hllf);
     row 3 on data/testRiemannHLLD.ini's walls with (hll, llf); row 4 on a
     two-rank window block, ideal and stratified; f32 + f64) and the
     dissipation kernel's stratified shear mode (plain and, bitwise,
     compensated); Orszag-Tang 256^3 f32 for each pair with kernel=auto and
     kernel=zcarry (2 warm-up + 3 timed chunks of 10 steps, launches
     counted, phase 5's gates), each instance's time, twin time and bound;
     the stratified MRI with nu 4e-7 and eta 1e-7 as shipped at
     128x256x128 f32 (phase 13's gates; 51s), the dissipation kernel's
     stratified mode there against its twin (bitwise), its time and bound;
     2D Orszag-Tang with (hll, hlla) on the card against the CPU (64^2 f64,
     10 steps, relative L2 1e-12);
 52. checkpoint / restart and the numerics guard: (52a) OT 256^3 f32 at
     the bench.py INI (kernel=auto and zcarry), the MRI at 128x256x128
     (compensated=no) and data/turbulence_mhd_ou.ini as shipped, each run
     2 N52 steps writing NetCDF checkpoints (ghostIncluded) at N52 and
     2 N52, then a fresh Run restarted from the step-N52 file for N52
     steps: its interior, t and step bitwise the step-2 N52 file's; the
     MRI as shipped (compensated) within COMP_RESUME_L2 (the carry a
     checkpoint does not hold); the 256^3 checkpoint's bytes, write and
     read ms; (52b) data/implode3d_debug.ini as shipped through the CLI
     (the guard after each chunk, launches counted), a NaN and a negative
     density planted in the 256^3 OT state, check_finite's text on the
     card equal to the CPU's, one check_finite's ms; (52c)
     data/mhd_mri_3d_stratified_restart.ini as shipped on 4 ranks sharing
     the card, from the checkpoint the port's sharded run of
     mhd_mri_3d_stratified_mpi.ini wrote, capped at 2 N52: bitwise the
     straight run's step-2 N52 file; the first restarted step's ms;
 53. the other schemes, the analysis tools, the profiler and the planner
     (whole-array PyTorch on the card: the JAX package has no kernel for
     them, so no kernel launches here): (53a) each alternative scheme
     (godunov-split, kurganov, laxliu, relaxingTVD; solvers/run2d_alt.py
     AltSchemeRun) card vs CPU at 128^2 f64 (10 steps, 1e-12), then timed
     in f32, the four on data/hydro_sod2d.ini at 1024^2 and godunov-split
     and relaxing TVD on data/implode3d.ini at 256^3 (ms/step, cells/s,
     peak memory; finite, rho, p > 0, mass); (53b) the structure
     functions' on-line hook through Run.output on data/turbulence_mhd.ini
     at 256^3 f32 as shipped (1000 samples, max_q 6) after 10 forced
     steps, timed, its counts, zero-distance bin and finite values, and the
     function at 32^3 f64 card vs CPU; (53c) the sharded structure
     functions of data/turbulence_mhd_mpi.ini on its 4 ranks against one
     device; (53d) the power spectrum at 256^3 card vs CPU, timed, and the
     fBm slope at 512^2; (53e) --profile of the bench.py workload at 256^3
     and of data/orszag-tang_mpi.ini on 4 ranks, the memory planner
     against max_memory_allocated (OT 256^3 auto and kernel=zcarry within
     10 %, 512^3 kernel=zcarry against phase 31's peak); (53f) the live
     view's frames where matplotlib imports; (53g) compensated=yes on
     data/implode3d.ini at 256^3 and data/implode2d.ini bitwise the plain
     runs;
 then the MHD step kernel's rows (A, A', 3, 4, 12, and the isothermal
 instances) with their times and bounds, the kernels JSON line, the card
 line, and the result line.
Imports nothing of JAX; of this repo it imports only ramsesgpu_tpu_torch.
"""
from __future__ import annotations

import contextlib
import ctypes
import json
import math
import re
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
    "shear_slabs_strat": ("ramsesgpu_tpu_torch/csrc/shear_border.cu",
                          "ramsesgpu_tpu/pallas/shear_packed.py:237 (the strip's sheared ghosts "
                          "and their stratified z extension, built by :952-1004 and :963-975: "
                          "the slab kernel's stratified launch) and the z band refill "
                          ":1006-1021"),
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
    # static gravity and the walled dissipation (phases 46-48)
    "hydro_step_grav": ("ramsesgpu_tpu_torch/csrc/hydro_step.cu",
                        "ramsesgpu_tpu/pallas/packed_bc.py:126 (make_packed_bc_step, pallas_call "
                        "at :371; with a uniform static gravity, which the JAX package runs on "
                        "its whole-array step, solvers/godunov.py:115-160)"),
    "hydro_step_ghosted_grav": ("ramsesgpu_tpu_torch/csrc/hydro_step.cu",
                                "ramsesgpu_tpu/pallas/fused_hydro3d.py:46 (make_fused_hydro_update,"
                                " pallas_call at :131; with a uniform static gravity)"),
    "mhd_step_ghosted_grav": ("ramsesgpu_tpu_torch/csrc/mhd_step.cu",
                              "ramsesgpu_tpu/pallas/fused_mhd3d.py:80 (make_fused_mhd_update, "
                              "pallas_call at :173; with a uniform static gravity, "
                              "solvers/godunov_mhd.py:613-618, 745-746)"),
    "dissip_step_ghosted": ("ramsesgpu_tpu_torch/csrc/dissip_step.cu",
                            "ramsesgpu_tpu/pallas/fused_dissip3d.py:51 (make_fused_mhd_dissipation,"
                            " pallas_call at :135, on the refilled ghosted array of the walled "
                            "step, pallas/fused_mhd3d.py:545-547)"),
    # the isothermal instances (cIso > 0: the turbulence inputs, phases 39-42)
    "mhd_step_iso": ("ramsesgpu_tpu_torch/csrc/mhd_step.cu",
                     "ramsesgpu_tpu/pallas/packed_io.py:423 (make_packed_io_step, MHD body "
                     "fused_mhd3d.py:228, cIso > 0)"),
    "cfl_mhd_iso": ("ramsesgpu_tpu_torch/csrc/cfl_mhd.cu",
                    "ramsesgpu_tpu/pallas/packed_io.py:125 (make_packed_cfl_mhd, the isothermal "
                    "pressure of solvers/timestep.py:117-118)"),
    "zcarry_mhd_iso": ("ramsesgpu_tpu_torch/csrc/zcarry_mhd.cu",
                       "ramsesgpu_tpu/pallas/zcarry_mhd3d.py:670 (make_zcarry_mhd_packed_io, "
                       "cIso > 0)"),
    "mhd_step_comp_iso": ("ramsesgpu_tpu_torch/csrc/mhd_step.cu",
                          "ramsesgpu_tpu/pallas/fused_mhd3d.py:247 (the packed-io step on 2*nvar "
                          "channels, cIso > 0)"),
    "mhd_step_ghosted_iso": ("ramsesgpu_tpu_torch/csrc/mhd_step.cu",
                             "ramsesgpu_tpu/pallas/fused_mhd3d.py:173 (make_fused_mhd_update, "
                             "cIso > 0)"),
    "cfl_mhd_ghosted_iso": ("ramsesgpu_tpu_torch/csrc/cfl_mhd.cu",
                            "ramsesgpu_tpu/pallas/packed_io.py:125 (its isothermal reduction on "
                            "the ghosted state)"),
    # the general instances (any face and corner solver; phase 51), and the
    # dissipation kernel's stratified shear mode
    **{f"mhd_step_{face}_{corner}": (
        "ramsesgpu_tpu_torch/csrc/mhd_step_general.cu",
        f"ramsesgpu_tpu/pallas/packed_io.py:148 (MHD body fused_mhd3d.py:228 -> "
        f"godunov_mhd.py:226 mhd_fluxes_emfs_from_parts with riemannSolver={face}, "
        f"magRiemannSolver={corner})")
       for face, corner in (("hll", "hlla"), ("llf", "llf"), ("hlld", "hllf"))},
    **{f"zcarry_mhd_{face}_{corner}": (
        "ramsesgpu_tpu_torch/csrc/zcarry_mhd_general.cu",
        f"ramsesgpu_tpu/pallas/zcarry_mhd3d.py:102 (its body zcarry_mhd3d.py:394 -> "
        f"godunov_mhd.py:226 with riemannSolver={face}, magRiemannSolver={corner})")
       for face, corner in (("hll", "hlla"), ("llf", "llf"), ("hlld", "hllf"))},
    "dissip_step_strat": ("ramsesgpu_tpu_torch/csrc/dissip_step.cu",
                          "ramsesgpu_tpu/pallas/shear_packed.py:917 (the MRI loop's dissipative "
                          "launch with gravity_z, :868-917)"),
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
# the stratified MRI's timed cell with nu and eta (phase 51s; see there)
STRAT_DISSIP_COEFFS = (4e-7, 1e-7)
# the shipped MRI inputs: the flagship and the stratified box, both
# Kahan-compensated as shipped ([implementation] compensated=yes)
MRI_INI = "data/mhd_mri_3d.ini"
STRAT_INI = "data/mhd_mri_3d_stratified.ini"
# the card's peaks (NVIDIA's H100 SXM data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
F64_FLOP_PER_S = 34e12


def ghosted_reads(kind: str, dims, visc: bool = False, resist: bool = False,
                  iso: bool = False) -> int:
    """The values a step function on a ghosted state must read: for each
    channel, the cells its written values depend on (the interior; B on the
    CT face layer too for the MHD step and, with eta, the dissipation), not
    the whole ghost frame. The counts are the support of the plain twin's
    gradient (tests/test_torch_gravity.py
    test_ghosted_reads_are_the_twins_support):
    - "hydro" (g = 2): the interior, two layers past each face and the
      diagonal layer along each edge, in each of the 5 channels;
    - "mhd" (g = 3): prod(n + 5) - 6 sum(n) - 75 cells in each of the 8
      channels (the one more layer of B normal to its face not counted);
    - "window" (g = 3, row 4's shear window: the interior and the x face
      planes, no face layer): prod(n + 4) - 6 sum(n) - 57 cells, likewise;
    - "dissip": with nu, rho prod(n + 2) - 8 and momentum d that less
      4 n_d; with eta, B_d (n_d + 2) prod_{e != d}(n_e + 3) - 4 n_d -
      sum_{e != d} n_e - 10; the energy on the interior unless isothermal."""
    nx, ny, nz = dims
    cells, sides = nx * ny * nz, nx + ny + nz
    if kind == "hydro":
        return 5 * (cells + 4 * (nx * ny + ny * nz + nz * nx) + 4 * sides)
    if kind == "mhd":
        return 8 * ((nx + 5) * (ny + 5) * (nz + 5) - 6 * sides - 75)
    if kind == "window":
        return 8 * ((nx + 4) * (ny + 4) * (nz + 4) - 6 * sides - 57)
    box = (nx + 2) * (ny + 2) * (nz + 2) - 8
    values = visc * (4 * box - 4 * sides) + (not iso) * cells
    if resist:
        frame = (nx + 3) * (ny + 3) * (nz + 3)
        values += sum(frame // (n + 3) * (n + 2) - 3 * n - sides - 10 for n in dims)
    return values


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


def device_ms(fn, reps: int = 10) -> float:
    """Device ms per call of fn: the summed time of the CUDA kernels it
    launches (torch.profiler), free of the host's launch overhead, which
    exceeds the run time of the smallest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _attempt in range(3):  # (a profile now and then comes back empty)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA)
        if total > 0:
            return total / reps / 1e3
    raise AssertionError("torch.profiler recorded no device time in three profiles")


def device_parts(fn, key: str, reps: int = 10):
    """Device ms per call of fn, which launches one kernel whose name holds
    ``key``: that kernel's, and that of the other kernels it launches, per
    call the profile recorded (torch.profiler drops some calls' events, so
    the count of the key kernel's launches is the calls' count), and that
    count; None when three profiles recorded no such launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        calls = sum(n for k, _us, n in rows if key in k)
        if calls:
            mine = sum(us for k, us, _n in rows if key in k)
            others = sum(us for k, us, _n in rows if key not in k)
            return mine / calls / 1e3, others / calls / 1e3, calls
    return None


def wrappers():
    from ramsesgpu_tpu_torch.kernels.cfl_hydro import cfl_hydro
    from ramsesgpu_tpu_torch.kernels.cfl_mhd import cfl_mhd, cfl_mhd_window
    from ramsesgpu_tpu_torch.kernels.dissip_step import dissip_step
    from ramsesgpu_tpu_torch.kernels.hydro_step import hydro_step
    from ramsesgpu_tpu_torch.kernels.mhd_step import mhd_step, mhd_window
    from ramsesgpu_tpu_torch.kernels.shear_border import shear_border, shear_slabs
    from ramsesgpu_tpu_torch.kernels.zcarry_hydro3d import zcarry_hydro
    from ramsesgpu_tpu_torch.kernels.zcarry_mhd3d import zcarry_mhd

    return {"mhd_step": mhd_step, "cfl_mhd": cfl_mhd, "hydro_step": hydro_step,
            "cfl_hydro": cfl_hydro, "shear_slabs": shear_slabs, "shear_border": shear_border,
            "dissip_step": dissip_step,
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
             (dissip_step, "mhd_dissipation_ghosted_update"),
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
           compensated: bool = False, kernel: str = "auto", c_iso: float = 0.0):
    """The periodic MHD main path, ideal or (phase 17) with viscosity nu and
    resistivity eta, plain or (phases 22, 22d) with the Kahan-compensated
    state, on the staged step kernel or (kernel=zcarry, phases 29, 29c)
    the streamed one, adiabatic or (phase 41c) isothermal with c_iso;
    returns its launch counts and (params, S, t) at its end."""
    from ramsesgpu_tpu_torch.kernels.cfl_mhd import cfl_mhd
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries_concat
    from ramsesgpu_tpu_torch.solvers.step import make_packed_advance_chain
    from ramsesgpu_tpu_torch.solvers.timestep import dt_from_inv

    n, chunk = 256, 10
    params, S_init = setup(n, "float32")
    dt_first = float(dt_from_inv(params, cfl_mhd(params, S_init)))
    params = params.replace(nu=nu, eta=eta, compensated=compensated, kernel=kernel, c_iso=c_iso)
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
    from ramsesgpu_tpu_torch.kernels.build import load_library, param_block
    from ramsesgpu_tpu_torch.kernels.cfl_hydro import cfl_hydro
    from ramsesgpu_tpu_torch.kernels.cfl_rows import workspace
    from ramsesgpu_tpu_torch.solvers.boundary import interior, make_boundaries
    from ramsesgpu_tpu_torch.solvers.timestep import compute_inv_dt_hydro

    lib = load_library("cuda")

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
            same = torch.equal(got, want)
            print(f"[7] cfl_hydro {dtype} cIso={ciso} 64^3 {layout}: kernel {float(got)!r} "
                  f"twin {float(want)!r}: bitwise equal {same}")
            if not same:
                raise AssertionError(f"cfl_hydro {dtype} {layout} is not its twin bit for bit")
        # the jet's floor, taken in the kernel: above the max, the result
        fn = getattr(lib, f"ramses_cfl_hydro_{'f32' if dtype == 'float32' else 'f64'}")
        for floor in (0.5 * float(want), 2.0 * float(want)):
            got = torch.empty((), dtype=S.dtype, device="cuda")
            err = fn(S.data_ptr(), *workspace(lib, S), got.data_ptr(), params.nx, params.ny,
                     params.nz, 0, floor, param_block(params),
                     torch.cuda.current_stream().cuda_stream)
            if err or not torch.equal(got, torch.maximum(want, want.new_full((), floor))):
                raise AssertionError(f"cfl_hydro's floor {floor!r}: {float(got)!r} (error {err})")
        print(f"[7] cfl_hydro {dtype} cIso={ciso}: a floor below and above the max taken in the "
              f"kernel, bitwise")
        S[2, 7, 9, 11] = float("nan")  # a momentum: read by the isothermal chain too
        U[2, 9, 11, 13] = float("nan")
        if not (torch.isnan(cfl_hydro(params, S))
                and torch.isnan(cfl_hydro(params, U, ghost=params.ghost_width))):
            raise AssertionError("cfl_hydro does not propagate NaN")
    print("[7] cfl_hydro propagates NaN in both layouts")


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
    S64 = S0.double()
    if not torch.equal(cfl_hydro(params, S64), compute_inv_dt_hydro(params, S64, ghost=0)):
        raise AssertionError("cfl_hydro at 256^3 f64 is not its twin bit for bit")
    cfl_f64_ms = time_ms(lambda: cfl_hydro(params, S64), 50)
    print(f"[10] cfl_hydro at 256^3 bitwise its twin in f32 and f64: {ms['cfl_hydro']:.4f} ms "
          f"f32, {cfl_f64_ms:.4f} ms f64 ({card})")
    del S64
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
                ("ghosted", lambda: hydro_step.ghosted(params, U, dt_m),
                 size * (5 * n + ghosted_reads("hydro", (256,) * 3))),
                ("ghosted in place", lambda: hydro_step.ghosted_(params, Uw, dt_m, active, buf),
                 size * (5 * n + ghosted_reads("hydro", (256,) * 3)))):
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
    if not torch.equal(inv, inv_t):
        raise AssertionError(f"cfl_hydro at {params.nx}^3 f32 is not its twin bit for bit: "
                             f"{float(inv)!r} against {float(inv_t)!r}")
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
            "cfl_f64_ms": cfl_f64_ms,
            "params": implode[0], "dt": float(dt),
            "state": implode[1][:, :32, :32, :32].contiguous()}


def phase11(mhd: dict, hydro: dict, card: str) -> dict:
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
              "hydro_step_ghosted": 4 * (5 * n + ghosted_reads("hydro", (256,) * 3))}
    bounds = {}
    for name in nbytes:
        t_bytes = nbytes[name] / HBM_BYTES_PER_S * 1e3
        t_ops = ops[name] / F32_FLOP_PER_S * 1e3
        bounds[name] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
        print(f"[11] {name} at 256^3 f32: {nbytes[name] / 1e9:.3f} GB -> {t_bytes:.4f} ms, "
              f"{ops[name] / 1e9:.3f} GFLOP -> {t_ops:.4f} ms: bound {bounds[name][0]:.4f} ms "
              f"by {bounds[name][1]}")
    t64 = max(5 * 8 * n / HBM_BYTES_PER_S, ops["cfl_hydro"] / F64_FLOP_PER_S) * 1e3
    for dtype, ms, bnd in (("f32", hydro["ms"]["cfl_hydro"], bounds["cfl_hydro"][0]),
                           ("f64", hydro["cfl_f64_ms"], t64)):
        print(f"[11] cfl_hydro at 256^3 {dtype}: kernel {ms:.4f} ms against its bound {bnd:.4f} "
              f"ms: {ms / bnd:.2f}x ({card})")
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


def strat_slabs(params, S, kept, t, dt):
    """The x slabs and the stratified z slabs, from one launch of the slab
    kernel."""
    from ramsesgpu_tpu_torch.kernels.mhd_step import zslab_shape
    from ramsesgpu_tpu_torch.kernels.shear_border import shear_slabs

    zslabs = torch.empty(zslab_shape(params), dtype=S.dtype, device=S.device)
    return shear_slabs(params, S, kept, t, dt, zout=zslabs), zslabs


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
            check_equal(f"{tag} shear_slabs", shear_slabs(params, S, kept, t0, dt), slabs_t)
            planes = torch.zeros((5, params.nz, params.ny), dtype=S.dtype, device="cuda")
            S1 = mhd_step(params, S.clone(), dt, active, mhd_step.scratch(params, S),
                          shear=(slabs_t, planes))
            S1_t, planes_t = mhd_3d_shear_update(params, S, slabs_t, dt)
            check(f"{tag} mhd_step shear", rel_l2(S1, S1_t), tol1)
            check(f"{tag} the 5 x-face planes before the remap", rel_l2(planes, planes_t), tol1)
            S2, kept2 = S1_t.clone(), kept.clone()
            rem = shear_border(params, S2, kept2, planes_t, t0, dt, active)
            S2_t, kept2_t, rem_t = shear_border_update(params, S1_t, kept, planes_t, t0, dt)
            check_equal(f"{tag} shear_border state", S2, S2_t)
            check_equal(f"{tag} shear_border kept face", kept2, kept2_t)
            check_equal(f"{tag} shear_border remapped planes", rem, rem_t)
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
    # the border kernels run for less time than their launch takes on the
    # host: the kernels line gives their device time (torch.profiler) as
    # device_ms beside ms, CUDA events through the wrapper
    dev = {"shear_slabs": device_ms(lambda: shear_slabs(params, S, kept, t, dt, out=slabs_w)),
           "shear_border": device_ms(lambda: shear_border(params, Sw, kw, planes_w, t, dt,
                                                          active, rem_w))}
    for name, dms in dev.items():
        print(f"[14] {name}: CUDA events through the wrapper {ms[name]:.5f} ms, device time "
              f"{dms:.5f} ms (torch.profiler) (128x256x128 f32, {card})")
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
    check_equal("14 shear_slabs 128x256x128 f32", slabs, slabs_t)
    check_equal("14 shear_border state 128x256x128 f32", S2, S2_t)
    check_equal("14 shear_border kept face 128x256x128 f32", kept2, kept2_t)
    check_equal("14 shear_border remapped planes 128x256x128 f32", rem, rem_t)
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
    return {"ms": ms, "plain_ms": plain, "max_abs_err": errs, "device_ms": dev,
            "params": params, "dt": float(dt),
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


def phase15(shear: dict, card: str) -> dict:
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
    for name in ops:
        ms, dev = shear["ms"][name], shear["device_ms"].get(name)
        print(f"[15] {name}: kernel {ms:.5f} ms (CUDA events) against its bound "
              f"{bounds[name][0]:.5f} ms: {ms / bounds[name][0]:.1f}x" + (
                  "" if dev is None else
                  f"; device time {dev:.5f} ms: {dev / bounds[name][0]:.1f}x") + f" ({card})")
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
    from ramsesgpu_tpu_torch.kernels.shear_border import shear_border
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
        zslabs_t = stratified_zslabs(params, S[:8], slabs_t)
        slabs_k, zslabs_k = strat_slabs(params, S, kept, t0, dt)
        check_equal(f"{tag} shear_slabs (one launch with the z slabs)", slabs_k, slabs_t)
        check_equal(f"{tag} shear_slabs' z slabs", zslabs_k, zslabs_t)
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
    from ramsesgpu_tpu_torch.kernels.shear_border import shear_border
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
        slabs, zslabs = strat_slabs(params, S, kept, t, dt)
        mhd_step(params, S, dt, active, scratch, shear=(slabs, planes, zslabs, gz))
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
    from ramsesgpu_tpu_torch.kernels.shear_border import shear_border, shear_slabs
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
    out = {"ms": {}, "plain_ms": {}, "max_abs_err": {}, "bounds": {}, "device_ms": {}}
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
    out["device_ms"]["shear_border_comp"] = device_ms(
        lambda: shear_border(params, Sw, kw, planes_w, t, dt, active, rem_w))
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

    # the stratified step and the slab kernel's stratified launch (the x and
    # the z slabs; the stratified box as shipped)
    params, S, kept, t, config = strat
    gz = gravity_z(params, config, "cuda")
    dt = dt_from_inv(params, cfl_mhd(params, S, kept=kept))
    slabs, zslabs = strat_slabs(params, S, kept, t, dt)
    slabs_t = slabs_twin(params, S[:8], kept[0], t + dt)
    zslabs_t = stratified_zslabs(params, S[:8], slabs_t)
    check_equal(f"25 shear_slabs stratified {size} f32", slabs, slabs_t)
    check_equal(f"25 shear_slabs' z slabs {size} f32", zslabs, zslabs_t)
    out["max_abs_err"]["shear_slabs_strat"] = max(float((slabs - slabs_t).abs().max()),
                                             float((zslabs - zslabs_t).abs().max()))
    del slabs_t, zslabs_t
    scratch = mhd_step.scratch(params, S)
    S1 = mhd_step(params, S.clone(), dt, active, scratch, shear=(slabs, planes, zslabs, gz))
    check_update_stage(f"25 mhd_step_strat {size} f32", params, S, S1, scratch, dt, gz)
    S1_t, _planes_t = mhd_3d_shear_update(params, S, slabs, dt, zslabs, gz)
    check_step_comp(f"25 mhd_step_strat {size} f32", S, S1, S1_t, tol)
    out["max_abs_err"]["mhd_step_strat"] = float((S1[:8] - S1_t[:8]).abs().max())
    del S1, S1_t, _planes_t
    Sw, sw, zw = S.clone(), slabs.clone(), zslabs.clone()
    out["ms"]["mhd_step_strat"] = time_ms(
        lambda: mhd_step(params, Sw, dt, active, scratch, shear=(slabs, planes, zslabs, gz)), 10)
    out["ms"]["shear_slabs_strat"] = time_ms(
        lambda: shear_slabs(params, S, kept, t, dt, out=sw, zout=zw), 50)
    out["device_ms"]["shear_slabs_strat"] = device_ms(
        lambda: shear_slabs(params, S, kept, t, dt, out=sw, zout=zw))
    x_only_ms = device_ms(lambda: shear_slabs(params, S, kept, t, dt, out=sw))
    del Sw, sw, zw, scratch
    torch.cuda.empty_cache()
    out["plain_ms"]["mhd_step_strat"] = time_ms(
        lambda: mhd_3d_shear_update(params, S, slabs, dt, zslabs, gz), 3)
    out["plain_ms"]["shear_slabs_strat"] = time_ms(
        lambda: stratified_zslabs(params, S[:8], slabs_twin(params, S[:8], kept[0], t + dt)), 10)
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
    # the x slabs' bytes (phase 15), then per z side the two source rows'
    # six channels (of the interior and of the x slabs) it reads and the
    # three ghost rows of eight it writes
    out["bounds"]["shear_slabs_strat"] = bound(
        "25", "shear_slabs_strat (x and z slabs in one launch)",
        4 * (2 * 8 * 3 * rows + rows + 2 * 8 * 3 * rows) + 4 * 2 * (6 + 24) * ny * (nx + 6),
        (counts[0] + counts[2]) * scale, size, n)
    for name in ("mhd_step_strat", "shear_slabs_strat", "shear_border_comp"):
        ms, dev, bnd = out["ms"][name], out["device_ms"].get(name), out["bounds"][name][0]
        print(f"[25] {name}: kernel {ms:.4f} ms (CUDA events) against its bound {bnd:.5f} ms "
              f"({ms / bnd:.1f}x)" + ("" if dev is None else
                                       f", device time {dev:.5f} ms ({dev / bnd:.1f}x)")
              + f", twin {out['plain_ms'][name]:.3f} ms ({size} f32, {card})")
    print(f"[25] the slab kernel on the stratified state (device time, torch.profiler): x and z "
          f"slabs in one launch {out['device_ms']['shear_slabs_strat']:.5f} ms, the x slabs "
          f"alone {x_only_ms:.5f} ms ({card})")
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
    from ramsesgpu_tpu_torch.kernels.shear_border import shear_slabs
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
            planes = torch.zeros((5, params.nz, params.ny), dtype=S.dtype, device="cuda")
            if gz is None:
                shear = (shear_slabs(params, S, kept, t0, dt), planes)
            else:
                slabs, zslabs = strat_slabs(params, S, kept, t0, dt)
                shear = (slabs, planes, zslabs, gz)
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


def phase31(card: str) -> float:
    """One 10-step chunk of Orszag-Tang at 512^3 f32 with kernel=zcarry:
    the state built on the card, its peak memory (returned, bytes) and the
    rings' bytes, in shared memory (the staged step's stage buffer would be
    173 values per cell, ~93 GB)."""
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
    return peak


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
    from ramsesgpu_tpu_torch.kernels.shear_border import shear_slabs
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
    slabs, zslabs = strat_slabs(params, S, kept, t, dt)
    sh = (slabs, torch.zeros((5, params.nz, params.ny), dtype=S.dtype, device="cuda"), zslabs, gz)
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
        # (isothermal: the pressure is rho cIso^2)
        p_min = (rho_min * params.c_iso ** 2 if params.c_iso > 0
                 else float(mhd_pressure(params, U).min()))
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


def phase34(card: str, n_twin: int, label: str = "34", c_iso: float = 0.0) -> dict:
    """The walled MHD main path: data/testRiemannHLLD.ini's physics (3D
    Brio-Wu, six NEUMANN faces; phase 41w: isothermal, c_iso, the
    kernels' isothermal ghosted instances, named with _iso) at 256^3 f32 through
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
    params = params.replace(c_iso=c_iso)
    sfx = "_iso" if c_iso > 0 else ""
    U = ghosted_state(config, params)
    g = params.ghost_width
    pack, advance, unpack = make_packed_advance_chain(params, "cuda")
    t = torch.zeros((), dtype=torch.float32, device="cuda")
    with counted_main_path(label, {"mhd_step": steps, "cfl_mhd": steps}) as launches:
        S = pack(U)
        del U
        S, t, _dt = run_chunks(label, card, advance, S, t, n, chunk)
    peak = torch.cuda.max_memory_allocated() - base
    gates = check_walled_state(label, params, S)
    print(f"[{label}] {steps} steps at {n}^3 f32 (six NEUMANN faces) on {card}: t={float(t)!r}, "
          f"{gates}; launches per step: mhd_step {launches['mhd_step'] / steps:g}, cfl_mhd "
          f"{launches['cfl_mhd'] / steps:g}; peak allocated {peak / 1e9:.3f} GB (ghosted state "
          f"{S.numel() * 4 / 1e9:.3f} GB, stage buffer "
          f"{mhd_step.scratch_size(load_library('cuda'), params, True) * 4 / 1e9:.3f} GB)")
    if tuple(unpack(S, t).shape) != params.shape:
        raise AssertionError(f"{label}: unpacked shape")
    rows = profile_chunk(f"{label}p", card, advance, S, t, chunk)
    parts = {"step": 0.0, "cfl": 0.0, "fill": 0.0}
    for key, (us, _count) in rows.items():
        part = "step" if "mhd::" in key else "cfl" if "cfl_rows" in key else "fill"
        parts[part] += us
    busy = sum(parts.values())
    print(f"[{label}p] device time per step by part: " + ", ".join(
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
        params = params.replace(c_iso=c_iso)
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
        check(f"{label} {name} at {n_twin}^3 f32 (the path's state)", rel[name], tol[name],
              f", max abs {errs[name]:.3e}")
        print(f"[{label}] {name}: kernel {ms[name]:.3f} ms at {n}^3 (CUDA events), twin "
              f"{plain[name]:.3f} ms at {n_twin}^3 (f32, {card})")
    del W

    # bounds: the operations of the interior, counted on a 32^3 block of the
    # end state (its first 32 + 2g layers on each axis: a ghosted block)
    lib = load_library("count")
    p_blk = block_params(params, 32)
    cells = n ** 3
    ops = {"mhd_step_ghosted": lib.ramses_mhd_step_ghosted_ops(
               bound_input.data_ptr(), 32, 32, 32, g, param_block(p_blk), float(dt)) / 32 ** 3,
           "cfl_mhd_ghosted": lib.ramses_cfl_mhd_ghosted_ops(
               bound_input.data_ptr(), 32, 32, 32, g, param_block(p_blk)) / 32 ** 3}
    # the cells of the ghosted state the step reads (ghosted_reads) read
    # once, the interior and the CT face layer's three face fields written
    # once; the CFL reads the interior's 8 values
    nbytes = {"mhd_step_ghosted": 4 * (ghosted_reads("mhd", (n,) * 3) + 8 * cells
                                       + 3 * ((n + 1) ** 3 - cells)),
              "cfl_mhd_ghosted": 4 * 8 * cells}
    bounds = {name: bound(label, name, nbytes[name], ops[name] * cells, f"{n}^3", cells)
              for name in ms}
    for name in ms:
        print(f"[{label}] {name}: {ms[name]:.3f} ms against its bound {bounds[name][0]:.4f} ms "
              f"({ms[name] / bounds[name][0]:.1f}x)")
    out = {"ms": ms, "plain_ms": plain, "max_abs_err": errs, "bounds": bounds,
           "launches": {"mhd_step_ghosted": launches["mhd_step"],
                        "cfl_mhd_ghosted": launches["cfl_mhd"]}}
    return {key: {name + sfx: v for name, v in part.items()} for key, part in out.items()}


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
    # of the same state, times its cells at this size; the cells of the
    # window the step reads (ghosted_reads) read once, the interior and the
    # five planes written once
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
    nbytes = {"mhd_window": 4 * (ghosted_reads("window", (lp.nx, lp.ny, lp.nz)) + 8 * cells
                                 + 5 * lp.nz * lp.ny),
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


def check_rank_counts(label: str, ranks: list, steps: int, launched=("mhd_window",
                                                                      "cfl_mhd_window")) -> None:
    """Each rank launched each kernel counter of ``launched`` (parallel/
    sharded_step.py launch_counts) once a step, and no other."""
    want = {name: steps if name in launched else 0 for name in ranks[0]["counts"]}
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
    """One rank of phases 38 and 49 (a spawned process): the CLI's main(argv)
    in ``workdir``, as the CLI's own spawned ranks run it, with the
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
    try:
        before = launch_counts()
        rc = main(argv)
        counts = {name: n - before[name] for name, n in launch_counts().items()}
    finally:
        DistributedRun.start = start
    run = runs[0]
    out = {"rank": run.grid.rank, "rc": rc, "counts": counts, "n_step": run.n_step,
           "t": run.t, "backend": run.grid.describe(), "device": str(run.device)}
    S = run.interior()
    if S is not None:
        g = run.params.ghost_width
        inner = (slice(None),) + (slice(g, -g),) * run.params.dim
        out.update(U=S, U0=init_problem(run.params, run.config)[inner])
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


# ---------------------------------------------------------------------------
# turbulence: isothermal periodic MHD, the two forcings, the history
# ---------------------------------------------------------------------------
TURB = {name: f"data/{name}.ini" for name in
        ("turbulence_mhd", "turbulence_mhd_ou", "turbulence_hydro", "turbulence_hydro_ou")}
# the five timed forced paths of phase 41 at 256^3 f32: label, input, kernel
TURB_PATHS = (("41a", "turbulence_mhd", "auto"), ("41b", "turbulence_mhd_ou", "auto"),
              ("41h", "turbulence_hydro", "auto"), ("41o", "turbulence_hydro_ou", "auto"),
              ("41z", "turbulence_mhd", "zcarry"))
# the static kick's kinetic-energy change against n_cells dt edot
# (ops/forcing.py random_forcing_normalization's identity)
TOL_KICK = 1e-4
MASS_TOL = 1e-5


def turb_setup(name: str, n: int, dtype: str = "float32", kernel: str = "auto"):
    """data/<name>.ini at n^3 with the dtype and the kernel choice: config
    and params."""
    from ramsesgpu_tpu_torch.config.params import params_from_config

    config, _params = shipped(TURB[name], dtype, (n, n, n))
    config.set_string("implementation", "kernel", kernel)
    return config, params_from_config(config)


def iso_state(dtype: str, n: int = 64):
    """Phase 39's isothermal turbulence state on the card:
    data/turbulence_mhd_ou.ini's physics (cIso = 1) at n^3, its velocity the
    static forcing field at Mach 1 and the divergence-free field Bx = 0.2,
    By = 0.1 sin 2 pi x, Bz = 0.1 cos 2 pi y: params, the interior S and
    the filled ghosted state U."""
    import numpy as np

    from ramsesgpu_tpu_torch.convert import torch_dtype
    from ramsesgpu_tpu_torch.ops.forcing import turbulence_init_field
    from ramsesgpu_tpu_torch.problems import init_problem
    from ramsesgpu_tpu_torch.solvers.boundary import interior, make_boundaries

    config, params = turb_setup("turbulence_mhd_ou", n, dtype)
    U = init_problem(params, config)
    U[2:5] = U[0] * turbulence_init_field(params, 1.0)
    g = params.ghost_width
    x = params.xmin + params.dx / 2 + (np.arange(params.isize) - g) * params.dx
    y = params.ymin + params.dy / 2 + (np.arange(params.jsize) - g) * params.dy
    U[5] = 0.2
    U[6] = 0.1 * np.sin(2 * np.pi * x)[None, None, :]
    U[7] = 0.1 * np.cos(2 * np.pi * y)[None, :, None]
    U = make_boundaries(params, torch.from_numpy(U).to(device="cuda", dtype=torch_dtype(params)))
    return params, interior(params, U).contiguous(), U.contiguous()


def phase39() -> None:
    """The isothermal instances (rows A plain and compensated, B, 3, 12)
    against their twins on iso_state at 64^3, f32 + f64: the CFL (periodic
    and ghosted; the adiabatic instance reads another pressure on this
    state, so the isothermal one ran), one step of the streamed kernel
    against its twin and the staged kernel, its folded inverse dt against
    the CFL kernel, an inactive step, 10 chained steps of the loop
    (kernel=auto and zcarry) against the twins' loop, the dissipation
    kernel's periodic isothermal mode (its increment), and the ghosted step
    (and its inactive step) against its twin."""
    from ramsesgpu_tpu_torch.kernels.cfl_mhd import cfl_mhd
    from ramsesgpu_tpu_torch.kernels.dissip_step import dissip_step
    from ramsesgpu_tpu_torch.kernels.mhd_step import mhd_step
    from ramsesgpu_tpu_torch.solvers.dissipation import mhd_dissipation_periodic_update
    from ramsesgpu_tpu_torch.solvers.godunov_mhd import mhd_3d_ghosted_update
    from ramsesgpu_tpu_torch.solvers.step import make_packed_advance_chain
    from ramsesgpu_tpu_torch.solvers.timestep import (dt_from_inv, inv_dt_mhd_ghosted,
                                                      inv_dt_mhd_periodic)

    on = torch.ones((), dtype=torch.bool, device="cuda")
    for dtype in ("float32", "float64"):
        params, S, U = iso_state(dtype)
        g = params.ghost_width
        t0 = torch.zeros((), dtype=S.dtype, device="cuda")
        inv, inv_t = cfl_mhd(params, S), inv_dt_mhd_periodic(params, S)
        inv_a = cfl_mhd(params.replace(c_iso=0.0), S)
        inv_g, inv_gt = cfl_mhd(params, U, ghost=g), inv_dt_mhd_ghosted(params, U)
        apart = abs(float(inv_a) - float(inv)) / float(inv)
        check(f"39 cfl_mhd isothermal {dtype}", abs(float(inv) - float(inv_t)) / float(inv_t),
              TOL_CFL[dtype], f" (the adiabatic instance {apart:.3e} apart)")
        check(f"39 cfl_mhd ghosted isothermal {dtype}",
              abs(float(inv_g) - float(inv_gt)) / float(inv_gt), TOL_CFL[dtype])
        if not apart > 1e-3:
            raise AssertionError("39: the isothermal CFL did not take the isothermal pressure")
        for comp in (False, True):
            name = "compensated" if comp else "plain"
            p = params.replace(kernel="zcarry", compensated=comp)
            state = with_carry(S, 31) if comp else S
            e = zcarry_one_step(p, state, t0, None)
            tag = f"[39] {name} {dtype}"
            print(f"{tag} 1 step: streamed vs twin rel L2 {e['twin']:.3e}, vs staged "
                  f"{e['staged']:.3e} (tol {TOL_STEP1[dtype]:.0e}), max abs {e['max_abs']:.3e}, "
                  f"folded inv dt vs CFL kernel {e['fold_ulps']:.2f} ULP (bound {ULP_FOLD}), "
                  f"inactive copies: {e['idle_copy']}")
            if not (e["twin"] <= TOL_STEP1[dtype] and e["staged"] <= TOL_STEP1[dtype]
                    and e["fold_ulps"] <= ULP_FOLD and e["idle_copy"]):
                raise AssertionError(f"{tag}: the isothermal step disagrees: {e}")
            want, t_t = twin_loop(p, state, t0, None, 10)
            for kernel in ("auto", "zcarry"):
                _pack, advance, _unpack = make_packed_advance_chain(p.replace(kernel=kernel),
                                                                    "cuda")
                got, t_k, k = advance(state.clone(), t0.clone(), 10)
                rel10 = rel_l2(got[:8], want[:8])
                print(f"{tag} 10 chained steps, kernel={kernel}: k={int(k)}, t {float(t_k)!r} "
                      f"(twins {float(t_t)!r}), rel L2 {rel10:.3e} (tol {TOL_Z10[dtype]:.0e})")
                if int(k) != 10 or not rel10 <= TOL_Z10[dtype]:
                    raise AssertionError(f"{tag} kernel={kernel}: 10 steps disagree: {rel10}")
        # the dissipation kernel's periodic isothermal mode (no energy flux)
        pd = params.replace(nu=DISSIP_COEFFS["nu=2e-3 eta=1e-3"][0],
                            eta=DISSIP_COEFFS["nu=2e-3 eta=1e-3"][1])
        dt = dt_from_inv(pd, inv_t)
        got = dissip_step(pd, S, torch.empty_like(S), dt, on)
        check(f"39 dissip_step periodic isothermal {dtype} increment",
              increment_rel(got, mhd_dissipation_periodic_update(pd, S, dt), S), TOL_STEP1[dtype])
        dt = dt_from_inv(params, inv_gt)
        scratch = mhd_step.scratch(params, U, ghosted=True)
        got = mhd_step.ghosted(params, U.clone(), dt, on, scratch)
        check(f"39 ghosted step isothermal {dtype}", rel_l2(got, mhd_3d_ghosted_update(params, U, dt)),
              TOL_STEP1[dtype])
        if not torch.equal(mhd_step.ghosted(params, U.clone(), dt, ~on, scratch), U):
            raise AssertionError("39: the inactive ghosted step changed the state")
        del S, U, got, scratch
        torch.cuda.empty_cache()


def forced_twin_loop(params, S: torch.Tensor, forcing, n: int):
    """n forced steps of the twins on the card from the interior state S
    (the JAX forced step: dt from the state, the step, the kick): (S, t)."""
    from ramsesgpu_tpu_torch.solvers.godunov import hydro_3d_state_update
    from ramsesgpu_tpu_torch.solvers.godunov_mhd import mhd_3d_periodic_update
    from ramsesgpu_tpu_torch.solvers.timestep import (compute_inv_dt_hydro, dt_from_inv,
                                                      inv_dt_mhd_periodic)

    on = torch.ones((), dtype=torch.bool, device=S.device)
    t = torch.zeros((), dtype=S.dtype, device=S.device)
    for _ in range(n):
        if params.mhd:
            dt = dt_from_inv(params, inv_dt_mhd_periodic(params, S))
            S = mhd_3d_periodic_update(params, S, dt)
        else:
            dt = dt_from_inv(params, compute_inv_dt_hydro(params, S, ghost=0))
            S = hydro_3d_state_update(params, S, dt)
        forcing(S, dt, on)
        t = t + dt
    return S, t


def replay(forcing, draws: torch.Tensor) -> None:
    """Give an OU forcing the draws ``draws`` [k, 3, 31] in turn."""
    if forcing.state is not None:
        it = iter(draws.to(forcing.state.forcingField.device))
        forcing.state.draw = lambda: next(it)


def phase40() -> None:
    """Both forcings on the card against their CPU results on the same
    tensors (3 kicks of a moving 64^3 state, the OU draws the same), f32 +
    f64; then 10 steps of each forced loop (static and OU MHD, OU hydro:
    the step kernels, a CFL launch every step, the kick) against the twins'
    forced loop with the same draws."""
    from ramsesgpu_tpu_torch.kernels.cfl_mhd import cfl_mhd
    from ramsesgpu_tpu_torch.ops.forcing import make_forcing
    from ramsesgpu_tpu_torch.solvers.boundary import interior
    from ramsesgpu_tpu_torch.solvers.step import make_forced_chain
    from ramsesgpu_tpu_torch.solvers.timestep import dt_from_inv

    for dtype in ("float32", "float64"):
        tdt = getattr(torch, dtype)
        draws = torch.randn((10, 3, 31), generator=torch.Generator().manual_seed(40), dtype=tdt)
        for name in ("turbulence_mhd", "turbulence_mhd_ou"):
            config, params = turb_setup(name, 64, dtype)
            S = interior(params, ghosted_state(config, params, seed=41)).contiguous()
            S[2:5] += 0.1 * S[0]
            dt = dt_from_inv(params, cfl_mhd(params, S))
            on = torch.ones((), dtype=torch.bool, device="cuda")
            card_f, host_f = (make_forcing(params, config, d, tdt) for d in ("cuda", "cpu"))
            replay(card_f, draws)
            replay(host_f, draws)
            Sc = S.cpu()
            for _ in range(3):
                card_f(S, dt, on)
                host_f(Sc, dt.cpu(), on.cpu())
            rel = rel_l2(S.cpu(), Sc)
            extra = ""
            if card_f.state is not None:
                f_rel = rel_l2(card_f.state.forcingField.cpu(), host_f.state.forcingField)
                extra = f", OU field rel L2 {f_rel:.3e}"
                rel = max(rel, f_rel)
            check(f"40 {name} forcing on the card vs the CPU, 3 kicks, {dtype}", rel,
                  TOL_STEP1[dtype], extra)
        for name in ("turbulence_mhd", "turbulence_mhd_ou", "turbulence_hydro_ou"):
            config, params = turb_setup(name, 64, dtype)
            U = ghosted_state(config, params)
            (pack, advance, _unpack), forcing = make_forced_chain(params, "cuda", config)
            twin = make_forcing(params, config, "cuda", tdt)
            replay(forcing, draws)
            replay(twin, draws)
            t0 = torch.zeros((), dtype=tdt, device="cuda")
            S, t, k = advance(pack(U), t0, 10)
            W, t_w = forced_twin_loop(params, interior(params, U).contiguous(), twin, 10)
            rel10 = rel_l2(S, W)
            print(f"[40] {name} {dtype}: 10 forced loop steps: k={int(k)}, t {float(t)!r} "
                  f"(twins {float(t_w)!r}), rel L2 {rel10:.3e} (tol {TOL_STEP10[dtype]:.0e})")
            if int(k) != 10 or not rel10 <= TOL_STEP10[dtype]:
                raise AssertionError(f"40 {name} {dtype}: the forced loop disagrees: {rel10}")
            del U, S, W
        torch.cuda.empty_cache()


def kinetic_energy(S: torch.Tensor) -> float:
    """sum |rho v|^2 / (2 rho) over the interior state, in float64."""
    S64 = S[:5].double()
    return float((0.5 * (S64[2:5] ** 2).sum(0) / S64[0]).sum())


def kick_identity(label: str, params, forcing, S: torch.Tensor, dt: torch.Tensor) -> str:
    """The static kick on a copy of S: its kinetic-energy change against
    n_cells dt edot (norm s0 + norm^2 s1 / 2 = N dt edot, ops/forcing.py)."""
    from ramsesgpu_tpu_torch.ops.forcing import add_random_forcing, random_forcing_normalization

    X = S.clone()
    before = kinetic_energy(X)
    norm = random_forcing_normalization(params, X, forcing.F, dt, forcing.edot)
    add_random_forcing(params, X, forcing.F, norm)
    change = kinetic_energy(X) - before
    want = params.nx * params.ny * params.nz * float(dt) * forcing.edot
    rel = abs(change - want) / abs(want)
    if not rel <= TOL_KICK:
        raise AssertionError(f"{label}: the kick's kinetic energy {change!r}, N dt edot {want!r}")
    return f"kick dKE {change:.6e} vs N dt edot {want:.6e} (rel {rel:.2e}, tol {TOL_KICK:.0e})"


def phase41(card: str) -> dict:
    """The five forced paths at 256^3 f32 (TURB_PATHS) through
    make_forced_chain: 2 warm-up and 3 timed chunks of 10 steps each,
    launches per step (one CFL launch a step, also with kernel=zcarry),
    peak memory, the gates (finite, rho > 0, mass within 1e-5, MHD max|divB|
    as phase 5, the static kick's energy identity) and a profiled chunk:
    its idle share and the forcing's share of device time (every kernel
    besides the step and CFL kernels: the forcing's PyTorch passes and the
    loop's 0-d ops). Returns each path's launches and the end state of 41a
    and 41z."""
    from ramsesgpu_tpu_torch.kernels.cfl_hydro import cfl_hydro
    from ramsesgpu_tpu_torch.kernels.cfl_mhd import cfl_mhd
    from ramsesgpu_tpu_torch.ops.forcing import OUForcing
    from ramsesgpu_tpu_torch.solvers.boundary import interior
    from ramsesgpu_tpu_torch.solvers.step import make_forced_chain
    from ramsesgpu_tpu_torch.solvers.timestep import dt_from_inv

    n, chunk, steps = 256, 10, 50
    out = {"launches": {}, "ends": {}}
    for label, name, kernel in TURB_PATHS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        config, params = turb_setup(name, n, "float32", kernel)
        U = ghosted_state(config, params)
        mass0 = float(interior(params, U)[0].double().sum())
        (pack, advance, unpack), forcing = make_forced_chain(params, "cuda", config)
        if params.mhd:
            step = "zcarry_mhd" if kernel == "zcarry" else "mhd_step"
            expect = {step: steps, "cfl_mhd": steps}
        else:
            expect = {"hydro_step": steps, "cfl_hydro": steps}
        t = torch.zeros((), dtype=torch.float32, device="cuda")
        with counted_main_path(label, expect) as launches:
            S = pack(U)
            del U
            S, t, _dt = run_chunks(label, card, advance, S, t, n, chunk)
        peak = torch.cuda.max_memory_allocated() - base
        if not bool(torch.isfinite(S).all()):
            raise AssertionError(f"{label}: non-finite state")
        rho_min = float(S[0].min())
        mass = float(S[0].double().sum())
        text = f"min rho {rho_min:.4e}, mass rel {abs(mass - mass0) / mass0:.3e} ({MASS_TOL:.0e})"
        if not (rho_min > 0 and abs(mass - mass0) <= MASS_TOL * mass0):
            raise AssertionError(f"{label}: {text}")
        if params.mhd:
            b_over_dx = max(float(S[5].abs().max()), 1e-10) / params.dx
            divb = div_b_max(params, S)
            text += f", max|divB| {divb:.3e} (bound {1e-3 * b_over_dx:.3e})"
            if not divb < 1e-3 * b_over_dx:
                raise AssertionError(f"{label}: divB bound violated: {text}")
            inv = cfl_mhd(params, S)
        else:
            inv = cfl_hydro(params, S)
        if not isinstance(forcing, OUForcing):
            text += "; " + kick_identity(label, params, forcing, S, dt_from_inv(params, inv))
        basis = getattr(forcing, "basis", None)
        print(f"[{label}] {name} at {n}^3 f32, kernel={kernel} on {card}: {steps} steps, "
              f"t={float(t)!r}; {text}; launches per step: "
              + ", ".join(f"{k} {v / steps:g}" for k, v in launches.items() if v)
              + f"; peak allocated {peak / 1e9:.3f} GB"
              + ("" if basis is None else f" (OU basis {basis.numel() * 4 / 1e9:.3f} GB)"))
        if tuple(unpack(S, t).shape) != params.shape:
            raise AssertionError(f"{label}: unpacked shape")
        cfl = cfl_mhd if params.mhd else cfl_hydro
        before = cfl.launches
        rows = profile_chunk(f"{label}p", card, advance, S, t, chunk)
        cfl_launches = cfl.launches - before
        check_streamed(f"{label}p", kernel, rows)
        parts = {"step": 0.0, "cfl": 0.0, "forcing": 0.0}
        profiled_cfl = 0
        for key, (us, count) in rows.items():
            if "cfl_rows" in key:
                parts["cfl"] += us
                profiled_cfl += count
            elif "mhd::" in key or "zcarry" in key or "hydro" in key:
                parts["step"] += us
            else:
                parts["forcing"] += us
        busy = sum(parts.values())
        print(f"[{label}p] device time per step by part: " + ", ".join(
            f"{k} {v / 1e3 / chunk:.4f} ms ({100 * v / busy:.1f} %)" for k, v in parts.items())
            + f"; forcing share {parts['forcing'] / busy:.4f} (the forcing's passes and the "
              f"loop's 0-d ops); CFL launches {cfl_launches} in {chunk} steps (the profiler "
              f"recorded {profiled_cfl})")
        if cfl_launches != chunk:
            raise AssertionError(f"{label}: {cfl_launches} CFL launches in a {chunk}-step chunk")
        out["launches"][label] = dict(launches)
        if label in ("41a", "41z"):
            out["ends"][label] = (params, S, forcing)
        else:
            del S, forcing
    return out


def phase41k(card: str, ends: dict, comp, n_twin: int) -> dict:
    """The isothermal instances at full width on the end states of paths
    41a (static MHD: rows A and B), 41z (row 12, the folded CFL) and 41c
    (compensated OT: row A's compensated instance): each against its twin
    (at n_twin^3, phase 6's choice), its time (CUDA events) against the
    twin's, and its bound: the state read and written once (the CFL: read),
    and the operations counted by build("count") on a 32^3 block."""
    from ramsesgpu_tpu_torch.kernels.build import load_library, param_block
    from ramsesgpu_tpu_torch.kernels.cfl_mhd import cfl_mhd
    from ramsesgpu_tpu_torch.kernels.mhd_step import mhd_step
    from ramsesgpu_tpu_torch.kernels.zcarry_mhd3d import zcarry_mhd
    from ramsesgpu_tpu_torch.solvers.godunov_mhd import mhd_3d_periodic_update
    from ramsesgpu_tpu_torch.solvers.timestep import dt_from_inv, inv_dt_mhd_periodic

    res = {"ms": {}, "plain_ms": {}, "max_abs_err": {}, "bounds": {}}
    on = torch.ones((), dtype=torch.bool, device="cuda")
    lib = load_library("count")
    n = 256 ** 3
    cases = (("mhd_step_iso", ends["41a"][:2]), ("cfl_mhd_iso", ends["41a"][:2]),
             ("zcarry_mhd_iso", ends["41z"][:2]), ("mhd_step_comp_iso", comp[:2]))
    for name, (params, S) in cases:
        dt = dt_from_inv(params, cfl_mhd(params, S))
        Sw = S if n_twin == 256 else S[:, :n_twin, :n_twin, :n_twin].contiguous()
        pw = params if n_twin == 256 else block_params(params, n_twin)
        if name == "cfl_mhd_iso":
            run = lambda: cfl_mhd(params, S)  # noqa: E731
            got, want = cfl_mhd(pw, Sw), inv_dt_mhd_periodic(pw, Sw)
            plain = lambda: inv_dt_mhd_periodic(pw, Sw)  # noqa: E731
            tol = TOL_CFL["float32"]
        elif name == "zcarry_mhd_iso":
            S1 = torch.empty_like(S)
            run = lambda: zcarry_mhd(params, S, S1, dt, on, fold=True)  # noqa: E731
            got = torch.empty_like(Sw)
            zcarry_mhd(pw, Sw, got, dt, on, fold=True)
            want = mhd_3d_periodic_update(pw, Sw, dt)
            plain = lambda: inv_dt_mhd_periodic(pw, mhd_3d_periodic_update(pw, Sw, dt))  # noqa
            tol = TOL_STEP1["float32"]
        else:
            scratch = mhd_step.scratch(params, S)
            X = S.clone()
            run = lambda: mhd_step(params, X, dt, on, scratch)  # noqa: E731
            got = mhd_step(pw, Sw.clone(), dt, on, mhd_step.scratch(pw, Sw))
            want = mhd_3d_periodic_update(pw, Sw, dt)
            plain = lambda: mhd_3d_periodic_update(pw, Sw, dt)  # noqa: E731
            tol = TOL_STEP1["float32"]
        res["ms"][name] = time_ms(run, 10 if name != "cfl_mhd_iso" else 50)
        if name != "cfl_mhd_iso":  # the state; a compensated state's carry follows it
            got, want = got[:8], want[:8]
        check(f"41k {name} at {n_twin}^3 f32 (the path's end state)", rel_l2(got, want), tol)
        res["max_abs_err"][name] = float((got - want).abs().max())
        del got, want
        torch.cuda.empty_cache()
        res["plain_ms"][name] = time_ms(plain, 2 if name != "cfl_mhd_iso" else 10)
        blk = S[:, :32, :32, :32].double().cpu().contiguous()
        p32 = block_params(params, 32)
        comp_flag = int(params.compensated)
        step_ops = lib.ramses_mhd_step_ops(blk.data_ptr(), comp_flag, 32, 32, 32,
                                           param_block(p32), float(dt)) / 32 ** 3 * n
        cfl_ops = lib.ramses_cfl_mhd_ops(blk.data_ptr(), 32, 32, 32, param_block(p32)) / 32 ** 3 * n
        ch = S.shape[0]
        nbytes, ops = {"cfl_mhd_iso": (8 * 4 * n, cfl_ops),
                       "zcarry_mhd_iso": (2 * 8 * 4 * n, step_ops + cfl_ops)}.get(
            name, (2 * ch * 4 * n, step_ops))
        res["bounds"][name] = bound("41k", name, nbytes, ops, "256^3", n)
        print(f"[41k] {name}: kernel {res['ms'][name]:.4f} ms at 256^3, twin "
              f"{res['plain_ms'][name]:.3f} ms at {n_twin}^3, bound {res['bounds'][name][0]:.4f} "
              f"ms: {res['ms'][name] / res['bounds'][name][0]:.1f}x (f32, {card})")
        del Sw
        torch.cuda.empty_cache()
    return res


def phase42(card: str) -> None:
    """The four turbulence inputs as shipped through the CLI's main() on
    the card, at most 50 steps each, in a directory of their own (no HDF5
    snapshots where h5py is not installed: --no-output): the step kernels
    and one CFL launch a step, no twin; turbulence_mhd_ou.ini's history
    file is written, parses, and its mass column is constant to 1e-5."""
    import importlib.util
    import os
    import tempfile

    from ramsesgpu_tpu_torch.cli.main import main as cli_main
    from ramsesgpu_tpu_torch.io.history import read_history

    for name, path in TURB.items():
        params = params_from_text(Path(path).read_text())
        steps = min(50, params.n_stepmax)
        argv = ["--param", str(Path(path).resolve()), "--max-steps", str(steps)]
        label = f"42 {name}.ini"
        if importlib.util.find_spec("h5py") is None and "outputHdf5=yes" in Path(path).read_text():
            print(f"[{label}] h5py is not installed here: its HDF5 snapshots are skipped "
                  f"(--no-output)")
            argv.append("--no-output")
        expect = ({"mhd_step": steps, "cfl_mhd": steps} if params.mhd
                  else {"hydro_step": steps, "cfl_hydro": steps})
        cwd = os.getcwd()
        with tempfile.TemporaryDirectory(prefix="smoke42_") as workdir:
            os.chdir(workdir)
            try:
                with counted_main_path(label, expect):
                    rc = cli_main(argv)
            finally:
                os.chdir(cwd)
            written = sorted(p.name for p in Path(workdir).iterdir())
            history = Path(workdir) / f"{name}.history"
            text = f"rc {rc}, files {written}"
            if name == "turbulence_mhd_ou":
                if not history.exists():
                    raise AssertionError(f"{label}: no history file: {written}")
                cols = read_history(history)
                mass = cols["mass"]
                drift = max(abs(m - mass[0]) for m in mass) / abs(mass[0])
                text += (f"; history: {len(mass)} samples, {len(cols)} columns, t "
                         f"{cols['totalTime'][0]:.4f} .. {cols['totalTime'][-1]:.4f}, mass drift "
                         f"{drift:.3e} (tol {MASS_TOL:.0e})")
                if not (len(mass) >= 2 and drift <= MASS_TOL):
                    raise AssertionError(f"{label}: history {text}")
        print(f"[{label}] {params.nx}^3 {params.dtype} as shipped on {card}: {steps} steps; "
              + text)
        if rc != 0:
            raise AssertionError(f"{label}: rc {rc}")


# the 19 single-device 2D inputs without gravity (the 2D path: whole-array
# PyTorch on the card; the JAX package has no 2D kernel)
INPUTS_2D = ("hydro_sod2d", "implode2d", "blast2d", "Gresho_vortex2d", "riemann2d",
             "kelvin_helmholtz_cpu_2d", "kelvin_helmholtz_gpu_2d",
             "kelvin_helmholtz_gpu_2d_large", "jet2d_cpu", "jet2d_gpu", "orszag-tang",
             "mhd_rotor", "mhd_BrioWu", "mhd_currentSheet_2d", "mhd_fieldloop2d",
             "mhd_kelvin_helmholtz_2d", "kelvin_helmholtz_gpu_2d_mhd", "mhd_jet2d",
             "mhd_inertialWave_2d")


def check_2d_state(label: str, params, U: torch.Tensor, U0: torch.Tensor) -> str:
    """The gates of a 2D run's ghosted state U (initial state U0): finite,
    rho > 0 and (hydro) p > 0 on the interior; with periodic faces the
    mass within MASS_TOL; MHD: max|dBx/dx + dBy/dy| over the interior (its
    +1 faces are the CT layer n+g) < 1e-3 max|Bx| / dx. Returns the
    numbers as text."""
    from ramsesgpu_tpu_torch.core.constants import BoundaryConditionType as BCT

    g = params.ghost_width
    yi, xi = slice(g, g + params.ny), slice(g, g + params.nx)
    if not bool(torch.isfinite(U).all()):
        raise AssertionError(f"{label}: non-finite state")
    W = U[:, yi, xi].double()
    rho_min = float(W[0].min())
    ok = rho_min > 0
    text = f"min rho {rho_min:.4e}"
    if not params.mhd:
        ekin = 0.5 * (W[2:4] ** 2).sum(0) / W[0]
        p_min = float(((params.gamma0 - 1.0) * (W[1] - ekin)).min())
        ok = ok and p_min > 0
        text += f", min p {p_min:.4e}"
    else:
        bx, by = U[5].double(), U[6].double()
        div = ((bx[yi, g + 1:g + params.nx + 1] - bx[yi, xi]) / params.dx
               + (by[g + 1:g + params.ny + 1, xi] - by[yi, xi]) / params.dy)
        divb = float(div.abs().max())
        bound = 1e-3 * max(float(W[5].abs().max()), 1e-10) / params.dx
        ok = ok and divb < bound
        text += f", max|divB| {divb:.3e} (bound {bound:.3e})"
    if all(b == BCT.BC_PERIODIC for b in params.boundary_types[:4]):
        mass0 = float(U0[0, yi, xi].double().sum())
        drift = abs(float(W[0].sum()) - mass0) / mass0
        ok = ok and drift <= MASS_TOL
        text += f", mass drift {drift:.3e} (tol {MASS_TOL:.0e})"
    if not ok:
        raise AssertionError(f"{label}: {text}")
    return text


def cli_run(label: str, path: Path, steps: int, expect: dict):
    """The CLI's main() on the input ``path`` for ``steps`` steps with
    --no-output (no HDF5 where h5py is missing, and the snapshots are not
    what is checked), in a temporary directory, its kernel launches counted
    against ``expect`` (counted_main_path): the Run on the card, its
    initial state and the wall seconds, set-up included."""
    import os
    import tempfile

    from ramsesgpu_tpu_torch.cli.main import main as cli_main
    from ramsesgpu_tpu_torch.solvers.run import Run

    start = Run.start
    runs = []

    def kept_start(self, *args, **kw):
        runs.append((self, self.U.clone()))
        return start(self, *args, **kw)

    cwd = os.getcwd()
    Run.start = kept_start
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="smoke_cli_") as workdir:
        os.chdir(workdir)
        try:
            with counted_main_path(label, expect):
                rc = cli_main(["--param", str(path), "--max-steps", str(steps), "--no-output"])
        finally:
            os.chdir(cwd)
            Run.start = start
    run, U0 = runs[0]
    if rc != 0 or run.n_step != steps or run.U.device.type != "cuda":
        raise AssertionError(f"{label}: rc {rc}, {run.n_step} steps, on {run.U.device}")
    return run, U0, time.perf_counter() - t0


def phase43(card: str) -> None:
    """Every 2D input as shipped through the CLI's main() on the card, at
    most 10 steps each (cli_run): no kernel launch and no twin (there is no
    2D kernel), the Run on the card, and check_2d_state's gates on the
    state it ends with."""
    for name in INPUTS_2D:
        path = Path(f"data/{name}.ini").resolve()
        params = params_from_text(path.read_text())
        steps = min(10, params.n_stepmax)
        label = f"43 {name}.ini"
        run, U0, wall = cli_run(label, path, steps, {})
        text = check_2d_state(label, run.params, run.U, U0)
        print(f"[{label}] {params.nx}x{params.ny} {params.dtype} "
              f"{'MHD' if params.mhd else 'hydro'} {params.riemann_solver.name} as shipped on "
              f"{card}: {steps} steps to t {run.t:.4e} in {wall:.2f} s (set-up included); {text}")


def phase44(card: str) -> None:
    """The two timed 2D cells, f32, through make_packed_advance_chain on
    the card: Orszag-Tang at 2048^2 (data/orszag-tang.ini's physics on a
    mesh enlarged as a 2D production run would be) and
    data/kelvin_helmholtz_gpu_2d_large.ini as shipped (1200^2). Each: 2
    warm-up and 3 timed chunks of 10 steps (ms/step, cells/s), peak device
    memory, one profiled chunk (device time by kernel, launches a step,
    idle share), check_2d_state's gates."""
    from ramsesgpu_tpu_torch.config.configmap import ConfigMap
    from ramsesgpu_tpu_torch.config.params import params_from_config
    from ramsesgpu_tpu_torch.problems import init_problem
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries
    from ramsesgpu_tpu_torch.solvers.step import make_packed_advance_chain

    for label, name, n in (("44 OT 2048^2", "orszag-tang", 2048),
                           ("44 KH 1200^2", "kelvin_helmholtz_gpu_2d_large", None)):
        config = ConfigMap(Path(f"data/{name}.ini"))
        if n is not None:
            config.set_integer("mesh", "nx", n)
            config.set_integer("mesh", "ny", n)
        params = params_from_config(config)
        if params.dtype != "float32" or params.dim != 2:
            raise AssertionError(f"{label}: {params.dtype}, dim {params.dim}")
        U0 = make_boundaries(params, torch.from_numpy(init_problem(params, config)).cuda())
        pack, advance, unpack = make_packed_advance_chain(params, "cuda", config)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        S = pack(U0)
        t = torch.zeros((), dtype=U0.dtype, device="cuda")
        cells = params.nx * params.ny
        with counted_main_path(label, {}):
            S, t, _dt = run_chunks(label, card, advance, S, t, f"{params.nx}x{params.ny}",
                                   cells=cells)
        peak = torch.cuda.max_memory_allocated() - base
        rows = profile_chunk(label, card, advance, S, t, 10)
        launches = sum(count for _us, count in rows.values()) / 10
        busy_ms = sum(us for us, _count in rows.values()) / 1e3
        # the profiler slows the host's launches: the idle share against one
        # more chunk without it too
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        S, t, _k = advance(S, t, 10)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        print(f"[{label}] {launches:.1f} kernel launches a step; device busy {busy_ms:.3f} ms "
              f"against {wall_ms:.3f} ms of an unprofiled chunk: idle share "
              f"{1 - busy_ms / wall_ms:.4f}; peak device memory {peak / 2**30:.3f} GiB above "
              f"the initial state ({peak / cells:.1f} B a cell); "
              f"{check_2d_state(label, params, unpack(S, t), U0)}")
        del S, U0


def phase45(card: str) -> None:
    """The 2D path on the card against the CPU through the same code:
    data/orszag-tang.ini and data/hydro_sod2d.ini at 64^2, f64, 10 steps of
    make_advance_n; relative L2 <= 1e-12, equal t and step counts, and no
    host sync in the card's chunk (sync debug mode "error" raises on one)."""
    from ramsesgpu_tpu_torch.config.configmap import ConfigMap
    from ramsesgpu_tpu_torch.config.params import params_from_config
    from ramsesgpu_tpu_torch.problems import init_problem
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries
    from ramsesgpu_tpu_torch.solvers.step import make_advance_n

    for name in ("orszag-tang", "hydro_sod2d"):
        label = f"45 {name}"
        config = ConfigMap(Path(f"data/{name}.ini"))
        for axis in ("nx", "ny"):
            config.set_integer("mesh", axis, 64)
        config.set_string("implementation", "dtype", "float64")
        params = params_from_config(config)
        U = make_boundaries(params, torch.from_numpy(init_problem(params, config)).cuda())
        t0 = torch.zeros((), dtype=U.dtype, device="cuda")
        advance = make_advance_n(params, "cuda", config)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            U_gpu, t_gpu, k_gpu = advance(U, t0, 10)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        U_cpu, t_cpu, k_cpu = make_advance_n(params, "cpu", config)(U.cpu(), t0.cpu(), 10)
        rel = rel_l2(U_gpu.cpu(), U_cpu)
        dt_rel = abs(float(t_gpu) - float(t_cpu)) / float(t_cpu)
        print(f"[{label}] 64^2 f64, 10 steps, card vs CPU: relative L2 {rel:.3e} (tol 1e-12), "
              f"t {float(t_gpu):.6e} vs {float(t_cpu):.6e} (rel {dt_rel:.1e}); no host sync "
              f"in the card's chunk")
        if not (int(k_gpu) == int(k_cpu) == 10 and rel <= 1e-12 and dt_rel <= 1e-12):
            raise AssertionError(f"{label}: k {int(k_gpu)}/{int(k_cpu)}, rel {rel}, t {dt_rel}")


# ---------------------------------------------------------------------------
# static gravity and the walled dissipation: phases 46-48
# ---------------------------------------------------------------------------
RT3_INI = "data/rayleigh_taylor_gpu_3d.ini"
RT3_MHD_INI = "data/rayleigh_taylor_gpu_3d_mhd.ini"
GRAVITY_2D = ("rayleigh_taylor_gpu_2d", "falling_bubble_gpu_2d", "Keplerian_disk2d",
              "rayleigh_taylor_cpu_2d_mhd")
GRAVITY_3D = ("rayleigh_taylor_gpu_3d", "rayleigh_taylor_gpu_3d_mhd")
# phase 46's cases: the step kernels' gravity instances and the dissipation
# kernel's ghosted mode on perturbed initial states (the walled Brio-Wu
# with phase 17's nu and eta)
CASES_46 = ("hydro gravity", "mhd gravity", "walls dissipation")
# the gravity-free numbers phase 48's cells are printed beside (NVIDIA H100
# 80GB HBM3, 700 W; PERF.md sections 5-6)
GRAVITY_FREE_48 = {"48h": "implode 2.553 ms/step, row 6 2.299 ms",
                   "48m": "MHD walls 9.881 ms/step, row 3 9.164 ms",
                   "48d": "MHD walls 9.881 ms/step; periodic dissipation 2.182 ms, bound 0.300 ms"}


def case_46(case: str, dtype: str, mesh, seed: int = 46):
    """(config, params, filled ghosted state) of a phase 46 case at
    ``mesh``, times 1 + 0.05 N(0, 1) before the fill."""
    path = {"hydro gravity": RT3_INI, "mhd gravity": RT3_MHD_INI,
            "walls dissipation": HLLD_INI}[case]
    config, params = shipped(path, dtype, mesh)
    if case == "walls dissipation":
        nu, eta = DISSIP_COEFFS["nu=2e-3 eta=1e-3"]
        config.set_float("hydro", "nu", nu)
        config.set_float("MHD", "eta", eta)
        params = params.replace(nu=nu, eta=eta)
    return config, params, ghosted_state(config, params, seed=seed)


def twin_loop_46(case: str, params, U: torch.Tensor, n: int):
    """n steps of the loop's semantics on the card through the twins: the
    hydro interior loop (CFL, step from the load rules' fill), or the
    ghosted loop (CFL on the state as it stands, the fill, the step; with
    nu or eta the fill again and the ghosted dissipation). Returns the
    ghosted state (hydro: the interior's fill) and t."""
    from ramsesgpu_tpu_torch.solvers.boundary import (fill_ghosts_, interior,
                                                      make_boundaries_concat)
    from ramsesgpu_tpu_torch.solvers.dissipation import mhd_dissipation_ghosted_update
    from ramsesgpu_tpu_torch.solvers.godunov import gravity_vector, hydro_3d_state_update
    from ramsesgpu_tpu_torch.solvers.godunov_mhd import mhd_3d_ghosted_update
    from ramsesgpu_tpu_torch.solvers.timestep import (compute_inv_dt_hydro, dt_from_inv,
                                                      inv_dt_mhd_ghosted)

    grav, t = gravity_vector(params, U), 0.0
    if not params.mhd:
        S = interior(params, U).contiguous()
        for _ in range(n):
            dt = dt_from_inv(params, compute_inv_dt_hydro(params, S, ghost=0))
            S = hydro_3d_state_update(params, S, dt, grav)
            t += float(dt)
        return make_boundaries_concat(params, S, interior_only=True), t
    U = U.clone()
    for _ in range(n):
        dt = dt_from_inv(params, inv_dt_mhd_ghosted(params, U))
        U = mhd_3d_ghosted_update(params, fill_ghosts_(params, U), dt, grav)
        if params.nu > 0 or params.eta > 0:
            U = mhd_dissipation_ghosted_update(params, fill_ghosts_(params, U), dt)
        t += float(dt)
    return U, t


def phase46() -> None:
    """The new kernel instances and mode against their twins on the card,
    at 64^3 and at an odd 50x50x72 (no multiple of any tile), f32 and f64:
    one step of hydro_step.cu's gravity instance (interior mode with the z
    walls, and ghosted mode), of mhd_step.cu's ghosted gravity instance, of
    dissip_step.cu's ghosted mode (the interior and the CT face layer; an
    inactive sub-step changes nothing), each against its twin; then 10
    steps of each loop (make_advance_n) against the twins' loop."""
    from ramsesgpu_tpu_torch.kernels.dissip_step import dissip_step
    from ramsesgpu_tpu_torch.kernels.hydro_step import hydro_step
    from ramsesgpu_tpu_torch.kernels.mhd_step import mhd_step
    from ramsesgpu_tpu_torch.solvers.boundary import interior
    from ramsesgpu_tpu_torch.solvers.dissipation import mhd_dissipation_ghosted_update
    from ramsesgpu_tpu_torch.solvers.godunov import (gravity_vector, hydro_3d_interior_update,
                                                     hydro_3d_state_update)
    from ramsesgpu_tpu_torch.solvers.godunov_mhd import mhd_3d_ghosted_update
    from ramsesgpu_tpu_torch.solvers.step import make_advance_n

    on = torch.ones((), dtype=torch.bool, device="cuda")
    off = torch.zeros((), dtype=torch.bool, device="cuda")
    for mesh in ((64, 64, 64), (50, 50, 72)):
        size = "x".join(map(str, mesh))
        for dtype in ("float32", "float64"):
            for case in CASES_46:
                label = f"46 {case} {size} {dtype}"
                config, params, U = case_46(case, dtype, mesh)
                dt = torch.tensor(1e-3, dtype=U.dtype, device="cuda")
                grav = gravity_vector(params, U)
                if case == "hydro gravity":
                    S = interior(params, U).contiguous()
                    got = hydro_step(params, S, torch.empty_like(S), dt, on)
                    check(f"{label} interior mode (walls), 1 step",
                          rel_l2(got, hydro_3d_state_update(params, S, dt, grav)),
                          TOL_STEP1[dtype])
                    check(f"{label} ghosted mode, 1 step",
                          rel_l2(hydro_step.ghosted(params, U, dt),
                                 hydro_3d_interior_update(params, U, dt, grav)), TOL_STEP1[dtype])
                elif case == "mhd gravity":
                    got = U.clone()
                    mhd_step.ghosted(params, got, dt, on, mhd_step.scratch(params, U, True))
                    check(f"{label} ghosted mode, 1 step",
                          rel_l2(got, mhd_3d_ghosted_update(params, U, dt, grav)),
                          TOL_STEP1[dtype])
                else:
                    buf = dissip_step.scratch(params, U)
                    got = U.clone()
                    dissip_step.ghosted_(params, got, dt, off, buf)
                    if not torch.equal(got, U):
                        raise AssertionError(f"{label}: an inactive sub-step changed the state")
                    dissip_step.ghosted_(params, got, dt, on, buf)
                    want = mhd_dissipation_ghosted_update(params, U, dt)
                    check(f"{label} ghosted dissipation, increment",
                          increment_rel(got, want, U), TOL_STEP1[dtype],
                          f", increment norm / state norm {rel_l2(want, U):.3e}")
                t0 = torch.zeros((), dtype=U.dtype, device="cuda")
                got, t, k = make_advance_n(params, "cuda", config)(U, t0, 10)
                want, t_ref = twin_loop_46(case, params, U, 10)
                rel = rel_l2(interior(params, got), interior(params, want))
                if int(k) != 10 or abs(float(t) - t_ref) > TOL_STEP10[dtype] * t_ref:
                    raise AssertionError(f"{label}: k {int(k)}, t {float(t)!r} vs {t_ref!r}")
                check(f"{label} 10 loop steps against the twins' loop (interior)", rel,
                      TOL_STEP10[dtype])
                del U, got, want
    torch.cuda.empty_cache()


def phase47(card: str) -> dict:
    """The six single-device gravity inputs as shipped through the CLI's
    main() on the card, at most 10 steps each (cli_run): the Run on the
    card, the gates (finite, rho > 0, hydro p > 0, MHD divB), the kernel
    launches a step (none in 2D; 3D the step and CFL kernels once a step,
    no twin); make_step_fn of rayleigh_taylor_gpu_3d (the hydro step's
    ghosted gravity mode, TPU row 5), 10 steps on the card, counted; and the
    four 2D inputs at their shipped mesh in f64, 10 steps of make_advance_n
    on the card against the CPU (relative L2 <= 1e-12, equal t). Returns
    the launches of the ghosted hydro gravity mode."""
    from ramsesgpu_tpu_torch.config.configmap import ConfigMap
    from ramsesgpu_tpu_torch.config.params import params_from_config, static_gravity
    from ramsesgpu_tpu_torch.problems import has_gravity_field, init_problem
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries
    from ramsesgpu_tpu_torch.solvers.step import make_advance_n, make_step_fn

    for name in GRAVITY_2D + GRAVITY_3D:
        path = Path(f"data/{name}.ini").resolve()
        params = params_from_text(path.read_text())
        steps = min(10, params.n_stepmax)
        label = f"47 {name}.ini"
        expect = {} if params.dim == 2 else (
            {"mhd_step": steps, "cfl_mhd": steps} if params.mhd
            else {"hydro_step": steps, "cfl_hydro": steps})
        run, U0, wall = cli_run(label, path, steps, expect)
        text = (check_2d_state(label, run.params, run.U, U0) if params.dim == 2
                else check_walled_state(label, run.params, run.U))
        per_step = ", ".join(f"{k} {v / steps:g}" for k, v in expect.items()) or "none"
        field = ("the problem field" if has_gravity_field(params, run.config)
                 else static_gravity(params))
        print(f"[{label}] {'x'.join(str(n) for n in (params.nx, params.ny, params.nz)[:params.dim])}"
              f" {params.dtype} {'MHD' if params.mhd else 'hydro'} {params.riemann_solver.name}, "
              f"gravity {field} as shipped on "
              f"{card}: {steps} steps to t {run.t:.4e} in {wall:.2f} s (set-up included); kernel "
              f"launches a step: {per_step}; {text}")

    # the ghosted mode's gravity instance through make_step_fn (TPU row 5)
    config = ConfigMap(Path(RT3_INI))
    params = params_from_config(config)
    step = make_step_fn(params, "cuda", config)
    U = make_boundaries(params, torch.from_numpy(init_problem(params, config)).cuda())
    with counted_main_path("47 make_step_fn rayleigh_taylor_gpu_3d.ini",
                           {"hydro_step": 10, "cfl_hydro": 10}) as launches:
        t = 0.0
        for _ in range(10):
            U, dt = step(U, t)
            t += float(dt)
    check_walled_state("47 make_step_fn", params, U)

    for name in GRAVITY_2D:
        label = f"47 {name} f64 card vs CPU"
        config = ConfigMap(Path(f"data/{name}.ini"))
        config.set_string("implementation", "dtype", "float64")
        params = params_from_config(config)
        U = make_boundaries(params, torch.from_numpy(init_problem(params, config)).cuda())
        t0 = torch.zeros((), dtype=U.dtype, device="cuda")
        U_gpu, t_gpu, k_gpu = make_advance_n(params, "cuda", config)(U, t0, 10)
        U_cpu, t_cpu, k_cpu = make_advance_n(params, "cpu", config)(U.cpu(), t0.cpu(), 10)
        rel = rel_l2(U_gpu.cpu(), U_cpu)
        dt_rel = abs(float(t_gpu) - float(t_cpu)) / float(t_cpu)
        print(f"[{label}] {params.nx}x{params.ny} f64, 10 steps: relative L2 {rel:.3e} "
              f"(tol 1e-12), t {float(t_gpu):.6e} vs {float(t_cpu):.6e} (rel {dt_rel:.1e})")
        if not (int(k_gpu) == int(k_cpu) == 10 and rel <= 1e-12 and dt_rel <= 1e-12):
            raise AssertionError(f"{label}: k {int(k_gpu)}/{int(k_cpu)}, rel {rel}, t {dt_rel}")
    return {"hydro_step_ghosted_grav": launches["hydro_step"]}


def phase48(card: str, n_twin: int) -> dict:
    """Three timed cells at 256^3 f32 through make_packed_advance_chain,
    each 2 warm-up and 3 timed chunks of 10 steps (ms/step, cells/s),
    counted (one launch of each kernel a step, no twin), peak device
    memory, gated, and one profiled chunk (device time by kernel, launches a
    step, idle share): 48h the 3D hydro Rayleigh-Taylor physics
    (data/rayleigh_taylor_gpu_3d.ini: x, y periodic, z reflecting, g_z =
    -0.2, approx) and 48m the same in 3D MHD (data/rayleigh_taylor_gpu_3d_mhd.ini,
    HLLD), both at 256^3 instead of 50x50x200; 48d data/testRiemannHLLD.ini's
    walled Brio-Wu with phase 17's nu and eta at 256^3. Then the new kernel
    instances on each path's end state with CUDA events against their twins
    (at 256^3; the MHD step's at n_twin^3, phase 6's choice) and their
    bounds (bytes read and written once; the operations counted by
    build("count") on a 32^3 block)."""
    from ramsesgpu_tpu_torch.kernels.build import load_library, param_block
    from ramsesgpu_tpu_torch.kernels.cfl_hydro import cfl_hydro
    from ramsesgpu_tpu_torch.kernels.cfl_mhd import cfl_mhd
    from ramsesgpu_tpu_torch.kernels.dissip_step import dissip_step
    from ramsesgpu_tpu_torch.kernels.hydro_step import hydro_step
    from ramsesgpu_tpu_torch.kernels.mhd_step import mhd_step
    from ramsesgpu_tpu_torch.solvers.boundary import fill_ghosts_, make_boundaries_concat
    from ramsesgpu_tpu_torch.solvers.dissipation import mhd_dissipation_ghosted_update
    from ramsesgpu_tpu_torch.solvers.godunov import (gravity_vector, hydro_3d_interior_update,
                                                     hydro_3d_state_update)
    from ramsesgpu_tpu_torch.solvers.godunov_mhd import mhd_3d_ghosted_update
    from ramsesgpu_tpu_torch.solvers.step import make_packed_advance_chain
    from ramsesgpu_tpu_torch.solvers.timestep import dt_from_inv

    n, chunk, steps = 256, 10, 50
    cells = n ** 3
    on = torch.ones((), dtype=torch.bool, device="cuda")
    out = {"ms": {}, "plain_ms": {}, "max_abs_err": {}, "bounds": {}, "launches": {}}
    lib = load_library("count")
    for label, path in (("48h", RT3_INI), ("48m", RT3_MHD_INI), ("48d", HLLD_INI)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        config, params = shipped(path, "float32", (n, n, n))
        if label == "48d":
            nu, eta = DISSIP_COEFFS["nu=2e-3 eta=1e-3"]
            config.set_float("hydro", "nu", nu)
            config.set_float("MHD", "eta", eta)
            params = params.replace(nu=nu, eta=eta)
        g = params.ghost_width
        U = ghosted_state(config, params)
        expect = ({"hydro_step": steps, "cfl_hydro": steps} if not params.mhd
                  else {"mhd_step": steps, "cfl_mhd": steps})
        if label == "48d":
            expect["dissip_step"] = steps
        pack, advance, unpack = make_packed_advance_chain(params, "cuda", config)
        t = torch.zeros((), dtype=torch.float32, device="cuda")
        with counted_main_path(label, expect) as launches:
            S = pack(U)
            del U
            S, t, _dt = run_chunks(label, card, advance, S, t, n, chunk)
        peak = torch.cuda.max_memory_allocated() - base
        U = unpack(S, t)
        gates = check_walled_state(label, params, U)
        del U
        rows = profile_chunk(f"{label}p", card, advance, S, t, chunk)
        per_step = sum(count for _us, count in rows.values()) / chunk
        print(f"[{label}] {steps} steps at {n}^3 f32 on {card}: t={float(t)!r}, {gates}; "
              f"launches per step: " + ", ".join(f"{k} {v / steps:g}" for k, v in expect.items())
              + f"; {per_step:.1f} device kernels a step in the profiled chunk (the fill's "
              f"included); peak allocated {peak / 1e9:.3f} GB; gravity-free (PERF.md): "
              f"{GRAVITY_FREE_48[label]}")

        dt = dt_from_inv(params, cfl_hydro(params, S) if not params.mhd
                         else cfl_mhd(params, S, ghost=g))
        grav = gravity_vector(params, S)
        if label == "48h":
            name = "hydro_step_grav"
            out["launches"][name] = launches["hydro_step"]
            newton = torch.zeros((), dtype=torch.int64, device="cuda")
            got = hydro_step(params, S, torch.empty_like(S), dt, on, newton=newton)
            So = torch.empty_like(S)
            U = make_boundaries_concat(params, S, interior_only=True)
            out["ms"][name] = time_ms(lambda: hydro_step(params, S, So, dt, on), 10)
            out["ms"]["hydro_step_ghosted_grav"] = time_ms(
                lambda: hydro_step.ghosted(params, U, dt), 10)
            # the gravity-free instance on the same state: what gravity costs
            p0 = params.replace(gravity_x=0.0, gravity_y=0.0, gravity_z=0.0)
            free_ms = time_ms(lambda: hydro_step(p0, S, So, dt, on), 10)
            print(f"[48h] hydro_step on the path's state: gravity instance "
                  f"{out['ms'][name]:.4f} ms, gravity-free instance {free_ms:.4f} ms ({card})")
            got_g = hydro_step.ghosted(params, U, dt)
            del So
            torch.cuda.empty_cache()
            want = hydro_3d_state_update(params, S, dt, grav)
            for key, k_out in ((name, got), ("hydro_step_ghosted_grav", got_g)):
                out["max_abs_err"][key] = float((k_out - want).abs().max())
                check(f"48h {key} 256^3 f32 (the path's state)", rel_l2(k_out, want),
                      TOL_STEP1["float32"], f", max abs {out['max_abs_err'][key]:.3e}")
            del got, got_g, want
            torch.cuda.empty_cache()
            out["plain_ms"][name] = time_ms(lambda: hydro_3d_state_update(params, S, dt, grav), 3)
            out["plain_ms"]["hydro_step_ghosted_grav"] = time_ms(
                lambda: hydro_3d_interior_update(params, U, dt, grav), 3)
            ops = hydro_ops(params, S, float(dt), int(newton))["ops"]
            out["bounds"][name] = bound(label, name, 2 * 5 * 4 * cells, ops, "256^3", cells)
            out["bounds"]["hydro_step_ghosted_grav"] = bound(
                label, "hydro_step_ghosted_grav",
                4 * (5 * cells + ghosted_reads("hydro", (n,) * 3)), ops, "256^3", cells)
            names = (name, "hydro_step_ghosted_grav")
            del U
        elif label == "48m":
            name = "mhd_step_ghosted_grav"
            names = (name,)
            out["launches"][name] = launches["mhd_step"]
            W = fill_ghosts_(params, S.clone())
            scratch = mhd_step.scratch(params, W, ghosted=True)
            W_t = W.clone()
            out["ms"][name] = time_ms(lambda: mhd_step.ghosted(params, W_t, dt, on, scratch), 10)
            p0 = params.replace(gravity_x=0.0, gravity_y=0.0, gravity_z=0.0)
            free_ms = time_ms(lambda: mhd_step.ghosted(p0, W_t, dt, on, scratch), 10)
            print(f"[48m] mhd_step ghosted on the path's state: gravity instance "
                  f"{out['ms'][name]:.4f} ms, gravity-free instance {free_ms:.4f} ms ({card})")
            del W_t
            got = mhd_step.ghosted(params, W.clone(), dt, on, scratch)
            del scratch
            bound_input = W[:, :32 + 2 * g, :32 + 2 * g, :32 + 2 * g].double().cpu().contiguous()
            if n_twin != n:
                config_t, params_t = shipped(path, "float32", (n_twin,) * 3)
                W = ghosted_state(config_t, params_t, seed=48)
                got = mhd_step.ghosted(params_t, W.clone(), dt, on,
                                       mhd_step.scratch(params_t, W, True))
            else:
                params_t = params
            torch.cuda.empty_cache()
            want = mhd_3d_ghosted_update(params_t, W, dt, grav)
            out["max_abs_err"][name] = float((got - want).abs().max())
            check(f"48m {name} at {n_twin}^3 f32", rel_l2(got, want), TOL_STEP1["float32"],
                  f", max abs {out['max_abs_err'][name]:.3e}")
            del got, want
            torch.cuda.empty_cache()
            out["plain_ms"][name] = time_ms(lambda: mhd_3d_ghosted_update(params_t, W, dt, grav),
                                            3)
            del W
            p_blk = block_params(params, 32)
            ops = lib.ramses_mhd_step_ghosted_ops(bound_input.data_ptr(), 32, 32, 32, g,
                                                  param_block(p_blk), float(dt)) / 32 ** 3
            nbytes = 4 * (ghosted_reads("mhd", (n,) * 3) + 8 * cells + 3 * ((n + 1) ** 3 - cells))
            out["bounds"][name] = bound(label, name, nbytes, ops * cells, "256^3", cells)
        else:
            name = "dissip_step_ghosted"
            names = (name,)
            out["launches"][name] = launches["dissip_step"]
            W = fill_ghosts_(params, S.clone())
            buf = dissip_step.scratch(params, W)
            got = dissip_step.ghosted_(params, W.clone(), dt, on, buf)
            W_t = W.clone()
            out["ms"][name] = time_ms(lambda: dissip_step.ghosted_(params, W_t, dt, on, buf), 10)
            parts = device_parts(lambda: dissip_step.ghosted_(params, W_t, dt, on, buf),
                                 "dissip::Body")
            split = ("not measured (the profiler recorded no launch)" if parts is None else
                     f"the kernel {parts[0]:.4f} ms, the copy back {parts[1]:.4f} ms "
                     f"({parts[2]} of 10 calls profiled)")
            print(f"[48d] {name}: {out['ms'][name]:.4f} ms through the wrapper (CUDA events); "
                  f"device time a call: {split} ({card})")
            del W_t, buf
            torch.cuda.empty_cache()
            want = mhd_dissipation_ghosted_update(params, W, dt)
            out["max_abs_err"][name] = float((got - want).abs().max())
            check(f"48d {name} 256^3 f32 increment", increment_rel(got, want, W),
                  TOL_STEP1["float32"], f", max abs {out['max_abs_err'][name]:.3e}, increment "
                  f"norm / state norm {rel_l2(want, W):.3e}")
            del got, want
            torch.cuda.empty_cache()
            out["plain_ms"][name] = time_ms(lambda: mhd_dissipation_ghosted_update(params, W, dt),
                                            3)
            blk = block_params(params, 32)
            S_sub = W[:, g:g + 32, g:g + 32, g:g + 32].double().contiguous().cpu()
            ops = lib.ramses_dissip_step_ops(S_sub.data_ptr(), None, 0, 32, 32, 32,
                                             param_block(blk), float(dt)) / 32 ** 3 * cells
            # as dissip_bytes: it reads the cells of the ghosted state that
            # reach what it writes (ghosted_reads) and, with eta, B of the CT
            # face layer written too
            iso, visc, resist = params.c_iso > 0, params.nu > 0, params.eta > 0
            written = 3 * visc + 3 * resist + (not iso)
            nbytes = 4 * (ghosted_reads("dissip", (n,) * 3, visc, resist, iso) + written * cells
                          + 3 * resist * ((n + 1) ** 3 - cells))
            out["bounds"][name] = bound(label, name, nbytes, ops, "256^3", cells)
            del W
        for key in names:
            print(f"[{label}] {key}: kernel {out['ms'][key]:.4f} ms, twin "
                  f"{out['plain_ms'][key]:.3f} ms, bound {out['bounds'][key][0]:.4f} ms "
                  f"({out['bounds'][key][1]}), {out['ms'][key] / out['bounds'][key][0]:.1f}x "
                  f"(256^3 f32, {card})")
        del S
        torch.cuda.empty_cache()
    return out


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
        ("11", "cfl_mhd_shear"), ("CFL of 3", "cfl_mhd_ghosted"), ("CFL of 4", "cfl_mhd_window"),
        ("7", "cfl_hydro"), ("9 / 10 x slabs", "shear_slabs"), ("9 / 10 border", "shear_border"),
        ("9 / 10 border, compensated", "shear_border_comp"),
        ("9 stratified x + z slabs", "shear_slabs_strat"), ("A isothermal", "mhd_step_iso"),
        ("A'-compensated isothermal", "mhd_step_comp_iso"), ("B isothermal", "cfl_mhd_iso"),
        ("3 isothermal", "mhd_step_ghosted_iso"), ("CFL of 3 isothermal", "cfl_mhd_ghosted_iso"),
        ("12 isothermal", "zcarry_mhd_iso"), ("6 gravity", "hydro_step_grav"),
        ("5 gravity", "hydro_step_ghosted_grav"), ("3 gravity", "mhd_step_ghosted_grav"),
        ("8 ghosted", "dissip_step_ghosted"),
        *((f"{row} {face}/{corner}", f"{kernel}_{face}_{corner}")
          for row, kernel in (("A", "mhd_step"), ("12", "zcarry_mhd"))
          for face, corner in (("hll", "hlla"), ("llf", "llf"), ("hlld", "hllf"))),
        ("A'-shear-dissipation / 10 stratified", "dissip_step_strat"))


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


# ---------------------------------------------------------------------------
# the sharded periodic, walled and jet runs (JAX make_local_step): phase 49
# ---------------------------------------------------------------------------
# the nine shipped [mpi] inputs the slice runs, by world size (4 or 8 ranks
# sharing the card)
LOCAL_MPI_INIS = {
    4: ("data/implode3d_mpi_zslab.ini", "data/implode2d_mpi.ini", "data/jet2d_mpi_cpu.ini",
        "data/jet2d_mpi_gpu.ini", "data/kelvin_helmholtz_gpu_2d_mhd_mpi.ini",
        "data/orszag-tang_mpi.ini", "data/rayleigh_taylor_2d_mpi_mhd.ini"),
    8: ("data/jet3d_mpi_gpu.ini", "data/jet3d_mhd_mpi_gpu.ini"),
}
# the timed cells: label, input (its physics and topology), global mesh
LOCAL_CELLS = (("49h", "data/implode3d_mpi_zslab.ini", (256, 256, 256)),
               ("49m", "data/jet3d_mhd_mpi_gpu.ini", (128, 128, 256)),
               ("49o", "data/orszag-tang_mpi.ini", (2048, 2048, 1)))
SHARDED_REL_L2["49"] = 1e-5


def rank_jobs49(jobs: list) -> list:
    """One rank of phase 49 (a spawned process): each job in turn, in one
    world, a CLI run (``{"cli": cli_rank_checked's arguments}``) or
    parallel/sharded_step.py rank_advance's keyword arguments."""
    from ramsesgpu_tpu_torch.parallel.sharded_step import rank_advance

    return [cli_rank_checked(**job["cli"]) if "cli" in job else rank_advance(**job)
            for job in jobs]


def local_launched(params) -> tuple:
    """The launch counters a rank of a sharded run outside the shearing box
    adds to once a step: the step and CFL kernels' ghosted modes in 3D
    (rows 3 and B's ghosted form; row 5 and row 7), with nu or eta in 3D
    MHD also the dissipation kernel's ghosted mode (row 8); none in 2D."""
    if params.dim == 2:
        return ()
    kind = "mhd" if params.mhd else "hydro"
    dissip = ("dissip_step", "dissip_step_ghosted") if params.mhd and (
        params.nu > 0 or params.eta > 0) else ()
    return (f"{kind}_step", f"{kind}_step_ghosted", f"cfl_{kind}", f"cfl_{kind}_ghosted",
            *dissip)


def single_rank_local(text: str, steps: int):
    """(interior on the CPU, t, k) of the port's single-rank path on the
    card (solvers/step.py make_advance_n; a turbulence problem's
    make_forced_advance_n, its OU generator on the card seeded as every
    rank's) from the INI's initial state."""
    from ramsesgpu_tpu_torch.config.configmap import ConfigMap
    from ramsesgpu_tpu_torch.convert import torch_dtype
    from ramsesgpu_tpu_torch.problems import init_problem
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries
    from ramsesgpu_tpu_torch.solvers.step import is_forced, make_advance_n, make_forced_advance_n

    config = ConfigMap(text=text)
    params = params_from_text(text)
    U0 = torch.from_numpy(init_problem(params, config)).to("cuda", torch_dtype(params))
    advance = (make_forced_advance_n(params, "cuda", config)[0] if is_forced(params)
               else make_advance_n(params, "cuda", config))
    U, t, k = advance(
        make_boundaries(params, U0), torch.zeros((), dtype=U0.dtype, device="cuda"), steps)
    g = params.ghost_width
    return U[(slice(None),) + (slice(g, -g),) * params.dim].cpu(), float(t), int(k)


def compare_single_local(label: str, text: str, got: torch.Tensor, t_got: float, k_got: int,
                         steps: int) -> None:
    """The gathered sharded state after ``steps`` against the single-rank
    path's: t within 1e-6, k equal, each channel's relative L2 (its absolute
    L2 where the channel is 0) within SHARDED_REL_L2["49"], printed."""
    single, t1, k1 = single_rank_local(text, steps)
    diff = (got - single).double()
    rel = [float(diff[c].norm()) / (float(single[c].double().norm()) or 1.0)
           for c in range(single.shape[0])]
    tol = SHARDED_REL_L2["49"]
    print(f"[{label}] {steps} steps against the single-rank path: t {t_got!r} vs {t1!r}; "
          f"relative L2 per channel {[f'{x:.3e}' for x in rel]} (<= {tol:.0e}); max |diff| "
          f"{float(diff.abs().max()):.3e}")
    if not (max(rel) <= tol and k1 == k_got == steps and abs(t1 - t_got) <= 1e-6 * t1):
        raise AssertionError(f"{label}: the sharded run disagrees with the single-rank path")


def local_gates(label: str, params, S: torch.Tensor) -> str:
    """Finite, rho > 0; on 2D and 3D MHD max|divB| < 1e-3 max|B| / dx on
    the interior's faces (the +1 face of the last cells is not held)."""
    if not bool(torch.isfinite(S).all()) or not float(S[0].min()) > 0:
        raise AssertionError(f"{label}: non-finite state or rho <= 0 (min {float(S[0].min())})")
    out = f"finite, min rho {float(S[0].min()):.4e}"
    if params.mhd:
        S = S.double()
        if params.dim == 2:
            div = ((S[5][:, 1:] - S[5][:, :-1])[:-1] / params.dx
                   + (S[6][1:] - S[6][:-1])[:, :-1] / params.dy)
        else:
            div = ((S[5][..., 1:] - S[5][..., :-1])[:-1, :-1] / params.dx
                   + (S[6][:, 1:] - S[6][:, :-1])[:-1, :, :-1] / params.dy
                   + (S[7][1:] - S[7][:-1])[:, :-1, :-1] / params.dz)
        bound = 1e-3 * max(float(S[5:8].abs().max()), 1e-30) / params.dx
        divb = float(div.abs().max())
        if not divb < bound:
            raise AssertionError(f"{label}: divB {divb} (bound {bound})")
        out += f", max|divB| {divb:.3e} (bound {bound:.3e})"
    return out


def single_rank_timed(label: str, text: str, card: str, chunk: int = 10):
    """ms/step of the port's single-rank path on the card at the cell's
    global mesh (make_packed_advance_chain, a turbulence problem's
    make_forced_chain; 2 warm-up and 3 timed chunks), and its state after
    its first chunk (CPU)."""
    from ramsesgpu_tpu_torch.config.configmap import ConfigMap
    from ramsesgpu_tpu_torch.convert import torch_dtype
    from ramsesgpu_tpu_torch.problems import init_problem
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries
    from ramsesgpu_tpu_torch.solvers.step import (is_forced, make_forced_chain,
                                                  make_packed_advance_chain)

    config = ConfigMap(text=text)
    params = params_from_text(text)
    pack, advance, unpack = (make_forced_chain(params, "cuda", config)[0] if is_forced(params)
                             else make_packed_advance_chain(params, "cuda", config))
    U0 = torch.from_numpy(init_problem(params, config)).to("cuda", torch_dtype(params))
    S = pack(make_boundaries(params, U0))
    del U0
    t = torch.zeros((), dtype=S.dtype, device="cuda")
    g = params.ghost_width
    first, times = None, []
    for i in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        S, t, k = advance(S, t, chunk)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if int(k) != chunk:
            raise AssertionError(f"{label}: a single-rank chunk stopped early")
        if i == 0:
            first = (unpack(S, t)[(slice(None),) + (slice(g, -g),) * params.dim].cpu(),
                     float(t))
    del S
    torch.cuda.empty_cache()
    return min(times[2:]) * 1e3 / chunk, first


def timed_cell(label: str, text: str, mesh, ranks: list, profiled: list, card: str,
               chunk: int = 10, compare: int = 10, hold: bool = True) -> None:
    """The report of one timed sharded cell (phases 49, 50): the best of the
    3 timed chunks (slowest rank each) and the cells/s, the launches a
    rank-step, each rank's profiled sections and the share of its step
    outside the kernels, the single-rank path at the same mesh (timed), the
    gates and the profiled steps against the single-rank path's first
    chunk (held within SHARDED_REL_L2["49"] where ``hold``, else printed:
    a resistive cell, see phase 50)."""
    params = params_from_text(text)
    cells = math.prod(mesh)
    if any(r["k"] != chunk for r in ranks):
        raise AssertionError(f"{label}: a chunk stopped early")
    per_chunk = [max(r["chunk_s"][i] for r in ranks) for i in range(2, 5)]
    ms = min(per_chunk) * 1e3 / chunk
    size = "x".join(str(n) for n in mesh if n > 1)
    print(f"[{label}] {size} {params.dtype} on {len(ranks)} ranks ({ranks[0]['transport']}) "
          f"on {card}: best chunk {ms:.3f} ms/step, {cells * chunk / (ms * chunk / 1e3):.4e} "
          f"cells/s (chunks {[round(x * 1e3 / chunk, 3) for x in per_chunk]} ms/step, "
          f"slowest rank each)")
    check_rank_counts(label, ranks, 5 * chunk, local_launched(params))
    check_rank_counts(label + "p", profiled, compare, local_launched(params))
    for r in profiled:
        prof = r["profile"]
        step_ms = r["chunk_s"][0] * 1e3 / compare
        walls = ", ".join(f"{k} {v / compare:.3f}" for k, v in prof["wall_ms"].items())
        events = ", ".join(f"{k} {v / compare:.4f}" for k, v in prof["kernel_ms"].items())
        inside = sum(prof["kernel_ms"].values()) / compare
        what = "kernels" if params.dim == 3 else "whole-array step and CFL"
        print(f"[{label}p] rank {r['rank']}: step {step_ms:.3f} ms; sections: {walls}; "
              f"CUDA events: {events}; share of the step outside the {what}: "
              f"{1 - inside / step_ms:.4f}")
    single_ms, (first, t_first) = single_rank_timed(label, text, card, compare)
    print(f"[{label}] the single-rank path at the same mesh on {card}: {single_ms:.3f} "
          f"ms/step ({cells / (single_ms / 1e3):.4e} cells/s); sharded/single "
          f"{ms / single_ms:.3f}")
    got = torch.from_numpy(profiled[0]["U"])
    print(f"[{label}] " + local_gates(label, params, got))
    diff = (got - first).double()
    rel = [float(diff[c].norm()) / (float(first[c].double().norm()) or 1.0)
           for c in range(first.shape[0])]
    tol = SHARDED_REL_L2["49"]
    print(f"[{label}] {compare} profiled steps against the single-rank path's first "
          f"chunk: t {profiled[0]['t']!r} vs {t_first!r}; relative L2 per channel "
          f"{[f'{x:.3e}' for x in rel]} (<= {tol:.0e})")
    if hold and not (max(rel) <= tol and abs(profiled[0]["t"] - t_first) <= 1e-6 * t_first):
        raise AssertionError(f"{label}: the sharded cell disagrees with the single-rank "
                             f"path")


def phase49(card: str) -> None:
    """The sharded periodic, walled and jet runs (parallel/sharded_step.py):
    (a) the nine shipped [mpi] inputs the slice runs as shipped through the
    CLI's main() on their spawned ranks, 4 or 8 sharing the card, at most
    20 steps each (no snapshots where the input writes HDF5 and h5py is not
    installed): per-rank launches, each gathered state against the
    single-rank path, the written VTK pieces reassembled against the
    gathered state; (b) three timed cells, each 2 warm-up and 3 timed
    chunks of 10 steps (slowest rank) and 10 profiled steps from the initial
    state against the single-rank path, which is also timed at the same
    mesh: the 3D implode at 256^3 on 2x2x1, the 3D MHD jet at 128x128x256
    on 2x2x2, 2D Orszag-Tang at 2048^2 on 2x2."""
    import importlib.util
    import tempfile

    import numpy as np

    from ramsesgpu_tpu_torch.config.configmap import ConfigMap
    from ramsesgpu_tpu_torch.core.constants import var_names
    from ramsesgpu_tpu_torch.io.vtk import read_pvti
    from ramsesgpu_tpu_torch.parallel.launch import spawn_ranks

    have_h5 = importlib.util.find_spec("h5py") is not None
    chunk, compare = 10, 10
    with tempfile.TemporaryDirectory(prefix="smoke49_") as tmp:
        jobs, meta = {4: [], 8: []}, {4: [], 8: []}
        for world, inis in LOCAL_MPI_INIS.items():
            for ini in inis:
                text = Path(ini).read_text()
                steps = min(20, params_from_text(text).n_stepmax)
                argv = ["--param", str(Path(ini).resolve()), "--max-steps", str(steps)]
                if not have_h5 and "outputHdf5=yes" in text:
                    argv.append("--no-output")
                workdir = Path(tmp) / Path(ini).stem
                workdir.mkdir()
                jobs[world].append({"cli": dict(argv=argv, workdir=str(workdir))})
                meta[world].append(("cli", ini, text, steps, workdir, "--no-output" in argv))
        for label, ini, mesh in LOCAL_CELLS:
            text = sharded_ini(ini, mesh)
            world = math.prod(int(re.search(rf"^{k}=(\d+)", text, re.M).group(1))
                              for k in ("mx", "my", "mz"))
            jobs[world] += [dict(config_text=text, device="cuda", n_steps=chunk, chunks=5),
                            dict(config_text=text, device="cuda", n_steps=compare,
                                 profile=True)]
            meta[world] += [("timed", label, text, mesh), ("profiled", label, text, mesh)]
        results = []
        for world in (4, 8):
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            per_rank = spawn_ranks(rank_jobs49, world, (jobs[world],))
            print(f"[49] {world} ranks on {card}: {len(jobs[world])} jobs in "
                  f"{time.perf_counter() - t0:.1f} s")
            results += [(m, [r[i] for r in per_rank]) for i, m in enumerate(meta[world])]
        timed = {}
        for m, ranks in results:
            r0 = ranks[0]
            if m[0] == "cli":
                _kind, ini, text, steps, workdir, no_output = m
                label = f"49 {Path(ini).name}"
                params = params_from_text(text)
                written = sorted(p.name for p in workdir.iterdir())
                print(f"[{label}] {params.nx}x{params.ny}x{params.nz} {params.dtype} as shipped: "
                      f"{r0['backend']}, {r0['n_step']} steps, t={r0['t']!r}, "
                      f"{len(written)} files written")
                if any(r["rc"] != 0 or r["n_step"] != steps for r in ranks):
                    raise AssertionError(f"{label}: {[(r['rc'], r['n_step']) for r in ranks]}")
                check_rank_counts(label, ranks, steps, local_launched(params))
                got = torch.from_numpy(r0["U"])
                print(f"[{label}] " + local_gates(label, params, got))
                compare_single_local(label, text, got, r0["t"], r0["n_step"], steps)
                config = ConfigMap(text=text)
                if not no_output and config.get_bool("output", "outputVtk", True):
                    prefix = config.get_string("output", "outputPrefix", "output")
                    pieces = read_pvti(workdir / f"{prefix}_{steps:07d}.pvti")
                    back = torch.from_numpy(np.stack(
                        [pieces[n] for n in var_names(params.nb_var)]))
                    n_pieces = len(list(workdir.glob(f"{prefix}_{steps:07d}_p*.vti")))
                    if n_pieces != len(ranks) or not torch.equal(back, got):
                        raise AssertionError(f"{label}: the VTK pieces ({n_pieces}) do not "
                                             f"reassemble to the gathered state")
                    print(f"[{label}] its {n_pieces} VTK pieces at step {steps} reassemble "
                          f"to the gathered state, bitwise")
            else:
                timed.setdefault(m[1], {})[m[0]] = (m, ranks)
        for label, _ini, mesh in LOCAL_CELLS:
            (_, _, text, _), ranks = timed[label]["timed"]
            _m, profiled = timed[label]["profiled"]
            timed_cell(label, text, mesh, ranks, profiled, card, chunk, compare)
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the sharded dissipation and forcing (phase 50)
# ---------------------------------------------------------------------------
TURB_MPI_INIS = ("data/turbulence_hydro_mpi.ini", "data/turbulence_mhd_mpi.ini")
MPI_221 = "\n[mpi]\nmx=2\nmy=2\nmz=1\n"
# the timed cells of phase 50: label, input, global mesh, INI text appended
# (later keys win): 50f turbulence_mhd_mpi.ini's physics (static forcing,
# isothermal, 2x2x1), 50d the walled Brio-Wu with phase 17's nu and eta
DISSIP_CELLS_50 = (
    ("50f", "data/turbulence_mhd_mpi.ini", (256, 256, 256), ""),
    ("50d", HLLD_INI, (256, 256, 256), "\n[hydro]\nnu=2e-3\n[MHD]\neta=1e-3\n" + MPI_221),
)
# 10 OU MHD steps at 64^3 on 2x2x1 against one rank
OU_50 = ("50o", TURB["turbulence_mhd_ou"], (64, 64, 64))


def dissip_block(case: str, dtype: str, mesh):
    """(params, filled ghosted state on the card) of a rank-size block with
    nu = 2e-3, eta = 1e-3, times 1 + 0.05 N(0, 1) before the fill: the
    walled Brio-Wu (the fill), or the MRI (cIso = omega0 = 1) filled by
    the sheared fill at a t0 whose offset is 2.5 cells."""
    from ramsesgpu_tpu_torch.convert import torch_dtype
    from ramsesgpu_tpu_torch.problems import init_problem
    from ramsesgpu_tpu_torch.solvers.shear import make_all_boundaries_shear

    nu, eta = DISSIP_COEFFS["nu=2e-3 eta=1e-3"]
    if case == "walls":
        config, params = shipped(HLLD_INI, dtype, mesh)
        config.set_float("hydro", "nu", nu)
        config.set_float("MHD", "eta", eta)
        return params.replace(nu=nu, eta=eta), ghosted_state(config, params.replace(nu=nu, eta=eta),
                                                             seed=50)
    params, config, _state = mri_setup(*mesh, dtype, coeffs=1.0, nu=nu, eta=eta)
    U = torch.from_numpy(init_problem(params, config)).to("cuda", torch_dtype(params))
    gen = torch.Generator(device="cuda").manual_seed(50)
    U = U * (1 + 0.05 * torch.randn(U.shape, generator=gen, device="cuda", dtype=U.dtype))
    return params, make_all_boundaries_shear(params, U, shear_t0(params, U.dtype)).contiguous()


def phase50_kernel() -> None:
    """Row 8's ghosted mode as a rank runs it (interior_only: the interior
    alone written back) on rank-size blocks, 64x64x128 and an odd
    15x15x30, walled and shearing-box, f32 and f64: an inactive sub-step
    changes nothing; the interior's increment against the twin's
    (mhd_dissipation_ghosted_update); every ghost bitwise as it was."""
    from ramsesgpu_tpu_torch.kernels.dissip_step import dissip_step
    from ramsesgpu_tpu_torch.solvers.dissipation import mhd_dissipation_ghosted_update

    on = torch.ones((), dtype=torch.bool, device="cuda")
    off = torch.zeros((), dtype=torch.bool, device="cuda")
    for mesh in ((64, 64, 128), (15, 15, 30)):
        size = "x".join(map(str, mesh))
        for dtype in ("float32", "float64"):
            for case in ("walls", "shear"):
                label = f"50 row 8 ghosted, interior only, {case} {size} {dtype}"
                params, U = dissip_block(case, dtype, mesh)
                g = params.ghost_width
                inner = (slice(None),) + (slice(g, -g),) * 3
                dt = torch.tensor(1e-3, dtype=U.dtype, device="cuda")
                buf = dissip_step.scratch(params, U)
                got = U.clone()
                before = dissip_step.ghosted_launches
                dissip_step.ghosted_(params, got, dt, off, buf, True)
                if not torch.equal(got, U):
                    raise AssertionError(f"{label}: an inactive sub-step changed the state")
                dissip_step.ghosted_(params, got, dt, on, buf, True)
                if dissip_step.ghosted_launches - before != 2:
                    raise AssertionError(f"{label}: {dissip_step.ghosted_launches - before} "
                                         f"launches, expected 2")
                want = mhd_dissipation_ghosted_update(params, U, dt)
                check(label + ", increment", increment_rel(got[inner], want[inner], U[inner]),
                      TOL_STEP1[dtype], f", increment norm / state norm "
                      f"{rel_l2(want[inner], U[inner]):.3e}")
                got[inner], U[inner] = 0, 0
                if not torch.equal(got, U):
                    raise AssertionError(f"{label}: a ghost changed")
                del U, got, want
    torch.cuda.empty_cache()


def phase50(card: str) -> None:
    """The sharded dissipation and forcing (parallel/sharded_step.py), in
    one world of 4 ranks sharing the card: (a) both turbulence [mpi]
    inputs as shipped through the CLI's main() (no snapshots where h5py is
    not installed): per-rank launches, the gates (finite, rho > 0, mass
    within MASS_TOL, MHD divB), the gathered state against the single-rank
    path; (b) 10 OU MHD steps at 64^3 on 2x2x1 against the single-rank
    path (every rank and the single rank seed the same generator on the
    card: the same draws); (c) the timed cells 50f and 50d, each 2 warm-up
    and 3 timed chunks of 10 steps (slowest rank) and 10 profiled steps
    against the single-rank path, also timed at the same mesh."""
    import importlib.util
    import tempfile

    from ramsesgpu_tpu_torch.parallel.launch import spawn_ranks

    phase50_kernel()
    have_h5 = importlib.util.find_spec("h5py") is not None
    chunk, compare = 10, 10
    with tempfile.TemporaryDirectory(prefix="smoke50_") as tmp:
        jobs, meta = [], []
        for ini in TURB_MPI_INIS:
            text = Path(ini).read_text()
            steps = min(20, params_from_text(text).n_stepmax)
            argv = ["--param", str(Path(ini).resolve()), "--max-steps", str(steps)]
            if not have_h5 and "outputHdf5=yes" in text:
                argv.append("--no-output")
            workdir = Path(tmp) / Path(ini).stem
            workdir.mkdir()
            jobs.append({"cli": dict(argv=argv, workdir=str(workdir))})
            meta.append(("cli", f"50 {Path(ini).name}", text, steps))
        label, ini, mesh = OU_50
        text = sharded_ini(ini, mesh) + MPI_221
        jobs.append(dict(config_text=text, device="cuda", n_steps=compare))
        meta.append(("ou", label, text, compare))
        for label, ini, mesh, extra in DISSIP_CELLS_50:
            text = sharded_ini(ini, mesh) + extra
            jobs += [dict(config_text=text, device="cuda", n_steps=chunk, chunks=5),
                     dict(config_text=text, device="cuda", n_steps=compare, profile=True)]
            meta += [("timed", label, text, mesh), ("profiled", label, text, mesh)]
            if params_from_text(text).eta > 0:
                jobs.append(dict(config_text=text, device="cuda", n_steps=1))
                meta.append(("one", label, text, mesh))
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        per_rank = spawn_ranks(rank_jobs49, 4, (jobs,))
        print(f"[50] 4 ranks on {card}: {len(jobs)} jobs in {time.perf_counter() - t0:.1f} s")
        timed = {}
        for i, m in enumerate(meta):
            ranks = [r[i] for r in per_rank]
            r0 = ranks[0]
            if m[0] in ("cli", "ou"):
                kind, label, text, steps = m
                params = params_from_text(text)
                n_step = r0["n_step"] if kind == "cli" else r0["k"]
                print(f"[{label}] {params.nx}x{params.ny}x{params.nz} {params.dtype}: "
                      f"{r0['backend']}, {n_step} steps, t={r0['t']!r}")
                if kind == "cli" and any(r["rc"] != 0 or r["n_step"] != steps for r in ranks):
                    raise AssertionError(f"{label}: {[(r['rc'], r['n_step']) for r in ranks]}")
                check_rank_counts(label, ranks, steps, local_launched(params))
                got = torch.from_numpy(r0["U"])
                U0 = (torch.from_numpy(r0["U0"]) if kind == "cli"
                      else initial_interior(params, text))
                mass0, mass = float(U0[0].double().sum()), float(got[0].double().sum())
                if not abs(mass - mass0) <= MASS_TOL * abs(mass0):
                    raise AssertionError(f"{label}: mass {mass} against {mass0}")
                print(f"[{label}] " + local_gates(label, params, got)
                      + f", mass rel {abs(mass - mass0) / abs(mass0):.3e} (tol {MASS_TOL:.0e})")
                compare_single_local(label, text, got, r0["t"], n_step, steps)
            elif m[0] == "one":
                resistive_step(m[1], m[2], ranks)
            else:
                timed.setdefault(m[1], {})[m[0]] = (m, ranks)
        for label, _ini, mesh, _extra in DISSIP_CELLS_50:
            (_, _, text, _), ranks = timed[label]["timed"]
            _m, profiled = timed[label]["profiled"]
            timed_cell(label, text, mesh, ranks, profiled, card, chunk, compare,
                       hold=params_from_text(text).eta == 0)
    torch.cuda.empty_cache()


def resistive_step(label: str, text: str, ranks: list) -> None:
    """One step of a sharded resistive run against the single-rank path.
    Each rank's row 8 runs the JAX sharded route's CT range on its refilled
    block (the interior and its max-side face layer, JAX
    apply_dissipation_mhd on the CPU): the resistive energy flux of the
    cells beside an internal block face reads ghost B that the block's CT
    leaves as the fill wrote it, where the single-rank path reads the
    neighbour's updated B (ROADMAP Queue 3 item 16). So after one step
    every channel but the energy, and the energy outside the cells within
    one cell of an internal block face, equal the single-rank path's
    within SHARDED_REL_L2["49"]; the band's energy differs by the
    difference printed. After it the difference spreads: the timed cell's
    10 steps are printed against the single-rank path, not held."""
    from ramsesgpu_tpu_torch.core.constants import IP

    params = params_from_text(text)
    check_rank_counts(label + " one step", ranks, 1, local_launched(params))
    got = torch.from_numpy(ranks[0]["U"])
    single, t1, k1 = single_rank_local(text, 1)
    band = torch.zeros(got.shape[1:], dtype=torch.bool)
    sizes = ((params.nz, ranks_of(text, "mz")), (params.ny, ranks_of(text, "my")),
             (params.nx, ranks_of(text, "mx")))
    for axis, (n, m) in enumerate(sizes):
        for face in range(n // m, n, n // m):
            band.narrow(axis, face - 1, 2).fill_(True)
    diff = (got - single).double()
    rel = [float(diff[c].norm()) / (float(single[c].double().norm()) or 1.0)
           for c in range(single.shape[0]) if c != IP]
    e = single[IP].double()
    rel_e = float(diff[IP][~band].norm()) / float(e[~band].norm())
    tol = SHARDED_REL_L2["49"]
    print(f"[{label} one step] against the single-rank path: t {ranks[0]['t']!r} vs {t1!r}; "
          f"relative L2 of the channels but the energy {[f'{x:.3e}' for x in rel]}, of the "
          f"energy outside the internal faces' band {rel_e:.3e} (<= {tol:.0e}); in the band "
          f"({int(band.sum())} cells) max |diff| {float(diff[IP][band].abs().max()):.3e}, "
          f"relative L2 {float(diff[IP][band].norm()) / float(e[band].norm()):.3e}")
    if not (max(rel + [rel_e]) <= tol and k1 == 1 and abs(ranks[0]["t"] - t1) <= 1e-6 * t1):
        raise AssertionError(f"{label}: one resistive step disagrees with the single-rank path "
                             f"outside the internal faces' band")


def ranks_of(text: str, key: str) -> int:
    return int(re.search(rf"^{key}=(\d+)", text, re.M).group(1))


def initial_interior(params, text: str) -> torch.Tensor:
    """The INI's initial interior (CPU)."""
    from ramsesgpu_tpu_torch.config.configmap import ConfigMap
    from ramsesgpu_tpu_torch.problems import init_problem

    g = params.ghost_width
    return torch.from_numpy(init_problem(params, ConfigMap(text=text)))[
        (slice(None),) + (slice(g, -g),) * params.dim]


# ---------------------------------------------------------------------------
# the MHD solvers other than HLLD and the stratified box with nu, eta: phase 51
# ---------------------------------------------------------------------------
# the (face, corner) solver pairs of phase 51: between them every solver
# the HLLD / 2D-HLLD instances do not take
SOLVER_PAIRS = (("hll", "hlla"), ("llf", "llf"), ("hlld", "hllf"))


def with_solvers(params, face: str, corner: str):
    """params with the face solver ``face`` and the corner solver ``corner``
    (the INI's [hydro] riemannSolver and [MHD] magRiemannSolver names)."""
    from ramsesgpu_tpu_torch.core.constants import MagneticRiemannSolver, RiemannSolver

    return params.replace(riemann_solver=RiemannSolver[face.upper()],
                          mag_riemann_solver=MagneticRiemannSolver[f"MAG_{corner.upper()}"])


def phase51_twins() -> None:
    """The general instances against their twins on small inputs, f32 +
    f64, at the tolerances of the phases that cover each row: rows A and 12
    on Orszag-Tang at 32^3 for each pair (the streamed step's folded
    inverse dt against the CFL twin on its output), row 3 on
    data/testRiemannHLLD.ini's walls with (hll, llf), row 4 on a window of
    a two-rank block (ideal, and stratified with g_z) with (llf, hllf) and
    (hll, hlla), and the dissipation kernel's stratified shear mode (plain:
    the increment and the kept face's change; compensated: bitwise)."""
    from ramsesgpu_tpu_torch.kernels.cfl_mhd import cfl_mhd
    from ramsesgpu_tpu_torch.kernels.dissip_step import dissip_step
    from ramsesgpu_tpu_torch.kernels.mhd_step import mhd_step, mhd_window
    from ramsesgpu_tpu_torch.kernels.zcarry_mhd3d import zcarry_mhd
    from ramsesgpu_tpu_torch.solvers.dissipation import (kept_face_resistive_ct,
                                                          mhd_dissipation_shear_update)
    from ramsesgpu_tpu_torch.solvers.godunov_mhd import (mhd_3d_ghosted_update,
                                                         mhd_3d_periodic_update,
                                                         mhd_3d_shear_window_update)
    from ramsesgpu_tpu_torch.solvers.timestep import (dt_from_inv, inv_dt_ghosted,
                                                      inv_dt_mhd_ghosted_shear,
                                                      inv_dt_mhd_periodic, inv_dt_mhd_shear)

    active = torch.ones((), dtype=torch.bool, device="cuda")
    for dtype in ("float32", "float64"):
        base, S = setup(32, dtype)
        for face, corner in SOLVER_PAIRS:
            params = with_solvers(base, face, corner)
            label = f"51 {face}/{corner} 32^3 {dtype}"
            dt = dt_from_inv(params, cfl_mhd(params, S))
            want = mhd_3d_periodic_update(params, S, dt)
            got = mhd_step(params, S.clone(), dt, active, mhd_step.scratch(params, S))
            check(f"{label} row A", rel_l2(got, want), TOL_STEP1[dtype])
            out = torch.empty_like(S)
            inv = zcarry_mhd(params, S, out, dt, active, fold=True)
            check(f"{label} row 12", rel_l2(out, want), TOL_STEP1[dtype])
            u = ulps(inv, inv_dt_mhd_periodic(params, out))
            print(f"[{label}] row 12's folded inverse dt: {u:.2f} ULP of the CFL twin's (bound 4)")
            if not u <= 4:
                raise AssertionError(f"{label}: the folded inverse dt disagrees: {u} ULP")

        config, params = shipped(HLLD_INI, dtype, (40, 36, 32))
        params = with_solvers(params, "hll", "llf")
        U = ghosted_state(config, params, seed=51)
        dt = dt_from_inv(params, inv_dt_ghosted(params, U))
        got = mhd_step.ghosted(params, U.clone(), dt, active,
                               mhd_step.scratch(params, U, ghosted=True))
        check(f"51 row 3 hll/llf walls 40x36x32 {dtype}",
              rel_l2(got, mhd_3d_ghosted_update(params, U, dt)), TOL_STEP1[dtype])

        for ini, topo, rank, (face, corner) in ((DEBUG_INI, (2, 1, 1), (0, 0, 1), ("llf", "hllf")),
                                                (STRAT_MPI_INI, (1, 1, 2), (1, 0, 0),
                                                 ("hll", "hlla"))):
            _p, _c, lp, W, x0, _z0, gz = window_case36(ini, (32, 64, 32), topo, rank, dtype, 51)
            lp = with_solvers(lp, face, corner)
            dt = dt_from_inv(lp, inv_dt_mhd_ghosted_shear(lp, W))
            out, planes = mhd_window(lp, W, dt, x0, gz, mhd_window.scratch(lp, W))
            want, want_p = mhd_3d_shear_window_update(lp, W, dt, x0, gz)
            label = (f"51 row 4 {face}/{corner} {'stratified ' if gz is not None else ''}"
                     f"window {lp.nx}x{lp.ny}x{lp.nz} {dtype}")
            check(label, rel_l2(out, want), TOL_STEP1[dtype])
            for c in range(5):
                check(f"{label} plane {c}", rel_l2(planes[c], want_p[c]), TOL_PLANES[dtype])

        for comp in (False, True):
            params, _config, (S2, kept), _gz = strat_setup(24, 32, 32, dtype,
                                                           seed=51 if comp else None)
            if not comp:
                S2, kept = S2[:8].contiguous(), kept[0].contiguous()
            params = params.replace(nu=4e-5, eta=1e-5, compensated=comp)
            face = kept[0] if comp else kept
            # (1 + 0.01 N(0, 1)) on the state and the kept face: the
            # initial field is uniform, which the resistive terms would
            # not change
            gen = torch.Generator(device="cuda").manual_seed(51)
            for x in (S2[:8], face):
                x *= 1 + 0.01 * torch.randn(x.shape, generator=gen, device="cuda",
                                            dtype=torch.float64).to(x.dtype)
            t = shear_t0(params, S2.dtype)
            dt = dt_from_inv(params, inv_dt_mhd_shear(params, S2[:8], face))
            slabs, zslabs = strat_slabs(params, S2, kept, t, dt)
            got, kept_got = torch.empty_like(S2), kept.clone()
            dissip_step(params, S2, got, dt, active, shear=(slabs, kept_got, zslabs))
            want, eypl, ezpl = mhd_dissipation_shear_update(params, S2, slabs, dt, zslabs)
            old = torch.stack([slabs[1, 5, ..., 0], kept[1]]) if comp else slabs[1, 5, ..., 0]
            kept_want = kept_face_resistive_ct(params, old, eypl, ezpl, dt)
            label = (f"51 stratified dissipation 24x32x32 {dtype} "
                     f"{'compensated' if comp else 'plain'}")
            if comp:
                check_equal(f"{label} state and carry", got, want)
                check_equal(f"{label} kept face and carry", kept_got, kept_want)
            else:
                check(f"{label} increment", increment_rel(got, want, S2), TOL_STEP1[dtype],
                      f", increment norm / state norm {rel_l2(want, S2):.3e}")
                check(f"{label} kept-face change", increment_rel(kept_got, kept_want, kept),
                      TOL_STEP1[dtype])


def solver_path(card: str, label: str, base, S_init, face: str, corner: str, kernel: str):
    """Orszag-Tang 256^3 f32 (phase 5's workload) with the solver pair
    through make_packed_advance_chain, staged (kernel=auto) or streamed
    (kernel=zcarry): 2 warm-up + 3 timed chunks of 10 steps with every
    launch count set to 0 before and read after (the general instance
    once a step, its CFL once a step or, streamed, once a chunk); finite
    state, divB, mass and energy as phase 5. Returns the launch counts,
    the params and the end state."""
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries_concat
    from ramsesgpu_tpu_torch.solvers.step import make_packed_advance_chain

    n, chunk, steps = 256, 10, 50
    params = with_solvers(base.replace(kernel=kernel), face, corner)
    U = make_boundaries_concat(params, S_init, interior_only=True)
    mass0 = float(U[0, 3:-3, 3:-3, 3:-3].double().sum())
    energy0 = float(U[1, 3:-3, 3:-3, 3:-3].double().sum())
    pack, advance, _unpack = make_packed_advance_chain(params, "cuda")
    t = torch.zeros((), dtype=torch.float32, device="cuda")
    expect = ({"zcarry_mhd": steps, "cfl_mhd": 5} if kernel == "zcarry"
              else {"mhd_step": steps, "cfl_mhd": steps})
    with counted_main_path(label, expect) as launches:
        S = pack(U)
        del U
        S, t, _dt = run_chunks(label, card, advance, S, t, n, chunk)
    b_over_dx = max(float(S[5].abs().max()), 1e-10) / params.dx
    divb = div_b_max(params, S)
    mass, energy = float(S[0].double().sum()), float(S[1].double().sum())
    print(f"[{label}] {steps} steps to t={float(t)!r}: max|divB|={divb:.3e} "
          f"(bound {1e-3 * b_over_dx:.3e}), mass rel {abs(mass - mass0) / abs(mass0):.3e} "
          f"(1e-5), energy rel {abs(energy - energy0) / abs(energy0):.3e} (1e-4)")
    if not bool(torch.isfinite(S).all()) or not divb < 1e-3 * b_over_dx:
        raise AssertionError(f"{label}: non-finite state or divB bound violated")
    if not (abs(mass - mass0) <= 1e-5 * abs(mass0)
            and abs(energy - energy0) <= 1e-4 * abs(energy0)):
        raise AssertionError(f"{label}: conservation bound violated")
    return launches, params, S


def phase51(card: str, n_twin: int) -> dict:
    """The solver pairs' main paths and kernels at full width (Orszag-Tang
    256^3 f32, kernel=auto and kernel=zcarry), the stratified MRI with nu
    and eta as shipped but for the mesh (128x256x128 f32, compensated: its
    ms/step and the dissipation kernel's stratified mode with its time and
    bound), and 2D Orszag-Tang with (hll, hlla) on the card against the CPU.
    Returns the new kernels-line entries' launches, times and bounds."""
    from ramsesgpu_tpu_torch.kernels.build import load_library, param_block
    from ramsesgpu_tpu_torch.kernels.cfl_mhd import cfl_mhd
    from ramsesgpu_tpu_torch.kernels.dissip_step import dissip_step
    from ramsesgpu_tpu_torch.kernels.mhd_step import mhd_step
    from ramsesgpu_tpu_torch.kernels.zcarry_mhd3d import zcarry_mhd
    from ramsesgpu_tpu_torch.solvers.dissipation import (kept_face_resistive_ct,
                                                          mhd_dissipation_shear_update)
    from ramsesgpu_tpu_torch.solvers.godunov_mhd import mhd_3d_periodic_update
    from ramsesgpu_tpu_torch.solvers.timestep import dt_from_inv

    phase51_twins()
    out = {"launches": {}, "ms": {}, "plain_ms": {}, "max_abs_err": {}, "bounds": {}}
    lib = load_library("count")
    active = torch.ones((), dtype=torch.bool, device="cuda")
    base, S_init = setup(256, "float32")
    n = 256 ** 3
    ms_step = {}
    for face, corner in SOLVER_PAIRS:
        for kernel in ("auto", "zcarry"):
            label = f"51 {face}/{corner} {kernel}"
            launches, params, S = solver_path(card, label, base, S_init, face, corner, kernel)
            key = f"{'zcarry_mhd' if kernel == 'zcarry' else 'mhd_step'}_{face}_{corner}"
            out["launches"][key] = launches["zcarry_mhd" if kernel == "zcarry" else "mhd_step"]
            dt = dt_from_inv(params, cfl_mhd(params, S))
            if kernel == "zcarry":
                Sw = torch.empty_like(S)
                out["ms"][key] = time_ms(lambda: zcarry_mhd(params, S, Sw, dt, active, fold=True),
                                         10)
            else:
                Sw, scratch = S.clone(), mhd_step.scratch(params, S)
                out["ms"][key] = time_ms(lambda: mhd_step(params, Sw, dt, active, scratch), 10)
                del scratch
            del Sw
            torch.cuda.empty_cache()
            # against the twin at n_twin^3 (256 where its memory fits, phase 6)
            St = S if n_twin == 256 else S[:, :n_twin, :n_twin, :n_twin].contiguous()
            pt = params if n_twin == 256 else block_params(params, n_twin)
            dt_t = dt_from_inv(pt, cfl_mhd(pt, St))
            if kernel == "zcarry":
                got = torch.empty_like(St)
                zcarry_mhd(pt, St, got, dt_t, active, fold=True)
            else:
                got = mhd_step(pt, St.clone(), dt_t, active, mhd_step.scratch(pt, St))
            want = mhd_3d_periodic_update(pt, St, dt_t)
            out["max_abs_err"][key] = float((got - want).abs().max())
            check(f"{label} at {n_twin}^3 f32", rel_l2(got, want), TOL_STEP1["float32"],
                  f", max abs {out['max_abs_err'][key]:.3e}")
            del got, want
            torch.cuda.empty_cache()
            out["plain_ms"][key] = time_ms(lambda: mhd_3d_periodic_update(pt, St, dt_t), 3)
            # the bound: bytes read and written once (64 B/cell), the step's
            # operations of this pair counted on a 32^3 block (and, streamed,
            # the folded CFL's)
            blk = block_params(params, 32)
            S_sub = S[:, :32, :32, :32].double().contiguous().cpu()
            ops = lib.ramses_mhd_step_ops(S_sub.data_ptr(), 0, 32, 32, 32, param_block(blk),
                                          float(dt)) / 32 ** 3 * n
            if kernel == "zcarry":
                ops += lib.ramses_cfl_mhd_ops(S_sub.data_ptr(), 32, 32, 32,
                                              param_block(blk)) / 32 ** 3 * n
            t_bytes = 2 * 8 * 4 * n / HBM_BYTES_PER_S * 1e3
            t_ops = ops / F32_FLOP_PER_S * 1e3
            out["bounds"][key] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
                                  "operations")
            ms, (bound_ms, by) = out["ms"][key], out["bounds"][key]
            print(f"[{label}] kernel {ms:.4f} ms at 256^3 f32, bound {bound_ms:.4f} ms by {by} "
                  f"({ops / n:.1f} flop/cell; bytes {t_bytes:.4f} ms), {ms / bound_ms:.1f}x; "
                  f"twin {out['plain_ms'][key]:.3f} ms at {n_twin}^3 ({card})")
            del S, St
            torch.cuda.empty_cache()
    del S_init
    torch.cuda.empty_cache()

    # the stratified MRI with nu and eta as shipped (compensated) at
    # 128x256x128. Its init leaves cells at the density floor with
    # supersonic velocities (ROADMAP Queue 3 item 8), where the explicit
    # viscous stress (rho_f nu grad v, rho_f of the face) acts as a
    # kinematic viscosity ~1e4 nu; with scripts/perf_table.py's nu = 4e-5,
    # eta = 1e-5 (and with 4e-6, 1e-6) the box leaves rho > 0 or goes NaN
    # within 20 steps (PERF.md section 6), so this cell takes a hundredth of
    # those
    launches, (params, S, kept, t, _config) = phase13(
        card, "51s", *STRAT_DISSIP_COEFFS, compensated=None, ini=STRAT_INI)
    name, size = "dissip_step_strat", f"{params.nx}x{params.ny}x{params.nz}"
    out["launches"][name] = launches["dissip_step"]
    face = kept[0] if params.compensated else kept
    dt = dt_from_inv(params, cfl_mhd(params, S, kept=kept))
    slabs, zslabs = strat_slabs(params, S, kept, t, dt)
    got, kept_got = torch.empty_like(S), kept.clone()
    dissip_step(params, S, got, dt, active, shear=(slabs, kept_got, zslabs))
    Sw, kw = torch.empty_like(S), kept.clone()
    out["ms"][name] = time_ms(
        lambda: dissip_step(params, S, Sw, dt, active, shear=(slabs, kw, zslabs)), 10)
    del Sw, kw

    def twin():
        S_new, eypl, ezpl = mhd_dissipation_shear_update(params, S, slabs, dt, zslabs)
        old = torch.stack([slabs[1, 5, ..., 0], kept[1]]) if params.compensated else face
        return S_new, kept_face_resistive_ct(params, old, eypl, ezpl, dt)

    want, kept_want = twin()
    out["max_abs_err"][name] = max(float((got - want).abs().max()),
                                   float((kept_got - kept_want).abs().max()))
    check_equal(f"51s {name} {size} f32 compensated state and carry", got, want)
    check_equal(f"51s {name} {size} f32 kept face and carry", kept_got, kept_want)
    del got, want
    torch.cuda.empty_cache()
    out["plain_ms"][name] = time_ms(twin, 3)
    # the bound: the shear mode's bytes (dissip_bytes) and the z slab rows
    # its stencil reaches (2 a side); the operations counted on an
    # nx x 32 x nz block (the stratified rows in z), scaled to ny
    iso, visc, resist = params.c_iso > 0, params.nu > 0, params.eta > 0
    read = 4 * visc + 3 * resist + (not iso)
    nbytes = dissip_bytes(params, True) + 4 * 2 * 2 * read * params.nx * params.ny
    by = 32
    blk = params.replace(ny=by, ymax=params.ymin + by * params.dy)
    shear_mode = torch.zeros(1, dtype=torch.float64)  # (a non-null slab pointer: the shear mode)
    ops = lib.ramses_dissip_step_ops(None, shear_mode.data_ptr(), 1, params.nx, by, params.nz,
                                     param_block(blk), float(dt)) * params.ny / by
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOP_PER_S * 1e3
    out["bounds"][name] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
    cells = params.nx * params.ny * params.nz
    print(f"[51s] {name} at {size} f32 (compensated): {nbytes / cells:.1f} B/cell -> "
          f"{t_bytes:.5f} ms; {ops / cells:.1f} flop/cell -> {t_ops:.5f} ms: bound "
          f"{out['bounds'][name][0]:.5f} ms by {out['bounds'][name][1]}; kernel "
          f"{out['ms'][name]:.4f} ms ({out['ms'][name] / out['bounds'][name][0]:.1f}x), twin "
          f"{out['plain_ms'][name]:.3f} ms ({card})")
    del S, kept, slabs, zslabs
    torch.cuda.empty_cache()

    # 2D: the whole-array step with (hll, hlla), card against CPU
    from ramsesgpu_tpu_torch.config.configmap import ConfigMap
    from ramsesgpu_tpu_torch.config.params import params_from_config
    from ramsesgpu_tpu_torch.problems import init_problem
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries
    from ramsesgpu_tpu_torch.solvers.step import make_advance_n

    config = ConfigMap(Path("data/orszag-tang.ini"))
    for axis in ("nx", "ny"):
        config.set_integer("mesh", axis, 64)
    config.set_string("implementation", "dtype", "float64")
    config.set_string("hydro", "riemannSolver", "hll")
    config.set_string("MHD", "magRiemannSolver", "hlla")
    params = params_from_config(config)
    U = make_boundaries(params, torch.from_numpy(init_problem(params, config)).cuda())
    t0 = torch.zeros((), dtype=U.dtype, device="cuda")
    U_gpu, t_gpu, k_gpu = make_advance_n(params, "cuda", config)(U, t0, 10)
    U_cpu, t_cpu, k_cpu = make_advance_n(params, "cpu", config)(U.cpu(), t0.cpu(), 10)
    rel = rel_l2(U_gpu.cpu(), U_cpu)
    print(f"[51 2D] Orszag-Tang 64^2 f64 hll/hlla, 10 steps, card vs CPU: relative L2 "
          f"{rel:.3e} (tol 1e-12), t {float(t_gpu):.6e} vs {float(t_cpu):.6e}")
    if not (int(k_gpu) == int(k_cpu) == 10 and rel <= 1e-12
            and abs(float(t_gpu) - float(t_cpu)) <= 1e-12 * float(t_cpu)):
        raise AssertionError(f"51 2D: k {int(k_gpu)}/{int(k_cpu)}, rel {rel}")
    return out


# ---------------------------------------------------------------------------
# checkpoint / restart and the numerics guard: phase 52
# ---------------------------------------------------------------------------
# steps between the checkpoints of phase 52's runs; the shipped restart input
# reads noutput=10, so its run from step 5 is one chunk of 5, as the straight
# run's second chunk is
N52 = 5
# the compensated MRI's resumed-vs-straight relative L2 (the Kahan carry a
# checkpoint does not hold), tests/test_torch_restart_io.py COMP_RESUME_L2
COMP_RESUME_L2 = 1e-6
RESTART_INI = "data/mhd_mri_3d_stratified_restart.ini"
IMPLODE_DEBUG_INI = "data/implode3d_debug.ini"


def ini_with(text: str, section: str, **kv) -> str:
    """The INI text with the keys of ``section`` set (replaced, else added)."""
    for k in kv:
        text = re.sub(rf"^{k}=.*\n", "", text, flags=re.M)
    lines = "".join(f"{k}={v}\n" for k, v in kv.items())
    if f"[{section}]\n" in text:
        return text.replace(f"[{section}]\n", f"[{section}]\n{lines}", 1)
    return text + f"\n[{section}]\n{lines}"


def resumed_case(label: str, text: str, card: str, timed: bool = False) -> dict:
    """The run of ``text`` on the card for 2 N52 steps writing NetCDF
    checkpoints (ghostIncluded) at N52 and 2 N52, then a fresh Run restarted
    from the step-N52 file (beside the OU forcing state's) for N52 steps:
    whether its interior, t and step are the step-2 N52 file's bitwise, and
    their relative L2; with ``timed`` the checkpoint's bytes and the ms of
    its write and read (host clock, the state already on the host) and of
    the copy from the card."""
    import shutil
    import tempfile

    from ramsesgpu_tpu_torch.io.netcdf import input_netcdf, output_netcdf
    from ramsesgpu_tpu_torch.solvers.run import Run, config_from_ini

    with tempfile.TemporaryDirectory(prefix="smoke52_") as tmp:
        a, b = Path(tmp) / "straight", Path(tmp) / "resumed"
        b.mkdir(parents=True)
        base = ini_with(text, "run", noutput=N52, nstepmax=2 * N52)
        base = ini_with(base, "output", outputDir=a, outputPrefix="ck", outputVtk="no",
                        outputHdf5="no", outputNetcdf="yes", ghostIncluded="yes")
        config, params = config_from_ini(base)
        Run(config, "cuda", params).start()
        for f in a.glob(f"ck_forcing_{N52:07d}.npz"):
            shutil.copy(f, b)
        resumed = ini_with(base, "run", restart="yes", restart_filename=a / f"ck_{N52:07d}.nc")
        config, _ = config_from_ini(ini_with(resumed, "output", outputDir=b, outputNetcdf="no"))
        run = Run(config, "cuda", params)
        if run.n_step != N52:
            raise AssertionError(f"{label}: restarted at step {run.n_step}, expected {N52}")
        run.start()
        U, t, step = input_netcdf(params, a / f"ck_{2 * N52:07d}.nc")
        g = params.ghost_width
        want = torch.from_numpy(U[(slice(None),) + (slice(g, -g),) * params.dim])
        got = torch.from_numpy(run.interior())
        out = {"bitwise": bool(torch.equal(got, want)) and run.t == t
               and run.n_step == step == 2 * N52, "rel_l2": rel_l2(got, want), "t": (run.t, t)}
        if timed:
            t0 = time.perf_counter()
            U_host = run.U.cpu().numpy()
            out["copy_ms"] = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            output_netcdf(params, U_host, step, str(b / "timed.nc"), total_time=t,
                          ghost_included=True)
            out["write_ms"] = (time.perf_counter() - t0) * 1e3
            out["bytes"] = (b / "timed.nc").stat().st_size
            t0 = time.perf_counter()
            input_netcdf(params, b / "timed.nc")
            out["read_ms"] = (time.perf_counter() - t0) * 1e3
    print(f"[{label}] {params.nx}x{params.ny}x{params.nz} {params.dtype} on {card}: resumed at "
          f"step {N52} and run to {2 * N52}: bitwise {out['bitwise']}, relative L2 "
          f"{out['rel_l2']:.3e}, t {out['t'][0]!r} vs {out['t'][1]!r}"
          + ("" if not timed else f"; checkpoint {out['bytes']} bytes, copy from the card "
             f"{out['copy_ms']:.1f} ms, write {out['write_ms']:.1f} ms, read "
             f"{out['read_ms']:.1f} ms (host clock, warm page cache)"))
    return out


def phase52a(card: str) -> None:
    """Restart continuity on the card: OT 256^3 f32 at the bench.py INI
    (kernel=auto, timed, and kernel=zcarry), the MRI at 128x256x128 with
    compensated=no, turbulence_mhd_ou.ini as shipped: each resumed run
    bitwise the straight one; the MRI as shipped (compensated) within
    COMP_RESUME_L2."""
    ot = INI.format(n=256, dtype="float32")
    mri = Path(MRI_INI).read_text().replace("nx=16\nny=32\nnz=16", "nx=128\nny=256\nnz=128")
    if "nx=128\nny=256\nnz=128" not in mri or "compensated=yes" not in mri:
        raise AssertionError(f"{MRI_INI}: unexpected mesh or compensated key")
    cases = [("52a OT", ot, True), ("52a OT kernel=zcarry", ini_with(
        ot, "implementation", kernel="zcarry"), False),
        ("52a MRI", mri.replace("compensated=yes", "compensated=no"), False),
        ("52a turbulence_mhd_ou.ini", Path(TURB["turbulence_mhd_ou"]).read_text(), False)]
    for label, text, timed in cases:
        torch.cuda.empty_cache()
        if not resumed_case(label, text, card, timed)["bitwise"]:
            raise AssertionError(f"{label}: the resumed run is not the straight run bitwise")
    out = resumed_case("52a MRI as shipped (compensated)", mri, card)
    if not 0 < out["rel_l2"] <= COMP_RESUME_L2:
        raise AssertionError(f"52a compensated MRI: resumed vs straight {out['rel_l2']:.3e}, "
                             f"bound {COMP_RESUME_L2}")


def phase52b(card: str) -> None:
    """data/implode3d_debug.ini as shipped through the CLI on the card (the
    guard after each of its 5 one-step chunks, a VTK snapshot a step); a
    NaN and, separately, a negative density planted in the 256^3 OT state:
    check_finite on the card raises the CPU's NumericsError text; the
    device ms of one check_finite at 256^3 (CUDA events, its host read
    included)."""
    import os
    import tempfile

    from ramsesgpu_tpu_torch.cli.main import main as cli_main
    from ramsesgpu_tpu_torch.convert import torch_dtype
    from ramsesgpu_tpu_torch.io.vtk import read_vti
    from ramsesgpu_tpu_torch.problems import init_problem
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries
    from ramsesgpu_tpu_torch.solvers.run import config_from_ini
    from ramsesgpu_tpu_torch.utils.guard import NumericsError, check_finite, failure_message

    cwd = os.getcwd()
    path = Path(IMPLODE_DEBUG_INI).resolve()
    with tempfile.TemporaryDirectory(prefix="smoke52b_") as workdir:
        os.chdir(workdir)
        try:
            with counted_main_path("52b implode3d_debug.ini", {"hydro_step": 5, "cfl_hydro": 5}):
                rc = cli_main(["--param", str(path)])
        finally:
            os.chdir(cwd)
        written = sorted(p.name for p in Path(workdir).iterdir())
        rho = read_vti(Path(workdir) / written[-1])[0]["density"]
    if rc != 0 or written != [f"implode3d_gpu_v2_{k:07d}.vti" for k in range(6)]:
        raise AssertionError(f"52b implode3d_debug.ini: rc {rc}, files {written}")
    if not (math.isfinite(float(rho.min())) and float(rho.min()) > 0):
        raise AssertionError("52b implode3d_debug.ini: density not finite and positive")
    print(f"[52b] implode3d_debug.ini as shipped on {card}: 5 steps, guard after each, "
          f"files {written}")

    config, params = config_from_ini(INI.format(n=256, dtype="float32"))
    U = make_boundaries(params, torch.from_numpy(init_problem(params, config)).to(
        "cuda", torch_dtype(params)))
    g = params.ghost_width
    ms = time_ms(lambda: check_finite(params, U, 41), 10)
    for kind, value, where in (("nonfinite", float("nan"), (3, 100, 37, 201)),
                               ("density", -1.0, (0, 57, 140, 9))):
        bad = U.clone()
        bad[where] = value
        texts = []
        for state in (bad, bad.cpu()):
            try:
                check_finite(params, state, 41)
            except NumericsError as exc:
                texts.append(str(exc))
        cell = (where[0],) + tuple(i - g for i in where[1:])
        want = failure_message(kind, cell if kind == "nonfinite" else cell[1:], 41)
        print(f"[52b] planted {kind} at {where}: card {texts[:1]}, CPU {texts[1:]}")
        if texts != [want, want]:
            raise AssertionError(f"52b {kind}: {texts}, expected {want!r} twice")
    print(f"[52b] check_finite at 256^3 f32 (one reduction, one host read): {ms:.3f} ms "
          f"({card})")


def rank52(workdir: str, restart_ini: str) -> dict:
    """One rank of phase 52c (a spawned process): in ``workdir``, the
    straight sharded run (straight.ini, the CLI's main()), rank 0 copying
    its step-N52 checkpoint to the name the restart input reads, then the
    restart input as shipped through main() capped at N52 + 1 (its first
    restarted step, timed) and at 2 N52; the last run's gathered state."""
    import os
    import shutil

    import torch.distributed as dist

    from ramsesgpu_tpu_torch.cli.main import main
    from ramsesgpu_tpu_torch.solvers.run_distributed import DistributedRun

    os.chdir(workdir)
    runs, walls = [], []
    start = DistributedRun.start

    def kept_start(self, *args, **kw):
        runs.append(self)
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        start(self, *args, **kw)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)

    DistributedRun.start = kept_start
    try:
        rcs = [main(["--param", "straight.ini"])]
        if dist.get_rank() == 0:
            shutil.copy(f"mhd_mri_3d_stratified_mpi_{N52:07d}.nc",
                        "mhd_mri_3d_stratified_mpi_0005000.nc")
        dist.barrier()
        for cap in (N52 + 1, 2 * N52):
            rcs.append(main(["--param", restart_ini, "--max-steps", str(cap)]))
    finally:
        DistributedRun.start = start
    run = runs[-1]
    return {"rank": run.grid.rank, "rcs": rcs, "steps": [r.n_step for r in runs],
            "first_step_ms": walls[1] * 1e3, "t": run.t, "U": run.interior(),
            "transport": run.grid.describe()}


def phase52c(card: str) -> None:
    """The shipped restart input on 4 ranks sharing the card: the port's
    sharded run of mhd_mri_3d_stratified_mpi.ini with outputNetcdf=yes,
    noutput=N52, nstepmax=2 N52 writes the checkpoints; the restart input
    as shipped from the step-N52 one, capped at 2 N52 (both drivers cap
    the total step count): its gathered interior, t and step are the
    straight run's step-2 N52 file's bitwise."""
    import tempfile

    from ramsesgpu_tpu_torch.io.netcdf import input_netcdf
    from ramsesgpu_tpu_torch.parallel.launch import spawn_ranks

    text = ini_with(Path(STRAT_MPI_INI).read_text(), "run", noutput=N52, nstepmax=2 * N52)
    text = ini_with(text, "output", outputNetcdf="yes", outputVtk="no")
    params = params_from_text(text)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="smoke52c_") as workdir:
        (Path(workdir) / "straight.ini").write_text(text)
        ranks = spawn_ranks(rank52, 4, (workdir, str(Path(RESTART_INI).resolve())))
        U, t, step = input_netcdf(params, Path(workdir) /
                                  f"mhd_mri_3d_stratified_mpi_{2 * N52:07d}.nc")
        written = sorted(p.name for p in Path(workdir).iterdir())
    r0 = ranks[0]
    g = params.ghost_width
    got, want = torch.from_numpy(r0["U"]), torch.from_numpy(U[:, g:-g, g:-g, g:-g])
    first = max(r["first_step_ms"] for r in ranks)
    print(f"[52c] {RESTART_INI} as shipped on {card}, {r0['transport']}: steps "
          f"{r0['steps']} (straight, first restarted step, restart to {2 * N52}), t "
          f"{r0['t']!r} vs {t!r}, relative L2 {rel_l2(got, want):.3e}, files {written}; first "
          f"restarted step {first:.1f} ms (start() of one step, host clock, slowest rank)")
    if any(r["rcs"] != [0, 0, 0] or r["steps"] != [2 * N52, N52 + 1, 2 * N52] for r in ranks):
        raise AssertionError(f"52c: {[(r['rcs'], r['steps']) for r in ranks]}")
    if not (torch.equal(got, want) and r0["t"] == t and step == 2 * N52):
        raise AssertionError("52c: the restarted sharded run is not the straight run bitwise")


# ---------------------------------------------------------------------------
# 53: the other schemes, the analysis tools, the profiler and the planner
# ---------------------------------------------------------------------------
SOD2D_INI = "data/hydro_sod2d.ini"
IMPLODE2D_INI = "data/implode2d.ini"
IMPLODE3D_INI = "data/implode3d.ini"
OT_MPI_INI = "data/orszag-tang_mpi.ini"
ALT_2D = ("godunov-split", "kurganov", "laxliu", "relaxingTVD")
ALT_3D = ("godunov-split", "relaxingTVD")
MASS_ALT_TOL = 1e-5   # f32, walled boxes (the CPU's 64^2 / 32^3 runs: 1e-9)
SF_SHARDED_TOL = 1e-6  # f32 means, each rounded once from float64 sums
SF_CPU_SAMPLES = 200   # the card-vs-CPU check of 53b (the CPU's share of the phase's time)
MEM_TOL = 0.10
PROFILE_PHASES = ("dt reduction", "boundary fill", "godunov update", "full fused step")


def quiet(fn):
    """fn() with its standard output dropped (the runs' perf reports)."""
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        return fn()


def alt_text(path: str, mesh: dict, dtype: str) -> str:
    return ini_with(ini_with(Path(path).read_text(), "mesh", **mesh), "implementation",
                    dtype=dtype)


def hydro_gates(params, U: torch.Tensor) -> tuple:
    """(mass, min rho, min p, finite) of a ghosted hydro state's interior."""
    g = params.ghost_width
    S = U[(slice(None),) + (slice(g, -g),) * params.dim].double()
    p = (params.gamma0 - 1.0) * (S[1] - 0.5 * (S[2:] ** 2).sum(0) / S[0])
    return (float(S[0].sum()), float(S[0].min()), float(p.min()), bool(torch.isfinite(S).all()))


def timed_alt(label: str, text: str, scheme: str, card: str, steps: int, warm: int = 2) -> None:
    """AltSchemeRun of ``scheme`` on the card: ``warm`` steps, then ``steps``
    timed by the host clock (one host read a step, as the loop makes);
    ms/step, cells/s, peak memory; finite, rho, p > 0, mass."""
    from ramsesgpu_tpu_torch.config.configmap import ConfigMap
    from ramsesgpu_tpu_torch.solvers.run2d_alt import AltSchemeRun

    torch.cuda.empty_cache()
    run = AltSchemeRun(ConfigMap(text=text), "cuda", scheme)
    p = run.params
    mass0 = hydro_gates(p, run.U)[0]
    quiet(lambda: run.start(max_steps=warm, do_output=False))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    quiet(lambda: run.start(max_steps=warm + steps, do_output=False))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cells = p.nx * p.ny * (p.nz if p.dim == 3 else 1)
    mass, rho_min, p_min, finite = hydro_gates(p, run.U)
    dm = abs(mass - mass0) / mass0
    print(f"[{label}] {scheme} {'x'.join(str(n) for n in (p.nx, p.ny, p.nz)[:p.dim])} "
          f"{p.dtype} on {card}: {wall * 1e3 / steps:.3f} ms/step, "
          f"{cells * steps / wall:.4e} cells/s ({steps} steps after {warm}, host clock), peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; min rho {rho_min:.4e}, min p "
          f"{p_min:.4e}, mass rel {dm:.3e}")
    if not (finite and rho_min > 0 and p_min > 0 and dm <= MASS_ALT_TOL
            and run.n_step == warm + steps):
        raise AssertionError(f"{label} {scheme}: gates failed")


def phase53a(card: str) -> None:
    """The alternative schemes on the card: each against the CPU at 128^2
    in f64 (10 steps, relative L2 1e-12), then timed in f32: the four 2D
    schemes at 1024^2 (scripts/perf_table.py's 2D row size), godunov-split
    and relaxing TVD on data/implode3d.ini at 256^3."""
    from ramsesgpu_tpu_torch.config.configmap import ConfigMap
    from ramsesgpu_tpu_torch.solvers.run2d_alt import AltSchemeRun

    text = alt_text(SOD2D_INI, dict(nx=128, ny=128), "float64")
    for scheme in ALT_2D:
        runs = [AltSchemeRun(ConfigMap(text=text), dev, scheme) for dev in ("cuda", "cpu")]
        for run in runs:
            quiet(lambda: run.start(max_steps=10, do_output=False))
        gpu, cpu = runs
        err = rel_l2(gpu.U.cpu(), cpu.U)
        print(f"[53a] {scheme} 128^2 f64, 10 steps: card vs CPU relative L2 {err:.3e}, t "
              f"{gpu.t!r} vs {cpu.t!r}")
        if not (gpu.n_step == cpu.n_step == 10 and abs(gpu.t - cpu.t) <= 1e-12 * cpu.t
                and err <= 1e-12 and bool(torch.isfinite(gpu.U).all())):
            raise AssertionError(f"53a {scheme}: the card disagrees with the CPU")
    text = alt_text(SOD2D_INI, dict(nx=1024, ny=1024), "float32")
    for scheme in ALT_2D:
        timed_alt("53a", text, scheme, card, steps=20)
    text = alt_text(IMPLODE3D_INI, dict(nx=256, ny=256, nz=256), "float32")
    for scheme in ALT_3D:
        timed_alt("53a", text, scheme, card, steps=5, warm=1)


def sf_gates(label: str, result: dict, n_samples: int, cells: int, max_q: int) -> None:
    import numpy as np

    counts = result["counts"]
    ok = (float(counts.sum()) == n_samples * cells and result["sf_long"].shape[:2] == (3, max_q)
          and float(abs(result["sf_long"][:, :, 0]).max()) == 0.0
          and float(abs(result["sf_tran"][:, :, 0]).max()) == 0.0
          and all(bool(np.isfinite(result[k]).all()) for k in ("sf_long", "sf_tran")))
    if not ok:
        raise AssertionError(f"{label}: structure-function gates failed")


def phase53b(card: str) -> None:
    """The structure functions' on-line hook: data/turbulence_mhd.ini at
    256^3 f32 with [structureFunctions] enabled as shipped (1000 samples,
    max_q 6), 10 forced steps through Run, then Run.output (the hook at
    step 10, timed); the counts, the zero-distance bin, finite values; then
    the function at 32^3 in f64 (SF_CPU_SAMPLES samples), card against
    CPU."""
    import tempfile

    import numpy as np

    from ramsesgpu_tpu_torch.analysis.structure_functions import compute_structure_functions
    from ramsesgpu_tpu_torch.solvers import run as run_mod
    from ramsesgpu_tpu_torch.solvers.run import Run, config_from_ini

    hook, times = run_mod.structure_functions_online, []

    def timed(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = hook(*args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return path

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="smoke53b_") as tmp:
        text = ini_with(Path(TURB["turbulence_mhd"]).read_text(), "mesh", nx=256, ny=256, nz=256)
        text = ini_with(text, "run", noutput=10, nstepmax=10)
        text = ini_with(text, "output", outputDir=tmp, outputHdf5="no", outputVtk="no")
        text = ini_with(text, "structureFunctions", enabled="yes")
        config, params = config_from_ini(text)
        n_samples = config.get_integer("structureFunctions", "nSampleTotal", 1000)
        max_q = config.get_integer("structureFunctions", "max_q", 5)
        run_mod.structure_functions_online = timed
        try:
            run = Run(config, "cuda", params)
            t0 = time.perf_counter()
            quiet(lambda: run.start(do_output=False))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            run.output()
        finally:
            run_mod.structure_functions_online = hook
        result = dict(np.load(Path(tmp) / "turbulence_mhd_cpu_sf_0000010.npz"))
        written = sorted(p.name for p in Path(tmp).iterdir())
    sf_gates("53b", result, n_samples, 256 ** 3, max_q)
    print(f"[53b] turbulence_mhd.ini 256^3 f32, {n_samples} samples, max_q {max_q} on {card}: "
          f"the hook {times[0]:.3f} s ({times[0] / n_samples * 1e3:.2f} ms a sample point; "
          f"host clock), the 10 forced steps {wall:.2f} s; files {written}; sf_long(v, q=2) "
          f"over the first bins {[float(f'{x:.4e}') for x in result['sf_long'][0, 1, 1:6]]}")
    if len(times) != 1 or run.n_step != 10:
        raise AssertionError(f"53b: the hook ran {len(times)} times after {run.n_step} steps")
    config, params = config_from_ini(ini_with(ini_with(Path(TURB["turbulence_mhd"]).read_text(),
                                                       "implementation", dtype="float64"),
                                              "structureFunctions", enabled="yes"))
    U = ghosted_state(config, params)
    n_samples = SF_CPU_SAMPLES
    got = compute_structure_functions(params, U, n_samples, max_q)
    want = compute_structure_functions(params, U.cpu(), n_samples, max_q)
    errs = [rel_l2(torch.from_numpy(got[k]), torch.from_numpy(want[k]))
            for k in ("sf_long", "sf_tran")]
    print(f"[53b] 32^3 f64, {n_samples} samples, max_q {max_q}: card vs CPU relative L2 "
          f"{errs[0]:.3e} (long), {errs[1]:.3e} (transverse), counts equal "
          f"{bool(np.array_equal(got['counts'], want['counts']))}")
    sf_gates("53b 32^3", got, n_samples, 32 ** 3, max_q)
    if not (max(errs) <= 1e-12 and np.array_equal(got["counts"], want["counts"])):
        raise AssertionError("53b: the card's structure functions disagree with the CPU's")


def rank53c(text: str, workdir: str, profile_argv: list) -> dict:
    """One rank of phase 53c: a DistributedRun of ``text`` on the card and
    its output at step 0 (the sharded structure functions; rank 0 writes),
    then the CLI's main(profile_argv) (--profile of an [mpi] input) in the
    same world, its standard output."""
    import io
    import os

    from ramsesgpu_tpu_torch.cli.main import main
    from ramsesgpu_tpu_torch.config.configmap import ConfigMap
    from ramsesgpu_tpu_torch.solvers.run_distributed import DistributedRun

    os.chdir(workdir)
    run = DistributedRun(ConfigMap(text=text), "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run.output()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(profile_argv)
    return {"rank": run.grid.rank, "s": seconds, "transport": run.grid.describe(),
            "profile": buf.getvalue()}


def phase53c(card: str) -> str:
    """data/turbulence_mhd_mpi.ini with the structure functions enabled on
    its 4 ranks (gloo, sharing the card): the file rank 0 writes against
    the single device's function of the same global state (distances and
    counts bitwise, the f32 means within SF_SHARDED_TOL). The same world
    then runs --profile of data/orszag-tang_mpi.ini (2x2): rank 0's output
    is returned (phase 53e)."""
    import tempfile

    import numpy as np

    from ramsesgpu_tpu_torch.analysis.structure_functions import compute_structure_functions
    from ramsesgpu_tpu_torch.parallel.launch import spawn_ranks
    from ramsesgpu_tpu_torch.solvers.run import config_from_ini

    text = ini_with(Path(TURB_MPI_INIS[1]).read_text(), "structureFunctions", enabled="yes")
    text = ini_with(text, "output", outputHdf5="no", outputVtk="no")
    config, params = config_from_ini(text)
    n_samples = config.get_integer("structureFunctions", "nSampleTotal", 1000)
    max_q = config.get_integer("structureFunctions", "max_q", 5)
    prefix = config.get_string("output", "outputPrefix", "output")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="smoke53c_") as workdir:
        ranks = spawn_ranks(rank53c, 4, (text, workdir, [
            "--param", str(Path(OT_MPI_INI).resolve()), "--profile"]))
        got = dict(np.load(Path(workdir) / f"{prefix}_sf_0000000.npz"))
    want = compute_structure_functions(params, ghosted_state(config, params), n_samples, max_q)
    errs = [rel_l2(torch.from_numpy(got[k]), torch.from_numpy(want[k]))
            for k in ("sf_long", "sf_tran")]
    print(f"[53c] {TURB_MPI_INIS[1]} {params.nx}x{params.ny}x{params.nz} f32 on 4 ranks "
          f"({ranks[0]['transport']}) on {card}: sharded vs single device relative L2 "
          f"{errs[0]:.3e} / {errs[1]:.3e} (<= {SF_SHARDED_TOL}); the output's time "
          f"{max(r['s'] for r in ranks):.3f} s (slowest rank)")
    sf_gates("53c", got, n_samples, params.nx * params.ny * params.nz, max_q)
    if not (max(errs) <= SF_SHARDED_TOL and np.array_equal(got["counts"], want["counts"])
            and np.array_equal(got["distance"], want["distance"])):
        raise AssertionError("53c: the sharded structure functions disagree with one device's")
    if any(r["profile"] for r in ranks[1:]):
        raise AssertionError("53c: a rank other than 0 printed the profile")
    return ranks[0]["profile"]


def phase53d(card: str) -> None:
    """The power spectrum of a seeded 256^3 f64 field on the card against
    the CPU (bins bitwise, relative L2 1e-12), timed; the fBm slope at
    512^2."""
    import numpy as np

    from ramsesgpu_tpu_torch.analysis.generate_fbm import generate_fbm
    from ramsesgpu_tpu_torch.analysis.power_spectrum import power_spectrum

    gen = torch.Generator().manual_seed(53)
    field = torch.randn((256, 256, 256), generator=gen, dtype=torch.float64)
    on_card = field.cuda()
    k, ek = power_spectrum(on_card)
    ms = min(time_ms(lambda: power_spectrum(on_card), 1) for _ in range(3))
    k_cpu, ek_cpu = power_spectrum(field)
    err = rel_l2(torch.from_numpy(ek), torch.from_numpy(ek_cpu))
    k2, ek2 = power_spectrum(torch.from_numpy(generate_fbm((512, 512), hurst=0.5, seed=1)).cuda())
    sel = (k2 >= 4) & (k2 <= 32) & (ek2 > 0)
    slope = float(np.polyfit(np.log(k2[sel]), np.log(ek2[sel]), 1)[0])
    print(f"[53d] power spectrum 256^3 f64 on {card}: {ms:.2f} ms a call (CUDA events, the host "
          f"read of E(k) included), card vs CPU relative L2 {err:.3e}; fBm H=0.5 at 512^2: "
          f"slope {slope:.3f} (expected ~ -2, -2.6 .. -1.4)")
    if not (np.array_equal(k, k_cpu) and err <= 1e-12 and -2.6 < slope < -1.4):
        raise AssertionError("53d: the power spectrum gates failed")


def phase53e(card: str, peak31: float, mpi_profile: str) -> None:
    """--profile on the bench.py workload at 256^3 (one device) and, from
    phase 53c's world, on data/orszag-tang_mpi.ini (4 ranks sharing the
    card); the memory planner's estimates against
    torch.cuda.max_memory_allocated for one chunk of that workload with
    kernel=auto and kernel=zcarry (within MEM_TOL), and its 512^3
    kernel=zcarry estimate beside phase 31's peak."""
    import io
    import tempfile

    from ramsesgpu_tpu_torch.cli.main import main
    from ramsesgpu_tpu_torch.solvers.step import make_packed_advance_chain
    from ramsesgpu_tpu_torch.utils.memory_footprint import estimate

    with tempfile.TemporaryDirectory(prefix="smoke53e_") as tmp:
        path = Path(tmp) / "ot256.ini"
        path.write_text(INI.format(n=256, dtype="float32"))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(["--param", str(path), "--profile"])
        single = buf.getvalue()
    print(f"[53e] --profile of the bench.py workload 256^3 f32 on {card}:\n{single}")
    print(f"[53e] --profile of {OT_MPI_INI} on 4 ranks sharing {card}:\n{mpi_profile}")
    if not (all(name in single for name in PROFILE_PHASES)
            and all(name in mpi_profile for name in ("halo exchange", "sync step",
                                                     "not supported for this configuration"))):
        raise AssertionError("53e: --profile does not print the JAX phase names")
    for kernel, key in (("auto", "staged_GiB"), ("zcarry", "zcarry_GiB")):
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        params, S = setup(256, "float32")
        params = params.replace(kernel=kernel)
        _pack, advance, _unpack = make_packed_advance_chain(params, "cuda")
        advance(S, torch.zeros((), device="cuda"), 2)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        est = estimate(params)[key] * 1024 ** 3
        print(f"[53e] planner, OT 256^3 f32 kernel={kernel}: estimate {est / 1e9:.3f} GB, "
              f"measured peak {peak / 1e9:.3f} GB (max_memory_allocated over the chunk, the "
              f"state included): {est / peak:.3f}x ({card})")
        del S, advance
        if abs(est - peak) > MEM_TOL * peak:
            raise AssertionError(f"53e: the planner's {key} is off by more than {MEM_TOL:.0%}")
    params = params_from_text(INI.format(n=512, dtype="float32")).replace(kernel="zcarry")
    est512 = estimate(params)["zcarry_GiB"] * 1024 ** 3
    print(f"[53e] planner, OT 512^3 f32 kernel=zcarry: estimate {est512 / 1e9:.3f} GB, phase "
          f"31's measured peak {peak31 / 1e9:.3f} GB: {est512 / peak31:.3f}x")
    if abs(est512 - peak31) > MEM_TOL * peak31:
        raise AssertionError("53e: the planner disagrees with phase 31's peak")


def phase53f(card: str) -> None:
    """The live view's frames of a 2D run on the card (matplotlib where it
    imports; the CPU tests cover it either way)."""
    import importlib.util
    import tempfile

    if importlib.util.find_spec("matplotlib") is None:
        print("[53f] matplotlib does not import on this machine: the live view is covered by "
              "the CPU tests (tests/test_torch_analysis.py)")
        return
    import os

    from ramsesgpu_tpu_torch.gui.live_view import main

    text = alt_text(SOD2D_INI, dict(nx=128, ny=128), "float32")
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="smoke53f_") as tmp:
        (Path(tmp) / "sod.ini").write_text(text)
        os.chdir(tmp)
        try:
            quiet(lambda: main(["--param", "sod.ini", "--frames", "--steps", "20", "--interval",
                                "10", "--device", "cuda"]))
        finally:
            os.chdir(cwd)
        frames = sorted(p.name for p in Path(tmp).glob("frame_*.png"))
    print(f"[53f] live view of hydro_sod2d.ini 128^2 on {card}: frames {frames}")
    if frames != ["frame_00000.png", "frame_00001.png"]:
        raise AssertionError("53f: the live view did not write its frames")


def phase53g(card: str) -> None:
    """[implementation] compensated=yes on 3D hydro (data/implode3d.ini at
    256^3 f32, 10 steps of make_packed_advance_chain) and in 2D
    (data/implode2d.ini as shipped, 10 steps of make_advance_n) on the
    card: bitwise the compensated=no run."""
    from ramsesgpu_tpu_torch.solvers.run import config_from_ini
    from ramsesgpu_tpu_torch.solvers.step import make_advance_n, make_packed_advance_chain

    for label, path, mesh in (("3D", IMPLODE3D_INI, dict(nx=256, ny=256, nz=256)),
                              ("2D", IMPLODE2D_INI, {})):
        ends = []
        for comp in ("no", "yes"):
            torch.cuda.empty_cache()
            text = alt_text(path, mesh, "float32") if mesh else Path(path).read_text()
            config, params = config_from_ini(ini_with(text, "implementation", compensated=comp))
            U = ghosted_state(config, params)
            t = torch.zeros((), dtype=U.dtype, device="cuda")
            if params.dim == 3:
                pack, advance, unpack = make_packed_advance_chain(params, "cuda", config)
                S, t, k = advance(pack(U), t, 10)
                U = unpack(S, t)
            else:
                U, t, k = make_advance_n(params, "cuda", config)(U, t, 10)
            ends.append((U.cpu(), float(t), int(k), params.compensated))
        (a, ta, ka, ca), (b, tb, kb, cb) = ends
        same = bool(torch.equal(a, b)) and ta == tb and ka == kb == 10 and cb and not ca
        print(f"[53g] {label} {Path(path).name} compensated=yes on {card}: bitwise the "
              f"compensated=no run after 10 steps: {same}")
        if not same:
            raise AssertionError(f"53g {label}: compensated=yes differs from compensated=no")


def phase53(card: str, peak31: float) -> None:
    start = time.perf_counter()
    phase53a(card)
    phase53b(card)
    mpi_profile = phase53c(card)
    phase53d(card)
    phase53e(card, peak31, mpi_profile)
    phase53f(card)
    phase53g(card)
    print(f"[53] phase 53 took {time.perf_counter() - start:.1f} s ({card})")


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
    bounds = phase11(timing, hydro_timing, card)
    lap("11")
    phase12()
    lap("12")
    shear_launches, mri = phase13(card)
    lap("13")
    shear_timing = phase14(card, mri)
    lap("14")
    del mri
    bounds.update(phase15(shear_timing, card))
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
    peak31 = phase31(card)
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
    phase39()
    lap("39")
    phase40()
    lap("40")
    turb = phase41(card)
    lap("41")
    comp_iso_launches, ot_comp_iso = phase5(card, "41c", compensated=True, c_iso=1.0)
    lap("41c")
    wall_iso = phase34(card, timing["n_twin"], "41w", c_iso=1.0)
    lap("41w")
    iso_timing = phase41k(card, turb["ends"], ot_comp_iso, timing["n_twin"])
    lap("41k")
    del turb["ends"], ot_comp_iso
    bounds.update(iso_timing["bounds"])
    bounds.update(wall_iso["bounds"])
    phase42(card)
    lap("42")
    phase43(card)
    lap("43")
    phase44(card)
    lap("44")
    phase45(card)
    lap("45")
    phase46()
    lap("46")
    grav_launches = phase47(card)
    lap("47")
    grav = phase48(card, timing["n_twin"])
    lap("48")
    phase49(card)
    lap("49")
    phase50(card)
    lap("50")
    solvers = phase51(card, timing["n_twin"])
    lap("51")
    phase52a(card)
    lap("52a")
    phase52b(card)
    lap("52b")
    phase52c(card)
    lap("52c")
    phase53(card, peak31)
    lap("53")
    bounds.update(grav["bounds"])
    bounds.update(solvers["bounds"])
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
                "shear_slabs_strat": strat_launches["shear_slabs"],
                "zcarry_mhd": zc_launches["zcarry_mhd"],
                "zcarry_hydro": zc_hydro_launches["zcarry_hydro"],
                "zcarry_mhd_shear": zc_shear_launches["zcarry_mhd"],
                **wall_timing["launches"], **sharded["launches"],
                "mhd_step_iso": turb["launches"]["41a"]["mhd_step"],
                "cfl_mhd_iso": turb["launches"]["41a"]["cfl_mhd"],
                "zcarry_mhd_iso": turb["launches"]["41z"]["zcarry_mhd"],
                "mhd_step_comp_iso": comp_iso_launches["mhd_step"], **wall_iso["launches"],
                **grav["launches"], **grav_launches, **solvers["launches"]}
    bounds.update(row4["bounds"])
    measured = {key: {**timing[key], **hydro_timing[key], **shear_timing[key],
                      **dissip_timing[key], **new_timing[key], **zc_timing[key],
                      **wall_timing[key], **row4[key], **iso_timing[key], **wall_iso[key],
                      **grav[key], **solvers[key]}
                for key in ("ms", "plain_ms", "max_abs_err")}
    # device time (torch.profiler) beside ms (CUDA events) where a kernel
    # runs for less time than its launch takes on the host
    device = {**shear_timing["device_ms"], **new_timing["device_ms"]}
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": measured["max_abs_err"][name],
         "ms": measured["ms"][name], "plain_ms": measured["plain_ms"][name],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1], "library_ms": None,
         "device_ms": device.get(name)}
        for name, (src, rep) in KERNELS.items()
    ]
    for row, name in ROWS:
        ms, (bound_ms, by), dev = measured["ms"][name], bounds[name], device.get(name)
        print(f"[rows] {row} ({name}): {ms:.4f} ms, bound {bound_ms:.4f} ms ({by}), "
              f"{ms / bound_ms:.1f}x" + ("" if dev is None else
                                          f"; device time {dev:.5f} ms, {dev / bound_ms:.1f}x")
              + f" ({card})")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
