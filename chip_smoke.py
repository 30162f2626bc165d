"""Chip smoke test of the PyTorch + CUDA port (ramsesgpu_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card

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
  6. at 256^3 f32, each MHD kernel against its twin on the same inputs,
     then each kernel's time against its twin's (128^3 for a twin whose
     estimated memory does not fit);
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
     each on its own against the twin's; the inactive kernel changes
     nothing; then 1 and 10 chained steps of each dissipative loop against
     the twins' loop;
 17. the dissipative periodic main path: phase 5's workload with the JAX
     dissipation tests' nu = 2e-3, eta = 1e-3, three kernels per step, and
     nu dt (1/dx^2 + 1/dy^2 + 1/dz^2) and eta dt (...) of the first, the
     timed and the next step (the CFL has no viscous or resistive limit);
 18. the viscous-resistive MRI main path: phase 13's workload with
     scripts/perf_table.py's nu = 4e-5, eta = 1e-5 (Re = 25000, Pm = 4),
     five kernels per step (the slab kernel twice), and the same numbers;
 19. the dissipation kernel at full width on the states of phases 17 and
     18: increment and kept face against the twin, its time against the
     twin's, its stages, and its bound (as 11 and 15);
 20. the kernels JSON line, the card line, and the result line.
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
}
# the dissipative coefficient sets (nu, eta): the JAX dissipation tests'
# (tests/test_pallas_dissip.py:46), each term alone, and the viscous-
# resistive MRI's (scripts/perf_table.py:93-102: Re = 25000, Pm = 4)
DISSIP_COEFFS = {"nu=2e-3 eta=1e-3": (2e-3, 1e-3), "nu=0 eta=1e-3": (0.0, 1e-3),
                 "nu=2e-3 eta=0": (2e-3, 0.0), "nu=4e-5 eta=1e-5": (4e-5, 1e-5)}
# the card's peaks (NVIDIA's H100 SXM data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


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
    from ramsesgpu_tpu_torch.kernels.cfl_mhd import cfl_mhd
    from ramsesgpu_tpu_torch.kernels.dissip_step import dissip_step
    from ramsesgpu_tpu_torch.kernels.hydro_step import hydro_step
    from ramsesgpu_tpu_torch.kernels.mhd_step import mhd_step
    from ramsesgpu_tpu_torch.kernels.shear_border import shear_border, shear_slabs

    return {"mhd_step": mhd_step, "cfl_mhd": cfl_mhd, "hydro_step": hydro_step,
            "cfl_hydro": cfl_hydro, "shear_slabs": shear_slabs, "shear_border": shear_border,
            "dissip_step": dissip_step}


@contextlib.contextmanager
def counted_main_path(name: str, expect: dict):
    """Drive one main path with every launch count set to 0 just before and
    read just after; fails unless the counts equal ``expect`` (0 for the
    kernels not named) or a plain twin ran meanwhile. Yields the dict the
    counts are read into."""
    from ramsesgpu_tpu_torch.kernels import (cfl_hydro, cfl_mhd, dissip_step, hydro_step,
                                             mhd_step, shear_border)

    twins = [(mhd_step, "mhd_3d_periodic_update"), (cfl_mhd, "inv_dt_mhd_periodic"),
             (hydro_step, "hydro_3d_state_update"), (hydro_step, "hydro_3d_interior_update"),
             (cfl_hydro, "compute_inv_dt_hydro"), (mhd_step, "mhd_3d_shear_update"),
             (cfl_mhd, "inv_dt_mhd_shear"), (shear_border, "shear_slabs_twin"),
             (shear_border, "shear_border_update"),
             (dissip_step, "mhd_dissipation_periodic_update"),
             (dissip_step, "mhd_dissipation_shear_update"),
             (dissip_step, "kept_face_resistive_ct")]
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
          f"chunks {[round(x * 1e3 / chunk, 3) for x in times]} ms/step)")
    return S, t, (float(t) - t_timed) / (3 * chunk)


def diffusion_numbers(label: str, params, dts: dict) -> None:
    """nu dt (1/dx^2 + 1/dy^2 + 1/dz^2), and the same with eta, for each dt
    of ``dts``: the explicit sub-step is stable up to 1/2, and the CFL has
    no viscous or resistive limit (nor has the JAX package's)."""
    inv_h2 = 1 / params.dx ** 2 + 1 / params.dy ** 2 + 1 / params.dz ** 2
    print(f"[{label}] diffusion numbers (explicit limit 0.5): " + "; ".join(
        f"{name}: dt {dt!r}, nu {params.nu * dt * inv_h2:.5f}, eta {params.eta * dt * inv_h2:.5f}"
        for name, dt in dts.items()))


def phase5(card: str, label: str = "5", nu: float = 0.0, eta: float = 0.0):
    """The periodic MHD main path, ideal or (phase 17) with viscosity nu and
    resistivity eta; returns its launch counts and (params, S, t) at its
    end."""
    from ramsesgpu_tpu_torch.kernels.cfl_mhd import cfl_mhd
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries_concat
    from ramsesgpu_tpu_torch.solvers.step import make_packed_advance_chain
    from ramsesgpu_tpu_torch.solvers.timestep import dt_from_inv

    n, chunk = 256, 10
    params, S_init = setup(n, "float32")
    params = params.replace(nu=nu, eta=eta)
    dt_first = float(dt_from_inv(params, cfl_mhd(params, S_init)))
    U = make_boundaries_concat(params, S_init, interior_only=True)
    del S_init
    mass0 = float(U[0, 3:-3, 3:-3, 3:-3].double().sum())
    energy0 = float(U[1, 3:-3, 3:-3, 3:-3].double().sum())
    pack, advance, unpack = make_packed_advance_chain(params, "cuda")
    t = torch.zeros((), dtype=torch.float32, device="cuda")

    steps = 5 * chunk
    expect = {"mhd_step": steps, "cfl_mhd": steps}
    if nu > 0 or eta > 0:
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
    profile_chunk(f"{label}p", card, advance, S, t, chunk)
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
    return {"ms": ms, "plain_ms": plain, "max_abs_err": errs,
            "bound_input": (block_params(params, 32), bound_input.cpu(), float(dt))}


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
                S_k = hydro_step(params, S0.clone(), dt, active, hydro_step.scratch(params, S0))
                S_g = hydro_step.ghosted(params, U, dt, hydro_step.scratch(params, U, ghosted=True))
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


def phase9(card: str) -> tuple[dict, torch.Tensor]:
    """Both hydro main paths; returns the summed launch counts and the
    implode state at the end of its path."""
    from ramsesgpu_tpu_torch.solvers.step import make_packed_advance_chain

    n, chunk, steps = 256, 10, 50
    total = {}
    kept = None
    for problem in ("implode", "blast"):
        label = f"9 {problem}"
        params, U = hydro_setup(problem, n, "float32")
        mass0 = float(U[0, 2:-2, 2:-2, 2:-2].double().sum())
        energy0 = float(U[1, 2:-2, 2:-2, 2:-2].double().sum())
        pack, advance, unpack = make_packed_advance_chain(params, "cuda")
        t = torch.zeros((), dtype=torch.float32, device="cuda")
        with counted_main_path(label, {"hydro_step": steps, "cfl_hydro": steps}) as launches:
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
        profile_chunk(f"{label}p", card, advance, S, t, chunk)
        if problem == "implode":
            kept = (params, S)
        else:
            del S
    return total, kept


def phase10(card: str, implode, twin_peak_64: int) -> dict:
    """The hydro kernels at 256^3 f32 on the implode main path's state; the
    step kernel in both modes (ghosted: make_step_fn's, TPU row 5)."""
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
    scratch = hydro_step.scratch(params, S0)
    inv = cfl_hydro(params, S0)
    dt = dt_from_inv(params, inv)
    newton = torch.zeros((), dtype=torch.int64, device="cuda")
    S_k = hydro_step(params, S0.clone(), dt, active, scratch, newton=newton)
    S = S0.clone()
    ms = {
        "hydro_step": time_ms(lambda: hydro_step(params, S, dt, active, scratch), 10),
        "cfl_hydro": time_ms(lambda: cfl_hydro(params, S), 50),
    }
    del S, scratch
    # the ghosted mode on the filled ghosted state; the two modes share the
    # arithmetic's source but not its machine code (the compiler may fuse
    # other products into FMAs), so they are compared and reported here and
    # each is held to the twin below
    U = make_boundaries_concat(params, S0, interior_only=True)
    scratch = hydro_step.scratch(params, U, ghosted=True)
    S_g = hydro_step.ghosted(params, U, dt, scratch)
    ms["hydro_step_ghosted"] = time_ms(lambda: hydro_step.ghosted(params, U, dt, scratch), 10)
    differ = (S_g != S_k).any(0)
    near_wall = torch.zeros_like(differ)
    for axis in range(3):
        near_wall |= (torch.arange(256, device="cuda") % 253 < 3).view(
            [256 if a == axis else 1 for a in range(3)])
    print(f"[10] hydro_step ghosted mode at 256^3 f32 on make_boundaries(implode state): "
          f"{ms['hydro_step_ghosted']:.3f} ms ({card}); against the interior mode: "
          f"equal {not bool(differ.any())}, {int(differ.sum())} cells differ "
          f"({int((differ & near_wall).sum())} within 3 cells of a wall), rel L2 "
          f"{rel_l2(S_g, S_k):.3e}, max abs {float((S_g - S_k).abs().max()):.3e}")
    del U, scratch, differ, near_wall
    if not full:
        params = block_params(params, 128)
        S0 = S0[:, :128, :128, :128].contiguous()
        inv = cfl_hydro(params, S0)
        S_k = hydro_step(params, S0.clone(), dt, active, hydro_step.scratch(params, S0))
    U = make_boundaries_concat(params, S0, interior_only=True)
    if not full:
        S_g = hydro_step.ghosted(params, U, dt, hydro_step.scratch(params, U, ghosted=True))
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
            "bound_input": implode[1][:, :32, :32, :32].contiguous().cpu()}


def phase11(mhd: dict, hydro: dict) -> dict:
    """bound_ms and bound_by of every kernel at the inputs phases 6 and 10
    timed: max(bytes / memory rate, flops / f32 rate). Bytes: each input
    value read once and each output written once. Flops: the arithmetic the
    function needs, counted by the counting build on a 32^3 block of those
    inputs with the kernels' own per-cell functions (for hydro_step: one
    trace per cell, one Riemann solve per face, per Newton iteration),
    scaled to 256^3 with the Newton iterations the card counted."""
    from ramsesgpu_tpu_torch.kernels.build import load_library, param_block
    from ramsesgpu_tpu_torch.kernels.packed_bc import bc_codes

    lib = load_library("count")
    n = 256 ** 3
    ops = {}

    p_sub, S_sub, dt = mhd["bound_input"]
    S_sub = S_sub.double().contiguous()
    ops["mhd_step"] = lib.ramses_mhd_step_ops(S_sub.data_ptr(), 32, 32, 32, param_block(p_sub),
                                              dt) / 32 ** 3 * n
    ops["cfl_mhd"] = lib.ramses_cfl_mhd_ops(S_sub.data_ptr(), 32, 32, 32,
                                            param_block(p_sub)) / 32 ** 3 * n

    # [prim, trace, face fluxes, update]
    p_sub = block_params(hydro["params"], 32)
    S_sub = hydro["bound_input"].double().contiguous()
    parts = (ctypes.c_longlong * 4)()
    iters = torch.zeros((), dtype=torch.int64)
    lib.ramses_hydro_step_ops(S_sub.data_ptr(), 32, 32, 32, bc_codes(p_sub), param_block(p_sub),
                              hydro["dt"], parts, iters.data_ptr())
    fixed = (ctypes.c_longlong * 4)()
    p0 = p_sub.replace(niter_riemann=0)  # the same code path without the Newton loop
    lib.ramses_hydro_step_ops(S_sub.data_ptr(), 32, 32, 32, bc_codes(p0), param_block(p0),
                              hydro["dt"], fixed, None)
    faces_sub, faces = 3 * 32 * 32 * 33, 3 * 256 * 256 * 257
    per_iter = (parts[2] - fixed[2]) / max(int(iters), 1)
    per_cell = (fixed[0] + fixed[1] + fixed[3]) / 32 ** 3
    per_face = fixed[2] / faces_sub
    ops["hydro_step"] = per_cell * n + per_face * faces + per_iter * hydro["newton"]
    ops["hydro_step_ghosted"] = ops["hydro_step"]
    ops["cfl_hydro"] = lib.ramses_cfl_hydro_ops(S_sub.data_ptr(), 32, 32, 32, 0,
                                                param_block(p_sub)) / 32 ** 3 * n
    print(f"[11] counted flops: hydro_step {per_cell:.1f}/cell (prim {fixed[0] / 32 ** 3:.1f}, "
          f"trace {fixed[1] / 32 ** 3:.1f}, update {fixed[3] / 32 ** 3:.1f}) + {per_face:.1f}/face "
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
    return bounds


def mri_setup(nx: int, ny: int, nz: int, dtype: str, coeffs: float | None = None,
              nu: float = 0.0, eta: float = 0.0):
    """data/mhd_mri_3d.ini at nx x ny x nz with compensated=no; with
    ``coeffs``, omega0 = cIso = coeffs (the JAX package's shear tests use
    1); viscosity nu and resistivity eta. Returns params, the config and the
    loop state (S, kept) on the card."""
    from ramsesgpu_tpu_torch.config.configmap import ConfigMap
    from ramsesgpu_tpu_torch.config.params import params_from_config
    from ramsesgpu_tpu_torch.convert import torch_dtype
    from ramsesgpu_tpu_torch.kernels.shear import pack
    from ramsesgpu_tpu_torch.problems import init_problem
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries

    config = ConfigMap(Path("data/mhd_mri_3d.ini"))
    for axis, n in (("nx", nx), ("ny", ny), ("nz", nz)):
        config.set_integer("mesh", axis, n)
    config.set_string("implementation", "dtype", dtype)
    config.set_string("implementation", "compensated", "no")
    if coeffs is not None:
        config.set_float("MHD", "omega0", coeffs)
        config.set_float("hydro", "cIso", coeffs)
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


def phase13(card: str, label: str = "13", nu: float = 0.0, eta: float = 0.0):
    """The MRI main path, ideal or (phase 18) with viscosity nu and
    resistivity eta; returns its launch counts and its final state."""
    from ramsesgpu_tpu_torch.kernels.cfl_mhd import cfl_mhd
    from ramsesgpu_tpu_torch.solvers.step import make_packed_advance_chain
    from ramsesgpu_tpu_torch.solvers.timestep import dt_from_inv

    nx, ny, nz, chunk = 128, 256, 128, 10
    params, config, (S0, kept0) = mri_setup(nx, ny, nz, "float32", nu=nu, eta=eta)
    dt_first = float(dt_from_inv(params, cfl_mhd(params, S0, kept=kept0)))
    mass0 = float(S0[0].double().sum())
    pack, advance, unpack = make_packed_advance_chain(params, "cuda", config)
    U = unpack((S0, kept0), torch.zeros((), device="cuda"))  # the ghosted state a Run holds
    del S0, kept0
    t = torch.zeros((), dtype=torch.float32, device="cuda")
    steps = 5 * chunk
    expect = {"mhd_step": steps, "cfl_mhd": steps, "shear_slabs": steps, "shear_border": steps}
    if nu > 0 or eta > 0:
        expect.update(shear_slabs=2 * steps, dissip_step=steps)
    with counted_main_path(label, expect) as launches:
        state = pack(U)
        del U
        state, t, dt_timed = run_chunks(label, card, advance, state, t, f"{nx}x{ny}x{nz}",
                                        chunk, cells=nx * ny * nz)
    S, kept = state
    if nu > 0 or eta > 0:
        diffusion_numbers(label, params, {
            "first step": dt_first, "timed steps (mean)": dt_timed,
            "next step": float(dt_from_inv(params, cfl_mhd(params, S, kept=kept)))})
    if not (bool(torch.isfinite(S).all()) and bool(torch.isfinite(kept).all())):
        raise AssertionError("non-finite state after the MRI main path")
    b_over_dx = max(float(S[5:8].abs().max()), float(kept.abs().max()), 1e-30) / params.dx
    divb = div_b_shear(params, S, kept)
    mass = float(S[0].double().sum())
    print(f"[{label}] {steps} steps at {nx}x{ny}x{nz} f32: t={float(t)!r}, max|divB|={divb:.3e} "
          f"(bound {1e-3 * b_over_dx:.3e}), mass rel {abs(mass - mass0) / abs(mass0):.3e} "
          f"(1e-5), min rho {float(S[0].min()):.4e}")
    if not divb < 1e-3 * b_over_dx:
        raise AssertionError("divB bound violated on the MRI path")
    if not abs(mass - mass0) <= 1e-5 * abs(mass0) or not float(S[0].min()) > 0:
        raise AssertionError("mass bound violated on the MRI path")
    U_out = unpack(state, t)
    if tuple(U_out.shape) != params.shape:
        raise AssertionError(f"unpacked shape {tuple(U_out.shape)} != {params.shape}")
    del U_out
    profile_chunk(f"{label}p", card, advance, state, t, chunk)
    return launches, (params, S, kept, t)


def phase14(card: str, mri) -> dict:
    """The shear kernels at 128x256x128 f32 on the MRI path's state, each
    against its twin and its time against the twin's."""
    from ramsesgpu_tpu_torch.kernels.cfl_mhd import cfl_mhd
    from ramsesgpu_tpu_torch.kernels.mhd_step import mhd_step
    from ramsesgpu_tpu_torch.kernels.shear_border import shear_border, shear_slabs
    from ramsesgpu_tpu_torch.solvers.godunov_mhd import mhd_3d_shear_update, shear_border_update
    from ramsesgpu_tpu_torch.solvers.shear import shear_slabs as slabs_twin
    from ramsesgpu_tpu_torch.solvers.timestep import dt_from_inv, inv_dt_mhd_shear

    params, S, kept, t = mri
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


def stage_times(fn, reps: int = 5, ns: str = "mhd::") -> dict:
    """Device ms per call of each CUDA kernel fn launches (torch.profiler),
    by its stage name in the namespace ``ns``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key.split(ns)[1].split("<")[0] if ns in e.key else e.key[:40]:
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
        "mhd_step_shear": lib.ramses_mhd_step_shear_ops(S.data_ptr(), slabs.data_ptr(), nx, by,
                                                        bz, pb, dt) * scale,
        "cfl_mhd_shear": lib.ramses_cfl_mhd_shear_ops(S.data_ptr(), kept.data_ptr(), nx, by, bz,
                                                      pb) * scale,
    }
    border = (ctypes.c_longlong * 2)()
    lib.ramses_shear_border_ops(S.data_ptr(), kept.data_ptr(), planes.data_ptr(), nx, by, bz, pb,
                                t, dt, border)
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
               noise: bool):
    """The MRI box with omega0 = 1 stepped with cIso = ciso (its state is
    the isothermal box's: with cIso = 0 the MRI init is a state at rest),
    viscosity nu and resistivity eta: params, S, kept and a t0 whose shear
    offset is 2.5 cells. ``noise``: 20 % noise on B and the kept face (the
    initial field varies in x only, so its resistive change of the kept face
    would vanish)."""
    params, _config, (S, kept) = mri_setup(nx, ny, nz, dtype, 1.0)
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
                    scratch = dissip_step.scratch(params, S)
                    got = dissip_step(params, S.clone(), dt, active, scratch)
                    unchanged = torch.equal(dissip_step(params, S.clone(), dt, idle, scratch), S)
                else:
                    params, S, kept, t0 = dissip_mri(64, 128, 64, dtype, ciso, nu, eta, True)
                    dt = dt_from_inv(params, inv_dt_mhd_shear(params, S, kept))
                    slabs = slabs_twin(params, S, kept, t0 + dt)
                    want, eypl, ezpl = mhd_dissipation_shear_update(params, S, slabs, dt)
                    scratch = dissip_step.scratch(params, S)
                    got, kept_got = S.clone(), kept.clone()
                    dissip_step(params, got, dt, active, scratch, shear=(slabs, kept_got))
                    S_idle, kept_idle = S.clone(), kept.clone()
                    dissip_step(params, S_idle, dt, idle, scratch, shear=(slabs, kept_idle))
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
    twin's, its stages, and its bound: max(bytes / memory rate, the
    operations counted by the counting build on a 32^3 block (periodic) or
    an 8x32x128 block (shear) of the state, scaled / f32 rate)."""
    from ramsesgpu_tpu_torch.kernels.build import load_library, param_block
    from ramsesgpu_tpu_torch.kernels.cfl_mhd import cfl_mhd
    from ramsesgpu_tpu_torch.kernels.dissip_step import dissip_step
    from ramsesgpu_tpu_torch.kernels.shear_border import shear_slabs
    from ramsesgpu_tpu_torch.solvers.dissipation import (kept_face_resistive_ct,
                                                          mhd_dissipation_periodic_update,
                                                          mhd_dissipation_shear_update)
    from ramsesgpu_tpu_torch.solvers.shear import shear_slabs as slabs_twin
    from ramsesgpu_tpu_torch.solvers.timestep import dt_from_inv

    lib = load_library("count")
    active = torch.ones((), dtype=torch.bool, device="cuda")
    out = {"ms": {}, "plain_ms": {}, "max_abs_err": {}, "bounds": {}}
    tol = TOL_STEP1["float32"]

    params, S, _t = ot
    name, size = "dissip_step", f"{params.nx}x{params.ny}x{params.nz}"
    dt = dt_from_inv(params, cfl_mhd(params, S))
    scratch = dissip_step.scratch(params, S)
    got = dissip_step(params, S.clone(), dt, active, scratch)
    Sw = S.clone()
    out["ms"][name] = time_ms(lambda: dissip_step(params, Sw, dt, active, scratch), 10)
    stages = {"periodic": stage_times(lambda: dissip_step(params, Sw, dt, active, scratch),
                                      ns="dissip::")}
    del Sw, scratch
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
    ops = lib.ramses_dissip_step_ops(S_sub.data_ptr(), 32, 32, 32, param_block(blk),
                                     float(dt)) / 32 ** 3 * (params.nx * params.ny * params.nz)
    rows = {name: (params, ops, dissip_bytes(params, False), size)}

    params, S, kept, t = mri
    name, size = "dissip_step_shear", f"{params.nx}x{params.ny}x{params.nz}"
    dt = dt_from_inv(params, cfl_mhd(params, S, kept=kept))
    slabs = shear_slabs(params, S, kept, t, dt)
    scratch = dissip_step.scratch(params, S)
    got, kept_got = S.clone(), kept.clone()
    dissip_step(params, got, dt, active, scratch, shear=(slabs, kept_got))
    Sw, kw = S.clone(), kept.clone()
    out["ms"][name] = time_ms(
        lambda: dissip_step(params, Sw, dt, active, scratch, shear=(slabs, kw)), 10)
    stages["shear"] = stage_times(
        lambda: dissip_step(params, Sw, dt, active, scratch, shear=(slabs, kw)), ns="dissip::")
    del Sw, kw, scratch
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
    ops = lib.ramses_dissip_step_shear_ops(S_sub.data_ptr(), slabs_sub.data_ptr(), params.nx, by,
                                           bz, param_block(blk), float(dt))
    rows[name] = (params, ops * (params.ny * params.nz) / (by * bz), dissip_bytes(params, True),
                  size)

    for mode, st in stages.items():
        print(f"[19] dissip_step stages, {mode} mode ({card}): {sum(st.values()):.4f} ms: "
              + ", ".join(f"{k} {v:.4f}" for k, v in sorted(st.items(), key=lambda kv: -kv[1])))
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


def main() -> int:
    card = phase1()
    phase2()
    phase3()
    twin_peak = phase4()
    launches, _ot = phase5(card)
    del _ot
    timing = phase6(card, twin_peak)
    phase7()
    hydro_twin_peak = phase8()
    hydro_launches, implode = phase9(card)
    hydro_timing = phase10(card, implode, hydro_twin_peak)
    del implode
    bounds = phase11(timing, hydro_timing)
    phase12()
    shear_launches, mri = phase13(card)
    shear_timing = phase14(card, mri)
    del mri
    bounds.update(phase15(shear_timing))
    phase16()
    dissip_launches, ot_dissip = phase5(card, "17", *DISSIP_COEFFS["nu=2e-3 eta=1e-3"])
    mri_dissip_launches, mri_dissip = phase13(card, "18", *DISSIP_COEFFS["nu=4e-5 eta=1e-5"])
    dissip_timing = phase19(card, ot_dissip, mri_dissip)
    del ot_dissip, mri_dissip
    bounds.update(dissip_timing["bounds"])
    if "jax" in sys.modules or any(m.startswith("ramsesgpu_tpu.") for m in sys.modules):
        raise AssertionError("the port imported jax or the JAX package")

    launches = {**{k: launches[k] for k in ("mhd_step", "cfl_mhd")},
                **{k: hydro_launches[k] for k in ("hydro_step", "cfl_hydro")},
                "mhd_step_shear": shear_launches["mhd_step"],
                "cfl_mhd_shear": shear_launches["cfl_mhd"],
                **{k: shear_launches[k] for k in ("shear_slabs", "shear_border")},
                "dissip_step": dissip_launches["dissip_step"],
                "dissip_step_shear": mri_dissip_launches["dissip_step"]}
    measured = {key: {**timing[key], **hydro_timing[key], **shear_timing[key],
                      **dissip_timing[key]}
                for key in ("ms", "plain_ms", "max_abs_err")}
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": measured["max_abs_err"][name],
         "ms": measured["ms"][name], "plain_ms": measured["plain_ms"][name],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1], "library_ms": None}
        for name, (src, rep) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
