"""Chip smoke test of the PyTorch + CUDA port (ramsesgpu_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card

Phases, in order; any failure raises and no result line is printed:
  1. the card, its power limit, torch / CUDA / nvcc versions;
  2. build csrc/ with nvcc for sm_90a (prints build time, ptxas report);
  3. CFL kernel vs its twin on a random physical state at 64^3, f32 + f64;
  4. step kernel vs its twin at 64^3 (Orszag-Tang), 1 step and 10 chained
     steps, f32 + f64;
  5. the main path: make_packed_advance_chain on the bench.py workload
     (3D MHD+CT Orszag-Tang, HLLD, 256^3 f32): 2 warm-up + 3 timed chunks
     of 10 steps; launch counts, finiteness, divB and conservation; then
     one more chunk under torch.profiler: device time by kernel and the
     device's idle share of the chunk;
  6. at 256^3 f32, each kernel against its twin on the same inputs, then
     each kernel's time against its twin's (128^3 for a twin whose
     estimated memory does not fit);
  7. the kernels JSON line, the card line, and the result line.
Imports nothing of JAX; of this repo it imports only ramsesgpu_tpu_torch.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

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
KERNELS = {
    "mhd_step": ("ramsesgpu_tpu_torch/csrc/mhd_step.cu",
                 "ramsesgpu_tpu/pallas/packed_io.py:148"),
    "cfl_mhd": ("ramsesgpu_tpu_torch/csrc/cfl_mhd.cu",
                "ramsesgpu_tpu/pallas/packed_io.py:51"),
}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def setup(n: int, dtype: str):
    from ramsesgpu_tpu_torch.convert import torch_dtype
    from ramsesgpu_tpu_torch.solvers.boundary import interior
    from ramsesgpu_tpu_torch.solvers.run import config_from_ini, init_state

    config, params = config_from_ini(INI.format(n=n, dtype=dtype))
    U0 = torch.from_numpy(init_state(params, config))
    S = interior(params, U0).to(device="cuda", dtype=torch_dtype(params)).contiguous()
    return params, S


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

    b = build("cuda")
    print(f"[2] built {b.path.name} in {b.seconds:.1f} s")
    for line in b.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[2] ptxas: {line.strip()}")


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


def phase5(card: str) -> dict:
    from ramsesgpu_tpu_torch.kernels.cfl_mhd import cfl_mhd
    from ramsesgpu_tpu_torch.kernels.mhd_step import mhd_step
    from ramsesgpu_tpu_torch.solvers.boundary import wrap_pad
    from ramsesgpu_tpu_torch.solvers.step import make_packed_advance_chain

    n, chunk = 256, 10
    params, S_init = setup(n, "float32")
    U = wrap_pad(S_init, params.ghost_width)
    del S_init
    mass0 = float(U[0, 3:-3, 3:-3, 3:-3].double().sum())
    energy0 = float(U[1, 3:-3, 3:-3, 3:-3].double().sum())
    pack, advance, unpack = make_packed_advance_chain(params, "cuda")
    t = torch.zeros((), dtype=torch.float32, device="cuda")

    cfl_mhd.launches = 0
    mhd_step.launches = 0
    torch.cuda.synchronize()
    S = pack(U)
    del U
    for _ in range(2):
        S, t, k = advance(S, t, chunk)
        torch.cuda.synchronize()
        if int(k) != chunk:
            raise AssertionError(f"warm-up chunk stopped early: {int(k)}")
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        S, t, k = advance(S, t, chunk)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if int(k) != chunk:
            raise AssertionError(f"timed chunk stopped early: {int(k)}")
    launches = {"mhd_step": mhd_step.launches, "cfl_mhd": cfl_mhd.launches}
    steps = 5 * chunk
    if launches != {"mhd_step": steps, "cfl_mhd": steps}:
        raise AssertionError(f"main path launch counts {launches}, expected {steps} each")

    if not bool(torch.isfinite(S).all()):
        raise AssertionError("non-finite state after the main path")
    b_over_dx = max(float(S[5].abs().max()), 1e-10) / params.dx
    divb = div_b_max(params, S)
    mass = float(S[0].double().sum())
    energy = float(S[1].double().sum())
    print(f"[5] {steps} steps at {n}^3 f32: t={float(t)!r}, max|divB|={divb:.3e} "
          f"(bound {1e-3 * b_over_dx:.3e}), mass rel {abs(mass - mass0) / abs(mass0):.3e} "
          f"(1e-5), energy rel {abs(energy - energy0) / abs(energy0):.3e} (1e-4)")
    if not divb < 1e-3 * b_over_dx:
        raise AssertionError("divB bound violated")
    if not abs(mass - mass0) <= 1e-5 * abs(mass0) or not abs(energy - energy0) <= 1e-4 * abs(energy0):
        raise AssertionError("conservation bound violated")
    U_out = unpack(S, t)
    if tuple(U_out.shape) != params.shape:
        raise AssertionError(f"unpacked shape {tuple(U_out.shape)} != {params.shape}")

    best, mean = min(times), sum(times) / len(times)
    cells = n ** 3
    print(f"[5] main path {n}^3 f32 on {card}: best chunk {best * 1e3 / chunk:.3f} ms/step, "
          f"{cells * chunk / best:.4e} cells/s (mean {mean * 1e3 / chunk:.3f} ms/step, "
          f"chunks {[round(x * 1e3 / chunk, 3) for x in times]} ms/step)")
    print(f"[5] launches during the main path: {launches}")
    profile_chunk(card, advance, S, t, chunk)
    return launches


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
    return {"ms": ms, "plain_ms": plain, "max_abs_err": errs}


def profile_chunk(card: str, advance, S: torch.Tensor, t: torch.Tensor, chunk: int) -> None:
    """Device time by kernel over one more chunk of the main path, and the
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
    print(f"[5p] one {chunk}-step chunk at {S.shape[-1]}^3 f32 on {card}: "
          f"wall {wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms, idle share {1 - busy / wall_us:.4f}")
    for us, count, key in sorted(rows, reverse=True):
        print(f"[5p] {us / 1e3:9.3f} ms {100 * us / busy:5.1f} % {count:4d}x  {key[:110]}")


def main() -> int:
    card = phase1()
    phase2()
    phase3()
    twin_peak = phase4()
    launches = phase5(card)
    timing = phase6(card, twin_peak)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": timing["max_abs_err"][name],
         "ms": timing["ms"][name], "plain_ms": timing["plain_ms"][name]}
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
