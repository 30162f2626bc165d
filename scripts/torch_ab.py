"""A/B timings of the PyTorch + CUDA port (ramsesgpu_tpu_torch) on one
NVIDIA GPU. Run from the root of a checkout.

    python3 scripts/torch_ab.py trees A B   # two checkouts, in turns A, B, B, A
    python3 scripts/torch_ab.py fmad        # mhd_step.cu with and without -fmad=false
    python3 scripts/torch_ab.py parent P [PART...]  # the kernels of this checkout against P's
    python3 scripts/torch_ab.py zcarry T... # row 12 of this checkout against the checkouts T
    python3 scripts/torch_ab.py hydro T...  # the hydro step kernels against the checkouts T
    python3 scripts/torch_ab.py clocks      # row 12's phases in cycles, per warp group
    python3 scripts/torch_ab.py clocks hydro  # the hydro body's phases, likewise
    python3 scripts/torch_ab.py clocks dissip # the dissipation kernel's phases
    python3 scripts/torch_ab.py kernels T...  # dissip_step.cu, cfl_mhd.cu against the checkouts T

``trees``: runs chip_smoke.py's build (phase 2) and main paths 5 (MHD OT
256^3), 13 (MRI 128x256x128, compensated=no) and 17 (OT dissipative) of
checkout A, then B, B and A, each in its own process from the root of its
checkout (its library builds there once and is reused by its second run);
prints each run's ms/step lines and its profiled chunk's device time.

``parent P``: csrc/mhd_step.cu and csrc/zcarry_mhd.cu of this checkout
against those of the checkout P (its library built there), through the
same wrappers on the same inputs: one step of every mode of the staged
step kernel (periodic, compensated, shear isothermal / adiabatic /
compensated, stratified, ghosted walls and jet, shear window ideal and
stratified) and of the streamed one (periodic, compensated, shear,
stratified), f32 and f64, at
64^3-sized grids: whether the new state (and planes) is bitwise the
parent's, else its largest difference in ULP and whether the fluxes and
EMFs the update read already differ; then the periodic step's stages at
256^3 f32 of each (torch.profiler), and each mode's time at the main
paths' sizes in f32, P, this, this, P (CUDA events, 10 launches). Then the
same for csrc/hydro_step.cu (interior mode with walls and periodic, ghosted,
ghosted in place) and csrc/zcarry_hydro.cu (its new state and inverse dt),
called through each library's own C entry points, so a parent with another
hydro interface (the staged kernel, which updates in place through a stage
buffer) is compared on the same inputs: bitwise or in ULP at 72^3, f32 and
f64, then each mode's time at 256^3 in f32 and f64, P, this, this, P.

Then (PART dissip) every mode and coefficient set of csrc/dissip_step.cu and
(PART cfl) every mode of csrc/cfl_mhd.cu (a NaN cell too), through each
library's own C entry points (a parent with the staged dissipation kernel
or the two-launch CFL is compared on the same inputs): bitwise or in ULP
at 72^3-sized grids, f32 and f64, then each mode's time at the main paths'
sizes, P, this, this, P. PART: any of step, hydro, dissip, cfl (default:
all four).

``hydro T...``: the hydro modes of ``parent`` at 256^3, f32 and f64, this
checkout against the checkouts T (ULP, then the times in turns this, T...,
T... reversed, this). For trying a variant of the streamed hydro body (its
tile, its groups): unpack a copy of the checkout into a directory that
.gitignore lists and edit csrc/hydro_stream.cuh there.

``zcarry T...``: row 12 (csrc/zcarry_mhd.cu) of this checkout against
the checkouts T (each library built there) in its four modes (periodic
and compensated with the folded CFL at 256^3, shear and stratified at
128x256x128, f32): each tree's new state against this one's (ULP), then
the times in turns this, T..., T... reversed, this (CUDA events, 10
launches). For trying a variant of the kernel: unpack a copy of the
checkout into a directory that .gitignore lists and edit it there.

``clocks``: row 12 built with -DRAMSES_ZCARRY_CLOCKS, one launch of each
of its four modes at the main paths' sizes (f32): block 0's producer and
consumer groups print the cycles they spent in each of their phases,
waits at the hand-over included (csrc/zcarry_mhd.cu Clocks); then that
build against the package's, timed in turns, for the counters' cost.

``clocks hydro``: the same for the streamed hydro body (csrc/hydro_stream.cuh:
csrc/hydro_step.cu and csrc/zcarry_hydro.cu built with the flag), one
launch of each hydro mode at 256^3, f32 and f64, untimed (row 12's
counters cost nothing measurable).

``kernels T...``: csrc/dissip_step.cu and csrc/cfl_mhd.cu of this checkout
against the checkouts T, every mode at the main paths' sizes, f32 and f64
(ULP, then the times in turns this, T..., T... reversed, this). For trying
a variant (a Tile or CflTile constant): unpack a copy of the checkout into
a directory that .gitignore lists and edit it there.

``clocks dissip``: csrc/dissip_step.cu built with -DRAMSES_ZCARRY_CLOCKS,
one launch of each mode at the main paths' sizes, f32 and f64: block 0's
thread 0 prints the cycles of each phase, its barrier included.

``fmad``: the periodic step at 256^3 f32, plain and compensated, launched
in turns (default, variant, variant, default) from the package's library
and from one whose csrc/mhd_step.cu was compiled with its usual flags plus
-fmad=false (no FMA contraction anywhere in the file); CUDA events over 10
launches each.
"""
from __future__ import annotations

import contextlib
import ctypes
import importlib.util
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PATHS = ("card = cs.phase1(); cs.phase2(); cs.phase5(card); cs.phase13(card); "
         "cs.phase5(card, '17', *cs.DISSIP_COEFFS['nu=2e-3 eta=1e-3'])")


def trees(a: str, b: str) -> None:
    for n, tree in enumerate((a, b, b, a), 1):
        res = subprocess.run([sys.executable, "-c", f"import chip_smoke as cs; {PATHS}"],
                             cwd=tree, capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            raise RuntimeError(f"run {n} in {tree} failed:\n{res.stdout[-3000:]}{res.stderr[-3000:]}")
        for line in res.stdout.splitlines():
            if "main path" in line or "idle share" in line or line.startswith("[1]"):
                print(f"run {n} {tree}: {line}", flush=True)


def fmad() -> None:
    import torch

    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from ramsesgpu_tpu_torch.kernels import build as b
    from ramsesgpu_tpu_torch.kernels.cfl_mhd import cfl_mhd
    from ramsesgpu_tpu_torch.kernels.mhd_step import mhd_step
    from ramsesgpu_tpu_torch.solvers.timestep import dt_from_inv

    card = cs.card_line()
    default = b.load_library("cuda")
    nvcc = b.find_nvcc()
    work = Path(tempfile.mkdtemp(dir=b.build_dir()))
    obj, lib = work / "mhd_step.o", work / "libmhd_step_nofma.so"
    for cmd in ([nvcc, *b.compile_flags("cuda", "mhd_step.cu"), "-fmad=false", "-o", str(obj),
                 str(b.CSRC / "mhd_step.cu")],
                [nvcc, *b.LINK_FLAGS, "-o", str(lib), str(obj)]):
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    variant = ctypes.CDLL(str(lib))
    variant.ramses_mhd_step_f32.argtypes, variant.ramses_mhd_step_f32.restype = \
        b._SIGNATURES["ramses_mhd_step_f32"]
    libs = {"default": default, "-fmad=false": variant}
    params, S8 = cs.setup(256, "float32")
    active = torch.ones((), dtype=torch.bool, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for comp in (False, True):
        p = params.replace(compensated=comp)
        S = torch.cat([S8, torch.zeros_like(S8)]).contiguous() if comp else S8.clone()
        dt = dt_from_inv(p, cfl_mhd(p, S))
        scratch = mhd_step.scratch(p, S)

        def launch(lib):
            err = lib.ramses_mhd_step_f32(S.data_ptr(), scratch.data_ptr(), dt.data_ptr(),
                                          active.data_ptr(), int(comp), 256, 256, 256,
                                          b.param_block(p), stream)
            if err:
                raise RuntimeError(f"mhd_step launch failed: CUDA error {err}")

        times = [(name, cs.time_ms(lambda: launch(libs[name]), 10))
                 for name in ("default", "-fmad=false", "-fmad=false", "default")]
        print(f"[fmad] mhd_step {'compensated' if comp else 'plain'} 256^3 f32 ({card}): "
              + ", ".join(f"{name} {ms:.3f} ms" for name, ms in times), flush=True)
        del S, scratch
        torch.cuda.empty_cache()


def clocks_hydro() -> None:
    """The streamed hydro body's phases: csrc/hydro_step.cu and
    csrc/zcarry_hydro.cu built on their own with -DRAMSES_ZCARRY_CLOCKS, one
    launch of each mode at 256^3, f32 and f64 (block 0 prints its groups'
    cycles, hydro_stream.cuh Stream::clk)."""
    import torch

    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from ramsesgpu_tpu_torch.kernels import build as b

    card = cs.card_line()
    nvcc = b.find_nvcc()
    work = Path(tempfile.mkdtemp(dir=b.build_dir()))
    sources = ("hydro_step.cu", "zcarry_hydro.cu")
    objs = [work / f"{Path(src).stem}.o" for src in sources]
    procs = [subprocess.Popen([nvcc, *b.compile_flags("cuda", src), "-DRAMSES_ZCARRY_CLOCKS",
                               "-o", str(obj), str(b.CSRC / src)])
             for src, obj in zip(sources, objs)]
    if any(proc.wait() for proc in procs):
        raise RuntimeError("building the hydro clocks variant failed")
    path = work / "libhydro_clocks.so"
    subprocess.run([nvcc, *b.LINK_FLAGS, "-o", str(path), *map(str, objs)], check=True)
    lib = ctypes.CDLL(str(path))
    for name, (args, res) in b._SIGNATURES.items():
        if name.startswith(("ramses_hydro_step", "ramses_hydro_stream", "ramses_zcarry_hydro")):
            getattr(lib, name).argtypes, getattr(lib, name).restype = args, res
    for dtype in ("float32", "float64"):
        for name, run in hydro_cases(cs, dtype, 256):
            print(f"[clocks] {name} {dtype} 256^3 ({card}): one launch", flush=True)
            _outs, _again = run(lib)
            torch.cuda.synchronize()
            del _outs, _again
            torch.cuda.empty_cache()


def clocks() -> None:
    """Row 12's phases: csrc/zcarry_mhd.cu built on its own with
    -DRAMSES_ZCARRY_CLOCKS, one launch of each mode at the main paths'
    sizes (f32); block 0 prints the cycles its groups spent in each phase
    (Clocks in the source). Then the same launch of the package's library
    and of the counting build's, timed, for the cost of the counters."""
    import torch

    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from ramsesgpu_tpu_torch.kernels import build as b

    card = cs.card_line()
    nvcc = b.find_nvcc()
    work = Path(tempfile.mkdtemp(dir=b.build_dir()))
    obj, path = work / "zcarry_mhd.o", work / "libzcarry_clocks.so"
    for cmd in ([nvcc, *b.compile_flags("cuda", "zcarry_mhd.cu"), "-DRAMSES_ZCARRY_CLOCKS",
                 "-o", str(obj), str(b.CSRC / "zcarry_mhd.cu")],
                [nvcc, *b.LINK_FLAGS, "-o", str(path), str(obj)]):
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(path))
    for name, (args, res) in b._SIGNATURES.items():
        if name.startswith("ramses_zcarry_mhd"):
            getattr(lib, name).argtypes, getattr(lib, name).restype = args, res
    libs = {"clocks": lib, "package": b.load_library("cuda")}
    for name, _params, run in step_cases(cs, "float32", full=True, streamed_only=True):
        with library(libs["clocks"]):
            print(f"[clocks] {name} f32 (main path size; {card}): one launch", flush=True)
            outs, _fe, again = run(libs["clocks"])
            torch.cuda.synchronize()
            del outs
        times = []
        for who in ("package", "clocks", "clocks", "package"):
            with library(libs[who]):
                times.append((who, cs.time_ms(again, 10)))
        print(f"[clocks] {name}: " + ", ".join(f"{who} {ms:.3f} ms" for who, ms in times),
              flush=True)
        del _fe, again
        torch.cuda.empty_cache()


def ulp_diff(a, b) -> tuple:
    """(elements that differ, the largest |a - b| in ULP of b) of two
    tensors of one dtype."""
    import torch

    diff = (a != b) & ~(a.isnan() & b.isnan())
    if not bool(diff.any()):
        return 0, 0.0
    tiny = torch.finfo(b.dtype).tiny
    ulp = torch.finfo(b.dtype).eps * b.abs().clamp_min(tiny)
    return int(diff.sum()), float(((a - b).abs() / ulp)[diff].max())


@contextlib.contextmanager
def library(lib):
    """The step wrappers (kernels/mhd_step.py, kernels/zcarry_mhd3d.py)
    launching from ``lib``."""
    from ramsesgpu_tpu_torch.kernels import mhd_step as ms, zcarry_mhd3d as zm

    saved = ms.load_library, zm.load_library
    ms.load_library = zm.load_library = lambda kind="cuda": lib
    try:
        yield
    finally:
        ms.load_library, zm.load_library = saved


def step_cases(cs, dtype: str, full: bool, streamed_only: bool = False):
    """(name, params, run) of every mode: run(lib) makes its buffers with
    that library, launches one step and returns (outputs, fluxes and EMFs,
    a relaunch for timing). ``full``: the main paths' sizes (f32);
    ``streamed_only``: the streamed step's modes alone."""
    import torch
    from ramsesgpu_tpu_torch.kernels.cfl_mhd import cfl_mhd, cfl_mhd_window
    from ramsesgpu_tpu_torch.kernels.mhd_step import MhdStepKernel, MhdWindowKernel
    from ramsesgpu_tpu_torch.kernels.shear_border import shear_slabs, shear_zslabs
    from ramsesgpu_tpu_torch.kernels.zcarry_mhd3d import ZcarryMhdKernel
    from ramsesgpu_tpu_torch.solvers.timestep import dt_from_inv

    active = torch.ones((), dtype=torch.bool, device="cuda")
    n, mri = (256, (128, 256, 128)) if full else (64, (64, 128, 64))

    def tail(scratch, lib, shear=False):
        # the fluxes [3][5] and EMFs [3] on the stage grid, the last 18 of
        # the values per cell before the shear mode's state copy Se [8]
        per_cell = lib.ramses_mhd_step_scratch_per_cell()
        ne = scratch.numel() // (per_cell + (8 if shear else 0))
        return scratch[(per_cell - 18) * ne:per_cell * ne]

    def periodic(comp):
        params, S = cs.setup(n, dtype)
        if comp:
            params, S = params.replace(compensated=True), cs.with_carry(S, 31)
        dt = dt_from_inv(params, cfl_mhd(params, S))

        def run(lib):
            k, Sw = MhdStepKernel(), S.clone()
            scratch = k.scratch(params, S)
            k(params, Sw, dt, active, scratch)
            return ((Sw,), tail(scratch, lib),
                    lambda: k(params, Sw, dt, active, scratch))
        return params, run

    def shear(kind):
        if kind == "stratified":
            params, _config, (S, kept), gz = cs.strat_setup(*mri, dtype, seed=33)
            gz = gz.to(S.dtype)
        else:
            params, _config, (S, kept) = cs.mri_setup(*mri, dtype, compensated=(
                None if kind == "compensated" else False))
            if kind == "adiabatic":
                params = params.replace(c_iso=0.0)
            if params.compensated:
                S, kept = cs.comp_state(S, kept, 33)
            gz = None
        t = cs.shear_t0(params, S.dtype)
        dt = dt_from_inv(params, cfl_mhd(params, S, kept=kept))
        slabs = shear_slabs(params, S, kept, t, dt)
        extra = () if gz is None else (shear_zslabs(params, S, slabs), gz)

        def run(lib):
            k, Sw = MhdStepKernel(), S.clone()
            planes = torch.zeros((5, params.nz, params.ny), dtype=S.dtype, device="cuda")
            scratch = k.scratch(params, S)
            k(params, Sw, dt, active, scratch, shear=(slabs, planes, *extra))
            return ((Sw, planes), tail(scratch, lib, shear=True),
                    lambda: k(params, Sw, dt, active, scratch, shear=(slabs, planes, *extra)))
        return params, run

    def ghosted(case):
        params, U = cs.wall_case(case, dtype, (n, n, n) if full else (64, 48, 40))
        dt = dt_from_inv(params, cfl_mhd(params, U, ghost=params.ghost_width))

        def run(lib):
            k, Uw = MhdStepKernel(), U.clone()
            scratch = k.scratch(params, U, ghosted=True)
            k.ghosted(params, Uw, dt, active, scratch)
            return ((Uw,), tail(scratch, lib),
                    lambda: k.ghosted(params, Uw, dt, active, scratch))
        return params, run

    def window(kind):
        ini, topo, rank = ((cs.DEBUG_INI, (2, 2, 1), (0, 1, 1)) if kind == "ideal"
                           else (cs.STRAT_MPI_INI, (2, 1, 2), (1, 0, 1)))
        mesh = mri if full else (32, 64, 32)
        _p, _c, lp, W, x0, _z0, gz = cs.window_case36(ini, mesh, topo, rank, dtype, seed=36)
        dt = dt_from_inv(lp, cfl_mhd_window(lp, W))

        def run(lib):
            k = MhdWindowKernel()
            scratch = k.scratch(lp, W)
            out = k(lp, W, dt, x0, gz, scratch)
            return (out, tail(scratch, lib),
                    lambda: k(lp, W, dt, x0, gz, scratch))
        return lp, run

    def zcarry(kind):
        if kind in ("periodic", "compensated"):
            params, S = cs.setup(n, dtype)
            params = params.replace(kernel="zcarry", compensated=kind == "compensated")
            if params.compensated:
                S = cs.with_carry(S, 31)
            dt = dt_from_inv(params, cfl_mhd(params, S))
            extra, fold = None, True
        else:
            if kind == "stratified":
                params, _config, (S, kept), gz = cs.strat_setup(*mri, dtype, seed=33)
            else:
                params, _config, (S, kept) = cs.mri_setup(*mri, dtype)
            params = params.replace(kernel="zcarry")
            t = cs.shear_t0(params, S.dtype)
            dt = dt_from_inv(params, cfl_mhd(params, S, kept=kept))
            slabs = shear_slabs(params, S, kept, t, dt)
            extra = (slabs,) if kind == "shear" else (
                slabs, shear_zslabs(params, S, slabs), gz.to(S.dtype))
            fold = False

        def run(_lib):
            k, out = ZcarryMhdKernel(), torch.empty_like(S)
            planes = torch.zeros((5, params.nz, params.ny), dtype=S.dtype, device="cuda")
            sh = None if extra is None else (extra[0], planes, *extra[1:])
            inv = k(params, S, out, dt, active, shear=sh, fold=fold)
            outs = (out, planes) if inv is None else (out, inv)
            return outs, None, lambda: k(params, S, out, dt, active, shear=sh, fold=fold)
        return params, run

    if not streamed_only:
        yield "mhd_step periodic", *periodic(False)
        yield "mhd_step compensated", *periodic(True)
        for kind in ("isothermal", "adiabatic", "compensated", "stratified"):
            yield f"mhd_step shear {kind}", *shear(kind)
        for case in ("neumann", "jet"):
            yield f"mhd_step ghosted {case}", *ghosted(case)
        for kind in ("ideal", "stratified"):
            yield f"mhd_step window {kind}", *window(kind)
    for kind in ("periodic", "compensated", "shear", "stratified"):
        yield f"zcarry_mhd {kind}", *zcarry(kind)


def hydro_cases(cs, dtype: str, n: int):
    """(name, run) of every mode of the hydro step kernels on an n^3 state
    (data/implode3d.ini, walls, or its periodic blast, 1 % noise from a
    seed on the interior, ghosts filled): run(lib) launches one step through
    lib's C entry points and returns (outputs, a relaunch for timing). A
    library with ramses_hydro_step_scratch has the staged kernel (interior
    mode in place, a stage buffer); else the streamed one (the new state
    into another buffer)."""
    import torch
    from ramsesgpu_tpu_torch.kernels.build import param_block
    from ramsesgpu_tpu_torch.kernels.packed_bc import bc_codes
    from ramsesgpu_tpu_torch.solvers.boundary import interior, make_boundaries
    from ramsesgpu_tpu_torch.solvers.timestep import compute_inv_dt_hydro, dt_from_inv

    f64 = int(dtype == "float64")
    sfx = "f64" if f64 else "f32"
    active = torch.ones((), dtype=torch.bool, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def state(problem):
        params, U = cs.hydro_setup(problem, n, dtype)
        gen = torch.Generator(device="cuda").manual_seed(11)
        inner = interior(params, U)
        inner *= 1 + 0.01 * torch.randn(inner.shape, generator=gen, device="cuda", dtype=U.dtype)
        U = make_boundaries(params, U)
        S = interior(params, U).contiguous()
        return params, U, S, dt_from_inv(params, compute_inv_dt_hydro(params, S, ghost=0))

    def launcher(lib, params, dt, ghosted, src, out):
        """A launch of src into out (the staged kernel: out its in-place
        target), the buffers made with lib."""
        fn = getattr(lib, f"ramses_hydro_step_{sfx}")
        if hasattr(lib, "ramses_hydro_step_scratch"):
            third = torch.empty(lib.ramses_hydro_step_scratch(n, n, n, ghosted), dtype=src.dtype,
                                device="cuda")
            arg = third.data_ptr()
        else:
            third, arg = None, lib.ramses_hydro_step_blocks(f64)

        def go(third=third):
            err = fn(src.data_ptr(), out.data_ptr(), arg, dt.data_ptr(), active.data_ptr(),
                     n, n, n, ghosted, bc_codes(params), param_block(params), None, stream)
            if err:
                raise RuntimeError(f"hydro_step launch failed: CUDA error {err}")
        return go

    def interior_mode(problem):
        params, _U, S, dt = state(problem)

        def run(lib):
            if hasattr(lib, "ramses_hydro_step_scratch"):
                out = S.clone()
                go = launcher(lib, params, dt, 0, out, out)
            else:
                out = torch.empty_like(S)
                go = launcher(lib, params, dt, 0, S, out)
            go()
            return (out,), go
        return run

    def ghosted_mode(in_place):
        params, U, _S, dt = state("implode")

        def run(lib):
            if in_place:
                Uw = U.clone()
                buf = (Uw if hasattr(lib, "ramses_hydro_step_scratch")
                       else torch.empty_like(interior(params, U)).contiguous())
                go = launcher(lib, params, dt, 2, Uw, buf)
                go()
                return (Uw,), go
            out = torch.empty_like(interior(params, U)).contiguous()
            go = launcher(lib, params, dt, 1, U, out)
            go()
            return (out,), go
        return run

    def folded():
        params, _U, S, dt = state("blast")

        def run(lib):
            out = torch.empty_like(S)
            inv = torch.empty((), dtype=S.dtype, device="cuda")
            blocks = lib.ramses_zcarry_hydro_blocks(f64)
            fn = getattr(lib, f"ramses_zcarry_hydro_{sfx}")

            def go():
                err = fn(S.data_ptr(), out.data_ptr(), blocks, inv.data_ptr(), dt.data_ptr(),
                         active.data_ptr(), n, n, n, param_block(params), stream)
                if err:
                    raise RuntimeError(f"zcarry_hydro launch failed: CUDA error {err}")
            go()
            return (out, inv), go
        return run

    yield "hydro_step interior (walls)", interior_mode("implode")
    yield "hydro_step interior (periodic)", interior_mode("blast")
    yield "hydro_step ghosted", ghosted_mode(False)
    yield "hydro_step ghosted in place", ghosted_mode(True)
    yield "zcarry_hydro", folded()


def dissip_cases(cs, dtype: str, full: bool):
    """(name, run) of every mode of csrc/dissip_step.cu (periodic plain and
    compensated, shear isothermal and adiabatic, plain and compensated) and
    coefficient set (``full``: the main paths' sets, at their sizes):
    run(lib) launches one sub-step through lib's C entry points and
    returns (outputs, a relaunch for timing). A library with
    ramses_dissip_step_scratch has the staged kernel (in place, through a
    scratch buffer); else the one-launch kernel (S into another buffer)."""
    import torch
    from ramsesgpu_tpu_torch.kernels.build import param_block
    from ramsesgpu_tpu_torch.kernels.cfl_mhd import cfl_mhd
    from ramsesgpu_tpu_torch.solvers.shear import shear_slabs
    from ramsesgpu_tpu_torch.solvers.timestep import dt_from_inv

    sfx = "f64" if dtype == "float64" else "f32"
    active = torch.ones((), dtype=torch.bool, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    n, mri = (256, (128, 256, 128)) if full else (72, (40, 72, 24))

    def case(params, S, slabs=None, kept=None):
        plain = params.replace(compensated=False)
        face = None if kept is None else (kept[0] if params.compensated else kept)
        dt = dt_from_inv(params, cfl_mhd(plain, S[:8], kept=face))

        def run(lib):
            fn = getattr(lib, f"ramses_dissip_step_{sfx}")
            dims = (params.nx, params.ny, params.nz)
            staged = hasattr(lib, "ramses_dissip_step_scratch")
            out = S.clone() if staged else torch.empty_like(S)
            third = (torch.empty(lib.ramses_dissip_step_scratch(*dims, int(slabs is not None)),
                                 dtype=S.dtype, device="cuda") if staged else out)
            kept_w = None if kept is None else kept.clone()

            def go():
                err = fn((out if staged else S).data_ptr(), third.data_ptr(),
                         None if slabs is None else slabs.data_ptr(),
                         None if kept is None else kept_w.data_ptr(), dt.data_ptr(),
                         active.data_ptr(), int(params.compensated), *dims,
                         param_block(params), stream)
                if err:
                    raise RuntimeError(f"dissip_step launch failed: CUDA error {err}")
            go()
            return (out.clone(),) + (() if kept is None else (kept_w.clone(),)), go
        return run

    coeffs = ({"nu=2e-3 eta=1e-3": cs.DISSIP_COEFFS["nu=2e-3 eta=1e-3"]} if full else
              {k: v for k, v in cs.DISSIP_COEFFS.items() if k != "nu=4e-5 eta=1e-5"})
    for cname, (nu, eta) in coeffs.items():
        params, S = cs.setup(n, dtype)
        params = params.replace(nu=nu, eta=eta)
        size = f"{n}^3"
        yield f"dissip_step periodic {size} {cname}", case(params, S)
        yield (f"dissip_step periodic compensated {size} {cname}",
               case(params.replace(compensated=True), cs.with_carry(S, 20)))
        del S
    size = "x".join(map(str, mri))
    coeffs = {"nu=4e-5 eta=1e-5": cs.DISSIP_COEFFS["nu=4e-5 eta=1e-5"]} if full else coeffs
    for ciso in (1.0,) if full else (1.0, 0.0):
        for cname, (nu, eta) in coeffs.items():
            for comp in (False, True):
                p, S, kept, t0 = cs.dissip_mri(*mri, dtype, ciso, nu, eta, True)
                if comp:
                    p = p.replace(compensated=True)
                    S, kept = cs.comp_state(S, kept[None], 22)
                face = kept[0] if comp else kept
                dt = dt_from_inv(p, cfl_mhd(p.replace(compensated=False), S[:8], kept=face))
                slabs = shear_slabs(p, S[:8], face, t0 + dt).contiguous()
                yield (f"dissip_step shear cIso={ciso}{' compensated' if comp else ''} {size} "
                       f"{cname}", case(p, S, slabs, kept))
                del S, kept, slabs


def cfl_cases(cs, dtype: str, full: bool):
    """(name, run) of every mode of csrc/cfl_mhd.cu (periodic, shear,
    stratified shear, ghosted with and without a floor, ghosted shear; a
    NaN cell in the periodic and shear modes): run(lib) launches one
    reduction through lib's C entry points and returns ((inv,), a relaunch
    for timing). A parent whose entry points take no block counter runs the
    two-launch reduction."""
    import torch
    from ramsesgpu_tpu_torch.kernels import fused_mhd3d, shear
    from ramsesgpu_tpu_torch.kernels.build import param_block

    sfx = "f64" if dtype == "float64" else "f32"
    stream = torch.cuda.current_stream().cuda_stream
    n, mri, window = (256, (128, 256, 128), (64, 128, 128)) if full else (72, (40, 72, 24),
                                                                         (20, 36, 24))

    def case(entry, params, S, *args, ghost=0, floor=None):
        def run(lib):
            fn = getattr(lib, f"ramses_cfl_mhd_{entry}{sfx}")
            partial = torch.empty(lib.ramses_cfl_mhd_partials(), dtype=S.dtype, device="cuda")
            work = [partial.data_ptr()]
            count = torch.zeros(1, dtype=torch.int32, device="cuda")
            if len(fn.argtypes) > 8 + len(args) + bool(ghost) + (floor is not None):
                work.append(count.data_ptr())
            out = torch.empty((), dtype=S.dtype, device="cuda")
            tail = (params.nx, params.ny, params.nz) + ((ghost,) if ghost else ()) + (
                () if floor is None else (floor,)) + (param_block(params), stream)

            def go():
                err = fn(S.data_ptr(), *(a.data_ptr() for a in args), *work, out.data_ptr(),
                         *tail)
                if err:
                    raise RuntimeError(f"cfl_mhd launch failed: CUDA error {err}")
            go()
            return (out.clone(),), go
        return run

    params, S = cs.setup(n, dtype)
    yield f"cfl_mhd periodic {n}^3", case("", params, S)
    U = fused_mhd3d.unpack(params, S).contiguous()
    g = params.ghost_width
    yield f"cfl_mhd ghosted {n}^3", case("ghosted_", params, U, ghost=g, floor=float("-inf"))
    yield (f"cfl_mhd ghosted {n}^3, floor 1e6", case("ghosted_", params, U, ghost=g,
                                                     floor=1e6))
    if not full:
        S_nan = S.clone()
        S_nan[1, 3, 5, 7] = float("nan")
        yield f"cfl_mhd periodic {n}^3 NaN cell", case("", params, S_nan)
    del S, U
    size = "x".join(map(str, mri))
    for ini in (cs.MRI_INI, cs.STRAT_INI):
        params, _config, (S, kept) = cs.mri_setup(*mri, dtype, ini=ini)
        yield f"cfl_mhd shear {ini} {size}", case("shear_", params, S, kept)
        if not full and ini == cs.MRI_INI:
            S_nan = S.clone()
            S_nan[0, 2, 3, params.nx - 1] = float("nan")
            yield f"cfl_mhd shear {size} NaN cell", case("shear_", params, S_nan, kept)
    params, _config, (S, kept) = cs.mri_setup(*window, dtype)
    U = shear.unpack(params, (S, kept), cs.shear_t0(params, S.dtype)).contiguous()
    yield (f"cfl_mhd ghosted shear {'x'.join(map(str, window))}",
           case("ghosted_shear_", params, U, ghost=params.ghost_width))


def kernel_turns(cs, cases, libs: dict, order: list, card: str, tag: str, reps: int) -> None:
    """Each case of ``cases`` (dissip_cases, cfl_cases): each library's
    outputs against the first's of ``order`` (bitwise, else ULP), then the
    times in the turns of ``order`` (CUDA events, ``reps`` launches)."""
    import torch

    first = order[0]
    for name, run in cases:
        outs, times = {}, []
        for who in order:
            got, again = run(libs[who])
            outs.setdefault(who, got)
            times.append((who, cs.time_ms(again, reps)))
            del got, again
        diffs = "; ".join(
            f"{who}: " + ("bitwise equal" if all(d[0] == 0 for d in ds) else
                          "outputs differ " + ", ".join(f"{d[0]} elements up to {d[1]:.2f} ULP"
                                                        for d in ds))
            for who in outs if who != first
            for ds in [[ulp_diff(t, p) for t, p in zip(outs[who], outs[first])]])
        print(f"[{tag}] {name} ({card}): against {first}: {diffs}; "
              + ", ".join(f"{who} {ms:.4f} ms" for who, ms in times), flush=True)
        del outs
        torch.cuda.empty_cache()


def hydro_turns(cs, libs: dict, order: list, card: str, tag: str) -> None:
    """The hydro modes at 256^3, f32 and f64: each library's new state
    against the first's (ULP), then the times in the turns of ``order``
    (CUDA events, 10 launches)."""
    import torch

    first = order[0]
    for dtype in ("float32", "float64"):
        for name, run in hydro_cases(cs, dtype, 256):
            outs, times = {}, []
            for who in order:
                got, again = run(libs[who])
                outs.setdefault(who, tuple(x.clone() for x in got))  # (relaunches update in place)
                times.append((who, cs.time_ms(again, 10)))
                del got, again
            diffs = "; ".join(
                f"{who}: " + ", ".join("bitwise equal" if d[0] == 0 else
                                       f"{d[0]} elements up to {d[1]:.2f} ULP"
                                       for d in map(ulp_diff, outs[who], outs[first]))
                for who in outs if who != first)
            print(f"[{tag}] {name} {dtype} 256^3 ({card}): "
                  + ", ".join(f"{who} {ms:.3f} ms" for who, ms in times)
                  + f"; against {first}: {diffs}", flush=True)
            del outs
            torch.cuda.empty_cache()


def tree_library(tree: str, tag: str):
    """The CUDA library of the checkout ``tree``, built there by its own
    kernels/build.py."""
    spec = importlib.util.spec_from_file_location(
        f"{tag}_build", Path(tree).resolve() / "ramsesgpu_tpu_torch" / "kernels" / "build.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # (its dataclass looks its module up)
    spec.loader.exec_module(mod)
    return mod.load_library("cuda")


def parent(tree: str, parts: list) -> None:
    import torch

    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from ramsesgpu_tpu_torch.kernels import build as b

    from ramsesgpu_tpu_torch.kernels.cfl_mhd import cfl_mhd
    from ramsesgpu_tpu_torch.kernels.mhd_step import MhdStepKernel
    from ramsesgpu_tpu_torch.solvers.timestep import dt_from_inv

    card = cs.card_line()
    libs = {"parent": tree_library(tree, "parent"), "this": b.load_library("cuda")}
    parts = parts or ["step", "hydro", "dissip", "cfl"]
    # the dissipation and MHD CFL kernels: every mode bitwise or in ULP at
    # 72^3-sized grids (partial tiles and rows), f32 and f64, then in turns
    # at the main paths' sizes
    turns = ["parent", "this", "this", "parent"]
    if "dissip" in parts:
        for dtype in ("float32", "float64"):
            kernel_turns(cs, dissip_cases(cs, dtype, False), libs, turns, card, "parent", 3)
        for dtype in ("float32", "float64"):
            kernel_turns(cs, dissip_cases(cs, dtype, True), libs, turns, card, "parent", 10)
    if "cfl" in parts:
        for dtype in ("float32", "float64"):
            kernel_turns(cs, cfl_cases(cs, dtype, False), libs, turns, card, "parent", 3)
        for dtype in ("float32", "float64"):
            kernel_turns(cs, cfl_cases(cs, dtype, True), libs, turns, card, "parent", 50)
    if "step" not in parts and "hydro" not in parts:
        return
    if "step" not in parts:
        hydro_turns(cs, libs, ["parent", "this", "this", "parent"], card, "parent")
        return
    print(f"[parent] {card}; stage buffer values per cell: parent "
          f"{libs['parent'].ramses_mhd_step_scratch_per_cell()}, this "
          f"{libs['this'].ramses_mhd_step_scratch_per_cell()}", flush=True)
    for dtype in ("float32", "float64"):
        for name, _params, run in step_cases(cs, dtype, full=False):
            got = {}
            for who in ("parent", "this"):
                with library(libs[who]):
                    outs, fe, _again = run(libs[who])
                    torch.cuda.synchronize()
                    got[who] = (outs, fe)
            (po, pf), (to, tf) = got["parent"], got["this"]
            diffs = [ulp_diff(t, p) for t, p in zip(to, po)]
            same = all(d[0] == 0 for d in diffs)
            line = f"[parent] {name} {dtype}: " + ("bitwise equal" if same else "outputs differ " + ", ".join(
                f"{d[0]} elements up to {d[1]:.2f} ULP" for d in diffs))
            if pf is not None:
                nd, u = ulp_diff(tf, pf)
                line += f"; fluxes and EMFs {'bitwise equal' if nd == 0 else f'{nd} differ, up to {u:.2f} ULP'}"
            print(line, flush=True)
            del got, po, pf, to, tf
            torch.cuda.empty_cache()
    params, S = cs.setup(256, "float32")
    dt = dt_from_inv(params, cfl_mhd(params, S))
    active = torch.ones((), dtype=torch.bool, device="cuda")
    for who in ("parent", "this"):
        with library(libs[who]):
            k = MhdStepKernel()
            scratch = k.scratch(params, S)
            stages = cs.stage_times(lambda: k(params, S, dt, active, scratch))
        print(f"[parent] {who}'s periodic step at 256^3 f32 by stage (torch.profiler; {card}): "
              + ", ".join(f"{n} {ms:.3f} ms" for n, ms in stages.items()), flush=True)
        del scratch
    del S
    torch.cuda.empty_cache()
    for name, _params, run in step_cases(cs, "float32", full=True):
        times = []
        for who in ("parent", "this", "this", "parent"):
            with library(libs[who]):
                _outs, _fe, again = run(libs[who])
                times.append((who, cs.time_ms(again, 10)))
            del _outs, _fe, again
            torch.cuda.empty_cache()
        print(f"[parent] {name} f32 (main path size; {card}): "
              + ", ".join(f"{who} {ms:.3f} ms" for who, ms in times), flush=True)
    if "hydro" not in parts:
        return
    # the hydro step kernels: bitwise at 72^3 (partial x tiles), then in turns
    for dtype in ("float32", "float64"):
        for name, run in hydro_cases(cs, dtype, 72):
            got = {who: run(libs[who])[0] for who in ("parent", "this")}
            torch.cuda.synchronize()
            diffs = [ulp_diff(t, p) for t, p in zip(got["this"], got["parent"])]
            print(f"[parent] {name} {dtype} 72^3: " + (
                "bitwise equal" if all(d[0] == 0 for d in diffs) else "outputs differ " +
                ", ".join(f"{d[0]} elements up to {d[1]:.2f} ULP" for d in diffs)), flush=True)
            del got
    hydro_turns(cs, libs, ["parent", "this", "this", "parent"], card, "parent")


def zcarry(others: list) -> None:
    """Row 12 of this checkout and of the checkouts ``others``, each mode at
    the main paths' sizes in f32: each one's new state against this one's
    (ULP), then the times in turns this, others, others reversed, this."""
    import torch

    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from ramsesgpu_tpu_torch.kernels import build as b

    card = cs.card_line()
    libs = {"this": b.load_library("cuda"),
            **{t: tree_library(t, f"tree{i}") for i, t in enumerate(others)}}
    order = ["this", *others, *reversed(others), "this"]
    for name, _params, run in step_cases(cs, "float32", full=True, streamed_only=True):
        first, times = {}, []
        for who in order:
            with library(libs[who]):
                outs, _fe, again = run(libs[who])
                first.setdefault(who, outs[0])
                times.append((who, cs.time_ms(again, 10)))
            del outs, _fe, again
        diffs = "; ".join(f"{t}: " + ("bitwise equal" if d[0] == 0 else
                                      f"{d[0]} elements up to {d[1]:.2f} ULP")
                          for t in others for d in [ulp_diff(first[t], first["this"])])
        print(f"[zcarry] {name} f32 (main path size; {card}): "
              + ", ".join(f"{who} {ms:.3f} ms" for who, ms in times)
              + f"; against this: {diffs}", flush=True)
        del first
        torch.cuda.empty_cache()


def kernels(others: list) -> None:
    """csrc/dissip_step.cu and csrc/cfl_mhd.cu of this checkout and of the
    checkouts ``others`` (variants: another tile, threads or cells in
    flight), every mode at the main paths' sizes, f32 and f64: each one's
    outputs against this one's (ULP), then the times in turns this,
    others, others reversed, this."""
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from ramsesgpu_tpu_torch.kernels import build as b

    card = cs.card_line()
    libs = {"this": b.load_library("cuda"),
            **{t: tree_library(t, f"tree{i}") for i, t in enumerate(others)}}
    order = ["this", *others, *reversed(others), "this"]
    for dtype in ("float32", "float64"):
        kernel_turns(cs, dissip_cases(cs, dtype, True), libs, order, card, "kernels", 10)
        kernel_turns(cs, cfl_cases(cs, dtype, True), libs, order, card, "kernels", 50)


def clocks_dissip() -> None:
    """The dissipation kernel's phases: csrc/dissip_step.cu built on its own
    with -DRAMSES_ZCARRY_CLOCKS, one launch of each mode at the main paths'
    sizes, f32 and f64: block 0's thread 0 prints the cycles of each phase
    of its planes, the block barrier that ends it included."""
    import torch

    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from ramsesgpu_tpu_torch.kernels import build as b

    card = cs.card_line()
    nvcc = b.find_nvcc()
    work = Path(tempfile.mkdtemp(dir=b.build_dir()))
    obj, path = work / "dissip_step.o", work / "libdissip_clocks.so"
    for cmd in ([nvcc, *b.compile_flags("cuda", "dissip_step.cu"), "-DRAMSES_ZCARRY_CLOCKS",
                 "-o", str(obj), str(b.CSRC / "dissip_step.cu")],
                [nvcc, *b.LINK_FLAGS, "-o", str(path), str(obj)]):
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(path))
    for name, (args, res) in b._SIGNATURES.items():
        if name.startswith("ramses_dissip_step"):
            getattr(lib, name).argtypes, getattr(lib, name).restype = args, res
    for dtype in ("float32", "float64"):
        for name, run in dissip_cases(cs, dtype, True):
            print(f"[clocks] {name} {dtype} ({card}): one launch", flush=True)
            _outs, _again = run(lib)
            torch.cuda.synchronize()
            del _outs, _again
            torch.cuda.empty_cache()


def hydro(others: list) -> None:
    """The hydro step kernels of this checkout and of the checkouts
    ``others`` at 256^3, in turns this, others, others reversed, this."""
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from ramsesgpu_tpu_torch.kernels import build as b

    card = cs.card_line()
    libs = {"this": b.load_library("cuda"),
            **{t: tree_library(t, f"tree{i}") for i, t in enumerate(others)}}
    hydro_turns(cs, libs, ["this", *others, *reversed(others), "this"], card, "hydro")


if __name__ == "__main__":
    if sys.argv[1:2] == ["trees"] and len(sys.argv) == 4:
        trees(sys.argv[2], sys.argv[3])
    elif sys.argv[1:2] == ["zcarry"] and len(sys.argv) >= 3:
        zcarry(sys.argv[2:])
    elif sys.argv[1:2] == ["hydro"] and len(sys.argv) >= 3:
        hydro(sys.argv[2:])
    elif sys.argv[1:2] == ["parent"] and len(sys.argv) >= 3:
        parent(sys.argv[2], sys.argv[3:])
    elif sys.argv[1:] == ["fmad"]:
        fmad()
    elif sys.argv[1:] == ["clocks"]:
        clocks()
    elif sys.argv[1:] == ["clocks", "hydro"]:
        clocks_hydro()
    elif sys.argv[1:] == ["clocks", "dissip"]:
        clocks_dissip()
    elif sys.argv[1:2] == ["kernels"] and len(sys.argv) >= 3:
        kernels(sys.argv[2:])
    else:
        sys.exit(__doc__)
