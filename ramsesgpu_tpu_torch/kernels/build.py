"""Build the port's CUDA sources (``csrc/*.cu``) into one shared library
with a plain C interface, loaded with ctypes.

The library is compiled at first use — never at import — into
``build_dir()``, named by a hash of the sources and flags so a stale build
is never loaded. That directory is ``$RAMSES_TORCH_BUILD_DIR`` when set;
else ``build/ramsesgpu_tpu_torch/`` of the source checkout the package runs
from; else, for an installed package, ``ramsesgpu_tpu_torch/`` under the
user's cache directory (``$XDG_CACHE_HOME`` or ``~/.cache``).

- ``build("cuda")``: ``nvcc`` for ``sm_90a`` (Hopper), one process per
  source started together, then one link. The kernels launch on the
  stream the caller passes (PyTorch's current stream).
- ``build("host")``: the same sources compiled as plain C++ with ``g++``;
  every stage then runs as a serial loop on host pointers. It exists so the
  CPU test suite can check the arithmetic of the CUDA sources against the
  PyTorch twins where no CUDA compiler exists; it never runs on the main path.
- ``build("count")``: the host build plus the ``ramses_*_ops`` entry
  points (csrc/op_count.cuh), which run a kernel's code path on a state and
  count its floating-point operations: the work of the kernels' roofline
  bounds (chip_smoke.py).
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
# (the two *_general.cu sources compile the MHD step kernels' general
# instances, any solver pair, beside their HLLD ones: csrc/mhd_stages.cuh Mode)
SOURCES = ("cfl_mhd.cu", "mhd_step.cu", "mhd_step_general.cu", "cfl_hydro.cu", "hydro_step.cu",
           "shear_border.cu", "dissip_step.cu", "zcarry_mhd.cu", "zcarry_mhd_general.cu",
           "zcarry_hydro.cu")
HEADERS = ("common.cuh", "op_count.cuh", "mhd_stages.cuh", "hydro_stages.cuh", "hydro_stream.cuh",
           "cfl_mhd.cuh", "cfl_hydro.cuh", "cfl_rows.cuh")

# per-source compile flags (each source compiles to an object, all in
# parallel) and the link flags of the shared library
COMPILE_FLAGS = {
    "cuda": ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-c"),
    # (-O1: the CPU tests run these sources on 16^3 grids, where -O2 costs
    # more compile time than it saves)
    "host": ("-x", "c++", "-std=c++17", "-O1", "-fPIC", "-c"),
    "count": ("-x", "c++", "-std=c++17", "-O2", "-fPIC", "-c", "-DRAMSES_COUNT_OPS"),
}
LINK_FLAGS = ("-shared",)
# flags of one source beside its kind's: the dissipation kernel, the
# shear border kernels and the hydro CFL kernel repeat their twins'
# roundings (their Kahan carries too; the CFL's products by an exact
# reciprocal), so nothing contracts a product and a sum into an FMA.
# mhd_step.cu keeps contraction and rounds its compensated update stage on
# its own with intrinsics (csrc/common.cuh r_add, r_sub, r_mul).
_NO_FMA = {"cuda": ("-fmad=false",), "host": ("-ffp-contract=off",),
           "count": ("-ffp-contract=off",)}
SOURCE_FLAGS = {"dissip_step.cu": _NO_FMA, "shear_border.cu": _NO_FMA,
                "cfl_hydro.cu": _NO_FMA}


def compile_flags(kind: str, source: str) -> tuple[str, ...]:
    """The flags of one source: its kind's and its own."""
    return COMPILE_FLAGS[kind] + SOURCE_FLAGS.get(source, {}).get(kind, ())


@dataclass(frozen=True)
class Build:
    path: Path
    seconds: float   # compile time; 0.0 when an existing build was reused
    log: str         # the compilers' stderr (ptxas register/spill report)


def build_dir() -> Path:
    """Where the library is built and loaded from (see the module note)."""
    override = os.environ.get("RAMSES_TORCH_BUILD_DIR")
    if override:
        return Path(override)
    checkout = Path(__file__).resolve().parents[2]
    if (checkout / "pyproject.toml").exists() and (checkout / "ramsesgpu_tpu_torch").is_dir():
        return checkout / "build" / "ramsesgpu_tpu_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "ramsesgpu_tpu_torch"


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build csrc/")
    return nvcc


def _compiler(kind: str) -> str:
    if kind == "cuda":
        return find_nvcc()
    if kind in ("host", "count"):
        cxx = shutil.which("g++") or shutil.which("c++")
        if cxx is None:
            raise RuntimeError("no C++ compiler found for the host build")
        return cxx
    raise ValueError(f"unknown build kind {kind!r}")


def _digest(kind: str) -> str:
    flags = [f for source in SOURCES for f in compile_flags(kind, source)]
    h = hashlib.sha256(" ".join(flags + list(LINK_FLAGS)).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build(kind: str = "cuda") -> Build:
    """Compile csrc/ (or reuse an identical earlier build): one compiler
    process per source, all started together, then one link. Processes
    that ask for the same build at once (test workers) take turns on a
    lock file, so one compiles and the others load its library. Raises
    RuntimeError with the compiler's output when a step fails."""
    cxx = _compiler(kind)
    directory = build_dir()
    out = directory / f"libramses_{kind}_{_digest(kind)}.so"
    if out.exists():
        return Build(out, 0.0, "")
    directory.mkdir(parents=True, exist_ok=True)
    with open(out.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return Build(out, 0.0, "")
        return _compile(kind, cxx, directory, out)


def _compile(kind: str, cxx: str, directory: Path, out: Path) -> Build:
    work = Path(tempfile.mkdtemp(dir=directory))
    t0 = time.perf_counter()
    try:
        objs = [work / f"{Path(s).stem}.o" for s in SOURCES]
        procs = [subprocess.Popen([cxx, *compile_flags(kind, s), "-o", str(o), str(CSRC / s)],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for s, o in zip(SOURCES, objs)]
        outputs = [proc.communicate() for proc in procs]  # every compiler ends first
        for src, proc, (stdout, stderr) in zip(SOURCES, procs, outputs):
            if proc.returncode != 0:
                raise RuntimeError(f"compiling csrc/{src} with {cxx} failed "
                                   f"(exit {proc.returncode}):\n{stdout}{stderr}")
        logs = [stderr for _stdout, stderr in outputs]
        lib = work / "lib.so"
        res = subprocess.run([cxx, *LINK_FLAGS, "-o", str(lib), *map(str, objs)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"linking csrc/ with {cxx} failed (exit {res.returncode}):\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(lib, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return Build(out, time.perf_counter() - t0, "".join(logs))


_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "ramses_cfl_rows_partials": ([], _I),
    "ramses_mhd_step_scratch_per_cell": ([], ctypes.c_longlong),
    "ramses_cfl_mhd_f32": ([_P] * 4 + [_I] * 3 + [_P, _P], _I),
    "ramses_cfl_mhd_f64": ([_P] * 4 + [_I] * 3 + [_P, _P], _I),
    "ramses_mhd_step_f32": ([_P] * 4 + [_I] * 4 + [_P, _P], _I),
    "ramses_mhd_step_f64": ([_P] * 4 + [_I] * 4 + [_P, _P], _I),
    "ramses_mhd_step_ghosted_scratch": ([_I] * 4, ctypes.c_longlong),
    "ramses_mhd_step_ghosted_f32": ([_P] * 4 + [_I] * 4 + [_P, _P], _I),
    "ramses_mhd_step_ghosted_f64": ([_P] * 4 + [_I] * 4 + [_P, _P], _I),
    "ramses_cfl_mhd_ghosted_f32": ([_P] * 4 + [_I] * 4 + [ctypes.c_double, _P, _P], _I),
    "ramses_cfl_mhd_ghosted_f64": ([_P] * 4 + [_I] * 4 + [ctypes.c_double, _P, _P], _I),
    "ramses_cfl_mhd_ghosted_shear_f32": ([_P] * 4 + [_I] * 4 + [_P, _P], _I),
    "ramses_cfl_mhd_ghosted_shear_f64": ([_P] * 4 + [_I] * 4 + [_P, _P], _I),
    "ramses_mhd_step_window_scratch": ([_I] * 3, ctypes.c_longlong),
    "ramses_mhd_step_window_f32": ([_P] * 7 + [_I] * 4 + [_P, _P], _I),
    "ramses_mhd_step_window_f64": ([_P] * 7 + [_I] * 4 + [_P, _P], _I),
    "ramses_cfl_mhd_shear_f32": ([_P] * 5 + [_I] * 3 + [_P, _P], _I),
    "ramses_cfl_mhd_shear_f64": ([_P] * 5 + [_I] * 3 + [_P, _P], _I),
    "ramses_mhd_step_shear_scratch": ([_I, _I, _I, _I], ctypes.c_longlong),
    "ramses_mhd_step_shear_f32": ([_P] * 8 + [_I] * 4 + [_P, _P], _I),
    "ramses_mhd_step_shear_f64": ([_P] * 8 + [_I] * 4 + [_P, _P], _I),
    "ramses_shear_slabs_f32": ([_P] * 6 + [_I] * 3 + [_P, _P], _I),
    "ramses_shear_slabs_f64": ([_P] * 6 + [_I] * 3 + [_P, _P], _I),
    "ramses_shear_border_f32": ([_P] * 7 + [_I] * 4 + [_P, _P], _I),
    "ramses_shear_border_f64": ([_P] * 7 + [_I] * 4 + [_P, _P], _I),
    "ramses_cfl_hydro_f32": ([_P] * 4 + [_I] * 4 + [ctypes.c_double, _P, _P], _I),
    "ramses_cfl_hydro_f64": ([_P] * 4 + [_I] * 4 + [ctypes.c_double, _P, _P], _I),
    "ramses_hydro_step_blocks": ([_I], _I),
    "ramses_hydro_stream_tile": ([_I, _P], None),
    "ramses_hydro_stream_ring_bytes": ([_I], ctypes.c_longlong),
    "ramses_hydro_stream_chunk_depth": ([_I] * 5, _I),
    "ramses_hydro_step_f32": ([_P, _P, _I, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P], _I),
    "ramses_hydro_step_f64": ([_P, _P, _I, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P], _I),
    "ramses_dissip_step_launch": ([_I, _I, _I, _I, _P], _I),
    "ramses_dissip_step_f32": ([_P] * 6 + [_I] * 4 + [_P, _P], _I),
    "ramses_dissip_step_f64": ([_P] * 6 + [_I] * 4 + [_P, _P], _I),
    "ramses_dissip_step_strat_f32": ([_P] * 7 + [_I] * 4 + [_P, _P], _I),
    "ramses_dissip_step_strat_f64": ([_P] * 7 + [_I] * 4 + [_P, _P], _I),
    "ramses_dissip_step_ghosted_f32": ([_P] * 4 + [_I] * 4 + [_P, _P], _I),
    "ramses_dissip_step_ghosted_f64": ([_P] * 4 + [_I] * 4 + [_P, _P], _I),
    "ramses_zcarry_mhd_ring_bytes": ([_I], ctypes.c_longlong),
    "ramses_zcarry_mhd_tile": ([_I, _P], None),
    "ramses_zcarry_mhd_chunk_depth": ([_I] * 5, _I),
    "ramses_zcarry_mhd_blocks": ([_I, _I, _I, _P], _I),
    "ramses_zcarry_mhd_f32": ([_P, _P, _I] + [_P] * 7 + [_I] * 4 + [_P, _P], _I),
    "ramses_zcarry_mhd_f64": ([_P, _P, _I] + [_P] * 7 + [_I] * 4 + [_P, _P], _I),
    "ramses_zcarry_hydro_blocks": ([_I], _I),
    "ramses_zcarry_hydro_f32": ([_P, _P, _I, _P, _P, _P, _I, _I, _I, _P, _P], _I),
    "ramses_zcarry_hydro_f64": ([_P, _P, _I, _P, _P, _P, _I, _I, _I, _P, _P], _I),
}

# the operation-counting entry points of build("count")
_L = ctypes.c_longlong
_D = ctypes.c_double
_COUNT_SIGNATURES = {
    "ramses_cfl_mhd_ops": ([_P, _I, _I, _I, _P], _L),
    "ramses_mhd_step_ops": ([_P, _I, _I, _I, _I, _P, _D], _L),
    "ramses_cfl_mhd_shear_ops": ([_P, _P, _I, _I, _I, _P], _L),
    "ramses_mhd_step_ghosted_ops": ([_P] + [_I] * 4 + [_P, _D], _L),
    "ramses_mhd_step_window_ops": ([_P, _P] + [_I] * 4 + [_P, _D, _P], _L),
    "ramses_cfl_mhd_ghosted_shear_ops": ([_P] + [_I] * 4 + [_P], _L),
    "ramses_cfl_mhd_ghosted_ops": ([_P] + [_I] * 4 + [_P], _L),
    "ramses_mhd_step_shear_ops": ([_P] * 4 + [_I] * 4 + [_P, _D], _L),
    "ramses_shear_border_ops": ([_P] * 3 + [_I] * 4 + [_P, _D, _D, _P], None),
    "ramses_cfl_hydro_ops": ([_P, _I, _I, _I, _I, _P], _L),
    "ramses_hydro_step_ops": ([_P, _I, _I, _I, _P, _P, _D, _P, _P], None),
    "ramses_dissip_step_ops": ([_P, _P] + [_I] * 4 + [_P, _D], _L),
}

# the host builds' entry points (not built for the card)
_HOST_SIGNATURES = {
    "ramses_mhd_traced_states_f32": ([_P] * 4 + [_I] * 3 + [_P], _I),
    "ramses_mhd_traced_states_f64": ([_P] * 4 + [_I] * 3 + [_P], _I),
}

_loaded: dict[str, ctypes.CDLL] = {}


def load_library(kind: str = "cuda") -> ctypes.CDLL:
    """The built library with every entry point's ctypes signature set."""
    if kind not in _loaded:
        lib = ctypes.CDLL(str(build(kind).path))
        signatures = dict(_SIGNATURES, **(_HOST_SIGNATURES if kind != "cuda" else {}),
                          **(_COUNT_SIGNATURES if kind == "count" else {}))
        for name, (argtypes, restype) in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _loaded[kind] = lib
    return _loaded[kind]


# the last params object and its block: every launch of a loop step passes
# the same params, and building the block costs more host time per launch
# than a launch of the MRI's small kernels leaves to spare
_last_block: tuple = (None, None)


def param_block(params) -> ctypes.Array:
    """The physical parameters as the C side's P_* double block
    (csrc/common.cuh). An iorder-1 scheme is slope_type 0; the Riemann
    solver travels as its RiemannSolver value. The shearing-box constants
    are formed as the JAX package forms them: the fill's 1.5 omega0 Lx
    with Lx = dx nx and Ly = dy ny (solvers/shear.py:40-45), the remap's
    with Lx = xmax - xmin and Ly = ymax - ymin (godunov_mhd.py:558-561).
    Then nu and eta; then the stratified z faces' flag and the density
    factors of their ghost rows (solvers/stratified.py density_factors);
    then the uniform static gravity (gx, gy, gz), which selects the step
    kernels' gravity instances where one is non-zero; then the MHD corner
    solver as its MagneticRiemannSolver value (another pair than HLLD /
    2D-HLLD selects the MHD step kernels' general instances).
    The block is read, never written, by the C side."""
    global _last_block
    if _last_block[0] is params:
        return _last_block[1]
    from ..solvers.stratified import density_factors, uses_stratified_z

    slope = 0.0 if params.iorder == 1 else float(params.slope_type)
    strat = uses_stratified_z(params)
    lo, hi = density_factors(params) if strat else ((0.0,) * 3, (0.0,) * 3)
    block = (ctypes.c_double * 32)(
        params.gamma0, params.smallr, params.smallp, params.smallc, slope,
        params.dx, params.dy, params.dz,
        params.niter_riemann, params.smallpp, params.gamma6, params.c_iso,
        int(params.riemann_solver),
        params.omega0, params.xmin,
        1.5 * params.omega0 * (params.dx * params.nx), params.dy * params.ny,
        1.5 * params.omega0 * (params.xmax - params.xmin), params.ymax - params.ymin,
        params.nu, params.eta,
        float(strat), *lo, *hi,
        params.gravity_x, params.gravity_y, params.gravity_z,
        int(params.mag_riemann_solver),
    )
    _last_block = (params, block)
    return block


def window_block(params, x0: float) -> ctypes.Array:
    """param_block of ``params`` with its x origin (P_XMIN) set to ``x0``:
    a rank's ghosted window of the sharded shearing box, whose column i has
    its centre at x0 + dx/2 + i dx (csrc/mhd_step.cu, the shear window
    mode). A new block."""
    block = (ctypes.c_double * len(param_block(params)))(*param_block(params))
    block[14] = x0   # P_XMIN (csrc/common.cuh)
    return block
