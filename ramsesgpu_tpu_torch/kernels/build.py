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
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("cfl_mhd.cu", "mhd_step.cu", "cfl_hydro.cu", "hydro_step.cu", "shear_border.cu",
           "dissip_step.cu")
HEADERS = ("common.cuh", "op_count.cuh")

# per-source compile flags (each source compiles to an object, all in
# parallel) and the link flags of the shared library
COMPILE_FLAGS = {
    "cuda": ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-c"),
    "host": ("-x", "c++", "-std=c++17", "-O2", "-fPIC", "-c"),
    "count": ("-x", "c++", "-std=c++17", "-O2", "-fPIC", "-c", "-DRAMSES_COUNT_OPS"),
}
LINK_FLAGS = ("-shared",)
# flags of one source beside its kind's: the dissipation kernel repeats its
# twin's roundings, so nothing contracts a product and a sum into an FMA
SOURCE_FLAGS = {
    "dissip_step.cu": {"cuda": ("-fmad=false",), "host": ("-ffp-contract=off",),
                       "count": ("-ffp-contract=off",)},
}


def compile_flags(kind: str, source: str) -> tuple[str, ...]:
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
    process per source, all started together, then one link. Raises
    RuntimeError with the compiler's output when a step fails."""
    cxx = _compiler(kind)
    directory = build_dir()
    out = directory / f"libramses_{kind}_{_digest(kind)}.so"
    if out.exists():
        return Build(out, 0.0, "")
    directory.mkdir(parents=True, exist_ok=True)
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
    "ramses_cfl_mhd_partials": ([], _I),
    "ramses_mhd_step_scratch_per_cell": ([], ctypes.c_longlong),
    "ramses_cfl_mhd_f32": ([_P, _P, _P, _I, _I, _I, _P, _P], _I),
    "ramses_cfl_mhd_f64": ([_P, _P, _P, _I, _I, _I, _P, _P], _I),
    "ramses_mhd_step_f32": ([_P, _P, _P, _P, _I, _I, _I, _P, _P], _I),
    "ramses_mhd_step_f64": ([_P, _P, _P, _P, _I, _I, _I, _P, _P], _I),
    "ramses_cfl_mhd_shear_f32": ([_P, _P, _P, _P, _I, _I, _I, _P, _P], _I),
    "ramses_cfl_mhd_shear_f64": ([_P, _P, _P, _P, _I, _I, _I, _P, _P], _I),
    "ramses_mhd_step_shear_scratch": ([_I, _I, _I], ctypes.c_longlong),
    "ramses_mhd_step_shear_f32": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P], _I),
    "ramses_mhd_step_shear_f64": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P], _I),
    "ramses_shear_slabs_f32": ([_P, _P, _P, _P, _P, _I, _I, _I, _P, _P], _I),
    "ramses_shear_slabs_f64": ([_P, _P, _P, _P, _P, _I, _I, _I, _P, _P], _I),
    "ramses_shear_border_f32": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P], _I),
    "ramses_shear_border_f64": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P], _I),
    "ramses_cfl_hydro_partials": ([], _I),
    "ramses_cfl_hydro_f32": ([_P, _P, _P, _I, _I, _I, _I, _P, _P], _I),
    "ramses_cfl_hydro_f64": ([_P, _P, _P, _I, _I, _I, _I, _P, _P], _I),
    "ramses_hydro_step_scratch": ([_I, _I, _I, _I], ctypes.c_longlong),
    "ramses_hydro_step_f32": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P], _I),
    "ramses_hydro_step_f64": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P], _I),
    "ramses_dissip_step_scratch": ([_I, _I, _I, _I], ctypes.c_longlong),
    "ramses_dissip_step_f32": ([_P, _P, _P, _P, _I, _I, _I, _P, _P], _I),
    "ramses_dissip_step_f64": ([_P, _P, _P, _P, _I, _I, _I, _P, _P], _I),
    "ramses_dissip_step_shear_f32": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P], _I),
    "ramses_dissip_step_shear_f64": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P], _I),
}

# the operation-counting entry points of build("count")
_L = ctypes.c_longlong
_COUNT_SIGNATURES = {
    "ramses_cfl_mhd_ops": ([_P, _I, _I, _I, _P], _L),
    "ramses_mhd_step_ops": ([_P, _I, _I, _I, _P, ctypes.c_double], _L),
    "ramses_cfl_mhd_shear_ops": ([_P, _P, _I, _I, _I, _P], _L),
    "ramses_mhd_step_shear_ops": ([_P, _P, _I, _I, _I, _P, ctypes.c_double], _L),
    "ramses_shear_border_ops": ([_P, _P, _P, _I, _I, _I, _P, ctypes.c_double, ctypes.c_double,
                                 _P], None),
    "ramses_cfl_hydro_ops": ([_P, _I, _I, _I, _I, _P], _L),
    "ramses_hydro_step_ops": ([_P, _I, _I, _I, _P, _P, ctypes.c_double, _P, _P], None),
    "ramses_dissip_step_ops": ([_P, _I, _I, _I, _P, ctypes.c_double], _L),
    "ramses_dissip_step_shear_ops": ([_P, _P, _I, _I, _I, _P, ctypes.c_double], _L),
}

_loaded: dict[str, ctypes.CDLL] = {}


def load_library(kind: str = "cuda") -> ctypes.CDLL:
    """The built library with every entry point's ctypes signature set."""
    if kind not in _loaded:
        lib = ctypes.CDLL(str(build(kind).path))
        signatures = dict(_SIGNATURES, **(_COUNT_SIGNATURES if kind == "count" else {}))
        for name, (argtypes, restype) in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _loaded[kind] = lib
    return _loaded[kind]


def param_block(params) -> ctypes.Array:
    """The physical parameters as the C side's P_* double block
    (csrc/common.cuh). An iorder-1 scheme is slope_type 0; the Riemann
    solver travels as its RiemannSolver value. The shearing-box constants
    are formed as the JAX package forms them: the fill's 1.5 omega0 Lx
    with Lx = dx nx and Ly = dy ny (solvers/shear.py:40-45), the remap's
    with Lx = xmax - xmin and Ly = ymax - ymin (godunov_mhd.py:558-561).
    Then nu and eta."""
    slope = 0.0 if params.iorder == 1 else float(params.slope_type)
    return (ctypes.c_double * 21)(
        params.gamma0, params.smallr, params.smallp, params.smallc, slope,
        params.dx, params.dy, params.dz,
        params.niter_riemann, params.smallpp, params.gamma6, params.c_iso,
        int(params.riemann_solver),
        params.omega0, params.xmin,
        1.5 * params.omega0 * (params.dx * params.nx), params.dy * params.ny,
        1.5 * params.omega0 * (params.xmax - params.xmin), params.ymax - params.ymin,
        params.nu, params.eta,
    )
