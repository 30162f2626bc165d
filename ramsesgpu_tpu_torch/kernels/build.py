"""Build the port's CUDA sources (``csrc/*.cu``) into one shared library
with a plain C interface, loaded with ctypes.

The library is compiled at first use — never at import — into
``build_dir()``, named by a hash of the sources and flags so a stale build
is never loaded. That directory is ``$RAMSES_TORCH_BUILD_DIR`` when set;
else ``build/ramsesgpu_tpu_torch/`` of the source checkout the package runs
from; else, for an installed package, ``ramsesgpu_tpu_torch/`` under the
user's cache directory (``$XDG_CACHE_HOME`` or ``~/.cache``).

- ``build("cuda")``: ``nvcc`` for ``sm_90a`` (Hopper). The kernels launch on
  the stream the caller passes (PyTorch's current stream).
- ``build("host")``: the same sources compiled as plain C++ with ``g++``;
  every stage then runs as a serial loop on host pointers. It exists so the
  CPU test suite can check the arithmetic of the CUDA sources against the
  PyTorch twins where no CUDA compiler exists; it never runs on the main path.
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
SOURCES = ("cfl_mhd.cu", "mhd_step.cu")
HEADERS = ("mhd_common.cuh",)

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
HOST_FLAGS = ("-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC")


@dataclass(frozen=True)
class Build:
    path: Path
    seconds: float   # compile time; 0.0 when an existing build was reused
    log: str         # the compiler's stderr (ptxas register/spill report)


def build_dir() -> Path:
    """Where the library is built and loaded from (see the module note)."""
    override = os.environ.get("RAMSES_TORCH_BUILD_DIR")
    if override:
        return Path(override)
    checkout = Path(__file__).resolve().parents[2]
    if (checkout / "pyproject.toml").exists() and (checkout / "ramsesgpu_tpu").is_dir():
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


def _compiler(kind: str) -> list[str]:
    if kind == "cuda":
        return [find_nvcc(), *NVCC_FLAGS]
    if kind == "host":
        cxx = shutil.which("g++") or shutil.which("c++")
        if cxx is None:
            raise RuntimeError("no C++ compiler found for the host build")
        return [cxx, *HOST_FLAGS]
    raise ValueError(f"unknown build kind {kind!r}")


def _digest(cmd: list[str]) -> str:
    h = hashlib.sha256(" ".join(cmd[1:]).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build(kind: str = "cuda") -> Build:
    """Compile csrc/ (or reuse an identical earlier build). Raises
    RuntimeError with the compiler's output when compilation fails."""
    cmd = _compiler(kind)
    directory = build_dir()
    out = directory / f"libramses_{kind}_{_digest(cmd)}.so"
    if out.exists():
        return Build(out, 0.0, "")
    directory.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=directory)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        res = subprocess.run(
            [*cmd, "-o", tmp, *(str(CSRC / s) for s in SOURCES)],
            capture_output=True, text=True,
        )
        if res.returncode != 0:
            raise RuntimeError(
                f"building csrc/ with {cmd[0]} failed (exit {res.returncode}):\n"
                f"{res.stdout}{res.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return Build(out, time.perf_counter() - t0, res.stderr)


_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "ramses_cfl_mhd_partials": ([], _I),
    "ramses_mhd_step_scratch_per_cell": ([], ctypes.c_longlong),
    "ramses_cfl_mhd_f32": ([_P, _P, _P, _I, _I, _I, _P, _P], _I),
    "ramses_cfl_mhd_f64": ([_P, _P, _P, _I, _I, _I, _P, _P], _I),
    "ramses_mhd_step_f32": ([_P, _P, _P, _P, _I, _I, _I, _P, _P], _I),
    "ramses_mhd_step_f64": ([_P, _P, _P, _P, _I, _I, _I, _P, _P], _I),
}

_loaded: dict[str, ctypes.CDLL] = {}


def load_library(kind: str = "cuda") -> ctypes.CDLL:
    """The built library with every entry point's ctypes signature set."""
    if kind not in _loaded:
        lib = ctypes.CDLL(str(build(kind).path))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _loaded[kind] = lib
    return _loaded[kind]


def param_block(params) -> ctypes.Array:
    """The physical parameters as the C side's P_* double block
    (csrc/mhd_common.cuh). An iorder-1 scheme is slope_type 0."""
    slope = 0.0 if params.iorder == 1 else float(params.slope_type)
    return (ctypes.c_double * 8)(
        params.gamma0, params.smallr, params.smallp, params.smallc, slope,
        params.dx, params.dy, params.dz,
    )
