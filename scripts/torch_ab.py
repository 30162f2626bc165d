"""A/B timings of the PyTorch + CUDA port (ramsesgpu_tpu_torch) on one
NVIDIA GPU. Run from the root of a checkout.

    python3 scripts/torch_ab.py trees A B   # two checkouts, in turns A, B, B, A
    python3 scripts/torch_ab.py fmad        # mhd_step.cu with and without -fmad=false

``trees``: runs chip_smoke.py's build (phase 2) and main paths 5 (MHD OT
256^3), 13 (MRI 128x256x128, compensated=no) and 17 (OT dissipative) of
checkout A, then B, B and A, each in its own process from the root of its
checkout (its library builds there once and is reused by its second run);
prints each run's ms/step lines and its profiled chunk's device time.

``fmad``: the periodic step at 256^3 f32, plain and compensated, launched
in turns (default, variant, variant, default) from the package's library
and from one whose csrc/mhd_step.cu was compiled with its usual flags plus
-fmad=false (no FMA contraction anywhere in the file); CUDA events over 10
launches each.
"""
from __future__ import annotations

import ctypes
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


if __name__ == "__main__":
    if sys.argv[1:2] == ["trees"] and len(sys.argv) == 4:
        trees(sys.argv[2], sys.argv[3])
    elif sys.argv[1:] == ["fmad"]:
        fmad()
    else:
        sys.exit(__doc__)
