"""Fractional Brownian motion field generator (the port's own copy of
ramsesgpu_tpu/analysis/generate_fbm.py, numpy as there; reference
src/analysis/powerSpectrum/generate_fBm.cpp): a Gaussian random field with
the power-law spectrum P(k) ~ k^(-(2H + dim)) by spectral synthesis. It
seeds turbulence states and checks the power spectrum tool, which must
read a generated field's slope back.
"""
from __future__ import annotations

import numpy as np


def generate_fbm(shape, hurst: float = 0.5, seed: int = 0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    ndim = len(shape)
    ks = [np.fft.fftfreq(n, d=1.0 / n) for n in shape]
    grids = np.meshgrid(*ks, indexing="ij")
    kmag = np.sqrt(sum(g * g for g in grids))
    kmag[tuple([0] * ndim)] = 1.0  # no division by zero at k = 0

    beta = 2.0 * hurst + ndim
    amplitude = kmag ** (-beta / 2.0)
    amplitude[tuple([0] * ndim)] = 0.0

    phase = rng.rand(*shape) * 2 * np.pi
    spec = amplitude * np.exp(1j * phase)
    field = np.real(np.fft.ifftn(spec))
    return (field - field.mean()) / max(field.std(), 1e-30)


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="generate an fBm random field")
    parser.add_argument("--size", type=int, default=64)
    parser.add_argument("--dim", type=int, default=3, choices=[2, 3])
    parser.add_argument("--hurst", type=float, default=0.5)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default="fbm.npz")
    args = parser.parse_args(argv)

    field = generate_fbm((args.size,) * args.dim, args.hurst, args.seed)
    np.savez(args.out, field=field, hurst=args.hurst)
    print(f"wrote {args.out} shape={field.shape}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
