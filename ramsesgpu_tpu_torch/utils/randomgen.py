"""Portable random deviate generator (the port's copy of
ramsesgpu_tpu/utils/randomgen.py, numpy only).

Counterpart of the reference's RandomGen class
(reference: src/hydro/RandomGen.{h,cpp} — a portable LCG with Gaussian and
Poisson deviates feeding the turbulence forcing): same interface
(rans/gaussDev/poissonDev), numpy-backed streams. Bit-exact replication of
the legacy LCG is deliberately not attempted; the statistical contract
(uniform/Gaussian/Poisson deviates from per-cpu seeds) is identical.
"""
from __future__ import annotations

import numpy as np


class RandomGen:
    def __init__(self, seed: int = 0):
        self._rng = np.random.RandomState(seed)

    def rans(self, n_cpu: int, seed: int, out=None) -> np.ndarray:
        """Generate n_cpu 4-integer seed tuples from a master seed
        (RandomGen::rans)."""
        master = np.random.RandomState(seed)
        seeds = master.randint(1, 2**31 - 1, size=(n_cpu, 4)).astype(np.int64)
        if out is not None:
            out[:] = seeds.ravel()[: len(out)]
        return seeds

    def gauss_dev(self, seed_state=None) -> float:
        """One N(0,1) deviate (RandomGen::gaussDev)."""
        return float(self._rng.randn())

    # reference-compatible camelCase aliases
    gaussDev = gauss_dev

    def poisson_dev(self, mean: float) -> int:
        """One Poisson deviate (RandomGen::poissonDev)."""
        return int(self._rng.poisson(mean))

    poissonDev = poisson_dev

    def uniform(self) -> float:
        return float(self._rng.rand())
