"""The ``xp`` namespace the whole-array numerics are written against (the
PyTorch counterpart of ramsesgpu_tpu/ops/backend.py ``JnpBackend``).

Only the pass-through backend is ported: the JAX package's BoxBackend
exists to shrink intermediates inside TPU VMEM tiles, which the CUDA
kernels here do not need.

The difference from jnp that this layer absorbs: ``torch.maximum`` and
``torch.minimum`` take tensors only; a Python scalar is broadcast as a 0-d
tensor of the other operand's dtype (jnp's weak typing does the same
cast). Both propagate NaN, as jnp does.

And ``sqrt``, correctly rounded in float32: some CPU builds of torch round
a float32 square root wrongly in the last place (one value in five on an
AVX-512 host), where g++, XLA and CUDA's ``sqrtf`` round it correctly. The
float32 root is taken in float64 and rounded once more, which is exact: a
double rounding of a square root is harmless with 53 >= 2 * 24 + 2 bits.
Every square root of the twins goes through it.
"""
from __future__ import annotations

import torch

from .stencil import shift_m as _shift_m, shift_p as _shift_p


def _as_tensor_pair(a, b):
    if not isinstance(a, torch.Tensor):
        a = b.new_full((), a)
    if not isinstance(b, torch.Tensor):
        b = a.new_full((), b)
    return a, b


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of x (float32: through float64;
    other dtypes: torch.sqrt)."""
    if x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


class TorchBackend:
    """Roll shifts, maximum/minimum that accept a Python scalar on either
    side, and the correctly rounded sqrt. Everything else is plain torch
    (torch.rsqrt, torch.where, ...)."""

    shift_p = staticmethod(_shift_p)
    shift_m = staticmethod(_shift_m)
    sqrt = staticmethod(sqrt)

    @staticmethod
    def maximum(a, b):
        return torch.maximum(*_as_tensor_pair(a, b))

    @staticmethod
    def minimum(a, b):
        return torch.minimum(*_as_tensor_pair(a, b))


xp = TorchBackend()
