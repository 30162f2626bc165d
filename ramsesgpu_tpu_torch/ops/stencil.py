"""Stencil shift helpers for the whole-array numerics (the PyTorch twin of
ramsesgpu_tpu/ops/stencil.py).

Shifts are ``torch.roll``: on a ghosted array the ghost layers absorb the
wrap; on the port's interior-only periodic state the wrap IS the periodic
boundary condition.
"""
from __future__ import annotations

import torch


def shift_p(a: torch.Tensor, axis: int) -> torch.Tensor:
    """Value at the next cell along ``axis``: out[i] = a[i+1]."""
    return torch.roll(a, -1, dims=axis)


def shift_m(a: torch.Tensor, axis: int) -> torch.Tensor:
    """Value at the previous cell along ``axis``: out[i] = a[i-1]."""
    return torch.roll(a, 1, dims=axis)


def shift(a: torch.Tensor, axis: int, offset: int) -> torch.Tensor:
    """out[i] = a[i+offset] along ``axis`` (wraps)."""
    return torch.roll(a, -offset, dims=axis)
