"""TVD slope limiters, whole-array (the PyTorch twin of
ramsesgpu_tpu/ops/slopes.py; reference slope.h:41-147)."""
from __future__ import annotations

import torch

from ..config.params import RunParams

from .backend import xp


def slope_1d(params: RunParams, q: torch.Tensor, axis: int) -> torch.Tensor:
    """Limited slope of q along ``axis``:
    sign(dcen) * min(|dlft|, |drgt|, |dcen|), zeroed at extrema."""
    if params.slope_type == 0 or params.iorder == 1:
        return torch.zeros_like(q)
    q_p = xp.shift_p(q, axis)
    q_m = xp.shift_m(q, axis)
    dlft = params.slope_type * (q - q_m)
    drgt = params.slope_type * (q_p - q)
    dcen = 0.5 * (q_p - q_m)
    dsgn = torch.where(dcen >= 0.0, 1.0, -1.0).to(q.dtype)
    dlim = torch.minimum(torch.abs(dlft), torch.abs(drgt))
    dlim = torch.where(dlft * drgt <= 0.0, 0.0, dlim)
    return dsgn * torch.minimum(dlim, torch.abs(dcen))


def slopes_unsplit(params: RunParams, Q: torch.Tensor) -> tuple:
    """Slopes in every direction for the unsplit scheme: (dqX, dqY) in 2D,
    (dqX, dqY, dqZ) in 3D, each of Q's shape."""
    return tuple(slope_1d(params, Q, axis) for axis in (-1, -2, -3)[: params.dim])
