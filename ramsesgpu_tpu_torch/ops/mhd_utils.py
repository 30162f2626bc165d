"""MHD wave-speed helpers, whole-array (the PyTorch twin of
ramsesgpu_tpu/ops/mhd_utils.py; reference mhd_utils.h:29-318)."""
from __future__ import annotations

import torch

from ..config.params import RunParams
from ..core.constants import IA, IB, IC, ID, IP
from .backend import xp


def fast_magnetosonic_speed_dir(params: RunParams, Q: torch.Tensor, bn: torch.Tensor):
    """Fast magnetosonic speed of the primitive state Q [8, ...] given the
    normal field component ``bn`` (mhd_utils.h:30-52)."""
    d = Q[ID]
    p = Q[IP]
    b2 = Q[IA] ** 2 + Q[IB] ** 2 + Q[IC] ** 2
    c2 = params.gamma0 * p / d
    d2 = 0.5 * (b2 / d + c2)
    return xp.sqrt(d2 + xp.sqrt(xp.maximum(d2 * d2 - c2 * bn * bn / d, 0.0)))


def fast_magnetosonic_speeds(params: RunParams, Q: torch.Tensor):
    """(cf_x, cf_y, cf_z) over the whole array."""
    return tuple(fast_magnetosonic_speed_dir(params, Q, Q[c]) for c in (IA, IB, IC))
