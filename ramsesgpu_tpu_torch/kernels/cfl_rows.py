"""The device workspace of the CFL reductions' row walk (``csrc/cfl_rows.cuh``),
which the MHD and the hydro CFL kernels (``kernels/cfl_mhd.py``,
``kernels/cfl_hydro.py``) share: the per-block partials and the counter of
the blocks done, which the last block sets back to 0 as it ends.
"""
from __future__ import annotations

import torch

# per (device, dtype): the partials and the counter
_WORK: dict = {}


def workspace(lib, S: torch.Tensor) -> tuple[int, int]:
    """The pointers of the partials and the counter for a reduction on S's
    device and dtype: allocated once (the counter zeroed), then reused by
    every launch of either CFL kernel on the stream, one after another."""
    key = (S.device, S.dtype)
    if key not in _WORK:
        _WORK[key] = (torch.empty(lib.ramses_cfl_rows_partials(), dtype=S.dtype, device=S.device),
                      torch.zeros(1, dtype=torch.int32, device=S.device))
    return tuple(x.data_ptr() for x in _WORK[key])
