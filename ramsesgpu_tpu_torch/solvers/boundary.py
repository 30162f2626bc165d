"""Ghost-cell boundary fill (the PyTorch twin of
ramsesgpu_tpu/solvers/boundary.py). Only fully periodic boundaries are
ported: the ghosts are then a wrap pad of the interior."""
from __future__ import annotations

import torch

from ramsesgpu_tpu.config.params import RunParams
from ramsesgpu_tpu.core.constants import BoundaryConditionType as BCT


def require_periodic(params: RunParams) -> None:
    if any(b != BCT.BC_PERIODIC for b in params.boundary_types):
        names = [b.name for b in params.boundary_types]
        raise NotImplementedError(
            f"only fully periodic boundaries are ported, got {names}"
        )


def interior(params: RunParams, U: torch.Tensor) -> torch.Tensor:
    """The interior block [nvar, nz, ny, nx] of a ghosted 3D state (a view)."""
    g = params.ghost_width
    return U[:, g:-g, g:-g, g:-g]


def wrap_pad(S: torch.Tensor, g: int) -> torch.Tensor:
    """Periodic ghost frame of width g around the last three axes of S."""
    for axis in (-3, -2, -1):
        n = S.shape[axis]
        idx = torch.arange(-g, n + g, device=S.device) % n
        S = torch.index_select(S, axis % S.ndim, idx)
    return S


def make_boundaries(params: RunParams, U: torch.Tensor) -> torch.Tensor:
    """Fill all ghost layers of a 3D ghosted state (X, Y, Z order in the
    reference; for periodic walls every order gives the wrap pad)."""
    require_periodic(params)
    if params.dim != 3:
        raise NotImplementedError("only 3D is ported")
    return wrap_pad(interior(params, U), params.ghost_width)
