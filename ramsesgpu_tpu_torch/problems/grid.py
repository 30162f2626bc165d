"""Cell-center coordinate grids for problem initializers.

Coordinates follow the reference convention
(HydroRunBase.cpp:5590-5600): xPos = xMin + dx/2 + (i - ghostWidth)*dx,
evaluated here for every cell *including ghosts* (ghost coordinates fall
outside the domain, which initializers may rely on; ghost values are
overwritten by the first boundary fill anyway).

Arrays are produced in the framework layout [(z,) y, x].

The port's own copy of ramsesgpu_tpu/problems/grid.py: the port imports nothing of
the JAX package.
"""
from __future__ import annotations

import numpy as np

from ..config.params import RunParams


def cell_centers_1d(params: RunParams, direction: str) -> np.ndarray:
    g = params.ghost_width
    if direction == "x":
        n, lo, d = params.isize, params.xmin, params.dx
    elif direction == "y":
        n, lo, d = params.jsize, params.ymin, params.dy
    else:
        n, lo, d = params.ksize, params.zmin, params.dz
    idx = np.arange(n)
    return lo + d / 2 + (idx - g) * d


def coords(params: RunParams):
    """Broadcastable coordinate arrays (x, y[, z]) in grid layout."""
    x = cell_centers_1d(params, "x")
    y = cell_centers_1d(params, "y")
    if params.dim == 2:
        X, Y = np.meshgrid(x, y, indexing="xy")  # [y, x]
        return X, Y
    z = cell_centers_1d(params, "z")
    Z, Y, X = np.meshgrid(z, y, x, indexing="ij")  # [z, y, x]
    return X, Y, Z


def index_grids(params: RunParams):
    """Raw (i, j[, k]) integer index grids (absolute, ghost-inclusive) for
    initializers defined on indices, like sod/implode (HydroRunBase.cpp:5367)."""
    i = np.arange(params.isize)
    j = np.arange(params.jsize)
    if params.dim == 2:
        J, I = np.meshgrid(j, i, indexing="ij")
        return I, J
    k = np.arange(params.ksize)
    K, J, I = np.meshgrid(k, j, i, indexing="ij")
    return I, J, K
