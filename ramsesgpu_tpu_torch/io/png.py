"""PNG images with colormaps (the port's copy of ramsesgpu_tpu/io/png.py:12-46;
reference HydroRunBase.cpp:4097+ outputPng, src/glutGui/palettes.h): PIL
and matplotlib, imported when an image is written.
"""
from __future__ import annotations

import os

import numpy as np

from ..core.constants import ID


def write_png_colormap(filename: str, field2d: np.ndarray, cmap: str = "viridis",
                       vmin: float | None = None, vmax: float | None = None) -> None:
    """``field2d`` [ny, nx] through ``cmap`` between vmin and vmax (default
    its own range), +y up."""
    import matplotlib
    from PIL import Image

    a = np.asarray(field2d, dtype=np.float64)
    lo = a.min() if vmin is None else vmin
    hi = a.max() if vmax is None else vmax
    norm = (a - lo) / max(hi - lo, 1e-30)
    rgba = (matplotlib.colormaps[cmap](np.clip(norm, 0, 1)) * 255).astype(np.uint8)
    Image.fromarray(rgba[::-1]).save(filename)  # flip so +y is up


def output_png(params, U: np.ndarray, n_step: int, output_dir: str = ".",
               prefix: str = "output", cmap: str = "viridis", vmin=None, vmax=None) -> str:
    """The density of the ghosted state U as ``<prefix>_<step>.png`` (3D:
    its mid-z plane of the ghosted array, as the JAX package takes it)."""
    g = params.ghost_width
    rho = np.asarray(U[ID])
    if params.dim == 3:
        rho = rho[rho.shape[0] // 2]
    rho = rho[g:-g, g:-g]
    os.makedirs(output_dir, exist_ok=True)
    path = f"{output_dir}/{prefix}_{n_step:07d}.png"
    write_png_colormap(path, rho, cmap=cmap, vmin=vmin, vmax=vmax)
    return path
