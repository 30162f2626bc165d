"""Projected (column) density maps (the port's counterpart of
ramsesgpu_tpu/analysis/projected_density.py; reference
computeProjectedDensityMpi.cpp): the density of a snapshot summed along
one axis, saved as npz (and as PNG by io/png.py). numpy, with h5py for
the snapshots.
"""
from __future__ import annotations

import numpy as np

from ..config.configmap import ConfigMap


def projected_density(params, U, axis: str = "z") -> np.ndarray:
    from ..core.constants import ID

    g = params.ghost_width
    sl = (slice(g, -g),) * params.dim
    rho = np.asarray(U[ID][sl])
    ax = {"z": 0, "y": 1, "x": 2}[axis] if params.dim == 3 else {"y": 0, "x": 1}[axis]
    return rho.sum(axis=ax)


def main(argv=None) -> int:
    import argparse

    from ..config.params import params_from_config
    from ..io.hdf5 import input_hdf5
    from .read_slice import require_h5py

    parser = argparse.ArgumentParser(description="projected density maps")
    parser.add_argument("--param", required=True)
    parser.add_argument("files", nargs="+")
    parser.add_argument("--axis", default="z", choices=["x", "y", "z"])
    parser.add_argument("--png", action="store_true", help="also write PNGs")
    args = parser.parse_args(argv)

    require_h5py("projected_density")
    params = params_from_config(ConfigMap(args.param))
    for fname in args.files:
        U, t, step = input_hdf5(params, fname)
        proj = projected_density(params, U, args.axis)
        out = fname.replace(".h5", f"_proj{args.axis}.npz")
        np.savez(out, projected_density=proj, time=t, step=step)
        if args.png:
            from ..io.png import write_png_colormap

            write_png_colormap(out.replace(".npz", ".png"), proj)
        print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
