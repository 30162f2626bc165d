"""Snapshot format converter (the port's copy of ramsesgpu_tpu/io/convert.py:17-72;
the reference's ioConvert tool, src/utils/IO/ioConvert.cpp): an HDF5
snapshot to VTI, NRRD, npz or NetCDF (NetCDF-3 through scipy where the
netCDF4 package is not installed).

    python -m ramsesgpu_tpu_torch.io.convert --param run.ini --to nc snapshot.h5 ...
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np


def convert(params, src: str, fmt: str, out: str | None = None) -> Path:
    """Convert the HDF5 snapshot ``src`` to ``fmt`` (vti, nrrd, npz, nc);
    returns the new file's path (default: src with fmt's suffix)."""
    from .hdf5 import dataset_names, input_hdf5

    U, t, step = input_hdf5(params, src)
    g = params.ghost_width
    interior = (slice(None),) + (slice(g, -g),) * params.dim
    Ui = U[interior]
    base = Path(out) if out else Path(src).with_suffix("." + fmt)

    if fmt == "vti":
        from .vtk import write_vti

        names = dataset_names(params)
        write_vti(base, {n: Ui[i] for i, n in enumerate(names)},
                  origin=(params.xmin, params.ymin, params.zmin),
                  spacing=(params.dx, params.dy, params.dz if params.dim == 3 else 1.0))
    elif fmt == "nrrd":
        from .misc_formats import write_nrrd

        write_nrrd(base, Ui)
    elif fmt == "npz":
        np.savez(base, **{n: Ui[i] for i, n in enumerate(dataset_names(params))},
                 time=t, step=step)
    elif fmt == "nc":
        from .netcdf import output_netcdf

        output_netcdf(params, U, step, str(base), total_time=t)
    else:
        raise ValueError(f"unknown target format {fmt!r}")
    return base


def main(argv=None) -> int:
    import argparse

    from ..config.configmap import ConfigMap
    from ..config.params import params_from_config

    parser = argparse.ArgumentParser(description="convert snapshot formats")
    parser.add_argument("--param", required=True)
    parser.add_argument("--to", required=True, choices=["vti", "nrrd", "npz", "nc"])
    parser.add_argument("files", nargs="+")
    args = parser.parse_args(argv)

    params = params_from_config(ConfigMap(args.param))
    for f in args.files:
        out = convert(params, f, args.to)
        print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
