"""Extract a 2D slice from a (large) 3D snapshot (the port's counterpart of
ramsesgpu_tpu/analysis/read_slice.py; reference readSlice.cpp): h5py reads
one hyperslab without loading the cube. h5py is imported when called and
named when missing.
"""
from __future__ import annotations

import importlib.util

import numpy as np


def require_h5py(tool: str) -> None:
    """Raise ImportError naming h5py when it is not installed."""
    if importlib.util.find_spec("h5py") is None:
        raise ImportError(f"{tool} reads HDF5 snapshots and needs h5py, which is not installed")


def read_slice(filename: str, dataset: str, axis: str, index: int) -> np.ndarray:
    require_h5py("read_slice")
    import h5py

    with h5py.File(filename, "r") as f:
        dset = f[dataset]
        if dset.ndim != 3:
            raise ValueError(f"dataset {dataset} is not 3D")
        if axis == "z":
            return np.asarray(dset[index, :, :])
        if axis == "y":
            return np.asarray(dset[:, index, :])
        return np.asarray(dset[:, :, index])


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="extract a 2D slice from a snapshot")
    parser.add_argument("file")
    parser.add_argument("--dataset", default="density")
    parser.add_argument("--axis", default="z", choices=["x", "y", "z"])
    parser.add_argument("--index", type=int, default=0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    sl = read_slice(args.file, args.dataset, args.axis, args.index)
    out = args.out or args.file.replace(".h5", f"_{args.dataset}_{args.axis}{args.index}.npz")
    np.savez(out, slice=sl)
    print(f"wrote {out} shape={sl.shape}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
