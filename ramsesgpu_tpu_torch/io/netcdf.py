"""NetCDF snapshot writer and reader (the port's copy of
ramsesgpu_tpu/io/netcdf.py:31-136; reference HydroRunBase.cpp:4120+,
HydroRunBaseMpi.cpp:6046-6503 output, :7505-7862 restart input).

The same dispatch as the JAX package: the netCDF4 package when it imports
(a NetCDF-4/HDF5 container), otherwise scipy's classic NetCDF-3 (64-bit
offset, ``netcdf_file(..., version=2)``). Each branch keeps the JAX
package's attribute names: netCDF4 "time step", "total time", "ghost
included"; NetCDF-3 "time_step", "total_time", "ghost_included" (its names
cannot hold a space). One variable per conserved component, named as the
HDF5 datasets (io/hdf5.py). Where neither h5py nor netCDF4 is installed,
as on a machine with only scipy, this is the checkpoint format that runs.

``write_classic_stream`` writes the NetCDF-3 file scipy writes, byte for
byte, one variable at a time from a callback, so a distributed run's rank 0
(io/sharded.py output_netcdf_sharded) holds one variable of the global
state at a time.
"""
from __future__ import annotations

from pathlib import Path
from typing import Callable

import numpy as np

from ..config.params import RunParams
from .hdf5 import dataset_names


def have_netcdf4() -> bool:
    try:
        import netCDF4  # noqa: F401

        return True
    except ImportError:
        return False


def output_netcdf(params: RunParams, U: np.ndarray, n_step: int, path: str,
                  total_time: float = 0.0, ghost_included: bool = False) -> str:
    """Write the ghosted state U (numpy) as ``path``: its interior, or the
    whole ghosted array with ``ghost_included``."""
    g = params.ghost_width
    U = np.asarray(U)
    if not ghost_included:
        U = U[(slice(None),) + (slice(g, -g),) * params.dim]
    dims = ("z", "y", "x")[-params.dim:]

    if have_netcdf4():
        import netCDF4

        ds = netCDF4.Dataset(path, "w")
        try:
            for name, size in zip(dims, U.shape[1:]):
                ds.createDimension(name, size)
            for i, name in enumerate(dataset_names(params)):
                var = ds.createVariable(name, U.dtype, dims)
                var[...] = U[i]
            ds.setncattr("time step", np.int32(n_step))
            ds.setncattr("total time", float(total_time))
            ds.setncattr("ghost included", np.int32(1 if ghost_included else 0))
        finally:
            ds.close()
        return path

    from scipy.io import netcdf_file

    ds = netcdf_file(path, "w", version=2)
    try:
        for name, size in zip(dims, U.shape[1:]):
            ds.createDimension(name, size)
        for i, name in enumerate(dataset_names(params)):
            var = ds.createVariable(name, U.dtype, dims)
            var[...] = U[i]
        setattr(ds, "time_step", np.int32(n_step))
        setattr(ds, "total_time", np.float64(total_time))
        setattr(ds, "ghost_included", np.int32(1 if ghost_included else 0))
    finally:
        ds.close()
    return path


def input_netcdf(params: RunParams, filename: str | Path) -> tuple[np.ndarray, float, int]:
    """A NetCDF snapshot as the full ghosted state (numpy, the run's dtype),
    from a ghost-included or an interior-only file (then the ghosts are 0);
    returns (U, total_time, time_step)."""
    g = params.ghost_width
    dtype = np.float64 if params.dtype == "float64" else np.float32
    U = np.zeros(params.shape, dtype=dtype)

    def fill(get_var, get_attr):
        for i, name in enumerate(dataset_names(params)):
            data = np.asarray(get_var(name), dtype=dtype)
            if data.shape == U[i].shape:
                U[i] = data
            else:
                interior = (slice(g, -g),) * params.dim
                if data.shape != U[i][interior].shape:
                    raise ValueError(
                        f"restart dataset {name} has shape {data.shape}, "
                        f"expected {U[i].shape} (ghosted) or "
                        f"{U[i][interior].shape} (interior)")
                U[i][interior] = data
        total_time = float(get_attr("total time", "total_time", 0.0))
        time_step = int(get_attr("time step", "time_step", 0))
        return total_time, time_step

    if have_netcdf4():
        import netCDF4

        ds = netCDF4.Dataset(filename, "r")
        try:
            def attr(name, alt, default):
                for n in (name, alt):
                    if n in ds.ncattrs():
                        return ds.getncattr(n)
                return default

            total_time, time_step = fill(lambda n: ds.variables[n][...], attr)
        finally:
            ds.close()
    else:
        from scipy.io import netcdf_file

        ds = netcdf_file(str(filename), "r", mmap=False)
        try:
            def attr(name, alt, default):
                for n in (name, alt):
                    v = getattr(ds, n.replace(" ", "_"), None)
                    if v is not None:
                        return v
                return default

            total_time, time_step = fill(lambda n: ds.variables[n].data, attr)
        finally:
            ds.close()
    return U, total_time, time_step


# the classic format's tags and types (NetCDF Users Guide, "File Format
# Specification"), as scipy.io.netcdf_file writes them
_NC_DIMENSION, _NC_VARIABLE, _NC_ATTRIBUTE = b"\x00\x00\x00\n", b"\x00\x00\x00\x0b", \
    b"\x00\x00\x00\x0c"
_ABSENT = b"\x00" * 8
_NC_TYPE = {np.dtype(np.int32): b"\x00\x00\x00\x04", np.dtype(np.float32): b"\x00\x00\x00\x05",
            np.dtype(np.float64): b"\x00\x00\x00\x06"}


def _int(value: int) -> bytes:
    return np.array(value, ">i4").tobytes()


def _name(s: str) -> bytes:
    raw = s.encode("latin1")
    return _int(len(raw)) + raw + b"\x00" * (-len(raw) % 4)


def write_classic_stream(path: str | Path, dims: dict[str, int], names: tuple[str, ...],
                         dtype, attrs: dict[str, np.generic],
                         variable: Callable[[int], np.ndarray]) -> Path:
    """Write the NetCDF-3 64-bit-offset file that scipy's ``netcdf_file(path,
    "w", version=2)`` writes for fixed-size variables ``names`` over
    ``dims`` (every variable on every dimension, in order) and the scalar
    global attributes ``attrs`` (np.int32 or np.float64), byte for byte,
    taking variable i's data from ``variable(i)`` (an array of the dims'
    shape) when its turn comes: one variable in memory at a time."""
    dtype = np.dtype(dtype)
    shape = tuple(dims.values())
    vsize = int(np.prod(shape)) * dtype.itemsize
    head = [b"CDF\x02", _int(0), _NC_DIMENSION, _int(len(dims))]
    head += [_name(n) + _int(size) for n, size in dims.items()]
    head += [_NC_ATTRIBUTE, _int(len(attrs))] if attrs else [_ABSENT]
    for key, value in attrs.items():
        value = np.asarray(value)
        raw = value.astype(value.dtype.newbyteorder(">")).tobytes()
        head += [_name(key), _NC_TYPE[value.dtype], _int(1), raw, b"\x00" * (-len(raw) % 4)]
    head += [_NC_VARIABLE, _int(len(names))]
    meta = [_name(n) + _int(len(shape)) + b"".join(_int(i) for i in range(len(shape)))
            + _ABSENT + _NC_TYPE[dtype] + _int(vsize) for n in names]
    begin = sum(len(h) for h in head) + sum(len(m) + 8 for m in meta)
    with open(path, "wb") as f:
        f.write(b"".join(head))
        for k, m in enumerate(meta):
            f.write(m + np.array(begin + k * (vsize + -vsize % 4), ">i8").tobytes())
        for i in range(len(names)):
            data = np.asarray(variable(i))
            if data.shape != shape:
                raise ValueError(f"variable {names[i]} has shape {data.shape}, expected {shape}")
            f.write(data.astype(dtype.newbyteorder(">"), copy=False).tobytes())
            f.write(b"\x00" * (-vsize % 4))
    return Path(path)
