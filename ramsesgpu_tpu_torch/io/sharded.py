"""Snapshot output of a distributed run without gathering the state (the
port's counterpart of ramsesgpu_tpu/io/sharded.py:72-229; reference
HydroRunBaseMpi.cpp:4206-4227 per-rank VTK pieces and the rank-0 ``.pvti``
master, :4835-5557 the collective PHDF5 hyperslabs).

- ``output_vtk_pieces``: every rank writes its own interior block as the
  piece ``<prefix>_<step:07d>_p<k:04d>.vti``, k its rank (the JAX
  ``global_piece_table`` numbers the pieces by device id, which its mesh
  lays out in the same (z, y, x) order as the port's ranks), and rank 0
  writes the ``<prefix>_<step:07d>.pvti`` master that lists them all.
- ``output_hdf5_sharded``: one global-shape ``<prefix>_<step:07d>.h5``
  with the serial writer's datasets and attributes (io/hdf5.py), and its
  XDMF wrapper. Rank 0 writes its own block, then receives the other
  ranks' blocks one at a time and writes each into its hyperslab, so the
  global array is never held on one host.
- ``output_netcdf_sharded`` (JAX :357-432, its single-process branch):
  one global-shape ``<prefix>_<step:07d>.nc`` with io/netcdf.py's
  variables and attributes, interior only. Rank 0 writes it one variable
  at a time, each assembled from the ranks' blocks of that variable as it
  is written (scipy's NetCDF-3 file byte for byte, io/netcdf.py
  write_classic_stream; netCDF4 where it imports), so it holds one
  variable of the global state, never the whole.

Every rank calls each writer. Both end in a barrier, so the files are
whole when any rank returns.
"""
from __future__ import annotations

import datetime
import importlib.util
import os
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..config.params import RunParams
from ..core.constants import var_names
from ..parallel.mesh import ProcessGrid, block_slices
from .hdf5 import dataset_names, write_xdmf_wrapper
from .vtk import write_vti


def _n_ranks(grid: ProcessGrid) -> int:
    return grid.mx * grid.my * grid.mz


def piece_extent(params: RunParams, grid: ProcessGrid, rank: int) -> tuple:
    """(ox, oy, oz, nx, ny, nz): the cell offset and extent of rank
    ``rank``'s block in the global interior (oz = 0, nz = 1 in 2D)."""
    spatial = block_slices(params, grid, rank)[1:][::-1] + (slice(0, 1),) * (3 - params.dim)
    return (*(s.start for s in spatial), *(s.stop - s.start for s in spatial))


def _barrier(grid: ProcessGrid) -> None:
    if _n_ranks(grid) > 1:
        dist.barrier()


def output_vtk_pieces(params: RunParams, grid: ProcessGrid, U_local: torch.Tensor,
                      n_step: int, output_dir: str = ".", prefix: str = "output",
                      binary: bool = True) -> Path:
    """Write this rank's ``.vti`` piece of its interior block U_local
    [nvar, (lnz,) lny, lnx] and, on rank 0, the ``.pvti`` master; returns
    the master's path (JAX io/sharded.py:87-160, byte for byte)."""
    os.makedirs(output_dir, exist_ok=True)
    names = var_names(params.nb_var)
    origin = (params.xmin, params.ymin, params.zmin)
    spacing = (params.dx, params.dy, params.dz if params.dim == 3 else 1.0)
    data = U_local.cpu().numpy()
    ox, oy, oz = piece_extent(params, grid, grid.rank)[:3]
    write_vti(Path(output_dir) / f"{prefix}_{n_step:07d}_p{grid.rank:04d}.vti",
              {name: data[i] for i, name in enumerate(names)}, origin=origin,
              spacing=spacing, binary=binary, extent_offset=(ox, oy, oz))
    master = Path(output_dir) / f"{prefix}_{n_step:07d}.pvti"
    if grid.rank == 0:
        vtk_type = "Float64" if params.dtype == "float64" else "Float32"
        nz = params.nz if params.dim == 3 else 1
        lines = [
            '<?xml version="1.0"?>',
            '<VTKFile type="PImageData" version="0.1" byte_order="LittleEndian">',
            f'  <PImageData WholeExtent="0 {params.nx} 0 {params.ny} 0 {nz}" GhostLevel="0" '
            f'Origin="{origin[0]} {origin[1]} {origin[2]}" '
            f'Spacing="{spacing[0]} {spacing[1]} {spacing[2]}">',
            "    <PCellData>",
        ]
        lines += [f'      <PDataArray type="{vtk_type}" Name="{name}"/>' for name in names]
        lines.append("    </PCellData>")
        for k in range(_n_ranks(grid)):
            px, py, pz, nx, ny, nz = piece_extent(params, grid, k)
            lines.append(f'    <Piece Extent="{px} {px + nx} {py} {py + ny} {pz} {pz + nz}" '
                         f'Source="{prefix}_{n_step:07d}_p{k:04d}.vti"/>')
        lines += ["  </PImageData>", "</VTKFile>", ""]
        master.write_text("\n".join(lines))
    _barrier(grid)
    return master


def require_h5py() -> None:
    """Raise ImportError with the way out when h5py is missing."""
    if importlib.util.find_spec("h5py") is None:
        raise ImportError("[output] outputHdf5=yes needs h5py, which is not installed: "
                          "set outputHdf5=no or run with --no-output")


def output_hdf5_sharded(params: RunParams, grid: ProcessGrid, U_local: torch.Tensor,
                        n_step: int, total_time: float = 0.0, output_dir: str = ".",
                        prefix: str = "output") -> Path:
    """One global-shape HDF5 snapshot of the blocks U_local of every rank
    and its XDMF wrapper (JAX io/sharded.py:163-226, single process): rank
    0 writes each block into its hyperslab as it arrives, one at a time;
    returns the file's path. Every rank checks for h5py before any message
    travels."""
    require_h5py()
    path = Path(output_dir) / f"{prefix}_{n_step:07d}.h5"
    buf = grid.send_form(U_local)
    if grid.rank != 0:
        dist.send(buf, dst=0)
        _barrier(grid)
        return path

    import h5py

    os.makedirs(output_dir, exist_ok=True)
    shape = (params.nz, params.ny, params.nx)[-params.dim:]
    dtype = np.float64 if params.dtype == "float64" else np.float32
    with h5py.File(path, "w") as f:
        dsets = [f.create_dataset(n, shape=shape, dtype=dtype) for n in dataset_names(params)]
        recv = torch.empty_like(buf)
        for k in range(_n_ranks(grid)):
            if k:
                dist.recv(recv, src=k)
            data = (buf if k == 0 else recv).cpu().numpy()
            spatial = block_slices(params, grid, k)[1:]
            for i, d in enumerate(dsets):
                d[spatial] = data[i]
        f.attrs["time step"] = np.int32(n_step)
        f.attrs["total time"] = np.float64(total_time)
        f.attrs["nx"] = np.int32(params.nx)
        f.attrs["ny"] = np.int32(params.ny)
        f.attrs["nz"] = np.int32(params.nz)
        f.attrs["ghost included"] = np.int32(0)
        f.attrs["ghost width"] = np.int32(params.ghost_width)
        f.attrs["creation date"] = datetime.datetime.now().isoformat()
    write_xdmf_wrapper(params, path, ghost_included=False)
    _barrier(grid)
    return path


def output_netcdf_sharded(params: RunParams, grid: ProcessGrid, U_local: torch.Tensor,
                          n_step: int, total_time: float = 0.0, output_dir: str = ".",
                          prefix: str = "output") -> Path:
    """One global-shape NetCDF snapshot (the interior) of the blocks U_local
    of every rank (JAX io/sharded.py:357-432, single process): for each
    variable in turn, the other ranks send their block of it and rank 0
    writes the assembled variable; returns the file's path."""
    from .netcdf import have_netcdf4, write_classic_stream

    path = Path(output_dir) / f"{prefix}_{n_step:07d}.nc"
    names = dataset_names(params)
    if grid.rank != 0:
        for i in range(len(names)):
            dist.send(grid.send_form(U_local[i]), dst=0)
        _barrier(grid)
        return path

    os.makedirs(output_dir, exist_ok=True)
    shape = (params.nz, params.ny, params.nx)[-params.dim:]
    dims = dict(zip(("z", "y", "x")[-params.dim:], shape))
    dtype = np.float64 if params.dtype == "float64" else np.float32

    def variable(i: int) -> np.ndarray:
        buf = np.empty(shape, dtype)
        own = grid.send_form(U_local[i])
        recv = torch.empty_like(own)
        for k in range(_n_ranks(grid)):
            if k:
                dist.recv(recv, src=k)
            buf[block_slices(params, grid, k)[1:]] = (own if k == 0 else recv).cpu().numpy()
        return buf

    if have_netcdf4():
        import netCDF4

        ds = netCDF4.Dataset(path, "w")
        try:
            for name, size in dims.items():
                ds.createDimension(name, size)
            for i, name in enumerate(names):
                ds.createVariable(name, dtype, tuple(dims))[...] = variable(i)
            ds.setncattr("time step", np.int32(n_step))
            ds.setncattr("total time", float(total_time))
            ds.setncattr("ghost included", np.int32(0))
        finally:
            ds.close()
    else:
        write_classic_stream(path, dims, names, dtype,
                             {"time_step": np.int32(n_step), "total_time": np.float64(total_time),
                              "ghost_included": np.int32(0)}, variable)
    _barrier(grid)
    return path
