"""HDF5 output / restart input with XDMF wrapper.

Same file layout as the reference so files interoperate
(reference: src/hydro/HydroRunBase.cpp:3323-3650 outputHdf5,
:4818-5155 inputHdf5, :3823-4069 writeXdmfForHdf5Wrapper): one dataset per
conserved variable (/density, /energy, /momentum_x|y|z,
/magnetic_field_x|y|z), root attributes "time step" (int), "total time"
(double), plus grid metadata; optional gzip+shuffle compression via
[output] outputHdf5CompressionLevel.

The port's own copy of ramsesgpu_tpu/io/hdf5.py: the port imports nothing of
the JAX package.
"""
from __future__ import annotations

import datetime
import os
from pathlib import Path

import numpy as np

from ..config.params import RunParams
from ..core.constants import IA, IB, IC, ID, IP, IU, IV, IW

#: dataset name per component index (HydroRunBase.cpp:3431-3501)
DATASET_NAMES = (
    "density",
    "energy",
    "momentum_x",
    "momentum_y",
    "momentum_z",
    "magnetic_field_x",
    "magnetic_field_y",
    "magnetic_field_z",
)


def dataset_names(params: RunParams) -> tuple[str, ...]:
    if params.nb_var == 4:  # 2D hydro has no momentum_z
        return ("density", "energy", "momentum_x", "momentum_y")
    return DATASET_NAMES[: params.nb_var]


def output_hdf5(
    params: RunParams,
    U: np.ndarray,
    n_step: int,
    total_time: float = 0.0,
    output_dir: str = ".",
    prefix: str = "output",
    ghost_included: bool = False,
    compression_level: int = 0,
    write_xdmf: bool = True,
) -> Path:
    import h5py

    g = params.ghost_width
    U = np.asarray(U)
    if not ghost_included:
        U = U[(slice(None),) + (slice(g, -g),) * params.dim]

    os.makedirs(output_dir, exist_ok=True)
    path = Path(output_dir) / f"{prefix}_{n_step:07d}.h5"
    kwargs = {}
    if compression_level > 0:
        kwargs = dict(compression="gzip", compression_opts=compression_level,
                      shuffle=True)

    with h5py.File(path, "w") as f:
        for i, name in enumerate(dataset_names(params)):
            f.create_dataset(name, data=U[i], **kwargs)
        f.attrs["time step"] = np.int32(n_step)
        f.attrs["total time"] = np.float64(total_time)
        f.attrs["nx"] = np.int32(params.nx)
        f.attrs["ny"] = np.int32(params.ny)
        f.attrs["nz"] = np.int32(params.nz)
        f.attrs["ghost included"] = np.int32(1 if ghost_included else 0)
        f.attrs["ghost width"] = np.int32(g)
        f.attrs["creation date"] = datetime.datetime.now().isoformat()

    if write_xdmf:
        write_xdmf_wrapper(params, path, ghost_included=ghost_included)
    return path


def write_xdmf_wrapper(params: RunParams, h5path: Path, ghost_included: bool) -> Path:
    """XDMF sidecar so ParaView/VisIt open the .h5 directly
    (HydroRunBase.cpp:3823-4069)."""
    h5path = Path(h5path)
    if ghost_included:
        nx, ny, nz = params.isize, params.jsize, params.ksize
    else:
        nx, ny, nz = params.nx, params.ny, params.nz
    prec = 8 if params.dtype == "float64" else 4

    if params.dim == 2:
        topo = f'<Topology TopologyType="2DCoRectMesh" NumberOfElements="{ny} {nx}"/>'
        geom = (
            '<Geometry GeometryType="ORIGIN_DXDY">\n'
            '        <DataItem Format="XML" Dimensions="2">0 0</DataItem>\n'
            f'        <DataItem Format="XML" Dimensions="2">{params.dy} {params.dx}</DataItem>\n'
            "      </Geometry>"
        )
        dims = f"{ny} {nx}"
    else:
        topo = f'<Topology TopologyType="3DCoRectMesh" NumberOfElements="{nz} {ny} {nx}"/>'
        geom = (
            '<Geometry GeometryType="ORIGIN_DXDYDZ">\n'
            '        <DataItem Format="XML" Dimensions="3">0 0 0</DataItem>\n'
            f'        <DataItem Format="XML" Dimensions="3">{params.dz} {params.dy} {params.dx}</DataItem>\n'
            "      </Geometry>"
        )
        dims = f"{nz} {ny} {nx}"

    attrs = []
    for name in dataset_names(params):
        attrs.append(
            f'      <Attribute Center="Node" Name="{name}">\n'
            f'        <DataItem Format="HDF" NumberType="Float" Precision="{prec}" '
            f'Dimensions="{dims}">\n'
            f"          {h5path.name}:/{name}\n"
            "        </DataItem>\n"
            "      </Attribute>"
        )

    xml = (
        '<?xml version="1.0" ?>\n'
        '<!DOCTYPE Xdmf SYSTEM "Xdmf.dtd">\n'
        '<Xdmf xmlns:xi="http://www.w3.org/2003/XInclude" Version="2.0">\n'
        "  <Domain>\n"
        f'    <Grid Name="{h5path.stem}" GridType="Uniform">\n'
        f"      {topo}\n"
        f"      {geom}\n" + "\n".join(attrs) + "\n"
        "    </Grid>\n"
        "  </Domain>\n"
        "</Xdmf>\n"
    )
    out = h5path.with_suffix(".xmf")
    out.write_text(xml)
    return out


def input_hdf5(params: RunParams, filename: str | Path) -> tuple[np.ndarray, float, int]:
    """Read a restart file into a full ghosted state array.

    Accepts both ghost-included files (the reference's restart convention)
    and interior-only files (ghosts are then zero and refilled by the first
    boundary fill). Returns (U, total_time, time_step)
    (HydroRunBase.cpp:4818-5155)."""
    import h5py

    g = params.ghost_width
    dtype = np.float64 if params.dtype == "float64" else np.float32
    U = np.zeros(params.shape, dtype=dtype)

    with h5py.File(filename, "r") as f:
        names = dataset_names(params)
        for i, name in enumerate(names):
            data = np.asarray(f[name])
            if data.shape == U[i].shape:
                U[i] = data
            else:
                interior = (slice(g, -g),) * params.dim
                if data.shape != U[i][interior].shape:
                    raise ValueError(
                        f"restart dataset {name} has shape {data.shape}, "
                        f"expected {U[i].shape} (ghosted) or "
                        f"{U[i][interior].shape} (interior)"
                    )
                U[i][interior] = data
        total_time = float(f.attrs.get("total time", 0.0))
        time_step = int(f.attrs.get("time step", 0))
    return U, total_time, time_step


def upscale(params: RunParams, coarse: np.ndarray) -> np.ndarray:
    """x2 upscale restart: each coarse cell fills a 2^dim block of fine
    cells (HydroRunBase.cpp:5170-5278). Face-centered B components are
    copied per-face so the staggered layout stays div-free to roundoff."""
    g = params.ghost_width
    fine = np.zeros(params.shape, dtype=coarse.dtype)
    ci = coarse[(slice(None),) + (slice(g, -g),) * params.dim]  # coarse interior

    up = ci
    for ax in range(1, params.dim + 1):
        up = np.repeat(up, 2, axis=ax)
    interior = (slice(None),) + (slice(g, -g),) * params.dim
    fine[interior] = up
    return fine
