"""VTK ImageData (.vti / .pvti) writer (the port's copy of
ramsesgpu_tpu/io/vtk.py, with the appended blob assembled in numpy).

Pure-Python re-implementation of the reference's hand-written VTI output
(reference: src/hydro/HydroRunBase.cpp:2520-2681 outputVtk, and the per-rank
piece + .pvti master of HydroRunBaseMpi.cpp:4167-4227). Supports ascii and
appended-raw-binary encodings; cell data, one array per conserved variable.
"""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from ..config.params import RunParams
from ..core.constants import var_names


def write_vti(
    filename: str | Path,
    fields: dict[str, np.ndarray],
    origin=(0.0, 0.0, 0.0),
    spacing=(1.0, 1.0, 1.0),
    binary: bool = True,
    extent_offset=(0, 0, 0),
) -> None:
    """Write cell-centered fields to a VTK ImageData file.

    Each field must be a 2D [ny, nx] or 3D [nz, ny, nx] array; VTK expects
    x-fastest ordering, which matches our memory layout directly.
    ``extent_offset`` shifts the WholeExtent (used for .pvti pieces).
    """
    fields = {k: np.asarray(v) for k, v in fields.items()}
    first = next(iter(fields.values()))
    if first.ndim == 2:
        ny, nx = first.shape
        nz = 1
    else:
        nz, ny, nx = first.shape

    ox, oy, oz = extent_offset
    extent = f"{ox} {ox+nx} {oy} {oy+ny} {oz} {oz+nz}"
    lines = [
        '<?xml version="1.0"?>',
        '<VTKFile type="ImageData" version="0.1" byte_order="LittleEndian">',
        f'  <ImageData WholeExtent="{extent}" '
        f'Origin="{origin[0]} {origin[1]} {origin[2]}" '
        f'Spacing="{spacing[0]} {spacing[1]} {spacing[2]}">',
        f'    <Piece Extent="{extent}">',
        "      <PointData>",
        "      </PointData>",
        "      <CellData>",
    ]

    def vtk_type(a: np.ndarray) -> str:
        return {"float32": "Float32", "float64": "Float64",
                "int32": "Int32", "int64": "Int64"}[a.dtype.name]

    if binary:
        offset = 0
        arrays = []
        for name, a in fields.items():
            lines.append(
                f'        <DataArray type="{vtk_type(a)}" Name="{name}" '
                f'format="appended" offset="{offset}" />'
            )
            arrays.append(np.ascontiguousarray(a))
            offset += 4 + arrays[-1].nbytes
        lines += [
            "      </CellData>",
            "    </Piece>",
            "  </ImageData>",
            '  <AppendedData encoding="raw">',
        ]
        body = "\n".join(lines).encode() + b"\n    _"
        for a in arrays:  # per array: uint32 byte count, then the raw bytes
            body += np.uint32(a.nbytes).tobytes() + a.tobytes()
        body += b"\n  </AppendedData>\n</VTKFile>\n"
        Path(filename).write_bytes(body)
    else:
        for name, a in fields.items():
            flat = " ".join(repr(float(x)) for x in np.asarray(a).ravel())
            lines.append(
                f'        <DataArray type="{vtk_type(a)}" Name="{name}" format="ascii">'
            )
            lines.append(f"          {flat}")
            lines.append("        </DataArray>")
        lines += [
            "      </CellData>",
            "    </Piece>",
            "  </ImageData>",
            "</VTKFile>",
        ]
        Path(filename).write_text("\n".join(lines) + "\n")


def output_vtk(
    params: RunParams,
    U: np.ndarray,
    n_step: int,
    output_dir: str = ".",
    prefix: str = "output",
    ghost_included: bool = False,
    binary: bool = True,
) -> Path:
    """Write the conserved state with the reference's naming scheme
    ``<prefix>_<step:07d>.vti`` (HydroRunBase.cpp:2520)."""
    g = params.ghost_width
    U = np.asarray(U)
    if not ghost_included:
        U = U[(slice(None),) + (slice(g, -g),) * params.dim]
    names = var_names(params.nb_var)
    fields = {name: U[i] for i, name in enumerate(names)}
    os.makedirs(output_dir, exist_ok=True)
    path = Path(output_dir) / f"{prefix}_{n_step:07d}.vti"
    write_vti(
        path,
        fields,
        origin=(params.xmin, params.ymin, params.zmin),
        spacing=(params.dx, params.dy, params.dz if params.dim == 3 else 1.0),
        binary=binary,
    )
    return path


def read_vti(filename: str | Path):
    """Read a .vti file written by write_vti (ascii or appended-raw).

    Returns (fields: dict[name -> ndarray], extent: (x0,x1,y0,y1,z0,z1)).
    Arrays come back [nz,ny,nx] (or [ny,nx] when nz == 1)."""
    import re

    raw = Path(filename).read_bytes()
    head_end = raw.find(b"<AppendedData")
    head = raw[: head_end if head_end >= 0 else len(raw)].decode()
    m = re.search(r'WholeExtent="([\d\-\s]+)"', head)
    extent = tuple(int(v) for v in m.group(1).split())
    x0, x1, y0, y1, z0, z1 = extent
    nx, ny, nz = x1 - x0, y1 - y0, z1 - z0
    shape = (ny, nx) if nz <= 1 else (nz, ny, nx)
    np_types = {"Float32": np.float32, "Float64": np.float64,
                "Int32": np.int32, "Int64": np.int64}

    fields = {}
    if head_end >= 0:  # appended raw binary
        blob = raw[raw.index(b"_", raw.index(b'encoding="raw">')) + 1:]
        for m in re.finditer(
            r'<DataArray type="(\w+)" Name="(\w+)" format="appended" '
            r'offset="(\d+)"', head
        ):
            dtype = np_types[m.group(1)]
            off = int(m.group(3))
            nbytes = int(np.frombuffer(blob[off:off + 4], np.uint32)[0])
            fields[m.group(2)] = np.frombuffer(
                blob[off + 4:off + 4 + nbytes], dtype
            ).reshape(shape)
    else:  # ascii
        for m in re.finditer(
            r'<DataArray type="(\w+)" Name="(\w+)" format="ascii">\s*([^<]*)',
            head,
        ):
            fields[m.group(2)] = np.fromstring(
                m.group(3), dtype=np_types[m.group(1)], sep=" "
            ).reshape(shape)
    return fields, extent


def read_pvti(filename: str | Path):
    """Assemble a .pvti master + its .vti pieces into global arrays.

    Successor of reading the reference's per-rank piece output
    (HydroRunBaseMpi.cpp:4206-4227). Returns dict[name -> ndarray] of the
    full interior, [nz,ny,nx] (or [ny,nx])."""
    import re

    path = Path(filename)
    text = path.read_text()
    m = re.search(r'WholeExtent="([\d\-\s]+)"', text)
    x0, x1, y0, y1, z0, z1 = (int(v) for v in m.group(1).split())
    nx, ny, nz = x1 - x0, y1 - y0, z1 - z0
    dim2 = nz <= 1
    out = None
    for pm in re.finditer(r'<Piece Extent="([\d\-\s]+)" Source="([^"]+)"', text):
        px0, px1, py0, py1, pz0, pz1 = (int(v) for v in pm.group(1).split())
        fields, _ = read_vti(path.parent / pm.group(2))
        if out is None:
            shape = (ny, nx) if dim2 else (nz, ny, nx)
            out = {
                name: np.zeros(shape, a.dtype) for name, a in fields.items()
            }
        sl = (
            (slice(py0, py1), slice(px0, px1))
            if dim2
            else (slice(pz0, pz1), slice(py0, py1), slice(px0, px1))
        )
        for name, a in fields.items():
            out[name][sl] = a
    return out
