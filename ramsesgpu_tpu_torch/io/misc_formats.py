"""Minor output formats: NRRD, Xsmurf, raw binary and the face dumps (the
port's copy of ramsesgpu_tpu/io/misc_formats.py:18-82; reference
HydroRunBase.cpp:4266+ outputNrrd, :3308 outputXsm, :4530 outputBin;
copyFaces.cuh face extraction for movie output). numpy only: the run hands
them the ghosted state on the host.
"""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from ..config.params import RunParams
from ..core.constants import var_names


def write_nrrd(filename: str | Path, field: np.ndarray) -> None:
    """Minimal NRRD writer (header in the file, raw encoding), which the
    reference used for WebGL animations."""
    a = np.ascontiguousarray(field)
    type_map = {"float32": "float", "float64": "double"}
    sizes = " ".join(str(s) for s in a.shape[::-1])  # NRRD is x-fastest
    header = (
        "NRRD0004\n"
        f"type: {type_map[a.dtype.name]}\n"
        f"dimension: {a.ndim}\n"
        f"sizes: {sizes}\n"
        "encoding: raw\n"
        "endian: little\n"
        "\n"
    )
    with open(filename, "wb") as f:
        f.write(header.encode())
        f.write(a.tobytes())


def write_xsm(filename: str | Path, field2d: np.ndarray) -> None:
    """Xsmurf-compatible 2D float image: an ascii header and raw float32
    (HydroRunBase.cpp:3308-3400 outputXsm)."""
    a = np.ascontiguousarray(field2d, dtype=np.float32)
    ny, nx = a.shape
    header = f"Binary 1 {nx}x{ny} {nx*ny}(4 byte reals)\n"
    with open(filename, "wb") as f:
        f.write(header.encode())
        f.write(a.tobytes())


def write_bin(filename: str | Path, field: np.ndarray) -> None:
    """Raw float32 dump after an int32 header of the sizes, x first
    (outputBin)."""
    a = np.ascontiguousarray(field, dtype=np.float32)
    with open(filename, "wb") as f:
        f.write(np.array(a.shape[::-1], dtype=np.int32).tobytes())
        f.write(a.tobytes())


def output_faces(params: RunParams, U: np.ndarray, n_step: int, output_dir: str = ".",
                 prefix: str = "output") -> list[Path]:
    """The six domain faces (four in 2D) of every variable of the ghosted
    state U, one ``<prefix>_face_<face>_<step>.npz`` each: the reference's
    high-frequency movie output (copyFaces.cuh:46-197, outputFaces)."""
    g = params.ghost_width
    names = var_names(params.nb_var)
    os.makedirs(output_dir, exist_ok=True)
    out = []
    interior = U[(slice(None),) + (slice(g, -g),) * params.dim]
    faces = {
        "xmin": interior[..., 0], "xmax": interior[..., -1],
        "ymin": interior[..., 0, :], "ymax": interior[..., -1, :],
    }
    if params.dim == 3:
        faces["zmin"] = interior[:, 0]
        faces["zmax"] = interior[:, -1]
    for face, data in faces.items():
        path = Path(output_dir) / f"{prefix}_face_{face}_{n_step:07d}.npz"
        np.savez(path, **{n: np.asarray(data[i]) for i, n in enumerate(names)})
        out.append(path)
    return out
