"""The loop state of 3D hydro runs with walls, and the face types the step
kernel reads (the port's counterpart of ramsesgpu_tpu/pallas/packed_bc.py).

The JAX package carries a walled run in a lane-padded ghosted layout
S [5, nz+2g, ny+2*YB, WX] and rebuilds its ghost lanes and bands in the
kernel after every update (packed_bc.py:108-123, :126). The port carries
the interior only, S [5, nz, ny, nx], for every mix of DIRICHLET, NEUMANN
and PERIODIC faces, periodic runs included: the step kernel maps each
neighbour load that leaves the interior through the face's rule
(csrc/hydro_step.cu), which reads exactly the values make_boundaries
writes. So pack is a slice of the ghosted state (whose ghosts need not be
valid) and unpack is the port's boundary fill of the interior.
"""
from __future__ import annotations

import ctypes

import torch

from ..config.params import RunParams
from ..solvers.boundary import interior, make_boundaries_concat, require_simple_bcs


def bc_codes(params: RunParams) -> ctypes.Array:
    """The six face types (xmin, xmax, ymin, ymax, zmin, zmax) as the
    step kernel's int array (BoundaryConditionType values)."""
    require_simple_bcs(params)
    return (ctypes.c_int * 6)(*(int(b) for b in params.boundary_types))


def pack_state(params: RunParams, U: torch.Tensor) -> torch.Tensor:
    """Ghosted state -> the loop state (a new contiguous interior)."""
    return interior(params, U).contiguous()


def unpack_state(params: RunParams, S: torch.Tensor) -> torch.Tensor:
    """The loop state -> the ghosted state, every ghost filled."""
    return make_boundaries_concat(params, S, interior_only=True)
