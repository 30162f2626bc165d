"""Z-slab pipelining of a whole-array 3D update (the port's counterpart of
ramsesgpu_tpu/solvers/zslab.py; reference {Hydro,MHD}RunGodunovZslab.cpp,
zSlabInfo.h:30-38).

The unchanged whole-array update runs on one z window at a time, so only
one slab's intermediates (traced states, fluxes, EMFs) are alive at once:
O(nz / zSlabNb) scratch. Each window carries the full ghost width on both
z sides and writes back exactly its own nz / zSlabNb planes, so the result
is bitwise the monolithic update. The port's kernels stream their own
intermediates and ignore ``zSlabNb``, as the JAX kernel paths do; this is
the whole-array step's (solvers/step.py make_step_fn with kernel=jnp).
"""
from __future__ import annotations

from typing import Callable

import torch

from ..config.params import RunParams

_Z = -3


def zslab_apply(params: RunParams, U: torch.Tensor,
                update_fn: Callable[[torch.Tensor], torch.Tensor], n_slabs: int) -> torch.Tensor:
    """``update_fn`` (a whole-array update of a ghosted state that writes
    only its ghost interior and reads up to ghost_width cells beyond)
    applied slab by slab along z: a new tensor."""
    g = params.ghost_width
    nz = U.shape[_Z] - 2 * g
    if n_slabs <= 1:
        return update_fn(U)
    if nz % n_slabs:
        raise ValueError(f"nz={nz} not divisible by zSlabNb={n_slabs}")
    bz = nz // n_slabs
    U_new = U.clone()
    for s in range(n_slabs):
        k0 = g + s * bz
        updated = update_fn(U.narrow(_Z, k0 - g, bz + 2 * g))
        U_new.narrow(_Z, k0, bz).copy_(updated.narrow(_Z, g, bz))
    return U_new
