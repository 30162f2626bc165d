"""Moving state between the JAX package and the port.

In this system the "weights" are the state and the RunParams; the
RunParams are shared as they are. The state layouts:

- ghosted: [8, nz+2g, ny+2g, nx+2g], the same in both packages;
- JAX packed loop state (ramsesgpu_tpu/pallas/packed_io.py:39-48):
  [8, nz+2g, ny+2*YB, nx] with YB = 8 wrap rows in y, wrap planes in z and
  no x ghosts;
- the port's loop state: the interior [8, nz, ny, nx], periodic by index
  wrap (kernels/fused_mhd3d.py).
"""
from __future__ import annotations

import numpy as np
import torch

from ramsesgpu_tpu.config.params import RunParams

YB = 8  # the JAX packed layout's y ghost band (ramsesgpu_tpu/pallas/packed_io.py:30)


def torch_dtype(params: RunParams) -> torch.dtype:
    return torch.float64 if params.dtype == "float64" else torch.float32


def state_from_jax(params: RunParams, U_np: np.ndarray, device) -> torch.Tensor:
    """A ghosted state from the JAX package (numpy) as a tensor on ``device``."""
    U = np.asarray(U_np)
    if U.shape != params.shape:
        raise ValueError(f"state shape {U.shape} != {params.shape}")
    return torch.from_numpy(np.ascontiguousarray(U)).to(device=device, dtype=torch_dtype(params))


def packed_from_jax(params: RunParams, P_np: np.ndarray, device) -> torch.Tensor:
    """The JAX packed loop state -> the port's loop state on ``device``."""
    g = params.ghost_width
    P = np.asarray(P_np)
    want = (params.nb_var, params.nz + 2 * g, params.ny + 2 * YB, params.nx)
    if P.shape != want:
        raise ValueError(f"packed state shape {P.shape} != {want}")
    S = P[:, g : g + params.nz, YB : YB + params.ny, :]
    return torch.from_numpy(np.ascontiguousarray(S)).to(device=device, dtype=torch_dtype(params))


def packed_to_jax(params: RunParams, S: torch.Tensor) -> np.ndarray:
    """The port's loop state -> the JAX packed loop state (numpy), equal to
    ramsesgpu_tpu.pallas.packed_io.pack_state of the same interior."""
    g = params.ghost_width
    interior = S.detach().cpu().numpy()
    return np.pad(interior, ((0, 0), (g, g), (YB, YB), (0, 0)), mode="wrap")
