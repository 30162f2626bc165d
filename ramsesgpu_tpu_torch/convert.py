"""Moving state between the JAX package and the port.

In this system the "weights" are the state and the RunParams. The
port's RunParams is a copy of the JAX package's with the same fields, so
the functions here take either. The state layouts (nvar = 8 for MHD, 5
for 3D hydro):

- ghosted: [nvar, nz+2g, ny+2g, nx+2g], the same in both packages;
- JAX packed loop state of fully periodic runs
  (ramsesgpu_tpu/pallas/packed_io.py:39-48): [nvar, nz+2g, ny+2*YB, nx]
  with YB = 8 wrap rows in y, wrap planes in z and no x ghosts;
- JAX padded-carry loop state of walled hydro runs
  (ramsesgpu_tpu/pallas/packed_bc.py:108-123): [5, nz+2g, ny+2*YB, WX]
  with the x ghosts in the row, WX = nx+2g rounded up to a multiple of
  128, and the ghost bands filled as make_boundaries fills them;
- JAX shear carry of shearing-box runs (ramsesgpu_tpu/pallas/
  shear_packed.py:1210 pack_shear): (P, kept_bx), P the packed layout
  above and kept_bx [nz, ny] the kept Bx face at x = nx;
- the port's loop state: the interior [nvar, nz, ny, nx]; the kernels
  find neighbours outside it by index rules (kernels/fused_mhd3d.py,
  kernels/packed_bc.py); a shearing-box run carries the pair (S, kept)
  (kernels/shear.py).
"""
from __future__ import annotations

import numpy as np
import torch

from .config.params import RunParams
from .solvers.boundary import make_boundaries_concat

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


def shear_carry_from_jax(params: RunParams, carry, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX shear carry (P, kept_bx) -> the port's loop state (S, kept)."""
    P, kept = carry
    kept = np.asarray(kept)
    if kept.shape != (params.nz, params.ny):
        raise ValueError(f"kept face shape {kept.shape} != {(params.nz, params.ny)}")
    return (packed_from_jax(params, P, device),
            torch.tensor(kept, dtype=torch_dtype(params), device=device))


def shear_carry_to_jax(params: RunParams, state) -> tuple[np.ndarray, np.ndarray]:
    """The port's loop state (S, kept) -> the JAX shear carry (numpy),
    equal to ramsesgpu_tpu.pallas.shear_packed.pack_shear of a ghosted
    state with that interior and kept face."""
    S, kept = state
    return packed_to_jax(params, S), kept.detach().cpu().numpy()


def padded_width(params: RunParams) -> int:
    """The JAX padded-carry row width: nx + 2g rounded up to 128 lanes."""
    return -(-(params.nx + 2 * params.ghost_width) // 128) * 128


def bc_carry_from_jax(params: RunParams, P_np: np.ndarray, device) -> torch.Tensor:
    """The JAX padded-carry loop state -> the port's loop state on ``device``."""
    g = params.ghost_width
    P = np.asarray(P_np)
    want = (params.nb_var, params.nz + 2 * g, params.ny + 2 * YB, padded_width(params))
    if P.shape != want:
        raise ValueError(f"padded-carry state shape {P.shape} != {want}")
    S = P[:, g : g + params.nz, YB : YB + params.ny, g : g + params.nx]
    return torch.from_numpy(np.ascontiguousarray(S)).to(device=device, dtype=torch_dtype(params))


def bc_carry_to_jax(params: RunParams, S: torch.Tensor) -> np.ndarray:
    """The port's loop state -> the JAX padded-carry loop state (numpy),
    equal to ramsesgpu_tpu.pallas.packed_bc.pack_bc_state of the ghost fill
    of the same interior."""
    g = params.ghost_width
    U = make_boundaries_concat(params, S.detach().cpu(), interior_only=True).numpy()
    pad_x = padded_width(params) - U.shape[-1]
    return np.pad(U, ((0, 0), (0, 0), (YB - g, YB - g), (0, pad_x)), mode="edge")
