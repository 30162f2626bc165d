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
  (kernels/shear.py);
- a sharded run: JAX holds one global interior-only array [nvar, nz, ny,
  nx] laid over the device mesh (parallel/sharded_step.py); the port's
  ranks each hold their interior block [nvar, lnz, lny, lnx]
  (parallel/sharded_step.py of the port), rank (iz, iy, ix) the block at
  (iz lnz, iy lny, ix lnx); its ``shard_global_state`` takes a rank's
  block of the JAX global state (numpy) and ``gather_global_state``
  assembles the blocks on rank 0 in the JAX layout.

A Kahan-compensated run ([implementation] compensated) carries 2 * nvar
channels in both packages, the state and then its carry
(ramsesgpu_tpu/pallas/fused_mhd3d.py:247-259), and a shearing box's kept
face becomes [2, nz, ny], the face and its carry
(pallas/shear_packed.py:1210 pack_shear). A stratified shear carry
(``pack_shear(..., stratified=True)``) holds the stratified z ghost planes
of the interior in its z bands and zero carries there.
"""
from __future__ import annotations

import numpy as np
import torch

from .config.params import RunParams
from .solvers.boundary import make_boundaries_concat
from .solvers.stratified import stratified_ghost_slabs

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
    """The JAX packed loop state -> the port's loop state on ``device``
    (its z and y bands, wraps or stratified ghosts, are dropped)."""
    g = params.ghost_width
    P = np.asarray(P_np)
    nvar = 2 * params.nb_var if params.compensated else params.nb_var  # with the carry
    want = (nvar, params.nz + 2 * g, params.ny + 2 * YB, params.nx)
    if P.shape != want:
        raise ValueError(f"packed state shape {P.shape} != {want}")
    S = P[:, g : g + params.nz, YB : YB + params.ny, :]
    return torch.from_numpy(np.ascontiguousarray(S)).to(device=device, dtype=torch_dtype(params))


def packed_to_jax(params: RunParams, S: torch.Tensor) -> np.ndarray:
    """The port's loop state -> the JAX packed loop state (numpy), equal to
    ramsesgpu_tpu.pallas.packed_io.pack_state of the same interior (all
    channels, carries included, wrap-padded)."""
    g = params.ghost_width
    interior = S.detach().cpu().numpy()
    return np.pad(interior, ((0, 0), (g, g), (YB, YB), (0, 0)), mode="wrap")


def shear_carry_from_jax(params: RunParams, carry, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX shear carry (P, kept_bx) -> the port's loop state (S, kept);
    plain, compensated or stratified."""
    P, kept = carry
    kept = np.asarray(kept)
    want = ((2,) if params.compensated else ()) + (params.nz, params.ny)
    if kept.shape != want:
        raise ValueError(f"kept face shape {kept.shape} != {want}")
    return (packed_from_jax(params, P, device),
            torch.tensor(kept, dtype=torch_dtype(params), device=device))


def shear_carry_to_jax(params: RunParams, state,
                       stratified: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """The port's loop state (S, kept) -> the JAX shear carry (numpy),
    equal to ramsesgpu_tpu.pallas.shear_packed.pack_shear (with
    ``stratified``) of a ghosted state with that interior, kept face and
    carries: the z bands wrap, or hold the interior's stratified z ghost
    planes and zero carries."""
    S, kept = state
    kept = kept.detach().cpu().numpy()
    if not stratified:
        return packed_to_jax(params, S), kept
    S = S.detach().cpu()
    zlo, zhi = stratified_ghost_slabs(params, S[:params.nb_var])
    bands = [torch.cat([zlo, S[:params.nb_var], zhi], dim=-3)]
    if params.compensated:
        zero = torch.zeros_like(zlo)
        bands.append(torch.cat([zero, S[params.nb_var:], zero], dim=-3))
    mid = torch.cat(bands).numpy()
    return np.pad(mid, ((0, 0), (0, 0), (YB, YB), (0, 0)), mode="wrap"), kept


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
