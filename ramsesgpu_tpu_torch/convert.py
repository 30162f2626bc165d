"""Moving state between the JAX package and the port.

In this system the "weights" are the state and the RunParams. The
port's RunParams is a copy of the JAX package's with the same fields, so
the functions here take either. The state layouts (nvar = 8 for MHD, 5
for 3D hydro, 4 for 2D hydro):

- ghosted: [nvar, nz+2g, ny+2g, nx+2g], the same in both packages; in 2D
  [nvar, ny+2g, nx+2g], which is also the loop state of both packages'
  2D paths (``state_from_jax`` / ``state_to_jax``);
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
- a static gravity field: [dim, *ghosted shape] in both packages (the 2D
  step takes it); a uniform one is, for the 3D kernels, the constant
  vector (gx, gy, gz) (``gravity_from_jax``);
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

The OU forcing state: the JAX package's is a dict of mode [3, 31],
projTens [3, 3, 31], forcingField [3, 31] (float32) and a PRNG key
(uint32 [2]); the port's an ops/forcing.py OUState with the same three
arrays and a torch.Generator (seed, blocks drawn). The two random streams
differ, so a key maps to a seed and no more: ``forcing_state_from_jax``
seeds the generator with the key's two words as one 64-bit integer
(k0 << 32 | k1; PRNGKey(s) gives seed s) and no draws;
``forcing_state_to_jax`` gives the key of the seed (k0 = seed >> 32, k1 =
its low 32 bits), whatever has been drawn since.

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


def gravity_from_jax(params: RunParams, g_np: np.ndarray, device):
    """A static gravity field of the JAX package (numpy [dim, *ghosted
    shape], make_gravity_field) as the port's: the field tensor on
    ``device`` that the 2D step takes, and the constant vector (gx, gy, gz)
    the 3D kernels take where the field is one (else None)."""
    field = torch.from_numpy(np.ascontiguousarray(g_np)).to(device)
    flat = g_np.reshape(g_np.shape[0], -1)
    uniform = bool((flat == flat[:, :1]).all())
    vec = None
    if uniform and params.dim == 3:
        vec = tuple(float(v) for v in flat[:, 0])
    return field, vec


def state_to_jax(params: RunParams, U: torch.Tensor) -> np.ndarray:
    """A ghosted state of the port -> the JAX package's (numpy)."""
    if tuple(U.shape) != params.shape:
        raise ValueError(f"state shape {tuple(U.shape)} != {params.shape}")
    return U.detach().cpu().numpy()


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


def forcing_state_from_jax(jstate: dict, device, dtype=torch.float32):
    """The JAX OU forcing state (numpy or JAX arrays) -> the port's OUState
    on ``device``, drawing in ``dtype`` (the run's); the key rule is the
    module note's."""
    from .ops.forcing import OUState

    key = np.asarray(jstate["key"]).astype(np.uint64).reshape(2)
    return OUState(
        mode=torch.from_numpy(np.array(jstate["mode"], np.float64)).to(device),
        projTens=torch.from_numpy(np.array(jstate["projTens"], np.float64)).to(device),
        forcingField=torch.from_numpy(np.array(jstate["forcingField"], np.float32)).to(device),
        seed=int((key[0] << np.uint64(32)) | key[1]), dtype=dtype,
    )


def forcing_state_to_jax(state) -> dict:
    """The port's OUState -> the JAX OU forcing state's arrays (numpy):
    mode, projTens, forcingField and the key of its seed."""
    return {
        "mode": state.mode.cpu().numpy(),
        "projTens": state.projTens.cpu().numpy(),
        "forcingField": state.forcingField.cpu().numpy(),
        "key": np.array([state.seed >> 32, state.seed & 0xFFFFFFFF], np.uint32),
    }
