"""Velocity structure functions, on line and off line (the port's
counterpart of ramsesgpu_tpu/analysis/structure_functions.py; reference
structureFunctions{,Mpi}.{h,cpp} on line, structureFunctionsMpi*.cpp and
common_sf.h off line). The types of common_sf.h:

  SF_TYPE_V     : delta v
  SF_TYPE_RHO2V : delta(rho^1/2 v)
  SF_TYPE_RHO3V : delta(rho^1/3 v)

For each of ``n_samples`` reference points (numpy's RandomState(seed), so
both packages sample the same cells) the increment to every cell is
formed at once on the state's device, split into its longitudinal and
transverse parts along the periodic minimal-image separation, binned by
rint of the distance, and summed for the orders q = 1 .. max_q. The
separations are float32 in every dtype, as in the JAX package (so the
bins are its bins); rho^1/3 is ``pow(rho, 1/3)`` (torch has no cbrt: it
differs from cbrt by an ULP). Each point's bins are summed by one
bincount per type into running sums kept in float64 on every device
(CUDA's scatter-add has no fixed order, and the JAX package's float32 sums
on a TPU lose digits over 1000 points; ROADMAP Queue 3), the powers of
each increment formed in float64 too; the .npz holds the means in the
state's dtype and the counts, whole numbers up to samples x cells, in
float64 (the reference dumps with cnpy, structureFunctions.cpp:465-495).

The sharded form runs on a DistributedRun's blocks: each rank works on
its block with global indices, the reference points' values cross the
ranks once (one all_reduce), the binned sums are summed by one more, and
rank 0 writes the file.

The on-line hooks follow the JAX Run's: ``[structureFunctions]
nSampleTotal`` (1000) and ``max_q`` (5), seed 0; the JAX hook never reads
``randomSeed`` (ROADMAP Queue 3).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..config.configmap import ConfigMap
from ..config.params import RunParams
from ..core.constants import ID, IU, IV, IW
from ..ops.backend import xp

SF_TYPE_NAMES = ("v", "rho2v", "rho3v")


def _sf_geometry(dims) -> int:
    """The number of distance bins."""
    return int(np.ceil(max(dims) / 2.0 * np.sqrt(3.0))) + 2


def _sample_ref_points(dims, n_samples: int, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    return np.stack([rng.randint(0, d, size=n_samples) for d in dims], axis=1)


def sf_fields(rho: torch.Tensor, vel: torch.Tensor) -> torch.Tensor:
    """[3 types, ndim, *cells]: v, rho^1/2 v, rho^1/3 v."""
    return torch.stack([vel, vel * xp.sqrt(rho)[None], vel * torch.pow(rho, 1.0 / 3.0)[None]])


def _interior_fields(params: RunParams, U) -> tuple[torch.Tensor, torch.Tensor]:
    """(rho, the velocity [ndim, *cells]) of the interior of the ghosted
    state U, on its device."""
    U = torch.as_tensor(U)
    g = params.ghost_width
    sl = (slice(g, -g),) * params.dim
    rho = U[ID][sl]
    return rho, torch.stack([U[c][sl] / rho for c in (IU, IV, IW)[: params.dim]])


class _Accumulator:
    """The running float64 sums of one set of cells (the whole interior,
    or a rank's block at the global ``origin``) of a periodic box ``dims``."""

    def __init__(self, fields: torch.Tensor, dims, origin, n_bins: int, max_q: int):
        self.fields, self.dims, self.n_bins, self.max_q = fields, dims, n_bins, max_q
        device = fields.device
        local = fields.shape[2:]
        self.grids = torch.meshgrid(*[torch.arange(o, o + n, device=device)
                                      for o, n in zip(origin, local)], indexing="ij")
        # [long q = 1..max_q, tran q = 1..max_q] per bin, one bincount a
        # type over the weights w (float64) at the indices idx
        self.offsets = (n_bins * torch.arange(2 * max_q, dtype=torch.int32,
                                              device=device)).view(-1, 1)
        cells = fields[0, 0].numel()
        self.w = torch.empty((2 * max_q, cells), dtype=torch.float64, device=device)
        # (int32: bincount reads its indices three times)
        self.idx = torch.empty((2 * max_q, cells), dtype=torch.int32, device=device)
        self.acc = torch.zeros((3, 2 * max_q, n_bins), dtype=torch.float64, device=device)
        self.counts = torch.zeros(n_bins, dtype=torch.float64, device=device)

    def add(self, ref, ref_vals: torch.Tensor) -> None:
        """One reference point: ``ref`` its global cell (ints), ``ref_vals``
        [3, ndim] the fields there."""
        ndim = len(self.dims)
        sep = []
        for d in range(ndim):
            n = self.dims[d]
            s = self.grids[d] - int(ref[d])
            s = torch.where(s > n // 2, s - n, s)
            s = torch.where(s < -(n // 2), s + n, s)
            sep.append(s.to(torch.float32))
        dist = xp.sqrt(sum(s * s for s in sep))
        bins = torch.clamp(torch.round(dist).to(torch.int32), 0, self.n_bins - 1).ravel()
        inv_dist = torch.where(dist > 0, 1.0 / xp.maximum(dist, 1e-30), 0.0)
        torch.add(bins.view(1, -1), self.offsets, out=self.idx)
        idx, w, m = self.idx.view(-1), self.w, self.max_q
        for t in range(3):
            f = self.fields[t]
            delta = f - ref_vals[t].reshape((-1,) + (1,) * ndim)
            # the separation is (z, y, x), the velocity (x, y, z)
            d_long = sum(delta[ndim - 1 - d] * sep[d] for d in range(ndim)) * inv_dist
            d2 = sum(delta[c] ** 2 for c in range(delta.shape[0]))
            d_tran = xp.sqrt(xp.maximum(d2 - d_long * d_long, 0.0))
            # the powers q = 1 .. max_q in float64, each from the one before
            w[0].copy_(torch.abs(d_long).ravel())
            w[m].copy_(d_tran.ravel())
            for q in range(1, m):
                torch.mul(w[q - 1], w[0], out=w[q])
                torch.mul(w[m + q - 1], w[m], out=w[m + q])
            self.acc[t] += torch.bincount(idx, weights=w.view(-1), minlength=2 * m * self.n_bins
                                          ).view(2 * m, self.n_bins)
        self.counts += torch.bincount(bins, minlength=self.n_bins).to(torch.float64)


def _sf_result(counts, acc, n_bins: int, max_q: int, dtype) -> dict:
    """The .npz dictionary: the means in ``dtype``, the counts (whole
    numbers) in float64 (numpy)."""
    counts = counts.cpu().numpy()
    acc = acc.cpu().numpy()
    safe = np.maximum(counts, 1.0)
    return {
        "distance": np.arange(n_bins, dtype=np.float64),
        "counts": counts,
        "sf_long": (acc[:, :max_q] / safe).astype(dtype),
        "sf_tran": (acc[:, max_q:] / safe).astype(dtype),
        "types": np.array(SF_TYPE_NAMES),
        "max_q": np.array([max_q]),
    }


def _np_dtype(t: torch.Tensor):
    return np.float64 if t.dtype == torch.float64 else np.float32


def compute_structure_functions(params: RunParams, U, n_samples: int = 1000, max_q: int = 5,
                                seed: int = 0) -> dict:
    """The structure functions of the ghosted state U (numpy or a tensor,
    on its device): a dict of numpy arrays, ``sf_long`` and ``sf_tran``
    [3 types, max_q, n_bins] (mean |increment|^q), ``counts`` and the bins'
    ``distance``."""
    rho, vel = _interior_fields(params, U)
    dims = tuple(rho.shape)
    n_bins = _sf_geometry(dims)
    ref_idx = _sample_ref_points(dims, n_samples, seed)
    fields = sf_fields(rho, vel)
    accum = _Accumulator(fields, dims, (0,) * len(dims), n_bins, max_q)
    for ref in ref_idx:
        accum.add(ref, fields[(slice(None), slice(None)) + tuple(int(i) for i in ref)])
    return _sf_result(accum.counts, accum.acc, n_bins, max_q, _np_dtype(rho))


def compute_structure_functions_sharded(params: RunParams, grid, U_local: torch.Tensor,
                                        n_samples: int = 1000, max_q: int = 5,
                                        seed: int = 0) -> dict | None:
    """The structure functions of the global state whose interior block
    [nvar, (lnz,) lny, lnx] this rank holds (parallel/mesh.py ProcessGrid
    ``grid``): the result on rank 0, None on the others. Every rank must
    call it."""
    from ..parallel.mesh import block_slices

    dims = (params.nz, params.ny, params.nx)[-params.dim:]
    origin = tuple(s.start for s in block_slices(params, grid, grid.rank)[1:])
    n_bins = _sf_geometry(dims)
    ref_idx = _sample_ref_points(dims, n_samples, seed)
    rho = U_local[ID]
    fields = sf_fields(rho, torch.stack([U_local[c] / rho for c in (IU, IV, IW)[: params.dim]]))
    # the reference points' values: each rank its own, summed over the ranks
    local = torch.as_tensor(ref_idx) - torch.tensor(origin)
    mine = ((local >= 0) & (local < torch.tensor(fields.shape[2:]))).all(dim=1)
    values = torch.zeros((n_samples, 3, params.dim), dtype=fields.dtype, device=fields.device)
    rows = torch.nonzero(mine).ravel()
    if len(rows):
        cells = local[rows].to(fields.device)
        values[rows.to(fields.device)] = fields[(slice(None), slice(None)) + tuple(
            cells[:, d] for d in range(params.dim))].permute(2, 0, 1)
    values = grid.all_sum(values)
    accum = _Accumulator(fields, dims, origin, n_bins, max_q)
    for p, ref in enumerate(ref_idx):
        accum.add(ref, values[p])
    acc = grid.all_sum(accum.acc)
    counts = grid.all_sum(accum.counts)
    if grid.rank != 0:
        return None
    return _sf_result(counts, acc, n_bins, max_q, _np_dtype(rho))


def _online_settings(config: ConfigMap, n_step: int) -> tuple[int, int, str]:
    n_samples = config.get_integer("structureFunctions", "nSampleTotal", 1000)
    max_q = config.get_integer("structureFunctions", "max_q", 5)
    output_dir = config.get_string("output", "outputDir", "./")
    prefix = config.get_string("output", "outputPrefix", "output")
    return n_samples, max_q, f"{output_dir}/{prefix}_sf_{n_step:07d}.npz"


def structure_functions_online(params: RunParams, config: ConfigMap, U, n_step: int) -> str:
    """The on-line hook of a Run: the structure functions of the ghosted
    state U on its device, dumped with the reference's naming; the path."""
    n_samples, max_q, path = _online_settings(config, n_step)
    result = compute_structure_functions(params, U, n_samples, max_q)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **result)
    return path


def structure_functions_online_sharded(params: RunParams, config: ConfigMap, grid,
                                       U_local: torch.Tensor, n_step: int) -> str:
    """The on-line hook of a DistributedRun (every rank calls it; rank 0
    writes); the path."""
    n_samples, max_q, path = _online_settings(config, n_step)
    result = compute_structure_functions_sharded(params, grid, U_local, n_samples, max_q)
    if result is not None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez(path, **result)
    return path


def main(argv=None) -> int:
    """The off-line tool over saved HDF5 snapshots (the successor of
    computeStructureFunctionsMpi)."""
    import argparse

    from ..config.params import params_from_config
    from ..io.hdf5 import input_hdf5

    parser = argparse.ArgumentParser(description="structure functions from snapshots")
    parser.add_argument("--param", required=True, help="INI file of the run")
    parser.add_argument("files", nargs="+", help="HDF5 snapshot files")
    parser.add_argument("--nsamples", type=int, default=1000)
    parser.add_argument("--maxq", type=int, default=5)
    parser.add_argument("--out", default="sf.npz")
    parser.add_argument("--device", default="cuda" if torch.cuda.is_available() else "cpu")
    args = parser.parse_args(argv)

    params = params_from_config(ConfigMap(args.param))
    results = []
    for fname in args.files:
        U, _t, _step = input_hdf5(params, fname)
        results.append(compute_structure_functions(
            params, torch.from_numpy(U).to(args.device), args.nsamples, args.maxq))
    # the average over the snapshots
    merged = {k: results[0][k] for k in ("distance", "types", "max_q")}
    for key in ("counts", "sf_long", "sf_tran"):
        merged[key] = np.mean([r[key] for r in results], axis=0)
    np.savez(args.out, **merged)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
