"""Time stepping over ranks: one process per rank, torch.distributed
between them (the port's counterpart of ramsesgpu_tpu/parallel/
sharded_step.py; reference MHDRunGodunovMpi.cpp).

Ported: the shearing box (the MRI, ideal or stratified), JAX
``_make_sharded_advance_shear`` (:404-608) on its kernel route: each rank
carries its GHOSTED local block, so the CFL reads ghosts one fill old, as
the single-device step computes dt before the fill; per step

1. the CFL kernel's ghosted shearing-box form on the block as it stands,
   and the max over ranks (all_reduce MAX, JAX ``lax.pmax``);
2. the interior, grown again by ``attach_halos_shear`` at t + dt (y ring,
   x ring with the sheared remap at the domain edge, z ring, the rebuilt
   xmax Bx face, the stratified z fill);
3. TPU row 4 on the grown block (kernels/fused_mhd3d.py
   ``make_fused_mhd_shear``: one launch of the step kernel's shear window
   mode, with this rank's x0 and z0) and the post-correction of JAX
   ``kernel_update`` (:501-544) in whole-array torch: the density flux and
   emfY remapped across ranks, the border columns' density (floored on
   the domain-edge columns only), Bx and Bz, the z+1 row of the emfY
   delta over the z ring. The new interior replaces the grown block's;
   its ghosts stay those of the fill, the CFL of the next step reads them.

The JAX package's own test (tests/test_parallel.py:531-550) holds this
route against its whole-array route (``_mhd_update``) with a tolerance:
the whole-array update also moves the CT face layer n+g of the block,
which the next CFL reads.

Every other sharded configuration (periodic or walled MHD, hydro,
forcing, zslab, halo overlap, the sharded dissipation) raises
NotImplementedError: ROADMAP Queue 1 item 7.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable

import torch
import torch.distributed as dist

from ..config.configmap import ConfigMap
from ..config.params import RunParams
from ..convert import torch_dtype
from ..core.constants import IA, IC, ID, BoundaryConditionType as BCT
from ..kernels.cfl_mhd import cfl_mhd_window
from ..kernels.fused_mhd3d import make_fused_mhd_shear
from ..solvers.dissipation import _div
from ..solvers.step import mri_gz_profile, require_slice
from ..solvers.stratified import uses_stratified_z
from ..solvers.timestep import dt_from_inv
from .halo import exchange, strip_halos
from .mesh import ProcessGrid
from .shear_dist import ShardedShearComm, attach_halos_shear

ROADMAP_ITEM = "ROADMAP Queue 1 item 7"


def require_sharded_scope(params: RunParams, device, config: ConfigMap | None = None) -> None:
    """Raise NotImplementedError for a sharded configuration outside the
    ported slice (the ideal or stratified MRI shearing box), naming the
    ROADMAP item that holds the rest. ``[implementation] zSlabNb`` and
    ``haloOverlap`` select nothing on the shearing box, as in the JAX
    package (its zslab and overlap paths belong to ``make_local_step``)."""
    reasons = []
    if not params.mhd or params.dim != 3:
        reasons.append("only 3D MHD")
    if (params.boundary_xmin, params.boundary_xmax) != (BCT.BC_SHEARINGBOX,) * 2:
        reasons.append("periodic or walled MHD and hydro (make_local_step)")
    if params.nu > 0 or params.eta > 0:
        reasons.append("the sharded dissipation")
    if params.problem.startswith("turbulence"):
        reasons.append("forcing")
    if reasons:
        raise NotImplementedError(
            f"sharded runs cover the MRI shearing box (ideal or stratified); not ported: "
            f"{'; '.join(reasons)} ({ROADMAP_ITEM})")
    require_slice(params, device, config)


def local_params(params: RunParams, grid: ProcessGrid) -> RunParams:
    """The rank's block as RunParams: its extent, the global origin and
    cell size (JAX sharded_step.py:420-425)."""
    lnx, lny, lnz = params.nx // grid.mx, params.ny // grid.my, params.nz // grid.mz
    return params.replace(
        nx=lnx, ny=lny, nz=lnz,
        xmax=params.xmin + lnx * params.dx,
        ymax=params.ymin + lny * params.dy,
        zmax=params.zmin + lnz * params.dz,
    )


class StepProfile:
    """Where one rank's steps go (``profile=True`` on a CUDA rank): the host
    wall time of each section of a step, the device synchronised at the
    section's end so that the device work it queued counts in it
    (``cfl``: the CFL kernel, the all_reduce and dt; ``exchange``: the
    grown block at t + dt; ``row4``: the step kernel; ``remap``: the
    post-correction and its collectives), and the CUDA-event time of the
    row-4 and CFL launches. Off, it adds nothing."""

    SECTIONS = ("cfl", "exchange", "row4", "remap")

    def __init__(self, enabled: bool) -> None:
        self.enabled = enabled
        self._reset()

    def _reset(self) -> None:
        self.wall = dict.fromkeys(self.SECTIONS, 0.0)
        self.events = {"row4": [], "cfl": []}

    @contextlib.contextmanager
    def section(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        self.wall[name] += time.perf_counter() - t0

    def kernel(self, name: str, fn: Callable, *args):
        if not self.enabled:
            return fn(*args)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        end.record()
        self.events[name].append((start, end))
        return out

    def take(self) -> dict:
        """{"wall_ms": per section, "kernel_ms": per kernel}, totals since
        the last call (synchronises)."""
        if self.enabled:
            torch.cuda.synchronize()
        out = {"wall_ms": {k: v * 1e3 for k, v in self.wall.items()},
               "kernel_ms": {k: sum(s.elapsed_time(e) for s, e in v)
                             for k, v in self.events.items()}}
        self._reset()
        return out


def make_sharded_advance_n(params: RunParams, grid: ProcessGrid,
                           config: ConfigMap | None = None, profile: bool = False) -> Callable:
    """``advance_n(U_local, t, n) -> (U_local', t', k)`` on this rank:
    U_local the interior-only block [8, lnz, lny, lnx] on the rank's
    device, t a 0-d tensor of its dtype; up to n steps, stopping once
    t >= t_end (t_end > 0), as JAX's while_loop does. Every rank calls it
    with the same n. ``profile``: time the step's sections and the row-4
    and CFL launches (StepProfile; ``advance_n.profile.take()``)."""
    require_sharded_scope(params, grid.device, config)
    lp = local_params(params, grid)
    lnz, lny, lnx = lp.nz, lp.ny, lp.nx
    g = params.ghost_width
    comm = ShardedShearComm(params, (lnz, lny, lnx), grid)
    iz, _iy, ix = grid.coords
    x0 = params.xmin + ix * lnx * params.dx
    z0 = params.zmin + iz * lnz * params.dz
    strat = uses_stratified_z(params)
    fused_shear = make_fused_mhd_shear(lp, grid.device,
                                       gravity_z=mri_gz_profile(params, config) if strat else None)
    t_end = params.t_end
    prof = StepProfile(profile and grid.device.type == "cuda")
    inner = (slice(None), slice(g, -g), slice(g, -g), slice(g, -g))

    def kernel_update(Ub, dt, t):
        """JAX kernel_update (sharded_step.py:501-544) on the grown block
        Ub (in place; returned)."""
        with prof.section("row4"):
            new_int, fpl, eypl, _ezpl = prof.kernel("row4", fused_shear, Ub, dt, x0, z0)
        with prof.section("remap"):
            lo, hi = comm.remap_pair(torch.stack([fpl[0], eypl[0]]),
                                     torch.stack([fpl[1], eypl[1]]), t, dt)
            dtdx, dtdz = _div(dt, params.dx), _div(dt, params.dz)
            floor = new_int.new_full((), params.smallr)
            if comm.is_min:
                fmin_r, emin_r = lo
                d_emin = emin_r - eypl[0]
                col = new_int[:, :, :, 0]
                col[ID] = torch.maximum(col[ID] + dtdx * (fmin_r - fpl[0]), floor)
                # dbx = -dtdz (d_emf_y(z+1) - d_emf_y): the z+1 row of the
                # block's top comes over the z ring
                nxt = exchange(grid, "z", None, d_emin[0:1, :])[1]
                d_emin_zp1 = torch.cat([d_emin[1:], nxt], dim=0)
                col[IA] = col[IA] + (-dtdz * (d_emin_zp1 - d_emin))
                # dbz = +dtdx (d_emf_y(x+1) - d_emf_y) at the two border cells
                col[IC] = col[IC] + (-dtdx * d_emin)
            if comm.is_max:
                fmax_r, emax_r = hi
                col = new_int[:, :, :, lnx - 1]
                col[ID] = torch.maximum(col[ID] - dtdx * (fmax_r - fpl[1]), floor)
                col[IC] = col[IC] + dtdx * (emax_r - eypl[1])
            Ub[inner] = new_int
        return Ub

    def advance_n(U, t, n_steps):
        if U.device != grid.device or tuple(U.shape) != (8, lnz, lny, lnx):
            raise ValueError(f"block {tuple(U.shape)} on {U.device}, expected "
                             f"{(8, lnz, lny, lnx)} on {grid.device}")
        Ug = attach_halos_shear(lp, params, U, t, comm)
        k = 0
        while k < int(n_steps) and (t_end <= 0 or bool(t < t_end)):
            with prof.section("cfl"):
                dt = dt_from_inv(params, grid.all_max(prof.kernel("cfl", cfl_mhd_window, lp, Ug)))
            with prof.section("exchange"):
                Ub = attach_halos_shear(lp, params, strip_halos(lp, Ug), t + dt, comm)
            Ug = kernel_update(Ub, dt, t)
            t = t + dt
            k += 1
        return strip_halos(lp, Ug).contiguous(), t, k

    advance_n.profile = prof
    return advance_n


def shard_global_state(params: RunParams, grid: ProcessGrid, U) -> torch.Tensor:
    """This rank's interior block [8, lnz, lny, lnx] (contiguous, in the
    run's dtype, on its device) of a global state U, numpy or tensor,
    ghosted or interior-only (the JAX sharded array): every rank holds the
    same global state (the inits are deterministic) and keeps its own block
    (JAX sharded_step.py:882 shard_global_state)."""
    U = torch.as_tensor(U)
    g = params.ghost_width if tuple(U.shape[1:]) == params.shape[1:] else 0
    if tuple(U.shape[1:]) != (params.nz + 2 * g, params.ny + 2 * g, params.nx + 2 * g):
        raise ValueError(f"global state shape {tuple(U.shape)} is neither the interior "
                         f"nor {params.shape}")
    lnx, lny, lnz = params.nx // grid.mx, params.ny // grid.my, params.nz // grid.mz
    iz, iy, ix = grid.coords
    block = U[:, g + iz * lnz:g + (iz + 1) * lnz, g + iy * lny:g + (iy + 1) * lny,
              g + ix * lnx:g + (ix + 1) * lnx]
    return block.to(device=grid.device, dtype=torch_dtype(params)).contiguous()


def gather_global_state(params: RunParams, grid: ProcessGrid, U_local: torch.Tensor):
    """The global interior [8, nz, ny, nx] (a CPU tensor) assembled on rank
    0 from every rank's block; None on the other ranks."""
    lnz, lny, lnx = U_local.shape[1:]
    buf = grid.send_form(U_local)
    if grid.mx * grid.my * grid.mz == 1:
        return buf.cpu()
    parts = [torch.empty_like(buf) for _ in range(grid.mx * grid.my * grid.mz)] \
        if grid.rank == 0 else None
    dist.gather(buf, parts, dst=0)
    if grid.rank != 0:
        return None
    out = torch.empty((8, params.nz, params.ny, params.nx), dtype=U_local.dtype)
    for r, part in enumerate(parts):
        iz, iy, ix = r // (grid.mx * grid.my), (r // grid.mx) % grid.my, r % grid.mx
        out[:, iz * lnz:(iz + 1) * lnz, iy * lny:(iy + 1) * lny,
            ix * lnx:(ix + 1) * lnx] = part.cpu()
    return out


def launch_counts() -> dict:
    """The launch counters of the kernels a shearing-box rank may run: row
    4 and its CFL, and the single-device shear step and CFL, which a
    sharded run never launches."""
    from ..kernels.cfl_mhd import cfl_mhd
    from ..kernels.mhd_step import mhd_step, mhd_window

    return {"mhd_window": mhd_window.launches, "cfl_mhd_window": cfl_mhd_window.launches,
            "mhd_step": mhd_step.launches, "cfl_mhd": cfl_mhd.launches}


def rank_advance(config_text: str, device: str, n_steps: int, U0=None, t0: float = 0.0,
                 chunks: int = 1, profile: bool = False) -> dict:
    """One rank's part of a sharded advance from the INI text: join the
    world (parallel/mesh.py init_process_group), take this rank's block of
    the global state U0 (numpy, ghosted or the JAX sharded interior;
    default: the problem's initial state), advance ``chunks`` chunks of
    n_steps from t0, each timed on the host clock after a barrier, and
    gather. Every rank returns k (the last chunk's steps) and t, the
    launch counts of its kernels over the chunks, the chunks' seconds and,
    with ``profile`` (a CUDA rank), where its steps went (StepProfile);
    rank 0 also the global interior (numpy)."""
    from ..config.params import params_from_config
    from ..problems import init_problem
    from .mesh import init_process_group, topology_from_config

    config = ConfigMap(text=config_text)
    params = params_from_config(config)
    grid = init_process_group(device, topology_from_config(config))
    if U0 is None:
        U0 = init_problem(params, config)
    U = shard_global_state(params, grid, U0)
    advance = make_sharded_advance_n(params, grid, config, profile=profile)
    t = torch.tensor(t0, dtype=torch_dtype(params), device=grid.device)
    cuda = grid.device.type == "cuda"
    before, seconds, k = launch_counts(), [], 0
    for _ in range(chunks):
        if cuda:
            torch.cuda.synchronize()
        dist.barrier()
        wall = time.perf_counter()
        U, t, k = advance(U, t, n_steps)
        if cuda:
            torch.cuda.synchronize()
        seconds.append(time.perf_counter() - wall)
    counts = {name: n - before[name] for name, n in launch_counts().items()}
    out = {"rank": grid.rank, "k": k, "t": float(t), "counts": counts, "chunk_s": seconds,
           "backend": grid.backend, "transport": grid.describe(), "device": str(grid.device)}
    if profile:
        out["profile"] = advance.profile.take()
    glob = gather_global_state(params, grid, U)
    if glob is not None:
        out["U"] = glob.numpy()
    return out


def rank_jobs(jobs: list[dict]) -> list[dict]:
    """rank_advance of each job (its keyword arguments) in turn, in one
    world: every rank runs the same jobs in the same order, each on its
    own [mpi] topology of the world's size."""
    return [rank_advance(**job) for job in jobs]
