"""Time stepping over ranks: one process per rank, torch.distributed
between them (the port's counterpart of ramsesgpu_tpu/parallel/
sharded_step.py; reference HydroRunGodunovMpi.cpp, MHDRunGodunovMpi.cpp).

Two loops, as in the JAX ``make_sharded_advance_n`` (:647):

**Periodic, walled and jet runs, 2D and 3D** (JAX ``make_local_step``,
:117-402, its synchronous branch ``local_step``, :371-400). Each rank
carries its ghosted local block, whose interior is the state; per step

1. the halo fill in place (parallel/halo.py ``fill_halos_``: the x, y
   (and z) exchanges, the physical fill of the ranks at the domain's
   edge, then the inflow jet on the ranks that hold its face);
2. the inverse dt on the filled block, the max over ranks (all_reduce MAX,
   JAX ``lax.pmax``), dt;
3. the update: in 3D MHD TPU row 3 (kernels/fused_mhd3d.py
   ``make_fused_mhd_update``, the step kernel's ghosted mode in place),
   after the CFL kernel's ghosted mode (kernels/cfl_mhd.py, the jet's
   floor in the kernel); in 3D hydro the hydro step kernel's ghosted mode
   (kernels/hydro_step.py ``ghosted_``, TPU row 5, where the JAX package
   runs its whole-array step, :292-299, whose counterpart it is) after
   csrc/cfl_hydro.cu's ghosted form with the jet's floor; in 2D the
   whole-array ``godunov_unsplit_hydro`` / ``godunov_unsplit_mhd`` on the
   rank's device (the JAX package has no 2D kernel) after the whole-array
   CFL. The new interior stays in the block, whose ghosts the next fill
   rewrites (the MHD step's CT face layer n+g among them);
4. with nu or eta (3D; JAX :393-398, whose refill comes before the
   dissipative sub-step): the fill again, the jet included, then in MHD
   TPU row 8 (kernels/dissip_step.py ``ghosted_``, the dissipation
   kernel's ghosted mode, the interior alone written back, JAX
   ``dissipate``, :276-283), in hydro the whole-array viscous sub-step
   (solvers/dissipation.py ``viscosity_``, JAX :300-303; the JAX package
   has no kernel for it);
5. on a turbulence problem (JAX ``make_sharded_forced_advance_n``,
   :707-847, its body :810-814) the forcing on the block's interior
   (ops/forcing.py): the rank's block of the global static field, the sums
   of its normalization summed over the ranks in float64
   (``ProcessGrid.all_sum``, JAX ``lax.psum``); or the OU kick with the
   rank's block of the mode basis and the mode state replicated on every
   rank. The forcing object lives in the loop (``advance_n.forcing``)
   across chunks.

A static gravity field enters as each rank's ghosted window of the
global field (``gravity_window``, JAX ``_gravity_windows``, :611-645),
sliced and never exchanged: in 2D the whole-array step takes it; in 3D a
uniform field is the constant vector of the parameter block, which
selects the kernels' gravity instances as on one device; a non-uniform 3D
field raises (solvers/step.py require_slice). The inflow jet and its dt
floor are applied as the single-device step applies them (JAX
solvers/boundary.py:228-229, solvers/timestep.py:257-261); the JAX
sharded step has neither (ROADMAP Queue 3 item 15), so the port's sharded
jet runs are held against single-device runs. ``[implementation]
zSlabNb`` selects nothing, as on the port's kernel paths; where the JAX
``make_local_step`` would slab (3D hydro, or 3D MHD with gravity), a
local nz it does not divide raises the JAX package's ValueError.

**The shearing box** (the MRI, ideal or stratified), JAX
``_make_sharded_advance_shear`` (:404-608) on its kernel route: each rank
carries its GHOSTED local block, so the CFL reads ghosts one fill old, as
the single-device step computes dt before the fill; per step

1. the CFL kernel's ghosted shearing-box form on the block as it stands,
   and the max over ranks;
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
   its ghosts stay those of the fill, the CFL of the next step reads them;
4. with nu or eta (JAX :567-578): the new interior grown again by
   ``attach_halos_shear`` at t + dt, then TPU row 8, the dissipation
   kernel's ghosted mode on that block (the sheared fill has filled it),
   the interior alone written back; the block's ghosts stay those of this
   second fill.

The JAX package's own test (tests/test_parallel.py:531-550) holds this
route against its whole-array route (``_mhd_update``) with a tolerance:
the whole-array update also moves the CT face layer n+g of the block,
which the next CFL reads (so does its whole-array dissipation, ROADMAP
Queue 3 item 10).

Not ported, and raising NotImplementedError naming its ROADMAP item
(``require_sharded_scope``): 2D viscosity or resistivity (Queue 1 item
3.2, as on one device), the stratified box with nu or eta (item 4, as on
one device) and ``[implementation] haloOverlap`` (item 7.5). Forcing is
taken where the single-device forced loops take it.
"""
from __future__ import annotations

import contextlib
import importlib.util
import time
from typing import Callable

import torch
import torch.distributed as dist

from ..config.configmap import ConfigMap
from ..config.params import RunParams, static_gravity
from ..convert import torch_dtype
from ..core.constants import IA, IC, ID
from ..kernels.cfl_hydro import cfl_hydro
from ..kernels.cfl_mhd import cfl_mhd, cfl_mhd_window
from ..kernels.dissip_step import dissip_step
from ..kernels.fused_mhd3d import make_fused_mhd_shear, make_fused_mhd_update
from ..kernels.hydro_step import hydro_step
from ..kernels.mhd_step import uses_ghosted, uses_shear
from ..ops.forcing import FORCED_PROBLEMS, make_forcing
from ..problems import has_gravity_field
from ..solvers.boundary import uses_jet
from ..solvers.dissipation import _div, uses_dissipation, viscosity_
from ..solvers.godunov import godunov_unsplit_hydro
from ..solvers.godunov_mhd import godunov_unsplit_mhd
from ..solvers.step import make_gravity_field, mri_gz_profile, require_slice
from ..solvers.stratified import uses_stratified_z
from ..solvers.timestep import dt_from_inv, inv_dt_ghosted
from .halo import attach_jet, exchange, fill_halos_, strip_halos
from .mesh import ProcessGrid, block_slices, local_params, topology_from_config
from .shear_dist import ShardedShearComm, attach_halos_shear

ROADMAP_ITEM = "ROADMAP Queue 1 item 7"


def require_sharded_scope(params: RunParams, device, config: ConfigMap | None = None) -> None:
    """Raise for a sharded configuration outside the port, before any rank
    starts: NotImplementedError naming the ROADMAP item that holds 2D
    viscosity or resistivity (Queue 1 item 3.2), the stratified box with
    nu or eta (item 4) and ``haloOverlap`` (item 7.5), and for forcing
    where the single-device forced loops refuse it (2D, the shearing box,
    the jet, MHD walls or gravity); then the single-device scope
    (solvers/step.py require_slice); then, given the run's ``config`` (its
    [mpi] topology), the JAX package's ValueError for a local nz that
    ``zSlabNb`` does not divide where the JAX ``make_local_step`` slabs
    (:361-369: 3D hydro, or 3D MHD with gravity, or any 3D run outside
    its kernels). On the shearing box ``zSlabNb`` and ``haloOverlap``
    select nothing, as in the JAX package (its zslab and overlap paths
    belong to ``make_local_step``)."""
    shear = uses_shear(params)
    reasons = []
    if shear and (not params.mhd or params.dim != 3):
        reasons.append("a shearing box outside 3D MHD")
    if uses_dissipation(params) and params.dim == 2:
        reasons.append("2D viscosity / resistivity (ROADMAP Queue 1 item 3.2)")
    if uses_dissipation(params) and shear and uses_stratified_z(params):
        reasons.append("viscosity or resistivity with stratified z faces (ROADMAP Queue 1 "
                       "item 4)")
    if params.problem in FORCED_PROBLEMS and (
            params.dim != 3 or shear or uses_jet(params)
            or (params.mhd and uses_ghosted(params))):
        reasons.append("forcing outside periodic 3D MHD and 3D hydro without the jet "
                       "(as on one device)")
    if params.halo_overlap and not shear:
        reasons.append(f"[implementation] haloOverlap ({ROADMAP_ITEM}.5)")
    if params.omega0 > 0 and not shear:
        reasons.append("a rotating frame without a shearing box")
    topo = (1, 1, 1) if config is None else topology_from_config(config)
    if params.dim == 2 and topo[2] != 1:
        reasons.append(f"a 2D run over mz = {topo[2]} z ranks")
    if reasons:
        raise NotImplementedError(f"not ported in a sharded run: {'; '.join(reasons)}")
    require_slice(params, device, config)
    if shear or params.dim != 3 or params.z_slab_nb <= 1:
        return
    gravity = static_gravity(params) is not None or has_gravity_field(
        params, config if config is not None else ConfigMap(text=""))
    kernel_route = params.mhd and params.kernel in ("auto", "pallas") and not gravity
    lnz = params.nz // topo[2]
    if not kernel_route and lnz % params.z_slab_nb:
        raise ValueError(f"local nz={lnz} (nz={params.nz} over mz shards) not "
                         f"divisible by zSlabNb={params.z_slab_nb}")


class StepProfile:
    """Where one rank's steps go (``profile=True`` on a CUDA rank): the host
    wall time of each section of a step, the device synchronised at the
    section's end so that the device work it queued counts in it, and the
    CUDA-event time of the step, CFL and dissipation launches. The
    shearing box's sections (``SHEAR``): ``cfl`` (the CFL kernel, the
    all_reduce and dt), ``exchange`` (the grown block at t + dt, both
    fills with nu or eta), ``row4`` (the step kernel), ``remap`` (the
    post-correction and its collectives), ``dissip`` (row 8 and its copy
    back). The other runs' (``LOCAL``): ``exchange`` (the halo exchanges
    and the physical fill, both fills with nu or eta), ``jet`` (the inflow
    jet's fill, on jet runs), ``cfl``, ``step`` (the step kernel, or the
    2D whole-array step), ``dissip`` (row 8, or hydro's whole-array
    viscous sub-step) and ``force`` (the forcing, its all_reduce
    included). Off, it adds nothing."""

    SHEAR = (("cfl", "exchange", "row4", "remap", "dissip"), ("row4", "cfl", "dissip"))
    LOCAL = (("exchange", "jet", "cfl", "step", "dissip", "force"), ("step", "cfl", "dissip"))

    def __init__(self, enabled: bool, layout=SHEAR) -> None:
        self.enabled = enabled
        self.sections, self.kernels = layout
        self._reset()

    def _reset(self) -> None:
        self.wall = dict.fromkeys(self.sections, 0.0)
        self.events = {name: [] for name in self.kernels}

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
    U_local the interior-only block [nvar, (lnz,) lny, lnx] on the rank's
    device, t a 0-d tensor of its dtype; up to n steps, stopping once
    t >= t_end (t_end > 0), as JAX's while_loop does. Every rank calls it
    with the same n. ``profile``: time the step's sections and the step,
    CFL and dissipation launches (StepProfile; ``advance_n.profile.take()``).
    A turbulence problem takes its forcing after each step;
    ``advance_n.forcing`` is its forcing object (ops/forcing.py), whose OU
    state it carries across calls (None without forcing)."""
    require_sharded_scope(params, grid.device, config)
    if not uses_shear(params):
        return _make_local_advance_n(params, grid, config, profile)
    lp = local_params(params, grid)
    lnz, lny, lnx = lp.nz, lp.ny, lp.nx
    g = params.ghost_width
    comm = ShardedShearComm(params, (lnz, lny, lnx), grid)
    iz, _iy, ix = grid.coords
    x0 = params.xmin + ix * lnx * params.dx
    z0 = params.zmin + iz * lnz * params.dz
    strat = uses_stratified_z(params)
    # row 4 is the ideal step; the dissipative sub-step is row 8's, after it
    fused_shear = make_fused_mhd_shear(lp.replace(nu=0.0, eta=0.0), grid.device,
                                       gravity_z=mri_gz_profile(params, config) if strat else None)
    t_end = params.t_end
    prof = StepProfile(profile and grid.device.type == "cuda")
    inner = (slice(None), slice(g, -g), slice(g, -g), slice(g, -g))
    dissipate = ghosted_dissipation(lp, grid.device) if uses_dissipation(params) else None

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
            if dissipate is not None:
                with prof.section("exchange"):
                    Ug = attach_halos_shear(lp, params, strip_halos(lp, Ug), t + dt, comm)
                with prof.section("dissip"):
                    prof.kernel("dissip", dissipate, Ug, dt)
            t = t + dt
            k += 1
        return strip_halos(lp, Ug).contiguous(), t, k

    advance_n.profile = prof
    advance_n.forcing = None
    return advance_n


def ghosted_dissipation(lp: RunParams, device) -> Callable:
    """``dissipate(Ug, dt)``: TPU row 8, the dissipation kernel's ghosted
    mode, on a rank's refilled block Ug in place, the interior alone
    written back (JAX sharded_step.py:282-283, 572-574); its output buffer
    allocated once. Returns Ug."""
    always = torch.ones((), dtype=torch.bool, device=device)
    buf = None

    def dissipate(Ug, dt):
        nonlocal buf
        if buf is None:
            buf = dissip_step.scratch(lp, Ug)
        return dissip_step.ghosted_(lp, Ug, dt, always, buf, interior_only=True)

    return dissipate


def gravity_window(params: RunParams, grid: ProcessGrid, config: ConfigMap | None
                   ) -> torch.Tensor | None:
    """This rank's ghosted window [2, lny+2g, lnx+2g] of a 2D run's static
    gravity field (solvers/step.py make_gravity_field) on its device, or
    None (JAX ``_gravity_windows``, :611-645): gravity is a function of the
    coordinates, so its ghost values come from the ghost coordinates and
    the window is sliced from the global field, never exchanged. In 3D a
    uniform field is the constant vector of the parameter block, and this
    returns None."""
    if params.dim != 2:
        return None
    field = make_gravity_field(params, config)
    if field is None:
        return None
    g = params.ghost_width
    lny, lnx = params.ny // grid.my, params.nx // grid.mx
    _iz, iy, ix = grid.coords
    window = field[:, iy * lny:iy * lny + lny + 2 * g, ix * lnx:ix * lnx + lnx + 2 * g]
    return window.contiguous().to(grid.device)


def _make_local_advance_n(params: RunParams, grid: ProcessGrid, config: ConfigMap | None,
                          profile: bool) -> Callable:
    """make_sharded_advance_n of a periodic, walled or jet run (see the
    module note)."""
    lp = local_params(params, grid)
    g = params.ghost_width
    want = (params.nb_var, *(n - 2 * g for n in lp.shape[1:]))
    t_end = params.t_end
    prof = StepProfile(profile and grid.device.type == "cuda", StepProfile.LOCAL)
    always = torch.ones((), dtype=torch.bool, device=grid.device)
    dissipate = None
    if uses_dissipation(params):
        dissipate = (ghosted_dissipation(lp, grid.device) if params.mhd
                     else lambda Ug, dt: viscosity_(lp, Ug, dt))
    forcing = make_forcing(params, config if config is not None else ConfigMap(text=""),
                           grid.device, torch_dtype(params),
                           block=block_slices(params, grid, grid.rank), reduce=grid.all_sum)
    if params.dim == 2:
        gravity = gravity_window(params, grid, config)
        update = godunov_unsplit_mhd if params.mhd else godunov_unsplit_hydro

        def cfl(Ug):
            return inv_dt_ghosted(lp, Ug)

        def step(Ug, dt):
            return update(lp, Ug, dt, gravity)
    elif params.mhd:
        fused = make_fused_mhd_update(lp, grid.device)

        def cfl(Ug):
            return cfl_mhd(lp, Ug, ghost=g)

        def step(Ug, dt):
            fused(Ug, dt, in_place=True)
            return Ug
    else:
        buf = None  # the in-place step's interior buffer, allocated once

        def cfl(Ug):
            return cfl_hydro(lp, Ug, ghost=g)

        def step(Ug, dt):
            nonlocal buf
            if buf is None:
                buf = hydro_step.scratch(lp, Ug)
            return hydro_step.ghosted_(lp, Ug, dt, always, buf)

    def advance_n(U, t, n_steps):
        if U.device != grid.device or tuple(U.shape) != want:
            raise ValueError(f"block {tuple(U.shape)} on {U.device}, expected {want} on "
                             f"{grid.device}")
        Ug = U.new_empty(lp.shape)
        strip_halos(lp, Ug).copy_(U)
        k = 0
        while k < int(n_steps) and (t_end <= 0 or bool(t < t_end)):
            with prof.section("exchange"):
                fill_halos_(lp, grid, Ug)
            with prof.section("jet"):
                attach_jet(lp, grid, Ug)
            with prof.section("cfl"):
                dt = dt_from_inv(params, grid.all_max(prof.kernel("cfl", cfl, Ug)))
            with prof.section("step"):
                Ug = prof.kernel("step", step, Ug, dt)
            if dissipate is not None:
                with prof.section("exchange"):
                    fill_halos_(lp, grid, Ug)
                with prof.section("jet"):
                    attach_jet(lp, grid, Ug)
                with prof.section("dissip"):
                    prof.kernel("dissip", dissipate, Ug, dt)
            if forcing is not None:
                with prof.section("force"):
                    forcing(strip_halos(lp, Ug), dt, always)
            t = t + dt
            k += 1
        return strip_halos(lp, Ug).contiguous(), t, k

    advance_n.profile = prof
    advance_n.forcing = forcing
    return advance_n


def shard_global_state(params: RunParams, grid: ProcessGrid, U) -> torch.Tensor:
    """This rank's interior block [nvar, (lnz,) lny, lnx] (contiguous, in
    the run's dtype, on its device) of a global state U, numpy or tensor,
    ghosted or interior-only (the JAX sharded array), 2D or 3D: every rank
    holds the same global state (the inits are deterministic) and keeps its
    own block (JAX sharded_step.py:882 shard_global_state)."""
    U = torch.as_tensor(U)
    inner = (params.nz, params.ny, params.nx)[-params.dim:]
    g = params.ghost_width if tuple(U.shape[1:]) == params.shape[1:] else 0
    if tuple(U.shape[1:]) != tuple(n + 2 * g for n in inner):
        raise ValueError(f"global state shape {tuple(U.shape)} is neither the interior "
                         f"nor {params.shape}")
    block = U[(slice(None),) + tuple(slice(s.start + g, s.stop + g)
                                     for s in block_slices(params, grid, grid.rank)[1:])]
    return block.to(device=grid.device, dtype=torch_dtype(params)).contiguous()


def gather_global_state(params: RunParams, grid: ProcessGrid, U_local: torch.Tensor):
    """The global interior [nvar, (nz,) ny, nx] (a CPU tensor) assembled on
    rank 0 from every rank's block; None on the other ranks."""
    buf = grid.send_form(U_local)
    n_ranks = grid.mx * grid.my * grid.mz
    if n_ranks == 1:
        return buf.cpu()
    parts = [torch.empty_like(buf) for _ in range(n_ranks)] if grid.rank == 0 else None
    dist.gather(buf, parts, dst=0)
    if grid.rank != 0:
        return None
    inner = (params.nz, params.ny, params.nx)[-params.dim:]
    out = torch.empty((U_local.shape[0], *inner), dtype=U_local.dtype)
    for r, part in enumerate(parts):
        out[block_slices(params, grid, r)] = part.cpu()
    return out


def launch_counts() -> dict:
    """The launch counters of the kernels a rank may run: on the shearing
    box row 4 and its CFL; on the other 3D runs the step and CFL kernels'
    ghosted modes (``*_ghosted``) among their totals; with nu or eta in 3D
    MHD the dissipation kernel's ghosted mode (row 8). The totals' other
    modes are the single-device loops', which a sharded run never
    launches."""
    from ..kernels.mhd_step import mhd_step, mhd_window

    return {"mhd_window": mhd_window.launches, "cfl_mhd_window": cfl_mhd_window.launches,
            "mhd_step": mhd_step.launches, "cfl_mhd": cfl_mhd.launches,
            "mhd_step_ghosted": mhd_step.ghosted_launches,
            "cfl_mhd_ghosted": cfl_mhd.ghosted_launches,
            "hydro_step": hydro_step.launches, "cfl_hydro": cfl_hydro.launches,
            "hydro_step_ghosted": hydro_step.ghosted_launches,
            "cfl_hydro_ghosted": cfl_hydro.ghosted_launches,
            "dissip_step": dissip_step.launches,
            "dissip_step_ghosted": dissip_step.ghosted_launches}


def rank_advance(config_text: str, device: str, n_steps: int, U0=None, t0: float = 0.0,
                 chunks: int = 1, profile: bool = False, snapshot=None,
                 ou_draws=None) -> dict:
    """One rank's part of a sharded advance from the INI text: join the
    world (parallel/mesh.py init_process_group), take this rank's block of
    the global state U0 (numpy, ghosted or the JAX sharded interior;
    default: the problem's initial state), advance ``chunks`` chunks of
    n_steps from t0, each timed on the host clock after a barrier, and
    gather. Every rank returns k (the last chunk's steps) and t, the
    launch counts of its kernels over the chunks, the chunks' seconds and,
    with ``profile`` (a CUDA rank), where its steps went (StepProfile);
    rank 0 also the global interior (numpy). ``snapshot``, a pair
    (directory, prefix): then the VTK pieces and, where h5py is installed,
    the HDF5 file of the final state (io/sharded.py), as step k. The
    forcing of a turbulence problem stays in the loop across the chunks;
    ``ou_draws`` (numpy [steps, 3, 31]) replaces the OU generator's draws
    on every rank, one block a step (the tests replay the JAX package's);
    an OU run returns its final mode field too."""
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
    state = None if advance.forcing is None else advance.forcing.state
    if state is not None and ou_draws is not None:
        draws = iter(torch.as_tensor(ou_draws).to(grid.device))
        state.draw = lambda: next(draws)
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
    if state is not None:
        out["forcingField"] = state.forcingField.cpu().numpy()
    if snapshot is not None:
        from ..io.sharded import output_hdf5_sharded, output_vtk_pieces

        kw = dict(output_dir=snapshot[0], prefix=snapshot[1])
        output_vtk_pieces(params, grid, U, k, **kw)
        if importlib.util.find_spec("h5py") is not None:
            output_hdf5_sharded(params, grid, U, k, total_time=float(t), **kw)
    glob = gather_global_state(params, grid, U)
    if glob is not None:
        out["U"] = glob.numpy()
    return out


def rank_jobs(jobs: list[dict]) -> list[dict]:
    """rank_advance of each job (its keyword arguments) in turn, in one
    world: every rank runs the same jobs in the same order, each on its
    own [mpi] topology of the world's size."""
    return [rank_advance(**job) for job in jobs]
