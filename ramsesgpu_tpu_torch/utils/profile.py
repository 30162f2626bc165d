"""Per-phase step profile: the reference's DO_TIMING breakdown (the port's
counterpart of ramsesgpu_tpu/utils/profile.py; reference
HydroRunGodunov.cpp:4056-4062, MHDRunGodunov.h:382-405).

Each phase is what the port runs for it, launched alone and timed best of
N: on the card by CUDA events around the call, on the CPU (where the
kernel wrappers run their plain twins) by the host clock.

- "dt reduction": the configuration's CFL (its loop's, kernels/loop.py);
- "boundary fill": the ghost fill of the ghosted state (the sheared fill
  on a shearing box);
- "godunov update": the step of the configuration without nu and eta, as
  its loop binds it (one launch of the step kernel on the periodic and
  walled paths; the slab, step and border launches on a shearing box; the
  in-place fill and the step on the ghosted loop; the whole-array step in
  2D);
- "dissipative": the viscous-resistive sub-step on the filled ghosted
  state (MHD: the dissipation kernel's ghosted mode; hydro: the
  whole-array viscosity), when nu or eta > 0;
- "full fused step": one step of the run's own chunk loop.

The distributed profile times, in a world of the ``[mpi]`` topology's
ranks, the halo exchange (parallel/halo.py fill_halos_) and one step of
the sharded loop, the slowest rank's best of N; the port has no halo
overlap yet (ROADMAP Queue 1 item 7.5).
"""
from __future__ import annotations

import time
from typing import Callable

import torch

from ..config.params import RunParams


def time_best(fn: Callable, device, reps: int = 5) -> float:
    """The best of ``reps`` calls of fn() in seconds, after one warm-up
    call: CUDA events on the card, the host clock on the CPU."""
    device = torch.device(device)
    fn()
    best = float("inf")
    for _ in range(reps):
        if device.type == "cuda":
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            best = min(best, start.elapsed_time(stop) * 1e-3)
        else:
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
    return best


def _initial_state(params: RunParams, config, device) -> torch.Tensor:
    from ..convert import torch_dtype
    from ..problems import init_problem
    from ..solvers.boundary import make_boundaries

    U0 = torch.from_numpy(init_problem(params, config)).to(device, torch_dtype(params))
    return make_boundaries(params, U0)


def _chain(params: RunParams, config, device):
    from ..solvers.step import is_forced, make_forced_chain, make_packed_advance_chain

    if is_forced(params):
        return make_forced_chain(params, device, config)[0]
    return make_packed_advance_chain(params, device, config)


def profile_step(params: RunParams, config, device="cuda", reps: int = 5) -> dict[str, float]:
    """The phases of one step on ``device``: {phase: seconds}."""
    from ..kernels.mhd_step import uses_shear
    from ..solvers.boundary import fill_ghosts_, make_boundaries
    from ..solvers.dissipation import uses_dissipation, viscosity_
    from ..solvers.timestep import dt_from_inv

    device = torch.device(device)
    U = _initial_state(params, config, device)
    t0 = torch.zeros((), dtype=U.dtype, device=device)
    active = torch.ones((), dtype=torch.bool, device=device)
    pack, advance, _unpack = _chain(params, config, device)
    S = pack(U)
    dt = dt_from_inv(params, advance.cfl(S))

    phases: dict[str, float] = {}
    phases["dt reduction"] = time_best(lambda: advance.cfl(S), device, reps)
    shear = params.dim == 3 and params.mhd and uses_shear(params)
    if shear:
        from ..solvers.shear import make_all_boundaries_shear

        phases["boundary fill"] = time_best(
            lambda: make_all_boundaries_shear(params, U, t0), device, reps)
    else:
        phases["boundary fill"] = time_best(lambda: make_boundaries(params, U), device, reps)

    ideal = params.replace(nu=0.0, eta=0.0)
    pack_i, advance_i, _u = _chain(ideal, config, device)
    S_i = pack_i(U)
    step = advance_i.bind_step(S_i)
    phases["godunov update"] = time_best(lambda: step(S_i, dt, active, t0), device, reps)

    if uses_dissipation(params):
        U_b = fill_ghosts_(params, U.clone())
        if params.mhd:
            from ..kernels.dissip_step import DissipStepKernel, dissip_step

            buf = DissipStepKernel.scratch(params, U_b)
            phases["dissipative"] = time_best(
                lambda: dissip_step.ghosted_(params, U_b.clone(), dt, active, buf,
                                             interior_only=shear), device, reps)
        else:
            phases["dissipative"] = time_best(
                lambda: viscosity_(params, U_b.clone(), dt, active), device, reps)

    def full_step():
        advance(S, t0, 1)

    phases["full fused step"] = time_best(full_step, device, reps)
    return phases


def format_profile(phases: dict[str, float]) -> str:
    total = sum(v for k, v in phases.items() if k != "full fused step")
    lines = ["per-phase profile (each phase launched alone, best-of-N):"]
    for k, v in phases.items():
        if k == "full fused step":
            continue
        lines.append(f"  {k:18s}: {v * 1e3:8.2f} ms ({100 * v / total:5.1f} %)")
    lines.append(f"  {'sum of phases':18s}: {total * 1e3:8.2f} ms")
    if "full fused step" in phases:
        lines.append(f"  {'full fused step':18s}: "
                     f"{phases['full fused step'] * 1e3:8.2f} ms (one step of the run's loop)")
    return "\n".join(lines)


def profile_step_distributed(params: RunParams, config, device="cuda",
                             reps: int = 5) -> dict[str, float] | None:
    """The distributed step's phases on this rank's world (joined from the
    environment, parallel/mesh.py init_process_group): "halo exchange",
    the ghost fill of every rank's block alone, and "sync step", one step
    of the sharded loop; each the slowest rank's best of ``reps``. Every
    rank must call it; rank 0 gets {phase: seconds}, the others None."""
    import torch.distributed as dist

    from ..parallel.halo import attach_halos, fill_halos_
    from ..parallel.mesh import init_process_group, topology_from_config, validate_decomposition
    from ..parallel.sharded_step import make_sharded_advance_n, shard_global_state
    from ..problems import init_problem

    topo = topology_from_config(config)
    validate_decomposition(params, *topo)
    grid = init_process_group(device, topo)
    U = shard_global_state(params, grid, init_problem(params, config))
    Ug = attach_halos(params, grid, U)
    t0 = torch.zeros((), dtype=U.dtype, device=grid.device)
    advance = make_sharded_advance_n(params, grid, config)

    def slowest(fn) -> float:
        def synced():
            dist.barrier()
            fn()
        best = torch.tensor(time_best(synced, "cpu", reps), dtype=torch.float64)
        return float(grid.all_max(best.to(grid.device)))

    def cuda_synced(fn):
        def call():
            fn()
            if grid.device.type == "cuda":
                torch.cuda.synchronize(grid.device)
        return call

    phases = {"halo exchange": slowest(cuda_synced(lambda: fill_halos_(params, grid, Ug))),
              "sync step": slowest(cuda_synced(lambda: advance(U.clone(), t0, 1)))}
    return phases if grid.rank == 0 else None


def format_profile_distributed(phases: dict[str, float], n_devices: int) -> str:
    lines = [f"distributed step profile ({n_devices} devices, best-of-N):"]
    for k, v in phases.items():
        if k == "overlap %":
            lines.append(f"  {'halo overlap':18s}: {100 * v:5.1f} % of exchange time "
                         "hidden (reference: 0 %)")
        else:
            lines.append(f"  {k:18s}: {v * 1e3:8.2f} ms")
    if "overlap step" not in phases:
        lines.append("  halo overlap      : not supported for this configuration")
    return "\n".join(lines)
