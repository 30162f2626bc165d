"""Analytic device-memory planner of the port on one 80 GB H100 (the
counterpart of ramsesgpu_tpu/utils/memory_footprint.py; reference
memory_footprint.py:10-21).

Re-based on what the port allocates, not on the TPU's lane padding: the
ghosted state a Run keeps, the chunk loop's state and the step's buffers
(kernels/loop.py and the kernel modules):

- the staged MHD step (kernel=auto on the periodic, compensated and
  shearing-box paths): the interior loop state S (8 channels, 16
  compensated), the stage buffer of 77 values a cell (csrc/mhd_stages.cuh
  SCRATCH_PER_CELL; 85 on the shearing box's stage grid of nx + 4
  columns, and nz + 4 rows when stratified) and, with nu or eta, the
  second state buffer the dissipation kernel writes;
- kernel=zcarry: S and the second buffer the streamed step writes; no
  stage buffer (the rings live in shared memory);
- the ghosted loop (walls, the jet, gravity): a copy of the ghosted state
  and the stage buffer over the ghosted array; with nu or eta the
  dissipation's cube [8, nz+1, ny+1, nx+1];
- 3D hydro: S [5, ...] and the streamed step's second buffer (the jet and
  nu: the ghosted copy and an interior buffer);
- 2D: the ghosted copy and the whole-array step's intermediates (about 12
  state-sized arrays, as the JAX planner counts them);
- every CFL reduction's workspace (1024 partials).

The keys end in _GiB; ``loop_GiB`` is the path the configuration runs,
``run_GiB`` that plus the Run's own ghosted state. The ``[mpi]`` form
plans one rank's block.
"""
from __future__ import annotations

from ..config.params import RunParams

H100_GIB = 80e9 / 1024 ** 3  # one card's device memory
SCRATCH_PER_CELL = 77        # csrc/mhd_stages.cuh
SHEAR_SCRATCH_PER_CELL = 85
CFL_PARTIALS = 1024          # csrc/cfl_rows.cuh CFL_BLOCKS


def _bpe(params: RunParams) -> int:
    return 8 if params.dtype == "float64" else 4


def _cells(params: RunParams) -> int:
    return params.nx * params.ny * (params.nz if params.dim == 3 else 1)


def state_bytes(params: RunParams) -> int:
    """One ghosted state [nvar, (nz+2g,) ny+2g, nx+2g]."""
    g = params.ghost_width
    ghosted = (params.nx + 2 * g) * (params.ny + 2 * g) * (params.nz + 2 * g if params.dim == 3
                                                           else 1)
    return params.nb_var * ghosted * _bpe(params)


def loop_state_bytes(params: RunParams) -> int:
    """The interior-only loop state S of the 3D kernel loops (with its
    Kahan carry when compensated)."""
    channels = params.nb_var * (2 if params.mhd and params.compensated else 1)
    return channels * _cells(params) * _bpe(params)


def path_bytes(params: RunParams) -> dict[str, int]:
    """{path: bytes} of the chunk loops this configuration's physics can
    run (see the module note), the CFL workspace included."""
    b, n, g = _bpe(params), _cells(params), params.ghost_width
    work = CFL_PARTIALS * b + 4
    S, U = loop_state_bytes(params), state_bytes(params)
    ghosted_cells = U // (params.nb_var * b)
    if params.dim == 2:
        return {"whole_array_2d": U + 12 * U + work}
    dissip = params.nu > 0 or params.eta > 0
    if not params.mhd:
        return {"hydro": 2 * S + work, "hydro_ghosted": U + 5 * n * b + work}
    from ..kernels.mhd_step import uses_shear
    from ..solvers.stratified import uses_stratified_z

    if uses_shear(params):
        strat = uses_stratified_z(params)
        stage = (SHEAR_SCRATCH_PER_CELL * (params.nx + 4) * params.ny
                 * (params.nz + (4 if strat else 0)) * b)
        kept = params.nz * params.ny * b * (2 if params.compensated else 1)
        return {"shear_staged": S + kept + stage + (S if dissip else 0) + work,
                "shear_zcarry": 2 * S + kept + work}
    cube = 8 * (params.nx + 1) * (params.ny + 1) * (params.nz + 1) * b
    return {"staged": S + SCRATCH_PER_CELL * n * b + (S if dissip else 0) + work,
            "zcarry": 2 * S + work,
            "ghosted": U + SCRATCH_PER_CELL * ghosted_cells * b + (cube if dissip else 0) + work}


def run_path(params: RunParams, config=None) -> str:
    """The key of path_bytes that this configuration's loop runs."""
    from ..config.configmap import ConfigMap
    from ..problems import has_gravity_field

    if params.dim == 2:
        return "whole_array_2d"
    if not params.mhd:
        from ..kernels.fused_hydro3d import uses_ghosted_hydro

        return "hydro_ghosted" if uses_ghosted_hydro(params) else "hydro"
    from ..kernels.mhd_step import uses_ghosted, uses_shear

    zc = "zcarry" if params.kernel == "zcarry" else "staged"
    if uses_shear(params):
        return f"shear_{zc}"
    gravity = has_gravity_field(params, config if config is not None else ConfigMap(text=""))
    return "ghosted" if uses_ghosted(params) or gravity else zc


def estimate(params: RunParams, config=None) -> dict[str, float]:
    """GiB of one ghosted state, of each loop path, of the configuration's
    own (``loop_GiB``) and of a Run of it (``run_GiB``), and the card's
    (``h100_GiB``)."""
    gib = 1024 ** 3
    paths = path_bytes(params)
    loop = paths[run_path(params, config)]
    return {"state_GiB": state_bytes(params) / gib,
            **{f"{k}_GiB": v / gib for k, v in paths.items()},
            "loop_GiB": loop / gib,
            "run_GiB": (state_bytes(params) + loop) / gib,
            "h100_GiB": H100_GIB}


def estimate_sharded(params: RunParams, topo: tuple[int, int, int],
                     config=None) -> dict[str, float]:
    """One rank's footprint under an (mx, my, mz) decomposition."""
    mx, my, mz = topo
    local = params.replace(nx=params.nx // mx, ny=params.ny // my,
                           nz=params.nz // mz if params.dim == 3 else params.nz)
    return {f"per_shard_{k}": v for k, v in estimate(local, config).items()}


def main(argv=None) -> int:
    import argparse

    from ..config.configmap import ConfigMap
    from ..config.params import params_from_config

    parser = argparse.ArgumentParser(description="device memory planner (one H100)")
    parser.add_argument("--param", help="INI file", default=None)
    parser.add_argument("--nx", type=int, default=256)
    parser.add_argument("--ny", type=int, default=256)
    parser.add_argument("--nz", type=int, default=256)
    parser.add_argument("--mhd", action="store_true")
    args = parser.parse_args(argv)

    if args.param:
        config = ConfigMap(args.param)
    else:
        config = ConfigMap(text=f"""
[mesh]
nx={args.nx}
ny={args.ny}
nz={args.nz}
[MHD]
enable={'true' if args.mhd else 'false'}
""")
    params = params_from_config(config)
    for key, value in estimate(params, config).items():
        print(f"{key:32s}: {value:8.3f}")
    if args.param:
        from ..parallel.mesh import topology_from_config

        topo = topology_from_config(config)
        if topo != (1, 1, 1):
            print(f"[mpi] topology {topo[0]}x{topo[1]}x{topo[2]}:")
            for key, value in estimate_sharded(params, topo, config).items():
                print(f"{key:32s}: {value:8.3f}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
