"""Command-line entry point of the port (counterpart of
ramsesgpu_tpu/cli/main.py; reference euler_main.cpp:76-195): read the INI,
build the Run on ``--device`` and integrate.

    ramses-tpu-torch --param implode3d.ini [--device cuda] [--max-steps N]

An INI with an ``[mpi]`` topology (mx * my * mz > 1) runs distributed
(solvers/run_distributed.py, the reference's euler_mpi_main): when
``WORLD_SIZE`` is unset the command starts the mx * my * mz rank processes
itself (parallel/launch.py; the kernels are built first, in this
process) and waits for them; under ``torchrun`` (``WORLD_SIZE`` set) the
process joins that world as one rank.

The JAX CLI's other switches: ``--scheme`` (godunov, godunov-split,
kurganov, laxliu, relaxingTVD; ``[hydro] unsplit=no`` selects
godunov-split) runs an alternative scheme through solvers/run2d_alt.py
AltSchemeRun, on one device only; ``--dump-param-file`` prints the
effective parameter file; ``--profile`` prints the per-phase step profile
(utils/profile.py; of an ``[mpi]`` input on its ranks) and exits. The JAX
CLI's platform and multi-host bootstraps (its utils/platform.py and
parallel/multihost.py) have no counterpart: ``--device`` selects the
device.
"""
from __future__ import annotations

import argparse
import math
import os
import sys

from ..config.configmap import ConfigMap
from ..config.params import params_from_config


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="ramses-tpu-torch",
        description="PyTorch + CUDA port of ramsesgpu_tpu (2D and 3D hydro and ideal "
                    "MHD+CT with walls or periodic faces, the inflow jet, static gravity, "
                    "viscous-resistive 3D MHD, viscous 3D hydro, the MRI shearing box, "
                    "driven turbulence; [mpi] inputs, forced and dissipative ones included, "
                    "over one process per rank; checkpoint / restart, the numerics guard; "
                    "the split Godunov, Kurganov-Tadmor, Lax-Liu and relaxing-TVD schemes).",
    )
    parser.add_argument("--param", "-i", required=True, help="INI parameter file")
    parser.add_argument(
        "--scheme", default=None,
        choices=["godunov", "godunov-split", "kurganov", "laxliu", "relaxingTVD"],
        help="numerical scheme (same switch as the reference's euler_main)",
    )
    parser.add_argument("--dump-param-file", action="store_true",
                        help="print the effective parameter file and exit")
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--no-output", action="store_true")
    parser.add_argument("--profile", action="store_true",
                        help="print a per-phase step profile and exit "
                             "(the reference's DO_TIMING breakdown)")
    parser.add_argument(
        "--device", default="cuda",
        help="torch device to run on (default cuda; cpu runs the plain twins)",
    )
    return parser


def spawn(argv: list[str] | None, topo, params, device: str, config: ConfigMap) -> None:
    """Start the mx * my * mz ranks of this command line (the kernels built
    first, in this process) and wait for them."""
    from ..parallel.launch import spawn_ranks
    from ..parallel.sharded_step import require_sharded_scope
    from ..solvers.run_distributed import cli_rank

    require_sharded_scope(params, device, config)
    if device.startswith("cuda"):
        from ..kernels.build import build

        build("cuda")
    spawn_ranks(cli_rank, math.prod(topo), (list(sys.argv[1:] if argv is None else argv),))


def print_profile(config: ConfigMap, params, device: str, topo) -> None:
    """The --profile report: the single-device phases, or the distributed
    ones of this process's world (rank 0 prints)."""
    from ..utils import profile

    if topo == (1, 1, 1):
        text = profile.format_profile(profile.profile_step(params, config, device))
    else:
        phases = profile.profile_step_distributed(params, config, device)
        if phases is None:
            return  # a rank other than 0
        text = profile.format_profile_distributed(phases, math.prod(topo))
    print(f"problem        : {params.problem}")
    print(f"mesh           : {params.nx} x {params.ny} x {params.nz}")
    print(text)


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    config = ConfigMap(args.param)
    if args.dump_param_file:
        print(config.dump())
        return 0
    params = params_from_config(config)

    from ..parallel.mesh import topology_from_config

    topo = topology_from_config(config)
    if args.profile:
        if topo != (1, 1, 1) and "WORLD_SIZE" not in os.environ:
            spawn(argv, topo, params, args.device, config)
        else:
            print_profile(config, params, args.device, topo)
        return 0

    scheme = args.scheme or "godunov"
    if scheme == "godunov" and not config.get_bool("hydro", "unsplit", True):
        scheme = "godunov-split"  # [hydro] unsplit=no (HydroRunGodunov.cpp:70)
    if scheme != "godunov":
        if topo != (1, 1, 1):
            raise SystemExit("--scheme alternatives run single-device only")
        from ..solvers.run2d_alt import AltSchemeRun

        run = AltSchemeRun(config, args.device, scheme=scheme)
        params = run.params
    elif topo != (1, 1, 1):
        from ..solvers.run_distributed import DistributedRun

        if "WORLD_SIZE" not in os.environ:
            spawn(argv, topo, params, args.device, config)
            return 0
        run = DistributedRun(config, args.device, params)
        if run.grid.rank != 0:
            run.start(max_steps=args.max_steps, do_output=not args.no_output)
            return 0
        print(f"ranks          : {run.grid.describe()}")
    else:
        from ..solvers.run import Run

        run = Run(config, args.device, params)
    print(f"problem        : {params.problem}")
    print(f"mesh           : {params.nx} x {params.ny} x {params.nz} (dim {params.dim})")
    print(f"mhd            : {params.mhd}")
    print(f"riemann solver : {params.riemann_solver.name}")
    print(f"device         : {run.device}")
    run.start(max_steps=args.max_steps, do_output=not args.no_output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
