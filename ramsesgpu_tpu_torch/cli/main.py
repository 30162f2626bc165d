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
                    "over one process per rank; checkpoint / restart, the numerics guard).",
    )
    parser.add_argument("--param", "-i", required=True, help="INI parameter file")
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--no-output", action="store_true")
    parser.add_argument(
        "--device", default="cuda",
        help="torch device to run on (default cuda; cpu runs the plain twins)",
    )
    parser.add_argument(
        "--scheme", default=None,
        help="alternative schemes of the JAX CLI; not ported (godunov only)",
    )
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.scheme not in (None, "godunov"):
        raise NotImplementedError(f"--scheme {args.scheme} is not ported")

    config = ConfigMap(args.param)
    if not config.get_bool("hydro", "unsplit", True):
        raise NotImplementedError("[hydro] unsplit=no is not ported")
    params = params_from_config(config)

    from ..parallel.mesh import topology_from_config

    topo = topology_from_config(config)
    if topo != (1, 1, 1):
        from ..solvers.run_distributed import DistributedRun, cli_rank

        if "WORLD_SIZE" not in os.environ:
            from ..parallel.launch import spawn_ranks
            from ..parallel.sharded_step import require_sharded_scope

            require_sharded_scope(params, args.device, config)
            if args.device.startswith("cuda"):
                from ..kernels.build import build

                build("cuda")
            spawn_ranks(cli_rank, math.prod(topo),
                        (list(sys.argv[1:] if argv is None else argv),))
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
