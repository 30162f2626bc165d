"""Command-line entry point of the port (counterpart of
ramsesgpu_tpu/cli/main.py; reference euler_main.cpp:76-195): read the INI,
build the Run on ``--device`` and integrate.

    ramses-tpu-torch --param implode3d.ini [--device cuda] [--max-steps N]
"""
from __future__ import annotations

import argparse
import sys

from ..config.configmap import ConfigMap
from ..config.params import params_from_config


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="ramses-tpu-torch",
        description="PyTorch + CUDA port of ramsesgpu_tpu (3D hydro with walls or "
                    "periodic faces, periodic 3D MHD+CT, the ideal MRI shearing box).",
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
