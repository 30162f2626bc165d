"""Live 2D run viewer and snapshot animator (the port's counterpart of
ramsesgpu_tpu/gui/live_view.py; reference src/glutGui/HydroWindow.h and
src/qtGui/qtHydro2d): matplotlib either (a) drives a 2D run of the port
on its device and renders one variable every ``--interval`` steps (a
window when a display exists, PNG frames otherwise), or (b) animates
saved HDF5 snapshots into a gif / mp4. matplotlib is imported when used
and named when missing.

Usage:
  ramses-tpu-torch-view --param jet2d_gpu.ini --var density --steps 2000 [--device cpu]
  ramses-tpu-torch-view --animate 'run_*.h5' --param run.ini --out movie.gif
"""
from __future__ import annotations

import argparse
import glob
import importlib.util
import os
import sys

import torch

from ..config.configmap import ConfigMap
from ..config.params import params_from_config
from ..core.constants import var_names


def _matplotlib(interactive: bool):
    if importlib.util.find_spec("matplotlib") is None:
        raise ImportError("the live view renders with matplotlib, which is not installed")
    import matplotlib

    if not interactive:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def live_run(args) -> int:
    from ..convert import torch_dtype
    from ..problems import init_problem
    from ..solvers.boundary import make_boundaries
    from ..solvers.step import make_advance_n

    config = ConfigMap(args.param)
    params = params_from_config(config)
    if params.dim != 2:
        raise SystemExit("live view renders 2D runs (like the reference GUIs)")
    ivar = list(var_names(params.nb_var)).index(args.var)
    g = params.ghost_width
    device = torch.device(args.device)

    U = make_boundaries(params, torch.from_numpy(init_problem(params, config)).to(
        device, torch_dtype(params)))
    advance = make_advance_n(params, device, config)
    t = torch.zeros((), dtype=U.dtype, device=device)

    interactive = bool(os.environ.get("DISPLAY")) and not args.frames
    plt = _matplotlib(interactive)
    fig, ax = plt.subplots(figsize=(6, 6))
    img = ax.imshow(U[ivar, g:-g, g:-g].cpu().numpy(), origin="lower", cmap=args.cmap)
    fig.colorbar(img, ax=ax)
    if interactive:
        plt.ion()
        plt.show()

    n_step = 0
    frame = 0
    while n_step < args.steps and (params.t_end <= 0 or float(t) < params.t_end):
        U, t, k = advance(U, t, args.interval)
        n_step += int(k)
        data = U[ivar, g:-g, g:-g].cpu().numpy()
        img.set_data(data)
        img.set_clim(data.min(), data.max())
        ax.set_title(f"{args.var}  step {n_step}  t={float(t):.4f}")
        if interactive:
            fig.canvas.draw_idle()
            plt.pause(0.001)
        else:
            fig.savefig(f"frame_{frame:05d}.png", dpi=110)
        frame += 1
        if int(k) == 0:
            break
    plt.close(fig)
    if not interactive:
        print(f"wrote {frame} frames (frame_*.png)")
    return 0


def animate_snapshots(args) -> int:
    from ..io.hdf5 import input_hdf5

    params = params_from_config(ConfigMap(args.param))
    ivar = list(var_names(params.nb_var)).index(args.var)
    g = params.ghost_width

    files = sorted(glob.glob(args.animate))
    if not files:
        raise SystemExit(f"no files match {args.animate!r}")
    plt = _matplotlib(False)
    from matplotlib.animation import FuncAnimation

    frames = []
    for f in files:
        U, t, _step = input_hdf5(params, f)
        a = U[ivar]
        if params.dim == 3:
            a = a[a.shape[0] // 2]
        frames.append((a[g:-g, g:-g] if a.shape[0] > params.ny else a, t))

    fig, ax = plt.subplots(figsize=(6, 6))
    img = ax.imshow(frames[0][0], origin="lower", cmap=args.cmap)
    fig.colorbar(img, ax=ax)

    def update(i):
        data, t = frames[i]
        img.set_data(data)
        img.set_clim(data.min(), data.max())
        ax.set_title(f"{args.var}  t={t:.4f}")
        return [img]

    anim = FuncAnimation(fig, update, frames=len(frames), interval=100)
    anim.save(args.out, writer="pillow" if args.out.endswith(".gif") else None)
    plt.close(fig)
    print(f"wrote {args.out} ({len(frames)} frames)")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="live 2D run viewer / animator")
    parser.add_argument("--param", required=True)
    parser.add_argument("--var", default="density")
    parser.add_argument("--cmap", default="viridis")
    parser.add_argument("--steps", type=int, default=10000)
    parser.add_argument("--interval", type=int, default=20, help="steps between frames")
    parser.add_argument("--frames", action="store_true",
                        help="force PNG frame output (no window)")
    parser.add_argument("--animate", default=None,
                        help="glob of .h5 snapshots to animate instead of running")
    parser.add_argument("--out", default="movie.gif")
    parser.add_argument("--device", default="cuda" if torch.cuda.is_available() else "cpu")
    args = parser.parse_args(argv)
    if args.animate:
        return animate_snapshots(args)
    return live_run(args)


if __name__ == "__main__":
    sys.exit(main())
