"""The numerics guard and the debug dump (the port's counterpart of
ramsesgpu_tpu/utils/guard.py:21-75; reference SIGFPE trapping,
src/euler_main.cpp:59-80, and the h_debug / outputHdf5Debug dumps,
HydroRunBase.h:443-470).

``check_finite`` runs where the state lies: one reduction over the
interior for "every value finite and the density > 0" and one read of
the flag on the host. Only when it fails does it look for the first bad
value, in C order (variable, then cell), as the JAX package's
``np.argwhere`` does, and raise NumericsError with the JAX package's
text. The run drivers call it once per chunk (``[run] fpe_check`` or
``[debug] dumpData``), never once per step.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config.params import RunParams


class NumericsError(RuntimeError):
    pass


def interior_ok(Ui: torch.Tensor) -> torch.Tensor:
    """The 0-d bool "every value of the interior state Ui finite and its
    density > 0" (one reduction, on Ui's device)."""
    good = torch.isfinite(Ui)
    good[0] &= Ui[0] > 0
    return good.all()


def first_bad(Ui: torch.Tensor) -> tuple[str, tuple]:
    """("nonfinite", (var, *cell)) or ("density", cell) of the first bad
    value of the interior state Ui in C order, as np.argwhere finds it."""
    bad = ~torch.isfinite(Ui)
    if bool(bad.any()):
        flat = int(torch.argmax(bad.reshape(-1).to(torch.uint8)))
        return "nonfinite", tuple(np.unravel_index(flat, tuple(Ui.shape)))
    flat = int(torch.argmax((Ui[0] <= 0).reshape(-1).to(torch.uint8)))
    return "density", tuple(np.unravel_index(flat, tuple(Ui.shape[1:])))


def failure_message(kind: str, idx: tuple, n_step: int, where: str = "") -> str:
    """The JAX package's NumericsError text for first_bad's result."""
    idx = np.asarray(idx, dtype=np.int64)
    if kind == "nonfinite":
        return (f"non-finite value at step {n_step} {where}: "
                f"var={idx[0]} cell={tuple(idx[1:])}")
    return f"non-positive density at step {n_step} {where}: cell={tuple(idx)}"


def check_finite(params: RunParams, U: torch.Tensor, n_step: int, where: str = "") -> None:
    """Raise NumericsError if the interior of the ghosted state U (a tensor
    on any device, or numpy) holds a NaN or an Inf, or a density <= 0."""
    g = params.ghost_width
    Ui = torch.as_tensor(U)[(slice(None),) + (slice(g, -g),) * params.dim]
    if bool(interior_ok(Ui)):
        return
    raise NumericsError(failure_message(*first_bad(Ui), n_step, where))


def dump_debug_state(params: RunParams, config, U, dt, n_step: int,
                     output_dir: str = ".") -> list[str]:
    """Write the ghosted state U as ``debug_state_<step>.h5`` (dataset U,
    attributes dt and step) and its primitive variables as
    ``debug_prim_<step>.h5`` (datasets Q and c, from ops/eos.py), the
    successor of outputHdf5Debug; returns the paths. Needs h5py."""
    import h5py

    from ..ops.eos import constoprim_hydro, constoprim_mhd

    U = torch.as_tensor(U).cpu()
    paths = [f"{output_dir}/debug_state_{n_step:07d}.h5"]
    with h5py.File(paths[0], "w") as f:
        f.create_dataset("U", data=U.numpy())
        f.attrs["dt"] = float(dt)
        f.attrs["step"] = n_step
    if params.mhd:
        Q, c = constoprim_mhd(params, U, torch.tensor(float(dt), dtype=U.dtype))
    else:
        Q, c = constoprim_hydro(params, U)
    paths.append(f"{output_dir}/debug_prim_{n_step:07d}.h5")
    with h5py.File(paths[1], "w") as f:
        f.create_dataset("Q", data=Q.numpy())
        f.create_dataset("c", data=c.numpy())
    return paths
