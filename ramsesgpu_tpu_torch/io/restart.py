"""Checkpoint / restart (the port's counterpart of
ramsesgpu_tpu/io/restart.py:1-120; reference init_simulation's restart
branch, src/hydro/HydroRunBase.cpp:7027-7070): read ``[run]
restart_filename`` (from the output directory, else as given), optionally
upscale it x2 (``restart_upscale``), optionally reset the time and the step
(``restart_reset_totaltime``, ``restart_reset_timestep``), then the
problem's post-restart work.

A checkpoint is a snapshot the run wrote: NetCDF (``.nc``, io/netcdf.py)
or HDF5 (any other suffix, io/hdf5.py). It holds the conserved state, the
time and the step and nothing else, so a Kahan-compensated run resumes with
a zero carry, as the JAX package's packed loop does after its pack. The
JAX package's collective zarr store and multi-host piece sets are not
ported.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..config.configmap import ConfigMap
from ..config.params import RunParams
from .hdf5 import input_hdf5, upscale


def _mri_restart_fixup(params: RunParams, config: ConfigMap, U: np.ndarray) -> np.ndarray:
    """Re-derive the MRI's static gravity field (the reference regenerates
    it after a restart: it lives outside the checkpoint). The port builds
    the field from (params, config) when it builds the step, so nothing is
    patched; deriving it here checks that the restart's mesh and
    ``[gravity]`` settings still give a finite field."""
    from ..solvers.step import make_gravity_field

    field = make_gravity_field(params, config)
    if field is not None and not bool(field.isfinite().all()):
        raise ValueError("post-restart gravity field is non-finite; check [gravity] / "
                         "mesh settings against the restart file")
    return U


# --------------------------------------------------------------------------- #
# Problem-specific post-restart work (restart_run_extra_work, reference
# MHDRunBase.cpp:3215-3228, HydroRunBaseMpi.cpp:10374-10386): a lower-cased
# problem name -> fn(params, config, U) -> U on the loaded ghosted state.
# --------------------------------------------------------------------------- #
RESTART_EXTRA_WORK = {"mri": _mri_restart_fixup}


def load_restart(params: RunParams, config: ConfigMap) -> tuple[np.ndarray, float, int]:
    """(U, total_time, time_step) of the checkpoint ``[run]
    restart_filename`` (in ``[output] outputDir``, else as given): U the
    ghosted state (numpy, the run's dtype; an interior-only file leaves its
    ghosts 0 for the run's first fill), after the upscale, the resets and
    the problem's post-restart work."""
    filename = config.get_string("run", "restart_filename", "")
    path = Path(config.get_string("output", "outputDir", "./")) / filename
    if not path.exists():
        path = Path(filename)
    if not path.exists():
        raise FileNotFoundError(f"restart file not found: {filename}")
    if path.suffix == ".zarr":
        raise NotImplementedError(
            "restart from a zarr store is not ported (ROADMAP Queue 1 item 8: the JAX "
            "writer needs tensorstore)")
    if path.name.endswith(".pieces.json"):
        raise NotImplementedError(
            "restart from a multi-host piece manifest is not ported (ROADMAP Queue 1 "
            "item 7.6)")
    if path.suffix == ".nc":
        from .netcdf import input_netcdf as reader
    else:
        reader = input_hdf5

    if config.get_bool("run", "restart_upscale", False):
        half = params.replace(nx=params.nx // 2, ny=params.ny // 2,
                              nz=params.nz // 2 if params.dim == 3 else 1)
        coarse, total_time, time_step = reader(half, path)
        U = upscale(params, coarse)
    else:
        U, total_time, time_step = reader(params, path)

    if config.get_bool("run", "restart_reset_totaltime", False):
        total_time = 0.0
    if config.get_bool("run", "restart_reset_timestep", False):
        time_step = 0
    extra_work = RESTART_EXTRA_WORK.get(str(params.problem).lower())
    if extra_work is not None:
        U = extra_work(params, config, U)
    return U, total_time, time_step
