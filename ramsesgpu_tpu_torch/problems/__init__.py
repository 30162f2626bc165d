"""Problem registry: maps the reference's problem names to initializers
(the port's copy of ramsesgpu_tpu/problems/__init__.py; reference
HydroRunBase.cpp:7109-7133, MHDRunBase.cpp:1378-3245).

The port registers the initial conditions it can run: the gravity-free
hydro problems below, and the MHD problems of ``mhd_inits`` (registered
when that module is imported; ``solvers/step.py require_slice`` refuses
those that need walls, 2D or a static gravity field). Any other name
raises NotImplementedError. ``has_gravity_field`` is the JAX package's
gate (problems/__init__.py:48-76): Keplerian-disk always has a field, MRI
only with a [gravity] section (stratified MRI).
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from ..config.configmap import ConfigMap
from ..config.params import RunParams
from . import hydro_inits

InitFn = Callable[[RunParams, ConfigMap], np.ndarray]

_HYDRO_REGISTRY: dict[str, InitFn] = {
    "sod": hydro_inits.init_hydro_sod,
    "implode": hydro_inits.init_hydro_implode,
    "blast": hydro_inits.init_hydro_blast,
    "Kelvin-Helmholtz": hydro_inits.init_hydro_kelvin_helmholtz,
}

_MHD_REGISTRY: dict[str, InitFn] = {}


def register_mhd(name: str, fn: InitFn) -> None:
    _MHD_REGISTRY[name] = fn


def has_gravity_field(params: RunParams, config: ConfigMap) -> bool:
    """Whether the problem carries a static gravity field (the reference's
    h_gravity, HydroRunBase.h:80-120), by the JAX package's gravity
    registry (problems/__init__.py:48-76): the Keplerian disk always, MRI
    only when stratified."""
    from .mhd_inits import mri_stratified

    if params.problem == "Keplerian-disk":
        return True
    return params.problem in ("MRI", "Mri", "mri") and mri_stratified(config)


def init_problem(params: RunParams, config: ConfigMap) -> np.ndarray:
    """The initial conserved state (numpy, ghosted) of ``params.problem``."""
    if params.mhd:
        from . import mhd_inits  # noqa: F401  (registers on import)

        registry = _MHD_REGISTRY
    else:
        registry = _HYDRO_REGISTRY
    fn = registry.get(params.problem)
    if fn is None:
        raise NotImplementedError(
            f"problem {params.problem!r} (mhd={params.mhd}) is not ported; "
            f"ported: {sorted(registry)}"
        )
    return fn(params, config)
