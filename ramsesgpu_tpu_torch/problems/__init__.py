"""Problem registry: maps the reference's problem names to initializers
(the port's copy of ramsesgpu_tpu/problems/__init__.py; reference
HydroRunBase.cpp:7109-7133, MHDRunBase.cpp:1378-3245).

The port registers the initial conditions it can run: the gravity-free
hydro problems below, and the MHD problems of ``mhd_inits`` (registered
when that module is imported; ``solvers/step.py require_slice`` refuses
those that need rotation, gravity, walls or 2D). Any other name raises
NotImplementedError.
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
