"""Problem registry: maps the reference's problem names to initializers
(the port's copy of ramsesgpu_tpu/problems/__init__.py; reference
HydroRunBase.cpp:7109-7133, MHDRunBase.cpp:1378-3245).

The port registers the initial conditions it can run: the hydro problems
below (Rayleigh-Taylor, falling-bubble and Keplerian-disk with their static
gravity), the 2D Riemann problems of ``riemann2d``, the MHD
problems of ``mhd_inits`` and the four turbulence problems of
``turbulence_inits`` (hydro and MHD; registered when those modules are
imported, as the JAX package's problems/__init__.py:60-69 does;
``solvers/step.py make_gravity_field`` gives the static gravity of those
that carry one). Any other name raises
NotImplementedError. ``has_gravity_field`` is the JAX package's
gate (problems/__init__.py:48-76): Keplerian-disk always has a field, MRI
only with a [gravity] section (stratified MRI); ``gravity_field`` builds
both.
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
    "Rayleigh-Taylor": hydro_inits.init_hydro_rayleigh_taylor,
    "Gresho-vortex": hydro_inits.init_hydro_gresho_vortex,
    "falling-bubble": hydro_inits.init_hydro_falling_bubble,
    "Keplerian-disk": hydro_inits.init_hydro_keplerian_disk,
    "jet": hydro_inits.init_hydro_jet,
}

_MHD_REGISTRY: dict[str, InitFn] = {}


def register_hydro(name: str, fn: InitFn) -> None:
    _HYDRO_REGISTRY[name] = fn


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


def gravity_field(params: RunParams, config: ConfigMap):
    """The problem's static gravity field [dim, *ghosted shape] (the
    reference's h_gravity; JAX problems/__init__.py:48-55), or None: the
    Keplerian disk's (hydro_inits.keplerian_gravity_field) and the
    stratified MRI's (mhd_inits.mri_gravity_field)."""
    if params.problem == "Keplerian-disk":
        return hydro_inits.keplerian_gravity_field(params, config)
    if params.problem in ("MRI", "Mri", "mri"):
        from .mhd_inits import mri_gravity_field

        return mri_gravity_field(params, config)
    return None


def init_problem(params: RunParams, config: ConfigMap) -> np.ndarray:
    """The initial conserved state (numpy, ghosted) of ``params.problem``."""
    from . import riemann2d, turbulence_inits  # noqa: F401  (register on import)

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
