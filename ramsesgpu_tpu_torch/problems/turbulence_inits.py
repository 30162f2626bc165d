"""Turbulence problem initial conditions (3D only, like the reference).

The port's own copy of ramsesgpu_tpu/problems/turbulence_inits.py (numpy;
the static field from the port's ops/forcing.py): the port imports
nothing of the JAX package.

reference: src/hydro/HydroRunBase.cpp init_hydro_turbulence /
init_hydro_turbulence_Ornstein_Uhlenbeck (:6930-7010) and
MHDRunBase.cpp:3045-3160 MHD twins (uniform B added along x).
"""
from __future__ import annotations

import numpy as np

from ..config.configmap import ConfigMap
from ..config.params import RunParams
from ..core.constants import IA, ID, IP, IU, IV, IW
from . import register_hydro, register_mhd
from ..ops.forcing import turbulence_init_field


def _np_dtype(params: RunParams):
    return np.float64 if params.dtype == "float64" else np.float32


def _base_state(params: RunParams, section: str, config: ConfigMap):
    if params.dim != 3:
        raise ValueError("turbulence problems are 3D only (as in the reference)")
    d0 = config.get_float(section, "density", 1.0)
    amp = config.get_float(section, "initialDensityPerturbationAmplitude", 0.0)
    p0 = config.get_float(section, "pressure", 1.0)
    seed = config.get_integer(section, "random_seed", 33)
    rng = np.random.RandomState(seed)

    U = np.zeros(params.shape, dtype=_np_dtype(params))
    rho = d0 * (1.0 + amp * (rng.rand(*params.shape[1:]) - 0.5))
    U[ID] = rho
    U[IP] = p0 / (params.gamma0 - 1.0)
    return U, p0


def init_hydro_turbulence(params: RunParams, config: ConfigMap) -> np.ndarray:
    """Initial velocity = the static forcing field itself
    (HydroRunBase.cpp:6930-6990)."""
    U, p0 = _base_state(params, "turbulence", config)
    mach = config.get_float("turbulence", "machNumber", 0.0)
    F = turbulence_init_field(params, mach)
    U[IU] = U[ID] * F[0]
    U[IV] = U[ID] * F[1]
    U[IW] = U[ID] * F[2]
    U[IP] = p0 / (params.gamma0 - 1.0) + 0.5 * (
        U[IU] ** 2 + U[IV] ** 2 + U[IW] ** 2
    ) / U[ID]
    return U


def init_hydro_turbulence_ou(params: RunParams, config: ConfigMap) -> np.ndarray:
    """Fluid starts at rest; the OU forcing spins it up
    (HydroRunBase.cpp init_hydro_turbulence_Ornstein_Uhlenbeck)."""
    U, _ = _base_state(params, "turbulence-Ornstein-Uhlenbeck", config)
    return U


def init_mhd_turbulence(params: RunParams, config: ConfigMap) -> np.ndarray:
    """MHD turbulence: hydro turbulence + uniform Bx
    (MHDRunBase.cpp:3045-3105)."""
    U, p0 = _base_state(params, "turbulence", config)
    mach = config.get_float("turbulence", "machNumber", 0.0)
    F = turbulence_init_field(params, mach)
    U[IU] = U[ID] * F[0]
    U[IV] = U[ID] * F[1]
    U[IW] = U[ID] * F[2]
    b0 = config.get_float("turbulence", "initialBx", 0.0)
    U[IA] = b0
    U[IP] = (
        p0 / (params.gamma0 - 1.0)
        + 0.5 * (U[IU] ** 2 + U[IV] ** 2 + U[IW] ** 2) / U[ID]
        + 0.5 * b0 * b0
    )
    return U


def init_mhd_turbulence_ou(params: RunParams, config: ConfigMap) -> np.ndarray:
    """MHD OU turbulence: at rest + uniform Bx (MHDRunBase.cpp:3107-3160)."""
    U, p0 = _base_state(params, "turbulence-Ornstein-Uhlenbeck", config)
    b0 = config.get_float("turbulence-Ornstein-Uhlenbeck", "initialBx", 0.0)
    U[IA] = b0
    U[IP] = p0 / (params.gamma0 - 1.0) + 0.5 * b0 * b0
    return U


register_hydro("turbulence", init_hydro_turbulence)
register_hydro("turbulence-Ornstein-Uhlenbeck", init_hydro_turbulence_ou)
register_mhd("turbulence", init_mhd_turbulence)
register_mhd("turbulence-Ornstein-Uhlenbeck", init_mhd_turbulence_ou)
