"""Hydrodynamics problem initial conditions.

Re-implementations of the reference's initializers
(reference: src/hydro/HydroRunBase.cpp:5358-6910, initHydro.cpp), built on
numpy (runs once on host; state then moves to device). Each initializer has
signature ``init(params, config) -> np.ndarray`` returning the conserved
state U of shape ``params.shape`` (ghosts included, zero-filled — the first
boundary fill overwrites them).

The port's own copy of ramsesgpu_tpu/problems/hydro_inits.py: the port imports nothing of
the JAX package.
"""
from __future__ import annotations

import numpy as np

from ..config.configmap import ConfigMap
from ..config.params import RunParams
from ..core.constants import ID, IP, IU, IV, IW
from .grid import coords, index_grids


def _np_dtype(params: RunParams):
    return np.float64 if params.dtype == "float64" else np.float32


def _empty_state(params: RunParams) -> np.ndarray:
    return np.zeros(params.shape, dtype=_np_dtype(params))


def _set_prim(params: RunParams, U: np.ndarray, mask, rho, p, u=0.0, v=0.0, w=0.0):
    """Assign conservative state from primitive scalars/arrays under a mask.
    The reference stores E = p/(gamma-1) + kinetic directly."""
    gamma = params.gamma0
    rho_b, p_b = np.broadcast_to(rho, mask.shape), np.broadcast_to(p, mask.shape)
    u_b = np.broadcast_to(u, mask.shape)
    v_b = np.broadcast_to(v, mask.shape)
    eken = 0.5 * rho_b * (u_b * u_b + v_b * v_b)
    if params.dim == 3:
        w_b = np.broadcast_to(w, mask.shape)
        eken = eken + 0.5 * rho_b * w_b * w_b
    U[ID][mask] = rho_b[mask]
    U[IP][mask] = (p_b / (gamma - 1.0) + eken)[mask]
    U[IU][mask] = (rho_b * u_b)[mask]
    U[IV][mask] = (rho_b * v_b)[mask]
    if params.dim == 3:
        U[IW][mask] = (rho_b * w_b)[mask]
    return U


def init_hydro_sod(params: RunParams, config: ConfigMap) -> np.ndarray:
    """Sod shock tube, discontinuity at the x midplane
    (HydroRunBase.cpp:5358-5438: left (1, 1/(g-1)), right (0.125, 0.1/(g-1)))."""
    U = _empty_state(params)
    grids = index_grids(params)
    I = grids[0]
    left = I < params.isize // 2
    U = _set_prim(params, U, left, 1.0, 1.0)
    U = _set_prim(params, U, ~left, 0.125, 0.1)
    return U


def init_hydro_implode(params: RunParams, config: ConfigMap) -> np.ndarray:
    """Liska-Wendroff implosion (HydroRunBase.cpp:5449-5536): diagonal
    discontinuity; optional uniform density perturbation."""
    rng = np.random.RandomState(config.get_integer("implode", "seed", 1))
    amplitude = config.get_float("implode", "amplitude", 0.0)

    U = _empty_state(params)
    grids = index_grids(params)
    if params.dim == 2:
        I, J = grids
        diag = I.astype(np.float64) / params.nx + J.astype(np.float64) / params.ny
    else:
        I, J, K = grids
        diag = (
            I.astype(np.float64) / params.nx
            + J.astype(np.float64) / params.ny
            + K.astype(np.float64) / params.nz
        )
    outer = diag > 0.5
    noise = amplitude * (rng.rand(*outer.shape) - 0.5)
    U = _set_prim(params, U, outer, 1.0 + noise, 1.0)
    U = _set_prim(params, U, ~outer, 0.125 + noise, 0.14)
    return U


def init_hydro_blast(params: RunParams, config: ConfigMap) -> np.ndarray:
    """Spherical blast wave (HydroRunBase.cpp:5551-5676)."""
    radius = config.get_float("blast", "radius", 0.25 * (params.xmax - params.xmin))
    cx = config.get_float("blast", "center_x", (params.xmax + params.xmin) / 2)
    cy = config.get_float("blast", "center_y", (params.ymax + params.ymin) / 2)
    cz = config.get_float("blast", "center_z", (params.zmax + params.zmin) / 2)
    density_in = config.get_float("blast", "density_in", 1.0)
    density_out = config.get_float("blast", "density_out", 1.0)
    pressure_in = config.get_float("blast", "pressure_in", 10.0)
    pressure_out = config.get_float("blast", "pressure_out", 0.1)

    U = _empty_state(params)
    cs = coords(params)
    d2 = (cs[0] - cx) ** 2 + (cs[1] - cy) ** 2
    if params.dim == 3:
        d2 = d2 + (cs[2] - cz) ** 2
    inside = d2 < radius * radius
    U = _set_prim(params, U, inside, density_in, pressure_in)
    U = _set_prim(params, U, ~inside, density_out, pressure_out)
    return U


def init_hydro_kelvin_helmholtz(params: RunParams, config: ConfigMap) -> np.ndarray:
    """Kelvin-Helmholtz shear instability (HydroRunBase.cpp:5857-6252).

    Two perturbation flavors, as in the reference:
      [kelvin-helmholtz] perturbation=rand : white-noise transverse velocity
      perturbation=sine : single-mode sine with smoothed density interface
    """
    rng = np.random.RandomState(config.get_integer("kelvin-helmholtz", "seed", 12))
    d_in = config.get_float("kelvin-helmholtz", "d_in", 1.0)
    d_out = config.get_float("kelvin-helmholtz", "d_out", 2.0)
    pressure = config.get_float("kelvin-helmholtz", "pressure", 2.5)
    amplitude = config.get_float("kelvin-helmholtz", "amplitude", 0.01)
    vflow_in = config.get_float("kelvin-helmholtz", "vflow_in", -0.5)
    vflow_out = config.get_float("kelvin-helmholtz", "vflow_out", 0.5)
    use_sine = config.get_bool("kelvin-helmholtz", "perturbation_sine", False) or (
        config.get_string("kelvin-helmholtz", "perturbation", "rand") == "sine"
    )

    U = _empty_state(params)
    cs = coords(params)
    x, y = cs[0], cs[1]
    ly = params.ymax - params.ymin
    yn = (y - params.ymin) / ly  # normalized transverse coordinate in [0,1)
    if params.dim == 3:
        # shear layers normal to z in 3D
        z = cs[2]
        lz = params.zmax - params.zmin
        yn = (z - params.zmin) / lz

    inner = (yn >= 0.25) & (yn < 0.75)

    if use_sine:
        n_mode = config.get_float("kelvin-helmholtz", "mode", 2.0)
        w0 = config.get_float("kelvin-helmholtz", "w0", 0.1)
        delta = config.get_float("kelvin-helmholtz", "delta", 0.03)
        lx = params.xmax - params.xmin
        rho = np.where(inner, d_in, d_out)
        # smooth the interfaces with tanh ramps of width delta
        ramp = 0.5 * (
            np.tanh((yn - 0.25) / delta) - np.tanh((yn - 0.75) / delta)
        )
        rho = d_out + (d_in - d_out) * ramp
        vx = vflow_out + (vflow_in - vflow_out) * ramp
        vy = w0 * np.sin(n_mode * 2.0 * np.pi * x / lx)
        U = _set_prim(params, U, np.ones_like(inner), rho, pressure, vx, vy)
    else:
        noise_u = amplitude * (rng.rand(*inner.shape) - 0.5)
        noise_v = amplitude * (rng.rand(*inner.shape) - 0.5)
        rho = np.where(inner, d_in, d_out)
        vx = np.where(inner, vflow_in, vflow_out) * (1.0 + noise_u)
        vy = noise_v
        U = _set_prim(params, U, np.ones_like(inner), rho, pressure, vx, vy)
    return U


def init_hydro_rayleigh_taylor(params: RunParams, config: ConfigMap) -> np.ndarray:
    """Rayleigh-Taylor instability (HydroRunBase.cpp:6262-6520): heavy fluid
    above light, hydrostatic pressure, single-mode velocity perturbation."""
    d0 = config.get_float("rayleigh-taylor", "d0", 1.0)
    d1 = config.get_float("rayleigh-taylor", "d1", 2.0)
    ampl = config.get_float("rayleigh-taylor", "amplitude", 0.01)
    p0 = config.get_float("rayleigh-taylor", "pressure0", 2.5)
    gx = config.get_float("gravity", "static_field_x", 0.0)
    gy = config.get_float("gravity", "static_field_y", 0.0)
    gz = config.get_float("gravity", "static_field_z", 0.0)

    U = _empty_state(params)
    cs = coords(params)
    x, y = cs[0], cs[1]
    lx = params.xmax - params.xmin
    ly = params.ymax - params.ymin

    if params.dim == 2:
        heavy = y > (params.ymin + params.ymax) / 2
        rho = np.where(heavy, d1, d0)
        p = p0 + rho * gy * (y - (params.ymin + params.ymax) / 2)
        # single-mode perturbation on vy, tapered by a cosine envelope
        vy = (
            ampl
            * (1.0 + np.cos(2 * np.pi * (x - (params.xmin + params.xmax) / 2) / lx))
            * (1.0 + np.cos(2 * np.pi * (y - (params.ymin + params.ymax) / 2) / ly))
            / 4.0
        )
        U = _set_prim(params, U, np.ones_like(heavy), rho, p, 0.0, vy)
    else:
        z = cs[2]
        lz = params.zmax - params.zmin
        heavy = z > (params.zmin + params.zmax) / 2
        rho = np.where(heavy, d1, d0)
        p = p0 + rho * gz * (z - (params.zmin + params.zmax) / 2)
        vz = (
            ampl
            * (1.0 + np.cos(2 * np.pi * (x - (params.xmin + params.xmax) / 2) / lx))
            * (1.0 + np.cos(2 * np.pi * (y - (params.ymin + params.ymax) / 2) / ly))
            * (1.0 + np.cos(2 * np.pi * (z - (params.zmin + params.zmax) / 2) / lz))
            / 8.0
        )
        U = _set_prim(params, U, np.ones_like(heavy), rho, p, 0.0, 0.0, vz)
    return U


def init_hydro_jet(params: RunParams, config: ConfigMap) -> np.ndarray:
    """Uniform ambient medium for the jet problem (HydroRunBase.cpp:5287-5350);
    the inflowing jet itself is applied each step as a boundary override
    (solvers/jet.py)."""
    U = _empty_state(params)
    # ambient medium (reference uses rho=1, zero velocity, p = 1/gamma
    # scaled so the ambient sound speed is 1)
    mask = np.ones(params.shape[1:], dtype=bool)
    p_amb = config.get_float("jet", "pamb", 1.0 / params.gamma0)
    d_amb = config.get_float("jet", "damb", 1.0)
    U = _set_prim(params, U, mask, d_amb, p_amb)
    return U


def init_hydro_gresho_vortex(params: RunParams, config: ConfigMap) -> np.ndarray:
    """Gresho vortex (HydroRunBase.cpp:5678-5820; arXiv:1409.7395 §4.2.3)."""
    rho0 = config.get_float("gresho", "rho0", 1.0)
    mach = config.get_float("gresho", "Mach", 0.1)

    U = _empty_state(params)
    cs = coords(params)
    x = cs[0] - (params.xmin + params.xmax) / 2
    y = cs[1] - (params.ymin + params.ymax) / 2
    r = np.sqrt(x * x + y * y)
    p0 = rho0 / (params.gamma0 * mach * mach)

    vphi = np.where(r < 0.2, 5.0 * r, np.where(r < 0.4, 2.0 - 5.0 * r, 0.0))
    p = np.where(
        r < 0.2,
        p0 + 12.5 * r * r,
        np.where(
            r < 0.4,
            p0 + 12.5 * r * r + 4.0 * (1.0 - 5.0 * r - np.log(0.2) + np.log(np.maximum(r, 1e-30))),
            p0 - 2.0 + 4.0 * np.log(2.0),
        ),
    )
    with np.errstate(invalid="ignore", divide="ignore"):
        cosphi = np.where(r > 0, x / np.maximum(r, 1e-30), 0.0)
        sinphi = np.where(r > 0, y / np.maximum(r, 1e-30), 0.0)
    u = -vphi * sinphi
    v = vphi * cosphi
    mask = np.ones(r.shape, dtype=bool)
    return _set_prim(params, U, mask, rho0, p, u, v)


def init_hydro_keplerian_disk(params: RunParams, config: ConfigMap) -> np.ndarray:
    """Keplerian disk around a softened point mass
    (HydroRunBase.cpp init_hydro_Keplerian_disk): azimuthal velocity
    v = r (r^2+eps^2)^(-3/4), piecewise density profile, cold pressure."""
    eps = config.get_float("Keplerian-disk", "epsilon", 0.01)
    p0 = config.get_float("Keplerian-disk", "pressure", 1e-6)
    xc = config.get_float("Keplerian-disk", "xCenter", (params.xmax + params.xmin) / 2)
    yc = config.get_float("Keplerian-disk", "yCenter", (params.ymax + params.ymin) / 2)

    U = _empty_state(params)
    cs = coords(params)
    x = cs[0] - xc
    y = cs[1] - yc
    r = np.sqrt(x * x + y * y)
    theta = np.arctan2(y, x)
    velocity = r * (r * r + eps * eps) ** (-0.75)

    rho = np.where(
        r < 0.5,
        0.01 + (r / 0.5) ** 3,
        np.where(r <= 2, 1.01, 0.01 + (1 + (r - 2) / 0.1) ** (-3.0)),
    )
    u = -np.sin(theta) * velocity
    v = np.cos(theta) * velocity
    mask = np.ones(r.shape, dtype=bool)
    return _set_prim(params, U, mask, rho, p0, u, v)


def init_hydro_falling_bubble(params: RunParams, config: ConfigMap) -> np.ndarray:
    """Light bubble falling under gravity (HydroRunBase.cpp:6640-6830)."""
    d0 = config.get_float("falling-bubble", "d0", 1.0)      # light (bubble)
    d1 = config.get_float("falling-bubble", "d1", 2.0)      # ambient
    radius = config.get_float("falling-bubble", "radius", 0.1)
    cx = config.get_float("falling-bubble", "center_x", (params.xmin + params.xmax) / 2)
    cy = config.get_float("falling-bubble", "center_y", 0.8 * (params.ymax - params.ymin))
    p0 = config.get_float("falling-bubble", "pressure0", 2.5)
    v0 = config.get_float("falling-bubble", "initialSpeed", 0.0)
    gy = config.get_float("gravity", "static_field_y", 0.0)

    U = _empty_state(params)
    cs = coords(params)
    x, y = cs[0], cs[1]
    rho = np.full(x.shape, d1)
    p = p0 + d1 * gy * (y - params.ymin)
    d2 = (x - cx) ** 2 + (y - cy) ** 2
    bubble = d2 < radius * radius
    rho[bubble] = d0
    vy = np.where(bubble, v0, 0.0)
    mask = np.ones(rho.shape, dtype=bool)
    return _set_prim(params, U, mask, rho, p, 0.0, vy)
