"""MHD problem initial conditions.

Re-implementations of the reference's MHD initializers
(reference: src/hydro/MHDRunBase.cpp:1378-3245). The conservative state
stores face-centered B at each cell's *left* faces (IA/IB/IC); total energy
uses the cell-centered field (average of left face and the next cell's left
face), as the reference does.

The port's own copy of ramsesgpu_tpu/problems/mhd_inits.py: the port imports nothing of
the JAX package.
"""
from __future__ import annotations

import numpy as np

from ..config.configmap import ConfigMap
from ..config.params import RunParams
from ..core.constants import IA, IB, IC, ID, IP, IU, IV, IW
from . import register_mhd
from .grid import cell_centers_1d, coords, index_grids


def _np_dtype(params: RunParams):
    return np.float64 if params.dtype == "float64" else np.float32


def _empty(params: RunParams) -> np.ndarray:
    return np.zeros(params.shape, dtype=_np_dtype(params))


def _energy_from_cell_b(params: RunParams, U: np.ndarray, p_gas) -> None:
    """Fill IP with p/(gamma-1) + kinetic + magnetic, using cell-centered B
    from face averages with periodic wrap (MHDRunBase.cpp:1443-1500)."""
    x_ax = -1
    y_ax = -2
    bxc = 0.5 * (U[IA] + np.roll(U[IA], -1, axis=x_ax))
    byc = 0.5 * (U[IB] + np.roll(U[IB], -1, axis=y_ax))
    if params.dim == 3:
        bzc = 0.5 * (U[IC] + np.roll(U[IC], -1, axis=-3))
    else:
        bzc = U[IC]
    rho = np.maximum(U[ID], params.smallr)
    ekin = 0.5 * (U[IU] ** 2 + U[IV] ** 2 + U[IW] ** 2) / rho
    emag = 0.5 * (bxc**2 + byc**2 + bzc**2)
    U[IP] = p_gas / (params.gamma0 - 1.0) + ekin + emag


def init_orszag_tang(params: RunParams, config: ConfigMap) -> np.ndarray:
    """Orszag-Tang vortex (MHDRunBase.cpp:1378-1520)."""
    two_pi = 2.0 * np.pi
    B0 = 1.0 / np.sqrt(2.0 * two_pi)
    p0 = params.gamma0 / (2.0 * two_pi)
    d0 = params.gamma0 * p0
    v0 = 1.0

    U = _empty(params)
    cs = coords(params)
    X, Y = cs[0], cs[1]

    U[ID] = d0
    U[IU] = -d0 * v0 * np.sin(Y * two_pi)
    U[IV] = d0 * v0 * np.sin(X * two_pi)
    U[IA] = -B0 * np.sin(Y * two_pi)
    U[IB] = B0 * np.sin(2.0 * X * two_pi)
    if params.dim == 3:
        # 3D variant keeps the same planar structure in every z-plane
        pass
    _energy_from_cell_b(params, U, p0)
    return U


def init_mhd_briowu(params: RunParams, config: ConfigMap) -> np.ndarray:
    """Brio-Wu MHD shock tube (MHDRunBase.cpp:1870-2110); direction 0/1/3."""
    B0 = config.get_float("BrioWu", "B0", 1.0)
    B1 = config.get_float("BrioWu", "B1", 0.75)
    d0 = config.get_float("BrioWu", "d0", 1.0)
    d1 = config.get_float("BrioWu", "d1", 0.125)
    p0, p1 = 1.0, 0.1
    direction = config.get_integer("BrioWu", "direction", 0)

    U = _empty(params)
    grids = index_grids(params)
    I, J = grids[0], grids[1]
    emag = 0.5 * (B0 * B0 + B1 * B1)

    if direction == 0:
        left = I < params.isize // 2
        U[ID] = np.where(left, d0, d1)
        U[IP] = np.where(left, p0, p1) / (params.gamma0 - 1.0) + emag
        U[IA] = B1
        U[IB] = np.where(left, B0, -B0)
    elif direction == 1:
        bottom = J < params.jsize // 2
        U[ID] = np.where(bottom, d0, d1)
        U[IP] = np.where(bottom, p0, p1) / (params.gamma0 - 1.0) + emag
        U[IA] = np.where(bottom, B0, -B0)
        U[IB] = B1
    elif direction == 2 and params.dim == 3:
        K = grids[2]
        front = K < params.ksize // 2
        U[ID] = np.where(front, d0, d1)
        U[IP] = np.where(front, p0, p1) / (params.gamma0 - 1.0) + emag
        U[IA] = np.where(front, B0, -B0)
        U[IC] = B1
    else:  # diagonal XY (direction == 3)
        left = I.astype(float) / params.isize + J.astype(float) / params.jsize < 1
        emag_d = 0.5 * ((-B0 + B1) ** 2 / 2 + (B0 + B1) ** 2 / 2)
        s = 1.0 / np.sqrt(2.0)
        U[ID] = np.where(left, d0, d1)
        U[IP] = np.where(left, p0, p1) / (params.gamma0 - 1.0) + emag_d
        U[IA] = np.where(left, -B0 * s + B1 * s, B0 * s + B1 * s)
        U[IB] = np.where(left, B0 * s + B1 * s, -B0 * s + B1 * s)
    return U


def init_mhd_sod(params: RunParams, config: ConfigMap) -> np.ndarray:
    """Sod tube with zero field — MHD solver regression oracle
    (MHDRunBase.cpp:1806-1868)."""
    U = _empty(params)
    I = index_grids(params)[0]
    left = I < params.isize // 2
    U[ID] = np.where(left, 1.0, 0.125)
    U[IP] = np.where(left, 1.0, 0.1) / (params.gamma0 - 1.0)
    return U


def init_mhd_rotor(params: RunParams, config: ConfigMap) -> np.ndarray:
    """MHD rotor (MHDRunBase.cpp:2117-2212)."""
    four_pi = 4.0 * np.pi
    r0 = config.get_float("rotor", "r0", 0.1)
    r1 = config.get_float("rotor", "r1", 0.115)
    u0 = config.get_float("rotor", "u0", 2.0)
    p0 = config.get_float("rotor", "p0", 1.0)
    b0 = config.get_float("rotor", "b0", 5.0 / np.sqrt(four_pi))

    U = _empty(params)
    cs = coords(params)
    X, Y = cs[0], cs[1]
    xc = (params.xmax + params.xmin) / 2
    yc = (params.ymax + params.ymin) / 2
    r = np.sqrt((X - xc) ** 2 + (Y - yc) ** 2)
    f_r = (r1 - r) / (r1 - r0)
    r_safe = np.maximum(r, 1e-30)

    U[ID] = np.where(r <= r0, 10.0, np.where(r <= r1, 1 + 9 * f_r, 1.0))
    U[IU] = np.where(
        r <= r0, -u0 * (Y - yc) / r0,
        np.where(r <= r1, -f_r * u0 * (Y - yc) / r_safe, 0.0),
    )
    U[IV] = np.where(
        r <= r0, u0 * (X - xc) / r0,
        np.where(r <= r1, f_r * u0 * (X - xc) / r_safe, 0.0),
    )
    U[IA] = b0
    U[IP] = (
        p0 / (params.gamma0 - 1.0)
        + 0.5 * (U[IU] ** 2 + U[IV] ** 2 + U[IW] ** 2) / U[ID]
        + 0.5 * b0 * b0
    )
    return U


def init_mhd_field_loop(params: RunParams, config: ConfigMap) -> np.ndarray:
    """Advected field loop (MHDRunBase.cpp:2214-2422): B from a vector
    potential Az so divB = 0 to machine precision."""
    radius = config.get_float("FieldLoop", "radius", 1.0)
    density_in = config.get_float("FieldLoop", "density_in", 1.0)
    amplitude = config.get_float("FieldLoop", "amplitude", 1.0)
    vflow = config.get_float("FieldLoop", "vflow", 1.0)
    cos_theta = 2.0 / np.sqrt(5.0)
    sin_theta = np.sqrt(1 - cos_theta**2)

    U = _empty(params)
    cs = coords(params)
    X, Y = cs[0], cs[1]
    r = np.sqrt(X * X + Y * Y)

    Az = np.where(r < radius, amplitude * (radius - r), 0.0)

    rho = np.where(r < radius, density_in, 1.0)
    U[ID] = rho
    U[IU] = rho * vflow * cos_theta
    U[IV] = rho * vflow * sin_theta

    if params.dim == 3:
        amp = config.get_float("FieldLoop", "amp", 0.01)
        seed = config.get_integer("FieldLoop", "seed", 0)
        rng = np.random.RandomState(seed)
        Az = Az + amp * (rng.rand(*Az.shape) - 0.5) * (r >= radius)
        U[IA] = (np.roll(Az, -1, axis=-2) - Az) / params.dy
        U[IB] = -(np.roll(Az, -1, axis=-1) - Az) / params.dx
    else:
        U[IA] = (np.roll(Az, -1, axis=-2) - Az) / params.dy
        U[IB] = -(np.roll(Az, -1, axis=-1) - Az) / params.dx

    _energy_from_cell_b(params, U, 1.0)
    return U


def init_mhd_current_sheet(params: RunParams, config: ConfigMap) -> np.ndarray:
    """Double current sheet (MHDRunBase.cpp:2424-2501)."""
    A = config.get_float("CurrentSheet", "A", 0.1)
    B0 = config.get_float("CurrentSheet", "B0", 1.0)
    beta = config.get_float("CurrentSheet", "beta", 0.1)

    U = _empty(params)
    cs = coords(params)
    X, Y = cs[0], cs[1]
    U[ID] = 1.0
    U[IP] = beta  # the reference stores beta directly in the energy slot
    U[IU] = U[ID] * A * np.sin(np.pi * Y)
    U[IB] = np.where((X < 0.5) | (X > 1.5), B0, -B0)
    return U


def init_mhd_kelvin_helmholtz(params: RunParams, config: ConfigMap) -> np.ndarray:
    """MHD Kelvin-Helmholtz (MHDRunBase.cpp:2814-2993): hydro KH plus a
    uniform field along x."""
    from .hydro_inits import init_hydro_kelvin_helmholtz

    # build the hydro part on a temporary 5-var view
    hydro_params = params.replace(mhd=False, ghost_width=params.ghost_width)
    Uh = init_hydro_kelvin_helmholtz(hydro_params, config)
    U = _empty(params)
    U[: Uh.shape[0]] = Uh
    b0 = config.get_float("kelvin-helmholtz", "b0", 0.5)
    U[IA] = b0
    # add the magnetic energy on top of the hydro total energy
    U[IP] += 0.5 * b0 * b0
    return U


def init_mhd_rayleigh_taylor(params: RunParams, config: ConfigMap) -> np.ndarray:
    """MHD Rayleigh-Taylor (MHDRunBase.cpp:2995-3043): hydro RT plus a
    uniform horizontal field."""
    from .hydro_inits import init_hydro_rayleigh_taylor

    hydro_params = params.replace(mhd=False, ghost_width=params.ghost_width)
    Uh = init_hydro_rayleigh_taylor(hydro_params, config)
    U = _empty(params)
    U[: Uh.shape[0]] = Uh
    b0 = config.get_float("rayleigh-taylor", "bx0", 0.0)
    U[IA] = b0
    U[IP] += 0.5 * b0 * b0
    return U


def init_mhd_jet(params: RunParams, config: ConfigMap) -> np.ndarray:
    """Uniform ambient medium for the MHD jet (MHDRunBase.cpp:1747-1804)."""
    U = _empty(params)
    p_amb = config.get_float("jet", "pamb", 1.0 / params.gamma0)
    d_amb = config.get_float("jet", "damb", 1.0)
    b_amb = config.get_float("jet", "bamb", 0.0)
    U[ID] = d_amb
    U[IA] = b_amb
    _energy_from_cell_b(params, U, p_amb)
    return U


def init_mhd_inertial_wave(params: RunParams, config: ConfigMap) -> np.ndarray:
    """Epicyclic inertial wave: uniform state with an x velocity kick
    (MHDRunBase.cpp:2503-2572); the rotating frame turns it into an
    epicyclic oscillation with frequency Omega0."""
    density = config.get_float("InertialWave", "density", 1.0)
    energy = config.get_float("InertialWave", "energy", 1.0)
    delta_vx = config.get_float("InertialWave", "delta_vx", 1.0) * params.c_iso
    U = _empty(params)
    U[ID] = density
    U[IP] = energy
    U[IU] = density * delta_vx
    return U


def init_mhd_shear_wave(params: RunParams, config: ConfigMap) -> np.ndarray:
    """Compressible shearing wave (MHDRunBase.cpp:2574-2675): a single
    (kx0, ky0) mode whose kx winds up with the background shear."""
    two_pi = 2.0 * np.pi
    d0 = 1.0
    Lx = params.dx * params.nx
    Ly = params.dy * params.ny
    energy = config.get_float("ShearWave", "energy", 1.0)
    delta_vx = -4.0e-4 * params.c_iso
    delta_vy = 1.0e-4 * params.c_iso
    kx0 = -4 * two_pi / Lx
    ky0 = two_pi / Ly
    xi0 = 0.5 * params.omega0 / d0
    delta_rho = (kx0 * delta_vy - ky0 * delta_vx) / xi0

    U = _empty(params)
    cs = coords(params)
    X, Y = cs[0], cs[1]
    phase = kx0 * X + ky0 * Y
    U[ID] = d0 * (1.0 - delta_rho * np.sin(phase))
    U[IP] = energy
    U[IU] = U[ID] * delta_vx * np.cos(phase)
    U[IV] = U[ID] * delta_vy * np.cos(phase)
    return U


def init_mhd_mri(params: RunParams, config: ConfigMap) -> np.ndarray:
    """Magneto-rotational instability in a shearing box
    (MHDRunBase.cpp:2677-2812). Isothermal EOS expected; field type
    'noflux' (Bz ~ sin 2pi x), 'fluxZ'/'pyl' (uniform Bz), else zero field.
    Velocities are deviations from the background shear. With gravity
    enabled, the stratified variant applies the Gaussian density profile
    and a toroidal field within |z| < H."""
    if params.dim != 3:
        raise ValueError("MRI is 3D only")
    d0 = config.get_float("MRI", "density", 1.0)
    beta = config.get_float("MRI", "beta", 400.0)
    p0 = d0 * params.c_iso * params.c_iso
    mri_type = config.get_string("MRI", "type", "noflux")
    if mri_type == "pyl":
        B0 = 1.5 * np.sqrt(d0 * params.omega0**2 * (params.zmax - params.zmin) ** 2 / beta)
    else:
        B0 = 2.0 * np.sqrt(p0 / beta)
    amp = config.get_float("MRI", "amp", 0.01)
    seed = config.get_integer("MRI", "seed", 0)
    d_amp = config.get_float("MRI", "density_fluctuations", 0.0)
    rng = np.random.RandomState(seed if seed else 12345)

    U = _empty(params)
    cs = coords(params)
    X = cs[0]
    shp = params.shape[1:]
    U[ID] = d0 * (1.0 + d_amp * 2.0 * (rng.rand(*shp) - 0.5))
    vamp = amp * np.sqrt(p0)
    U[IU] = d0 * vamp * (rng.rand(*shp) - 0.5)
    U[IV] = d0 * vamp * (rng.rand(*shp) - 0.5)
    U[IW] = d0 * vamp * (rng.rand(*shp) - 0.5)
    if mri_type == "noflux":
        U[IC] = B0 * np.sin(2.0 * np.pi * X)
    elif mri_type in ("pyl", "fluxZ"):
        U[IC] = B0

    if mri_stratified(config):
        # stratified MRI (MHDRunBase.cpp:2745-2805): Gaussian density
        # stratification with a floor, toroidal field confined to |z| < H
        z = cs[2]
        z_floor = config.get_float("MRI", "zFloor", 5.0)
        H = params.c_iso / params.omega0
        U[ID] = d0 * np.maximum(
            np.exp(-(z * z) / (2.0 * H * H)), np.exp(-z_floor * z_floor / 2.0)
        )
        U[IA] = 0.0
        U[IC] = 0.0
        U[IB] = np.where(np.abs(z) < H, B0, 0.0)

    _energy_from_cell_b(params, U, np.maximum(p0, params.smallp))
    return U


def mri_stratified(config: ConfigMap) -> bool:
    """Whether an MRI run is the stratified one: its INI enables [gravity]
    (the reference builds h_gravity only then)."""
    return config.get_bool("gravity", "enabled", False) or config.has("gravity", "static")


def mri_gravity_field(params: RunParams, config: ConfigMap):
    """Static vertical gravity of the STRATIFIED MRI, [3, *ghosted shape]
    in the state's dtype (ramsesgpu_tpu/problems/mhd_inits.py:353-378):
    g_z = -omega0^2 z, with the optional smooth cutoff near the vertical
    boundaries (MHDRunBase.cpp:3163-3245 init_mhd_mri_grav_field); None for
    an MRI run without a [gravity] section."""
    if not mri_stratified(config):
        return None
    z = cell_centers_1d(params, "z")
    gz = -params.omega0**2 * z
    if config.get_bool("MRI", "smoothGravity", False):
        z_floor = config.get_float("MRI", "zFloor", 5.0)
        H = params.c_iso / params.omega0
        gz = gz * np.exp(-((np.abs(z) / (z_floor * H)) ** 8))
    shape = params.shape[1:]
    g = np.zeros((3,) + shape, dtype=_np_dtype(params))
    g[2] = gz[:, None, None]
    return g


# aliases follow the reference's dispatch (MHDRunBase.cpp:1286-1340)
for _name in ("Orszag-Tang", "OrszagTang"):
    register_mhd(_name, init_orszag_tang)
for _name in ("Brio-Wu", "BrioWu", "brio-wu", "briowu"):
    register_mhd(_name, init_mhd_briowu)
register_mhd("sod", init_mhd_sod)
for _name in ("Rotor", "rotor"):
    register_mhd(_name, init_mhd_rotor)
for _name in ("FieldLoop", "fieldloop", "Fieldloop", "field-loop", "Field-Loop"):
    register_mhd(_name, init_mhd_field_loop)
for _name in ("CurrentSheet", "currentsheet", "Current-Sheet", "current-sheet"):
    register_mhd(_name, init_mhd_current_sheet)
for _name in ("Kelvin-Helmholtz", "Kelvin-helmholtz", "kelvin-helmholtz"):
    register_mhd(_name, init_mhd_kelvin_helmholtz)
for _name in ("Rayleigh-Taylor", "rayleigh-taylor"):
    register_mhd(_name, init_mhd_rayleigh_taylor)
for _name in ("jet", "Jet"):
    register_mhd(_name, init_mhd_jet)
for _name in ("MRI", "Mri", "mri"):
    register_mhd(_name, init_mhd_mri)
for _name in ("InertialWave", "inertialwave", "inertial-wave", "Inertial-Wave"):
    register_mhd(_name, init_mhd_inertial_wave)
for _name in ("ShearWave", "shearwave", "shear-wave", "Shear-Wave"):
    register_mhd(_name, init_mhd_shear_wave)
