"""Runtime parameters, parsed from INI config into an immutable dataclass.

TPU-first re-design of the reference's ``HydroParameters`` /
``GlobalConstants gParams`` (reference: src/hydro/HydroParameters.h:45-553,
constants.h:277-317). Instead of a mutable struct mirrored into CUDA
``__constant__`` memory, parameters live in a frozen, *hashable* dataclass
passed as a static argument to jitted step functions — XLA constant-folds
every scalar, which is the TPU analogue of constant memory.

The same ``data/*.ini`` problem files used by the reference parse unchanged
(key names and defaults replicated from HydroParameters.h:196-437).

The port's own copy of ramsesgpu_tpu/config/params.py: the port imports nothing of
the JAX package.
"""
from __future__ import annotations

import dataclasses
import math

from ..core.constants import (
    BoundaryConditionType,
    GeometryType,
    MagneticRiemannSolver,
    NvarSimulation,
    RiemannSolver,
    Scheme,
)
from .configmap import ConfigMap

_SCHEME_BY_NAME = {
    "muscl": Scheme.MUSCL,
    "plmde": Scheme.PLMDE,
    "collela": Scheme.COLLELA,
}

_RIEMANN_BY_NAME = {
    "approx": RiemannSolver.APPROX,
    "hll": RiemannSolver.HLL,
    "hllc": RiemannSolver.HLLC,
    "hlld": RiemannSolver.HLLD,
    "llf": RiemannSolver.LLF,
}

_MAG_RIEMANN_BY_NAME = {
    "hlld": MagneticRiemannSolver.MAG_HLLD,
    "hllf": MagneticRiemannSolver.MAG_HLLF,
    "hlla": MagneticRiemannSolver.MAG_HLLA,
    "roe": MagneticRiemannSolver.MAG_ROE,
    "llf": MagneticRiemannSolver.MAG_LLF,
    "upwind": MagneticRiemannSolver.MAG_UPWIND,
}


@dataclasses.dataclass(frozen=True)
class RunParams:
    """Everything a step function needs to know at trace time."""

    # mesh (global extents; per-shard sizes are derived in parallel/)
    nx: int = 2
    ny: int = 2
    nz: int = 1
    xmin: float = 0.0
    xmax: float = 1.0
    ymin: float = 0.0
    ymax: float = 1.0
    zmin: float = 0.0
    zmax: float = 1.0
    geometry: GeometryType = GeometryType.GEO_CARTESIAN
    ghost_width: int = 2
    boundary_xmin: BoundaryConditionType = BoundaryConditionType.BC_DIRICHLET
    boundary_xmax: BoundaryConditionType = BoundaryConditionType.BC_DIRICHLET
    boundary_ymin: BoundaryConditionType = BoundaryConditionType.BC_DIRICHLET
    boundary_ymax: BoundaryConditionType = BoundaryConditionType.BC_DIRICHLET
    boundary_zmin: BoundaryConditionType = BoundaryConditionType.BC_DIRICHLET
    boundary_zmax: BoundaryConditionType = BoundaryConditionType.BC_DIRICHLET

    # physics / scheme
    mhd: bool = False
    problem: str = "unknown"
    gamma0: float = 1.4
    cfl: float = 0.5
    c_iso: float = 0.0            # isothermal sound speed; >0 switches the EOS
    smallr: float = 1e-10
    smallc: float = 1e-10
    niter_riemann: int = 10
    iorder: int = 2
    slope_type: float = 1.0
    scheme: Scheme = Scheme.MUSCL
    riemann_solver: RiemannSolver = RiemannSolver.APPROX
    mag_riemann_solver: MagneticRiemannSolver = MagneticRiemannSolver.MAG_HLLD
    trace_version: int = 1
    unsplit_version: int = 1
    implementation_version: int = 1  # MHD pipeline version knob ([MHD] section)
    z_slab_nb: int = 0  # >1: z-slab pipelining for 3D memory capacity

    # source terms
    omega0: float = 0.0           # rotating frame / shearing box angular velocity
    nu: float = 0.0               # kinematic viscosity
    eta: float = 0.0              # resistivity (MHD)
    gravity_x: float = 0.0
    gravity_y: float = 0.0
    gravity_z: float = 0.0

    # legacy-scheme knobs (HydroParameters.h:314-318)
    alpha_kt: float = 1.4
    xlambda: float = 0.25
    ylambda: float = 0.25
    alpha_ll: float = 0.9  # Lax-Liu ALPHA
    beta_ll: float = 0.1   # Lax-Liu BETA

    # jet problem parameters ([jet] section, HydroParameters.h:439-444)
    ijet: int = 0
    djet: float = 1.0
    ujet: float = 0.0
    pjet: float = 0.0
    offset_jet: int = 0

    # compute path: "auto" (fused Pallas kernel where supported, on TPU),
    # "pallas" (force), or "jnp" (whole-array XLA)
    kernel: str = "auto"
    pallas_tiles: tuple[int, int] | None = None  # (bz, by) override
    # shearing box: fold the sheared-slab build, flux/emfY remap, border
    # corrections and kept-Bx CT into the strip kernel ([implementation]
    # stripFused; needs lane-exact ny — pallas/shear_packed.py).
    # None = auto: ON for dissipative shear runs (two strip passes per
    # step there; the XLA strip glue measured 40.9 vs 26.1 ms/step for
    # viscous-resistive MRI at 128x256x128 on the v5e, round 5), OFF for
    # ideal MRI (measured a slight loss, 16.8 vs 16.4, round 4).
    strip_fused: bool | None = None
    # sharded path: overlap the bulk halo exchange with the deep-interior
    # update ([implementation] haloOverlap; see parallel/overlap.py)
    halo_overlap: bool = False
    # periodic packed advance: fold the in-tile CFL into the main launch
    # and finish on tile-seam cells ([implementation] foldCfl). Measured
    # SLOWER on v5e at 256^3 (40.6 vs 35.5 ms/step, round 4): the main
    # kernel is VPU-bound so the folded reduction lands on the critical
    # path, and the strided seam pass costs more than the full streaming
    # CFL kernel's sequential re-read it replaces. Default off.
    fold_cfl: bool = False
    # MHD trace: assemble the 18 face/edge state stacks as ONE fused
    # concatenate that builders slice, instead of 18 separate stacks
    # ([implementation] traceMerged). Each separate stack is a fusion
    # root that XLA/Mosaic duplicates the shared half-step chain into —
    # measured 12.2k flops/cell duplicated vs ~2.5k computed-once on the
    # XLA cost model (scripts/trace_dup_probe.py). Hardware verdict
    # decides the default.
    trace_merged: bool = False

    # precision: "float32" (reference single) or "float64" (reference USE_DOUBLE)
    dtype: str = "float32"
    # Kahan-compensated f32 state accumulation in the packed advance loops
    # ([implementation] compensated): the TPU-native double-precision story —
    # the dominant f32 error in long runs is the U += dU summation loss
    # (~eps*|U| per step vs ~eps*|dU| flux rounding), which a carried
    # compensation channel removes at ~1.2x cost, where emulated f64 on TPU
    # measures ~86x (STATUS.md). Reference double regime: real_type.h:1-105.
    compensated: bool = False

    # run control
    t_end: float = 0.0
    n_stepmax: int = 1000
    n_output: int = 100

    # ------------------------------------------------------------------ #
    # derived quantities (kept as properties so the dataclass stays a pure
    # record of the INI content; all are Python floats → static under jit)
    # ------------------------------------------------------------------ #
    @property
    def dim(self) -> int:
        return 2 if self.nz == 1 else 3

    @property
    def nb_var(self) -> int:
        if self.mhd:
            return int(NvarSimulation.NVAR_MHD)
        return int(NvarSimulation.NVAR_2D if self.dim == 2 else NvarSimulation.NVAR_3D)

    @property
    def dx(self) -> float:
        return (self.xmax - self.xmin) / self.nx

    @property
    def dy(self) -> float:
        return (self.ymax - self.ymin) / self.ny

    @property
    def dz(self) -> float:
        return (self.zmax - self.zmin) / self.nz

    @property
    def smallp(self) -> float:
        """Pressure floor (HydroParameters.h:309-310)."""
        if self.c_iso > 0:
            return self.smallr * self.c_iso * self.c_iso
        return self.smallc * self.smallc / self.gamma0

    @property
    def smallpp(self) -> float:
        return self.smallr * self.smallp

    @property
    def gamma6(self) -> float:
        return (self.gamma0 + 1.0) / (2.0 * self.gamma0)

    @property
    def isize(self) -> int:
        return self.nx + 2 * self.ghost_width

    @property
    def jsize(self) -> int:
        return self.ny + 2 * self.ghost_width

    @property
    def ksize(self) -> int:
        return self.nz + 2 * self.ghost_width if self.dim == 3 else 1

    @property
    def shape(self) -> tuple[int, ...]:
        """Shape of the conserved state array [nvar, (z,) y, x] — x last so
        grid columns map onto TPU lanes."""
        if self.dim == 2:
            return (self.nb_var, self.jsize, self.isize)
        return (self.nb_var, self.ksize, self.jsize, self.isize)

    @property
    def boundary_types(self) -> tuple[BoundaryConditionType, ...]:
        return (
            self.boundary_xmin,
            self.boundary_xmax,
            self.boundary_ymin,
            self.boundary_ymax,
            self.boundary_zmin,
            self.boundary_zmax,
        )

    def replace(self, **kw) -> "RunParams":
        return dataclasses.replace(self, **kw)


def params_from_config(config: ConfigMap, **overrides) -> RunParams:
    """Build a :class:`RunParams` from an INI ConfigMap, mirroring the parse
    logic and defaults of HydroParameters.h:196-437."""
    nz = config.get_integer("mesh", "nz", 1)
    mhd = config.get_bool("MHD", "enable", False)

    ghost = config.get_integer("mesh", "ghostWidth", 2)
    if ghost not in (2, 3):
        ghost = 2
    if mhd:
        ghost = 3  # CT stencil needs 3 ghost layers (HydroParameters.h:268-271)

    scheme = _SCHEME_BY_NAME.get(
        config.get_string("hydro", "scheme", "muscl").lower(), Scheme.UNKNOWN
    )
    riemann = _RIEMANN_BY_NAME.get(
        config.get_string("hydro", "riemannSolver", "approx").lower(),
        RiemannSolver.APPROX,
    )
    if not mhd and riemann in (RiemannSolver.HLLD, RiemannSolver.LLF):
        riemann = RiemannSolver.APPROX  # hydro-only solvers (HydroParameters.h:360-366)
    mag_riemann = _MAG_RIEMANN_BY_NAME.get(
        config.get_string("MHD", "magRiemannSolver", "hlld").lower(),
        MagneticRiemannSolver.MAG_HLLD,
    )

    cfl = config.get_float("hydro", "cfl", 0.5)
    if not cfl or math.isnan(cfl):
        cfl = 0.5

    bc = {
        loc: BoundaryConditionType(
            config.get_integer("mesh", f"boundary_{loc}", BoundaryConditionType.BC_DIRICHLET)
        )
        for loc in ("xmin", "xmax", "ymin", "ymax", "zmin", "zmax")
    }

    params = RunParams(
        nx=config.get_integer("mesh", "nx", 2),
        ny=config.get_integer("mesh", "ny", 2),
        nz=nz,
        xmin=config.get_float("mesh", "xmin", 0.0),
        xmax=config.get_float("mesh", "xmax", 1.0),
        ymin=config.get_float("mesh", "ymin", 0.0),
        ymax=config.get_float("mesh", "ymax", 1.0),
        zmin=config.get_float("mesh", "zmin", 0.0),
        zmax=config.get_float("mesh", "zmax", 1.0),
        geometry=GeometryType(config.get_integer("mesh", "geometry", 0)),
        ghost_width=ghost,
        boundary_xmin=bc["xmin"],
        boundary_xmax=bc["xmax"],
        boundary_ymin=bc["ymin"],
        boundary_ymax=bc["ymax"],
        boundary_zmin=bc["zmin"],
        boundary_zmax=bc["zmax"],
        mhd=mhd,
        problem=config.get_string("hydro", "problem", "unknown"),
        gamma0=config.get_float("hydro", "gamma0", 1.4),
        cfl=cfl,
        c_iso=config.get_float("hydro", "cIso", 0.0),
        smallr=config.get_float("hydro", "smallr", 1e-10),
        smallc=config.get_float("hydro", "smallc", 1e-10),
        niter_riemann=config.get_integer("hydro", "niter_riemann", 10),
        iorder=config.get_integer("hydro", "iorder", 2),
        slope_type=config.get_float("hydro", "slope_type", 1.0),
        scheme=scheme,
        riemann_solver=riemann,
        mag_riemann_solver=mag_riemann,
        trace_version=config.get_integer("hydro", "traceVersion", 1),
        unsplit_version=config.get_integer("implementation", "unsplitVersion", 1),
        z_slab_nb=config.get_integer("implementation", "zSlabNb", 0),
        implementation_version=config.get_integer("MHD", "implementationVersion", 1),
        omega0=config.get_float("MHD", "omega0", 0.0),
        nu=config.get_float("hydro", "nu", 0.0),
        eta=config.get_float("MHD", "eta", 0.0),
        gravity_x=config.get_float("gravity", "static_field_x", 0.0),
        gravity_y=config.get_float("gravity", "static_field_y", 0.0),
        gravity_z=config.get_float("gravity", "static_field_z", 0.0),
        alpha_kt=config.get_float("hydro", "ALPHA_KT", 1.4),
        xlambda=config.get_float("hydro", "XLAMBDA", 0.25),
        ylambda=config.get_float("hydro", "YLAMBDA", 0.25),
        alpha_ll=config.get_float("hydro", "ALPHA", 0.9),
        beta_ll=config.get_float("hydro", "BETA", 0.1),
        ijet=config.get_integer("jet", "ijet", 0),
        djet=config.get_float("jet", "djet", 1.0),
        ujet=config.get_float("jet", "ujet", 0.0),
        pjet=config.get_float("jet", "pjet", 0.0),
        offset_jet=config.get_integer("jet", "offsetJet", 0),
        kernel=config.get_string("implementation", "kernel", "auto"),
        strip_fused=(
            None
            if config.get_string("implementation", "stripFused", "auto")
            .lower() in ("auto", "")
            else config.get_bool("implementation", "stripFused", False)
        ),
        fold_cfl=config.get_bool("implementation", "foldCfl", False),
        trace_merged=config.get_bool(
            "implementation", "traceMerged", False
        ),
        halo_overlap=config.get_bool("implementation", "haloOverlap", False),
        dtype=config.get_string("implementation", "dtype", "float32"),
        compensated=config.get_bool("implementation", "compensated", False),
        t_end=config.get_float("run", "tend", 0.0),
        n_stepmax=config.get_integer("run", "nstepmax", 1000),
        n_output=config.get_integer("run", "noutput", 100),
    )
    if overrides:
        params = params.replace(**overrides)
    return params
