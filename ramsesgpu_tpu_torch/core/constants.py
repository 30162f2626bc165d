"""Enumerations and component indices shared across the framework.

TPU-native re-design of the reference's enum layer
(reference: src/hydro/constants.h:45-231). We keep the same *names and
integer values* so that the reference's ``data/*.ini`` problem files parse
unchanged, but nothing here is CUDA-specific: these are plain Python enums
used as *static* (trace-time) configuration for jitted JAX programs.

The port's own copy of ramsesgpu_tpu/core/constants.py: the port imports nothing of
the JAX package.
"""
from __future__ import annotations

import enum


class NvarSimulation(enum.IntEnum):
    """Number of conserved fields (reference constants.h:45-49)."""

    NVAR_2D = 4   # 2D hydro: rho, E, rho*u, rho*v
    NVAR_3D = 5   # 3D hydro: rho, E, rho*u, rho*v, rho*w
    NVAR_MHD = 8  # MHD (2D or 3D): + Bx, By, Bz


# Hydro/MHD field indices (reference constants.h:59-71).
ID = 0   # density
IP = 1   # total energy (conservative) / pressure (primitive)
IU = 2   # x velocity / momentum
IV = 3   # y velocity / momentum
IW = 4   # z velocity / momentum
IBX = IA = 5  # Bx (face-centered at left x-face in conservative state)
IBY = IB = 6  # By
IBZ = IC = 7  # Bz


class ComponentIndex3D(enum.IntEnum):
    IX = 0
    IY = 1
    IZ = 2


IX, IY, IZ = 0, 1, 2


class GeometryType(enum.IntEnum):
    """reference constants.h:52-56 (cylindrical/spherical are vestigial there too)."""

    GEO_CARTESIAN = 0
    GEO_CYLINDRICAL = 1
    GEO_SPHERICAL = 2


class Scheme(enum.IntEnum):
    """Trace scheme (reference constants.h:137)."""

    UNKNOWN = 0
    MUSCL = 1
    PLMDE = 2
    COLLELA = 3


class NumScheme(enum.IntEnum):
    """Top-level numerical scheme (reference constants.h:130-134)."""

    GODUNOV = 0
    KURGANOV = 1
    RELAXING = 2


class RiemannSolver(enum.IntEnum):
    """Riemann solver for hydro fluxes (reference constants.h:140-146)."""

    APPROX = 0
    HLL = 1
    HLLC = 2
    HLLD = 3
    LLF = 4


class MagneticRiemannSolver(enum.IntEnum):
    """2D Riemann solver used for EMF at cell corners (reference constants.h:149-156)."""

    MAG_HLLD = 0
    MAG_HLLF = 1
    MAG_HLLA = 2
    MAG_ROE = 3     # never implemented in the reference either
    MAG_LLF = 4
    MAG_UPWIND = 5  # never implemented in the reference either


class BoundaryConditionType(enum.IntEnum):
    """Boundary condition ids — the *integer values* appear in .ini files
    (reference constants.h:209-217), so they must stay stable."""

    BC_UNDEFINED = 0
    BC_DIRICHLET = 1    # reflecting
    BC_NEUMANN = 2      # absorbing / zero-gradient
    BC_PERIODIC = 3
    BC_SHEARINGBOX = 4  # shearing box (x direction, MHD)
    BC_COPY = 5         # interior shard-to-shard boundary (MPI heritage)
    BC_Z_STRATIFIED = 6 # stratified MRI special z boundary


class BoundaryLocation(enum.IntEnum):
    """reference constants.h:198-205."""

    XMIN = 0
    XMAX = 1
    YMIN = 2
    YMAX = 3
    ZMIN = 4
    ZMAX = 5


class EmfIndex(enum.IntEnum):
    """EMF component storage order; EMFZ first since 2D only needs it
    (reference constants.h:191-195)."""

    I_EMFZ = 0
    I_EMFY = 1
    I_EMFX = 2


class FileFormat(enum.IntEnum):
    """Output file formats (reference constants.h:223-231)."""

    FF_HDF5 = 0
    FF_NETCDF = 1
    FF_PNETCDF = 2
    FF_VTK = 3
    FF_XSM = 4
    FF_NRRD = 5
    FF_BIN = 6


#: Human-readable variable names, indexed by ComponentIndex, used by every
#: output writer (matches the reference's varNames, HydroRunBase.cpp).
VAR_NAMES = ("density", "energy", "mx", "my", "mz", "bx", "by", "bz")


def var_names(nb_var: int) -> tuple[str, ...]:
    """Names of the first ``nb_var`` fields, handling the 2D-hydro case where
    slot IW does not exist."""
    if nb_var == NvarSimulation.NVAR_2D:
        return ("density", "energy", "mx", "my")
    return VAR_NAMES[:nb_var]
