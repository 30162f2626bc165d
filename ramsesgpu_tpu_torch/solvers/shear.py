"""Shearing-box boundary conditions: the sheared-periodic x ghost fill (the
PyTorch twin of ramsesgpu_tpu/solvers/shear.py; reference
make_boundary_shear.h:39-300, MHDRunGodunov.cpp:3445-3560).

Velocities are deviations from the background shear -1.5 omega0 x, so the
x ghosts are the opposite x border shifted in y by
deltay = 1.5 omega0 Lx t (mod Ly), with a slope-corrected linear
interpolation; the face-centred By takes the conservative form
b + eps * slope, and the first XMAX ghost column of Bx is left as it is:
it is the last interior cell's own right face (the "kept" face).

``shear_slabs`` builds the two ghost slabs from the port's loop state
(S [8, nz, ny, nx], kept [nz, ny]); it is the plain twin of the CUDA slab
kernel (kernels/shear_border.py). The y shifts are index gathers with the
shift as a device tensor, so no host sync is needed. Only periodic y and
z faces are ported (stratified z, BC_Z_STRATIFIED, raises).
"""
from __future__ import annotations

import torch

from ..config.params import RunParams
from ..core.constants import IA, IB, BoundaryConditionType as BCT

from ..ops.slopes import slope_1d

_X, _Y, _Z = -1, -2, -3


def roll_dynamic(a: torch.Tensor, shift: torch.Tensor, axis: int = _Y) -> torch.Tensor:
    """torch.roll(a, shift, axis) for a 0-d integer tensor ``shift``:
    out[j] = a[(j - shift) mod n] (the JAX package's jnp.roll with a traced
    shift)."""
    n = a.shape[axis]
    idx = torch.remainder(torch.arange(n, device=a.device) - shift.to(a.device), n)
    return torch.index_select(a, axis % a.ndim, idx)


def shear_offset(params: RunParams, t: torch.Tensor):
    """(jplus, epsi) of the sheared fill at time t: deltay = 1.5 omega0 Lx
    t mod Ly, jplus = floor(deltay / dy), epsi = deltay mod dy, in t's
    dtype with the JAX package's op order (solvers/shear.py:44-49)."""
    dy = params.dy
    Lx = params.dx * params.nx
    Ly = dy * params.ny
    deltay = torch.remainder(1.5 * params.omega0 * Lx * t, Ly)
    jplus = torch.floor(deltay / dy).to(torch.int64)
    epsi = torch.remainder(deltay, dy)
    return jplus, epsi


def _border_slopes(params: RunParams, buf: torch.Tensor) -> torch.Tensor:
    """Limited y-slopes of a border slab (make_boundary_shear.h:62-128)."""
    return slope_1d(params, buf, _Y)


def shear_slabs(params: RunParams, S: torch.Tensor, kept: torch.Tensor, t) -> torch.Tensor:
    """The sheared x ghost slabs [2, 8, nz, ny, g] (XMIN, XMAX) at time
    ``t`` from the loop state: ramsesgpu_tpu/pallas/shear_packed.py:167
    ``_shear_slabs_from_interior``, bitwise equal to the ghosted form
    solvers/shear.py:106 ``_shear_ghost_slabs`` (rolls are permutations)."""
    g = params.ghost_width
    nx, dy = params.nx, params.dy
    jplus, epsi = shear_offset(params, t)
    bmin = S[..., 0:g]
    bmax = S[..., nx - g:nx]

    def slopes_of(buf):
        # y is periodic: the slab's own rows wrap
        wrapped = torch.cat([buf[..., -1:, :], buf, buf[..., :1, :]], _Y)
        return _border_slopes(params, wrapped)[..., 1:-1, :]

    eps_min = 1.0 - epsi / dy
    lam_min = 0.5 * eps_min * (eps_min - 1.0)
    one = torch.ones_like(jplus)
    r0b, r0s = roll_dynamic(bmax, jplus), roll_dynamic(slopes_of(bmax), jplus)
    r1b, r1s = roll_dynamic(r0b, one), roll_dynamic(r0s, one)
    gmin = (1.0 - eps_min) * r1b + eps_min * r0b + lam_min * (r1s - r0s)
    gmin[IB] = r1b[IB] + eps_min * r1s[IB]

    eps_max = epsi / dy
    lam_max = 0.5 * eps_max * (eps_max - 1.0)
    q0b, q0s = roll_dynamic(bmin, -jplus), roll_dynamic(slopes_of(bmin), -jplus)
    q1b, q1s = roll_dynamic(q0b, -one), roll_dynamic(q0s, -one)
    gmax = (1.0 - eps_max) * q0b + eps_max * q1b - lam_max * (q0s - q1s)
    gmax[IB] = q0b[IB] + eps_max * q0s[IB]
    # the kept Bx face (make_boundary_shear.h:276-288)
    gmax[IA, :, :, 0] = kept
    return torch.stack([gmin, gmax])


def _shear_ghost_slabs(params: RunParams, U: torch.Tensor, t) -> torch.Tensor:
    """shear_slabs of a ghosted state (solvers/shear.py:106): interior-extent
    (z, y) slabs [2, nvar, nz, ny, g]."""
    g = params.ghost_width
    core = U[:, g:-g, g:-g]
    return shear_slabs(params, core[..., g:g + params.nx], core[IA, ..., params.nx + g], t)


def wrap_yz(params: RunParams, mid: torch.Tensor) -> torch.Tensor:
    """mid with periodic y and z ghost layers added (jnp.pad mode="wrap")."""
    g = params.ghost_width
    for axis in (_Y, _Z):
        n = mid.shape[axis]
        mid = torch.cat([mid.narrow(axis, n - g, g), mid, mid.narrow(axis, 0, g)], axis)
    return mid


def make_all_boundaries_shear(params: RunParams, U: torch.Tensor, t) -> torch.Tensor:
    """Every ghost of a 3D shearing-box state with periodic y and z faces at
    time t (solvers/shear.py:202, its periodic fast path): the sheared x
    slabs beside the interior, then the y and z wraps. A new tensor. Other
    y / z faces (stratified z, walls) are not ported and raise."""
    bts = params.boundary_types
    if params.dim != 3 or any(b != BCT.BC_PERIODIC for b in bts[2:]):
        names = [b.name for b in bts[2:]]
        raise NotImplementedError(
            f"the 3D shearing box with periodic y and z is ported, got {names}")
    g = params.ghost_width
    gmin, gmax = _shear_ghost_slabs(params, U, t)
    return wrap_yz(params, torch.cat([gmin, U[:, g:-g, g:-g, g:params.nx + g], gmax], _X))
