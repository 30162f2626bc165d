"""CFL time step (the PyTorch twin of ramsesgpu_tpu/solvers/timestep.py;
reference cmpdt.cuh:43-230, cmpdt_mhd.cuh:43-230).

dt = cfl / max over interior cells of sum_d (c_d + |v_d|) / dx_d, with
c_d the sound speed (hydro) or the fast magnetosonic speed along d (MHD,
face-B centred to cells).
"""
from __future__ import annotations

import torch

from ..config.params import RunParams
from ..core.constants import IA, IB, IC, ID, IP, IU, IV, IW

from ..ops.backend import xp
from ..ops.stencil import shift_p
from .stratified import uses_stratified_z


def _require_3d(params: RunParams) -> None:
    if params.dim != 3:
        raise NotImplementedError("only 3D MHD is ported")


def _interior(params: RunParams, a: torch.Tensor, ghost=None) -> torch.Tensor:
    g = params.ghost_width if ghost is None else ghost
    if isinstance(g, int):
        g = (g,) * params.dim
    sl = tuple(slice(gi, -gi) if gi else slice(None) for gi in g)
    return a[(..., *sl)]


def compute_inv_dt_hydro(params: RunParams, U: torch.Tensor, ghost=None) -> torch.Tensor:
    """Max inverse dt over the interior of a 3D hydro state
    (timestep.py:33; cmpdt.cuh:84-86). ``ghost`` overrides the ghost frame
    width (0: U is the interior-only state). The same op order as the JAX
    function, so the same bits; the plain twin of the CUDA CFL kernel
    (kernels/cfl_hydro.py)."""
    if params.dim != 3:
        raise NotImplementedError("only 3D hydro is ported")
    rho = xp.maximum(U[ID], params.smallr)
    u = U[IU] / rho
    v = U[IV] / rho
    w = U[IW] / rho
    if params.c_iso > 0:
        c = torch.full_like(rho, params.c_iso)
    else:
        eken = 0.5 * (u * u + v * v + w * w)
        eint = U[IP] / rho - eken
        p = xp.maximum((params.gamma0 - 1.0) * rho * eint, rho * params.smallp)
        c = torch.sqrt(params.gamma0 * p / rho)
    inv = (c + torch.abs(u)) / params.dx + (c + torch.abs(v)) / params.dy
    inv = inv + (c + torch.abs(w)) / params.dz
    # torch.max propagates NaN, as jnp.max does
    return torch.max(_interior(params, inv, ghost))


def _inv_dt_mhd_fields(params: RunParams, rho, eP, u, v, w, bx, by, bz):
    """Max inverse dt from interior-extent fields (cell-centred B). In a
    rotating frame vy carries the shear offset 1.5 omega0 dx / 2."""
    _require_3d(params)
    rho = xp.maximum(rho, params.smallr)
    if params.c_iso > 0:
        p = rho * params.c_iso**2
    else:
        eken = 0.5 * (u * u + v * v + w * w)
        emag = 0.5 * (bx * bx + by * by + bz * bz)
        eint = (eP - emag) / rho - eken
        p = xp.maximum((params.gamma0 - 1.0) * rho * eint, rho * params.smallp)

    b2 = bx * bx + by * by + bz * bz
    c2 = params.gamma0 * p / rho
    d2 = 0.5 * (b2 / rho + c2)

    def cf(bn):
        return torch.sqrt(d2 + torch.sqrt(xp.maximum(d2 * d2 - c2 * bn * bn / rho, 0.0)))

    vy = v
    if params.omega0 > 0:
        vy = vy + 1.5 * params.omega0 * params.dx / 2.0
    inv = (
        (cf(bx) + torch.abs(u)) / params.dx
        + (cf(by) + torch.abs(vy)) / params.dy
        + (cf(bz) + torch.abs(w)) / params.dz
    )
    # torch.max propagates NaN, as jnp.max does
    return torch.max(inv)


def compute_inv_dt_mhd(params: RunParams, U: torch.Tensor, ghost=None) -> torch.Tensor:
    """Max inverse dt over the interior of a ghosted 3D state (roll shifts
    for the +1 face-B neighbours; the ghosts absorb the wrap)."""
    _require_3d(params)
    rho = xp.maximum(U[ID], params.smallr)
    fields = (
        U[ID], U[IP], U[IU] / rho, U[IV] / rho, U[IW] / rho,
        0.5 * (U[IA] + shift_p(U[IA], -1)),
        0.5 * (U[IB] + shift_p(U[IB], -2)),
        0.5 * (U[IC] + shift_p(U[IC], -3)),
    )
    return _inv_dt_mhd_fields(params, *(_interior(params, f, ghost) for f in fields))


def inv_dt_mhd_periodic(params: RunParams, S: torch.Tensor) -> torch.Tensor:
    """compute_inv_dt_mhd on the port's interior-only periodic state
    [8, nz, ny, nx]: the +1 face-B neighbours wrap around. This is the
    plain twin of the CUDA CFL kernel (kernels/cfl_mhd.py)."""
    return compute_inv_dt_mhd(params, S, ghost=0)


def inv_dt_mhd_shear(params: RunParams, S: torch.Tensor, kept: torch.Tensor) -> torch.Tensor:
    """The shearing-box CFL reduction on the loop state (S [8, nz, ny, nx],
    or a compensated state's 16 channels, of which it reads the first 8;
    kept [nz, ny]): compute_inv_dt_mhd of the ghosted state, whose +1 x
    face of the last column is the kept Bx face (ramsesgpu_tpu
    pallas/shear_packed.py:929-948); y wraps; z wraps, or with stratified z
    faces the top row's +1 z ghost continues its Bz (solvers/stratified.py).
    The plain twin of the CUDA CFL kernel's shearing-box mode
    (kernels/cfl_mhd.py)."""
    rho = xp.maximum(S[ID], params.smallr)
    ia = S[IA]
    ia_p = torch.cat([ia[..., 1:], kept[..., None]], dim=-1)
    ic = S[IC]
    ic_p = torch.cat([ic[1:], ic[-1:]]) if uses_stratified_z(params) else shift_p(ic, -3)
    return _inv_dt_mhd_fields(
        params, S[ID], S[IP], S[IU] / rho, S[IV] / rho, S[IW] / rho,
        0.5 * (ia + ia_p),
        0.5 * (S[IB] + shift_p(S[IB], -2)),
        0.5 * (ic + ic_p),
    )


def compute_dt(params: RunParams, U: torch.Tensor) -> torch.Tensor:
    """cfl / max(invDt) on a ghosted 3D state (HydroRunBase.cpp:314-426)."""
    if params.problem in ("jet", "Jet"):
        raise NotImplementedError("the jet problem is not ported")
    inv = compute_inv_dt_mhd(params, U) if params.mhd else compute_inv_dt_hydro(params, U)
    return dt_from_inv(params, inv)


def dt_from_inv(params: RunParams, inv: torch.Tensor) -> torch.Tensor:
    """cfl / inv as a true division on the device (``float / tensor`` in
    torch multiplies by the reciprocal instead)."""
    return inv.new_full((), params.cfl) / inv
