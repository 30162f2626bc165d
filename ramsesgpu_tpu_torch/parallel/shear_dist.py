"""Distributed shearing box: the sheared-periodic x borders across ranks
(the port's counterpart of ramsesgpu_tpu/parallel/shear_dist.py:39-265;
reference MHDRunGodunovMpi.cpp:3346-3768, the sheared-y rank lookup with a
pair of MPI_Sendrecv per border, and the distributed flux / emfY remap
kernels kernel_mhd_3d_flux_remapping_xmin/xmax).

- the opposite x border's slab travels between the two domain-edge x
  ranks only (``_edge_swap_x``);
- an ``all_gather`` on the y column's process group assembles its whole
  global y extent, so every edge rank cuts its own sheared window at any
  time t;
- the face Bx of the last interior cell, which the reference keeps in the
  first XMAX ghost column (make_boundary_shear.h:276-288), is rebuilt from
  divB = 0 of that cell, which CT keeps (``fix_xmax_bx_face``).

The JAX package runs every collective on every shard and selects the
edge shards' values with ``where``; here only the ranks that use a value
take part in its messages: the x-edge columns' y gathers and the xmax
column's band exchanges (a y column, a z ring and an x-edge pair each lie
within one x column). Whole-array torch, as in JAX, where all of this is
outside any kernel.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..config.params import RunParams
from ..core.constants import IA, IB, IC, BoundaryConditionType as BCT
from ..ops.slopes import slope_1d
from ..solvers.boundary import _fill_side
from ..solvers.dissipation import _div
from ..solvers.godunov_mhd import _remap_offset
from ..solvers.shear import roll_dynamic
from .halo import attach_halos_axis, exchange
from .mesh import ProcessGrid

_X, _Y, _Z = -1, -2, -3


class ShardedShearComm:
    """The shear remaps of one rank. ``gparams`` carries the GLOBAL grid
    (deltay = 1.5 omega0 Lx t needs the global Lx and Ly)."""

    def __init__(self, gparams: RunParams, local_dims, grid: ProcessGrid):
        self.gp = gparams
        self.lnz, self.lny, self.lnx = local_dims
        self.grid = grid
        ix = grid.index("x")
        self.is_min = ix == 0
        self.is_max = ix == grid.mx - 1

    # -- collectives ------------------------------------------------------ #
    def _edge_swap_x(self, slab_min, slab_max):
        """(to_min, to_max): the x index 0 rank receives slab_max of the
        x index mx-1 rank of its (z, y) row, and that rank slab_min; None
        where this rank is not that edge. One rank across: both are
        local."""
        grid = self.grid
        if grid.mx == 1:
            return slab_max, slab_min
        iz, iy, _ = grid.coords
        ops, to_min, to_max = [], None, None
        if self.is_min:
            peer = grid.rank_of(iz, iy, grid.mx - 1)
            ops.append(dist.P2POp(dist.isend, grid.send_form(slab_min), peer, tag=2))
            to_min = grid.empty_like(slab_max)
            ops.append(dist.P2POp(dist.irecv, to_min, peer, tag=3))
        if self.is_max:
            peer = grid.rank_of(iz, iy, 0)
            ops.append(dist.P2POp(dist.isend, grid.send_form(slab_max), peer, tag=3))
            to_max = grid.empty_like(slab_min)
            ops.append(dist.P2POp(dist.irecv, to_max, peer, tag=2))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return (None if to_min is None else grid.local_form(to_min),
                None if to_max is None else grid.local_form(to_max))

    def _gather_y(self, slab, axis: int):
        """The slab's global-y assembly along ``axis`` over this rank's y
        column (all_gather)."""
        grid = self.grid
        if grid.my == 1:
            return slab
        buf = grid.send_form(slab)
        parts = [torch.empty_like(buf) for _ in range(grid.my)]
        dist.all_gather(parts, buf, group=grid.y_group)
        return grid.local_form(torch.cat(parts, dim=axis))

    def _y_offset(self) -> int:
        return self.grid.index("y") * self.lny

    # -- conservative flux / emfY remap at the domain x faces ------------ #
    def remap_pair(self, f_xmin, f_xmax, t, dt):
        """The distributed _shear_remap_pair (JAX shear_dist.py:69) of
        stacked border fields [k, lnz, lny] (y last): each edge side's
        value becomes the half-sum of its own and the other side's
        interpolated at deltay(t + dt/2); other ranks keep theirs."""
        if not (self.is_min or self.is_max):
            return f_xmin, f_xmax
        jplus, w = _remap_offset(self.gp, t, dt)
        one = torch.ones_like(jplus)
        fmax_here, fmin_here = self._edge_swap_x(f_xmin, f_xmax)
        yo = self._y_offset()

        def local_rows(gbuf, shift):
            return roll_dynamic(gbuf, shift, -1)[..., yo:yo + self.lny]

        new_min, new_max = f_xmin, f_xmax
        if self.is_min:
            G = self._gather_y(fmax_here, -1)
            interp = w * local_rows(G, jplus + one) + (1.0 - w) * local_rows(G, jplus)
            new_min = 0.5 * (f_xmin + interp)
        if self.is_max:
            G = self._gather_y(fmin_here, -1)
            interp = (1.0 - w) * local_rows(G, -jplus) + w * local_rows(G, -(jplus + one))
            new_max = 0.5 * (f_xmax + interp)
        return new_min, new_max

    # -- sheared-periodic ghost fill at the domain x borders -------------- #
    def fill_shear_x(self, Uyg, U_local, t):
        """Overwrite the x ghost columns of the domain-edge ranks of Uyg
        (the local block grown in y and x by the rings) with the sheared
        remap at time t from the opposite border (solvers/shear.py
        semantics with global-y interpolation; JAX shear_dist.py:118).
        ``U_local``: the bare interior block. In place; returns Uyg."""
        if not (self.is_min or self.is_max):
            return Uyg
        gp = self.gp
        g = gp.ghost_width
        dy = gp.dy
        Lx = gp.xmax - gp.xmin
        Ly = gp.ymax - gp.ymin
        deltay = torch.remainder(1.5 * gp.omega0 * Lx * t, Ly)
        jplus = torch.floor(_div(deltay, dy)).to(torch.int64)
        epsi = torch.remainder(deltay, dy)

        bmax_here, bmin_here = self._edge_swap_x(U_local[..., :g], U_local[..., -g:])
        yo = self._y_offset()
        lny2g = self.lny + 2 * g

        def remap(G, base_shift, eps, lam, sign):
            # y-slopes of the global slab: the roll's wrap is the periodic y
            S = slope_1d(gp, G, _Y)

            def rows(shift):
                b = roll_dynamic(G, shift, _Y)
                s = roll_dynamic(S, shift, _Y)
                # a double cover in y, so the ghosted window never runs off
                b = torch.cat([b, b], dim=_Y)[..., yo:yo + lny2g, :]
                s = torch.cat([s, s], dim=_Y)[..., yo:yo + lny2g, :]
                return b, s

            b_r, s_r = rows(-base_shift + g)
            b_rp1, s_rp1 = rows(-base_shift + (g - 1))
            interp = (1.0 - eps) * b_r + eps * b_rp1 + lam * sign * (s_r - s_rp1)
            interp[IB] = b_r[IB] + eps * s_r[IB]   # the conservative face-By form
            return interp

        if self.is_min:
            # XMIN ghosts <- the XMAX border shifted down: source j - jplus - 1
            eps_min = 1.0 - _div(epsi, dy)
            lam_min = 0.5 * eps_min * (eps_min - 1.0)
            G = self._gather_y(bmax_here, _Y)
            Uyg[..., :g] = remap(G, -jplus - 1, eps_min, lam_min, 1.0)
        if self.is_max:
            # XMAX ghosts <- the XMIN border shifted up: source j + jplus
            eps_max = _div(epsi, dy)
            lam_max = 0.5 * eps_max * (eps_max - 1.0)
            G = self._gather_y(bmin_here, _Y)
            Uyg[..., -g:] = remap(G, jplus, eps_max, lam_max, -1.0)
        return Uyg

    def fix_xmax_bx_face(self, Ug):
        """Rebuild, on the xmax ranks, the face Bx of the last interior cell
        (the first XMAX ghost column) from divB = 0 of that cell:
        bx_face = bx_left - dx (dBy/dy + dBz/dz); its y and z ghost bands
        then come from the neighbours' own rebuilds (y first, then z, so
        corners follow). Runs on the fully grown block; in place."""
        if not self.is_max:
            return Ug
        gp = self.gp
        g = gp.ghost_width
        bx_l = Ug[IA, :, :, -g - 1]
        by_c = Ug[IB, :, :, -g - 1]
        by_p = torch.roll(Ug[IB], -1, -2)[:, :, -g - 1]
        bz_c = Ug[IC, :, :, -g - 1]
        bz_p = torch.roll(Ug[IC], -1, -3)[:, :, -g - 1]
        col = bx_l - gp.dx * (_div(by_p - by_c, gp.dy) + _div(bz_p - bz_c, gp.dz))
        # the band exchanges: thin g-wide strips along the y, then z rings
        lo, hi = exchange(self.grid, "y", col[:, -2 * g:-g], col[:, g:2 * g])
        col[:, :g], col[:, -g:] = lo, hi
        lo, hi = exchange(self.grid, "z", col[-2 * g:-g, :], col[g:2 * g, :])
        col[:g, :], col[-g:, :] = lo, hi
        Ug[IA, :, :, -g] = col
        return Ug


def attach_halos_shear(params: RunParams, gparams: RunParams, U: torch.Tensor, t,
                       comm: ShardedShearComm) -> torch.Tensor:
    """The ghosted local block of a shearing-box step (JAX shear_dist.py:
    220): the periodic y ring, the x ring with the sheared remap over the
    domain-edge ghosts, then the z ring, the rebuilt xmax Bx face, and,
    with BC_Z_STRATIFIED, the stratified fill of the z-edge ranks, last,
    with the GLOBAL z bounds (the hydrostatic ratios depend on zmin and
    zmax) and the global dz. ``params``: the local block's."""
    grid = comm.grid
    Ug = attach_halos_axis(params, grid, U, _Y, BCT.BC_PERIODIC, BCT.BC_PERIODIC)
    Ug = attach_halos_axis(params, grid, Ug, _X, BCT.BC_PERIODIC, BCT.BC_PERIODIC)
    Ug = comm.fill_shear_x(Ug, U, t)
    Ug = attach_halos_axis(params, grid, Ug, _Z, BCT.BC_PERIODIC, BCT.BC_PERIODIC)
    Ug = comm.fix_xmax_bx_face(Ug)
    iz, mz = grid.index("z"), grid.mz
    if gparams.boundary_zmin == BCT.BC_Z_STRATIFIED and iz == 0:
        pmin = params.replace(zmin=gparams.zmin, zmax=gparams.zmin + params.nz * gparams.dz)
        _fill_side(pmin, Ug, _Z, False, BCT.BC_Z_STRATIFIED)
    if gparams.boundary_zmax == BCT.BC_Z_STRATIFIED and iz == mz - 1:
        pmax = params.replace(zmin=gparams.zmax - params.nz * gparams.dz, zmax=gparams.zmax)
        _fill_side(pmax, Ug, _Z, True, BCT.BC_Z_STRATIFIED)
    return Ug
