// The explicit viscous and resistive sub-step of 3D MHD, in two modes:
//
// - periodic: the interior-only periodic state, neighbours by index wrap.
//   Replaces the TPU kernels ramsesgpu_tpu/pallas/fused_dissip3d.py:51
//   make_fused_mhd_dissipation (make_pallas_step_fn's second kernel) and
//   the dissipative body of the packed-io shell pallas/fused_mhd3d.py:351-373
//   (the second launch of a dissipative periodic step, :457-463). Plain
//   twin: ramsesgpu_tpu_torch/solvers/dissipation.py
//   mhd_dissipation_periodic_update.
// - shear: the shearing box's interior with its sheared x ghost slabs
//   (shear_border.cu, rebuilt at t + dt from the post-Godunov state); y and
//   z wrap, an x load outside [0, nx) reads a slab. On the stratified box
//   (BC_Z_STRATIFIED z faces, isothermal) a z load outside [0, nz) reads
//   the stratified z ghost slabs instead of wrapping, rebuilt with the x
//   slabs from the post-Godunov state (shear_border.cu SlabBuild; the JAX
//   whole-array step refills every ghost with make_all_boundaries_shear at
//   t + dt before its dissipation, godunov_mhd.py:748-761). Replaces the
//   dissipative sub-step of the TPU's MRI loop, pallas/shear_packed.py:917
//   with the border strip's mode "dissip" (:339-362 of :237, and of the
//   fused strip :432). It also applies the resistive CT to the kept Bx face at x = nx;
//   that face's old value comes from the XMAX slab's first Bx column, never
//   from `kept`, which this kernel writes. Plain twin:
//   mhd_dissipation_shear_update + kept_face_resistive_ct.
// - ghosted (walls, the jet): a ghosted state U[nch][nz+2g][ny+2g][nx+2g]
//   whose ghosts the fill after the Godunov step has written, its new
//   interior into another buffer. Replaces the TPU kernel of the first
//   mode on the ghosted array (fused_mhd3d.py:545-547, the walled step's
//   refill and dissipation). A load outside the interior is a plain offset
//   into the ghost frame, and the CT updates B only on the interior and
//   its max-side face layer (the whole-array step's ct range,
//   godunov_mhd.py:748-761 -> dissipation.py apply_dissipation_mhd), so
//   the fluxes of the cells by a low face read the ghosts' B as filled;
//   the face layer's new B is written beside the interior (the output is
//   the cube 0 .. n of every axis), as the whole-array step updates it.
//   Plain twin: mhd_dissipation_ghosted_update.
//
// The function (JAX solvers/dissipation.py:285 mhd_dissipation_interior_update):
// the resistive EMF -eta J on the edges from the old B; its CT curl on the
// whole extent (B2); the resistive energy flux from B2 (cIso <= 0 only);
// the viscous stress fluxes from rho and the velocities (their energy flux
// with cIso <= 0 only); the interior gains flux[c] - flux[c+1]. nu and eta
// are independent, either may be 0.
//
// Design: one launch, every intermediate in shared memory. Along each
// axis the update of cell c reads the face fluxes at c and c + 1; those
// read rho, the velocities and B2 at c - 1 .. c + 1; B2 reads the EMFs at
// c .. c + 1, and those the old B at c - 1 .. c. So the update of a cell
// needs the state at c - 2 .. c + 3 along each axis. A work item is an
// (x, y) tile of TX x TY columns and a z chunk [z0, z1); a persistent grid
// of blocks (several an SM) walks its items' z planes p = z0 - 2 .. z1 + 2,
// and for each plane runs four phases over the tile's cells and a halo,
// with a block barrier after each:
//   copy     state (p + 1)     columns -2 .. W+1   rho, the momenta and B
//                                                  by cp.async through the
//                                                  load rule, one plane
//                                                  ahead of its use (E and
//                                                  the carries on 0 .. W-1);
//            velocities (p-1)  -1 .. W             (nu > 0), while it lands
//   emf      EMFs (p)          -1 .. W+1           -eta J on the z, y, x
//                                                  edges from the old B
//                                                  (eta > 0)
//   ct       B2 (p - 1)        -1 .. W             B + the CT curl (eta > 0)
//   flux     fluxes (p - 2)    x faces 0 .. W,     an item a cell: its x, y
//                              y and z 0 .. W-1    and z faces' stresses on
//                                                  u, v, w, viscous and
//                                                  resistive energy flux,
//                                                  which share their loads;
//            update (p - 3)    0 .. W-1            then, by the same thread,
//                                                  the cell's new state one
//                                                  plane down into So (its
//                                                  last flux, the +1 z
//                                                  face, just formed); B
//                                                  becomes B2; shear: the
//                                                  kept face
// (rows likewise). Each plane of each phase is computed once per item;
// the halo is computed again by the neighbouring tiles. The state's rho,
// momenta and B are read from device memory once per block, into a ring
// of five planes that the update still reads; E and the Kahan carry only
// at the update's own cells. Each ring keeps the planes its readers need:
// the state 5 (p - 3 .. p + 1), the velocities and B2 3 (p - 3 .. p - 1),
// the EMFs 2 (4 compensated: its update recomputes the CT delta of plane
// p - 3), the fluxes 2 (the update's z faces at p - 3 and p - 2). The
// phases' work items are small (a cell and a component) but for the flux,
// so a block's threads share each phase evenly.
//
// The cell sizes divide most of the arithmetic (the currents, the velocity
// gradients, the fluxes' dt / dh): where a cell size is a power of two, as
// on the usual 2^k grids of a domain of length 2^m, the quotient is formed
// as the product by its exact reciprocal, the same value bit for bit
// (Div). On the H100 an f32 division costs about ten instructions; the
// staged version's sub-step was bound by them.
//
// A block reads the old values of its neighbours' cells, so the sub-step
// cannot update S in place: it writes the new state into So, every
// channel (rho and the carries it leaves unchanged too); an inactive
// sub-step copies S into So. The host build runs the same block body, each
// phase a serial loop (common.cuh block_items), the blocks in turn.
//
// Compensated (S of 16 channels, the state and then its Kahan carry; kept
// [2][nz][ny]): the update collects each channel's whole increment, B's
// being the ct phase's delta recomputed from the EMFs, and makes one Kahan
// add per channel (dissipation.py:357-380); the kept face's resistive CT
// is Kahan-added to its carry.
//
// Rounding: the increment is a difference of nearly equal face fluxes, so
// an FMA the twin does not make moves it by ~1e-6 of its own norm in f32.
// The file is compiled without FMA contraction (kernels/build.py) and keeps
// the twin's op order, so it repeats the twin's roundings; each value is
// the same expression of the same operands as in the staged version it
// replaced, so the new state is that version's bit for bit.
//
// Bound on the H100: bytes. The function reads rho, the momenta, E and B and
// writes the momenta, E and B: 60 B/cell in f32 (52 isothermal: no E),
// 0.30 ms at 256^3 and 0.065 ms at 128x256x128 at 3.35 TB/s, against a few
// hundred flops per cell. The kernel also writes rho (and copies the
// carries it does not change) into So: 4 B/cell more than the bound counts.
// Tiles per dtype (Tile below): f32 16 x 8, 256 threads, three blocks an SM
// (73 KB of rings each, 98 KB compensated: two); f64 16 x 8, 512 threads,
// one block an SM.
#include "common.cuh"

namespace ramses::dissip {

constexpr int SLAB = 3;  // ghost columns of each sheared slab (ghost_width)
// the fields the stages read: rho, the velocities (the momenta in the state
// ring), B (B2 after the ct phase)
enum { W_RHO = 0, W_U, W_V, W_W, W_BX, W_BY, W_BZ, NW };
// the state channel of each field of the state ring
HD int state_channel(int f) {
  return f == W_RHO ? ID : (f < W_BX ? IU + f - W_U : IA + f - W_BX);
}
// per face axis: the stresses on u, v, w, the viscous and the resistive
// energy flux (kept apart: the twin sums the two in another order)
enum { F_U = 0, F_V, F_W, F_EV, F_ER, NF };

// GHOST: the ghosted mode (a filled ghosted state in; its interior and
// its max-side face layer's B out). STRAT: the shear mode on a stratified
// box (z loads outside the interior read the z slabs; isothermal only, as
// the stratified MRI)
template <bool SHEAR_, bool ISO_, bool COMP_, bool GHOST_ = false, bool STRAT_ = false>
struct Mode {
  static constexpr bool SHEAR = SHEAR_;
  static constexpr bool ISO = ISO_;
  static constexpr bool COMP = COMP_;
  static constexpr bool GHOST = GHOST_;
  static constexpr bool STRAT = STRAT_;
  static_assert(!(SHEAR_ && GHOST_), "the ghosted mode has no shearing box");
  static_assert(!STRAT_ || (SHEAR_ && ISO_), "the stratified box is isothermal and sheared");
};

// the coefficients, each formed in double as the JAX package forms its
// Python floats and rounded once to T
template <typename T>
struct Coef {
  T c_norm, c_shear, m_eta;  // -2/3 nu, -nu, -eta
  Div<T> d[3], d4[3];        // / dx, dy, dz and / 4 dx, 4 dy, 4 dz
  bool visc, resist;
};

// the (x, y) tile of a work item, the block's threads and the blocks an SM
// holds (as many as the rings of fit, at most PER_SM), per dtype (measured
// with scripts/torch_ab.py kernels; PERF.md section 6)
template <typename T>
struct Tile;
template <>
struct Tile<float> {
  static constexpr int TX = 16, TY = 8, NT = 256, PER_SM = 3;
};
template <>
struct Tile<double> {
  static constexpr int TX = 16, TY = 8, NT = 512, PER_SM = 1;
};

// a block's rings in shared memory: each [plane slot][field][cell] on its
// own extent, a cell at tile-local (li, lj) at (lj + lo) * width + li + lo
template <typename T, typename M>
struct Ring {
  static constexpr int TX = Tile<T>::TX, TY = Tile<T>::TY, NT = Tile<T>::NT;
  static constexpr int LW = TX + 4, LPP = LW * (TY + 4);  // state: lo 2
  static constexpr int EW = TX + 3, EPP = EW * (TY + 3);  // EMFs: lo 1
  static constexpr int BW = TX + 2, BPP = BW * (TY + 2);  // velocities, B2: lo 1
  static constexpr int FW = TX + 1, FPP = FW * (TY + 1);  // face fluxes: lo 0
  static constexpr int OPP = TX * TY;                      // the tile's own cells
  // a state slot: the stage fields on the state's extent, then E (and,
  // compensated, the eight carries) on the tile's own cells
  static constexpr int NOWN = M::COMP ? 9 : 1;
  static constexpr int SSLOT = NW * LPP + NOWN * OPP;
  // plane slots: state, velocities, EMFs, B2, fluxes
  static constexpr int RS = 5, RV = 3, RE = M::COMP ? 4 : 2, RB = 3, RF = 2;
  static constexpr int NFU = M::ISO ? 3 : 5;  // fluxes a face keeps (no energy: isothermal)
  static constexpr long long OFF_V = (long long)RS * SSLOT;
  static constexpr long long OFF_E = OFF_V + (long long)RV * 3 * BPP;
  static constexpr long long OFF_B = OFF_E + (long long)RE * 3 * EPP;
  static constexpr long long OFF_F = OFF_B + (long long)RB * 3 * BPP;
  static constexpr long long VALUES = OFF_F + (long long)RF * 3 * NFU * FPP;
  static constexpr long long BYTES = VALUES * (long long)sizeof(T);
  // the rings and the 1 KB the runtime keeps per block, in an SM's 228 KB
  static constexpr int FIT = (int)(233472 / (BYTES + 1024));
  static constexpr int PER_SM = Tile<T>::PER_SM < FIT ? Tile<T>::PER_SM : FIT;
  static_assert(BYTES + 1024 <= SMEM_LIMIT, "a block's rings fit an SM's shared memory");
  static_assert(NT % 32 == 0, "whole warps");
};

template <typename T>
struct Args {
  const T* S;      // [nch][n] the state (8 channels, or 16 with the carry);
                   // ghosted: [nch][ng], the ghosted array
  T* So;           // [nch][n] the new state (another buffer); ghosted: [8][oc.n],
                   // the cube 0 .. n of every axis (the interior and its
                   // max-side face layer, whose B the CT updates)
  const T* slabs;  // shear: [2][8][nz][ny][SLAB] sheared x ghosts (XMIN, XMAX)
  const T* zslabs; // stratified: [2][8][SLAB][ny][nx + 2 SLAB] z ghosts (ZMIN, ZMAX)
  T* kept;         // shear: [nz][ny] the kept Bx face (written when eta > 0)
  T* kept_c;       // compensated shear: [nz][ny] the kept face's carry (kept[1])
  const T* dt;     // device scalar
  const unsigned char* active;  // device flag: 0 skips the sub-step (So = S)
  Dims d;          // the interior's
  Dims oc;         // So's: d, or (ghosted) the cube of (nx + 1) (ny + 1) (nz + 1)
  int nch;         // 8, or 16 compensated
  int g;           // ghosted: the ghost width
  long long ng;    // ghosted: the cells of the ghosted array
  Phys<T> ph;
  Coef<T> k;
  int ntx, nty, bz;        // tiles along x and y; depth of a z chunk
  long long items, nblocks;
};

// One stage's fields at a cell of the ring: rho (the state ring), the
// velocities and B2 (their rings), or the old B (the state ring), on the
// planes k - 1, k, k + 1 (base[dk + 1]) around the tile-local (li, lj).
template <typename T, typename M, bool OLD_B>
struct Fields {
  using R = Ring<T, M>;
  const T* state[3];  // the state ring's slots of the three planes
  const T* vel[3];
  const T* b2[3];
  int li, lj;
  HD T w(int f, int di, int dj, int dk) const {
    if (f == W_RHO || (OLD_B && f >= W_BX))
      return state[dk + 1][f * R::LPP + (lj + dj + 2) * R::LW + li + di + 2];
    const int o = (lj + dj + 1) * R::BW + li + di + 1;
    if (f < W_BX) return vel[dk + 1][(f - W_U) * R::BPP + o];
    return b2[dk + 1][(f - W_BX) * R::BPP + o];
  }
};

// the edge current J_f (dissipation.py: jx = bdiff(bz, y) - bdiff(by, z),
// jy = bdiff(bx, z) - bdiff(bz, x), jz = bdiff(by, x) - bdiff(bx, y)) at
// the offset (ox, oy, oz), from the fields' B. Callers pass constant f and
// offsets, so every index folds at compile time.
template <typename T, typename F>
HD T current(const F& p, const Div<T>* d, int f, int ox, int oy, int oz) {
  const int f1 = (f + 1) % 3, f2 = (f + 2) % 3;  // J_f = d_f1 B_f2 - d_f2 B_f1
  return d[f1](p.w(W_BX + f2, ox, oy, oz) -
               p.w(W_BX + f2, ox - (f1 == 0), oy - (f1 == 1), oz - (f1 == 2))) -
         d[f2](p.w(W_BX + f1, ox, oy, oz) -
               p.w(W_BX + f1, ox - (f2 == 0), oy - (f2 == 1), oz - (f2 == 2)));
}

// component f of the CT curl of the resistive EMF at a cell
// (dissipation.py _ct_deltas): ez, ey, ex of the planes k (e0) and k + 1
// (e1), epp a field's values, ew the row width, o the cell's offset
template <typename T>
HD T ct_delta(const T* e0, const T* e1, int epp, int ew, int o, int f, T dtdx, T dtdy,
              T dtdz) {
  const T* ez = e0;
  const T* ey = e0 + epp;
  const T* ex = e0 + 2 * epp;
  if (f == 0) return (ez[o + ew] - ez[o]) * dtdy - (e1[epp + o] - ey[o]) * dtdz;
  if (f == 1) return (e1[2 * epp + o] - ex[o]) * dtdz - (ez[o + 1] - ez[o]) * dtdx;
  return (ey[o + 1] - ey[o]) * dtdx - (ex[o + ew] - ex[o]) * dtdy;
}

// the viscous fluxes at a cell's left face along AX (dissipation.py
// compute_viscosity_fluxes: the stresses on u, v, w and, adiabatic, their
// energy flux) into out[f * stride]. The loops unroll, so every stencil
// offset and array index is a compile-time constant (no local memory).
template <typename T, typename M, int AX, typename F>
HD void face_visc(const F& p, const Coef<T>& k, T dt, T* out, int stride) {
  // field f at the unit offsets s1 e_a1 + s2 e_a2
  auto at = [&](int f, int a1, int s1, int a2 = 0, int s2 = 0) {
    return p.w(f, s1 * (a1 == 0) + s2 * (a2 == 0), s1 * (a1 == 1) + s2 * (a2 == 1),
               s1 * (a1 == 2) + s2 * (a2 == 2));
  };
  // the two transverse axes, ascending
  constexpr int T1 = AX == 0 ? 1 : 0, T2 = AX == 2 ? 1 : 2;
  const T rho_f = T(0.5) * (p.w(W_RHO, 0, 0, 0) + at(W_RHO, AX, -1));
  T vc[3], vm[3], dnorm[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    vc[q] = p.w(W_U + q, 0, 0, 0);
    vm[q] = at(W_U + q, AX, -1);
    dnorm[q] = k.d[AX](vc[q] - vm[q]);
  }
  // _tavg4: the centred difference along t of the face sum f + f[AX-1]
  T dtr[3][3];
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    if (t == AX) continue;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const T gp = at(W_U + q, t, 1) + at(W_U + q, t, 1, AX, -1);
      const T gm = at(W_U + q, t, -1) + at(W_U + q, t, -1, AX, -1);
      dtr[t][q] = k.d4[t](gp - gm);
    }
  }
  const T div_t = dtr[T1][T1] + dtr[T2][T2];
  const T s_n = k.c_norm * rho_f * (T(2) * dnorm[AX] - div_t);
  const T s_1 = k.c_shear * rho_f * (dtr[T1][AX] + dnorm[T1]);
  const T s_2 = k.c_shear * rho_f * (dtr[T2][AX] + dnorm[T2]);
  out[(F_U + AX) * stride] = k.d[AX](s_n * dt);
  out[(F_U + T1) * stride] = k.d[AX](s_1 * dt);
  out[(F_U + T2) * stride] = k.d[AX](s_2 * dt);
  if constexpr (!M::ISO) {
    const T e = T(0.5) * (vc[AX] + vm[AX]) * s_n + T(0.5) * (vc[T1] + vm[T1]) * s_1 +
                T(0.5) * (vc[T2] + vm[T2]) * s_2;
    out[F_EV * stride] = k.d[AX](e * dt);
  }
}

// the resistive energy flux at a cell's left face along AX (dissipation.py
// compute_resistivity_energy_fluxes; adiabatic only) into out[F_ER *
// stride]: -eta (J_a1 B_a2 - J_a2 B_a1) at the face, a1, a2 = AX + 1, AX +
// 2 (mod 3), each current averaged over its two edges on the face (pair),
// each field over the four cells around it (quad)
template <typename T, int AX, typename F>
HD void face_resist(const F& p, const Coef<T>& k, T dt, T* out, int stride) {
  auto at = [&](int f, int a1, int s1, int a2 = 0, int s2 = 0) {
    return p.w(f, s1 * (a1 == 0) + s2 * (a2 == 0), s1 * (a1 == 1) + s2 * (a2 == 1),
               s1 * (a1 == 2) + s2 * (a2 == 2));
  };
  constexpr int A1 = (AX + 1) % 3, A2 = (AX + 2) % 3;
  const T pair1 = T(0.5) * (current(p, k.d, A1, 0, 0, 0) +
                            current(p, k.d, A1, A2 == 0, A2 == 1, A2 == 2));
  const T pair2 = T(0.5) * (current(p, k.d, A2, 0, 0, 0) +
                            current(p, k.d, A2, A1 == 0, A1 == 1, A1 == 2));
  const T quad2 = T(0.25) * (p.w(W_BX + A2, 0, 0, 0) + at(W_BX + A2, AX, -1) +
                             at(W_BX + A2, A2, 1) + at(W_BX + A2, AX, -1, A2, 1));
  const T quad1 = T(0.25) * (p.w(W_BX + A1, 0, 0, 0) + at(W_BX + A1, AX, -1) +
                             at(W_BX + A1, A1, 1) + at(W_BX + A1, AX, -1, A1, 1));
  out[F_ER * stride] = k.d[AX](k.m_eta * (pair1 * quad2 - pair2 * quad1) * dt);
}

// the flux differences of one channel f at a cell, summed in the twin's
// order: d = 0 + (f[c] - f[c+x]) + (f[c] - f[c+y]) + (f[c] - f[c+z])
template <typename T>
HD T flux_sum(const T* fx, const T* fy, const T* fz0, const T* fz1, int o, int fw) {
  T d = T(0);
  d = d + (fx[o] - fx[o + 1]);
  d = d + (fy[o] - fy[o + fw]);
  d = d + (fz0[o] - fz1[o]);
  return d;
}

// a work item: its tile (x0, y0, W x H) and z chunk [z0, z1)
struct Item {
  int x0, y0, z0, z1, W, H;
  template <typename T>
  HD Item(const Args<T>& a, long long item, int tx, int ty) {
    x0 = (int)(item % a.ntx) * tx;
    const long long r = item / a.ntx;
    y0 = (int)(r % a.nty) * ty;
    z0 = (int)(r / a.nty) * a.bz;
    W = a.d.nx - x0 < tx ? a.d.nx - x0 : tx;
    H = a.d.ny - y0 < ty ? a.d.ny - y0 : ty;
    z1 = a.d.nz - z0 < a.bz ? a.d.nz : z0 + a.bz;
  }
};

// One block's sub-step: its work items in turn, their planes streamed
// through the rings (see the design note above). Each phase is a list of
// work items (a cell and a component; in the flux phase a cell, its faces
// and its update), which the block's threads share.
template <typename T, typename M>
struct Body {
  using R = Ring<T, M>;
  static constexpr int NT = R::NT, MIN_BLOCKS = R::PER_SM;
  static constexpr long long BYTES = R::BYTES;
  Args<T> a;

  // the rings' slots of the plane of walk index w (the item's plane z0 - 2
  // has index 0)
  HD static T* state(T* ring, int w) { return ring + (w % R::RS) * R::SSLOT; }
  HD static T* own(T* ring, int w) { return state(ring, w) + NW * R::LPP; }
  HD static T* vel(T* ring, int w) { return ring + R::OFF_V + (w % R::RV) * 3 * R::BPP; }
  HD static T* emf(T* ring, int w) { return ring + R::OFF_E + (w % R::RE) * 3 * R::EPP; }
  HD static T* b2(T* ring, int w) { return ring + R::OFF_B + (w % R::RB) * 3 * R::BPP; }
  HD static T* flux(T* ring, int w, int ax) {
    return ring + R::OFF_F + ((w % R::RF) * 3 + ax) * R::NFU * R::FPP;
  }

  // copy: start the copy of plane k (walk index w) of rho, the momenta and
  // B, columns -2 .. W+1 and rows likewise, through the load rule (an item
  // a cell); and of E (and the carries) on the tile's own cells when the
  // item updates plane k
  HD void load(const Item& it, int k, int w, T* ring) const {
    const Dims& d = a.d;
    T* dst = state(ring, w);
    const int kk = M::GHOST || M::STRAT ? k : wrap_any(k, d.nz);
    const bool mine = k >= it.z0 && k < it.z1;
    block_items(R::LPP, [&](int t) {
      const int li = t % R::LW - 2, lj = t / R::LW - 2;
      if (li > it.W + 1 || lj > it.H + 1) return;
      const int i = it.x0 + li, j = M::GHOST ? it.y0 + lj : wrap_any(it.y0 + lj, d.ny);
      const T* src;
      long long stride;
      if constexpr (M::GHOST) {
        // a plain offset into the ghost frame (the fill wrote it)
        stride = a.ng;
        src = a.S + ((long long)(kk + a.g) * (d.ny + 2 * a.g) + (j + a.g)) * (d.nx + 2 * a.g) +
              i + a.g;
      } else if (M::STRAT && (kk < 0 || kk >= d.nz)) {
        // a stratified z slab: ZMIN's rows -3 .. -1, ZMAX's nz .. nz + 2,
        // each on the columns -3 .. nx + 2 (the x slabs' too)
        const int side = kk < 0 ? 0 : 1, row = kk < 0 ? kk + SLAB : kk - d.nz;
        stride = (long long)SLAB * d.ny * (d.nx + 2 * SLAB);
        src = a.zslabs + (((long long)side * 8 * SLAB + row) * d.ny + j) * (d.nx + 2 * SLAB) + i +
              SLAB;
      } else if (M::SHEAR && (i < 0 || i >= d.nx)) {
        // a sheared slab: XMIN's columns -3 .. -1, XMAX's nx .. nx + 2
        const int side = i < 0 ? 0 : 1, col = i < 0 ? i + SLAB : i - d.nx;
        stride = (long long)d.nz * d.ny * SLAB;
        src = a.slabs + (((long long)side * 8 * d.nz + kk) * d.ny + j) * SLAB + col;
      } else {
        stride = d.n;
        src = a.S + cell_at(d, M::SHEAR ? i : wrap_any(i, d.nx), j, kk);
      }
#pragma unroll
      for (int f = 0; f < NW; ++f)
        copy_async(dst + f * R::LPP + t, src + state_channel(f) * stride);
      if (mine && li >= 0 && li < it.W && lj >= 0 && lj < it.H) {
        // E, then the carries of channels 0-7
        T* own = dst + NW * R::LPP + lj * R::TX + li;
        const long long chs = M::GHOST ? a.ng : d.n;
        copy_async(own, src + IP * chs);
#pragma unroll
        for (int f = 1; f < R::NOWN; ++f) copy_async(own + f * R::OPP, src + (8 + f - 1) * chs);
      }
    });
  }

  // the velocities of plane p - 1 (walk index w - 1), whose state copy
  // landed in the plane before; an item a cell and a component
  HD void velocities(const Item& it, int w, T* ring) const {
    const T* s = state(ring, w - 1);
    T* v = vel(ring, w - 1);
    block_items(3 * R::BPP, [&](int t) {
      const int q = t / R::BPP, o = t % R::BPP;
      const int li = o % R::BW - 1, lj = o / R::BW - 1;
      if (li > it.W || lj > it.H) return;
      const T* c = s + (lj + 2) * R::LW + li + 2;
      v[t] = c[(W_U + q) * R::LPP] / c[W_RHO * R::LPP];
    });
  }

  // emf: the EMFs of plane p (walk index w, from the old B of p - 1 and p);
  // an item a cell and a component
  HD void emfs(const Item& it, int w, T* ring) const {
    const Coef<T>& k = a.k;
    const T* s0 = state(ring, w - 1);
    const T* s1 = state(ring, w);
    T* e = emf(ring, w);
    block_items(3 * R::EPP, [&](int t) {
      // -eta J at the edges (i, j-1/2, k-1/2) for x, (i-1/2, j, k-1/2) for
      // y, (i-1/2, j-1/2, k) for z (dissipation.py compute_resistivity_emf):
      // e[0] the z edge's, e[1] y, e[2] x
      const int g = t / R::EPP, o = t % R::EPP;
      const int li = o % R::EW - 1, lj = o / R::EW - 1;
      if (li > it.W + 1 || lj > it.H + 1) return;
      const Fields<T, M, true> p{{s0, s1, nullptr}, {}, {}, li, lj};
      // (a constant component in each branch: every index folds)
      if (g == 0)
        e[t] = k.m_eta * current(p, k.d, 2, 0, 0, 0);
      else if (g == 1)
        e[t] = k.m_eta * current(p, k.d, 1, 0, 0, 0);
      else
        e[t] = k.m_eta * current(p, k.d, 0, 0, 0, 0);
    });
  }

  // ct: B2 of plane p - 1 (walk index w - 1): its old B plus the CT curl of
  // the EMFs of p - 1 and p; an item a cell and a component. Ghosted: the
  // curl only on the interior and its max-side face layer (the cube 0 ..
  // n of every axis, the whole-array step's ct range); elsewhere B2 is the
  // old B, as the fill left it
  HD void ct(const Item& it, int w, T dtdx, T dtdy, T dtdz, T* ring) const {
    const T* s = state(ring, w - 1);
    const T* e0 = emf(ring, w - 1);
    const T* e1 = emf(ring, w);
    T* b = b2(ring, w - 1);
    const int k = it.z0 + w - 3;
    const bool k_in = !M::GHOST || (k >= 0 && k <= a.d.nz);
    block_items(3 * R::BPP, [&](int t) {
      const int f = t / R::BPP, o = t % R::BPP;
      const int li = o % R::BW - 1, lj = o / R::BW - 1;
      if (li > it.W || lj > it.H) return;
      const T old = s[(W_BX + f) * R::LPP + (lj + 2) * R::LW + li + 2];
      if constexpr (M::GHOST) {
        const int i = it.x0 + li, j = it.y0 + lj;
        if (!k_in || i < 0 || i > a.d.nx || j < 0 || j > a.d.ny) {
          b[t] = old;
          return;
        }
      }
      b[t] = old + ct_delta(e0, e1, R::EPP, R::EW, (lj + 1) * R::EW + li + 1, f, dtdx, dtdy, dtdz);
      if constexpr (M::GHOST) {
        // the face layer (i, j or k = n): written by the item that owns
        // its column, row and plane (the last tile or chunk for n itself)
        const int i = it.x0 + li, j = it.y0 + lj;
        const bool own_x = li >= 0 && (li < it.W || i == a.d.nx);
        const bool own_y = lj >= 0 && (lj < it.H || j == a.d.ny);
        const bool own_z = (k >= it.z0 && k < it.z1) || (k == a.d.nz && it.z1 == a.d.nz);
        if ((i == a.d.nx || j == a.d.ny || k == a.d.nz) && own_x && own_y && own_z)
          a.So[(IA + f) * a.oc.n + cell_at(a.oc, i, j, k)] = b[t];
      }
    });
  }

  // flux: the faces of plane k (walk index w), an item a cell of the (W +
  // 1) x (H + 1) face extent, which forms its x, y and z faces together (xy;
  // else its z face alone), viscous then resistive, so they share their
  // loads, and stores those the cell owns: x faces 0 .. W by 0 .. H-1, y
  // faces 0 .. W-1 by 0 .. H, z faces 0 .. W-1 by 0 .. H-1 (a face outside
  // those reads ring cells no phase wrote for it, and is dropped). upd: the
  // cell then updates itself on plane k - 1 (walk index w - 1), whose last
  // flux, its +1 z face, it has just formed.
  HD void fluxes(const Item& it, int w, bool xy, bool upd, T dt, T dtdx, T dtdy, T dtdz,
                 T* ring) const {
    const Coef<T>& k = a.k;
    const Fields<T, M, false> base{{state(ring, w - 1), state(ring, w), state(ring, w + 1)},
                                   {vel(ring, w - 1), vel(ring, w), vel(ring, w + 1)},
                                   {b2(ring, w - 1), b2(ring, w), b2(ring, w + 1)}, 0, 0};
    T* fx = flux(ring, w, 0);
    T* fy = flux(ring, w, 1);
    T* fz = flux(ring, w, 2);
    block_items(R::FPP, [&](int t) {
      const int li = t % R::FW, lj = t / R::FW;
      if (li > it.W || lj > it.H) return;
      const bool in_x = li < it.W, in_y = lj < it.H;
      if (!xy && !(in_x && in_y)) return;
      Fields<T, M, false> p = base;
      p.li = li;
      p.lj = lj;
      // the faces' fluxes in registers, then the owned ones stored
      T ox[NF], oy[NF], oz[NF];
      const int o = lj * R::FW + li;
      auto put = [&](int f) {  // (f constant at every call: the arrays stay registers)
        if (xy && in_y) fx[f * R::FPP + o] = ox[f];
        if (xy && in_x) fy[f * R::FPP + o] = oy[f];
        if (in_x && in_y) fz[f * R::FPP + o] = oz[f];
      };
      if (k.visc) {
        if (xy) {
          face_visc<T, M, 0>(p, k, dt, ox, 1);
          face_visc<T, M, 1>(p, k, dt, oy, 1);
        }
        face_visc<T, M, 2>(p, k, dt, oz, 1);
        put(F_U);
        put(F_V);
        put(F_W);
        if constexpr (!M::ISO) put(F_EV);
      }
      if constexpr (!M::ISO) {
        if (k.resist) {
          if (xy) {
            face_resist<T, 0>(p, k, dt, ox, 1);
            face_resist<T, 1>(p, k, dt, oy, 1);
          }
          face_resist<T, 2>(p, k, dt, oz, 1);
          put(F_ER);
        }
      }
      if (upd && in_x && in_y)
        for (int ch = 0; ch < 8; ++ch)
          update_value(it, it.z0 + w - 3, w - 1, ch, li, lj, dtdx, dtdy, dtdz, ring);
    });
  }

  // update: channel ch of the new state of plane k (walk index w) at the
  // tile-local cell (li, lj), into So. E and the momenta gain their flux
  // differences in the twin's order (resistive x, y, z, then viscous x, y,
  // z), B becomes B2; compensated, each changed channel Kahan-adds its
  // increment (B's the CT delta, recomputed from the EMFs) against its
  // carry; every other channel is copied. Shear: Bx's last column also
  // writes the kept face.
  HD void update_value(const Item& it, int k, int w, int ch, int li, int lj, T dtdx, T dtdy,
                       T dtdz, T* ring) const {
    const Coef<T>& kc = a.k;
    const Dims& d = M::GHOST ? a.oc : a.d;  // So's
    const long long n = d.n;
    const T* s = state(ring, w);
    const T* ow = own(ring, w);
    const T* fx = flux(ring, w, 0);
    const T* fy = flux(ring, w, 1);
    const T* fz0 = flux(ring, w, 2);
    const T* fz1 = flux(ring, w + 1, 2);
    const int oc = lj * R::TX + li;
    const long long c = cell_at(d, it.x0 + li, it.y0 + lj, k);
    const int so = (lj + 2) * R::LW + li + 2, fo = lj * R::FW + li;
    auto diff = [&](int f) {
      return flux_sum(fx + f * R::FPP, fy + f * R::FPP, fz0 + f * R::FPP, fz1 + f * R::FPP,
                      fo, R::FW);
    };
    T u, uc;  // the channel's new value and, compensated, its carry
    if constexpr (M::COMP) uc = ow[(1 + ch) * R::OPP + oc];
    if (ch == ID) {
      u = s[W_RHO * R::LPP + so];
    } else if (ch == IP) {
      // E: resistive then viscous differences along x, y, z
      u = ow[oc];
      if (!M::ISO && (kc.visc || kc.resist)) {
        T dE = T(0);
        if (kc.resist) {
          dE = dE + (fx[F_ER * R::FPP + fo] - fx[F_ER * R::FPP + fo + 1]);
          dE = dE + (fy[F_ER * R::FPP + fo] - fy[F_ER * R::FPP + fo + R::FW]);
          dE = dE + (fz0[F_ER * R::FPP + fo] - fz1[F_ER * R::FPP + fo]);
        }
        if (kc.visc) {
          dE = dE + (fx[F_EV * R::FPP + fo] - fx[F_EV * R::FPP + fo + 1]);
          dE = dE + (fy[F_EV * R::FPP + fo] - fy[F_EV * R::FPP + fo + R::FW]);
          dE = dE + (fz0[F_EV * R::FPP + fo] - fz1[F_EV * R::FPP + fo]);
        }
        if constexpr (M::COMP)
          kahan_add(u, uc, dE);
        else
          u = u + dE;
      }
    } else if (ch < IA) {
      const int q = ch - IU;
      u = s[(W_U + q) * R::LPP + so];
      if (kc.visc) {
        if constexpr (M::COMP)
          kahan_add(u, uc, diff(F_U + q));
        else
          u = u + diff(F_U + q);
      }
    } else {
      const int f = ch - IA, eo = (lj + 1) * R::EW + li + 1;
      const int bo = (lj + 1) * R::BW + li + 1;
      const T* e0 = emf(ring, w);
      const T* e1 = emf(ring, w + 1);
      const T* bn = b2(ring, w);
      u = s[(W_BX + f) * R::LPP + so];
      if (kc.resist) {
        if constexpr (M::COMP)
          kahan_add(u, uc, ct_delta(e0, e1, R::EPP, R::EW, eo, f, dtdx, dtdy, dtdz));
        else
          u = bn[f * R::BPP + bo];
      }
      if constexpr (M::SHEAR) {
        // the kept face x = nx: B2's column nx, whose old value is the XMAX
        // slab's first Bx column (compensated: that value Kahan-added its
        // CT delta against the face's carry)
        if (f == 0 && kc.resist && it.x0 + it.W == d.nx && li == it.W - 1) {
          const long long r = (long long)k * d.ny + it.y0 + lj;
          if constexpr (M::COMP) {
            T kf = s[W_BX * R::LPP + so + 1];
            kahan_add(kf, a.kept_c[r],
                      ct_delta(e0, e1, R::EPP, R::EW, eo + 1, 0, dtdx, dtdy, dtdz));
            a.kept[r] = kf;
          } else {
            a.kept[r] = bn[bo + 1];
          }
        }
      }
    }
    a.So[ch * n + c] = u;
    if constexpr (M::COMP) a.So[(8 + ch) * n + c] = uc;
  }

  // update: the new state of plane k (walk index w), an item a cell and a
  // channel (where no flux phase takes it: the isothermal resistive-only
  // sub-step)
  HD void update(const Item& it, int k, int w, T dtdx, T dtdy, T dtdz, T* ring) const {
    block_items(8 * R::OPP, [&](int t) {
      const int ch = t / R::OPP, oc = t % R::OPP, li = oc % R::TX, lj = oc / R::TX;
      if (li >= it.W || lj >= it.H) return;
      update_value(it, k, w, ch, li, lj, dtdx, dtdy, dtdz, ring);
    });
  }

  // the skipped sub-step: So = S (ghosted: S on So's cube), every
  // channel, the blocks striding over the values
  HD void copy(long long block) const {
    const long long total = (long long)a.nch * a.oc.n, stride = a.nblocks * NT;
    block_items(NT, [&](int tid) {
      for (long long t = block * NT + tid; t < total; t += stride) {
        if constexpr (M::GHOST) {
          const long long ch = t / a.oc.n;
          int i, j, k;
          cell_ijk(a.oc, t - ch * a.oc.n, i, j, k);
          a.So[t] = a.S[ch * a.ng + ((long long)(k + a.g) * (a.d.ny + 2 * a.g) + (j + a.g)) *
                                        (a.d.nx + 2 * a.g) + i + a.g];
        } else {
          a.So[t] = a.S[t];
        }
      }
    });
  }

  // one plane p of an item (walk index w = p - z0 + 2): the copy of p + 1
  // with the velocities of p - 1 beside it, then the emf, ct and flux
  // phases of the planes behind (the flux with the update). clk
  // (RAMSES_ZCARRY_CLOCKS builds): the cycles of each phase, its barrier
  // included: 0 the wait for free slots, 1 the copy's issue, the
  // velocities and the copy's wait, 2 emf, 3 ct, 4 flux and update
  HD void plane(const Item& it, int p, T dt, T dtdx, T dtdy, T dtdz, T* ring,
                Clocks& clk) const {
    const Coef<T>& k = a.k;
    const int w = p - it.z0 + 2;
    block_sync();  // the slots this plane's copy overwrites are read no more
    clk.lap(0);
    if (w == 0) {
      load(it, p, w, ring);
      copy_async_commit();
    }
    const bool ahead = p + 1 <= it.z1 + 2;
    if (ahead) {
      load(it, p + 1, w + 1, ring);
      copy_async_commit();
    }
    if (w >= 1 && k.visc) velocities(it, w, ring);
    if (ahead)
      copy_async_wait_prior();  // plane p's copy is done, p + 1's may run on
    else
      copy_async_wait();
    block_sync();
    clk.lap(1);
    if (w >= 1 && k.resist) {
      emfs(it, w, ring);
      block_sync();
    }
    clk.lap(2);
    if (k.resist && p >= it.z0) {
      ct(it, w, dtdx, dtdy, dtdz, ring);
      block_sync();
    }
    clk.lap(3);
    const bool upd = p >= it.z0 + 3;  // the update of plane p - 3
    if ((k.visc || (k.resist && !M::ISO)) && p >= it.z0 + 2)
      fluxes(it, w - 2, p - 2 < it.z1, upd, dt, dtdx, dtdy, dtdz, ring);
    else if (upd)
      update(it, p - 3, w - 3, dtdx, dtdy, dtdz, ring);
    clk.lap(4);
  }

  HD void operator()(long long block, T* ring) const {
    if (!*a.active) {
      copy(block);
      return;
    }
    const T dt = *a.dt;
    const T dtdx = dt / a.ph.dx, dtdy = dt / a.ph.dy, dtdz = dt / a.ph.dz;
    Clocks clk;
    clk.lap(-1);
    long long planes = 0;
    for (long long item = block; item < a.items; item += a.nblocks) {
      const Item it(a, item, R::TX, R::TY);
      for (int p = it.z0 - 2; p <= it.z1 + 2; ++p, ++planes)
        plane(it, p, dt, dtdx, dtdy, dtdz, ring, clk);
    }
#if defined(RAMSES_ZCARRY_CLOCKS) && defined(__CUDA_ARCH__)
    if (block == 0 && threadIdx.x == 0)
      printf("[clocks] dissip_step block 0, thread 0: %lld planes; cycles: wait for free "
             "slots %lld; copy issue, velocities and wait %lld; emf %lld; ct %lld; flux and "
             "update %lld\n", planes, clk.t[0], clk.t[1], clk.t[2], clk.t[3], clk.t[4]);
#else
    (void)planes;
#endif
  }
};

template <typename T>
Coef<T> make_coef(const double* prm) {
  Coef<T> k;
  const double nu = prm[P_NU], eta = prm[P_ETA];
  k.c_norm = T(-(2.0 / 3.0) * nu);
  k.c_shear = T(-nu);
  k.m_eta = T(-eta);
  const double dh[3] = {prm[P_DX], prm[P_DY], prm[P_DZ]};
  for (int i = 0; i < 3; ++i) {
    k.d[i] = make_div<T>(dh[i]);
    k.d4[i] = make_div<T>(4.0 * dh[i]);
  }
  k.visc = nu > 0.0;
  k.resist = eta > 0.0;
  return k;
}

#ifdef __CUDACC__
// blocks of F an SM holds at once, times the SMs: the persistent grid
template <typename T, typename F>
int resident_blocks(int* blocks) {
  int per_sm = 0, dev = 0, sms = 0;
  int err = (int)cudaFuncSetAttribute(for_each_block<T, F>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)F::BYTES);
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, for_each_block<T, F>,
                                                            F::NT, F::BYTES);
  if (!err) err = (int)cudaGetDevice(&dev);
  if (!err) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *blocks = per_sm * sms;
  return err;
}
#endif

// comp: S and So hold 16 channels (the state, then its carry) and, shear,
// kept two planes (the face, then its carry); ghosted: S the ghosted array
// of ghost width g, So the cube 0 .. n of every axis
template <typename T, typename M>
int dissip_step(const T* S, T* So, const T* slabs, T* kept, const T* dt,
                const unsigned char* active, int nx, int ny, int nz, const double* prm,
                void* stream, int g = 0, const T* zslabs = nullptr) {
  using R = Ring<T, M>;
  Body<T, M> body;
  Args<T>& a = body.a;
  a.S = S;
  a.So = So;
  a.slabs = slabs;
  a.zslabs = zslabs;
  a.kept = kept;
  a.kept_c = M::COMP && kept ? kept + (long long)ny * nz : nullptr;
  a.dt = dt;
  a.active = active;
  a.d = make_dims(nx, ny, nz);
  a.nch = M::COMP ? 16 : 8;
  a.g = g;
  a.ng = (long long)(nx + 2 * g) * (ny + 2 * g) * (nz + 2 * g);
  a.oc = M::GHOST ? make_dims(nx + 1, ny + 1, nz + 1) : a.d;
  a.ph = make_phys<T>(prm);
  a.k = make_coef<T>(prm);
  int blocks = 3;  // the host build: the serial blocks stride as the card's do
#ifdef __CUDACC__
  if (int err = resident_blocks<T, Body<T, M>>(&blocks)) return err;
#endif
  a.ntx = (nx + R::TX - 1) / R::TX;
  a.nty = (ny + R::TY - 1) / R::TY;
  const long long tiles = (long long)a.ntx * a.nty;
  const int nzc = pick_z_chunks(tiles, blocks, nz);
  a.bz = (nz + nzc - 1) / nzc;
  a.items = tiles * ((nz + a.bz - 1) / a.bz);
  a.nblocks = blocks;
  return launch_blocks<T>(body, blocks, stream);
}

// the isothermal instantiation for cIso > 0 (no energy terms at all)
template <typename T, bool SHEAR, bool COMP>
int dispatch(const T* S, T* So, const T* slabs, T* kept, const T* dt,
             const unsigned char* active, int nx, int ny, int nz, const double* prm,
             void* stream) {
  if (prm[P_CISO] > 0.0)
    return dissip_step<T, Mode<SHEAR, true, COMP>>(S, So, slabs, kept, dt, active, nx, ny, nz,
                                                   prm, stream);
  return dissip_step<T, Mode<SHEAR, false, COMP>>(S, So, slabs, kept, dt, active, nx, ny, nz,
                                                  prm, stream);
}

// the ghosted mode: U [8][nz+2g][ny+2g][nx+2g] (g >= 3: the stencil reads
// 2 cells beyond the interior in x and y and 3 in z), out [8] over the cube
// (nz+1) x (ny+1) x (nx+1): every channel of the interior, and B of the
// max-side face layer where eta > 0. Plain only: the walled step, as the
// JAX package's, has no compensated form.
template <typename T>
int dissip_ghosted_entry(const T* U, T* out, const T* dt, const unsigned char* active, int nx,
                         int ny, int nz, int g, const double* prm, void* stream) {
  if (g < 3) return 1;  // cudaErrorInvalidValue
  if (prm[P_CISO] > 0.0)
    return dissip_step<T, Mode<false, true, false, true>>(U, out, nullptr, nullptr, dt, active,
                                                          nx, ny, nz, prm, stream, g);
  return dissip_step<T, Mode<false, false, false, true>>(U, out, nullptr, nullptr, dt, active,
                                                         nx, ny, nz, prm, stream, g);
}

// zslabs (stratified; slabs given, isothermal) or null
template <typename T>
int dissip_entry(const T* S, T* So, const T* slabs, T* kept, const T* zslabs, const T* dt,
                 const unsigned char* active, int comp, int nx, int ny, int nz,
                 const double* prm, void* stream) {
  if (zslabs) {
    if (!slabs || !(prm[P_CISO] > 0.0)) return 1;  // cudaErrorInvalidValue
    if (comp)
      return dissip_step<T, Mode<true, true, true, false, true>>(
          S, So, slabs, kept, dt, active, nx, ny, nz, prm, stream, 0, zslabs);
    return dissip_step<T, Mode<true, true, false, false, true>>(
        S, So, slabs, kept, dt, active, nx, ny, nz, prm, stream, 0, zslabs);
  }
  if (slabs && comp)
    return dispatch<T, true, true>(S, So, slabs, kept, dt, active, nx, ny, nz, prm, stream);
  if (slabs)
    return dispatch<T, true, false>(S, So, slabs, kept, dt, active, nx, ny, nz, prm, stream);
  if (comp)
    return dispatch<T, false, true>(S, So, nullptr, nullptr, dt, active, nx, ny, nz, prm,
                                    stream);
  return dispatch<T, false, false>(S, So, nullptr, nullptr, dt, active, nx, ny, nz, prm,
                                   stream);
}

}  // namespace ramses::dissip

extern "C" {

// the launch of a mode: out[0..5] = the tile's TX and TY, the threads and
// the ring bytes of a block, the registers of a thread and the blocks an
// SM holds (the host build: 0, 0)
int ramses_dissip_step_launch(int f64, int shear, int iso, int comp, long long* out) {
  using namespace ramses::dissip;
  auto launch = [&](auto t, auto m) {
    using T = decltype(t);
    using M = decltype(m);
    using R = Ring<T, M>;
    out[0] = R::TX;
    out[1] = R::TY;
    out[2] = R::NT;
    out[3] = R::BYTES;
    out[4] = out[5] = 0;
#ifdef __CUDACC__
    cudaFuncAttributes fa;
    int per_sm = 0;
    int err = (int)cudaFuncGetAttributes(&fa, ramses::for_each_block<T, Body<T, M>>);
    if (!err) err = resident_blocks<T, Body<T, M>>(&per_sm);
    int dev = 0, sms = 1;
    if (!err) err = (int)cudaGetDevice(&dev);
    if (!err) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err) return err;
    out[4] = fa.numRegs;
    out[5] = per_sm / sms;
#endif
    return 0;
  };
  auto modes = [&](auto t) {
    if (shear)
      return iso ? (comp ? launch(t, Mode<true, true, true>{})
                         : launch(t, Mode<true, true, false>{}))
                 : (comp ? launch(t, Mode<true, false, true>{})
                         : launch(t, Mode<true, false, false>{}));
    return iso ? (comp ? launch(t, Mode<false, true, true>{})
                       : launch(t, Mode<false, true, false>{}))
               : (comp ? launch(t, Mode<false, false, true>{})
                       : launch(t, Mode<false, false, false>{}));
  };
  return f64 ? modes(0.0) : modes(0.0f);
}

// either mode (shear: slabs [2][8][nz][ny][3] and kept given, else null);
// comp: S and So hold 16 channels (the state, then its carry) and kept two
// planes. S is read, So (another buffer) written whole.
int ramses_dissip_step_f32(const float* S, float* So, const float* slabs, float* kept,
                           const float* dt, const unsigned char* active, int comp, int nx,
                           int ny, int nz, const double* prm, void* stream) {
  return ramses::dissip::dissip_entry<float>(S, So, slabs, kept, nullptr, dt, active, comp, nx,
                                             ny, nz, prm, stream);
}

int ramses_dissip_step_f64(const double* S, double* So, const double* slabs, double* kept,
                           const double* dt, const unsigned char* active, int comp, int nx,
                           int ny, int nz, const double* prm, void* stream) {
  return ramses::dissip::dissip_entry<double>(S, So, slabs, kept, nullptr, dt, active, comp, nx,
                                              ny, nz, prm, stream);
}

// the shear mode on a stratified box (isothermal): as above with the
// stratified z ghost slabs zslabs [2][8][3][ny][nx + 6] of the block
// [XMIN slab | S | XMAX slab] beside it
int ramses_dissip_step_strat_f32(const float* S, float* So, const float* slabs, float* kept,
                                 const float* zslabs, const float* dt,
                                 const unsigned char* active, int comp, int nx, int ny, int nz,
                                 const double* prm, void* stream) {
  if (zslabs == nullptr) return 1;  // cudaErrorInvalidValue
  return ramses::dissip::dissip_entry<float>(S, So, slabs, kept, zslabs, dt, active, comp, nx,
                                             ny, nz, prm, stream);
}

int ramses_dissip_step_strat_f64(const double* S, double* So, const double* slabs, double* kept,
                                 const double* zslabs, const double* dt,
                                 const unsigned char* active, int comp, int nx, int ny, int nz,
                                 const double* prm, void* stream) {
  if (zslabs == nullptr) return 1;  // cudaErrorInvalidValue
  return ramses::dissip::dissip_entry<double>(S, So, slabs, kept, zslabs, dt, active, comp, nx,
                                              ny, nz, prm, stream);
}

// the ghosted mode (walls, the jet): U [8][nz+2g][ny+2g][nx+2g], its
// ghosts filled, is read; out [8][nz+1][ny+1][nx+1] (another buffer) gets
// the new interior and, where eta > 0, the new B of the max-side face layer
// (its other channels there are not written)
int ramses_dissip_step_ghosted_f32(const float* U, float* out, const float* dt,
                                   const unsigned char* active, int nx, int ny, int nz, int g,
                                   const double* prm, void* stream) {
  return ramses::dissip::dissip_ghosted_entry<float>(U, out, dt, active, nx, ny, nz, g, prm,
                                                     stream);
}

int ramses_dissip_step_ghosted_f64(const double* U, double* out, const double* dt,
                                   const unsigned char* active, int nx, int ny, int nz, int g,
                                   const double* prm, void* stream) {
  return ramses::dissip::dissip_ghosted_entry<double>(U, out, dt, active, nx, ny, nz, g, prm,
                                                      stream);
}

}  // extern "C"

#ifdef RAMSES_COUNT_OPS
#include <type_traits>

namespace ramses::dissip {

// fields of constant value: the operations of the per-cell functions do
// not depend on the values
struct CountFields {
  HD Counted w(int, int, int, int) const { return Counted(1.0); }
};

// the operations of one call as the sub-step needs them (op_count.cuh):
// each phase's per-cell function once, times the cells it is needed on:
// periodic, every cell; shear, the EMFs on columns -1..nx+1, the
// velocities and B2 on -1..nx, the x faces 0..nx and the y and z faces
// 0..nx-1 (stratified: the same rows in z, the z faces 0..nz); the update
// on the state (and, with eta, the kept face). The tiles' halo
// recomputation is the kernel's cost, not the function's.
template <typename M>
long long count_ops(int nx, int ny, int nz, const double* prm, double dt) {
  const Coef<Counted> k = make_coef<Counted>(prm);
  const Phys<Counted> ph = make_phys<Counted>(prm);
  const long long plane = (long long)ny * nz, n = plane * nx;
  const long long x_emf = M::SHEAR ? nx + 3 : nx, x_b2 = M::SHEAR ? nx + 2 : nx;
  const long long x_face = M::SHEAR ? nx + 1 : nx;
  // the z rows of the EMFs, B2 and the velocities, and the z faces
  // (stratified: the extra rows as in x)
  const long long z_emf = M::STRAT ? nz + 3 : nz, z_b2 = M::STRAT ? nz + 2 : nz;
  const long long z_face = M::STRAT ? nz + 1 : nz;
  const CountFields p;
  const Counted dtc(dt), one(1.0);
  long long ops = 0;
  auto count = [&](long long cells, const auto& f) {
    const long long before = Counted::ops;
    f();
    ops += cells * (Counted::ops - before);
  };
  const Counted dtdx = dtc / ph.dx, dtdy = dtc / ph.dy, dtdz = dtc / ph.dz;
  Counted e[3 * 2 + 2] = {one, one, one, one, one, one, one, one};
  Counted out[NF];
  if (k.resist) {
    count(x_emf * ny * z_emf, [&] {
      for (int f = 0; f < 3; ++f) out[f] = k.m_eta * current(p, k.d, f, 0, 0, 0);
    });
    count(x_b2 * ny * z_b2, [&] {
      for (int f = 0; f < 3; ++f) out[f] = one + ct_delta(e, e + 1, 2, 1, 0, f, dtdx, dtdy, dtdz);
    });
  }
  if (k.visc) count(x_b2 * ny * z_b2, [&] {
    for (int q = 0; q < 3; ++q) out[q] = one / one;
  });
  if (k.visc || (k.resist && !M::ISO)) {
    auto faces = [&](auto axis) {
      constexpr int AX = decltype(axis)::value;
      if (k.visc) face_visc<Counted, M, AX>(p, k, dtc, out, 1);
      if constexpr (!M::ISO)
        if (k.resist) face_resist<Counted, AX>(p, k, dtc, out, 1);
    };
    count(x_face * plane, [&] { faces(std::integral_constant<int, 0>{}); });
    count(n, [&] { faces(std::integral_constant<int, 1>{}); });
    count((long long)nx * ny * z_face, [&] { faces(std::integral_constant<int, 2>{}); });
  }
  // the update: the flux differences and their adds (Kahan: four
  // operations each), B's CT delta again when compensated
  const Counted f[2] = {one, one};
  count(n, [&] {
    Counted u = one, c = one;
    auto add = [&](Counted d) {
      if (M::COMP)
        kahan_add(u, c, d);
      else
        u = u + d;
    };
    if (!M::ISO && (k.visc || k.resist)) {
      Counted dE = Counted(0.0);  // a difference and an add per face pair and flux
      for (int t = 0; t < 3 * (k.resist + k.visc); ++t) dE = dE + (one - one);
      add(dE);
    }
    if (k.visc)
      for (int q = 0; q < 3; ++q) add(flux_sum(f, f, f, f, 0, 0));
    if (M::COMP && k.resist)
      for (int q = 0; q < 3; ++q) add(ct_delta(e, e + 1, 2, 1, 0, q, dtdx, dtdy, dtdz));
  });
  if (M::SHEAR && k.resist) count(plane, [&] {
    Counted kf = one, kc = one;
    if (M::COMP) kahan_add(kf, kc, ct_delta(e, e + 1, 2, 1, 0, 0, dtdx, dtdy, dtdz));
  });
  return ops;
}

// (the stratified instances where the block's z faces are, prm[P_ZSTRAT])
template <bool SHEAR, bool COMP>
long long count_dispatch(int nx, int ny, int nz, const double* prm, double dt) {
  if constexpr (SHEAR) {
    if (prm[P_ZSTRAT] != 0.0 && prm[P_CISO] > 0.0)
      return count_ops<Mode<true, true, COMP, false, true>>(nx, ny, nz, prm, dt);
  }
  return prm[P_CISO] > 0.0 ? count_ops<Mode<SHEAR, true, COMP>>(nx, ny, nz, prm, dt)
                           : count_ops<Mode<SHEAR, false, COMP>>(nx, ny, nz, prm, dt);
}

}  // namespace ramses::dissip

// either mode (shear: slabs given, else null), compensated or not; S and
// slabs only select the mode, the count does not depend on their values
extern "C" long long ramses_dissip_step_ops(const double* S, const double* slabs, int comp,
                                            int nx, int ny, int nz, const double* prm,
                                            double dt) {
  (void)S;
  using namespace ramses::dissip;
  if (slabs)
    return comp ? count_dispatch<true, true>(nx, ny, nz, prm, dt)
                : count_dispatch<true, false>(nx, ny, nz, prm, dt);
  return comp ? count_dispatch<false, true>(nx, ny, nz, prm, dt)
              : count_dispatch<false, false>(nx, ny, nz, prm, dt);
}
#endif
