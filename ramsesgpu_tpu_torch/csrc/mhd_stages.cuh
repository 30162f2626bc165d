// The per-cell physics and the five stages of one 3D MHD+CT step, shared by
// the staged kernel (mhd_step.cu: one launch per stage over a stage buffer)
// and the z-streaming kernel (zcarry_mhd.cu: every stage in one launch, on
// a per-block ring of z planes). Each stage's body is ``at(p)`` on a site p
// that names its cell and maps its neighbours: Site below (the stage
// grid), mhd_step.cu's TileSite (the fused flux + EMF stage's tile in
// shared memory) or zcarry_mhd.cu's RingSite (the ring). The physics, the
// stages and their modes are described in mhd_step.cu.
#pragma once

#include <type_traits>

#include "common.cuh"

// its own namespace, as hydro_step.cu's (shared stage type names)
namespace ramses::mhd {

// the 18 traced face / edge states, in the order of ops/trace_mhd3d.py
// STATE_NAMES; none is stored: each is formed where it is read (traced)
constexpr int NSTATE = 18;
enum {
  QP_X = 0, QM_X, QP_Y, QM_Y, QP_Z, QM_Z,
  RT_X, RB_X, LT_X, LB_X,
  RT_Y, RB_Y, LT_Y, LB_Y,
  RT_Z, RB_Z, LT_Z, LB_Z
};
// the precursors of a cell's traced states, the trace's output: the
// half-step cell values q2 [8]; the half-slopes hx, hy, hz of Q without the
// face-normal field of their own axis [3][7]; the half-step face fields L2
// [3] and R2 [3]; the transverse half-slopes of the face fields dF [face
// axis][L/R][the two other axes]; the stratified gravity kick
constexpr int PQ = 0, PH = 8, PL = 29, PR = 32, PF = 35, PKICK = 47, NPRE = 48;
HD constexpr int ph_slot(int ax, int ch) { return PH + 7 * ax + (ch < IA + ax ? ch : ch - 1); }
HD constexpr int pf_slot(int fax, int side, int along) {
  return PF + 4 * fax + 2 * side + (along < fax ? along : along - 1);
}
constexpr int NFLUX = 5;  // rho, E, three momenta
constexpr long long SCRATCH_PER_CELL = 8 + 3 + NPRE + 3 * NFLUX + 3;
constexpr long long SHEAR_SCRATCH_PER_CELL = SCRATCH_PER_CELL + 8;  // + Se
constexpr int SLAB = 3;   // ghost columns of each sheared slab (ghost_width)
constexpr int XH = 2;     // stage-grid columns beyond each x face (shear mode)
constexpr int ZH = 2;     // stage-grid rows beyond each z face (stratified mode)
constexpr int NPLANE = 5; // x-face planes written by the shear-mode update
constexpr int WH = 2;     // stage-grid cells beyond each face, every axis (window mode)

// the kernel's mode: SHEAR (shearing box, rotating frame), ISO (the
// isothermal pressure in the solvers), STRAT (the stratified MRI:
// BC_Z_STRATIFIED z faces and the static vertical gravity) and GHOST (the
// ghosted mode: the stages run on a filled ghosted state as on a periodic
// box of its own extent, the update writes its interior and CT face
// layer); the periodic mode is <false, false, false, false>. SHEAR and
// GHOST together are the shear window mode: the rotating-frame step of a
// ghosted window whose ghosts every axis's exchange has written (a rank's
// block of the sharded shearing box), written out of place (mhd_step.cu).
// GRAV (the ghosted mode): the uniform static gravity, a constant vector
// (Phys::grav): the half-dt kick 0.5 dt g on the velocities of every
// traced state where FluxEmf forms it, and the conservative source in the
// update of the interior (godunov_mhd.py:613-618, 745-746). GEN: the
// general instance of a mode, whose face solver (HLLD, LLF, HLL) and
// corner solver (2D-HLLD, HLLA, HLLF, LLF) come from the parameter block
// (Phys::solver, mag_solver), one warp-uniform branch each where a flux or
// an EMF is formed; the other instances are HLLD / 2D-HLLD only, the code
// earlier builds ran. The general instances are compiled in their own
// objects (mhd_step_general.cu, zcarry_mhd_general.cu).
template <bool SHEAR_, bool ISO_, bool STRAT_ = false, bool GHOST_ = false, bool GRAV_ = false,
          bool GEN_ = false>
struct Mode {
  static constexpr bool SHEAR = SHEAR_;
  static constexpr bool ISO = ISO_;
  static constexpr bool STRAT = STRAT_;
  static constexpr bool GHOST = GHOST_;
  static constexpr bool WINDOW = SHEAR_ && GHOST_;
  static constexpr bool GRAV = GRAV_;
  static constexpr bool GEN = GEN_;
  static_assert(!GRAV_ || (GHOST_ && !SHEAR_), "the uniform gravity is the ghosted mode's");
};
// the mode M with its solvers fixed (HLLD / 2D-HLLD: GEN false) or from
// the parameter block (GEN true)
template <typename M, bool GEN>
using WithSolvers = Mode<M::SHEAR, M::ISO, M::STRAT, M::GHOST, M::GRAV, GEN>;

// f(gen) with gen a std::bool_constant: true where prm asks for another
// solver pair than HLLD / 2D-HLLD (common.cuh general_solvers)
template <typename F>
int with_solvers(const double* prm, const F& f) {
  return general_solvers(prm) ? f(std::true_type{}) : f(std::false_type{});
}
using Periodic = Mode<false, false>;
using Ghosted = Mode<false, false, false, true>;
// their isothermal instances (cIso > 0: turbulence, isothermal OT)
using PeriodicIso = Mode<false, true>;
using GhostedIso = Mode<false, true, false, true>;
// the ghosted mode's gravity instances (a uniform [gravity] static_field_*)
using GhostedGrav = Mode<false, false, false, true, true>;
using GhostedIsoGrav = Mode<false, true, false, true, true>;

template <typename T>
struct StepArgs {
  const T* S;   // [8][n]     state (read)
  T* So;        // [8][n]     the updated state stage 6 writes (== S: in place;
                //            window: the interior [8][in.n], out of place)
  T* Q;         // [8][ne]    primitives (ne: stage-grid cells)
  T* E;         // [3][ne]    Ex, Ey, Ez at the trace's edge centres
  T* pre;       // [NPRE][ne] the traced states' precursors
  T* fl;        // [3][5][ne] face fluxes x, y, z
  T* emf;       // [3][ne]    edge EMFs z, y, x
  T* Se;        // shear: [8][ne] the state on the stage grid (written by prim)
  const T* slabs;  // shear: [2][8][nz][ny][SLAB] sheared x ghosts (XMIN, XMAX)
  T* planes;       // shear: [5][nz][ny] x-face planes
  const T* C;      // compensated: [8][n] the Kahan carry (S's channels 8-15), else null
  T* Co;           // compensated: the updated carry (== C: in place)
  const T* zslabs; // stratified: [2][8][SLAB][ny][nx + 2 SLAB] z ghosts (ZMIN, ZMAX)
  const T* gz;     // stratified: [nz + 2 SLAB] g_z of each z row, ghost rows included
  const T* dt;  // device scalar
  const unsigned char* active;  // device flag: 0 skips the step
  Dims d;       // the state's (ghosted mode: the ghosted array's)
  Dims e;       // the stage grid's: d (periodic, ghosted), nx + 2 XH columns
                // (shear), and nz + 2 ZH rows (stratified); window: the
                // interior and WH cells on each side of every axis
  Dims in;      // ghosted, window: the interior's (at offset g on every axis)
  int g;        // ghosted, window: the ghost width
  Phys<T> ph;
};

HD int clamp_i(int i, int lo, int hi) { return i < lo ? lo : (i > hi ? hi : i); }

HD int wrap_d(int i, int di, int n) {
  return di == 0 ? i : (di > 0 ? wrap_p(i, n) : wrap_m(i, n));
}

// shear: where the state's channel ch at column ii of the interior or a
// slab lies
template <typename T>
HD const T* at_x(const StepArgs<T>& a, int ch, int ii, int jj, int kk) {
  if (ii >= 0 && ii < a.d.nx) return a.S + ch * a.d.n + cell_at(a.d, ii, jj, kk);
  const int side = ii < 0 ? 0 : 1;
  const int col = ii < 0 ? ii + SLAB : ii - a.d.nx;
  return a.slabs + ((((long long)side * 8 + ch) * a.d.nz + kk) * a.d.ny + jj) * SLAB + col;
}

// shear modes: where the state's channel ch at column ii (any, clamped to
// the slabs), row jj in [0, ny) and z kk lies: kk in [0, nz), or,
// stratified, any (clamped to the z slabs, read outside [0, nz))
template <typename T, typename M>
HD const T* at_shear(const StepArgs<T>& a, int ch, int ii, int jj, int kk) {
  ii = clamp_i(ii, -SLAB, a.d.nx + SLAB - 1);
  if constexpr (M::STRAT) {
    kk = clamp_i(kk, -SLAB, a.d.nz + SLAB - 1);
    if (kk < 0 || kk >= a.d.nz) {
      const int side = kk < 0 ? 0 : 1;
      const int row = kk < 0 ? kk + SLAB : kk - a.d.nz;
      return a.zslabs + ((((long long)side * 8 + ch) * SLAB + row) * a.d.ny + jj) *
                            (a.d.nx + 2 * SLAB) + ii + SLAB;
    }
  }
  return at_x(a, ch, ii, jj, kk);
}

// the value there (the load rule of the shear modes' state loads)
template <typename T, typename M>
HD T load_shear(const StepArgs<T>& a, int ch, int ii, int jj, int kk) {
  return *at_shear<T, M>(a, ch, ii, jj, kk);
}

// One stage thread's cell (i, j, k) and its neighbours. Periodic: the
// stage grid is the state's and every offset wraps. Ghosted: the same on
// the ghosted array (the rolls of the JAX whole-array step), but the
// update's threads cover the cube g .. n + g of every axis. Shear: stage column
// i sits at i + XH and x reads clamp to the grid; a state load (src)
// outside [0, nx) reads the slab, and the stages after prim read the
// state from its stage-grid copy (s). Stratified: the same in z, stage
// row k at k + ZH, a state load outside [0, nz) reading the z slabs
// (whose x extent covers the x slabs' columns too). Window: (i, j, k)
// counts from the interior's first cell, stage cell i sits at i + WH on
// every axis and reads clamp to the stage grid; every state load is a
// plain offset g into the ghosted window, the update's threads cover the
// interior, and it writes the interior array (co).
template <typename T, typename M>
struct Site {
  static constexpr int ZOFF = M::STRAT ? ZH : 0;
  const StepArgs<T>& a;
  int i, j, k;
  long long c;   // stage-grid index of (i, j, k)
  long long cs;  // on_state: the state's index of (i, j, k)
  long long co;  // on_state: the updated state's index (window: the interior's)

  // t: the thread's index, its stage-grid cell, or (on_state) its state cell
  HD Site(const StepArgs<T>& a_, long long t, bool on_state = false) : a(a_) {
    if constexpr (M::WINDOW) {
      if (on_state) {
        cell_ijk(a.in, t, i, j, k);
        c = cell_at(a.e, i + WH, j + WH, k + WH);
      } else {
        cell_ijk(a.e, t, i, j, k);
        i -= WH;
        j -= WH;
        k -= WH;
        c = t;
      }
      cs = cell_at(a.d, i + a.g, j + a.g, k + a.g);
      co = t;
      return;
    }
    if constexpr (M::SHEAR) {
      if (on_state) {
        cell_ijk(a.d, t, i, j, k);
        c = cell_at(a.e, i + XH, j, k + ZOFF);
        cs = t;
        co = t;
        return;
      }
      cell_ijk(a.e, t, i, j, k);
      i -= XH;
      k -= ZOFF;
    } else if (M::GHOST && on_state) {
      // the update's cells: the interior and the CT face layer n + g
      cell_ijk(make_dims(a.in.nx + 1, a.in.ny + 1, a.in.nz + 1), t, i, j, k);
      i += a.g;
      j += a.g;
      k += a.g;
      t = cell_at(a.d, i, j, k);
    } else {
      cell_ijk(a.d, t, i, j, k);
    }
    c = t;
    cs = t;
    co = t;
  }
  // the stage-grid cell (x, y, z): the cell the thread-index constructor
  // gives for t = cell_at(a.e, x, y, z), without its divisions
  HD Site(const StepArgs<T>& a_, int x, int y, int z) : a(a_) {
    i = x - (M::WINDOW ? WH : M::SHEAR ? XH : 0);
    j = y - (M::WINDOW ? WH : 0);
    k = z - (M::WINDOW ? WH : ZOFF);
    c = cell_at(a.e, x, y, z);
    cs = M::WINDOW ? cell_at(a.d, i + a.g, j + a.g, k + a.g) : c;
    co = c;
  }
  // ghosted: whether the cell is in the interior (not the CT face layer)
  HD bool interior() const {
    return i < a.g + a.in.nx && j < a.g + a.in.ny && k < a.g + a.in.nz;
  }
  // stage-grid index of the neighbour (i+di, j+dj, k+dk)
  HD long long q(int di, int dj, int dk) const {
    if constexpr (M::WINDOW)
      return cell_at(a.e, clamp_i(i + di, -WH, a.e.nx - WH - 1) + WH,
                     clamp_i(j + dj, -WH, a.e.ny - WH - 1) + WH,
                     clamp_i(k + dk, -WH, a.e.nz - WH - 1) + WH);
    if (!M::SHEAR && di == 0 && dj == 0 && dk == 0) return c;
    // (kk before the branch: nvcc then gives the periodic f32 trace stage
    // 128 registers, not 96, and that stage runs ~1 % faster; PERF.md)
    const int jj = wrap_d(j, dj, a.d.ny);
    const int kk = M::STRAT ? clamp_i(k + dk, -ZH, a.e.nz - ZH - 1) + ZH : wrap_d(k, dk, a.d.nz);
    if constexpr (M::SHEAR)
      return cell_at(a.e, clamp_i(i + di, -XH, a.e.nx - XH - 1) + XH, jj, kk);
    return cell_at(a.d, wrap_d(i, di, a.d.nx), jj, kk);
  }
  // the stage-grid index of stage-grid cell (x, y, z), each coordinate at
  // least -1: a -1 is q's neighbour of cell 0 below it (the x, y, z rules
  // of q: wrap, or clamp in x (shear), z (stratified), every axis (window))
  HD static long long grid_index(const StepArgs<T>& a, int x, int y, int z) {
    constexpr bool wrap_x = !M::SHEAR, wrap_y = !M::WINDOW, wrap_z = !M::STRAT && !M::WINDOW;
    if (x < 0) x = wrap_x ? a.e.nx - 1 : 0;
    if (y < 0) y = wrap_y ? a.e.ny - 1 : 0;
    if (z < 0) z = wrap_z ? a.e.nz - 1 : 0;
    return cell_at(a.e, x, y, z);
  }
  // the index of the neighbour (i+di, j+dj, k+dk), or of this cell, in
  // each intermediate array, and the array's channel stride; here every
  // array lies on the stage grid (zcarry_mhd.cu's RingSite gives each its
  // own ring): Q, E, the fluxes and EMFs, and the precursors
  HD long long iq(int di, int dj, int dk) const { return q(di, dj, dk); }
  HD long long ie(int di, int dj, int dk) const { return q(di, dj, dk); }
  HD long long iflux(int di, int dj, int dk) const { return q(di, dj, dk); }
  HD long long cq() const { return c; }
  HD long long ce() const { return c; }
  HD long long cflux() const { return c; }
  HD long long nq() const { return a.e.n; }
  HD long long ne() const { return a.e.n; }
  HD long long nflux() const { return a.e.n; }
  // precursor v of this cell (the trace's output slot) and of the neighbour
  // (di, dj, dk), read from the stage buffer (the operation counts' per-cell
  // flux + EMF stage; the kernel's reads its tile, mhd_step.cu TileSite)
  HD long long ipre(int v) const { return (long long)v * a.e.n + c; }
  HD T pre(int v, int di, int dj, int dk) const {
    return a.pre[(long long)v * a.e.n + q(di, dj, dk)];
  }
  // prim's copy of the cell's state sc (shear: the later stages read it, s)
  HD void keep_state(const T* sc) const {
    if constexpr (M::SHEAR && !M::WINDOW) {
#pragma unroll
      for (int ch = 0; ch < 8; ++ch) a.Se[ch * a.e.n + c] = sc[ch];
    }
  }
  // the state's channel ch at the neighbour, after prim
  HD T s(int ch, int di, int dj, int dk) const {
    if constexpr (M::WINDOW) return window(ch, di, dj, dk);
    if constexpr (M::SHEAR) return a.Se[ch * a.e.n + q(di, dj, dk)];
    return a.S[ch * a.d.n + q(di, dj, dk)];
  }
  // the state's channel ch at the neighbour, from the state or a slab
  HD T src(int ch, int di, int dj, int dk) const {
    if constexpr (M::WINDOW) {
      return window(ch, di, dj, dk);
    } else if constexpr (M::SHEAR) {
      return load_shear<T, M>(a, ch, i + di, wrap_d(j, dj, a.d.ny),
                              M::STRAT ? k + dk : wrap_d(k, dk, a.d.nz));
    } else {
      return a.S[ch * a.d.n + q(di, dj, dk)];
    }
  }
  // window: the state's channel ch at the neighbour; every stage cell's
  // neighbours (at most 1 away on each axis) lie in the window, as WH + 1
  // <= g
  HD T window(int ch, int di, int dj, int dk) const {
    return a.S[ch * a.d.n + cell_at(a.d, i + di + a.g, j + dj + a.g, k + dk + a.g)];
  }
  // cell-centre x of column i (godunov_mhd.py:44 xpos_array; window: xpos0
  // is the window's x0 + dx/2)
  HD T xpos() const { return a.ph.xpos0 + r_mul(T(i), a.ph.dx); }
  // stratified: g_z of row k (problems/mhd_inits.py mri_gravity_field;
  // window: of the window's rows, SLAB == g)
  HD T gz() const { return a.gz[k + SLAB]; }
};

// ---------------------------------------------------------------------------
// per-cell physics
// ---------------------------------------------------------------------------

// the gas pressure the solvers read: rho cIso^2 with the isothermal EOS
// (riemann_mhd.py:59,71,146,296,322,557)
template <typename M, typename T>
HD T pres(const Phys<T>& ph, const T* q) {
  if constexpr (M::ISO) return q[ID] * ph.ciso2;
  return q[IP];
}

// riemann_mhd.py _fast_speed_precursors / _fast_speed_from_precursors
template <typename T>
struct FastPre {
  T d2, cb;
};

template <typename T>
HD FastPre<T> fast_pre(const Phys<T>& ph, T d, T p, T a, T b, T c) {
  const T b2 = a * a + b * b + c * c;
  const T inv_d = T(1) / d;
  const T c2 = ph.gamma0 * p * inv_d;
  FastPre<T> f;
  f.d2 = T(0.5) * (b2 * inv_d + c2);
  f.cb = c2 * inv_d;
  return f;
}

template <typename T>
HD T fast_speed(const FastPre<T>& f, T bn) {
  return r_sqrt(f.d2 + r_sqrt(pmax(f.d2 * f.d2 - f.cb * (bn * bn), T(0))));
}

// riemann_mhd.py riemann_hlld: flux[0..4] (rho, E, normal and two
// transverse momenta) between ql and qr in the rotated order.
template <typename T>
struct HlldSide {
  T r, p, u, v, w, b, c, etot, ptot, vdotb, cfast;
};

template <typename T>
struct HlldStar {
  T rstar, vstar, wstar, bstar, cstar, vdotbstar, etotstar, sqrtr, calfven;
};

template <typename M, typename T>
HD HlldSide<T> hlld_prep(const Phys<T>& ph, const T* q, T a) {
  HlldSide<T> s;
  s.r = q[ID];
  s.p = pres<M>(ph, q);
  s.u = q[IU];
  s.v = q[IV];
  s.w = q[IW];
  s.b = q[IB];
  s.c = q[IC];
  const T ecin = T(0.5) * (s.u * s.u + s.v * s.v + s.w * s.w) * s.r;
  const T emag = T(0.5) * (a * a + s.b * s.b + s.c * s.c);
  s.etot = s.p * ph.entho + ecin + emag;
  s.ptot = s.p + emag;
  s.vdotb = s.u * a + s.v * s.b + s.w * s.c;
  s.cfast = fast_speed(fast_pre(ph, s.r, s.p, a, s.b, s.c), a);
  return s;
}

template <typename T>
HD HlldStar<T> hlld_star(const HlldSide<T>& q, T a, T s_, T ustar, T ptotstar) {
  HlldStar<T> o;
  const T inv_su = T(1) / (s_ - ustar);
  o.rstar = q.r * (s_ - q.u) * inv_su;
  const T estar = q.r * (s_ - q.u) * (s_ - ustar) - a * a;
  const T el = q.r * (s_ - q.u) * (s_ - q.u) - a * a;
  const bool degenerate =
      (a * a > T(0)) && (r_abs(estar / (a * a + T(1e-300)) - T(1)) <= T(1e-8));
  const T estar_safe = estar == T(0) ? T(1) : estar;
  const T inv_estar = T(1) / estar_safe;
  const T k = a * (ustar - q.u) * inv_estar;
  const T el_ratio = el * inv_estar;
  o.vstar = degenerate ? q.v : q.v - q.b * k;
  o.bstar = degenerate ? q.b : q.b * el_ratio;
  o.wstar = degenerate ? q.w : q.w - q.c * k;
  o.cstar = degenerate ? q.c : q.c * el_ratio;
  o.vdotbstar = ustar * a + o.vstar * o.bstar + o.wstar * o.cstar;
  o.etotstar = ((s_ - q.u) * q.etot - q.ptot * q.u + ptotstar * ustar +
                a * (q.vdotb - o.vdotbstar)) * inv_su;
  const T inv_sqrtr = r_rsqrt(o.rstar);
  o.sqrtr = o.rstar * inv_sqrtr;
  o.calfven = r_abs(a) * inv_sqrtr;
  return o;
}

template <typename M, typename T>
HD void riemann_hlld(const Phys<T>& ph, const T* ql, const T* qr, T* f) {
  const T a = T(0.5) * (ql[IA] + qr[IA]);
  const T sgnm = a >= T(0) ? T(1) : T(-1);
  const HlldSide<T> L = hlld_prep<M>(ph, ql, a);
  const HlldSide<T> R = hlld_prep<M>(ph, qr, a);

  const T sl = pmin(L.u, R.u) - pmax(L.cfast, R.cfast);
  const T sr = pmax(L.u, R.u) + pmax(L.cfast, R.cfast);
  const T rcl = L.r * (L.u - sl);
  const T rcr = R.r * (sr - R.u);
  const T inv_rc = T(1) / (rcr + rcl);
  const T ustar = (rcr * R.u + rcl * L.u + (L.ptot - R.ptot)) * inv_rc;
  const T ptotstar = (rcr * L.ptot + rcl * R.ptot + rcl * rcr * (L.u - R.u)) * inv_rc;

  const HlldStar<T> sL = hlld_star(L, a, sl, ustar, ptotstar);
  const HlldStar<T> sR = hlld_star(R, a, sr, ustar, ptotstar);
  const T sal = ustar - sL.calfven;
  const T sar = ustar + sR.calfven;

  const T sqrl = sL.sqrtr, sqrr = sR.sqrtr;
  const T inv_denom = T(1) / (sqrl + sqrr);
  const T vss = (sqrl * sL.vstar + sqrr * sR.vstar + sgnm * (sR.bstar - sL.bstar)) * inv_denom;
  const T wss = (sqrl * sL.wstar + sqrr * sR.wstar + sgnm * (sR.cstar - sL.cstar)) * inv_denom;
  const T bss = (sqrl * sR.bstar + sqrr * sL.bstar +
                 sgnm * sqrl * sqrr * (sR.vstar - sL.vstar)) * inv_denom;
  const T css = (sqrl * sR.cstar + sqrr * sL.cstar +
                 sgnm * sqrl * sqrr * (sR.wstar - sL.wstar)) * inv_denom;
  const T vdotbss = ustar * a + vss * bss + wss * css;
  const T etotssl = sL.etotstar - sgnm * sqrl * (sL.vdotbstar - vdotbss);
  const T etotssr = sR.etotstar + sgnm * sqrr * (sR.vdotbstar - vdotbss);

  // sample the 6-zone fan from the outside in
  T ro, uo, vo, wo, bo, co, ptoto, etoto, vdotbo;
  if (sl > T(0)) {
    ro = L.r; uo = L.u; vo = L.v; wo = L.w; bo = L.b; co = L.c;
    ptoto = L.ptot; etoto = L.etot; vdotbo = L.vdotb;
  } else if (sal > T(0)) {
    ro = sL.rstar; uo = ustar; vo = sL.vstar; wo = sL.wstar; bo = sL.bstar; co = sL.cstar;
    ptoto = ptotstar; etoto = sL.etotstar; vdotbo = sL.vdotbstar;
  } else if (ustar > T(0)) {
    ro = sL.rstar; uo = ustar; vo = vss; wo = wss; bo = bss; co = css;
    ptoto = ptotstar; etoto = etotssl; vdotbo = vdotbss;
  } else if (sar > T(0)) {
    ro = sR.rstar; uo = ustar; vo = vss; wo = wss; bo = bss; co = css;
    ptoto = ptotstar; etoto = etotssr; vdotbo = vdotbss;
  } else if (sr > T(0)) {
    ro = sR.rstar; uo = ustar; vo = sR.vstar; wo = sR.wstar; bo = sR.bstar; co = sR.cstar;
    ptoto = ptotstar; etoto = sR.etotstar; vdotbo = sR.vdotbstar;
  } else {
    ro = R.r; uo = R.u; vo = R.v; wo = R.w; bo = R.b; co = R.c;
    ptoto = R.ptot; etoto = R.etot; vdotbo = R.vdotb;
  }
  f[0] = ro * uo;
  f[1] = (etoto + ptoto) * uo - a * vdotbo;
  f[2] = ro * uo * uo - a * a + ptoto;
  f[3] = ro * uo * vo - a * bo;
  f[4] = ro * uo * wo - a * co;
}

// riemann_mhd.py _find_mhd_flux with the normal field a: the conservative
// state u and the flux f, each [0..4] (rho, E, the normal and two
// transverse momenta) of the rotated state q
template <typename M, typename T>
HD void mhd_flux(const Phys<T>& ph, const T* q, T a, T* u, T* f) {
  const T d = q[ID], p = pres<M>(ph, q);
  const T vu = q[IU], v = q[IV], w = q[IW], b = q[IB], c = q[IC];
  const T ecin = T(0.5) * (vu * vu + v * v + w * w) * d;
  const T emag = T(0.5) * (a * a + b * b + c * c);
  const T etot = p * ph.entho + ecin + emag;
  const T ptot = p + emag;
  u[0] = d;
  u[1] = etot;
  u[2] = d * vu;
  u[3] = d * v;
  u[4] = d * w;
  f[0] = d * vu;
  f[1] = (etot + ptot) * vu - a * (a * vu + b * v + c * w);
  f[2] = d * vu * vu - a * a + ptot;
  f[3] = d * vu * v - a * b;
  f[4] = d * vu * w - a * c;
}

// riemann_mhd.py _fast_speed of q along the normal field bn
template <typename M, typename T>
HD T fast_speed_q(const Phys<T>& ph, const T* q, T a, T bn) {
  return fast_speed(fast_pre(ph, q[ID], pres<M>(ph, q), a, q[IB], q[IC]), bn);
}

// riemann_mhd.py riemann_llf_mhd: the normal field of both sides is their
// mean before the fluxes and the fast speeds
template <typename M, typename T>
HD void riemann_llf(const Phys<T>& ph, const T* ql, const T* qr, T* f) {
  const T a = T(0.5) * (ql[IA] + qr[IA]);
  T ul[NFLUX], fl[NFLUX], ur[NFLUX], fr[NFLUX];
  mhd_flux<M>(ph, ql, a, ul, fl);
  mhd_flux<M>(ph, qr, a, ur, fr);
  const T vel = pmax(fast_speed_q<M>(ph, ql, a, a) + r_abs(ql[IU]),
                     fast_speed_q<M>(ph, qr, a, a) + r_abs(qr[IU]));
#pragma unroll
  for (int k = 0; k < NFLUX; ++k) f[k] = T(0.5) * (fl[k] + fr[k]) - T(0.5) * vel * (ur[k] - ul[k]);
}

// riemann_mhd.py riemann_hll_mhd: the HLL average of the two sides' full
// MHD fluxes, the fast speeds along the mean normal field
template <typename M, typename T>
HD void riemann_hll(const Phys<T>& ph, const T* ql, const T* qr, T* f) {
  const T a = T(0.5) * (ql[IA] + qr[IA]);
  T cl[NFLUX], fl[NFLUX], cr[NFLUX], fr[NFLUX];
  mhd_flux<M>(ph, ql, a, cl, fl);
  mhd_flux<M>(ph, qr, a, cr, fr);
  const T cfl = fast_speed_q<M>(ph, ql, a, a), cfr = fast_speed_q<M>(ph, qr, a, a);
  const T SL = pmin(pmin(ql[IU], qr[IU]) - pmax(cfl, cfr), T(0));
  const T SR = pmax(pmax(ql[IU], qr[IU]) + pmax(cfl, cfr), T(0));
#pragma unroll
  for (int k = 0; k < NFLUX; ++k)
    f[k] = (SR * fl[k] - SL * fr[k] + SR * SL * (cr[k] - cl[k])) / (SR - SL);
}

// the face flux of M's solver: HLLD, or (general instances) the block's
template <typename M, typename T>
HD void riemann_face(const Phys<T>& ph, const T* ql, const T* qr, T* f) {
  if constexpr (M::GEN) {
    if (ph.solver == MHD_LLF) return riemann_llf<M>(ph, ql, qr, f);
    if (ph.solver == MHD_HLL) return riemann_hll<M>(ph, ql, qr, f);
  }
  riemann_hlld<M>(ph, ql, qr, f);
}

// riemann_mhd.py mag_riemann2d_hlld on corner states in the 2D order
// (rho, p, u, v, w, A, B, C), plus the four corner EMFs.
template <typename T>
struct Corner2D {
  T rstarx, Bstar, rstary, Astar, rstar, Estarx, Estary, Estar;
};

template <typename T>
HD Corner2D<T> corner_star(T r, T u, T v, T a_, T b_, T Sx, T Sy, T ustar, T vstar) {
  Corner2D<T> o;
  const T ratio_x = (Sx - u) / (Sx - ustar);
  const T ratio_y = (Sy - v) / (Sy - vstar);
  o.rstarx = r * ratio_x;
  o.Bstar = b_ * ratio_x;
  o.rstary = r * ratio_y;
  o.Astar = a_ * ratio_y;
  o.rstar = o.rstarx * ratio_y;
  o.Estarx = ustar * o.Bstar - v * a_;
  o.Estary = u * b_ - vstar * o.Astar;
  o.Estar = ustar * o.Bstar - vstar * o.Astar;
  return o;
}

template <typename T>
HD T max5(T a0, T a1, T a2, T a3, T a4) {
  return pmax(pmax(pmax(a0, a1), pmax(a2, a3)), a4);
}

template <typename M, typename T>
HD T ptot2d(const Phys<T>& ph, const T* q) {
  return pres<M>(ph, q) + T(0.5) * (q[IA] * q[IA] + q[IB] * q[IB] + q[IC] * q[IC]);
}

template <typename M, typename T>
HD T mag_riemann2d_hlld(const Phys<T>& ph, const T* qLL, const T* qRL, const T* qLR,
                        const T* qRR, T eLL, T eRL, T eLR, T eRR) {
  const FastPre<T> pLL = fast_pre(ph, qLL[ID], pres<M>(ph, qLL), qLL[IA], qLL[IB], qLL[IC]);
  const FastPre<T> pLR = fast_pre(ph, qLR[ID], pres<M>(ph, qLR), qLR[IA], qLR[IB], qLR[IC]);
  const FastPre<T> pRL = fast_pre(ph, qRL[ID], pres<M>(ph, qRL), qRL[IA], qRL[IB], qRL[IC]);
  const FastPre<T> pRR = fast_pre(ph, qRR[ID], pres<M>(ph, qRR), qRR[IA], qRR[IB], qRR[IC]);
  const T cxmax = pmax(pmax(pmax(fast_speed(pLL, qLL[IA]), fast_speed(pLR, qLR[IA])),
                            fast_speed(pRL, qRL[IA])),
                       fast_speed(pRR, qRR[IA]));
  const T cymax = pmax(pmax(pmax(fast_speed(pLL, qLL[IB]), fast_speed(pLR, qLR[IB])),
                            fast_speed(pRL, qRL[IB])),
                       fast_speed(pRR, qRR[IB]));
  const T ulo = pmin(pmin(pmin(qLL[IU], qLR[IU]), qRL[IU]), qRR[IU]);
  const T uhi = pmax(pmax(pmax(qLL[IU], qLR[IU]), qRL[IU]), qRR[IU]);
  const T vlo = pmin(pmin(pmin(qLL[IV], qLR[IV]), qRL[IV]), qRR[IV]);
  const T vhi = pmax(pmax(pmax(qLL[IV], qLR[IV]), qRL[IV]), qRR[IV]);

  const T SL = ulo - cxmax;
  const T SR = uhi + cxmax;
  const T SB = vlo - cymax;
  const T ST = vhi + cymax;

  const T PtotLL = ptot2d<M>(ph, qLL), PtotLR = ptot2d<M>(ph, qLR);
  const T PtotRL = ptot2d<M>(ph, qRL), PtotRR = ptot2d<M>(ph, qRR);

  const T rLL = qLL[ID], uLL = qLL[IU], vLL = qLL[IV], aLL = qLL[IA], bLL = qLL[IB];
  const T rLR = qLR[ID], uLR = qLR[IU], vLR = qLR[IV], aLR = qLR[IA], bLR = qLR[IB];
  const T rRL = qRL[ID], uRL = qRL[IU], vRL = qRL[IV], aRL = qRL[IA], bRL = qRL[IB];
  const T rRR = qRR[ID], uRR = qRR[IU], vRR = qRR[IV], aRR = qRR[IA], bRR = qRR[IB];

  const T rcLLx = rLL * (uLL - SL), rcRLx = rRL * (SR - uRL);
  const T rcLRx = rLR * (uLR - SL), rcRRx = rRR * (SR - uRR);
  const T rcLLy = rLL * (vLL - SB), rcLRy = rLR * (ST - vLR);
  const T rcRLy = rRL * (vRL - SB), rcRRy = rRR * (ST - vRR);

  const T ustar = (rcLLx * uLL + rcLRx * uLR + rcRLx * uRL + rcRRx * uRR +
                   (PtotLL - PtotRL + PtotLR - PtotRR)) /
                  (rcLLx + rcLRx + rcRLx + rcRRx);
  const T vstar = (rcLLy * vLL + rcLRy * vLR + rcRLy * vRL + rcRRy * vRR +
                   (PtotLL - PtotLR + PtotRL - PtotRR)) /
                  (rcLLy + rcLRy + rcRLy + rcRRy);

  const Corner2D<T> LL = corner_star(rLL, uLL, vLL, aLL, bLL, SL, SB, ustar, vstar);
  const Corner2D<T> LR = corner_star(rLR, uLR, vLR, aLR, bLR, SL, ST, ustar, vstar);
  const Corner2D<T> RL = corner_star(rRL, uRL, vRL, aRL, bRL, SR, SB, ustar, vstar);
  const Corner2D<T> RR = corner_star(rRR, uRR, vRR, aRR, bRR, SR, ST, ustar, vstar);

  const T rqLL = r_rsqrt(LL.rstar), rqLR = r_rsqrt(LR.rstar);
  const T rqRL = r_rsqrt(RL.rstar), rqRR = r_rsqrt(RR.rstar);
  const T smallc = ph.smallc;
  const T calfvenL = max5(r_abs(aLR) * r_rsqrt(LR.rstarx), r_abs(LR.Astar) * rqLR,
                          r_abs(aLL) * r_rsqrt(LL.rstarx), r_abs(LL.Astar) * rqLL, smallc);
  const T calfvenR = max5(r_abs(aRR) * r_rsqrt(RR.rstarx), r_abs(RR.Astar) * rqRR,
                          r_abs(aRL) * r_rsqrt(RL.rstarx), r_abs(RL.Astar) * rqRL, smallc);
  const T calfvenB = max5(r_abs(bLL) * r_rsqrt(LL.rstary), r_abs(LL.Bstar) * rqLL,
                          r_abs(bRL) * r_rsqrt(RL.rstary), r_abs(RL.Bstar) * rqRL, smallc);
  const T calfvenT = max5(r_abs(bLR) * r_rsqrt(LR.rstary), r_abs(LR.Bstar) * rqLR,
                          r_abs(bRR) * r_rsqrt(RR.rstary), r_abs(RR.Bstar) * rqRR, smallc);

  const T SAL = pmin(ustar - calfvenL, T(0));
  const T SAR = pmax(ustar + calfvenR, T(0));
  const T SAB = pmin(vstar - calfvenB, T(0));
  const T SAT = pmax(vstar + calfvenT, T(0));

  const T inv_dsx = T(1) / (SAR - SAL);
  const T inv_dsy = T(1) / (SAT - SAB);
  const T AstarT = (SAR * RR.Astar - SAL * LR.Astar) * inv_dsx;
  const T AstarB = (SAR * RL.Astar - SAL * LL.Astar) * inv_dsx;
  const T BstarR = (SAT * RR.Bstar - SAB * RL.Bstar) * inv_dsy;
  const T BstarL = (SAT * LR.Bstar - SAB * LL.Bstar) * inv_dsy;

  if (SB > T(0)) {
    if (SL > T(0)) return eLL;
    if (SR < T(0)) return eRL;
    return (SAR * LL.Estarx - SAL * RL.Estarx + SAR * SAL * (bRL - bLL)) * inv_dsx;
  }
  if (ST < T(0)) {
    if (SL > T(0)) return eLR;
    if (SR < T(0)) return eRR;
    return (SAR * LR.Estarx - SAL * RR.Estarx + SAR * SAL * (bRR - bLR)) * inv_dsx;
  }
  if (SL > T(0))
    return (SAT * LL.Estary - SAB * LR.Estary - SAT * SAB * (aLR - aLL)) * inv_dsy;
  if (SR < T(0))
    return (SAT * RL.Estary - SAB * RR.Estary - SAT * SAB * (aRR - aRL)) * inv_dsy;
  return (SAL * SAB * RR.Estar - SAL * SAT * RL.Estar - SAR * SAB * LR.Estar +
          SAR * SAT * LL.Estar) * inv_dsx * inv_dsy -
         SAT * SAB * inv_dsy * (AstarT - AstarB) +
         SAR * SAL * inv_dsx * (BstarR - BstarL);
}

// riemann_mhd.py mag_riemann2d_hll_family: HLLA (FAST false: the Alfven
// speeds |B_n| / sqrt(rho), floored at smallc) or HLLF (the fast speeds);
// the 2D-HLL average of the corner EMFs plus dissipation on the in-plane
// field jumps
template <typename M, bool FAST, typename T>
HD T mag_riemann2d_hll(const Phys<T>& ph, const T* qLL, const T* qRL, const T* qLR,
                       const T* qRR, T eLL, T eRL, T eLR, T eRR) {
  const T* q[4] = {qLL, qLR, qRL, qRR};
  T cx[4], cy[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    if constexpr (FAST) {
      const FastPre<T> pre = fast_pre(ph, q[n][ID], pres<M>(ph, q[n]), q[n][IA], q[n][IB],
                                      q[n][IC]);
      cx[n] = fast_speed(pre, q[n][IA]);
      cy[n] = fast_speed(pre, q[n][IB]);
    } else {
      cx[n] = r_sqrt(q[n][IA] * q[n][IA] / q[n][ID]);
      cy[n] = r_sqrt(q[n][IB] * q[n][IB] / q[n][ID]);
    }
  }
  T cxmax = pmax(pmax(cx[0], cx[1]), pmax(cx[2], cx[3]));
  T cymax = pmax(pmax(cy[0], cy[1]), pmax(cy[2], cy[3]));
  if constexpr (!FAST) {
    cxmax = pmax(cxmax, ph.smallc);
    cymax = pmax(cymax, ph.smallc);
  }
  const T ulo = pmin(pmin(pmin(qLL[IU], qLR[IU]), qRL[IU]), qRR[IU]);
  const T uhi = pmax(pmax(pmax(qLL[IU], qLR[IU]), qRL[IU]), qRR[IU]);
  const T vlo = pmin(pmin(pmin(qLL[IV], qLR[IV]), qRL[IV]), qRR[IV]);
  const T vhi = pmax(pmax(pmax(qLL[IV], qLR[IV]), qRL[IV]), qRR[IV]);
  const T SL = pmin(ulo - cxmax, T(0));
  const T SR = pmax(uhi + cxmax, T(0));
  const T SB = pmin(vlo - cymax, T(0));
  const T ST = pmax(vhi + cymax, T(0));
  return (SL * SB * eRR - SL * ST * eRL - SR * SB * eLR + SR * ST * eLL) / (SR - SL) /
             (ST - SB) -
         ST * SB / (ST - SB) * (qRR[IA] - qLL[IA]) + SR * SL / (SR - SL) * (qRR[IB] - qLL[IB]);
}

// riemann_mhd.py mag_riemann2d_llf: the mean EMF plus LLF dissipation on
// the in-plane field jumps, the speeds |u_n| + the fast speed along IA (x)
// and IB (y)
template <typename M, typename T>
HD T mag_riemann2d_llf(const Phys<T>& ph, const T* qLL, const T* qRL, const T* qLR,
                       const T* qRR, T eLL, T eRL, T eLR, T eRR) {
  const T E = T(0.25) * (eLL + eRL + eLR + eRR);
  const T* q[4] = {qLL, qLR, qRL, qRR};
  T cx[4], cy[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const FastPre<T> pre = fast_pre(ph, q[n][ID], pres<M>(ph, q[n]), q[n][IA], q[n][IB],
                                    q[n][IC]);
    cx[n] = fast_speed(pre, q[n][IA]) + r_abs(q[n][IU]);
    cy[n] = fast_speed(pre, q[n][IB]) + r_abs(q[n][IV]);
  }
  const T vel_x = pmax(pmax(cx[0], cx[1]), pmax(cx[2], cx[3]));
  const T vel_y = pmax(pmax(cy[0], cy[1]), pmax(cy[2], cy[3]));
  return E - T(0.5) * vel_y * (qRR[IA] - qLL[IA]) + T(0.5) * vel_x * (qRR[IB] - qLL[IB]);
}

// the corner EMF of M's solver: 2D-HLLD, or (general instances) the block's
template <typename M, typename T>
HD T mag_riemann2d(const Phys<T>& ph, const T* qLL, const T* qRL, const T* qLR, const T* qRR,
                   T eLL, T eRL, T eLR, T eRR) {
  if constexpr (M::GEN) {
    if (ph.mag_solver == MAG_HLLA)
      return mag_riemann2d_hll<M, false>(ph, qLL, qRL, qLR, qRR, eLL, eRL, eLR, eRR);
    if (ph.mag_solver == MAG_HLLF)
      return mag_riemann2d_hll<M, true>(ph, qLL, qRL, qLR, qRR, eLL, eRL, eLR, eRR);
    if (ph.mag_solver == MAG_LLF)
      return mag_riemann2d_llf<M>(ph, qLL, qRL, qLR, qRR, eLL, eRL, eLR, eRR);
  }
  return mag_riemann2d_hlld<M>(ph, qLL, qRL, qLR, qRR, eLL, eRL, eLR, eRR);
}

// riemann_mhd.py compute_emf: rotation (iu, iv, iw, ia, ib, ic) of the
// edge family, corner quadrants qLL <- qRT, qRL <- qLT, qLR <- qRB,
// qRR <- qLB with in-plane field continuity.
template <typename M, typename T>
HD T compute_emf(const Phys<T>& ph, const T* qRT, const T* qRB, const T* qLT,
                 const T* qLB, int iu, int iv, int iw, int ia, int ib, int ic) {
  const T a_bottom = T(0.5) * (qRT[ia] + qLT[ia]);
  const T a_top = T(0.5) * (qRB[ia] + qLB[ia]);
  const T b_left = T(0.5) * (qRT[ib] + qRB[ib]);
  const T b_right = T(0.5) * (qLT[ib] + qLB[ib]);
  const T qLL[8] = {qRT[ID], qRT[IP], qRT[iu], qRT[iv], qRT[iw], a_bottom, b_left, qRT[ic]};
  const T qRL[8] = {qLT[ID], qLT[IP], qLT[iu], qLT[iv], qLT[iw], a_bottom, b_right, qLT[ic]};
  const T qLR[8] = {qRB[ID], qRB[IP], qRB[iu], qRB[iv], qRB[iw], a_top, b_left, qRB[ic]};
  const T qRR[8] = {qLB[ID], qLB[IP], qLB[iu], qLB[iv], qLB[iw], a_top, b_right, qLB[ic]};
  const T eLL = qLL[IU] * qLL[IB] - qLL[IV] * qLL[IA];
  const T eRL = qRL[IU] * qRL[IB] - qRL[IV] * qRL[IA];
  const T eLR = qLR[IU] * qLR[IB] - qLR[IV] * qLR[IA];
  const T eRR = qRR[IU] * qRR[IB] - qRR[IV] * qRR[IA];
  return mag_riemann2d<M>(ph, qLL, qRL, qLR, qRR, eLL, eRL, eLR, eRR);
}

// the shearing-box upwind term of an EMF (riemann_mhd.py:599-605):
// where(shear > 0, shear * lo, shear * hi)
template <typename T>
HD T shear_upwind(T shear, T lo, T hi) {
  return shear > T(0) ? shear * lo : shear * hi;
}

// ---------------------------------------------------------------------------
// stages
// ---------------------------------------------------------------------------

// 1: eos.py constoprim_mhd
template <typename T, typename M>
struct PrimStage {
  StepArgs<T> a;
  HD void operator()(long long t) const {
    if (!*a.active) return;
    at(Site<T, M>(a, t));
  }
  template <typename P>
  HD void at(const P& p) const {
    T sc[8];  // this cell's state
#pragma unroll
    for (int ch = 0; ch < 8; ++ch) sc[ch] = p.src(ch, 0, 0, 0);
    const T rho = pmax(sc[ID], a.ph.smallr);
    const T inv_rho = T(1) / rho;
    T u = sc[IU] * inv_rho;
    T v = sc[IV] * inv_rho;
    const T w = sc[IW] * inv_rho;
    const T bx = T(0.5) * (sc[IA] + p.src(IA, 1, 0, 0));
    const T by = T(0.5) * (sc[IB] + p.src(IB, 0, 1, 0));
    const T bz = T(0.5) * (sc[IC] + p.src(IC, 0, 0, 1));
    T pr;
    if constexpr (M::ISO) {
      pr = rho * a.ph.ciso * a.ph.ciso;
    } else {
      const T eken = T(0.5) * (u * u + v * v + w * w);
      const T emag = T(0.5) * (bx * bx + by * by + bz * bz);
      const T eint = (sc[IP] - emag) * inv_rho - eken;
      pr = pmax(a.ph.gm1 * rho * eint, rho * a.ph.smallp);
    }
    if constexpr (M::SHEAR) {
      // Coriolis predictor half-kick (constoprim.h:190-195)
      const T dt = *a.dt;
      const T dvx = a.ph.cor2 * v;
      const T dvy = a.ph.corm05 * u;
      u = u + dvx * dt * T(0.5);
      v = v + dvy * dt * T(0.5);
    }
    const long long n = p.nq(), c = p.cq();
    T* Q = a.Q;
    Q[ID * n + c] = rho;
    Q[IP * n + c] = pr;
    Q[IU * n + c] = u;
    Q[IV * n + c] = v;
    Q[IW * n + c] = w;
    Q[IA * n + c] = bx;
    Q[IB * n + c] = by;
    Q[IC * n + c] = bz;
    p.keep_state(sc);
  }
};

// 2: trace_mhd3d.py electric fields at the edge centres: Ex (i, j-1/2,
// k-1/2), Ey (i-1/2, j, k-1/2), Ez (i-1/2, j-1/2, k)
template <typename T, typename M>
struct EFieldStage {
  StepArgs<T> a;
  // _corner_avg4(f, ax1, ax2) = 0.25 * (f + f[-1] + f[-2] + f[-1,-2])
  HD T avg4(const T* f, long long c, long long m1, long long m2, long long m12) const {
    return T(0.25) * (f[c] + f[m1] + f[m2] + f[m12]);
  }
  HD void operator()(long long t) const {
    if (!*a.active) return;
    at(Site<T, M>(a, t));
  }
  template <typename P>
  HD void at(const P& p) const {
    const long long n = p.nq(), c = p.cq();
    const long long cxm = p.iq(-1, 0, 0), cym = p.iq(0, -1, 0), czm = p.iq(0, 0, -1);
    const long long cyzm = p.iq(0, -1, -1), cxzm = p.iq(-1, 0, -1), cxym = p.iq(-1, -1, 0);
    const T* Qu = a.Q + IU * n;
    const T* Qv = a.Q + IV * n;
    const T* Qw = a.Q + IW * n;

    const T v4 = avg4(Qv, c, cym, czm, cyzm);
    const T w4 = avg4(Qw, c, cym, czm, cyzm);
    const T B_e = T(0.5) * (p.s(IB, 0, 0, 0) + p.s(IB, 0, 0, -1));
    const T C_e = T(0.5) * (p.s(IC, 0, 0, 0) + p.s(IC, 0, -1, 0));
    T ex = v4 * C_e - w4 * B_e;

    const T u4 = avg4(Qu, c, cxm, czm, cxzm);
    const T w4b = avg4(Qw, c, cxm, czm, cxzm);
    const T A_e = T(0.5) * (p.s(IA, 0, 0, 0) + p.s(IA, 0, 0, -1));
    const T C_e2 = T(0.5) * (p.s(IC, 0, 0, 0) + p.s(IC, -1, 0, 0));
    const T ey = w4b * A_e - u4 * C_e2;

    const T u4c = avg4(Qu, c, cxm, cym, cxym);
    const T v4c = avg4(Qv, c, cxm, cym, cxym);
    const T A_e2 = T(0.5) * (p.s(IA, 0, 0, 0) + p.s(IA, 0, -1, 0));
    const T B_e2 = T(0.5) * (p.s(IB, 0, 0, 0) + p.s(IB, -1, 0, 0));
    T ez = u4c * B_e2 - v4c * A_e2;
    if constexpr (M::SHEAR) {
      // trace_mhd3d.py:53-54, :150-151
      const T x = p.xpos();
      ex = ex + (a.ph.shear_k * x) * C_e;
      ez = ez - (a.ph.shear_k * (x - a.ph.dx_half)) * A_e2;
    }
    const long long ne = p.ne(), ce = p.ce();
    a.E[ce] = ex;
    a.E[ne + ce] = ey;
    a.E[2 * ne + ce] = ez;
  }
};

// 3: trace_mhd3d.py trace_mhd3d_state_parts for one cell, up to the
// precursors its 18 states are formed from (traced); stored in the
// precursor slots (PQ ... PKICK) of the site's array
template <typename T, typename M>
struct PrecursorStage {
  StepArgs<T> a;
  // limited slope of state channel ch along one axis (neighbours -1, +1)
  template <typename P>
  HD T sls(const P& p, int ch, int ax, int di, int dj, int dk) const {
    const int ox = ax == 0, oy = ax == 1, oz = ax == 2;
    return slope1(p.s(ch, di - ox, dj - oy, dk - oz), p.s(ch, di, dj, dk),
                  p.s(ch, di + ox, dj + oy, dk + oz), a.ph.slope);
  }

  HD void operator()(long long t) const {
    if (!*a.active) return;
    at(Site<T, M>(a, t));
  }
  template <typename P>
  HD void at(const P& p) const {
    const long long n = p.nq(), c = p.cq();
    const Phys<T>& ph = a.ph;
    const long long cxm = p.iq(-1, 0, 0), cxp = p.iq(1, 0, 0);
    const long long cym = p.iq(0, -1, 0), cyp = p.iq(0, 1, 0);
    const long long czm = p.iq(0, 0, -1), czp = p.iq(0, 0, 1);

    const T dt = *a.dt;
    const T dtdx = dt / ph.dx, dtdy = dt / ph.dy, dtdz = dt / ph.dz;

    // cell values and half-slopes of Q
    T q[8], hx[8], hy[8], hz[8];
#pragma unroll
    for (int ch = 0; ch < 8; ++ch) {
      const T* Qc = a.Q + ch * n;
      q[ch] = Qc[c];
      hx[ch] = T(0.5) * slope1(Qc[cxm], Qc[c], Qc[cxp], ph.slope);
      hy[ch] = T(0.5) * slope1(Qc[cym], Qc[c], Qc[cyp], ph.slope);
      hz[ch] = T(0.5) * slope1(Qc[czm], Qc[c], Qc[czp], ph.slope);
    }

    // face-centred fields, their right faces and transverse slopes
    const T AL = p.s(IA, 0, 0, 0), AR = p.s(IA, 1, 0, 0);
    const T BL = p.s(IB, 0, 0, 0), BR = p.s(IB, 0, 1, 0);
    const T CL = p.s(IC, 0, 0, 0), CR = p.s(IC, 0, 0, 1);

    const T dALy = T(0.5) * sls(p, IA, 1, 0, 0, 0);
    const T dALz = T(0.5) * sls(p, IA, 2, 0, 0, 0);
    const T dARy = T(0.5) * sls(p, IA, 1, 1, 0, 0);
    const T dARz = T(0.5) * sls(p, IA, 2, 1, 0, 0);
    const T dBLx = T(0.5) * sls(p, IB, 0, 0, 0, 0);
    const T dBLz = T(0.5) * sls(p, IB, 2, 0, 0, 0);
    const T dBRx = T(0.5) * sls(p, IB, 0, 0, 1, 0);
    const T dBRz = T(0.5) * sls(p, IB, 2, 0, 1, 0);
    const T dCLx = T(0.5) * sls(p, IC, 0, 0, 0, 0);
    const T dCLy = T(0.5) * sls(p, IC, 1, 0, 0, 0);
    const T dCRx = T(0.5) * sls(p, IC, 0, 0, 0, 1);
    const T dCRy = T(0.5) * sls(p, IC, 1, 0, 0, 1);

    const T dAx = T(0.5) * (AR - AL);
    const T dBy = T(0.5) * (BR - BL);
    const T dCz = T(0.5) * (CR - CL);

    // the 2x2 electric-field stencils around the cell (L = this, R = next)
    const long long ne = p.ne(), ec = p.ce();
    const long long exp_ = p.ie(1, 0, 0), eyp = p.ie(0, 1, 0), ezp = p.ie(0, 0, 1);
    const T* Ex = a.E;
    const T* Ey = a.E + ne;
    const T* Ez = a.E + 2 * ne;
    const T ELL = Ex[ec], ELR = Ex[ezp], ERL = Ex[eyp], ERR = Ex[p.ie(0, 1, 1)];
    const T FLL = Ey[ec], FLR = Ey[ezp], FRL = Ey[exp_], FRR = Ey[p.ie(1, 0, 1)];
    const T GLL = Ez[ec], GLR = Ez[eyp], GRL = Ez[exp_], GRR = Ez[p.ie(1, 1, 0)];

    const T r = q[ID], pr = q[IP], u = q[IU], v = q[IV], w = q[IW];
    const T A = q[IA], B = q[IB], C = q[IC];
    const T drx = hx[ID], dpx = hx[IP], dux = hx[IU], dvx = hx[IV], dwx = hx[IW];
    const T dBx = hx[IB], dCx = hx[IC];
    const T dry = hy[ID], dpy = hy[IP], duy = hy[IU], dvy = hy[IV], dwy = hy[IW];
    const T dAy = hy[IA], dCy = hy[IC];
    const T drz = hz[ID], dpz = hz[IP], duz = hz[IU], dvz = hz[IV], dwz = hz[IW];
    const T dAz = hz[IA], dBz = hz[IB];
    const T gamma = ph.gamma0;

    // source terms (trace_mhd.h:1127-1155), one hoisted 1/r
    const T inv_r = T(1) / r;
    T sr0 = (-u * drx - dux * r) * dtdx + (-v * dry - dvy * r) * dtdy +
            (-w * drz - dwz * r) * dtdz;
    T su0 = (-u * dux - (dpx + B * dBx + C * dCx) * inv_r) * dtdx +
            (-v * duy + B * dAy * inv_r) * dtdy + (-w * duz + C * dAz * inv_r) * dtdz;
    T sv0 = (-u * dvx + A * dBx * inv_r) * dtdx +
            (-v * dvy - (dpy + A * dAy + C * dCy) * inv_r) * dtdy +
            (-w * dvz + C * dBz * inv_r) * dtdz;
    T sw0 = (-u * dwx + A * dCx * inv_r) * dtdx + (-v * dwy + B * dCy * inv_r) * dtdy +
            (-w * dwz - (dpz + A * dAz + B * dBz) * inv_r) * dtdz;
    T sp0 = (-u * dpx - dux * gamma * pr) * dtdx + (-v * dpy - dvy * gamma * pr) * dtdy +
            (-w * dpz - dwz * gamma * pr) * dtdz;
    T sA0 = (u * dBy + B * duy - v * dAy - A * dvy) * dtdy +
            (u * dCz + C * duz - w * dAz - A * dwz) * dtdz;
    T sB0 = (v * dAx + A * dvx - u * dBx - B * dux) * dtdx +
            (v * dCz + C * dvz - w * dBz - B * dwz) * dtdz;
    T sC0 = (w * dAx + A * dwx - u * dCx - C * dux) * dtdx +
            (w * dBy + B * dwy - v * dCy - C * dvy) * dtdy;
    if constexpr (M::SHEAR) {
      // the background shear's advection and stretching (trace_mhd3d.py:231-240)
      const T shear = ph.shear_k * p.xpos();
      sr0 = sr0 - shear * dry * dtdy;
      su0 = su0 - shear * duy * dtdy;
      sv0 = sv0 - shear * dvy * dtdy;
      sw0 = sw0 - shear * dwy * dtdy;
      sp0 = sp0 - shear * dpy * dtdy;
      sA0 = sA0 - shear * dAy * dtdy;
      sB0 = sB0 + (shear * dAx - ph.rot15 * A * ph.dx) * dtdx + shear * dBz * dtdz;
      sC0 = sC0 - shear * dCy * dtdy;
    }

    // face-centred field half-step (induction; trace_mhd.h:1152-1158)
    const T h = T(0.5);
    const T sAL0 = (GLR - GLL) * dtdy * h - (FLR - FLL) * dtdz * h;
    const T sAR0 = (GRR - GRL) * dtdy * h - (FRR - FRL) * dtdz * h;
    const T sBL0 = -(GRL - GLL) * dtdx * h + (ELR - ELL) * dtdz * h;
    const T sBR0 = -(GRR - GLR) * dtdx * h + (ERR - ERL) * dtdz * h;
    const T sCL0 = (FRL - FLL) * dtdx * h - (ERL - ELL) * dtdy * h;
    const T sCR0 = (FRR - FLR) * dtdx * h - (ERR - ELR) * dtdy * h;

    // half-step cell values q2 and face values (L/R per axis)
    T q2[8];
    q2[ID] = r + sr0;
    q2[IP] = pr + sp0;
    q2[IU] = u + su0;
    q2[IV] = v + sv0;
    q2[IW] = w + sw0;
    q2[IA] = A + sA0;
    q2[IB] = B + sB0;
    q2[IC] = C + sC0;
    const T L2[3] = {AL + sAL0, BL + sBL0, CL + sCL0};
    const T R2[3] = {AR + sAR0, BR + sBR0, CR + sCR0};
    // transverse half-slopes of the face fields: dF[face axis][L/R][along]
    // (only the two transverse entries are kept)
    const T dF[3][2][3] = {
        {{T(0), dALy, dALz}, {T(0), dARy, dARz}},
        {{dBLx, T(0), dBLz}, {dBRx, T(0), dBRz}},
        {{dCLx, dCLy, T(0)}, {dCRx, dCRy, T(0)}},
    };
    const T* hd[3] = {hx, hy, hz};
    T* out = a.pre;
#pragma unroll
    for (int ch = 0; ch < 8; ++ch) out[p.ipre(PQ + ch)] = q2[ch];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
#pragma unroll
      for (int ch = 0; ch < 8; ++ch)
        if (ch != IA + ax) out[p.ipre(ph_slot(ax, ch))] = hd[ax][ch];
      out[p.ipre(PL + ax)] = L2[ax];
      out[p.ipre(PR + ax)] = R2[ax];
#pragma unroll
      for (int side = 0; side < 2; ++side)
#pragma unroll
        for (int along = 0; along < 3; ++along)
          if (along != ax) out[p.ipre(pf_slot(ax, side, along))] = dF[ax][side][along];
    }
    // stratified: the half-dt kick of the vertical gravity on every traced
    // state (godunov_mhd.py:213-218, after the floors)
    if constexpr (M::STRAT) out[p.ipre(PKICK)] = (T(0.5) * dt) * p.gz();
  }
};

// channel ch of the traced state S (STATE_NAMES order) of the neighbour
// (di, dj, dk) of site p, formed from its precursors (p.pre) as the trace
// forms it (trace_mhd3d.py trace_mhd3d_state_parts): a face state is q2 -+
// the half-slope of its axis (the face-normal field: L2 or R2), an edge
// state of family f (edges along f, varying in d1 < d2; RT (+,+), RB (+,-),
// LT (-,+), LB (-,-)) adds the half-slopes of d1 and d2 in turn (a face
// field: its L2 or R2 and its transverse half-slope), then the floors and,
// stratified, the gravity kick. The signs are +-1, so the state equals the
// one the trace would store, bit for bit.
template <typename M, int S, typename T, typename P>
HD T traced(const Phys<T>& ph, const P& p, int di, int dj, int dk, int ch) {
  const auto at = [&](int v) { return p.pre(v, di, dj, dk); };
  T val;
  if constexpr (S < 6) {
    constexpr int ax = S / 2, side = S % 2;
    const T s = side ? T(1) : T(-1);
    val = ch == IA + ax ? at(side ? PR + ax : PL + ax) : at(PQ + ch) + s * at(ph_slot(ax, ch));
  } else {
    constexpr int f = (S - 6) / 4, e = (S - 6) % 4;
    constexpr int d1 = f == 0 ? 1 : 0, d2 = f == 2 ? 1 : 2;
    constexpr int p1 = e < 2 ? 1 : 0, p2 = e % 2 == 0 ? 1 : 0;  // R in d1, T in d2
    const T s1 = p1 ? T(1) : T(-1);
    const T s2 = p2 ? T(1) : T(-1);
    if (ch == IA + d1)
      val = at(p1 ? PR + d1 : PL + d1) + s2 * at(pf_slot(d1, p1, d2));
    else if (ch == IA + d2)
      val = at(p2 ? PR + d2 : PL + d2) + s1 * at(pf_slot(d2, p2, d1));
    else
      val = at(PQ + ch) + s1 * at(ph_slot(d1, ch)) + s2 * at(ph_slot(d2, ch));
  }
  if (ch == ID) val = pmax(ph.smallr, val);
  if (ch == IP) val = pmax(ph.smallp, val);
  if constexpr (M::STRAT) {
    if (ch == IW) val = val + at(PKICK);
  }
  return val;
}

// 4: the face solver's flux at each cell's left x, y, z face
// (godunov_mhd.py mhd_fluxes_emfs: qm of the previous cell against this
// cell's qp, the y/z problems rotated into the x slots and the flux rotated
// back) and the corner solver's EMFs at its z, y, x edges (note the
// reference's RB/LT role swap for EMF_Y; the shearing-box upwind term is
// added to whichever corner solver's EMF), each state formed from the
// precursors (traced) where it is read. HLLD / 2D-HLLD, or in the general
// instances the block's pair (riemann_face, mag_riemann2d). p: a site
// whose pre() reads the precursors of the cell and of its -1 neighbours
// (x, y, z and the pairs xy, xz, yz). operator() is one cell
// of the stage grid read from the stage buffer (the operation counts);
// the kernel runs it on a tile (mhd_step.cu FluxEmfStage).
template <typename T, typename M>
struct FluxEmf {
  StepArgs<T> a;
  // state S of the neighbour (di, dj, dk), its channels permuted
  template <int S, typename P>
  HD void state(const P& p, int di, int dj, int dk, const int* perm, T* q) const {
#pragma unroll
    for (int ch = 0; ch < 8; ++ch) q[ch] = traced<M, S>(a.ph, p, di, dj, dk, perm[ch]);
    if constexpr (M::GRAV) {
      // the uniform gravity's half-dt kick, after the floors
      const T half = T(0.5) * *a.dt;
#pragma unroll
      for (int ch = 0; ch < 8; ++ch)
        if (perm[ch] >= IU && perm[ch] <= IW) q[ch] = q[ch] + half * a.ph.grav[perm[ch] - IU];
    }
  }
  HD void operator()(long long t) const {
    if (!*a.active) return;
    at(Site<T, M>(a, t));
  }
  template <typename P>
  HD void at(const P& p) const {
    for (int k = 0; k < 6; ++k) part(p, k);
  }
  // output k: the x, y, z face fluxes (0-2), the z, y, x edge EMFs (3-5);
  // the kernels pick k at run time, so each part is compiled on its own,
  // alike in both (mhd_step.cu FluxEmfStage, zcarry_mhd.cu)
  template <typename P>
  HD void part(const P& p, int k) const {
    switch (k) {
      case 0: axis<0>(p); break;
      case 1: axis<1>(p); break;
      case 2: axis<2>(p); break;
      case 3: edge<0>(p); break;
      case 4: edge<1>(p); break;
      default: edge<2>(p); break;
    }
  }
  // the flux through the cell's left face along AX
  template <int AX, typename P>
  HD void axis(const P& p) const {
    const long long n = p.nflux(), c = p.cflux();
    // component rotation of the sweep (godunov_mhd.py _PERM_Y/_Z)
    const int perm[8] = {ID, IP, AX == 0 ? IU : AX == 1 ? IV : IW, AX == 1 ? IU : IV,
                         AX == 2 ? IU : IW, AX == 0 ? IA : AX == 1 ? IB : IC,
                         AX == 1 ? IA : IB, AX == 2 ? IA : IC};
    T ql[8], qr[8], f[NFLUX];
    // qm of the previous cell, qp of this one
    state<2 * AX + 1>(p, -(AX == 0), -(AX == 1), -(AX == 2), perm, ql);
    state<2 * AX>(p, 0, 0, 0, perm, qr);
    riemann_face<M>(a.ph, ql, qr, f);
    T* out = a.fl + (long long)AX * NFLUX * n;
    // rotate back: out[ch] = f[perm[ch]] (perm is an involution and keeps
    // the five hydro slots among themselves)
#pragma unroll
    for (int ch = 0; ch < NFLUX; ++ch) out[ch * n + c] = f[perm[ch]];
  }
  // the EMF of the cell's edge family F: 0 z, 1 y, 2 x
  template <int F, typename P>
  HD void edge(const P& p) const {
    const long long n = p.nflux(), c = p.cflux();
    const int id[8] = {0, 1, 2, 3, 4, 5, 6, 7};
    T qRT[8], qRB[8], qLT[8], qLB[8];
    if constexpr (F == 0) {
      // EMF_Z at (i-1/2, j-1/2, k)
      state<RT_Z>(p, -1, -1, 0, id, qRT);
      state<RB_Z>(p, -1, 0, 0, id, qRB);
      state<LT_Z>(p, 0, -1, 0, id, qLT);
      state<LB_Z>(p, 0, 0, 0, id, qLB);
      T ez = compute_emf<M>(a.ph, qRT, qRB, qLT, qLB, IU, IV, IW, IA, IB, IC);
      if constexpr (M::SHEAR) {
        // upwind shear term on the in-plane Bx (riemann_mhd.py:604-605)
        const T shear = a.ph.shear_k * (p.xpos() - a.ph.dx_half);
        ez = ez - shear_upwind(shear, T(0.5) * (qRT[IA] + qLT[IA]), T(0.5) * (qRB[IA] + qLB[IA]));
      }
      a.emf[c] = ez;
    } else if constexpr (F == 1) {
      // EMF_Y at (i-1/2, j, k-1/2)
      state<RT_Y>(p, -1, 0, -1, id, qRT);
      state<LT_Y>(p, 0, 0, -1, id, qRB);
      state<RB_Y>(p, -1, 0, 0, id, qLT);
      state<LB_Y>(p, 0, 0, 0, id, qLB);
      a.emf[n + c] = compute_emf<M>(a.ph, qRT, qRB, qLT, qLB, IW, IU, IV, IC, IA, IB);
    } else {
      // EMF_X at (i, j-1/2, k-1/2)
      state<RT_X>(p, 0, -1, -1, id, qRT);
      state<RB_X>(p, 0, -1, 0, id, qRB);
      state<LT_X>(p, 0, 0, -1, id, qLT);
      state<LB_X>(p, 0, 0, 0, id, qLB);
      T ex = compute_emf<M>(a.ph, qRT, qRB, qLT, qLB, IV, IW, IU, IB, IC, IA);
      if constexpr (M::SHEAR) {
        // upwind shear term on the in-plane Bz (riemann_mhd.py:601-603)
        const T shear = a.ph.shear_k * p.xpos();
        ex = ex + shear_upwind(shear, T(0.5) * (qRT[IC] + qRB[IC]), T(0.5) * (qLT[IC] + qLB[IC]));
      }
      a.emf[2 * n + c] = ex;
    }
  }
};

// the CT increment of the face field ch (IA, IB or IC) of stage cell c from
// the edge EMFs of c and of its +1 neighbours cxp, cyp, czp
// (godunov_mhd.py mhd_apply_update); COMP rounds each operation on its own
template <bool COMP, typename T>
HD T ct_delta(const T* emf, long long n, int ch, long long c, long long cxp, long long cyp,
              long long czp, T dtdx, T dtdy, T dtdz) {
  const T* ez = emf;
  const T* ey = emf + n;
  const T* ex = emf + 2 * n;
  // dB = (f1[c + 1 along a1] - f1[c]) s1 - (f2[c + 1 along a2] - f2[c]) s2
  const T* f1 = ch == IA ? ez : (ch == IB ? ex : ey);
  const T* f2 = ch == IA ? ey : (ch == IB ? ez : ex);
  const long long n1 = ch == IA ? cyp : (ch == IB ? czp : cxp);
  const long long n2 = ch == IA ? czp : (ch == IB ? cxp : cyp);
  const T s1 = ch == IA ? dtdy : (ch == IB ? dtdz : dtdx);
  const T s2 = ch == IA ? dtdz : (ch == IB ? dtdx : dtdy);
  if constexpr (COMP) return r_sub(r_mul(r_sub(f1[n1], f1[c]), s1), r_mul(r_sub(f2[n2], f2[c]), s2));
  return (f1[n1] - f1[c]) * s1 - (f2[n2] - f2[c]) * s2;
}

// 5: godunov_mhd.py mhd_apply_update: flux divergence and CT curl, in
// place; the ghosted mode adds the flux divergence to the interior only
// and the CT curl to the cube g .. n + g of every axis, as the JAX
// whole-array step does (godunov_mhd.py:657-669, 733-744); the shear mode
// also writes the x-face planes of the remap
// (godunov_mhd.py:429-434). Stratified: the conservative gravity source
// with the time-centred momentum (godunov_mhd.py:375-413). COMP: each
// channel's increment is Kahan-added against the carry C (the gravity
// source chained through it), every operation rounded on its own in the
// twin's order (r_mul, r_add, r_sub), so the update repeats the twin's
// roundings exactly on the same fluxes and EMFs. The cell's state is read
// before anything is written (So may be S), so its loads overlap. With
// res, the cell's new state is also left there (res[ch]).
template <typename T, typename M, bool COMP>
struct UpdateStage {
  StepArgs<T> a;
  HD void operator()(long long t) const {  // t: the state's cell
    if (!*a.active) return;
    at(Site<T, M>(a, t, true));
  }
  template <typename P>
  HD void at(const P& p, T* res = nullptr) const {  // p: a state cell
    const long long n = p.nflux(), c = p.cflux();
    const long long cxp = p.iflux(1, 0, 0), cyp = p.iflux(0, 1, 0), czp = p.iflux(0, 0, 1);
    const T dt = *a.dt;
    const T dtdx = dt / a.ph.dx, dtdy = dt / a.ph.dy, dtdz = dt / a.ph.dz;
    const T* fx = a.fl;
    const T* fy = a.fl + NFLUX * n;
    const T* fz = a.fl + 2 * NFLUX * n;
    const T* ez = a.emf;
    const T* ey = a.emf + n;
    const T* ex = a.emf + 2 * n;
    const T* S = a.S;
    T* So = a.So;
    const long long ns = a.d.n, cs = p.cs;
    // where the update goes: the state in place, or the window's interior
    long long no = ns, co = cs;
    if constexpr (M::WINDOW) {
      no = a.in.n;
      co = p.co;
    }
    T u[8];
#pragma unroll
    for (int ch = 0; ch < 8; ++ch) u[ch] = S[ch * ns + cs];
    if constexpr (COMP) {
      static_assert(!M::WINDOW && !M::GRAV, "the window and gravity modes have no compensated update");
      T d[8], cc[8];
#pragma unroll
      for (int ch = 0; ch < 8; ++ch) cc[ch] = a.C[ch * ns + cs];
#pragma unroll
      for (int ch = 0; ch < NFLUX; ++ch) {
        const long long o = ch * n;
        d[ch] = r_add(r_add(r_mul(dtdx, r_sub(fx[o + c], fx[o + cxp])),
                            r_mul(dtdy, r_sub(fy[o + c], fy[o + cyp]))),
                      r_mul(dtdz, r_sub(fz[o + c], fz[o + czp])));
      }
#pragma unroll
      for (int ch = IA; ch <= IC; ++ch)
        d[ch] = ct_delta<true>(a.emf, n, ch, c, cxp, cyp, czp, dtdx, dtdy, dtdz);
      const T rho_old = u[ID], w_old = u[IW];
#pragma unroll
      for (int ch = 0; ch < 8; ++ch) kahan_add(u[ch], cc[ch], d[ch]);
      if constexpr (M::STRAT) {
        const T g = p.gz();
        const T mom_half = r_mul(T(0.5), r_add(w_old, u[IW]));
        kahan_add(u[IW], cc[IW], r_mul(r_mul(dt, rho_old), g));
        kahan_add(u[IP], cc[IP], r_mul(r_mul(dt, mom_half), g));
      }
#pragma unroll
      for (int ch = 0; ch < 8; ++ch) {
        So[ch * ns + cs] = u[ch];
        a.Co[ch * ns + cs] = cc[ch];
      }
    } else {
      const T rho_old = u[ID], w_old = u[IW];
      T m_old[3];
      if constexpr (M::GRAV) {
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) m_old[ax] = u[IU + ax];
      }
      bool hydro = true;  // ghosted: the CT face layer takes the curl only
      if constexpr (M::GHOST && !M::WINDOW) hydro = p.interior();
      if (hydro) {
#pragma unroll
        for (int ch = 0; ch < NFLUX; ++ch) {
          const long long o = ch * n;
          const T dU = dtdx * (fx[o + c] - fx[o + cxp]) + dtdy * (fy[o + c] - fy[o + cyp]) +
                       dtdz * (fz[o + c] - fz[o + czp]);
          u[ch] = u[ch] + dU;
        }
      }
#pragma unroll
      for (int ch = IA; ch <= IC; ++ch)
        u[ch] = u[ch] + ct_delta<false>(a.emf, n, ch, c, cxp, cyp, czp, dtdx, dtdy, dtdz);
      if constexpr (M::STRAT) {
        const T g = p.gz();
        const T w_new = u[IW];
        const T mom_half = T(0.5) * (w_old + w_new);
        u[IW] = w_new + dt * rho_old * g;
        u[IP] = u[IP] + dt * mom_half * g;
      }
      if constexpr (M::GRAV) {
        // the uniform gravity's source on the interior, per axis in turn
        // (godunov_mhd.py _gravity_source)
        if (hydro) {
#pragma unroll
          for (int ax = 0; ax < 3; ++ax) {
            const T g = a.ph.grav[ax];
            const T mom_half = T(0.5) * (m_old[ax] + u[IU + ax]);
            u[IU + ax] = u[IU + ax] + dt * rho_old * g;
            u[IP] = u[IP] + dt * mom_half * g;
          }
        }
      }
#pragma unroll
      for (int ch = 0; ch < 8; ++ch)
        if (hydro || ch >= IA) So[ch * no + co] = u[ch];
    }
    if (res != nullptr) {
#pragma unroll
      for (int ch = 0; ch < 8; ++ch) res[ch] = u[ch];
    }
    if constexpr (M::SHEAR) {
      const Dims& dp = M::WINDOW ? a.in : a.d;  // the planes' (z, y) extent
      const long long np = (long long)dp.nz * dp.ny;
      const long long pc = (long long)p.k * dp.ny + p.j;
      if (p.i == 0) {
        a.planes[pc] = fx[c];           // density flux at face 0
        a.planes[2 * np + pc] = ey[c];  // emfY at face 0
      }
      if (p.i == dp.nx - 1) {
        a.planes[np + pc] = fx[cxp];        // density flux at face nx
        a.planes[3 * np + pc] = ey[cxp];    // emfY at face nx
        a.planes[4 * np + pc] = ez[cxp];    // emfZ at face nx
      }
    }
  }
};

}  // namespace ramses::mhd
