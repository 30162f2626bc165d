// One unsplit MUSCL-Hancock step of 3D ideal MHD with constrained
// transport (HLLD face fluxes, 2D-HLLD corner EMFs), in two modes:
//
// - periodic: the fully periodic state. Replaces the TPU kernel
//   ramsesgpu_tpu/pallas/packed_io.py:148 make_packed_io_step with the
//   MHD body pallas/fused_mhd3d.py:228 -> solvers/godunov_mhd.py:437
//   mhd_3d_interior_update_staged. Plain twin:
//   ramsesgpu_tpu_torch/solvers/godunov_mhd.py mhd_3d_periodic_update.
// - shearing box: the rotating frame (Coriolis half-kick, the shear terms
//   of the trace and of the x and z EMFs, per-column x), the isothermal
//   EOS (cIso > 0) or the adiabatic one, sheared-periodic x faces, y and z
//   periodic. Replaces the MRI main kernel shear_packed.py:89
//   _make_main_kernel and the border strip kernel shear_packed.py:237
//   _make_strip_kernel (mode "godunov"): the TPU strip exists because
//   x-ghost-free lane-exact rows cannot hold ghost columns; here an x
//   load outside [0, nx) reads the sheared ghost slabs (built each step
//   by shear_border.cu), and the stages' x extent grows just enough for
//   the faces and edges 0..nx, so every face is computed once. The update
//   writes the unremapped x-face planes (density flux at faces 0 and nx,
//   emfY there, emfZ at face nx) that shear_border.cu remaps. Plain twin:
//   solvers/godunov_mhd.py mhd_3d_shear_update.
// - stratified (the shear mode with BC_Z_STRATIFIED z faces and the static
//   vertical gravity; isothermal): replaces the MRI main kernel with its
//   gravity_z aux plane (shear_packed.py:89, :117-131) and the strip's
//   gravity. A z load outside [0, nz) reads the stratified z slabs
//   (shear_border.cu ZSlabBuild, whose x extent covers the x slabs'
//   columns), the stage grid grows by ZH rows on each z side as it does by
//   XH columns in x, the traced states get the half-dt kick of g_z and the
//   update the conservative source with the time-centred momentum
//   (godunov_mhd.py:213-218, 375-413). g_z comes in per z row, ghost rows
//   included (the run's gravity field column).
// - compensated (any mode; TPU row A'-compensated, fused_mhd3d.py:247-259):
//   S holds 16 channels, the state and then its Kahan carry; the update
//   stage Kahan-adds each channel's increment (and chains the gravity
//   source through the carry), every operation of that stage rounded on
//   its own with intrinsics (r_mul, r_add, r_sub), so on the same fluxes
//   and EMFs it repeats the twin's roundings exactly. The file keeps FMA
//   contraction elsewhere: -fmad=false on the whole file costs the plain
//   periodic step ~1 % (PERF.md), the intrinsics cost the plain modes
//   nothing (their update stage is another instantiation).
//
// Layout: the interior-only state S[8][nz][ny][nx], x fastest
// (common.cuh). Neighbours wrap by index in y and z (and in x, periodic
// mode), so the TPU layout's 8-row y ghost bands and in-kernel ghost band
// writes have no counterpart: pack is a slice, unpack the ghost fill.
//
// Design (first, simple version): six stages, one thread per cell each,
// intermediates in device memory (one scratch buffer the Python wrapper
// allocates once per advance):
//   1 prim    S -> Q[8]           constoprim, cell-centred B
//   2 efield  Q, S -> E[3]        edge-centred Ex, Ey, Ez of the trace
//   3 trace   Q, S, E -> st[18][8] face states qp/qm (x, y, z) and the
//                                  4 corner states of each edge family
//   4 flux    st -> fl[3][5]      HLLD flux at each cell's left x/y/z face
//   5 emf     st -> emf[3]        2D-HLLD EMF on the z, y, x edges
//   6 update  S += dU, CT curl    in place (reads only fluxes, EMFs and the
//                                  cell's own S)
// In the shearing-box mode the intermediates live on a stage grid of
// nx + 2*XH columns (XH = 2 on each side). Stages 1-5 compute every cell
// of it, with their x reads clamped to the grid (and the state's to its
// slabs): the cells later stages read, columns -2..nx+1 for prim down to
// 0..nx for the fluxes and EMFs, see only unclamped data, and the stages
// write whole rows: skipping the unneeded edge columns left partly
// written cache lines on every row, whose read-modify-write slowed the
// store-heavy trace far below the periodic mode's rate (PERF.md). The
// update runs on the state's cells. Only prim loads the state through the
// slab rule (a branch per load); it copies its cell's state onto the
// stage grid (Se[8]), which efield and trace then read by plain index.
// The per-cell physics is transcribed from the JAX formulas (ops/eos.py,
// ops/slopes.py, ops/trace_mhd3d.py, ops/riemann_mhd.py,
// solvers/godunov_mhd.py) keeping their hoisted reciprocals and shared
// fast-speed precursors. Parity with the twins is tolerance-based (FMA
// contraction, rsqrtf), never bitwise.
//
// A device flag `active` (the loop's t < t_end test) is read by every
// stage; when it is 0 the step is skipped, so a chunk needs no host sync.
//
// Bound on the H100: the step's least time is its arithmetic, 2979
// counted flops per cell (op_count.cuh), 0.75 ms at 256^3 at the f32
// peak, against 64 B/cell of state read and written (0.32 ms at
// 3.35 TB/s). This staged version is bound by its own stage traffic
// instead: per cell and step the stages write 8+3+144+15+3+8 = 181 values
// and read about as many (the trace's 144 state values are each read by
// the flux or EMF stage), ~1.4 kB per cell in f32, ~24 GB at 256^3, ~7 ms
// per step at 3.35 TB/s. Fusing stages to keep the 144 state values on
// chip is the next step for speed.
#include "common.cuh"

// its own namespace, as hydro_step.cu's (shared stage type names)
namespace ramses::mhd {

constexpr int NSTATE = 18;  // order: ops/trace_mhd3d.py STATE_NAMES
enum {
  QP_X = 0, QM_X, QP_Y, QM_Y, QP_Z, QM_Z,
  RT_X, RB_X, LT_X, LB_X,
  RT_Y, RB_Y, LT_Y, LB_Y,
  RT_Z, RB_Z, LT_Z, LB_Z
};
constexpr int NFLUX = 5;  // rho, E, three momenta
constexpr long long SCRATCH_PER_CELL = 8 + 3 + NSTATE * 8 + 3 * NFLUX + 3;
constexpr long long SHEAR_SCRATCH_PER_CELL = SCRATCH_PER_CELL + 8;  // + Se
constexpr int SLAB = 3;   // ghost columns of each sheared slab (ghost_width)
constexpr int XH = 2;     // stage-grid columns beyond each x face (shear mode)
constexpr int ZH = 2;     // stage-grid rows beyond each z face (stratified mode)
constexpr int NPLANE = 5; // x-face planes written by the shear-mode update

// the kernel's mode: SHEAR (shearing box, rotating frame), ISO (the
// isothermal pressure in the solvers) and STRAT (the stratified MRI:
// BC_Z_STRATIFIED z faces and the static vertical gravity); the periodic
// mode is <false, false, false>
template <bool SHEAR_, bool ISO_, bool STRAT_ = false>
struct Mode {
  static constexpr bool SHEAR = SHEAR_;
  static constexpr bool ISO = ISO_;
  static constexpr bool STRAT = STRAT_;
};
using Periodic = Mode<false, false>;

template <typename T>
struct StepArgs {
  T* S;         // [8][n]     state, updated in place by stage 6
  T* Q;         // [8][ne]    primitives (ne: stage-grid cells)
  T* E;         // [3][ne]    Ex, Ey, Ez at the trace's edge centres
  T* st;        // [18][8][ne] face / edge states
  T* fl;        // [3][5][ne] face fluxes x, y, z
  T* emf;       // [3][ne]    edge EMFs z, y, x
  T* Se;        // shear: [8][ne] the state on the stage grid (written by prim)
  const T* slabs;  // shear: [2][8][nz][ny][SLAB] sheared x ghosts (XMIN, XMAX)
  T* planes;       // shear: [5][nz][ny] x-face planes
  T* C;            // compensated: [8][n] the Kahan carry (S's channels 8-15), else null
  const T* zslabs; // stratified: [2][8][SLAB][ny][nx + 2 SLAB] z ghosts (ZMIN, ZMAX)
  const T* gz;     // stratified: [nz + 2 SLAB] g_z of each z row, ghost rows included
  const T* dt;  // device scalar
  const unsigned char* active;  // device flag: 0 skips the step
  Dims d;       // the state's
  Dims e;       // the stage grid's: d (periodic), nx + 2 XH columns (shear),
                // and nz + 2 ZH rows (stratified)
  Phys<T> ph;
};

HD int clamp_i(int i, int lo, int hi) { return i < lo ? lo : (i > hi ? hi : i); }

HD int wrap_d(int i, int di, int n) {
  return di == 0 ? i : (di > 0 ? wrap_p(i, n) : wrap_m(i, n));
}

// One stage thread's cell (i, j, k) and its neighbours. Periodic: the
// stage grid is the state's and every offset wraps. Shear: stage column
// i sits at i + XH and x reads clamp to the grid; a state load (src)
// outside [0, nx) reads the slab, and the stages after prim read the
// state from its stage-grid copy (s). Stratified: the same in z, stage
// row k at k + ZH, a state load outside [0, nz) reading the z slabs
// (whose x extent covers the x slabs' columns too).
template <typename T, typename M>
struct Site {
  static constexpr int ZOFF = M::STRAT ? ZH : 0;
  const StepArgs<T>& a;
  int i, j, k;
  long long c;  // stage-grid index of (i, j, k)

  // t: the thread's index, its stage-grid cell, or (on_state) its state cell
  HD Site(const StepArgs<T>& a_, long long t, bool on_state = false) : a(a_) {
    if constexpr (M::SHEAR) {
      if (on_state) {
        cell_ijk(a.d, t, i, j, k);
        c = cell_at(a.e, i + XH, j, k + ZOFF);
        return;
      }
      cell_ijk(a.e, t, i, j, k);
      i -= XH;
      k -= ZOFF;
    } else {
      cell_ijk(a.d, t, i, j, k);
    }
    c = t;
  }
  // stage-grid index of the neighbour (i+di, j+dj, k+dk)
  HD long long q(int di, int dj, int dk) const {
    if (!M::SHEAR && di == 0 && dj == 0 && dk == 0) return c;
    // (kk before the branch: nvcc then gives the periodic f32 trace stage
    // 128 registers, not 96, and that stage runs ~1 % faster; PERF.md)
    const int jj = wrap_d(j, dj, a.d.ny);
    const int kk = M::STRAT ? clamp_i(k + dk, -ZH, a.e.nz - ZH - 1) + ZH : wrap_d(k, dk, a.d.nz);
    if constexpr (M::SHEAR)
      return cell_at(a.e, clamp_i(i + di, -XH, a.e.nx - XH - 1) + XH, jj, kk);
    return cell_at(a.d, wrap_d(i, di, a.d.nx), jj, kk);
  }
  // the state's channel ch at the neighbour, after prim
  HD T s(int ch, int di, int dj, int dk) const {
    if constexpr (M::SHEAR) return a.Se[ch * a.e.n + q(di, dj, dk)];
    return a.S[ch * a.d.n + q(di, dj, dk)];
  }
  // the state's channel ch at the neighbour, from the state or a slab
  HD T src(int ch, int di, int dj, int dk) const {
    if constexpr (M::SHEAR) {
      const int ii = clamp_i(i + di, -SLAB, a.d.nx + SLAB - 1);
      const int jj = wrap_d(j, dj, a.d.ny);
      if constexpr (M::STRAT) {
        const int kk = clamp_i(k + dk, -SLAB, a.d.nz + SLAB - 1);
        if (kk < 0 || kk >= a.d.nz) {
          const int side = kk < 0 ? 0 : 1;
          const int row = kk < 0 ? kk + SLAB : kk - a.d.nz;
          return a.zslabs[((((long long)side * 8 + ch) * SLAB + row) * a.d.ny + jj) *
                              (a.d.nx + 2 * SLAB) + ii + SLAB];
        }
        return src_x(ch, ii, jj, kk);
      } else {
        return src_x(ch, ii, jj, wrap_d(k, dk, a.d.nz));
      }
    } else {
      return a.S[ch * a.d.n + q(di, dj, dk)];
    }
  }
  // shear: the state's channel ch at column ii of the interior or a slab
  HD T src_x(int ch, int ii, int jj, int kk) const {
    if (ii >= 0 && ii < a.d.nx) return a.S[ch * a.d.n + cell_at(a.d, ii, jj, kk)];
    const int side = ii < 0 ? 0 : 1;
    const int col = ii < 0 ? ii + SLAB : ii - a.d.nx;
    return a.slabs[((((long long)side * 8 + ch) * a.d.nz + kk) * a.d.ny + jj) * SLAB + col];
  }
  // cell-centre x of column i (godunov_mhd.py:44 xpos_array)
  HD T xpos() const { return a.ph.xpos0 + r_mul(T(i), a.ph.dx); }
  // stratified: g_z of row k (problems/mhd_inits.py mri_gravity_field)
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
  return mag_riemann2d_hlld<M>(ph, qLL, qRL, qLR, qRR, eLL, eRL, eLR, eRR);
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
    const Site<T, M> p(a, t);
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
    const long long n = a.e.n, c = p.c;
    T* Q = a.Q;
    Q[ID * n + c] = rho;
    Q[IP * n + c] = pr;
    Q[IU * n + c] = u;
    Q[IV * n + c] = v;
    Q[IW * n + c] = w;
    Q[IA * n + c] = bx;
    Q[IB * n + c] = by;
    Q[IC * n + c] = bz;
    if constexpr (M::SHEAR) {
#pragma unroll
      for (int ch = 0; ch < 8; ++ch) a.Se[ch * n + c] = sc[ch];
    }
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
    const Site<T, M> p(a, t);
    const long long n = a.e.n, c = p.c;
    const long long cxm = p.q(-1, 0, 0), cym = p.q(0, -1, 0), czm = p.q(0, 0, -1);
    const long long cyzm = p.q(0, -1, -1), cxzm = p.q(-1, 0, -1), cxym = p.q(-1, -1, 0);
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
    a.E[c] = ex;
    a.E[n + c] = ey;
    a.E[2 * n + c] = ez;
  }
};

// 3: trace_mhd3d.py trace_mhd3d_state_parts for one cell
template <typename T, typename M>
struct TraceStage {
  StepArgs<T> a;
  // limited slope of state channel ch along one axis (neighbours -1, +1)
  HD T sls(const Site<T, M>& p, int ch, int ax, int di, int dj, int dk) const {
    const int ox = ax == 0, oy = ax == 1, oz = ax == 2;
    return slope1(p.s(ch, di - ox, dj - oy, dk - oz), p.s(ch, di, dj, dk),
                  p.s(ch, di + ox, dj + oy, dk + oz), a.ph.slope);
  }

  HD void operator()(long long t) const {
    if (!*a.active) return;
    const Site<T, M> p(a, t);
    const long long n = a.e.n, c = p.c;
    const Phys<T>& ph = a.ph;
    const long long cxm = p.q(-1, 0, 0), cxp = p.q(1, 0, 0);
    const long long cym = p.q(0, -1, 0), cyp = p.q(0, 1, 0);
    const long long czm = p.q(0, 0, -1), czp = p.q(0, 0, 1);

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
    const T* Ex = a.E;
    const T* Ey = a.E + n;
    const T* Ez = a.E + 2 * n;
    const T ELL = Ex[c], ELR = Ex[czp], ERL = Ex[cyp], ERR = Ex[p.q(0, 1, 1)];
    const T FLL = Ey[c], FLR = Ey[czp], FRL = Ey[cxp], FRR = Ey[p.q(1, 0, 1)];
    const T GLL = Ez[c], GLR = Ez[cyp], GRL = Ez[cxp], GRR = Ez[p.q(1, 1, 0)];

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
    // (only the two transverse entries are used)
    const T dF[3][2][3] = {
        {{T(0), dALy, dALz}, {T(0), dARy, dARz}},
        {{dBLx, T(0), dBLz}, {dBRx, T(0), dBRz}},
        {{dCLx, dCLy, T(0)}, {dCRx, dCRy, T(0)}},
    };
    const T* hd[3] = {hx, hy, hz};
    const int face_ch[3] = {IA, IB, IC};
    T* st = a.st;
    // stratified: the half-dt kick of the vertical gravity on every traced
    // state (godunov_mhd.py:213-218, after the floors)
    T kick = T(0);
    if constexpr (M::STRAT) kick = (T(0.5) * dt) * p.gz();

    // face states: qp (left face, sign -1) and qm (right face, sign +1)
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        const T s = side ? T(1) : T(-1);
        T* out = st + (long long)(2 * ax + side) * 8 * n;
#pragma unroll
        for (int ch = 0; ch < 8; ++ch) {
          T val = ch == face_ch[ax] ? (side ? R2[ax] : L2[ax]) : q2[ch] + s * hd[ax][ch];
          if (ch == ID) val = pmax(ph.smallr, val);
          if (ch == IP) val = pmax(ph.smallp, val);
          if (M::STRAT && ch == IW) val = val + kick;
          out[ch * n + c] = val;
        }
      }
    }

    // edge states of family f (edges along axis f, varying in the two
    // other axes d1 < d2): RT (+,+), RB (+,-), LT (-,+), LB (-,-)
    const int fam_axes[3][2] = {{1, 2}, {0, 2}, {0, 1}};
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      const int d1 = fam_axes[f][0], d2 = fam_axes[f][1];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p1 = (e < 2) ? 1 : 0;        // R in d1
        const int p2 = (e % 2 == 0) ? 1 : 0;   // T in d2
        const T s1 = p1 ? T(1) : T(-1);
        const T s2 = p2 ? T(1) : T(-1);
        T* out = st + (long long)(6 + 4 * f + e) * 8 * n;
#pragma unroll
        for (int ch = 0; ch < 8; ++ch) {
          T val;
          if (ch == face_ch[d1]) {
            val = (p1 ? R2[d1] : L2[d1]) + s2 * dF[d1][p1][d2];
          } else if (ch == face_ch[d2]) {
            val = (p2 ? R2[d2] : L2[d2]) + s1 * dF[d2][p2][d1];
          } else {
            val = q2[ch] + s1 * hd[d1][ch] + s2 * hd[d2][ch];
          }
          if (ch == ID) val = pmax(ph.smallr, val);
          if (ch == IP) val = pmax(ph.smallp, val);
          if (M::STRAT && ch == IW) val = val + kick;
          out[ch * n + c] = val;
        }
      }
    }
  }
};

// 4: HLLD flux at each cell's left x, y, z face (godunov_mhd.py
// mhd_fluxes_emfs: qm of the previous cell against this cell's qp, the y/z
// problems rotated into the x slots and the flux rotated back)
template <typename T, typename M>
struct FluxStage {
  StepArgs<T> a;
  HD void load(int s, long long cell, const int* perm, T* q) const {
    const T* src = a.st + (long long)s * 8 * a.e.n;
#pragma unroll
    for (int ch = 0; ch < 8; ++ch) q[ch] = src[perm[ch] * a.e.n + cell];
  }
  HD void operator()(long long t) const {
    if (!*a.active) return;
    const Site<T, M> p(a, t);
    const long long n = a.e.n, c = p.c;
    // component rotations of the y and z sweeps (godunov_mhd.py _PERM_Y/_Z)
    const int perms[3][8] = {{ID, IP, IU, IV, IW, IA, IB, IC},
                             {ID, IP, IV, IU, IW, IB, IA, IC},
                             {ID, IP, IW, IV, IU, IC, IB, IA}};
    const long long prev[3] = {p.q(-1, 0, 0), p.q(0, -1, 0), p.q(0, 0, -1)};
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      T ql[8], qr[8], f[NFLUX];
      load(2 * ax + 1, prev[ax], perms[ax], ql);  // qm of the previous cell
      load(2 * ax, c, perms[ax], qr);             // qp of this cell
      riemann_hlld<M>(a.ph, ql, qr, f);
      T* out = a.fl + (long long)ax * NFLUX * n;
      // rotate back: out[ch] = f[perm[ch]] (perm is an involution and keeps
      // the five hydro slots among themselves)
#pragma unroll
      for (int ch = 0; ch < NFLUX; ++ch) out[ch * n + c] = f[perms[ax][ch]];
    }
  }
};

// 5: EMFs at the z, y, x edges of each cell (godunov_mhd.py
// mhd_fluxes_emfs; note the reference's RB/LT role swap for EMF_Y)
template <typename T, typename M>
struct EmfStage {
  StepArgs<T> a;
  HD void load(int s, long long cell, T* q) const {
    const T* src = a.st + (long long)s * 8 * a.e.n;
#pragma unroll
    for (int ch = 0; ch < 8; ++ch) q[ch] = src[ch * a.e.n + cell];
  }
  HD void operator()(long long t) const {
    if (!*a.active) return;
    const Site<T, M> p(a, t);
    const long long n = a.e.n, c = p.c;
    T qRT[8], qRB[8], qLT[8], qLB[8];

    // EMF_Z at (i-1/2, j-1/2, k)
    load(RT_Z, p.q(-1, -1, 0), qRT);
    load(RB_Z, p.q(-1, 0, 0), qRB);
    load(LT_Z, p.q(0, -1, 0), qLT);
    load(LB_Z, c, qLB);
    T ez = compute_emf<M>(a.ph, qRT, qRB, qLT, qLB, IU, IV, IW, IA, IB, IC);
    if constexpr (M::SHEAR) {
      // upwind shear term on the in-plane Bx (riemann_mhd.py:604-605)
      const T shear = a.ph.shear_k * (p.xpos() - a.ph.dx_half);
      ez = ez - shear_upwind(shear, T(0.5) * (qRT[IA] + qLT[IA]), T(0.5) * (qRB[IA] + qLB[IA]));
    }
    a.emf[c] = ez;

    // EMF_Y at (i-1/2, j, k-1/2)
    load(RT_Y, p.q(-1, 0, -1), qRT);
    load(LT_Y, p.q(0, 0, -1), qRB);
    load(RB_Y, p.q(-1, 0, 0), qLT);
    load(LB_Y, c, qLB);
    a.emf[n + c] = compute_emf<M>(a.ph, qRT, qRB, qLT, qLB, IW, IU, IV, IC, IA, IB);

    // EMF_X at (i, j-1/2, k-1/2)
    load(RT_X, p.q(0, -1, -1), qRT);
    load(RB_X, p.q(0, -1, 0), qRB);
    load(LT_X, p.q(0, 0, -1), qLT);
    load(LB_X, c, qLB);
    T ex = compute_emf<M>(a.ph, qRT, qRB, qLT, qLB, IV, IW, IU, IB, IC, IA);
    if constexpr (M::SHEAR) {
      // upwind shear term on the in-plane Bz (riemann_mhd.py:601-603)
      const T shear = a.ph.shear_k * p.xpos();
      ex = ex + shear_upwind(shear, T(0.5) * (qRT[IC] + qRB[IC]), T(0.5) * (qLT[IC] + qLB[IC]));
    }
    a.emf[2 * n + c] = ex;
  }
};

// 6: godunov_mhd.py mhd_apply_update: flux divergence and CT curl, in
// place; the shear mode also writes the x-face planes of the remap
// (godunov_mhd.py:429-434). Stratified: the conservative gravity source
// with the time-centred momentum (godunov_mhd.py:375-413). COMP: each
// channel's increment is Kahan-added against the carry C (the gravity
// source chained through it), every operation rounded on its own in the
// twin's order (r_mul, r_add, r_sub), so the update repeats the twin's
// roundings exactly on the same fluxes and EMFs.
template <typename T, typename M, bool COMP>
struct UpdateStage {
  StepArgs<T> a;
  HD void operator()(long long t) const {  // t: the state's cell
    if (!*a.active) return;
    const Site<T, M> p(a, t, true);
    const long long n = a.e.n, c = p.c;
    const long long cxp = p.q(1, 0, 0), cyp = p.q(0, 1, 0), czp = p.q(0, 0, 1);
    const T dt = *a.dt;
    const T dtdx = dt / a.ph.dx, dtdy = dt / a.ph.dy, dtdz = dt / a.ph.dz;
    const T* fx = a.fl;
    const T* fy = a.fl + NFLUX * n;
    const T* fz = a.fl + 2 * NFLUX * n;
    const T* ez = a.emf;
    const T* ey = a.emf + n;
    const T* ex = a.emf + 2 * n;
    T* S = a.S;
    const long long ns = a.d.n, cs = t;
    if constexpr (COMP) {
      T d[8], u[8], cc[8];
#pragma unroll
      for (int ch = 0; ch < NFLUX; ++ch) {
        const long long o = ch * n;
        d[ch] = r_add(r_add(r_mul(dtdx, r_sub(fx[o + c], fx[o + cxp])),
                            r_mul(dtdy, r_sub(fy[o + c], fy[o + cyp]))),
                      r_mul(dtdz, r_sub(fz[o + c], fz[o + czp])));
      }
      d[IA] = r_sub(r_mul(r_sub(ez[cyp], ez[c]), dtdy), r_mul(r_sub(ey[czp], ey[c]), dtdz));
      d[IB] = r_sub(r_mul(r_sub(ex[czp], ex[c]), dtdz), r_mul(r_sub(ez[cxp], ez[c]), dtdx));
      d[IC] = r_sub(r_mul(r_sub(ey[cxp], ey[c]), dtdx), r_mul(r_sub(ex[cyp], ex[c]), dtdy));
#pragma unroll
      for (int ch = 0; ch < 8; ++ch) {
        u[ch] = S[ch * ns + cs];
        cc[ch] = a.C[ch * ns + cs];
      }
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
        S[ch * ns + cs] = u[ch];
        a.C[ch * ns + cs] = cc[ch];
      }
    } else {
      T rho_old = T(0), w_old = T(0);
      if constexpr (M::STRAT) {
        rho_old = S[ID * ns + cs];
        w_old = S[IW * ns + cs];
      }
#pragma unroll
      for (int ch = 0; ch < NFLUX; ++ch) {
        const long long o = ch * n;
        const T dU = dtdx * (fx[o + c] - fx[o + cxp]) + dtdy * (fy[o + c] - fy[o + cyp]) +
                     dtdz * (fz[o + c] - fz[o + czp]);
        S[ch * ns + cs] = S[ch * ns + cs] + dU;
      }
      const T dbx = (ez[cyp] - ez[c]) * dtdy - (ey[czp] - ey[c]) * dtdz;
      const T dby = (ex[czp] - ex[c]) * dtdz - (ez[cxp] - ez[c]) * dtdx;
      const T dbz = (ey[cxp] - ey[c]) * dtdx - (ex[cyp] - ex[c]) * dtdy;
      S[IA * ns + cs] = S[IA * ns + cs] + dbx;
      S[IB * ns + cs] = S[IB * ns + cs] + dby;
      S[IC * ns + cs] = S[IC * ns + cs] + dbz;
      if constexpr (M::STRAT) {
        const T g = p.gz();
        const T w_new = S[IW * ns + cs];
        const T mom_half = T(0.5) * (w_old + w_new);
        S[IW * ns + cs] = w_new + dt * rho_old * g;
        S[IP * ns + cs] = S[IP * ns + cs] + dt * mom_half * g;
      }
    }
    if constexpr (M::SHEAR) {
      const long long np = (long long)a.d.nz * a.d.ny;
      const long long pc = (long long)p.k * a.d.ny + p.j;
      if (p.i == 0) {
        a.planes[pc] = fx[c];           // density flux at face 0
        a.planes[2 * np + pc] = ey[c];  // emfY at face 0
      }
      if (p.i == a.d.nx - 1) {
        a.planes[np + pc] = fx[cxp];        // density flux at face nx
        a.planes[3 * np + pc] = ey[cxp];    // emfY at face nx
        a.planes[4 * np + pc] = ez[cxp];    // emfZ at face nx
      }
    }
  }
};

template <typename T, typename M>
StepArgs<T> step_args(T* S, T* scratch, const T* slabs, T* planes, const T* zslabs,
                      const T* gz, bool comp, const T* dt, const unsigned char* active, int nx,
                      int ny, int nz, const double* prm) {
  StepArgs<T> a;
  a.d = make_dims(nx, ny, nz);
  a.e = M::SHEAR ? make_dims(nx + 2 * XH, ny, nz + (M::STRAT ? 2 * ZH : 0)) : a.d;
  a.ph = make_phys<T>(prm);
  const long long n = a.e.n;
  a.S = S;
  a.Q = scratch;
  a.E = a.Q + 8 * n;
  a.st = a.E + 3 * n;
  a.fl = a.st + (long long)NSTATE * 8 * n;
  a.emf = a.fl + 3 * NFLUX * n;
  a.Se = M::SHEAR ? a.emf + 3 * n : nullptr;
  a.slabs = slabs;
  a.planes = planes;
  a.C = comp ? S + 8 * a.d.n : nullptr;
  a.zslabs = zslabs;
  a.gz = gz;
  a.dt = dt;
  a.active = active;
  return a;
}

// comp: S holds 16 channels, the state and then its Kahan carry
template <typename T, typename M>
int mhd_step(T* S, T* scratch, const T* slabs, T* planes, const T* zslabs, const T* gz,
             bool comp, const T* dt, const unsigned char* active, int nx, int ny, int nz,
             const double* prm, void* stream) {
  const StepArgs<T> a = step_args<T, M>(S, scratch, slabs, planes, zslabs, gz, comp, dt, active,
                                        nx, ny, nz, prm);
  const long long n = a.e.n;
  // stages 1-5 over the stage grid, the update over the state
  int err;
  if ((err = launch_cells(PrimStage<T, M>{a}, n, stream))) return err;
  if ((err = launch_cells(EFieldStage<T, M>{a}, n, stream))) return err;
  if ((err = launch_cells(TraceStage<T, M>{a}, n, stream))) return err;
  if ((err = launch_cells(FluxStage<T, M>{a}, n, stream))) return err;
  if ((err = launch_cells(EmfStage<T, M>{a}, n, stream))) return err;
  if (comp) return launch_cells(UpdateStage<T, M, true>{a}, a.d.n, stream);
  return launch_cells(UpdateStage<T, M, false>{a}, a.d.n, stream);
}

// the shear modes: isothermal or adiabatic; stratified (zslabs and gz
// given) only isothermal, as its scale height cIso / omega0 needs
template <typename T>
int mhd_step_shear(T* S, T* scratch, const T* slabs, T* planes, const T* zslabs, const T* gz,
                   bool comp, const T* dt, const unsigned char* active, int nx, int ny, int nz,
                   const double* prm, void* stream) {
  if (zslabs != nullptr) {
    if (!(prm[P_CISO] > 0.0) || gz == nullptr) return 1;  // cudaErrorInvalidValue
    return mhd_step<T, Mode<true, true, true>>(S, scratch, slabs, planes, zslabs, gz, comp, dt,
                                               active, nx, ny, nz, prm, stream);
  }
  if (prm[P_CISO] > 0.0)
    return mhd_step<T, Mode<true, true>>(S, scratch, slabs, planes, nullptr, nullptr, comp, dt,
                                         active, nx, ny, nz, prm, stream);
  return mhd_step<T, Mode<true, false>>(S, scratch, slabs, planes, nullptr, nullptr, comp, dt,
                                        active, nx, ny, nz, prm, stream);
}

}  // namespace ramses::mhd

extern "C" {

long long ramses_mhd_step_scratch_per_cell(void) { return ramses::mhd::SCRATCH_PER_CELL; }

// the shear mode's scratch: its stage grid has nx + 2 XH columns (and,
// stratified, nz + 2 ZH rows)
long long ramses_mhd_step_shear_scratch(int nx, int ny, int nz, int strat) {
  return ramses::mhd::SHEAR_SCRATCH_PER_CELL * (nx + 2LL * ramses::mhd::XH) * ny *
         (nz + (strat ? 2LL * ramses::mhd::ZH : 0));
}

// the periodic step; comp: S holds 16 channels, the state and its carry
int ramses_mhd_step_f32(float* S, float* scratch, const float* dt, const unsigned char* active,
                        int comp, int nx, int ny, int nz, const double* prm, void* stream) {
  return ramses::mhd::mhd_step<float, ramses::mhd::Periodic>(
      S, scratch, nullptr, nullptr, nullptr, nullptr, comp != 0, dt, active, nx, ny, nz, prm,
      stream);
}

int ramses_mhd_step_f64(double* S, double* scratch, const double* dt,
                        const unsigned char* active, int comp, int nx, int ny, int nz,
                        const double* prm, void* stream) {
  return ramses::mhd::mhd_step<double, ramses::mhd::Periodic>(
      S, scratch, nullptr, nullptr, nullptr, nullptr, comp != 0, dt, active, nx, ny, nz, prm,
      stream);
}

// the shear modes: comp (S holds 16 channels); stratified (zslabs
// [2][8][3][ny][nx + 6] and gz [nz + 6] given, else null)
int ramses_mhd_step_shear_f32(float* S, float* scratch, const float* slabs, float* planes,
                              const float* zslabs, const float* gz, const float* dt,
                              const unsigned char* active, int comp, int nx, int ny, int nz,
                              const double* prm, void* stream) {
  return ramses::mhd::mhd_step_shear<float>(S, scratch, slabs, planes, zslabs, gz, comp != 0,
                                            dt, active, nx, ny, nz, prm, stream);
}

int ramses_mhd_step_shear_f64(double* S, double* scratch, const double* slabs, double* planes,
                              const double* zslabs, const double* gz, const double* dt,
                              const unsigned char* active, int comp, int nx, int ny, int nz,
                              const double* prm, void* stream) {
  return ramses::mhd::mhd_step_shear<double>(S, scratch, slabs, planes, zslabs, gz, comp != 0,
                                             dt, active, nx, ny, nz, prm, stream);
}

}  // extern "C"

#ifdef RAMSES_COUNT_OPS
// the floating-point operations of one step of S (op_count.cuh): S holds 8
// channels, or 16 with comp (the state and its Kahan carry)
extern "C" long long ramses_mhd_step_ops(const double* S, int comp, int nx, int ny, int nz,
                                         const double* prm, double dt) {
  using ramses::Counted;
  const long long n = (long long)nx * ny * nz;
  std::vector<Counted> s = ramses::counted_copy(S, (comp ? 16 : 8) * n);
  std::vector<Counted> scratch(ramses::mhd::SCRATCH_PER_CELL * n);
  const Counted dtc(dt);
  const unsigned char active = 1;
  Counted::ops = 0;
  ramses::mhd::mhd_step<Counted, ramses::mhd::Periodic>(s.data(), scratch.data(), nullptr,
                                                        nullptr, nullptr, nullptr, comp != 0,
                                                        &dtc, &active, nx, ny, nz, prm, nullptr);
  return Counted::ops;
}

namespace ramses::mhd {

// the operations of stage f on the stage-grid cells (shear mode) of columns
// lo..nx+hi and, stratified, rows lo..nz+hi: those a later stage reads, for
// stages run on every cell
template <typename M, typename F>
long long counted_cells(const F& f, const Dims& e, int lo, int hi, int nx, int nz) {
  long long ops = 0;
  for (long long t = 0; t < e.n; ++t) {
    const long long before = Counted::ops;
    f(t);
    int i, j, k;
    cell_ijk(e, t, i, j, k);
    i -= XH;
    k -= M::STRAT ? ZH : 0;
    const bool in_z = !M::STRAT || (k >= lo && k <= nz + hi);
    if (i >= lo && i <= nx + hi && in_z) ops += Counted::ops - before;
  }
  return ops;
}

// the shear mode's step as it needs to be done: prim on columns -2..nx+1,
// efield on -1..nx+1, trace on -1..nx, fluxes and EMFs on faces 0..nx
// (stratified: the same rows in z), the update on the state; the stage
// grid's other cells are computed by the kernel but never read
template <typename M>
long long shear_step_ops(Counted* S, Counted* scratch, const Counted* slabs, Counted* planes,
                         const Counted* zslabs, const Counted* gz, bool comp, const Counted* dt,
                         int nx, int ny, int nz, const double* prm) {
  const unsigned char active = 1;
  const StepArgs<Counted> a = step_args<Counted, M>(S, scratch, slabs, planes, zslabs, gz, comp,
                                                    dt, &active, nx, ny, nz, prm);
  long long ops = counted_cells<M>(PrimStage<Counted, M>{a}, a.e, -XH, XH - 1, nx, nz);
  ops += counted_cells<M>(EFieldStage<Counted, M>{a}, a.e, -1, 1, nx, nz);
  ops += counted_cells<M>(TraceStage<Counted, M>{a}, a.e, -1, 0, nx, nz);
  ops += counted_cells<M>(FluxStage<Counted, M>{a}, a.e, 0, 0, nx, nz);
  ops += counted_cells<M>(EmfStage<Counted, M>{a}, a.e, 0, 0, nx, nz);
  const long long before = Counted::ops;
  if (comp) {
    const UpdateStage<Counted, M, true> update{a};
    for (long long t = 0; t < a.d.n; ++t) update(t);
  } else {
    const UpdateStage<Counted, M, false> update{a};
    for (long long t = 0; t < a.d.n; ++t) update(t);
  }
  return ops + Counted::ops - before;
}

}  // namespace ramses::mhd

// the same for the shearing-box modes, with the sheared slabs beside S (and,
// stratified, the z slabs and g_z; else null)
extern "C" long long ramses_mhd_step_shear_ops(const double* S, const double* slabs,
                                               const double* zslabs, const double* gz, int comp,
                                               int nx, int ny, int nz, const double* prm,
                                               double dt) {
  using ramses::Counted;
  using ramses::mhd::Mode;
  using ramses::mhd::SLAB;
  const long long n = (long long)nx * ny * nz;
  const bool strat = zslabs != nullptr;
  std::vector<Counted> s = ramses::counted_copy(S, (comp ? 16 : 8) * n);
  std::vector<Counted> sl = ramses::counted_copy(slabs, 2LL * 8 * nz * ny * SLAB);
  std::vector<Counted> zs, g;
  if (strat) {
    zs = ramses::counted_copy(zslabs, 2LL * 8 * SLAB * ny * (nx + 2 * SLAB));
    g = ramses::counted_copy(gz, nz + 2LL * SLAB);
  }
  std::vector<Counted> scratch(ramses_mhd_step_shear_scratch(nx, ny, nz, strat));
  std::vector<Counted> planes(ramses::mhd::NPLANE * (long long)nz * ny);
  const Counted dtc(dt);
  const auto count = strat ? ramses::mhd::shear_step_ops<Mode<true, true, true>>
                     : prm[ramses::P_CISO] > 0.0 ? ramses::mhd::shear_step_ops<Mode<true, true>>
                                                 : ramses::mhd::shear_step_ops<Mode<true, false>>;
  return count(s.data(), scratch.data(), sl.data(), planes.data(), strat ? zs.data() : nullptr,
               strat ? g.data() : nullptr, comp != 0, &dtc, nx, ny, nz, prm);
}
#endif
