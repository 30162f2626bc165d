// One unsplit MUSCL-Hancock step of 3D ideal MHD with constrained
// transport on the fully periodic state (HLLD face fluxes, 2D-HLLD corner
// EMFs).
//
// Replaces the TPU kernel ramsesgpu_tpu/pallas/packed_io.py:148
// make_packed_io_step with the MHD body pallas/fused_mhd3d.py:228 ->
// solvers/godunov_mhd.py:437 mhd_3d_interior_update_staged.
// Plain twin: ramsesgpu_tpu_torch/solvers/godunov_mhd.py
// mhd_3d_periodic_update.
//
// Layout: the interior-only periodic state S[8][nz][ny][nx], x fastest
// (common.cuh). Periodic neighbours are found by index wrap, so the
// TPU layout's 8-row y ghost bands, x-ghost-free lanes and in-kernel ghost
// band writes have no counterpart: pack is a slice, unpack the periodic
// ghost fill.
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

template <typename T>
struct StepArgs {
  T* S;         // [8][n]     state, updated in place by stage 6
  T* Q;         // [8][n]     primitives
  T* E;         // [3][n]     Ex, Ey, Ez at the trace's edge centres
  T* st;        // [18][8][n] face / edge states
  T* fl;        // [3][5][n]  face fluxes x, y, z
  T* emf;       // [3][n]     edge EMFs z, y, x
  const T* dt;  // device scalar
  const unsigned char* active;  // device flag: 0 skips the step
  Dims d;
  Phys<T> ph;
};

// ---------------------------------------------------------------------------
// per-cell physics
// ---------------------------------------------------------------------------

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

template <typename T>
HD HlldSide<T> hlld_prep(const Phys<T>& ph, const T* q, T a) {
  HlldSide<T> s;
  s.r = q[ID];
  s.p = q[IP];
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

template <typename T>
HD void riemann_hlld(const Phys<T>& ph, const T* ql, const T* qr, T* f) {
  const T a = T(0.5) * (ql[IA] + qr[IA]);
  const T sgnm = a >= T(0) ? T(1) : T(-1);
  const HlldSide<T> L = hlld_prep(ph, ql, a);
  const HlldSide<T> R = hlld_prep(ph, qr, a);

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

template <typename T>
HD T ptot2d(const T* q) {
  return q[IP] + T(0.5) * (q[IA] * q[IA] + q[IB] * q[IB] + q[IC] * q[IC]);
}

template <typename T>
HD T mag_riemann2d_hlld(const Phys<T>& ph, const T* qLL, const T* qRL, const T* qLR,
                        const T* qRR, T eLL, T eRL, T eLR, T eRR) {
  const FastPre<T> pLL = fast_pre(ph, qLL[ID], qLL[IP], qLL[IA], qLL[IB], qLL[IC]);
  const FastPre<T> pLR = fast_pre(ph, qLR[ID], qLR[IP], qLR[IA], qLR[IB], qLR[IC]);
  const FastPre<T> pRL = fast_pre(ph, qRL[ID], qRL[IP], qRL[IA], qRL[IB], qRL[IC]);
  const FastPre<T> pRR = fast_pre(ph, qRR[ID], qRR[IP], qRR[IA], qRR[IB], qRR[IC]);
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

  const T PtotLL = ptot2d(qLL), PtotLR = ptot2d(qLR);
  const T PtotRL = ptot2d(qRL), PtotRR = ptot2d(qRR);

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
template <typename T>
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
  return mag_riemann2d_hlld(ph, qLL, qRL, qLR, qRR, eLL, eRL, eLR, eRR);
}

// ---------------------------------------------------------------------------
// stages
// ---------------------------------------------------------------------------

// 1: eos.py constoprim_mhd
template <typename T>
struct PrimStage {
  StepArgs<T> a;
  HD void operator()(long long c) const {
    if (!*a.active) return;
    const long long n = a.d.n;
    const T* S = a.S;
    int i, j, k;
    cell_ijk(a.d, c, i, j, k);
    const long long cx = cell_at(a.d, wrap_p(i, a.d.nx), j, k);
    const long long cy = cell_at(a.d, i, wrap_p(j, a.d.ny), k);
    const long long cz = cell_at(a.d, i, j, wrap_p(k, a.d.nz));
    const T rho = pmax(S[ID * n + c], a.ph.smallr);
    const T inv_rho = T(1) / rho;
    const T u = S[IU * n + c] * inv_rho;
    const T v = S[IV * n + c] * inv_rho;
    const T w = S[IW * n + c] * inv_rho;
    const T bx = T(0.5) * (S[IA * n + c] + S[IA * n + cx]);
    const T by = T(0.5) * (S[IB * n + c] + S[IB * n + cy]);
    const T bz = T(0.5) * (S[IC * n + c] + S[IC * n + cz]);
    const T eken = T(0.5) * (u * u + v * v + w * w);
    const T emag = T(0.5) * (bx * bx + by * by + bz * bz);
    const T eint = (S[IP * n + c] - emag) * inv_rho - eken;
    const T p = pmax(a.ph.gm1 * rho * eint, rho * a.ph.smallp);
    T* Q = a.Q;
    Q[ID * n + c] = rho;
    Q[IP * n + c] = p;
    Q[IU * n + c] = u;
    Q[IV * n + c] = v;
    Q[IW * n + c] = w;
    Q[IA * n + c] = bx;
    Q[IB * n + c] = by;
    Q[IC * n + c] = bz;
  }
};

// 2: trace_mhd3d.py electric fields at the edge centres: Ex (i, j-1/2,
// k-1/2), Ey (i-1/2, j, k-1/2), Ez (i-1/2, j-1/2, k)
template <typename T>
struct EFieldStage {
  StepArgs<T> a;
  // _corner_avg4(f, ax1, ax2) = 0.25 * (f + f[-1] + f[-2] + f[-1,-2])
  HD T avg4(const T* f, long long c, long long m1, long long m2, long long m12) const {
    return T(0.25) * (f[c] + f[m1] + f[m2] + f[m12]);
  }
  HD void operator()(long long c) const {
    if (!*a.active) return;
    const Dims& d = a.d;
    const long long n = d.n;
    int i, j, k;
    cell_ijk(d, c, i, j, k);
    const int im = wrap_m(i, d.nx), jm = wrap_m(j, d.ny), km = wrap_m(k, d.nz);
    const long long cxm = cell_at(d, im, j, k), cym = cell_at(d, i, jm, k);
    const long long czm = cell_at(d, i, j, km);
    const long long cyzm = cell_at(d, i, jm, km), cxzm = cell_at(d, im, j, km);
    const long long cxym = cell_at(d, im, jm, k);
    const T* Qu = a.Q + IU * n;
    const T* Qv = a.Q + IV * n;
    const T* Qw = a.Q + IW * n;
    const T* bfx = a.S + IA * n;
    const T* bfy = a.S + IB * n;
    const T* bfz = a.S + IC * n;

    const T v4 = avg4(Qv, c, cym, czm, cyzm);
    const T w4 = avg4(Qw, c, cym, czm, cyzm);
    const T B_e = T(0.5) * (bfy[c] + bfy[czm]);
    const T C_e = T(0.5) * (bfz[c] + bfz[cym]);
    a.E[c] = v4 * C_e - w4 * B_e;

    const T u4 = avg4(Qu, c, cxm, czm, cxzm);
    const T w4b = avg4(Qw, c, cxm, czm, cxzm);
    const T A_e = T(0.5) * (bfx[c] + bfx[czm]);
    const T C_e2 = T(0.5) * (bfz[c] + bfz[cxm]);
    a.E[n + c] = w4b * A_e - u4 * C_e2;

    const T u4c = avg4(Qu, c, cxm, cym, cxym);
    const T v4c = avg4(Qv, c, cxm, cym, cxym);
    const T A_e2 = T(0.5) * (bfx[c] + bfx[cym]);
    const T B_e2 = T(0.5) * (bfy[c] + bfy[cxm]);
    a.E[2 * n + c] = u4c * B_e2 - v4c * A_e2;
  }
};

// 3: trace_mhd3d.py trace_mhd3d_state_parts for one cell
template <typename T>
struct TraceStage {
  StepArgs<T> a;

  // slope of f along one axis at cell c, with neighbours cm / cp
  HD T sl(const T* f, long long cm, long long c, long long cp) const {
    return slope1(f[cm], f[c], f[cp], a.ph.slope);
  }

  HD void operator()(long long c) const {
    if (!*a.active) return;
    const Dims& d = a.d;
    const long long n = d.n;
    const Phys<T>& ph = a.ph;
    int i, j, k;
    cell_ijk(d, c, i, j, k);
    const int im = wrap_m(i, d.nx), ip = wrap_p(i, d.nx);
    const int jm = wrap_m(j, d.ny), jp = wrap_p(j, d.ny);
    const int km = wrap_m(k, d.nz), kp = wrap_p(k, d.nz);
    const long long cxm = cell_at(d, im, j, k), cxp = cell_at(d, ip, j, k);
    const long long cym = cell_at(d, i, jm, k), cyp = cell_at(d, i, jp, k);
    const long long czm = cell_at(d, i, j, km), czp = cell_at(d, i, j, kp);

    const T dt = *a.dt;
    const T dtdx = dt / ph.dx, dtdy = dt / ph.dy, dtdz = dt / ph.dz;

    // cell values and half-slopes of Q
    T q[8], hx[8], hy[8], hz[8];
#pragma unroll
    for (int ch = 0; ch < 8; ++ch) {
      const T* Qc = a.Q + ch * n;
      q[ch] = Qc[c];
      hx[ch] = T(0.5) * sl(Qc, cxm, c, cxp);
      hy[ch] = T(0.5) * sl(Qc, cym, c, cyp);
      hz[ch] = T(0.5) * sl(Qc, czm, c, czp);
    }

    // face-centred fields, their right faces and transverse slopes
    const T* bfx = a.S + IA * n;
    const T* bfy = a.S + IB * n;
    const T* bfz = a.S + IC * n;
    const T AL = bfx[c], AR = bfx[cxp];
    const T BL = bfy[c], BR = bfy[cyp];
    const T CL = bfz[c], CR = bfz[czp];

    const T dALy = T(0.5) * sl(bfx, cym, c, cyp);
    const T dALz = T(0.5) * sl(bfx, czm, c, czp);
    const T dARy = T(0.5) * sl(bfx, cell_at(d, ip, jm, k), cxp, cell_at(d, ip, jp, k));
    const T dARz = T(0.5) * sl(bfx, cell_at(d, ip, j, km), cxp, cell_at(d, ip, j, kp));
    const T dBLx = T(0.5) * sl(bfy, cxm, c, cxp);
    const T dBLz = T(0.5) * sl(bfy, czm, c, czp);
    const T dBRx = T(0.5) * sl(bfy, cell_at(d, im, jp, k), cyp, cell_at(d, ip, jp, k));
    const T dBRz = T(0.5) * sl(bfy, cell_at(d, i, jp, km), cyp, cell_at(d, i, jp, kp));
    const T dCLx = T(0.5) * sl(bfz, cxm, c, cxp);
    const T dCLy = T(0.5) * sl(bfz, cym, c, cyp);
    const T dCRx = T(0.5) * sl(bfz, cell_at(d, im, j, kp), czp, cell_at(d, ip, j, kp));
    const T dCRy = T(0.5) * sl(bfz, cell_at(d, i, jm, kp), czp, cell_at(d, i, jp, kp));

    const T dAx = T(0.5) * (AR - AL);
    const T dBy = T(0.5) * (BR - BL);
    const T dCz = T(0.5) * (CR - CL);

    // the 2x2 electric-field stencils around the cell (L = this, R = next)
    const T* Ex = a.E;
    const T* Ey = a.E + n;
    const T* Ez = a.E + 2 * n;
    const T ELL = Ex[c], ELR = Ex[czp], ERL = Ex[cyp], ERR = Ex[cell_at(d, i, jp, kp)];
    const T FLL = Ey[c], FLR = Ey[czp], FRL = Ey[cxp], FRR = Ey[cell_at(d, ip, j, kp)];
    const T GLL = Ez[c], GLR = Ez[cyp], GRL = Ez[cxp], GRR = Ez[cell_at(d, ip, jp, k)];

    const T r = q[ID], p = q[IP], u = q[IU], v = q[IV], w = q[IW];
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
    const T sr0 = (-u * drx - dux * r) * dtdx + (-v * dry - dvy * r) * dtdy +
                  (-w * drz - dwz * r) * dtdz;
    const T su0 = (-u * dux - (dpx + B * dBx + C * dCx) * inv_r) * dtdx +
                  (-v * duy + B * dAy * inv_r) * dtdy + (-w * duz + C * dAz * inv_r) * dtdz;
    const T sv0 = (-u * dvx + A * dBx * inv_r) * dtdx +
                  (-v * dvy - (dpy + A * dAy + C * dCy) * inv_r) * dtdy +
                  (-w * dvz + C * dBz * inv_r) * dtdz;
    const T sw0 = (-u * dwx + A * dCx * inv_r) * dtdx + (-v * dwy + B * dCy * inv_r) * dtdy +
                  (-w * dwz - (dpz + A * dAz + B * dBz) * inv_r) * dtdz;
    const T sp0 = (-u * dpx - dux * gamma * p) * dtdx + (-v * dpy - dvy * gamma * p) * dtdy +
                  (-w * dpz - dwz * gamma * p) * dtdz;
    const T sA0 = (u * dBy + B * duy - v * dAy - A * dvy) * dtdy +
                  (u * dCz + C * duz - w * dAz - A * dwz) * dtdz;
    const T sB0 = (v * dAx + A * dvx - u * dBx - B * dux) * dtdx +
                  (v * dCz + C * dvz - w * dBz - B * dwz) * dtdz;
    const T sC0 = (w * dAx + A * dwx - u * dCx - C * dux) * dtdx +
                  (w * dBy + B * dwy - v * dCy - C * dvy) * dtdy;

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
    q2[IP] = p + sp0;
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
          out[ch * n + c] = val;
        }
      }
    }
  }
};

// 4: HLLD flux at each cell's left x, y, z face (godunov_mhd.py
// mhd_fluxes_emfs: qm of the previous cell against this cell's qp, the y/z
// problems rotated into the x slots and the flux rotated back)
template <typename T>
struct FluxStage {
  StepArgs<T> a;
  HD void load(int s, long long cell, const int* perm, T* q) const {
    const T* src = a.st + (long long)s * 8 * a.d.n;
#pragma unroll
    for (int ch = 0; ch < 8; ++ch) q[ch] = src[perm[ch] * a.d.n + cell];
  }
  HD void operator()(long long c) const {
    if (!*a.active) return;
    const Dims& d = a.d;
    const long long n = d.n;
    int i, j, k;
    cell_ijk(d, c, i, j, k);
    // component rotations of the y and z sweeps (godunov_mhd.py _PERM_Y/_Z)
    const int perms[3][8] = {{ID, IP, IU, IV, IW, IA, IB, IC},
                             {ID, IP, IV, IU, IW, IB, IA, IC},
                             {ID, IP, IW, IV, IU, IC, IB, IA}};
    const long long prev[3] = {cell_at(d, wrap_m(i, d.nx), j, k),
                               cell_at(d, i, wrap_m(j, d.ny), k),
                               cell_at(d, i, j, wrap_m(k, d.nz))};
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      T ql[8], qr[8], f[NFLUX];
      load(2 * ax + 1, prev[ax], perms[ax], ql);  // qm of the previous cell
      load(2 * ax, c, perms[ax], qr);             // qp of this cell
      riemann_hlld(a.ph, ql, qr, f);
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
template <typename T>
struct EmfStage {
  StepArgs<T> a;
  HD void load(int s, long long cell, T* q) const {
    const T* src = a.st + (long long)s * 8 * a.d.n;
#pragma unroll
    for (int ch = 0; ch < 8; ++ch) q[ch] = src[ch * a.d.n + cell];
  }
  HD void operator()(long long c) const {
    if (!*a.active) return;
    const Dims& d = a.d;
    const long long n = d.n;
    int i, j, k;
    cell_ijk(d, c, i, j, k);
    const int im = wrap_m(i, d.nx), jm = wrap_m(j, d.ny), km = wrap_m(k, d.nz);
    T qRT[8], qRB[8], qLT[8], qLB[8];

    // EMF_Z at (i-1/2, j-1/2, k)
    load(RT_Z, cell_at(d, im, jm, k), qRT);
    load(RB_Z, cell_at(d, im, j, k), qRB);
    load(LT_Z, cell_at(d, i, jm, k), qLT);
    load(LB_Z, c, qLB);
    a.emf[c] = compute_emf(a.ph, qRT, qRB, qLT, qLB, IU, IV, IW, IA, IB, IC);

    // EMF_Y at (i-1/2, j, k-1/2)
    load(RT_Y, cell_at(d, im, j, km), qRT);
    load(LT_Y, cell_at(d, i, j, km), qRB);
    load(RB_Y, cell_at(d, im, j, k), qLT);
    load(LB_Y, c, qLB);
    a.emf[n + c] = compute_emf(a.ph, qRT, qRB, qLT, qLB, IW, IU, IV, IC, IA, IB);

    // EMF_X at (i, j-1/2, k-1/2)
    load(RT_X, cell_at(d, i, jm, km), qRT);
    load(RB_X, cell_at(d, i, jm, k), qRB);
    load(LT_X, cell_at(d, i, j, km), qLT);
    load(LB_X, c, qLB);
    a.emf[2 * n + c] = compute_emf(a.ph, qRT, qRB, qLT, qLB, IV, IW, IU, IB, IC, IA);
  }
};

// 6: godunov_mhd.py mhd_apply_update: flux divergence and CT curl, in place
template <typename T>
struct UpdateStage {
  StepArgs<T> a;
  HD void operator()(long long c) const {
    if (!*a.active) return;
    const Dims& d = a.d;
    const long long n = d.n;
    int i, j, k;
    cell_ijk(d, c, i, j, k);
    const long long cxp = cell_at(d, wrap_p(i, d.nx), j, k);
    const long long cyp = cell_at(d, i, wrap_p(j, d.ny), k);
    const long long czp = cell_at(d, i, j, wrap_p(k, d.nz));
    const T dt = *a.dt;
    const T dtdx = dt / a.ph.dx, dtdy = dt / a.ph.dy, dtdz = dt / a.ph.dz;
    const T* fx = a.fl;
    const T* fy = a.fl + NFLUX * n;
    const T* fz = a.fl + 2 * NFLUX * n;
    T* S = a.S;
#pragma unroll
    for (int ch = 0; ch < NFLUX; ++ch) {
      const long long o = ch * n;
      const T dU = dtdx * (fx[o + c] - fx[o + cxp]) + dtdy * (fy[o + c] - fy[o + cyp]) +
                   dtdz * (fz[o + c] - fz[o + czp]);
      S[o + c] = S[o + c] + dU;
    }
    const T* ez = a.emf;
    const T* ey = a.emf + n;
    const T* ex = a.emf + 2 * n;
    const T dbx = (ez[cyp] - ez[c]) * dtdy - (ey[czp] - ey[c]) * dtdz;
    const T dby = (ex[czp] - ex[c]) * dtdz - (ez[cxp] - ez[c]) * dtdx;
    const T dbz = (ey[cxp] - ey[c]) * dtdx - (ex[cyp] - ex[c]) * dtdy;
    S[IA * n + c] = S[IA * n + c] + dbx;
    S[IB * n + c] = S[IB * n + c] + dby;
    S[IC * n + c] = S[IC * n + c] + dbz;
  }
};

template <typename T>
int mhd_step(T* S, T* scratch, const T* dt, const unsigned char* active, int nx, int ny,
             int nz, const double* prm, void* stream) {
  StepArgs<T> a;
  a.d = make_dims(nx, ny, nz);
  a.ph = make_phys<T>(prm);
  const long long n = a.d.n;
  a.S = S;
  a.Q = scratch;
  a.E = a.Q + 8 * n;
  a.st = a.E + 3 * n;
  a.fl = a.st + (long long)NSTATE * 8 * n;
  a.emf = a.fl + 3 * NFLUX * n;
  a.dt = dt;
  a.active = active;
  int err;
  if ((err = launch_cells(PrimStage<T>{a}, n, stream))) return err;
  if ((err = launch_cells(EFieldStage<T>{a}, n, stream))) return err;
  if ((err = launch_cells(TraceStage<T>{a}, n, stream))) return err;
  if ((err = launch_cells(FluxStage<T>{a}, n, stream))) return err;
  if ((err = launch_cells(EmfStage<T>{a}, n, stream))) return err;
  return launch_cells(UpdateStage<T>{a}, n, stream);
}

}  // namespace ramses::mhd

extern "C" {

long long ramses_mhd_step_scratch_per_cell(void) { return ramses::mhd::SCRATCH_PER_CELL; }

int ramses_mhd_step_f32(float* S, float* scratch, const float* dt,
                        const unsigned char* active, int nx, int ny, int nz,
                        const double* prm, void* stream) {
  return ramses::mhd::mhd_step<float>(S, scratch, dt, active, nx, ny, nz, prm, stream);
}

int ramses_mhd_step_f64(double* S, double* scratch, const double* dt,
                        const unsigned char* active, int nx, int ny, int nz,
                        const double* prm, void* stream) {
  return ramses::mhd::mhd_step<double>(S, scratch, dt, active, nx, ny, nz, prm, stream);
}

}  // extern "C"

#ifdef RAMSES_COUNT_OPS
// the floating-point operations of one step of S[8][nz][ny][nx] (op_count.cuh)
extern "C" long long ramses_mhd_step_ops(const double* S, int nx, int ny, int nz,
                                         const double* prm, double dt) {
  using ramses::Counted;
  const long long n = (long long)nx * ny * nz;
  std::vector<Counted> s = ramses::counted_copy(S, 8 * n);
  std::vector<Counted> scratch(ramses::mhd::SCRATCH_PER_CELL * n);
  const Counted dtc(dt);
  const unsigned char active = 1;
  Counted::ops = 0;
  ramses::mhd::mhd_step<Counted>(s.data(), scratch.data(), &dtc, &active, nx, ny, nz, prm, nullptr);
  return Counted::ops;
}
#endif
