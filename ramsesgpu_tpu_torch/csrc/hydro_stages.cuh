// The per-cell physics of one 3D hydro step (primitives, trace, Riemann
// solvers, update), run by the streamed block body (hydro_stream.cuh) of
// hydro_step.cu and zcarry_hydro.cu, and by the operation count
// (hydro_step.cu ramses_hydro_step_ops).
#pragma once

#include "common.cuh"

// its own namespace: the stage types of mhd_step.cu share these names, and
// identical template names in two sources would be merged by the linker
namespace ramses::hydro {

constexpr int G = 2;   // ghost width of the ghosted mode
constexpr int NV = 5;  // rho, E (p in Q), three momenta (velocities)
enum { SOLVER_APPROX = 0, SOLVER_HLL = 1, SOLVER_HLLC = 2 };  // RiemannSolver
enum { BC_DIRICHLET = 1, BC_NEUMANN = 2, BC_PERIODIC = 3 };   // BoundaryConditionType

template <typename T>
struct HydroPhys {
  T gamma0, gm1, entho, smallr, smallp, smallc, smallc2, smallpp, gamma6, c_iso, slope;
  T dx, dy, dz;
  int niter, solver;
};

template <typename T>
inline HydroPhys<T> make_hydro_phys(const double* p) {
  HydroPhys<T> ph;
  ph.gamma0 = T(p[P_GAMMA0]);
  ph.gm1 = T(p[P_GAMMA0] - 1.0);
  ph.entho = T(1.0 / (p[P_GAMMA0] - 1.0));
  ph.smallr = T(p[P_SMALLR]);
  ph.smallp = T(p[P_SMALLP]);
  ph.smallc = T(p[P_SMALLC]);
  ph.smallc2 = T(p[P_SMALLC] * p[P_SMALLC]);
  ph.smallpp = T(p[P_SMALLPP]);
  ph.gamma6 = T(p[P_GAMMA6]);
  ph.c_iso = T(p[P_CISO]);
  ph.slope = T(p[P_SLOPE]);
  ph.dx = T(p[P_DX]);
  ph.dy = T(p[P_DY]);
  ph.dz = T(p[P_DZ]);
  ph.niter = (int)p[P_NITER];
  ph.solver = (int)p[P_SOLVER];
  return ph;
}

// ---------------------------------------------------------------------------
// the interior mode's load rule
// ---------------------------------------------------------------------------

// One axis of the load rule of an interior-only state: an index outside
// [0, n) maps per axis: PERIODIC wraps, NEUMANN clamps, DIRICHLET mirrors
// (i -> -1-i on the min side, 2n-1-i on the max side; boundary.py:87-92)
// and toggles `flip`, the sign of that axis's normal momentum. Composing
// the per-axis maps gives exactly what the X->Y->Z make_boundaries writes
// into edge and corner ghosts, since copies and sign flips are exact.
HD int map_axis(int i, int n, int bc_lo, int bc_hi, bool& flip) {
  if (i < 0) {
    if (bc_lo == BC_PERIODIC) return i + n;
    if (bc_lo == BC_NEUMANN) return 0;
    flip = !flip;
    return -1 - i;
  }
  if (i >= n) {
    if (bc_hi == BC_PERIODIC) return i - n;
    if (bc_hi == BC_NEUMANN) return n - 1;
    flip = !flip;
    return 2 * n - 1 - i;
  }
  return i;
}

// ---------------------------------------------------------------------------
// per-cell physics
// ---------------------------------------------------------------------------

// trace.py trace_unsplit_hydro (3D), split in two: what the six face
// states of a cell share (its primitives, half slopes along each axis and
// dt-scaled source terms), and one face state from it
template <typename T>
struct CellTrace {
  T q[NV], h[3][NV], s[NV];
};

template <typename T, typename P>
HD void trace_cell(const HydroPhys<T>& ph, const P& prim, int i, int j, int k, T dtdx, T dtdy,
                   T dtdz, CellTrace<T>& c) {
  T m[NV], p[NV];
  T* q = c.q;
  T* hx = c.h[0];
  T* hy = c.h[1];
  T* hz = c.h[2];
  prim.load(i, j, k, q);
  prim.load(i - 1, j, k, m);
  prim.load(i + 1, j, k, p);
#pragma unroll
  for (int ch = 0; ch < NV; ++ch) hx[ch] = T(0.5) * slope1(m[ch], q[ch], p[ch], ph.slope);
  prim.load(i, j - 1, k, m);
  prim.load(i, j + 1, k, p);
#pragma unroll
  for (int ch = 0; ch < NV; ++ch) hy[ch] = T(0.5) * slope1(m[ch], q[ch], p[ch], ph.slope);
  prim.load(i, j, k - 1, m);
  prim.load(i, j, k + 1, p);
#pragma unroll
  for (int ch = 0; ch < NV; ++ch) hz[ch] = T(0.5) * slope1(m[ch], q[ch], p[ch], ph.slope);

  const T r = q[ID], pr = q[IP], u = q[IU], v = q[IV], w = q[IW];
  const T gamma = ph.gamma0;
  const T inv_r = T(1) / r;
  c.s[ID] = (-u * hx[ID] - hx[IU] * r) * dtdx + (-v * hy[ID] - hy[IV] * r) * dtdy +
            (-w * hz[ID] - hz[IW] * r) * dtdz;
  c.s[IU] = (-u * hx[IU] - hx[IP] * inv_r) * dtdx + (-v * hy[IU]) * dtdy +
            (-w * hz[IU]) * dtdz;
  c.s[IV] = (-u * hx[IV]) * dtdx + (-v * hy[IV] - hy[IP] * inv_r) * dtdy +
            (-w * hz[IV]) * dtdz;
  c.s[IW] = (-u * hx[IW]) * dtdx + (-v * hy[IW]) * dtdy +
            (-w * hz[IW] - hz[IP] * inv_r) * dtdz;
  c.s[IP] = (-u * hx[IP] - hx[IU] * gamma * pr) * dtdx +
            (-v * hy[IP] - hy[IV] * gamma * pr) * dtdy +
            (-w * hz[IP] - hz[IW] * gamma * pr) * dtdz;
}

// the cell's state on its right face (sign +1, qm) or its left face (sign
// -1, qp) along an axis, from its q + s (qs) and its half slopes h along
// that axis
template <typename T>
HD void face_state(const HydroPhys<T>& ph, const T* qs, const T* h, T sign, T* out) {
  const T rho_f = pmax(ph.smallr, qs[ID] + sign * h[ID]);
  out[ID] = rho_f;
  out[IP] = pmax(ph.smallp * rho_f, qs[IP] + sign * h[IP]);
  out[IU] = qs[IU] + sign * h[IU];
  out[IV] = qs[IV] + sign * h[IV];
  out[IW] = qs[IW] + sign * h[IW];
}

// the same from the whole trace, along AX
template <int AX, typename T>
HD void face_state(const HydroPhys<T>& ph, const CellTrace<T>& c, T sign, T* out) {
  T qs[NV];
#pragma unroll
  for (int ch = 0; ch < NV; ++ch) qs[ch] = c.q[ch] + c.s[ch];
  face_state(ph, qs, c.h[AX], sign, out);
}

// riemann.py cmpflx (3D): flux from the Godunov state g (rotated order)
template <typename T>
HD void cmpflx(const HydroPhys<T>& ph, T rho, T p, T u, T v, T w, T* f) {
  const T f_rho = rho * u;
  f[ID] = f_rho;
  f[IU] = f_rho * u + p;
  f[IV] = f_rho * v;
  f[IW] = f_rho * w;
  const T ekin = T(0.5) * rho * (u * u + v * v + w * w);
  const T etot = p * ph.entho + ekin;
  f[IP] = u * (etot + p);
}

// riemann.py riemann_approx; returns the Newton iterations it ran
template <typename T>
HD int riemann_approx(const HydroPhys<T>& ph, const T* ql, const T* qr, T* f) {
  const T rl = pmax(ql[ID], ph.smallr);
  const T ul = ql[IU];
  const T pl = pmax(ql[IP], rl * ph.smallp);
  const T rr = pmax(qr[ID], ph.smallr);
  const T ur = qr[IU];
  const T pr = pmax(qr[IP], rr * ph.smallp);
  const T gamma = ph.gamma0;

  // Lagrangian sound speed squared
  const T cl = gamma * pl * rl;
  const T cr = gamma * pr * rr;
  const T wl0 = r_sqrt(cl);
  const T wr0 = r_sqrt(cr);
  T pold = pmax(((wr0 * pl + wl0 * pr) + wl0 * wr0 * (ul - ur)) / (wl0 + wr0), T(0));
  T conv = T(1);
  const T inv_pl = T(1) / pl;
  const T inv_pr = T(1) / pr;
  int it = 0;
  for (; it < ph.niter; ++it) {
    if (!(conv > T(1e-6))) break;  // masked from here on: nothing changes
    const T wwl2 = cl * (T(1) + ph.gamma6 * (pold - pl) * inv_pl);
    const T wwr2 = cr * (T(1) + ph.gamma6 * (pold - pr) * inv_pr);
    const T rwl = r_rsqrt(wwl2);
    const T rwr = r_rsqrt(wwr2);
    const T wwl = wwl2 * rwl;
    const T wwr = wwr2 * rwr;
    const T qgl = T(2) * wwl2 * wwl / (wwl2 + cl);
    const T qgr = T(2) * wwr2 * wwr / (wwr2 + cr);
    const T usl = ul - (pold - pl) * rwl;
    const T usr = ur + (pold - pr) * rwr;
    const T delp = pmax(qgr * qgl / (qgr + qgl) * (usl - usr), -pold);
    const T pnew = pold + delp;
    conv = r_abs(delp / (pnew + ph.smallpp));
    pold = pnew;
  }

  const T pstar = pold;
  const T wwl2_f = cl * (T(1) + ph.gamma6 * (pstar - pl) * inv_pl);
  const T wwr2_f = cr * (T(1) + ph.gamma6 * (pstar - pr) * inv_pr);
  const T rwl_f = r_rsqrt(wwl2_f);
  const T rwr_f = r_rsqrt(wwr2_f);
  const T wl = wwl2_f * rwl_f;
  const T wr = wwr2_f * rwr_f;

  const T ustar = T(0.5) * (ul + (pl - pstar) * rwl_f + ur - (pr - pstar) * rwr_f);
  const T sgnm = ustar >= T(0) ? T(1) : T(-1);
  const bool left = sgnm > T(0);
  const T ro = left ? rl : rr;
  const T uo = left ? ul : ur;
  const T po = left ? pl : pr;
  const T wo = left ? wl : wr;
  const T inv_wo = left ? rwl_f : rwr_f;

  const T inv_ro = T(1) / ro;
  const T co = pmax(ph.smallc, r_sqrt(r_abs(gamma * po * inv_ro)));
  const T rstar = pmax(ro / (T(1) + ro * (po - pstar) * (inv_wo * inv_wo)), ph.smallr);
  const T cstar = pmax(ph.smallc, r_sqrt(r_abs(gamma * pstar / rstar)));

  T spout = co - sgnm * uo;
  T spin = cstar - sgnm * ustar;
  const T ushock = wo * inv_ro - sgnm * uo;
  if (pstar >= po) {
    spin = ushock;
    spout = ushock;
  }
  const T scr = pmax(spout - spin, ph.smallc + r_abs(spout + spin));
  T frac = T(0.5) * (T(1) + (spout + spin) / scr);
  frac = frac != frac ? T(0) : pmin(pmax(frac, T(0)), T(1));

  T g_rho = frac * rstar + (T(1) - frac) * ro;
  T g_u = frac * ustar + (T(1) - frac) * uo;
  T g_p = frac * pstar + (T(1) - frac) * po;
  if (spout < T(0)) {
    g_rho = ro;
    g_u = uo;
    g_p = po;
  }
  if (spin > T(0)) {
    g_rho = rstar;
    g_u = ustar;
    g_p = pstar;
  }
  cmpflx(ph, g_rho, g_p, g_u, left ? ql[IV] : qr[IV], left ? ql[IW] : qr[IW], f);
  return it;
}

// riemann.py riemann_hll (conserved state and flux of the raw face states)
template <typename T>
HD void hll_side(const HydroPhys<T>& ph, const T* q, T* u, T* f) {
  const T rho = q[ID], p = q[IP], vn = q[IU], v = q[IV], w = q[IW];
  T e = p * ph.entho + T(0.5) * rho * (vn * vn + v * v);
  e = e + T(0.5) * rho * w * w;
  const T mu = rho * vn;
  u[ID] = rho;
  u[IP] = e;
  u[IU] = mu;
  u[IV] = rho * v;
  u[IW] = rho * w;
  f[ID] = mu;
  f[IP] = vn * (e + p);
  f[IU] = p + mu * vn;
  f[IV] = mu * v;
  f[IW] = mu * w;
}

template <typename T>
HD void riemann_hll(const HydroPhys<T>& ph, const T* ql, const T* qr, T* f) {
  const T rl = pmax(ql[ID], ph.smallr);
  const T ul = ql[IU];
  const T pl = pmax(ql[IP], rl * ph.smallp);
  const T rr = pmax(qr[ID], ph.smallr);
  const T ur = qr[IU];
  const T pr = pmax(qr[IP], rr * ph.smallp);
  const T cl = r_sqrt(ph.gamma0 * pl / rl);
  const T cr = r_sqrt(ph.gamma0 * pr / rr);
  const T SL = pmin(pmin(ul, ur) - pmax(cl, cr), T(0));
  const T SR = pmax(pmax(ul, ur) + pmax(cl, cr), T(0));
  T uleft[NV], fleft[NV], uright[NV], fright[NV];
  hll_side(ph, ql, uleft, fleft);
  hll_side(ph, qr, uright, fright);
#pragma unroll
  for (int ch = 0; ch < NV; ++ch)
    f[ch] = (SR * fleft[ch] - SL * fright[ch] + SR * SL * (uright[ch] - uleft[ch])) / (SR - SL);
}

// riemann.py riemann_hllc
template <typename T>
HD void riemann_hllc(const HydroPhys<T>& ph, const T* ql, const T* qr, T* f) {
  const T gamma = ph.gamma0;
  const T rl = pmax(ql[ID], ph.smallr);
  const T pl = pmax(ql[IP], rl * ph.smallp);
  const T ul = ql[IU];
  T ecinl = T(0.5) * rl * (ul * ul + ql[IV] * ql[IV]);
  ecinl = ecinl + T(0.5) * rl * ql[IW] * ql[IW];
  const T etotl = pl * ph.entho + ecinl;

  const T rr = pmax(qr[ID], ph.smallr);
  const T pr = pmax(qr[IP], rr * ph.smallp);
  const T ur = qr[IU];
  T ecinr = T(0.5) * rr * (ur * ur + qr[IV] * qr[IV]);
  ecinr = ecinr + T(0.5) * rr * qr[IW] * qr[IW];
  const T etotr = pr * ph.entho + ecinr;

  const T cfastl = r_sqrt(pmax(gamma * pl / rl, ph.smallc2));
  const T cfastr = r_sqrt(pmax(gamma * pr / rr, ph.smallc2));
  const T SL = pmin(ul, ur) - pmax(cfastl, cfastr);
  const T SR = pmax(ul, ur) + pmax(cfastl, cfastr);

  const T rcl = rl * (ul - SL);
  const T rcr = rr * (SR - ur);
  const T inv_rc = T(1) / (rcr + rcl);
  const T ustar = (rcr * ur + rcl * ul + (pl - pr)) * inv_rc;
  const T ptotstar = (rcr * pl + rcl * pr + rcl * rcr * (ul - ur)) * inv_rc;

  const T inv_sl = T(1) / (SL - ustar);
  const T inv_sr = T(1) / (SR - ustar);
  const T rstarl = rl * (SL - ul) * inv_sl;
  const T etotstarl = ((SL - ul) * etotl - pl * ul + ptotstar * ustar) * inv_sl;
  const T rstarr = rr * (SR - ur) * inv_sr;
  const T etotstarr = ((SR - ur) * etotr - pr * ur + ptotstar * ustar) * inv_sr;

  // sample the fan: SL>0 left; ustar>0 left star; SR>0 right star; else right
  T ro, uo, ptoto, etoto;
  if (SL > T(0)) {
    ro = rl; uo = ul; ptoto = pl; etoto = etotl;
  } else if (ustar > T(0)) {
    ro = rstarl; uo = ustar; ptoto = ptotstar; etoto = etotstarl;
  } else if (SR > T(0)) {
    ro = rstarr; uo = ustar; ptoto = ptotstar; etoto = etotstarr;
  } else {
    ro = rr; uo = ur; ptoto = pr; etoto = etotr;
  }
  const T f_rho = ro * uo;
  f[ID] = f_rho;
  f[IU] = f_rho * uo + ptoto;
  f[IP] = (etoto + ptoto) * uo;
  f[IV] = f_rho > T(0) ? f_rho * ql[IV] : f_rho * qr[IV];
  f[IW] = f_rho > T(0) ? f_rho * ql[IW] : f_rho * qr[IW];
}

// eos.py constoprim_hydro of the cell whose conserved channel ch lies at
// U[ch * su]; its primitive channel ch goes to Q[ch * sq]
template <typename T>
HD void prim_cell(const HydroPhys<T>& ph, const T* U, long long su, T* Q, long long sq) {
  const T rho = pmax(U[ID * su], ph.smallr);
  const T inv_rho = T(1) / rho;
  const T u = U[IU * su] * inv_rho;
  const T v = U[IV * su] * inv_rho;
  const T w = U[IW * su] * inv_rho;
  T p;
  if (ph.c_iso > T(0)) {
    p = rho * ph.c_iso * ph.c_iso;
  } else {
    const T eken = T(0.5) * (u * u + v * v + w * w);
    const T eint = U[IP * su] * inv_rho - eken;
    p = pmax(ph.gm1 * rho * eint, rho * ph.smallp);
  }
  Q[ID * sq] = rho;
  Q[IP * sq] = p;
  Q[IU * sq] = u;
  Q[IV * sq] = v;
  Q[IW * sq] = w;
}

// godunov.py hydro_3d_interior_update of one channel: ((U + x part) + y
// part) + z part from the fluxes through the cell's left and right faces
template <typename T>
HD T update_value(T u, T fxl, T fxr, T fyl, T fyr, T fzl, T fzr, T dtdx, T dtdy, T dtdz) {
  u = u + dtdx * (fxl - fxr);
  u = u + dtdy * (fyl - fyr);
  return u + dtdz * (fzl - fzr);
}

// godunov.py compute_fluxes at one face along axis ax: qm against qp,
// rotated so the normal velocity sits in the IU slot, the Riemann solver,
// the flux rotated back into f. Returns the approx solver's Newton
// iterations.
template <typename T>
HD int face_flux(const HydroPhys<T>& ph, int ax, const T* qm, const T* qp, T* f) {
  // the rotation (godunov.py _rotation) swaps IU with the normal slot
  // IU + ax; it is an involution, so the same swap rotates the flux back
  // (selects, so the arrays stay in registers for a runtime axis)
  T ql[NV], qr[NV], fr[NV];
  ql[ID] = qm[ID];
  ql[IP] = qm[IP];
  ql[IU] = ax == 0 ? qm[IU] : (ax == 1 ? qm[IV] : qm[IW]);
  ql[IV] = ax == 1 ? qm[IU] : qm[IV];
  ql[IW] = ax == 2 ? qm[IU] : qm[IW];
  qr[ID] = qp[ID];
  qr[IP] = qp[IP];
  qr[IU] = ax == 0 ? qp[IU] : (ax == 1 ? qp[IV] : qp[IW]);
  qr[IV] = ax == 1 ? qp[IU] : qp[IV];
  qr[IW] = ax == 2 ? qp[IU] : qp[IW];
  int it = 0;
  if (ph.solver == SOLVER_APPROX) {
    it = riemann_approx(ph, ql, qr, fr);
  } else if (ph.solver == SOLVER_HLL) {
    riemann_hll(ph, ql, qr, fr);
  } else {
    riemann_hllc(ph, ql, qr, fr);
  }
  f[ID] = fr[ID];
  f[IP] = fr[IP];
  f[IU] = ax == 0 ? fr[IU] : (ax == 1 ? fr[IV] : fr[IW]);
  f[IV] = ax == 1 ? fr[IU] : fr[IV];
  f[IW] = ax == 2 ? fr[IU] : fr[IW];
  return it;
}

}  // namespace ramses::hydro
