// One unsplit MUSCL-Hancock step of 3D hydrodynamics (g = 2): primitives
// -> slopes (slope_type 0/1/2) -> trace to face states -> approx / HLL /
// HLLC face Riemann problems -> flux-difference update. f32 and f64.
//
// Replaces three TPU kernels, which all run this body
// (ramsesgpu_tpu/solvers/godunov.py:78 hydro_3d_interior_update):
//   A'-hydro  pallas/packed_io.py:148 make_packed_io_step with the hydro
//             body pallas/fused_hydro3d.py:182 (the periodic loop);
//   5         pallas/fused_hydro3d.py:46 make_fused_hydro_update (a
//             ghosted state in, its interior out);
//   6         pallas/packed_bc.py:126 make_packed_bc_step (the walled loop,
//             ghost lanes and bands rebuilt in-kernel).
// Plain twins: ramsesgpu_tpu_torch/solvers/godunov.py
// hydro_3d_state_update (interior mode) and hydro_3d_interior_update
// (ghosted mode).
//
// Two load layouts, chosen by the template parameter GHOSTED:
//  - interior mode (the loops, rows A'-hydro and 6): the state is
//    interior-only, S[5][nz][ny][nx], updated in place. A neighbour load
//    outside the interior maps its index per axis: PERIODIC wraps, NEUMANN
//    clamps, DIRICHLET mirrors (i -> -1-i on the min side, 2n-1-i on the
//    max side; boundary.py:87-92) and flips the sign of that axis's normal
//    velocity. Composing the per-axis maps gives exactly what the X->Y->Z
//    make_boundaries writes into edge and corner ghosts, since copies and
//    sign flips are exact; so the TPU kernel's in-kernel ghost rebuild
//    becomes a load rule, and no ghost is ever written.
//  - ghosted mode (row 5): reads a ghosted U[5][nz+4][ny+4][nx+4] as it
//    is and writes the interior to a separate out[5][nz][ny][nx].
//
// Design (first, simple version): three kinds of stage, one thread per
// cell or face each, intermediates in one scratch buffer the wrapper
// allocates once per advance:
//   1 prim          U -> Q[5]          constoprim (the interior, or the
//                                      whole ghosted array)
//   2 flux x, y, z  Q -> F_ax[5]       per face: the trace of both adjacent
//                                      cells (7-point Q stencils), the
//                                      rotation into the x slots, the
//                                      Riemann solver, the rotation back
//   3 update        U + dt/dx dF       (in place in the interior mode)
// Face fluxes are stored with one more face along their axis
// ([5][nz][ny][nx+1] for x ...), so walls need no special case. Each face
// traces both its cells instead of reading stored face states: a cell's
// slopes and sources (trace_cell) are computed six times, once for each of
// its face states, which keeps the scratch at ~20 values/cell.
// The approx solver's fixed-count masked Newton loop (riemann.py:87-103)
// breaks per thread once conv <= 1e-6: a masked iteration changes nothing,
// so the result is the same.
//
// The per-cell physics is transcribed from the JAX formulas (ops/eos.py,
// ops/slopes.py, ops/trace.py, ops/riemann.py, solvers/godunov.py) in their
// op order, hoisted 1/pl, 1/pr and rsqrt included. Parity with the twin is
// tolerance-based (FMA contraction, rsqrtf), never bitwise.
//
// A device flag `active` (the loop's t < t_end test) is read by every
// stage; when it is 0 the step is skipped, so a chunk needs no host sync.
//
// Bound on the H100: the step must read the 5 conserved values of each cell
// and write them back, 40 B/cell in f32 (0.67 GB at 256^3, 0.20 ms at
// 3.35 TB/s). The arithmetic it needs (op_count.cuh, ramses_hydro_step_ops)
// is 356 flops per cell (primitives, one trace, update), 96 per face
// (Riemann solve) and 36 per Newton iteration of the approx solver, ~0.75
// kflop per cell on the implode state (~1 iteration per face), 0.19 ms at
// the f32 peak: the bound is the bytes. This version moves ~6x the minimum
// bytes (Q and the face fluxes round-trip through device memory) and
// traces every cell six times; one trace per cell, kept on chip around a
// shared-memory z-plane ring, is the next step for speed.
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
// the primitive field and its two load layouts
// ---------------------------------------------------------------------------

// one axis of the interior mode's load rule; toggles `flip` on a mirror
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

// Q[5][cells] with (i, j, k) in interior coordinates, -G <= i < nx + G
template <typename T, bool GHOSTED>
struct Prim {
  const T* Q;
  long long stride;  // cells per channel of Q
  int nx, ny, nz;
  int bc[6];  // xmin, xmax, ymin, ymax, zmin, zmax (interior mode)

  HD void load(int i, int j, int k, T* q) const {
    long long c;
    bool fx = false, fy = false, fz = false;
    if (GHOSTED) {
      c = ((long long)(k + G) * (ny + 2 * G) + (j + G)) * (nx + 2 * G) + (i + G);
    } else {
      const int ii = map_axis(i, nx, bc[0], bc[1], fx);
      const int jj = map_axis(j, ny, bc[2], bc[3], fy);
      const int kk = map_axis(k, nz, bc[4], bc[5], fz);
      c = ((long long)kk * ny + jj) * nx + ii;
    }
#pragma unroll
    for (int ch = 0; ch < NV; ++ch) q[ch] = Q[ch * stride + c];
    if (fx) q[IU] = -q[IU];
    if (fy) q[IV] = -q[IV];
    if (fz) q[IW] = -q[IW];
  }
};

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

// the cell's state on its right face along AX (sign +1, qm) or its left
// face (sign -1, qp)
template <int AX, typename T>
HD void face_state(const HydroPhys<T>& ph, const CellTrace<T>& c, T sign, T* out) {
  const T* h = c.h[AX];
  const T rho_f = pmax(ph.smallr, (c.q[ID] + c.s[ID]) + sign * h[ID]);
  out[ID] = rho_f;
  out[IP] = pmax(ph.smallp * rho_f, (c.q[IP] + c.s[IP]) + sign * h[IP]);
  out[IU] = (c.q[IU] + c.s[IU]) + sign * h[IU];
  out[IV] = (c.q[IV] + c.s[IV]) + sign * h[IV];
  out[IW] = (c.q[IW] + c.s[IW]) + sign * h[IW];
}

template <int AX, typename T, typename P>
HD void trace_face(const HydroPhys<T>& ph, const P& prim, int i, int j, int k, T sign,
                   T dtdx, T dtdy, T dtdz, T* out) {
  CellTrace<T> c;
  trace_cell(ph, prim, i, j, k, dtdx, dtdy, dtdz, c);
  face_state<AX>(ph, c, sign, out);
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

// ---------------------------------------------------------------------------
// stages
// ---------------------------------------------------------------------------

template <typename T>
struct StepArgs {
  const T* U;   // the state: interior [5][n] or ghosted [5][ng]
  T* out;       // the new interior [5][n] (== U in the interior mode)
  T* Q;         // [5][nq] primitives (nq = n, or ng in the ghosted mode)
  T* F[3];      // face fluxes x [5][nz][ny][nx+1], y [5][nz][ny+1][nx], z [5][nz+1][ny][nx]
  const T* dt;  // device scalar
  const unsigned char* active;  // device flag: 0 skips the step
  unsigned long long* newton;   // optional: sum of the approx solver's iterations
  int nx, ny, nz;
  long long n, nq;
  int bc[6];
  HydroPhys<T> ph;
};

// 1: eos.py constoprim_hydro over nq cells
template <typename T>
struct PrimStage {
  StepArgs<T> a;
  HD void operator()(long long c) const {
    if (!*a.active) return;
    const long long n = a.nq;
    const HydroPhys<T>& ph = a.ph;
    const T rho = pmax(a.U[ID * n + c], ph.smallr);
    const T inv_rho = T(1) / rho;
    const T u = a.U[IU * n + c] * inv_rho;
    const T v = a.U[IV * n + c] * inv_rho;
    const T w = a.U[IW * n + c] * inv_rho;
    T p;
    if (ph.c_iso > T(0)) {
      p = rho * ph.c_iso * ph.c_iso;
    } else {
      const T eken = T(0.5) * (u * u + v * v + w * w);
      const T eint = a.U[IP * n + c] * inv_rho - eken;
      p = pmax(ph.gm1 * rho * eint, rho * ph.smallp);
    }
    a.Q[ID * n + c] = rho;
    a.Q[IP * n + c] = p;
    a.Q[IU * n + c] = u;
    a.Q[IV * n + c] = v;
    a.Q[IW * n + c] = w;
  }
};

template <typename T, bool GHOSTED>
HD Prim<T, GHOSTED> prim_of(const StepArgs<T>& a) {
  Prim<T, GHOSTED> prim;
  prim.Q = a.Q;
  prim.stride = a.nq;
  prim.nx = a.nx;
  prim.ny = a.ny;
  prim.nz = a.nz;
#pragma unroll
  for (int b = 0; b < 6; ++b) prim.bc[b] = a.bc[b];
  return prim;
}

// godunov.py compute_fluxes at one face along AX: qm against qp, rotated so
// the normal velocity sits in the IU slot, the Riemann solver, the flux
// rotated back into f. Returns the approx solver's Newton iterations.
template <int AX, typename T>
HD int face_flux(const HydroPhys<T>& ph, const T* qm, const T* qp, T* f) {
  // the rotation (godunov.py _rotation) swaps IU with the normal slot;
  // it is an involution, so the same swap rotates the flux back
  constexpr int NS = AX == 0 ? IU : (AX == 1 ? IV : IW);
  T ql[NV], qr[NV], fr[NV];
#pragma unroll
  for (int ch = 0; ch < NV; ++ch) {
    const int src = ch == IU ? NS : (ch == NS ? IU : ch);
    ql[ch] = qm[src];
    qr[ch] = qp[src];
  }
  int it = 0;
  if (ph.solver == SOLVER_APPROX) {
    it = riemann_approx(ph, ql, qr, fr);
  } else if (ph.solver == SOLVER_HLL) {
    riemann_hll(ph, ql, qr, fr);
  } else {
    riemann_hllc(ph, ql, qr, fr);
  }
#pragma unroll
  for (int ch = 0; ch < NV; ++ch) f[ch] = fr[ch == IU ? NS : (ch == NS ? IU : ch)];
  return it;
}

// 2: the flux through the left face of cell (i, j, k) along AX: the qm of
// the previous cell against this cell's qp
template <typename T, bool GHOSTED, int AX>
struct FluxStage {
  StepArgs<T> a;
  HD void operator()(long long c) const {
    if (!*a.active) return;
    // faces: one more along AX than cells
    const int fx = a.nx + (AX == 0), fy = a.ny + (AX == 1);
    const int i = (int)(c % fx);
    const long long r = c / fx;
    const int j = (int)(r % fy);
    const int k = (int)(r / fy);
    const Prim<T, GHOSTED> prim = prim_of<T, GHOSTED>(a);
    const HydroPhys<T>& ph = a.ph;
    const T dt = *a.dt;
    const T dtdx = dt / ph.dx, dtdy = dt / ph.dy, dtdz = dt / ph.dz;

    T qm[NV], qp[NV], f[NV];
    trace_face<AX>(ph, prim, i - (AX == 0), j - (AX == 1), k - (AX == 2), T(1), dtdx, dtdy,
                   dtdz, qm);
    trace_face<AX>(ph, prim, i, j, k, T(-1), dtdx, dtdy, dtdz, qp);
    const int it = face_flux<AX>(ph, qm, qp, f);
    if (ph.solver == SOLVER_APPROX && a.newton) {
#ifdef __CUDA_ARCH__
      const unsigned mask = __activemask();
      const unsigned total = __reduce_add_sync(mask, (unsigned)it);
      if ((threadIdx.x & 31) == __ffs(mask) - 1) atomicAdd(a.newton, (unsigned long long)total);
#else
      *a.newton += (unsigned long long)it;
#endif
    }
    T* out = a.F[AX];
    const long long nf = (long long)fx * fy * (a.nz + (AX == 2));
#pragma unroll
    for (int ch = 0; ch < NV; ++ch) out[ch * nf + c] = f[ch];
  }
};

// 3: godunov.py hydro_3d_interior_update: ((U + x part) + y part) + z part
template <typename T, bool GHOSTED>
struct UpdateStage {
  StepArgs<T> a;
  HD void operator()(long long c) const {
    if (!*a.active) return;
    const int nx = a.nx, ny = a.ny, nz = a.nz;
    const int i = (int)(c % nx);
    const long long r = c / nx;
    const int j = (int)(r % ny);
    const int k = (int)(r / ny);
    const long long cu =
        GHOSTED ? ((long long)(k + G) * (ny + 2 * G) + (j + G)) * (nx + 2 * G) + (i + G) : c;
    const T dt = *a.dt;
    const HydroPhys<T>& ph = a.ph;
    const T dtdx = dt / ph.dx, dtdy = dt / ph.dy, dtdz = dt / ph.dz;
    const long long nfx = (long long)nz * ny * (nx + 1);
    const long long nfy = (long long)nz * (ny + 1) * nx;
    const long long nfz = (long long)(nz + 1) * ny * nx;
    const long long cx = ((long long)k * ny + j) * (nx + 1) + i;
    const long long cy = ((long long)k * (ny + 1) + j) * nx + i;
    const long long cz = c;  // z faces: [nz+1][ny][nx], face k of cell c sits at c
#pragma unroll
    for (int ch = 0; ch < NV; ++ch) {
      const T* fx = a.F[0] + ch * nfx;
      const T* fy = a.F[1] + ch * nfy;
      const T* fz = a.F[2] + ch * nfz;
      T v = a.U[ch * a.nq + cu];
      v = v + dtdx * (fx[cx] - fx[cx + 1]);
      v = v + dtdy * (fy[cy] - fy[cy + nx]);
      v = v + dtdz * (fz[cz] - fz[cz + (long long)ny * nx]);
      a.out[ch * a.n + c] = v;
    }
  }
};

template <typename T>
long long scratch_values(int nx, int ny, int nz, int ghosted) {
  const long long nq = ghosted ? (long long)(nx + 2 * G) * (ny + 2 * G) * (nz + 2 * G)
                               : (long long)nx * ny * nz;
  const long long nf = (long long)nz * ny * (nx + 1) + (long long)nz * (ny + 1) * nx +
                       (long long)(nz + 1) * ny * nx;
  return NV * (nq + nf);
}

template <typename T, bool GHOSTED>
int hydro_step(StepArgs<T> a, void* stream) {
  int err;
  if ((err = launch_cells(PrimStage<T>{a}, a.nq, stream))) return err;
  const long long nx = a.nx, ny = a.ny, nz = a.nz;
  if ((err = launch_cells(FluxStage<T, GHOSTED, 0>{a}, nz * ny * (nx + 1), stream))) return err;
  if ((err = launch_cells(FluxStage<T, GHOSTED, 1>{a}, nz * (ny + 1) * nx, stream))) return err;
  if ((err = launch_cells(FluxStage<T, GHOSTED, 2>{a}, (nz + 1) * ny * nx, stream))) return err;
  return launch_cells(UpdateStage<T, GHOSTED>{a}, a.n, stream);
}

// in: the state (interior mode: S, updated in place, so out == in;
// ghosted mode: the ghosted U); bc: the six face types (interior mode)
template <typename T>
int hydro_step_entry(const T* in, T* out, T* scratch, const T* dt, const unsigned char* active,
                     int nx, int ny, int nz, int ghosted, const int* bc, const double* prm,
                     unsigned long long* newton, void* stream) {
  StepArgs<T> a;
  a.U = in;
  a.out = out;
  a.nx = nx;
  a.ny = ny;
  a.nz = nz;
  a.n = (long long)nx * ny * nz;
  a.nq = ghosted ? (long long)(nx + 2 * G) * (ny + 2 * G) * (nz + 2 * G) : a.n;
  a.Q = scratch;
  a.F[0] = a.Q + NV * a.nq;
  a.F[1] = a.F[0] + NV * (long long)nz * ny * (nx + 1);
  a.F[2] = a.F[1] + NV * (long long)nz * (ny + 1) * nx;
  a.dt = dt;
  a.active = active;
  a.newton = newton;
  for (int b = 0; b < 6; ++b) a.bc[b] = bc[b];
  a.ph = make_hydro_phys<T>(prm);
  return ghosted ? hydro_step<T, true>(a, stream) : hydro_step<T, false>(a, stream);
}

}  // namespace ramses::hydro

extern "C" {

long long ramses_hydro_step_scratch(int nx, int ny, int nz, int ghosted) {
  return ramses::hydro::scratch_values<float>(nx, ny, nz, ghosted);
}

int ramses_hydro_step_f32(const float* in, float* out, float* scratch, const float* dt,
                          const unsigned char* active, int nx, int ny, int nz, int ghosted,
                          const int* bc, const double* prm, unsigned long long* newton,
                          void* stream) {
  return ramses::hydro::hydro_step_entry<float>(in, out, scratch, dt, active, nx, ny, nz, ghosted, bc,
                                         prm, newton, stream);
}

int ramses_hydro_step_f64(const double* in, double* out, double* scratch, const double* dt,
                          const unsigned char* active, int nx, int ny, int nz, int ghosted,
                          const int* bc, const double* prm, unsigned long long* newton,
                          void* stream) {
  return ramses::hydro::hydro_step_entry<double>(in, out, scratch, dt, active, nx, ny, nz, ghosted, bc,
                                          prm, newton, stream);
}

}  // extern "C"

#ifdef RAMSES_COUNT_OPS
namespace ramses::hydro {

// the flux of every face along AX, counting only the rotation and the
// Riemann solve: the two face states are formed with the count paused
template <int AX>
void count_face_fluxes(const StepArgs<Counted>& a, const Prim<Counted, false>& prim,
                       Counted dtdx, Counted dtdy, Counted dtdz, unsigned long long* newton) {
  for (int k = 0; k < a.nz + (AX == 2); ++k)
    for (int j = 0; j < a.ny + (AX == 1); ++j)
      for (int i = 0; i < a.nx + (AX == 0); ++i) {
        Counted qm[NV], qp[NV], f[NV];
        const long long paused = Counted::ops;
        trace_face<AX>(a.ph, prim, i - (AX == 0), j - (AX == 1), k - (AX == 2), Counted(1),
                       dtdx, dtdy, dtdz, qm);
        trace_face<AX>(a.ph, prim, i, j, k, Counted(-1), dtdx, dtdy, dtdz, qp);
        Counted::ops = paused;
        const int it = face_flux<AX>(a.ph, qm, qp, f);
        if (newton) *newton += (unsigned long long)it;
      }
}

}  // namespace ramses::hydro

// The floating-point operations one interior-mode step of S[5][nz][ny][nx]
// needs (op_count.cuh), on the kernel's own per-cell functions: ops[0] the
// primitives of every cell; ops[1] one trace of every cell (its slopes and
// sources once, and its six face states); ops[2] the rotated Riemann solve
// of every face (the approx solver's Newton iterations included, summed
// into *newton); ops[3] the update. The staged kernel traces each cell six
// times (once per face state, each beside a fresh copy of the shared
// slopes and sources); that recomputation is the kernel's cost, not the
// step's, so it is not counted.
extern "C" void ramses_hydro_step_ops(const double* S, int nx, int ny, int nz, const int* bc,
                                      const double* prm, double dt, long long* ops,
                                      unsigned long long* newton) {
  using namespace ramses;
  using namespace ramses::hydro;
  const long long n = (long long)nx * ny * nz;
  std::vector<Counted> s = counted_copy(S, NV * n);
  std::vector<Counted> scratch(scratch_values<Counted>(nx, ny, nz, 0));
  const Counted dtc(dt);
  const unsigned char active = 1;
  StepArgs<Counted> a;
  a.U = s.data();
  a.out = s.data();
  a.nx = nx;
  a.ny = ny;
  a.nz = nz;
  a.n = a.nq = n;
  a.Q = scratch.data();
  a.F[0] = a.Q + NV * n;
  a.F[1] = a.F[0] + NV * (long long)nz * ny * (nx + 1);
  a.F[2] = a.F[1] + NV * (long long)nz * (ny + 1) * nx;
  a.dt = &dtc;
  a.active = &active;
  a.newton = nullptr;
  for (int b = 0; b < 6; ++b) a.bc[b] = bc[b];
  a.ph = make_hydro_phys<Counted>(prm);

  Counted::ops = 0;
  launch_cells(PrimStage<Counted>{a}, n, nullptr);
  ops[0] = Counted::ops;

  const Prim<Counted, false> prim = prim_of<Counted, false>(a);
  const Counted dtdx = dtc / a.ph.dx, dtdy = dtc / a.ph.dy, dtdz = dtc / a.ph.dz;
  Counted::ops = 0;
  for (int k = 0; k < nz; ++k)
    for (int j = 0; j < ny; ++j)
      for (int i = 0; i < nx; ++i) {
        CellTrace<Counted> c;
        Counted out[NV];
        trace_cell(a.ph, prim, i, j, k, dtdx, dtdy, dtdz, c);
        for (const Counted sign : {Counted(1), Counted(-1)}) {
          face_state<0>(a.ph, c, sign, out);
          face_state<1>(a.ph, c, sign, out);
          face_state<2>(a.ph, c, sign, out);
        }
      }
  ops[1] = Counted::ops;

  Counted::ops = 0;
  count_face_fluxes<0>(a, prim, dtdx, dtdy, dtdz, newton);
  count_face_fluxes<1>(a, prim, dtdx, dtdy, dtdz, newton);
  count_face_fluxes<2>(a, prim, dtdx, dtdy, dtdz, newton);
  ops[2] = Counted::ops;

  Counted::ops = 0;  // the update's operations do not depend on the fluxes' values
  launch_cells(UpdateStage<Counted, false>{a}, n, nullptr);
  ops[3] = Counted::ops;
}
#endif
