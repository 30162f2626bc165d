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
//   z wrap, an x load outside [0, nx) reads a slab. Replaces the dissipative
//   sub-step of the TPU's MRI loop, pallas/shear_packed.py:917 with the
//   border strip's mode "dissip" (:339-362 of :237, and of the fused strip
//   :432). It also applies the resistive CT to the kept Bx face at x = nx;
//   that face's old value comes from the XMAX slab's first Bx column, never
//   from `kept`, which this kernel writes. Plain twin:
//   mhd_dissipation_shear_update + kept_face_resistive_ct.
//
// The function (JAX solvers/dissipation.py:285 mhd_dissipation_interior_update):
// the resistive EMF -eta J on the edges from the old B; its CT curl on the
// whole extent (B2); the resistive energy flux from B2 (cIso <= 0 only);
// the viscous stress fluxes from rho and the velocities (their energy flux
// with cIso <= 0 only); the interior gains flux[c] - flux[c+1]. nu and eta
// are independent, either may be 0.
//
// Design (first, simple version): one thread per cell per stage, the
// intermediates in one scratch buffer (the loops pass the step kernel's
// stage buffer, idle by then on the same stream):
//   1 load    S (slabs) -> W[7]    rho, u, v, w, bx, by, bz
//   2 emf     W -> emf[3]          -eta J on the z, y, x edges       (eta > 0)
//   3 ct      emf -> W's B         B2 = B + curl, in place           (eta > 0)
//   4 flux    W -> fl[3][5]        at each cell's left x, y, z face: the
//                                  stresses on u, v, w, the viscous and the
//                                  resistive energy flux
//   5 update  S, W, fl -> S        in place (each thread its own cell);
//                                  shear: the kept face
// The stage grid is the state's (periodic) or nx + 2 XH columns wide
// (shear): the energy flux reads B2 one cell outside the interior, whose CT
// needs the EMFs of columns -1..nx+1 and those the B of columns -2..nx+1
// (XH = 2). Every stage computes whole rows, its x reads clamped to the
// grid: the clamped cells are never read (PERF.md: partly written rows cost
// mhd_step.cu's shear mode 1.7x).
//
// Rounding: the increment is a difference of nearly equal face fluxes, so
// an FMA the twin does not make moves it by ~1e-6 of its own norm in f32.
// The file is compiled without FMA contraction (kernels/build.py) and keeps
// the twin's op order, so it repeats the twin's roundings.
//
// Bound on the H100: bytes. The function reads rho, the momenta, E and B and
// writes the momenta, E and B: 60 B/cell in f32 (52 isothermal: no E),
// 0.065 ms at 128x256x128 at 3.35 TB/s, against a few hundred flops per
// cell. This staged version moves its 25 scratch values per stage-grid cell
// through device memory and reads each neighbour again from there; fusing
// the stages on a z-plane ring in shared memory is the next step for speed.
#include "common.cuh"

namespace ramses::dissip {

constexpr int SLAB = 3;  // ghost columns of each sheared slab (ghost_width)
constexpr int XH = 2;    // stage-grid columns beyond each x face (shear mode)
enum { W_RHO = 0, W_U, W_V, W_W, W_BX, W_BY, W_BZ, NW };
// per face axis: the stresses on u, v, w, the viscous and the resistive
// energy flux (kept apart: the twin sums the two in another order)
enum { F_U = 0, F_V, F_W, F_EV, F_ER, NF };
constexpr long long SCRATCH_PER_CELL = NW + 3 + 3 * NF;

template <bool SHEAR_, bool ISO_>
struct Mode {
  static constexpr bool SHEAR = SHEAR_;
  static constexpr bool ISO = ISO_;
};

// the coefficients, each formed in double as the JAX package forms its
// Python floats and rounded once to T
template <typename T>
struct Coef {
  T c_norm, c_shear, m_eta;  // -2/3 nu, -nu, -eta
  T d[3], d4[3];             // dx, dy, dz and 4 dx, 4 dy, 4 dz
  bool visc, resist;
};

template <typename T>
struct Args {
  T* S;            // [8][n] state, updated in place by the update stage
  T* W;            // [NW][ne] rho, velocities, B (B2 after the ct stage)
  T* emf;          // [3][ne] edge EMFs z, y, x
  T* fl;           // [3][NF][ne] face fluxes x, y, z
  const T* slabs;  // shear: [2][8][nz][ny][SLAB] sheared x ghosts (XMIN, XMAX)
  T* kept;         // shear: [nz][ny] the kept Bx face (written when eta > 0)
  const T* dt;     // device scalar
  const unsigned char* active;  // device flag: 0 skips the sub-step
  Dims d;          // the state's
  Dims e;          // the stage grid's
  Phys<T> ph;
  Coef<T> k;
};

HD int clamp_i(int i, int lo, int hi) { return i < lo ? lo : (i > hi ? hi : i); }

HD int wrap_d(int i, int di, int n) {
  return di == 0 ? i : (di > 0 ? wrap_p(i, n) : wrap_m(i, n));
}

// One stage thread's cell (i, j, k) and its neighbours (offsets of at most
// one cell per axis). Periodic: the stage grid is the state's and every
// offset wraps. Shear: stage column i sits at i + XH, x offsets clamp to the
// grid, y and z wrap.
template <typename T, typename M>
struct Site {
  const Args<T>& a;
  int i, j, k;
  long long c;  // stage-grid index of (i, j, k)

  // t: the thread's stage-grid cell, or (on_state) its state cell
  HD Site(const Args<T>& a_, long long t, bool on_state = false) : a(a_) {
    if constexpr (M::SHEAR) {
      if (on_state) {
        cell_ijk(a.d, t, i, j, k);
        c = cell_at(a.e, i + XH, j, k);
        return;
      }
      cell_ijk(a.e, t, i, j, k);
      i -= XH;
    } else {
      cell_ijk(a.d, t, i, j, k);
    }
    c = t;
  }
  HD long long q(int di, int dj, int dk) const {
    const int jj = wrap_d(j, dj, a.d.ny), kk = wrap_d(k, dk, a.d.nz);
    if constexpr (M::SHEAR)
      return cell_at(a.e, clamp_i(i + di, -XH, a.e.nx - XH - 1) + XH, jj, kk);
    return cell_at(a.d, wrap_d(i, di, a.d.nx), jj, kk);
  }
  // stage field f at the neighbour
  HD T w(int f, int di, int dj, int dk) const { return a.W[f * a.e.n + q(di, dj, dk)]; }
  // the state's channel ch at this cell, from the state or a slab
  HD T src(int ch) const {
    if constexpr (M::SHEAR) {
      if (i >= 0 && i < a.d.nx) return a.S[ch * a.d.n + cell_at(a.d, i, j, k)];
      const int side = i < 0 ? 0 : 1;
      const int col = i < 0 ? i + SLAB : i - a.d.nx;
      return a.slabs[((((long long)side * 8 + ch) * a.d.nz + k) * a.d.ny + j) * SLAB + col];
    } else {
      return a.S[ch * a.d.n + c];
    }
  }
};

// 1: rho, the velocities and B on the stage grid
template <typename T, typename M>
struct LoadStage {
  Args<T> a;
  HD void operator()(long long t) const {
    if (!*a.active) return;
    const Site<T, M> p(a, t);
    const long long n = a.e.n, c = p.c;
    const T rho = p.src(ID);
    T* W = a.W;
    W[W_RHO * n + c] = rho;
    W[W_U * n + c] = p.src(IU) / rho;
    W[W_V * n + c] = p.src(IV) / rho;
    W[W_W * n + c] = p.src(IW) / rho;
    W[W_BX * n + c] = p.src(IA);
    W[W_BY * n + c] = p.src(IB);
    W[W_BZ * n + c] = p.src(IC);
  }
};

// the edge current J_f (dissipation.py: jx = bdiff(bz, y) - bdiff(by, z),
// jy = bdiff(bx, z) - bdiff(bz, x), jz = bdiff(by, x) - bdiff(bx, y)) at
// the offset (ox, oy, oz), from the stage grid's B. Callers pass constant
// f and offsets, so every index folds at compile time.
template <typename T, typename M>
HD T current(const Site<T, M>& p, int f, int ox, int oy, int oz) {
  const int f1 = (f + 1) % 3, f2 = (f + 2) % 3;  // J_f = d_f1 B_f2 - d_f2 B_f1
  const T* d = p.a.k.d;
  return (p.w(W_BX + f2, ox, oy, oz) -
          p.w(W_BX + f2, ox - (f1 == 0), oy - (f1 == 1), oz - (f1 == 2))) / d[f1] -
         (p.w(W_BX + f1, ox, oy, oz) -
          p.w(W_BX + f1, ox - (f2 == 0), oy - (f2 == 1), oz - (f2 == 2))) / d[f2];
}

// 2: dissipation.py compute_resistivity_emf: -eta J at the edges
// (i, j-1/2, k-1/2) for x, (i-1/2, j, k-1/2) for y, (i-1/2, j-1/2, k) for z
template <typename T, typename M>
struct EmfStage {
  Args<T> a;
  HD void operator()(long long t) const {
    if (!*a.active) return;
    const Site<T, M> p(a, t);
    const long long n = a.e.n;
    a.emf[p.c] = a.k.m_eta * current(p, 2, 0, 0, 0);
    a.emf[n + p.c] = a.k.m_eta * current(p, 1, 0, 0, 0);
    a.emf[2 * n + p.c] = a.k.m_eta * current(p, 0, 0, 0, 0);
  }
};

// 3: the CT curl of the resistive EMF (dissipation.py _ct_deltas), in place
// on the stage grid's B: each thread reads the EMFs and its own B only
template <typename T, typename M>
struct CtStage {
  Args<T> a;
  HD void operator()(long long t) const {
    if (!*a.active) return;
    const Site<T, M> p(a, t);
    const long long n = a.e.n, c = p.c;
    const T dt = *a.dt;
    const T dtdx = dt / a.ph.dx, dtdy = dt / a.ph.dy, dtdz = dt / a.ph.dz;
    const T* ez = a.emf;
    const T* ey = a.emf + n;
    const T* ex = a.emf + 2 * n;
    const long long cxp = p.q(1, 0, 0), cyp = p.q(0, 1, 0), czp = p.q(0, 0, 1);
    const T dbx = (ez[cyp] - ez[c]) * dtdy - (ey[czp] - ey[c]) * dtdz;
    const T dby = (ex[czp] - ex[c]) * dtdz - (ez[cxp] - ez[c]) * dtdx;
    const T dbz = (ey[cxp] - ey[c]) * dtdx - (ex[cyp] - ex[c]) * dtdy;
    T* W = a.W;
    W[W_BX * n + c] = W[W_BX * n + c] + dbx;
    W[W_BY * n + c] = W[W_BY * n + c] + dby;
    W[W_BZ * n + c] = W[W_BZ * n + c] + dbz;
  }
};

// 4: the fluxes at each cell's left face along each axis (dissipation.py
// compute_viscosity_fluxes and compute_resistivity_energy_fluxes). The face
// axis is a template parameter and the loops unroll, so every stencil
// offset and array index is a compile-time constant (no local memory).
template <typename T, typename M>
struct FluxStage {
  Args<T> a;

  HD void operator()(long long t) const {
    if (!*a.active) return;
    const Site<T, M> p(a, t);
    face<0>(p);
    face<1>(p);
    face<2>(p);
  }

  // field f at the unit offsets s1 e_a1 + s2 e_a2
  HD T at(const Site<T, M>& p, int f, int a1, int s1, int a2 = 0, int s2 = 0) const {
    return p.w(f, s1 * (a1 == 0) + s2 * (a2 == 0), s1 * (a1 == 1) + s2 * (a2 == 1),
               s1 * (a1 == 2) + s2 * (a2 == 2));
  }

  template <int AX>
  HD void face(const Site<T, M>& p) const {
    const Coef<T>& k = a.k;
    const long long n = a.e.n;
    const T dt = *a.dt;
    T* out = a.fl + (long long)AX * NF * n + p.c;  // out[f * n]: flux f at this face
    // the two transverse axes, ascending
    constexpr int T1 = AX == 0 ? 1 : 0, T2 = AX == 2 ? 1 : 2;
    if (k.visc) {
      const T rho_f = T(0.5) * (p.w(W_RHO, 0, 0, 0) + at(p, W_RHO, AX, -1));
      T vc[3], vm[3], dnorm[3];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        vc[q] = p.w(W_U + q, 0, 0, 0);
        vm[q] = at(p, W_U + q, AX, -1);
        dnorm[q] = (vc[q] - vm[q]) / k.d[AX];
      }
      // _tavg4: the centred difference along t of the face sum f + f[AX-1]
      T dtr[3][3];
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        if (t == AX) continue;
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const T gp = at(p, W_U + q, t, 1) + at(p, W_U + q, t, 1, AX, -1);
          const T gm = at(p, W_U + q, t, -1) + at(p, W_U + q, t, -1, AX, -1);
          dtr[t][q] = (gp - gm) / k.d4[t];
        }
      }
      const T div_t = dtr[T1][T1] + dtr[T2][T2];
      const T s_n = k.c_norm * rho_f * (T(2) * dnorm[AX] - div_t);
      const T s_1 = k.c_shear * rho_f * (dtr[T1][AX] + dnorm[T1]);
      const T s_2 = k.c_shear * rho_f * (dtr[T2][AX] + dnorm[T2]);
      out[(F_U + AX) * n] = s_n * dt / k.d[AX];
      out[(F_U + T1) * n] = s_1 * dt / k.d[AX];
      out[(F_U + T2) * n] = s_2 * dt / k.d[AX];
      if constexpr (!M::ISO) {
        const T e = T(0.5) * (vc[AX] + vm[AX]) * s_n + T(0.5) * (vc[T1] + vm[T1]) * s_1 +
                    T(0.5) * (vc[T2] + vm[T2]) * s_2;
        out[F_EV * n] = e * dt / k.d[AX];
      }
    }
    if constexpr (!M::ISO) {
      if (k.resist) {
        // -eta (J_a1 B_a2 - J_a2 B_a1) at the face, a1, a2 = AX + 1, AX + 2
        // (mod 3): each current averaged over its two edges on the face
        // (pair), each field over the four cells around it (quad)
        constexpr int A1 = (AX + 1) % 3, A2 = (AX + 2) % 3;
        const T pair1 = T(0.5) * (current(p, A1, 0, 0, 0) +
                                  current(p, A1, A2 == 0, A2 == 1, A2 == 2));
        const T pair2 = T(0.5) * (current(p, A2, 0, 0, 0) +
                                  current(p, A2, A1 == 0, A1 == 1, A1 == 2));
        const T quad2 = T(0.25) * (p.w(W_BX + A2, 0, 0, 0) + at(p, W_BX + A2, AX, -1) +
                                   at(p, W_BX + A2, A2, 1) + at(p, W_BX + A2, AX, -1, A2, 1));
        const T quad1 = T(0.25) * (p.w(W_BX + A1, 0, 0, 0) + at(p, W_BX + A1, AX, -1) +
                                   at(p, W_BX + A1, A1, 1) + at(p, W_BX + A1, AX, -1, A1, 1));
        out[F_ER * n] = k.m_eta * (pair1 * quad2 - pair2 * quad1) * dt / k.d[AX];
      }
    }
  }
};

// 5: the update of the state's cells, in place (each thread reads and
// writes its own cell of S only): E and the momenta gain their flux
// differences in the twin's order (resistive x, y, z, then viscous x, y,
// z), B becomes B2; the shear mode's last column writes the kept face
template <typename T, typename M>
struct UpdateStage {
  Args<T> a;

  HD T diff(const Site<T, M>& p, int ax, int f) const {
    const T* F = a.fl + ((long long)ax * NF + f) * a.e.n;
    const long long nb = p.q(ax == 0, ax == 1, ax == 2);
    return F[p.c] - F[nb];
  }

  HD void operator()(long long t) const {  // t: the state's cell
    if (!*a.active) return;
    const Site<T, M> p(a, t, true);
    const Coef<T>& k = a.k;
    T* S = a.S;
    const long long ns = a.d.n;
    if constexpr (!M::ISO) {
      if (k.visc || k.resist) {
        T d = T(0);
        if (k.resist)
          for (int ax = 0; ax < 3; ++ax) d = d + diff(p, ax, F_ER);
        if (k.visc)
          for (int ax = 0; ax < 3; ++ax) d = d + diff(p, ax, F_EV);
        S[IP * ns + t] = S[IP * ns + t] + d;
      }
    }
    if (k.visc) {
      for (int q = 0; q < 3; ++q) {
        T d = T(0);
        for (int ax = 0; ax < 3; ++ax) d = d + diff(p, ax, F_U + q);
        S[(IU + q) * ns + t] = S[(IU + q) * ns + t] + d;
      }
    }
    if (k.resist) {
      const long long n = a.e.n;
      for (int f = 0; f < 3; ++f) S[(IA + f) * ns + t] = a.W[(W_BX + f) * n + p.c];
      if constexpr (M::SHEAR) {
        // the kept face x = nx: the XMAX slab's first Bx column after the CT
        if (p.i == a.d.nx - 1)
          a.kept[(long long)p.k * a.d.ny + p.j] = a.W[W_BX * n + p.q(1, 0, 0)];
      }
    }
  }
};

template <typename T, typename M>
Args<T> make_args(T* S, T* scratch, const T* slabs, T* kept, const T* dt,
                  const unsigned char* active, int nx, int ny, int nz, const double* prm) {
  Args<T> a;
  a.d = make_dims(nx, ny, nz);
  a.e = M::SHEAR ? make_dims(nx + 2 * XH, ny, nz) : a.d;
  a.ph = make_phys<T>(prm);
  const double nu = prm[P_NU], eta = prm[P_ETA];
  a.k.c_norm = T(-(2.0 / 3.0) * nu);
  a.k.c_shear = T(-nu);
  a.k.m_eta = T(-eta);
  const double dh[3] = {prm[P_DX], prm[P_DY], prm[P_DZ]};
  for (int i = 0; i < 3; ++i) {
    a.k.d[i] = T(dh[i]);
    a.k.d4[i] = T(4.0 * dh[i]);
  }
  a.k.visc = nu > 0.0;
  a.k.resist = eta > 0.0;
  const long long n = a.e.n;
  a.S = S;
  a.W = scratch;
  a.emf = a.W + NW * n;
  a.fl = a.emf + 3 * n;
  a.slabs = slabs;
  a.kept = kept;
  a.dt = dt;
  a.active = active;
  return a;
}

template <typename T, typename M>
int dissip_step(T* S, T* scratch, const T* slabs, T* kept, const T* dt,
                const unsigned char* active, int nx, int ny, int nz, const double* prm,
                void* stream) {
  const Args<T> a = make_args<T, M>(S, scratch, slabs, kept, dt, active, nx, ny, nz, prm);
  const long long n = a.e.n;
  int err;
  if ((err = launch_cells(LoadStage<T, M>{a}, n, stream))) return err;
  if (a.k.resist) {
    if ((err = launch_cells(EmfStage<T, M>{a}, n, stream))) return err;
    if ((err = launch_cells(CtStage<T, M>{a}, n, stream))) return err;
  }
  if (a.k.visc || (a.k.resist && !M::ISO))
    if ((err = launch_cells(FluxStage<T, M>{a}, n, stream))) return err;
  return launch_cells(UpdateStage<T, M>{a}, a.d.n, stream);
}

// the isothermal instantiation for cIso > 0 (no energy terms at all)
template <typename T, bool SHEAR>
int dispatch(T* S, T* scratch, const T* slabs, T* kept, const T* dt,
             const unsigned char* active, int nx, int ny, int nz, const double* prm,
             void* stream) {
  if (prm[P_CISO] > 0.0)
    return dissip_step<T, Mode<SHEAR, true>>(S, scratch, slabs, kept, dt, active, nx, ny, nz, prm,
                                             stream);
  return dissip_step<T, Mode<SHEAR, false>>(S, scratch, slabs, kept, dt, active, nx, ny, nz, prm,
                                            stream);
}

}  // namespace ramses::dissip

extern "C" {

// the scratch values of a call: SCRATCH_PER_CELL per stage-grid cell
long long ramses_dissip_step_scratch(int nx, int ny, int nz, int shear) {
  return ramses::dissip::SCRATCH_PER_CELL * (nx + (shear ? 2LL * ramses::dissip::XH : 0)) * ny *
         nz;
}

int ramses_dissip_step_f32(float* S, float* scratch, const float* dt,
                           const unsigned char* active, int nx, int ny, int nz,
                           const double* prm, void* stream) {
  return ramses::dissip::dispatch<float, false>(S, scratch, nullptr, nullptr, dt, active, nx, ny,
                                                nz, prm, stream);
}

int ramses_dissip_step_f64(double* S, double* scratch, const double* dt,
                           const unsigned char* active, int nx, int ny, int nz,
                           const double* prm, void* stream) {
  return ramses::dissip::dispatch<double, false>(S, scratch, nullptr, nullptr, dt, active, nx, ny,
                                                 nz, prm, stream);
}

int ramses_dissip_step_shear_f32(float* S, float* scratch, const float* slabs, float* kept,
                                 const float* dt, const unsigned char* active, int nx, int ny,
                                 int nz, const double* prm, void* stream) {
  return ramses::dissip::dispatch<float, true>(S, scratch, slabs, kept, dt, active, nx, ny, nz,
                                               prm, stream);
}

int ramses_dissip_step_shear_f64(double* S, double* scratch, const double* slabs, double* kept,
                                 const double* dt, const unsigned char* active, int nx, int ny,
                                 int nz, const double* prm, void* stream) {
  return ramses::dissip::dispatch<double, true>(S, scratch, slabs, kept, dt, active, nx, ny, nz,
                                                prm, stream);
}

}  // extern "C"

#ifdef RAMSES_COUNT_OPS
namespace ramses::dissip {

// the operations of one call as the sub-step needs them (op_count.cuh):
// periodic, every stage on every cell; shear, each stage only on the
// stage-grid columns a later stage reads (load -2..nx+1, emf -1..nx+1, ct
// -1..nx, the x faces 0..nx and the y and z faces 0..nx-1), the update on
// the state
template <typename M>
long long count_ops(Counted* S, Counted* scratch, const Counted* slabs, Counted* kept,
                    const Counted* dt, int nx, int ny, int nz, const double* prm) {
  const unsigned char active = 1;
  const Args<Counted> a = make_args<Counted, M>(S, scratch, slabs, kept, dt, &active, nx, ny, nz,
                                                prm);
  long long ops = 0;
  // run f(t) on every stage-grid cell, counting the columns lo..hi
  auto columns = [&](const auto& f, int lo, int hi) {
    for (long long t = 0; t < a.e.n; ++t) {
      const long long before = Counted::ops;
      f(t);
      const int i = M::SHEAR ? (int)(t % a.e.nx) - XH : lo;
      if (i >= lo && i <= hi) ops += Counted::ops - before;
    }
  };
  columns(LoadStage<Counted, M>{a}, -XH, nx + XH - 1);
  if (a.k.resist) {
    columns(EmfStage<Counted, M>{a}, -1, nx + 1);
    columns(CtStage<Counted, M>{a}, -1, nx);
  }
  if (a.k.visc || (a.k.resist && !M::ISO)) {
    const FluxStage<Counted, M> flux{a};
    columns(flux, 0, nx - 1);
    if constexpr (M::SHEAR) {  // the x faces at x = nx
      for (long long t = 0; t < a.e.n; ++t) {
        const Site<Counted, M> p(a, t);
        if (p.i != nx) continue;
        const long long before = Counted::ops;
        flux.template face<0>(p);
        ops += Counted::ops - before;
      }
    }
  }
  const long long before = Counted::ops;
  const UpdateStage<Counted, M> update{a};
  for (long long t = 0; t < a.d.n; ++t) update(t);
  return ops + Counted::ops - before;
}

template <bool SHEAR>
long long count_dispatch(const double* S, const double* slabs, int nx, int ny, int nz,
                         const double* prm, double dt) {
  const long long n = (long long)nx * ny * nz;
  std::vector<Counted> s = counted_copy(S, 8 * n);
  std::vector<Counted> sl;
  if (SHEAR) sl = counted_copy(slabs, 2LL * 8 * nz * ny * SLAB);
  std::vector<Counted> kept((long long)nz * ny);
  std::vector<Counted> scratch(ramses_dissip_step_scratch(nx, ny, nz, SHEAR));
  const Counted dtc(dt);
  const auto count = prm[P_CISO] > 0.0 ? count_ops<Mode<SHEAR, true>>
                                       : count_ops<Mode<SHEAR, false>>;
  return count(s.data(), scratch.data(), sl.data(), kept.data(), &dtc, nx, ny, nz, prm);
}

}  // namespace ramses::dissip

extern "C" long long ramses_dissip_step_ops(const double* S, int nx, int ny, int nz,
                                            const double* prm, double dt) {
  return ramses::dissip::count_dispatch<false>(S, nullptr, nx, ny, nz, prm, dt);
}

// the same for the shear mode, with the sheared slabs beside S
extern "C" long long ramses_dissip_step_shear_ops(const double* S, const double* slabs, int nx,
                                                  int ny, int nz, const double* prm, double dt) {
  return ramses::dissip::count_dispatch<true>(S, slabs, nx, ny, nz, prm, dt);
}
#endif
