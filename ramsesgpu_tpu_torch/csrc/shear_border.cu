// The shearing box's x borders, around the step kernel's shear mode
// (mhd_step.cu), in two kernels:
//
// - shear_slabs: the sheared x ghost slabs G[2][8][nz][ny][3] (XMIN,
//   XMAX) at time t + dt from the loop state (S, kept): each ghost is the
//   opposite border shifted in y by deltay = 1.5 omega0 Lx (t + dt) mod Ly,
//   interpolated linearly with a limited-slope correction; By takes the
//   conservative form b + eps * slope; the XMAX slab's first Bx column is
//   the kept face. Plain twin: ramsesgpu_tpu_torch/solvers/shear.py
//   shear_slabs (JAX: pallas/shear_packed.py:167
//   _shear_slabs_from_interior, solvers/shear.py:106).
// - shear_border: the conservative remap at the two domain x faces at
//   t + dt/2 and what it changes (pallas/shear_packed.py:1108-1168): the
//   step kernel's density flux and emfY planes of faces 0 and nx are
//   remapped against each other; the border columns 0 and nx-1 get the
//   density, Bx and Bz deltas and the density floor; the kept Bx face gets
//   its CT update with the remapped emfY. One thread per (z, y) row; it
//   also writes the remapped planes. Plain twin: solvers/godunov_mhd.py
//   shear_border_update.
//
// Together with the step kernel they replace the TPU kernels
// pallas/shear_packed.py:237 _make_strip_kernel (the border strip with its
// true sheared ghosts and remap planes) and the XLA glue around it
// (:952-1004 the slab build, :1108-1174 remap and corrections); the TPU's
// fused variant :432 _make_strip_kernel_fused is another kernel (a
// dissipative run's default) and is not this one.
//
// deltay and jplus are computed in the state's dtype with the JAX op order
// and an FMA-free product (r_mul), so kernel and twin pick the same shift
// where deltay / dy lands near an integer.
//
// Both move a few planes of nz * ny values (the slabs read 6 border
// columns and write 6; the border kernel reads 5 planes and 5 border
// values and writes 5 and 4 planes): a few microseconds of traffic at
// 128x256x128, near a launch's own latency.
#include "common.cuh"

namespace ramses::shear {

constexpr int SLAB = 3;  // ghost columns per side (ghost_width)
constexpr int NPLANE = 5;

template <typename T>
struct Consts {
  T fill_k, fill_ly, remap_k, remap_ly;
};

template <typename T>
Consts<T> make_consts(const double* p) {
  return Consts<T>{T(p[P_FILL_K]), T(p[P_FILL_LY]), T(p[P_REMAP_K]), T(p[P_REMAP_LY])};
}

// the y shift of the fill at time tf (solvers/shear.py:44-49): jplus and
// epsi = deltay mod dy
template <typename T>
HD void fill_offset(const Consts<T>& k, const Phys<T>& ph, T tf, int& jplus, T& epsi) {
  const T deltay = r_fmod(r_mul(k.fill_k, tf), k.fill_ly);
  jplus = to_int(r_floor(deltay / ph.dy));
  epsi = r_fmod(deltay, ph.dy);
}

template <typename T>
struct SlabBuild {
  const T* S;
  const T* kept;
  T* slabs;
  const T* t;
  const T* dt;
  Dims d;
  Phys<T> ph;
  Consts<T> k;

  // the border value b and its limited y-slope at row j (periodic y)
  HD void sample(int ch, int kz, int j, int col, T& b, T& s) const {
    const T* row = S + ch * d.n;
    const int ny = d.ny;
    const T bm = row[cell_at(d, col, mod_n(j - 1, ny), kz)];
    b = row[cell_at(d, col, mod_n(j, ny), kz)];
    const T bp = row[cell_at(d, col, mod_n(j + 1, ny), kz)];
    s = slope1(bm, b, bp, ph.slope);
  }

  HD void operator()(long long c) const {
    const int col = (int)(c % SLAB);
    long long r = c / SLAB;
    const int j = (int)(r % d.ny);
    r /= d.ny;
    const int kz = (int)(r % d.nz);
    r /= d.nz;
    const int ch = (int)(r % 8);
    const int side = (int)(r / 8);
    int jplus;
    T epsi;
    fill_offset(k, ph, *t + *dt, jplus, epsi);
    T val;
    if (side == 0) {
      // XMIN ghosts <- the XMAX border shifted down (make_boundary_shear.h:213-247)
      const T eps = T(1) - epsi / ph.dy;
      const T lam = T(0.5) * eps * (eps - T(1));
      T b0, s0, b1, s1;
      sample(ch, kz, j - jplus, d.nx - SLAB + col, b0, s0);
      sample(ch, kz, j - jplus - 1, d.nx - SLAB + col, b1, s1);
      val = ch == IB ? b1 + eps * s1 : (T(1) - eps) * b1 + eps * b0 + lam * (s1 - s0);
    } else {
      // XMAX ghosts <- the XMIN border shifted up (make_boundary_shear.h:251-299)
      const T eps = epsi / ph.dy;
      const T lam = T(0.5) * eps * (eps - T(1));
      T b0, s0, b1, s1;
      sample(ch, kz, j + jplus, col, b0, s0);
      sample(ch, kz, j + jplus + 1, col, b1, s1);
      val = ch == IB ? b0 + eps * s0 : (T(1) - eps) * b0 + eps * b1 - lam * (s0 - s1);
      if (ch == IA && col == 0) val = kept[(long long)kz * d.ny + j];  // the kept face
    }
    slabs[c] = val;
  }
};

template <typename T>
struct BorderFix {
  T* S;
  T* kept;
  const T* planes;   // [5][nz][ny]: fpl_min, fpl_max, eypl_min, eypl_max, ezpl_max
  T* remapped;       // [4][nz][ny]: the first four after the remap
  const T* t;
  const T* dt;
  const unsigned char* active;
  Dims d;
  Phys<T> ph;
  Consts<T> k;

  HD T P(int p, int kz, int j) const {
    return planes[((long long)p * d.nz + kz) * d.ny + mod_n(j, d.ny)];
  }
  // godunov_mhd.py:574 _shear_remap_pair_stacked on the pair (p, p + 1)
  // of planes at row (kz, j): each side's half-sum with the other side
  // interpolated at the sheared y
  HD T remap_min(int p, int kz, int j, int jplus, T w) const {
    return T(0.5) * (P(p, kz, j) + (w * P(p + 1, kz, j - jplus - 1) +
                                    (T(1) - w) * P(p + 1, kz, j - jplus)));
  }
  HD T remap_max(int p, int kz, int j, int jplus, T w) const {
    return T(0.5) * (P(p + 1, kz, j) + ((T(1) - w) * P(p, kz, j + jplus) +
                                        w * P(p, kz, j + jplus + 1)));
  }

  HD void operator()(long long c) const {
    if (!*active) return;
    const int j = (int)(c % d.ny);
    const int kz = (int)(c / d.ny);
    const int kp = wrap_p(kz, d.nz);
    const T dtv = *dt;
    // the remap's shift at t + dt/2 (godunov_mhd.py:583-585)
    const T deltay = r_fmod(r_mul(k.remap_k, *t + T(0.5) * dtv), k.remap_ly);
    const int jplus = to_int(r_floor(deltay / ph.dy));
    const T w = r_fmod(deltay, ph.dy) / ph.dy;

    const T fmin_r = remap_min(0, kz, j, jplus, w);
    const T fmax_r = remap_max(0, kz, j, jplus, w);
    const T emin_r = remap_min(2, kz, j, jplus, w);
    const T emax_r = remap_max(2, kz, j, jplus, w);
    const T d_emin = emin_r - P(2, kz, j);
    const T d_emin_p = remap_min(2, kp, j, jplus, w) - P(2, kp, j);
    const T d_emax = emax_r - P(3, kz, j);
    const T emax_r_p = remap_max(2, kp, j, jplus, w);

    const T dtdx = dtv / ph.dx, dtdy = dtv / ph.dy, dtdz = dtv / ph.dz;
    const long long n = d.n;
    const long long lo = cell_at(d, 0, j, kz), hi = cell_at(d, d.nx - 1, j, kz);
    // border-column deltas (shear_packed.py:1128-1157): density remap with
    // the floor (shearingBox_utils.cuh:484-485), dbx at the xmin face, dbz
    S[ID * n + lo] = pmax(S[ID * n + lo] + dtdx * (fmin_r - P(0, kz, j)), ph.smallr);
    S[IA * n + lo] = S[IA * n + lo] + -dtdz * (d_emin_p - d_emin);
    S[IC * n + lo] = S[IC * n + lo] + -dtdx * d_emin;
    S[ID * n + hi] = pmax(S[ID * n + hi] + -dtdx * (fmax_r - P(1, kz, j)), ph.smallr);
    S[IC * n + hi] = S[IC * n + hi] + dtdx * d_emax;
    // CT of the kept Bx face with the remapped emfY (shear_packed.py:1161-1168)
    kept[c] = kept[c] + (dtdy * (P(4, kz, j + 1) - P(4, kz, j)) - dtdz * (emax_r_p - emax_r));
    const long long np = (long long)d.nz * d.ny;
    remapped[c] = fmin_r;
    remapped[np + c] = fmax_r;
    remapped[2 * np + c] = emin_r;
    remapped[3 * np + c] = emax_r;
  }
};

template <typename T>
int shear_slabs(const T* S, const T* kept, T* slabs, const T* t, const T* dt, int nx, int ny,
                int nz, const double* prm, void* stream) {
  const Dims d = make_dims(nx, ny, nz);
  SlabBuild<T> f{S, kept, slabs, t, dt, d, make_phys<T>(prm), make_consts<T>(prm)};
  return launch_cells(f, 2LL * 8 * nz * ny * SLAB, stream);
}

template <typename T>
int shear_border(T* S, T* kept, const T* planes, T* remapped, const T* t, const T* dt,
                 const unsigned char* active, int nx, int ny, int nz, const double* prm,
                 void* stream) {
  const Dims d = make_dims(nx, ny, nz);
  BorderFix<T> f{S, kept, planes, remapped, t, dt, active, d, make_phys<T>(prm),
                 make_consts<T>(prm)};
  return launch_cells(f, (long long)nz * ny, stream);
}

}  // namespace ramses::shear

extern "C" {

int ramses_shear_slabs_f32(const float* S, const float* kept, float* slabs, const float* t,
                           const float* dt, int nx, int ny, int nz, const double* prm,
                           void* stream) {
  return ramses::shear::shear_slabs<float>(S, kept, slabs, t, dt, nx, ny, nz, prm, stream);
}

int ramses_shear_slabs_f64(const double* S, const double* kept, double* slabs,
                           const double* t, const double* dt, int nx, int ny, int nz,
                           const double* prm, void* stream) {
  return ramses::shear::shear_slabs<double>(S, kept, slabs, t, dt, nx, ny, nz, prm, stream);
}

int ramses_shear_border_f32(float* S, float* kept, const float* planes, float* remapped,
                            const float* t, const float* dt, const unsigned char* active,
                            int nx, int ny, int nz, const double* prm, void* stream) {
  return ramses::shear::shear_border<float>(S, kept, planes, remapped, t, dt, active, nx, ny,
                                            nz, prm, stream);
}

int ramses_shear_border_f64(double* S, double* kept, const double* planes, double* remapped,
                            const double* t, const double* dt, const unsigned char* active,
                            int nx, int ny, int nz, const double* prm, void* stream) {
  return ramses::shear::shear_border<double>(S, kept, planes, remapped, t, dt, active, nx,
                                             ny, nz, prm, stream);
}

}  // extern "C"

#ifdef RAMSES_COUNT_OPS
// the floating-point operations of the two kernels on a state (op_count.cuh):
// out[0] the slab build, out[1] the border kernel
extern "C" void ramses_shear_border_ops(const double* S, const double* kept,
                                        const double* planes, int nx, int ny, int nz,
                                        const double* prm, double t, double dt,
                                        long long* out) {
  using ramses::Counted;
  const long long n = 8LL * nx * ny * nz, np = (long long)nz * ny;
  std::vector<Counted> s = ramses::counted_copy(S, n);
  std::vector<Counted> kp = ramses::counted_copy(kept, np);
  std::vector<Counted> pl = ramses::counted_copy(planes, ramses::shear::NPLANE * np);
  std::vector<Counted> slabs(2LL * 8 * np * ramses::shear::SLAB), rem(4 * np);
  const Counted tc(t), dtc(dt);
  const unsigned char active = 1;
  Counted::ops = 0;
  ramses::shear::shear_slabs<Counted>(s.data(), kp.data(), slabs.data(), &tc, &dtc, nx, ny, nz,
                                      prm, nullptr);
  out[0] = Counted::ops;
  Counted::ops = 0;
  ramses::shear::shear_border<Counted>(s.data(), kp.data(), pl.data(), rem.data(), &tc, &dtc,
                                       &active, nx, ny, nz, prm, nullptr);
  out[1] = Counted::ops;
}
#endif
