// CFL reduction for 3D MHD: inv = max over cells of
//   sum_d (cf_d + |v_d|) / dx_d
// with cf_d the fast magnetosonic speed along d and the face-centred field
// averaged to cell centres (+1 face neighbour by periodic wrap).
//
// Replaces the TPU kernels ramsesgpu_tpu/pallas/packed_io.py:51
// make_packed_cfl_mhd (formula: solvers/timestep.py:114 _inv_dt_mhd_fields)
// and, in its shearing-box mode, pallas/shear_packed.py:716
// make_shear_cfl_kernel: the isothermal pressure (cIso > 0), vy offset by
// the rotating frame's 1.5 omega0 dx / 2, and the last column's +1 x face
// read from the kept Bx face. Plain twins:
// ramsesgpu_tpu_torch/solvers/timestep.py inv_dt_mhd_periodic and
// inv_dt_mhd_shear.
//
// Layout: the interior-only state S[8][nz][ny][nx] (common.cuh); y and z
// wrap, x wraps too in the periodic mode; the kept face kept[nz][ny].
// Channel ch is read at S + ch * nx * ny * nz, so a compensated state
// S[16][nz][ny][nx] (the state, then its Kahan carry) is read as it lies:
// the reduction reaches its channels 0-7 only. With stratified z faces
// (shear mode) the top row's +1 z neighbour is the row itself.
//
// Design: the deterministic two-pass NaN-propagating block max of
// common.cuh (reduce_max) over the per-cell inverse dt.
//
// Bound on the H100: it reads the 8 channels once (plus the +1 face
// neighbours, mostly from cache): 32 bytes/cell in f32, about 0.54 GB at
// 256^3, so ~0.16 ms at the 3.35 TB/s peak; its 69 counted flops per
// cell (op_count.cuh) are far below the compute bound.
#include "common.cuh"

namespace ramses {

template <typename T>
HD T fast_speed_cfl(T d2, T c2, T bn, T rho) {
  return r_sqrt(d2 + r_sqrt(pmax(d2 * d2 - c2 * bn * bn / rho, T(0))));
}

// timestep.py _inv_dt_mhd_fields on one cell c: bx_r is Bx on its +1 x
// face, cyp/czp its +1 y/z neighbours
template <typename T, bool SHEAR>
HD T inv_dt_cell(const Phys<T>& ph, const T* S, long long n, long long c,
                 T bx_r, long long cyp, long long czp) {
  const T rho_raw = S[ID * n + c];
  const T rho0 = pmax(rho_raw, ph.smallr);
  const T u = S[IU * n + c] / rho0;
  const T v = S[IV * n + c] / rho0;
  const T w = S[IW * n + c] / rho0;
  const T bx = T(0.5) * (S[IA * n + c] + bx_r);
  const T by = T(0.5) * (S[IB * n + c] + S[IB * n + cyp]);
  const T bz = T(0.5) * (S[IC * n + c] + S[IC * n + czp]);

  const T rho = pmax(rho_raw, ph.smallr);
  T p;
  if (SHEAR && ph.iso) {
    p = rho * ph.ciso2;
  } else {
    const T eken = T(0.5) * (u * u + v * v + w * w);
    const T emag = T(0.5) * (bx * bx + by * by + bz * bz);
    const T eint = (S[IP * n + c] - emag) / rho - eken;
    p = pmax(ph.gm1 * rho * eint, rho * ph.smallp);
  }

  const T b2 = bx * bx + by * by + bz * bz;
  const T c2 = ph.gamma0 * p / rho;
  const T d2 = T(0.5) * (b2 / rho + c2);
  const T vy = SHEAR ? v + ph.vy_shift : v;
  return (fast_speed_cfl(d2, c2, bx, rho) + r_abs(u)) / ph.dx +
         (fast_speed_cfl(d2, c2, by, rho) + r_abs(vy)) / ph.dy +
         (fast_speed_cfl(d2, c2, bz, rho) + r_abs(w)) / ph.dz;
}

// the cell's inverse dt; the shearing-box mode reads the last column's +1
// x face from kept
template <typename T, bool SHEAR>
HD T inv_dt_at(const Phys<T>& ph, const Dims& d, const T* S, const T* kept, long long c) {
  int i, j, k;
  cell_ijk(d, c, i, j, k);
  T bx_r;
  if (SHEAR && i == d.nx - 1)
    bx_r = kept[(long long)k * d.ny + j];
  else
    bx_r = S[IA * d.n + cell_at(d, wrap_p(i, d.nx), j, k)];
  // stratified z faces: the top row's +1 z ghost continues its Bz
  // (solvers/stratified.py), so its +1 z face is its own
  const long long czp =
      SHEAR && ph.zstrat && k == d.nz - 1 ? c : cell_at(d, i, j, wrap_p(k, d.nz));
  return inv_dt_cell<T, SHEAR>(ph, S, d.n, c, bx_r, cell_at(d, i, wrap_p(j, d.ny), k), czp);
}

template <typename T, bool SHEAR>
struct MhdInvDt {
  Phys<T> ph;
  Dims d;
  const T* S;
  const T* kept;
  HD T operator()(long long c) const { return inv_dt_at<T, SHEAR>(ph, d, S, kept, c); }
};

template <typename T, bool SHEAR>
int cfl_mhd(const T* S, const T* kept, T* partial, T* out, int nx, int ny, int nz,
            const double* prm, void* stream) {
  const Dims d = make_dims(nx, ny, nz);
  return reduce_max(MhdInvDt<T, SHEAR>{make_phys<T>(prm), d, S, kept}, d.n, partial, out,
                    stream);
}

}  // namespace ramses

extern "C" {

int ramses_cfl_mhd_partials(void) { return ramses::MAX_BLOCKS; }

int ramses_cfl_mhd_f32(const float* S, float* partial, float* out, int nx, int ny,
                       int nz, const double* prm, void* stream) {
  return ramses::cfl_mhd<float, false>(S, nullptr, partial, out, nx, ny, nz, prm, stream);
}

int ramses_cfl_mhd_f64(const double* S, double* partial, double* out, int nx, int ny,
                       int nz, const double* prm, void* stream) {
  return ramses::cfl_mhd<double, false>(S, nullptr, partial, out, nx, ny, nz, prm, stream);
}

int ramses_cfl_mhd_shear_f32(const float* S, const float* kept, float* partial, float* out,
                             int nx, int ny, int nz, const double* prm, void* stream) {
  return ramses::cfl_mhd<float, true>(S, kept, partial, out, nx, ny, nz, prm, stream);
}

int ramses_cfl_mhd_shear_f64(const double* S, const double* kept, double* partial,
                             double* out, int nx, int ny, int nz, const double* prm,
                             void* stream) {
  return ramses::cfl_mhd<double, true>(S, kept, partial, out, nx, ny, nz, prm, stream);
}

}  // extern "C"

#ifdef RAMSES_COUNT_OPS
// the floating-point operations of one reduction over S (op_count.cuh)
extern "C" long long ramses_cfl_mhd_ops(const double* S, int nx, int ny, int nz,
                                        const double* prm) {
  using ramses::Counted;
  std::vector<Counted> s = ramses::counted_copy(S, 8LL * nx * ny * nz);
  Counted out;
  Counted::ops = 0;
  ramses::cfl_mhd<Counted, false>(s.data(), nullptr, nullptr, &out, nx, ny, nz, prm, nullptr);
  return Counted::ops;
}

// the same for the shearing-box mode, with the kept face kept[nz][ny]
extern "C" long long ramses_cfl_mhd_shear_ops(const double* S, const double* kept, int nx,
                                              int ny, int nz, const double* prm) {
  using ramses::Counted;
  std::vector<Counted> s = ramses::counted_copy(S, 8LL * nx * ny * nz);
  std::vector<Counted> kp = ramses::counted_copy(kept, (long long)ny * nz);
  Counted out;
  Counted::ops = 0;
  ramses::cfl_mhd<Counted, true>(s.data(), kp.data(), nullptr, &out, nx, ny, nz, prm, nullptr);
  return Counted::ops;
}
#endif
