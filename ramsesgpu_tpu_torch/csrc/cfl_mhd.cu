// CFL reduction for 3D MHD: inv = max over cells of
//   sum_d (cf_d + |v_d|) / dx_d
// with cf_d the fast magnetosonic speed along d and the face-centred field
// averaged to cell centres (+1 face neighbour by periodic wrap).
//
// Replaces the TPU kernel ramsesgpu_tpu/pallas/packed_io.py:51
// make_packed_cfl_mhd (formula: solvers/timestep.py:114 _inv_dt_mhd_fields).
// Plain twin: ramsesgpu_tpu_torch/solvers/timestep.py inv_dt_mhd_periodic.
//
// Layout: the interior-only periodic state S[8][nz][ny][nx] (common.cuh).
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

// timestep.py _inv_dt_mhd_fields on one cell c (+1 neighbours cxp/cyp/czp)
template <typename T>
HD T inv_dt_cell(const Phys<T>& ph, const T* S, long long n, long long c,
                 long long cxp, long long cyp, long long czp) {
  const T rho_raw = S[ID * n + c];
  const T rho0 = pmax(rho_raw, ph.smallr);
  const T u = S[IU * n + c] / rho0;
  const T v = S[IV * n + c] / rho0;
  const T w = S[IW * n + c] / rho0;
  const T bx = T(0.5) * (S[IA * n + c] + S[IA * n + cxp]);
  const T by = T(0.5) * (S[IB * n + c] + S[IB * n + cyp]);
  const T bz = T(0.5) * (S[IC * n + c] + S[IC * n + czp]);

  const T rho = pmax(rho_raw, ph.smallr);
  const T eken = T(0.5) * (u * u + v * v + w * w);
  const T emag = T(0.5) * (bx * bx + by * by + bz * bz);
  const T eint = (S[IP * n + c] - emag) / rho - eken;
  const T p = pmax(ph.gm1 * rho * eint, rho * ph.smallp);

  const T b2 = bx * bx + by * by + bz * bz;
  const T c2 = ph.gamma0 * p / rho;
  const T d2 = T(0.5) * (b2 / rho + c2);
  return (fast_speed_cfl(d2, c2, bx, rho) + r_abs(u)) / ph.dx +
         (fast_speed_cfl(d2, c2, by, rho) + r_abs(v)) / ph.dy +
         (fast_speed_cfl(d2, c2, bz, rho) + r_abs(w)) / ph.dz;
}

template <typename T>
HD T inv_dt_at(const Phys<T>& ph, const Dims& d, const T* S, long long c) {
  int i, j, k;
  cell_ijk(d, c, i, j, k);
  return inv_dt_cell(ph, S, d.n, c, cell_at(d, wrap_p(i, d.nx), j, k),
                     cell_at(d, i, wrap_p(j, d.ny), k),
                     cell_at(d, i, j, wrap_p(k, d.nz)));
}

template <typename T>
struct MhdInvDt {
  Phys<T> ph;
  Dims d;
  const T* S;
  HD T operator()(long long c) const { return inv_dt_at(ph, d, S, c); }
};

template <typename T>
int cfl_mhd(const T* S, T* partial, T* out, int nx, int ny, int nz,
            const double* prm, void* stream) {
  const Dims d = make_dims(nx, ny, nz);
  return reduce_max(MhdInvDt<T>{make_phys<T>(prm), d, S}, d.n, partial, out, stream);
}

}  // namespace ramses

extern "C" {

int ramses_cfl_mhd_partials(void) { return ramses::MAX_BLOCKS; }

int ramses_cfl_mhd_f32(const float* S, float* partial, float* out, int nx, int ny,
                       int nz, const double* prm, void* stream) {
  return ramses::cfl_mhd<float>(S, partial, out, nx, ny, nz, prm, stream);
}

int ramses_cfl_mhd_f64(const double* S, double* partial, double* out, int nx, int ny,
                       int nz, const double* prm, void* stream) {
  return ramses::cfl_mhd<double>(S, partial, out, nx, ny, nz, prm, stream);
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
  ramses::cfl_mhd<Counted>(s.data(), nullptr, &out, nx, ny, nz, prm, nullptr);
  return Counted::ops;
}
#endif
