// CFL reduction for 3D hydrodynamics: inv = max over interior cells of
//   (c + |u|)/dx + (c + |v|)/dy + (c + |w|)/dz
// with c the sound speed (the isothermal cIso when cIso > 0).
//
// Replaces the TPU kernel ramsesgpu_tpu/pallas/packed_bc.py:408
// make_packed_cfl_hydro (formula: solvers/timestep.py:33
// compute_inv_dt_hydro). Plain twin: ramsesgpu_tpu_torch/solvers/
// timestep.py compute_inv_dt_hydro.
//
// Layout: either of the port's hydro states, A[5][nz+2o][ny+2o][nx+2o]
// with the interior at offset o: o = 0 for the loops' interior-only state,
// o = 2 for the ghosted state of the step function. Only the interior is
// read.
//
// Design: the deterministic two-pass NaN-propagating block max of
// common.cuh (reduce_max). The per-cell chain keeps compute_inv_dt_hydro's
// op order and its products are never fused into FMAs (r_mul), so the
// result is bitwise the twin's on the same state.
//
// Bound on the H100: it reads 5 values per cell, 20 B/cell in f32 (0.34 GB
// at 256^3, 0.10 ms at 3.35 TB/s); ~25 flops per cell are far below the
// compute bound.
#include "cfl_hydro.cuh"

namespace ramses {

template <typename T>
struct HydroInvDt {
  Phys<T> ph;
  T c_iso;
  const T* A;
  int nx, ny, off;
  long long stride;  // values per channel of A

  HD T operator()(long long c) const {
    const int i = (int)(c % nx);
    const long long r = c / nx;
    const int j = (int)(r % ny);
    const int k = (int)(r / ny);
    const long long a =
        ((long long)(k + off) * (ny + 2 * off) + (j + off)) * (nx + 2 * off) + (i + off);
    return hydro_inv_dt_cell(ph, c_iso, A + a, stride);
  }
};

template <typename T>
int cfl_hydro(const T* A, T* partial, T* out, int nx, int ny, int nz, int off,
              const double* prm, void* stream) {
  HydroInvDt<T> f;
  f.ph = make_phys<T>(prm);
  f.c_iso = T(prm[P_CISO]);
  f.A = A;
  f.nx = nx;
  f.ny = ny;
  f.off = off;
  f.stride = (long long)(nx + 2 * off) * (ny + 2 * off) * (nz + 2 * off);
  return reduce_max(f, (long long)nx * ny * nz, partial, out, stream);
}

}  // namespace ramses

extern "C" {

int ramses_cfl_hydro_partials(void) { return ramses::MAX_BLOCKS; }

int ramses_cfl_hydro_f32(const float* A, float* partial, float* out, int nx, int ny, int nz,
                         int off, const double* prm, void* stream) {
  return ramses::cfl_hydro<float>(A, partial, out, nx, ny, nz, off, prm, stream);
}

int ramses_cfl_hydro_f64(const double* A, double* partial, double* out, int nx, int ny, int nz,
                         int off, const double* prm, void* stream) {
  return ramses::cfl_hydro<double>(A, partial, out, nx, ny, nz, off, prm, stream);
}

}  // extern "C"

#ifdef RAMSES_COUNT_OPS
// the floating-point operations of one reduction over A (op_count.cuh)
extern "C" long long ramses_cfl_hydro_ops(const double* A, int nx, int ny, int nz, int off,
                                          const double* prm) {
  using ramses::Counted;
  std::vector<Counted> a = ramses::counted_copy(
      A, 5LL * (nx + 2 * off) * (ny + 2 * off) * (nz + 2 * off));
  Counted out;
  Counted::ops = 0;
  ramses::cfl_hydro<Counted>(a.data(), nullptr, &out, nx, ny, nz, off, prm, nullptr);
  return Counted::ops;
}
#endif
