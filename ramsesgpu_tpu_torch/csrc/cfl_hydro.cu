// CFL reduction for 3D hydrodynamics: inv = max over interior cells of
//   (c + |u|)/dx + (c + |v|)/dy + (c + |w|)/dz
// with c the sound speed (the isothermal cIso when cIso > 0), and at least
// `floor` (the inflow jet's (ujet + cjet) / dx, timestep.py:257-262; -inf
// without a jet).
//
// Replaces the TPU kernel ramsesgpu_tpu/pallas/packed_bc.py:408
// make_packed_cfl_hydro (formula: solvers/timestep.py:33
// compute_inv_dt_hydro). Plain twin: ramsesgpu_tpu_torch/solvers/
// timestep.py compute_inv_dt_hydro, then with_jet.
//
// Layout: either of the port's hydro states, A[5][nz+2o][ny+2o][nx+2o]
// with the interior at offset o: o = 0 for the loops' interior-only state,
// o = 2 for the ghosted state of the step function and the jet. Only the
// interior is read.
//
// Design: the one-launch row walk of cfl_rows.cuh (one wave of blocks,
// warps on whole x rows, the row's offset formed once in 64 bits, a lane's
// U cells with their five loads each in flight, the block's max by warp
// shuffles, the last block reducing the partials from the floor). The
// quotients by the cell sizes are products by the exact reciprocal where
// the size is a power of two (common.cuh Div, bitwise); the divisions by
// rho and the square root stay. The per-cell chain is cfl_hydro.cuh
// hydro_inv_dt_cell in compute_inv_dt_hydro's op order, and the file is
// compiled without FMA contraction (kernels/build.py), so the result is
// bitwise the twin's on the same state.
//
// Bound on the H100: it reads 5 values per cell, 20 B/cell in f32 (0.34 GB
// at 256^3, 0.10 ms at 3.35 TB/s); ~25 flops per cell are far below the
// compute bound of f32. In f64 the divisions and the square root (done in
// software sequences) come close to it.
#include "cfl_hydro.cuh"
#include "cfl_rows.cuh"

namespace ramses {

// the cells of a row a lane has in flight, per dtype (H100 at 700 W,
// 256^3, scripts/torch_ab.py parent, each pair in one process: f32 U = 2
// 0.163 ms against 0.201 for U = 4, U = 8 0.190 against U = 4's 0.187; f64
// U = 1 0.287 against U = 2's 0.289, U = 4 0.353 against U = 2's 0.388)
template <typename T>
struct HydroTile;
template <>
struct HydroTile<float> {
  static constexpr int U = 2;
};
template <>
struct HydroTile<double> {
  static constexpr int U = 1;
};

// the rows of A's interior: row (j, k) starts at ((k + o) sy + j + o) sx + o
template <typename T>
struct HydroRows {
  using Tile = HydroTile<T>;
  static constexpr int NV = 5;         // values a cell loads
  static constexpr bool FACE = false;  // no neighbour
  Phys<T> ph;
  T c_iso;
  Div<T> d[3];  // / dx, dy, dz
  const T* A;
  Dims in;      // the interior's extent
  long long n;  // values per channel of A
  int off;      // the interior's offset
  int sx, sy;   // A's row length and rows per plane
  T floor;      // the max starts here

  struct Row {
    long long c;  // the offset of the row's cell 0
  };
  HD Row row(long long r) const {
    const int j = (int)(r % in.ny), k = (int)(r / in.ny);
    return Row{((long long)(k + off) * sy + j + off) * sx + off};
  }
  HD void load(const Row& w, int x, T* v) const {
    const T* a = A + w.c + x;
#pragma unroll
    for (int ch = 0; ch < NV; ++ch) v[ch] = a[ch * n];
  }
  HD T inv(const T* v, T) const { return hydro_inv_dt_cell(ph, c_iso, v, 1, d[0], d[1], d[2]); }
};

template <typename T>
int cfl_hydro(const T* A, T* partial, unsigned* count, T* out, int nx, int ny, int nz, int off,
              double floor, const double* prm, void* stream) {
  HydroRows<T> f;
  f.ph = make_phys<T>(prm);
  f.c_iso = T(prm[P_CISO]);
  for (int a = 0; a < 3; ++a) f.d[a] = make_div<T>(prm[P_DX + a]);
  f.A = A;
  f.in = make_dims(nx, ny, nz);
  f.off = off;
  f.sx = nx + 2 * off;
  f.sy = ny + 2 * off;
  f.n = (long long)f.sx * f.sy * (nz + 2 * off);
  f.floor = T(floor);
  return cfl_rows(f, partial, count, out, stream);
}

}  // namespace ramses

extern "C" {

// A [5][nz+2 off][ny+2 off][nx+2 off]; partial and count: cfl_rows.cuh's
// (ramses_cfl_rows_partials); floor: the jet's inverse dt,
// or -inf
int ramses_cfl_hydro_f32(const float* A, float* partial, unsigned* count, float* out, int nx,
                         int ny, int nz, int off, double floor, const double* prm,
                         void* stream) {
  return ramses::cfl_hydro<float>(A, partial, count, out, nx, ny, nz, off, floor, prm, stream);
}

int ramses_cfl_hydro_f64(const double* A, double* partial, unsigned* count, double* out,
                         int nx, int ny, int nz, int off, double floor, const double* prm,
                         void* stream) {
  return ramses::cfl_hydro<double>(A, partial, count, out, nx, ny, nz, off, floor, prm, stream);
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
  ramses::cfl_hydro<Counted>(a.data(), nullptr, nullptr, &out, nx, ny, nz, off, -INFINITY, prm,
                             nullptr);
  return Counted::ops;
}
#endif
