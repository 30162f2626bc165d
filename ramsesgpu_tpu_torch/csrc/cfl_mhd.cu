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
// The ghosted mode reads a ghosted state U[8][nz+2g][ny+2g][nx+2g] as it
// stands (compute_dt runs before the fill, fused_mhd3d.py:541-542): the
// interior cells' +1 faces come from the ghost frame as given, like JAX
// compute_inv_dt_mhd and compute_inv_dt_mhd_ghosted (timestep.py:219-240),
// and the max starts from the inflow jet's (ujet + cjet) / dx
// (timestep.py:257-262; -inf without a jet). Plain twin:
// solvers/timestep.py inv_dt_mhd_ghosted. Its shearing-box form (the
// sharded shearing box's CFL on a rank's ghosted block as it stands, JAX
// parallel/sharded_step.py:551-556 compute_inv_dt_mhd(local_params, Ug))
// takes the isothermal pressure and the vy offset as the shear mode does,
// and no jet; plain twin: solvers/timestep.py inv_dt_mhd_ghosted_shear.
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
#include "cfl_mhd.cuh"

namespace ramses {

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

// the ghosted mode: interior cell c of U (offset g), +1 faces as they lie
template <typename T, bool SHEAR>
struct MhdInvDtGhosted {
  Phys<T> ph;
  Dims in, d;
  int g;
  const T* U;
  HD T operator()(long long c) const {
    int i, j, k;
    cell_ijk(in, c, i, j, k);
    const long long a = cell_at(d, i + g, j + g, k + g);
    return inv_dt_cell<T, SHEAR>(ph, U, d.n, a, U[IA * d.n + a + 1], a + d.nx,
                                 a + (long long)d.nx * d.ny);
  }
};

template <typename T, bool SHEAR = false>
int cfl_mhd_ghosted(const T* U, T* partial, T* out, int nx, int ny, int nz, int g,
                    double floor, const double* prm, void* stream) {
  const MhdInvDtGhosted<T, SHEAR> f{make_phys<T>(prm), make_dims(nx, ny, nz),
                             make_dims(nx + 2 * g, ny + 2 * g, nz + 2 * g), g, U};
  return reduce_max(f, f.in.n, partial, out, stream, T(floor));
}

}  // namespace ramses

extern "C" {

// the ghosted mode: U [8][nz+2g][ny+2g][nx+2g]; floor: the jet's inverse
// dt, or -inf
int ramses_cfl_mhd_ghosted_f32(const float* U, float* partial, float* out, int nx, int ny,
                               int nz, int g, double floor, const double* prm, void* stream) {
  return ramses::cfl_mhd_ghosted<float>(U, partial, out, nx, ny, nz, g, floor, prm, stream);
}

int ramses_cfl_mhd_ghosted_f64(const double* U, double* partial, double* out, int nx, int ny,
                               int nz, int g, double floor, const double* prm, void* stream) {
  return ramses::cfl_mhd_ghosted<double>(U, partial, out, nx, ny, nz, g, floor, prm, stream);
}

// the ghosted shearing-box form: U [8][nz+2g][ny+2g][nx+2g] as it stands
int ramses_cfl_mhd_ghosted_shear_f32(const float* U, float* partial, float* out, int nx, int ny,
                                     int nz, int g, const double* prm, void* stream) {
  return ramses::cfl_mhd_ghosted<float, true>(U, partial, out, nx, ny, nz, g, -INFINITY, prm,
                                              stream);
}

int ramses_cfl_mhd_ghosted_shear_f64(const double* U, double* partial, double* out, int nx,
                                     int ny, int nz, int g, const double* prm, void* stream) {
  return ramses::cfl_mhd_ghosted<double, true>(U, partial, out, nx, ny, nz, g, -INFINITY, prm,
                                               stream);
}

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

// the ghosted mode's operations on U [8][nz+2g][ny+2g][nx+2g]
extern "C" long long ramses_cfl_mhd_ghosted_ops(const double* U, int nx, int ny, int nz, int g,
                                                const double* prm) {
  using ramses::Counted;
  std::vector<Counted> u =
      ramses::counted_copy(U, 8LL * (nx + 2 * g) * (ny + 2 * g) * (nz + 2 * g));
  Counted out;
  Counted::ops = 0;
  ramses::cfl_mhd_ghosted<Counted>(u.data(), nullptr, &out, nx, ny, nz, g, -INFINITY, prm,
                                   nullptr);
  return Counted::ops;
}

// the ghosted shearing-box form's operations on U [8][nz+2g][ny+2g][nx+2g]
extern "C" long long ramses_cfl_mhd_ghosted_shear_ops(const double* U, int nx, int ny, int nz,
                                                      int g, const double* prm) {
  using ramses::Counted;
  std::vector<Counted> u =
      ramses::counted_copy(U, 8LL * (nx + 2 * g) * (ny + 2 * g) * (nz + 2 * g));
  Counted out;
  Counted::ops = 0;
  ramses::cfl_mhd_ghosted<Counted, true>(u.data(), nullptr, &out, nx, ny, nz, g, -INFINITY, prm,
                                         nullptr);
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
