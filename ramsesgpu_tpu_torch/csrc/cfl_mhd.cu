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
// Design: one launch. Blocks walk whole x rows, a warp a row at a time:
// the row's offsets (its own, its +1 y and +1 z neighbours', the source of
// its last +1 x face) are formed once per row in 64 bits, the cells inside
// it by 32-bit indices. A lane holds U cells of a row in flight (x = x0 +
// lane + 32 u; U per dtype, CflTile): their ten loads each (the eight
// channels, By at +1 y, Bz at +1 z) are issued before the arithmetic, and
// the +1 x face comes from the neighbouring lane (a shuffle), else from the
// row's own load. The grid is one wave (the blocks the card holds at
// once). Each block forms its max by warp shuffles and writes it to
// partial[block]; the last
// block to finish (a counter in device memory, which it sets back to 0)
// forms the final max from `floor` and the partials. The max is exact, so
// the result is the same whatever the order; it propagates NaN (pmax), as
// jnp.max and torch.max do: a blown-up state yields a NaN dt, which stops
// the loop. The per-cell arithmetic is cfl_mhd.cuh inv_dt_cell, the one
// the z-streaming step's folded CFL calls too. The host build walks the
// same rows serially.
//
// Bound on the H100: it reads the 8 channels once (plus the +1 face
// neighbours, mostly from cache): 32 bytes/cell in f32, about 0.54 GB at
// 256^3, so ~0.16 ms at the 3.35 TB/s peak; its 69 counted flops per
// cell (op_count.cuh) are far below the compute bound.
#include "cfl_mhd.cuh"

namespace ramses {

constexpr int CFL_THREADS = 256;  // a block: 8 warps
constexpr int CFL_BLOCKS = 1024;  // at most (the partials)

// the cells of a row a lane has in flight, per dtype (H100 at 700 W,
// periodic 256^3, scripts/torch_ab.py kernels: f32 U = 2 0.270 ms against
// 0.291 for U = 1 and 0.343 for U = 4; f64 U = 1 0.552 against 0.706 for
// U = 2)
template <typename T>
struct CflTile;
template <>
struct CflTile<float> {
  static constexpr int U = 2;
};
template <>
struct CflTile<double> {
  static constexpr int U = 1;
};

// One mode's rows: the state's pointer and channel stride, the interior's
// extent, and where row (j, k)'s cells, its +1 y and +1 z neighbours and
// its last cell's +1 x face lie.
template <typename T, bool SHEAR, bool GHOSTED>
struct Rows {
  Phys<T> ph;
  const T* S;
  const T* kept;   // shear: the kept face [nz][ny]
  Dims in;         // the interior's extent
  long long n;     // values per channel of S
  int g;           // ghosted: the ghost width of S
  int sx, sy;      // S's row length and rows per plane
  T floor;         // the max starts here (the jet's inverse dt, or -inf)

  struct Row {
    long long c, cy, cz;  // the offsets of cell 0 of the row and of its +1 y, +1 z rows
    const T* last;        // the +1 x face of the row's last cell
  };
  HD Row row(long long r) const {
    const int j = (int)(r % in.ny), k = (int)(r / in.ny);
    Row w;
    if constexpr (GHOSTED) {
      w.c = ((long long)(k + g) * sy + j + g) * sx + g;
      w.cy = w.c + sx;
      w.cz = w.c + (long long)sx * sy;
      w.last = S + IA * n + w.c + in.nx;
    } else {
      w.c = ((long long)k * in.ny + j) * in.nx;
      w.cy = ((long long)k * in.ny + wrap_p(j, in.ny)) * in.nx;
      // stratified z faces: the top row's +1 z ghost continues its Bz
      // (solvers/stratified.py), so its +1 z face is its own
      w.cz = SHEAR && ph.zstrat && k == in.nz - 1
                 ? w.c
                 : ((long long)wrap_p(k, in.nz) * in.ny + j) * in.nx;
      w.last = SHEAR ? kept + (long long)k * in.ny + j : S + IA * n + w.c;
    }
    return w;
  }
  // the ten values inv_dt_cell reads of cell x of row w, as a local state
  // of one cell: the channels 0-7, By at +1 y (v[8]) and Bz at +1 z (v[9])
  HD void load(const Row& w, int x, T* v) const {
    const T* s = S + w.c + x;
#pragma unroll
    for (int ch = 0; ch < 8; ++ch) v[ch] = s[ch * n];
    v[8] = S[IB * n + w.cy + x];
    v[9] = S[IC * n + w.cz + x];
  }
  // the +1 x face of cell x from the row's own load
  HD T face(const Row& w, int x) const {
    return x + 1 < in.nx ? S[IA * n + w.c + x + 1] : *w.last;
  }
  HD T inv(const T* v, T bx_r) const { return inv_dt_cell<T, SHEAR>(ph, v, 1, 0, bx_r, 2, 2); }
};

#ifdef __CUDACC__
template <typename T>
__device__ T warp_max(T v) {
  for (int o = 16; o > 0; o >>= 1) v = pmax(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

// the block's max of v into thread 0's return value
template <typename T>
__device__ T cfl_block_max(T v) {
  __shared__ T warp_m[CFL_THREADS / 32];
  v = warp_max(v);
  if (threadIdx.x % 32 == 0) warp_m[threadIdx.x / 32] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    v = threadIdx.x < CFL_THREADS / 32 ? warp_m[threadIdx.x] : -T(INFINITY);
    v = warp_max(v);
  }
  return v;
}

template <typename T, typename F>
__global__ void __launch_bounds__(CFL_THREADS) cfl_rows_kernel(F f, T* partial,
                                                               unsigned* count, T* out) {
  constexpr int CFL_U = CflTile<T>::U;
  const int lane = threadIdx.x % 32;
  const long long rows = (long long)f.in.ny * f.in.nz;
  const long long warps = (long long)gridDim.x * (CFL_THREADS / 32);
  const int nx = f.in.nx;
  T m = -T(INFINITY);
  for (long long r = blockIdx.x * (CFL_THREADS / 32) + threadIdx.x / 32; r < rows; r += warps) {
    const typename F::Row w = f.row(r);
    for (int x0 = 0; x0 < nx; x0 += 32 * CFL_U) {
      T v[CFL_U][10];
#pragma unroll
      for (int u = 0; u < CFL_U; ++u) {
        const int x = x0 + lane + 32 * u;
        if (x < nx) f.load(w, x, v[u]);
      }
#pragma unroll
      for (int u = 0; u < CFL_U; ++u) {
        const int x = x0 + lane + 32 * u;
        // the +1 x face: the next lane's Bx, lane 31's the next u's lane 0
        T bx_r = __shfl_down_sync(0xffffffffu, v[u][IA], 1);
        if (u + 1 < CFL_U) {
          const T next = __shfl_sync(0xffffffffu, v[u + 1][IA], 0);
          if (lane == 31) bx_r = next;
        }
        if (x + 1 >= nx || (lane == 31 && u + 1 == CFL_U)) bx_r = f.face(w, x);
        if (x < nx) m = pmax(m, f.inv(v[u], bx_r));
      }
    }
  }
  m = cfl_block_max(m);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = m;
    __threadfence();
    last = atomicAdd(count, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block: the max of the partials, from the floor
  __threadfence();
  T v = -T(INFINITY);
  for (int b = threadIdx.x; b < (int)gridDim.x; b += CFL_THREADS)
    v = pmax(v, static_cast<volatile T*>(partial)[b]);
  v = cfl_block_max(v);
  if (threadIdx.x == 0) {
    *out = pmax(f.floor, v);
    *count = 0;
  }
}
#endif

// max over the interior's cells of the inverse dt into out[0]; partial
// holds CFL_BLOCKS values and count one counter that is 0 before the
// launch (the kernel sets it back to 0); both unused in the host build
template <typename T, bool SHEAR, bool GHOSTED>
int cfl_rows(const Rows<T, SHEAR, GHOSTED>& f, T* partial, unsigned* count, T* out,
             void* stream) {
  const long long rows = (long long)f.in.ny * f.in.nz;
#ifdef __CUDACC__
  // one wave: the blocks the card holds at once (at most CFL_BLOCKS), or a
  // warp a row
  static const int resident = [] {
    int per_sm = 0, dev = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, cfl_rows_kernel<T, Rows<T, SHEAR, GHOSTED>>, CFL_THREADS, 0);
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return per_sm * sms;
  }();
  if (resident <= 0) return (int)cudaErrorInvalidConfiguration;
  long long blocks = (rows + CFL_THREADS / 32 - 1) / (CFL_THREADS / 32);
  if (blocks > resident) blocks = resident;
  if (blocks > CFL_BLOCKS) blocks = CFL_BLOCKS;
  cfl_rows_kernel<T><<<(unsigned)blocks, CFL_THREADS, 0, (cudaStream_t)stream>>>(f, partial,
                                                                                count, out);
  return (int)cudaGetLastError();
#else
  (void)partial;
  (void)count;
  (void)stream;
  T m = f.floor, v[10];
  for (long long r = 0; r < rows; ++r) {
    const auto w = f.row(r);
    for (int x = 0; x < f.in.nx; ++x) {
      f.load(w, x, v);
      m = pmax(m, f.inv(v, f.face(w, x)));
    }
  }
  out[0] = m;
  return 0;
#endif
}

// the interior-only modes: S [8][nz][ny][nx] (periodic), with the kept face
// (shear)
template <typename T, bool SHEAR>
int cfl_mhd(const T* S, const T* kept, T* partial, unsigned* count, T* out, int nx, int ny,
            int nz, const double* prm, void* stream) {
  Rows<T, SHEAR, false> f;
  f.ph = make_phys<T>(prm);
  f.S = S;
  f.kept = kept;
  f.in = make_dims(nx, ny, nz);
  f.n = f.in.n;
  f.g = 0;
  f.sx = nx;
  f.sy = ny;
  f.floor = -T(INFINITY);
  return cfl_rows(f, partial, count, out, stream);
}

// the ghosted mode: the interior of U [8][nz+2g][ny+2g][nx+2g], +1 faces as
// they lie
template <typename T, bool SHEAR = false>
int cfl_mhd_ghosted(const T* U, T* partial, unsigned* count, T* out, int nx, int ny, int nz,
                    int g, double floor, const double* prm, void* stream) {
  Rows<T, SHEAR, true> f;
  f.ph = make_phys<T>(prm);
  f.S = U;
  f.kept = nullptr;
  f.in = make_dims(nx, ny, nz);
  f.n = (long long)(nx + 2 * g) * (ny + 2 * g) * (nz + 2 * g);
  f.g = g;
  f.sx = nx + 2 * g;
  f.sy = ny + 2 * g;
  f.floor = T(floor);
  return cfl_rows(f, partial, count, out, stream);
}

}  // namespace ramses

extern "C" {

// the ghosted mode: U [8][nz+2g][ny+2g][nx+2g]; floor: the jet's inverse
// dt, or -inf
int ramses_cfl_mhd_ghosted_f32(const float* U, float* partial, unsigned* count, float* out,
                               int nx, int ny, int nz, int g, double floor, const double* prm,
                               void* stream) {
  return ramses::cfl_mhd_ghosted<float>(U, partial, count, out, nx, ny, nz, g, floor, prm,
                                        stream);
}

int ramses_cfl_mhd_ghosted_f64(const double* U, double* partial, unsigned* count, double* out,
                               int nx, int ny, int nz, int g, double floor, const double* prm,
                               void* stream) {
  return ramses::cfl_mhd_ghosted<double>(U, partial, count, out, nx, ny, nz, g, floor, prm,
                                         stream);
}

// the ghosted shearing-box form: U [8][nz+2g][ny+2g][nx+2g] as it stands
int ramses_cfl_mhd_ghosted_shear_f32(const float* U, float* partial, unsigned* count,
                                     float* out, int nx, int ny, int nz, int g,
                                     const double* prm, void* stream) {
  return ramses::cfl_mhd_ghosted<float, true>(U, partial, count, out, nx, ny, nz, g, -INFINITY,
                                              prm, stream);
}

int ramses_cfl_mhd_ghosted_shear_f64(const double* U, double* partial, unsigned* count,
                                     double* out, int nx, int ny, int nz, int g,
                                     const double* prm, void* stream) {
  return ramses::cfl_mhd_ghosted<double, true>(U, partial, count, out, nx, ny, nz, g,
                                               -INFINITY, prm, stream);
}

// the values `partial` holds
int ramses_cfl_mhd_partials(void) { return ramses::CFL_BLOCKS; }

int ramses_cfl_mhd_f32(const float* S, float* partial, unsigned* count, float* out, int nx,
                       int ny, int nz, const double* prm, void* stream) {
  return ramses::cfl_mhd<float, false>(S, nullptr, partial, count, out, nx, ny, nz, prm, stream);
}

int ramses_cfl_mhd_f64(const double* S, double* partial, unsigned* count, double* out, int nx,
                       int ny, int nz, const double* prm, void* stream) {
  return ramses::cfl_mhd<double, false>(S, nullptr, partial, count, out, nx, ny, nz, prm,
                                        stream);
}

int ramses_cfl_mhd_shear_f32(const float* S, const float* kept, float* partial, unsigned* count,
                             float* out, int nx, int ny, int nz, const double* prm,
                             void* stream) {
  return ramses::cfl_mhd<float, true>(S, kept, partial, count, out, nx, ny, nz, prm, stream);
}

int ramses_cfl_mhd_shear_f64(const double* S, const double* kept, double* partial,
                             unsigned* count, double* out, int nx, int ny, int nz,
                             const double* prm, void* stream) {
  return ramses::cfl_mhd<double, true>(S, kept, partial, count, out, nx, ny, nz, prm, stream);
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
  ramses::cfl_mhd<Counted, false>(s.data(), nullptr, nullptr, nullptr, &out, nx, ny, nz, prm,
                                  nullptr);
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
  ramses::cfl_mhd_ghosted<Counted>(u.data(), nullptr, nullptr, &out, nx, ny, nz, g, -INFINITY,
                                   prm, nullptr);
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
  ramses::cfl_mhd_ghosted<Counted, true>(u.data(), nullptr, nullptr, &out, nx, ny, nz, g,
                                         -INFINITY, prm, nullptr);
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
  ramses::cfl_mhd<Counted, true>(s.data(), kp.data(), nullptr, nullptr, &out, nx, ny, nz, prm,
                                 nullptr);
  return Counted::ops;
}
#endif
