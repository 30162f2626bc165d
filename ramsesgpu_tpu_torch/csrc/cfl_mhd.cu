// CFL reduction for 3D MHD: inv = max over cells of
//   sum_d (cf_d + |v_d|) / dx_d
// with cf_d the fast magnetosonic speed along d and the face-centred field
// averaged to cell centres (+1 face neighbour by periodic wrap).
//
// Replaces the TPU kernel ramsesgpu_tpu/pallas/packed_io.py:51
// make_packed_cfl_mhd (formula: solvers/timestep.py:114 _inv_dt_mhd_fields).
// Plain twin: ramsesgpu_tpu_torch/solvers/timestep.py inv_dt_mhd_periodic.
//
// Layout: the interior-only periodic state S[8][nz][ny][nx] (mhd_common.cuh).
//
// Design: pass 1 runs a fixed grid of at most CFL_MAX_BLOCKS blocks; each
// thread grid-strides over cells, each block tree-reduces in shared memory
// and writes one partial. Pass 2 (one block) reduces the partials into
// out[0]. The max is exact and the cell-to-thread map is fixed, so the
// result does not depend on scheduling. The max propagates NaN (pmax), as
// jnp.max and torch.max do: a blown-up state yields a NaN dt, which stops
// the loop, instead of a finite dt that an integer-bit atomicMax would give.
//
// Bound on the H100: it reads the 8 channels once (plus the +1 face
// neighbours, mostly from cache): 32 bytes/cell in f32, about 0.54 GB at
// 256^3, so ~0.2 ms at the 3.35 TB/s peak; ~60 flops/cell is far below the
// compute bound.
#include "mhd_common.cuh"

namespace ramses {

constexpr int CFL_THREADS = 256;
constexpr int CFL_MAX_BLOCKS = 1024;

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

#ifdef __CUDACC__
template <typename T>
__device__ T block_max(T v) {
  __shared__ T sdata[CFL_THREADS];
  sdata[threadIdx.x] = v;
  __syncthreads();
  for (int s = CFL_THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sdata[threadIdx.x] = pmax(sdata[threadIdx.x], sdata[threadIdx.x + s]);
    __syncthreads();
  }
  return sdata[0];
}

template <typename T>
__global__ void __launch_bounds__(CFL_THREADS)
cfl_partial_kernel(const T* S, T* partial, Dims d, Phys<T> ph) {
  T m = -T(INFINITY);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x; c < d.n; c += stride)
    m = pmax(m, inv_dt_at(ph, d, S, c));
  m = block_max(m);
  if (threadIdx.x == 0) partial[blockIdx.x] = m;
}

template <typename T>
__global__ void __launch_bounds__(CFL_THREADS)
cfl_final_kernel(const T* partial, int nblocks, T* out) {
  T m = -T(INFINITY);
  for (int b = threadIdx.x; b < nblocks; b += blockDim.x) m = pmax(m, partial[b]);
  m = block_max(m);
  if (threadIdx.x == 0) out[0] = m;
}
#endif

template <typename T>
int cfl_mhd(const T* S, T* partial, T* out, int nx, int ny, int nz,
            const double* prm, void* stream) {
  const Dims d = make_dims(nx, ny, nz);
  const Phys<T> ph = make_phys<T>(prm);
#ifdef __CUDACC__
  long long blocks = (d.n + CFL_THREADS - 1) / CFL_THREADS;
  if (blocks > CFL_MAX_BLOCKS) blocks = CFL_MAX_BLOCKS;
  cudaStream_t s = (cudaStream_t)stream;
  cfl_partial_kernel<T><<<(unsigned)blocks, CFL_THREADS, 0, s>>>(S, partial, d, ph);
  int err = (int)cudaGetLastError();
  if (err) return err;
  cfl_final_kernel<T><<<1, CFL_THREADS, 0, s>>>(partial, (int)blocks, out);
  return (int)cudaGetLastError();
#else
  (void)partial;
  (void)stream;
  T m = -T(INFINITY);
  for (long long c = 0; c < d.n; ++c) m = pmax(m, inv_dt_at(ph, d, S, c));
  out[0] = m;
  return 0;
#endif
}

}  // namespace ramses

extern "C" {

int ramses_cfl_mhd_partials(void) { return ramses::CFL_MAX_BLOCKS; }

int ramses_cfl_mhd_f32(const float* S, float* partial, float* out, int nx, int ny,
                       int nz, const double* prm, void* stream) {
  return ramses::cfl_mhd<float>(S, partial, out, nx, ny, nz, prm, stream);
}

int ramses_cfl_mhd_f64(const double* S, double* partial, double* out, int nx, int ny,
                       int nz, const double* prm, void* stream) {
  return ramses::cfl_mhd<double>(S, partial, out, nx, ny, nz, prm, stream);
}

}  // extern "C"
