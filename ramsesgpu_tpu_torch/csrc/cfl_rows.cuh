// The CFL reductions' walk over rows (cfl_mhd.cu, cfl_hydro.cu): the max
// over the interior's cells of a per-cell inverse dt, in one launch.
//
// Design: blocks walk whole x rows, a warp a row at a time: the row's
// offsets are formed once per row in 64 bits (F::row), the cells inside it
// by 32-bit indices. A lane holds F::Tile::U cells of a row in flight (x =
// x0 + lane + 32 u): their F::NV loads each (F::load) are issued before
// the arithmetic. With F::FACE (MHD) the +1 x face comes from the
// neighbouring lane (a shuffle), else from the row's own load (F::face).
// The grid is one wave (the blocks the card holds at once). Each block
// forms its max by warp shuffles and writes it to partial[block]; the last
// block to finish (a counter in device memory, which it sets back to 0)
// forms the final max from F::floor and the partials. The max is exact, so
// the result is the same whatever the order; it propagates NaN (pmax), as
// jnp.max and torch.max do: a blown-up state yields a NaN dt, which stops
// the loop. The host build walks the same rows serially.
#pragma once

#include "common.cuh"

namespace ramses {

constexpr int CFL_THREADS = 256;  // a block: 8 warps
constexpr int CFL_BLOCKS = 1024;  // at most (the partials)

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
  constexpr int CFL_U = F::Tile::U;
  const int lane = threadIdx.x % 32;
  const long long rows = (long long)f.in.ny * f.in.nz;
  const long long warps = (long long)gridDim.x * (CFL_THREADS / 32);
  const int nx = f.in.nx;
  T m = -T(INFINITY);
  for (long long r = blockIdx.x * (CFL_THREADS / 32) + threadIdx.x / 32; r < rows; r += warps) {
    const typename F::Row w = f.row(r);
    for (int x0 = 0; x0 < nx; x0 += 32 * CFL_U) {
      T v[CFL_U][F::NV];
#pragma unroll
      for (int u = 0; u < CFL_U; ++u) {
        const int x = x0 + lane + 32 * u;
        if (x < nx) f.load(w, x, v[u]);
      }
#pragma unroll
      for (int u = 0; u < CFL_U; ++u) {
        const int x = x0 + lane + 32 * u;
        T bx_r = T(0);
        if constexpr (F::FACE) {
          // the +1 x face: the next lane's Bx, lane 31's the next u's lane 0
          bx_r = __shfl_down_sync(0xffffffffu, v[u][IA], 1);
          if (u + 1 < CFL_U) {
            const T next = __shfl_sync(0xffffffffu, v[u + 1][IA], 0);
            if (lane == 31) bx_r = next;
          }
          if (x + 1 >= nx || (lane == 31 && u + 1 == CFL_U)) bx_r = f.face(w, x);
        }
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
template <typename T, typename F>
int cfl_rows(const F& f, T* partial, unsigned* count, T* out, void* stream) {
  const long long rows = (long long)f.in.ny * f.in.nz;
#ifdef __CUDACC__
  // one wave: the blocks the card holds at once (at most CFL_BLOCKS), or a
  // warp a row
  static const int resident = [] {
    int per_sm = 0, dev = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cfl_rows_kernel<T, F>, CFL_THREADS,
                                                  0);
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
  T m = f.floor, v[F::NV];
  for (long long r = 0; r < rows; ++r) {
    const auto w = f.row(r);
    for (int x = 0; x < f.in.nx; ++x) {
      f.load(w, x, v);
      if constexpr (F::FACE)
        m = pmax(m, f.inv(v, f.face(w, x)));
      else
        m = pmax(m, f.inv(v, T(0)));
    }
  }
  out[0] = m;
  return 0;
#endif
}

}  // namespace ramses
