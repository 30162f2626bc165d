// Shared pieces of the port's CUDA kernels (cfl_mhd.cu, mhd_step.cu,
// cfl_hydro.cu, hydro_step.cu, shear_border.cu, dissip_step.cu,
// zcarry_mhd.cu, zcarry_hydro.cu).
//
// Layout: a state is channel-major, x fastest: S[nvar][nz][ny][nx] for the
// loops' interior-only state, the same with a ghost frame for the ghosted
// state.
//
// Every per-cell function is host+device (HD). Built with nvcc the stages
// launch as CUDA kernels on the caller's stream; built as plain C++ (the
// same files, `g++ -x c++`) each stage is a serial loop over the cells —
// that host build exists so the CPU test suite can check the arithmetic of
// these sources against the PyTorch twins where no CUDA compiler exists.
#pragma once

#include <cmath>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __host__ __device__ __forceinline__
#else
#include <vector>
#define HD inline
#endif

#ifdef RAMSES_COUNT_OPS
#include "op_count.cuh"
#endif
#if defined(RAMSES_ZCARRY_CLOCKS) && defined(__CUDACC__)
#include <cstdio>
#endif

namespace ramses {

// Physical parameters. The Python side passes them as doubles in the
// order of the P_* indices (kernels/build.py param_block); derived
// constants are formed in double and rounded once to T, as the JAX
// reference rounds its Python floats. The shearing-box entries: omega0,
// xmin, and the shift constants of the sheared fill (1.5 omega0 Lx with
// Lx = dx nx, and Ly = dy ny) and of the remap (1.5 omega0 (xmax - xmin),
// ymax - ymin), each formed in double as the JAX package forms them. Then
// the kinematic viscosity nu and the resistivity eta. Then the stratified
// z faces (BC_Z_STRATIFIED): a flag, and the density factors of the g = 3
// ghost rows below the interior (z = -1, -2, -3) and above it (z = nz,
// nz + 1, nz + 2), each the running product of the hydrostatic ratios in
// double (solvers/stratified.py), rounded once to T. Then the uniform
// static gravity (gx, gy, gz). Then the MHD corner solver (P_SOLVER is
// the face solver, a RiemannSolver value; P_MAGSOLVER a
// MagneticRiemannSolver value).
enum {
  P_GAMMA0, P_SMALLR, P_SMALLP, P_SMALLC, P_SLOPE, P_DX, P_DY, P_DZ,
  P_NITER, P_SMALLPP, P_GAMMA6, P_CISO, P_SOLVER,
  P_OMEGA0, P_XMIN, P_FILL_K, P_FILL_LY, P_REMAP_K, P_REMAP_LY, P_NU, P_ETA,
  P_ZSTRAT, P_ZLO0, P_ZLO1, P_ZLO2, P_ZHI0, P_ZHI1, P_ZHI2, P_GX, P_GY, P_GZ, P_MAGSOLVER,
  P_COUNT
};

// the MHD solvers (core/constants.py RiemannSolver, MagneticRiemannSolver)
enum { MHD_HLL = 1, MHD_HLLD = 3, MHD_LLF = 4 };
enum { MAG_HLLD = 0, MAG_HLLF = 1, MAG_HLLA = 2, MAG_LLF = 4 };

// whether the block asks for another MHD solver pair than HLLD faces with
// 2D-HLLD corners: the MHD step kernels' general instances
inline bool general_solvers(const double* p) {
  return (int)p[P_SOLVER] != MHD_HLLD || (int)p[P_MAGSOLVER] != MAG_HLLD;
}

// whether the block carries a uniform static gravity (P_GX .. P_GZ, the
// [gravity] static_field_*): the step kernels' gravity instances
inline bool has_gravity(const double* p) {
  return p[P_GX] != 0.0 || p[P_GY] != 0.0 || p[P_GZ] != 0.0;
}

template <typename T>
struct Phys {
  T gamma0, gm1, entho, smallr, smallp, smallc, slope, dx, dy, dz;
  // isothermal EOS (cIso > 0): p = rho * ciso2 in the solvers
  bool iso;
  T ciso, ciso2;
  // rotating frame: -1.5 omega0, 1.5 omega0, 2 omega0, -0.5 omega0, the x
  // of the first cell centre (xmin + dx/2), dx/2, and the CFL's vy offset
  // 1.5 omega0 dx / 2
  T shear_k, rot15, cor2, corm05, xpos0, dx_half, vy_shift;
  // stratified z faces: the CFL's +1 z face of the top row is its own
  bool zstrat;
  // the uniform static gravity (the gravity instances read it)
  T grav[3];
  // the MHD face and corner solvers (the general instances branch on them)
  int solver, mag_solver;
};

template <typename T>
inline Phys<T> make_phys(const double* p) {
  Phys<T> ph;
  ph.gamma0 = T(p[P_GAMMA0]);
  ph.gm1 = T(p[P_GAMMA0] - 1.0);
  ph.entho = T(1.0 / (p[P_GAMMA0] - 1.0));
  ph.smallr = T(p[P_SMALLR]);
  ph.smallp = T(p[P_SMALLP]);
  ph.smallc = T(p[P_SMALLC]);
  ph.slope = T(p[P_SLOPE]);
  ph.dx = T(p[P_DX]);
  ph.dy = T(p[P_DY]);
  ph.dz = T(p[P_DZ]);
  ph.iso = p[P_CISO] > 0.0;
  ph.ciso = T(p[P_CISO]);
  ph.ciso2 = T(p[P_CISO] * p[P_CISO]);
  const double om = p[P_OMEGA0];
  ph.shear_k = T(-1.5 * om);
  ph.rot15 = T(1.5 * om);
  ph.cor2 = T(2.0 * om);
  ph.corm05 = T(-0.5 * om);
  ph.xpos0 = T(p[P_XMIN] + p[P_DX] / 2);
  ph.dx_half = T(p[P_DX] / 2);
  ph.vy_shift = T(1.5 * om * p[P_DX] / 2.0);
  ph.zstrat = p[P_ZSTRAT] != 0.0;
  for (int a = 0; a < 3; ++a) ph.grav[a] = T(p[P_GX + a]);
  ph.solver = (int)p[P_SOLVER];
  ph.mag_solver = (int)p[P_MAGSOLVER];
  return ph;
}

// conserved / primitive channel slots (core/constants.py)
enum { ID = 0, IP = 1, IU = 2, IV = 3, IW = 4, IA = 5, IB = 6, IC = 7 };

HD float r_sqrt(float x) { return sqrtf(x); }
HD double r_sqrt(double x) { return sqrt(x); }
HD float r_abs(float x) { return fabsf(x); }
HD double r_abs(double x) { return fabs(x); }
HD float r_rsqrt(float x) {
#ifdef __CUDA_ARCH__
  return rsqrtf(x);
#else
  return 1.0f / sqrtf(x);
#endif
}
HD double r_rsqrt(double x) {
#ifdef __CUDA_ARCH__
  return rsqrt(x);
#else
  return 1.0 / sqrt(x);
#endif
}
// a product the compiler may not fuse into an FMA (bitwise-reproducible
// reductions)
HD float r_mul(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}
HD double r_mul(double a, double b) {
#ifdef __CUDA_ARCH__
  return __dmul_rn(a, b);
#else
  return a * b;
#endif
}

// a sum and a difference the compiler may not fuse with a product (the
// Kahan-compensated updates repeat their twins' roundings)
HD float r_add(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}
HD double r_add(double a, double b) {
#ifdef __CUDA_ARCH__
  return __dadd_rn(a, b);
#else
  return a + b;
#endif
}
HD float r_sub(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fsub_rn(a, b);
#else
  return a - b;
#endif
}
HD double r_sub(double a, double b) {
#ifdef __CUDA_ARCH__
  return __dsub_rn(a, b);
#else
  return a - b;
#endif
}

// Kahan-compensated u += d with the running carry c (godunov_mhd.py
// mhd_apply_update comp): y = d - c; u' = u + y; c' = (u' - u) - y, each
// rounded on its own
template <typename T>
HD void kahan_add(T& u, T& c, T d) {
  const T y = r_sub(d, c);
  const T un = r_add(u, y);
  c = r_sub(r_sub(un, u), y);
  u = un;
}

HD float r_fmod(float a, float b) { return fmodf(a, b); }
HD double r_fmod(double a, double b) { return fmod(a, b); }
HD float r_floor(float a) { return floorf(a); }
HD double r_floor(double a) { return floor(a); }
HD int to_int(float a) { return (int)a; }
HD int to_int(double a) { return (int)a; }
// a mod n in [0, n) for any int a
HD int mod_n(int a, int n) { return ((a % n) + n) % n; }
// a mod n for any int a: one compare when a is within one period of
// [0, n), as a neighbour of an interior cell is on an axis of n >= 3 cells
HD int wrap_any(int a, int n) {
  if (a < 0) return a + n >= 0 ? a + n : mod_n(a, n);
  if (a >= n) return a - n < n ? a - n : mod_n(a, n);
  return a;
}

// x / d for a divisor d fixed for the call. When d is a power of two its
// reciprocal r is exact and x * r is x / d bit for bit (one rounding of
// the same real value), so the quotient costs a product: a grid of 2^k
// cells on a domain of length 2^m has such cell sizes. (Its users,
// dissip_step.cu and cfl_hydro.cu, are compiled without FMA contraction,
// so the product is never fused with a sum.)
template <typename T>
struct Div {
  T d, r;
  bool pow2;
  HD T operator()(T x) const { return pow2 ? x * r : x / d; }
};

template <typename T>
inline Div<T> make_div(double v) {
  Div<T> q;
  q.d = T(v);
  int e = 0;
  const double m = std::frexp((double)q.d, &e);
  // a normal power of two whose reciprocal is normal too (exact in T)
  q.r = T(1) / q.d;
  q.pow2 = m == 0.5 && std::isnormal((double)q.d) && std::isnormal((double)q.r) &&
           (double)q.r * (double)q.d == 1.0;
  return q;
}

// max/min that propagate NaN, as torch.maximum and jnp.maximum do
template <typename T> HD T pmax(T a, T b) { return (a > b || a != a) ? a : b; }
template <typename T> HD T pmin(T a, T b) { return (a < b || a != a) ? a : b; }

// slopes.py slope_1d on one stencil
template <typename T>
HD T slope1(T qm, T q, T qp, T st) {
  const T dlft = st * (q - qm);
  const T drgt = st * (qp - q);
  const T dcen = T(0.5) * (qp - qm);
  const T dsgn = dcen >= T(0) ? T(1) : T(-1);
  T dlim = pmin(r_abs(dlft), r_abs(drgt));
  dlim = (dlft * drgt <= T(0)) ? T(0) : dlim;
  return dsgn * pmin(dlim, r_abs(dcen));
}

struct Dims {
  int nx, ny, nz;
  long long n;  // nx * ny * nz
};

HD Dims make_dims(int nx, int ny, int nz) {
  Dims d;
  d.nx = nx;
  d.ny = ny;
  d.nz = nz;
  d.n = (long long)nx * ny * nz;
  return d;
}

HD long long cell_at(const Dims& d, int i, int j, int k) {
  return ((long long)k * d.ny + j) * d.nx + i;
}
HD int wrap_p(int i, int n) { return i + 1 == n ? 0 : i + 1; }
HD int wrap_m(int i, int n) { return i == 0 ? n - 1 : i - 1; }
HD void cell_ijk(const Dims& d, long long c, int& i, int& j, int& k) {
  i = (int)(c % d.nx);
  const long long r = c / d.nx;
  j = (int)(r % d.ny);
  k = (int)(r / d.ny);
}

// mhd_step.cu's fused stage runs a block body as phases: the block's
// threads stride over a phase's n work items t and meet at block_sync()
// before the next phase; the host build runs each phase as a serial loop,
// so it runs the same ring logic item by item. (zcarry_mhd.cu and
// hydro_stream.cuh split their blocks into warp groups: Group below.)
template <typename F>
HD void block_items(int n, const F& f) {
#ifdef __CUDA_ARCH__
  for (int t = threadIdx.x; t < n; t += blockDim.x) f(t);
#else
  for (int t = 0; t < n; ++t) f(t);
#endif
}

// the z chunks of each (x, y) tile for a persistent grid of `blocks`: the
// count whose busiest block walks the fewest planes, each item walking its
// chunk and about three planes of warm-up
HD int pick_z_chunks(long long tiles, int blocks, int nz) {
  int best = 1;
  long long best_cost = -1;
  for (int c = 1; c <= 64 && c <= nz; ++c) {
    const int bz = (nz + c - 1) / c;
    const long long items = tiles * ((nz + bz - 1) / bz);
    const long long cost = (items + blocks - 1) / blocks * (bz + 3);
    if (best_cost < 0 || cost < best_cost) {
      best = c;
      best_cost = cost;
    }
  }
  return best;
}

// bytes of shared memory a block may opt into on the H100 (227 KB;
// cudaFuncAttributeMaxDynamicSharedMemorySize), static arrays included
constexpr long long SMEM_LIMIT = 232448;

HD void block_sync() {
#ifdef __CUDA_ARCH__
  __syncthreads();
#endif
}

// Named barriers (PTX bar.sync / bar.arrive): barrier `id` completes when
// `n` threads (a multiple of 32, whole warps) have reached it; sync waits
// for that, arrive does not. Both order each thread's earlier memory
// accesses before the barrier's completion. The host build runs one
// thread: both are no-ops.
HD void bar_sync(int id, int n) {
#ifdef __CUDA_ARCH__
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
#else
  (void)id;
  (void)n;
#endif
}
HD void bar_arrive(int id, int n) {
#ifdef __CUDA_ARCH__
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
#else
  (void)id;
  (void)n;
#endif
}

// *dst = *src from device memory into shared memory without holding the
// thread (cp.async); copy_async_wait() waits for this thread's copies,
// after which a barrier shows them to the others. Host build: a copy.
template <typename T>
HD void copy_async(T* dst, const T* src) {
#ifdef __CUDA_ARCH__
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (sizeof(T) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(s), "l"(src) : "memory");
#else
  *dst = *src;
#endif
}
HD void copy_async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
#endif
}
// the copies this thread started since its last commit form one group
// (copy_async_commit); copy_async_wait_prior() waits for all its groups but
// the last, which may run on while the thread computes
HD void copy_async_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;" ::: "memory");
#endif
}
HD void copy_async_wait_prior() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group 1;" ::: "memory");
#endif
}

// A group of a block's threads: threads [first, first + size) of the block
// as tid 0 .. size-1, with its own named barrier. Its threads stride over
// a phase's n work items; the host build runs each phase as a serial loop.
struct Group {
  int tid, size, bar;
  template <typename F>
  HD void items(int n, const F& f) const {
#ifdef __CUDA_ARCH__
    for (int t = tid; t < n; t += size) f(t);
#else
    for (int t = 0; t < n; ++t) f(t);
#endif
  }
  HD void sync() const { bar_sync(bar, size); }
};

// The named barriers of a block split into a producer and a consumer
// group (zcarry_mhd.cu, hydro_stream.cuh): the hand-over of plane g (FULL,
// one of three: the producer may run up to three planes ahead of the
// consumer's wait, and a barrier never has two arrivals of one group
// pending), its release (EMPTY, one of two) and each group's own.
enum { BAR_FULL = 1, BAR_EMPTY = 4, BAR_A = 6, BAR_B = 7 };

// The hand-over of the planes of a three-plane ring between the groups,
// on named barriers of all NT threads: the producer arrives at FULL(g)
// once it has written plane g, the consumer waits there before it reads
// g; the consumer arrives at EMPTY(r) once it no longer reads plane r
// (after its wait at FULL(r + 1)), the producer waits there before it
// writes plane r + 3 into r's slot. Each barrier has at most one arrival
// of each group pending: between the producer's arrivals at FULL(g) and
// FULL(g + 3) it waits at EMPTY(g), which follows the consumer's wait at
// FULL(g + 1); between the consumer's arrivals at EMPTY(r) and EMPTY(r +
// 2), its wait at FULL(r + 3) follows the producer's wait at EMPTY(r).
// Host build: no-ops (the serial schedule keeps the order).
template <int NT>
struct Pipe {
  HD static void full_arrive(long long g) { bar_arrive(BAR_FULL + (int)(g % 3), NT); }
  HD static void full_wait(long long g) { bar_sync(BAR_FULL + (int)(g % 3), NT); }
  HD static void empty_arrive(long long r) { bar_arrive(BAR_EMPTY + (int)(r % 2), NT); }
  HD static void empty_wait(long long r) { bar_sync(BAR_EMPTY + (int)(r % 2), NT); }
};

// The cycles a block's warp groups spend in their phases, barrier waits
// included, in builds with RAMSES_ZCARRY_CLOCKS (scripts/torch_ab.py
// clocks; zcarry_mhd.cu and hydro_stream.cuh name their phases): lap(i)
// adds the clock64() time since the last lap to t[i]. Other builds: no-ops.
struct Clocks {
#if defined(RAMSES_ZCARRY_CLOCKS) && defined(__CUDA_ARCH__)
  long long t[6] = {0, 0, 0, 0, 0, 0}, last = 0;
  __device__ void lap(int i) {
    const long long now = clock64();
    if (i >= 0) t[i] += now - last;
    last = now;
  }
#else
  HD void lap(int) {}
#endif
};

#ifdef __CUDACC__
template <typename F>
__global__ void __launch_bounds__(128) for_each_cell(F f, long long n) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c < n) f(c);
}
#endif

// Run f(c) for every cell c: one CUDA thread per cell on `stream`, or a
// serial loop in the host build. Returns the launch's cudaError_t (0 = ok).
template <typename F>
inline int launch_cells(const F& f, long long n, void* stream) {
#ifdef __CUDACC__
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  for_each_cell<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(f, n);
  return (int)cudaGetLastError();
#else
  (void)stream;
  for (long long c = 0; c < n; ++c) f(c);
  return 0;
#endif
}

#ifdef __CUDACC__
template <typename T, typename F>
__global__ void __launch_bounds__(F::NT, F::MIN_BLOCKS) for_each_block(F f) {
  extern __shared__ __align__(16) unsigned char smem[];
  f(blockIdx.x, reinterpret_cast<T*>(smem));
}
#endif

// Run f(b, tile) for every block b in [0, blocks): a CUDA block of F::NT
// threads whose tile is F::BYTES of shared memory, on `stream`; in the host
// build the blocks run in turn on one local tile, each of their phases a
// serial loop (block_items, block_sync). Returns the cudaError_t (0 = ok).
template <typename T, typename F>
inline int launch_blocks(const F& f, long long blocks, void* stream) {
#ifdef __CUDACC__
  const int err = (int)cudaFuncSetAttribute(
      for_each_block<T, F>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)F::BYTES);
  if (err) return err;
  for_each_block<T, F><<<(unsigned)blocks, F::NT, F::BYTES, (cudaStream_t)stream>>>(f);
  return (int)cudaGetLastError();
#else
  (void)stream;
  std::vector<T> tile(F::BYTES / sizeof(T));
  for (long long b = 0; b < blocks; ++b) f(b, tile.data());
  return 0;
#endif
}

#ifdef __CUDACC__
// the max of the block's values v into *out, a device value the caller set
// to 0 before the launch: the block's max (NaN-propagating; by warp
// shuffles, then over the warps), then one atomic max on its bit pattern,
// which orders non-negative floats as their values and puts a NaN of either
// sign above every one of them. Every thread of the block calls it.
template <typename T>
__device__ void atomic_max_nonneg(T* out, T v) {
  __shared__ T warp_max[32];
  for (int o = 16; o > 0; o >>= 1) v = pmax(v, __shfl_down_sync(0xffffffffu, v, o));
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = v;
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 1; w < (int)(blockDim.x + 31) / 32; ++w) v = pmax(v, warp_max[w]);
  if constexpr (sizeof(T) == 4)
    atomicMax(reinterpret_cast<unsigned int*>(out), __float_as_uint(v));
  else
    atomicMax(reinterpret_cast<unsigned long long*>(out),
              (unsigned long long)__double_as_longlong(v));
}
#endif

}  // namespace ramses
