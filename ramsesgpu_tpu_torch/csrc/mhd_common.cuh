// Shared pieces of the port's CUDA kernels (cfl_mhd.cu, mhd_step.cu).
//
// Layout: the port's loop state is the interior-only periodic state
// S[8][nz][ny][nx] (channel-major, x fastest); a periodic neighbour is
// found by index wrap, so no ghost cells exist on the device.
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
#define HD inline
#endif

namespace ramses {

// Physical parameters. The Python side passes them as doubles in the
// order of the P_* indices; derived constants are formed in double and
// rounded once to T, as the JAX reference rounds its Python floats.
enum { P_GAMMA0, P_SMALLR, P_SMALLP, P_SMALLC, P_SLOPE, P_DX, P_DY, P_DZ, P_COUNT };

template <typename T>
struct Phys {
  T gamma0, gm1, entho, smallr, smallp, smallc, slope, dx, dy, dz;
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
  return ph;
}

// conserved / primitive channel slots (ramsesgpu_tpu core/constants.py)
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

// max/min that propagate NaN, as torch.maximum and jnp.maximum do
template <typename T> HD T pmax(T a, T b) { return (a > b || a != a) ? a : b; }
template <typename T> HD T pmin(T a, T b) { return (a < b || a != a) ? a : b; }

struct Dims {
  int nx, ny, nz;
  long long n;  // nx * ny * nz
};

inline Dims make_dims(int nx, int ny, int nz) {
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

}  // namespace ramses
