// One 3D hydro step of a fully periodic state streamed over z, with the
// next step's CFL reduction folded in: every stage of hydro_step.cu's
// interior PERIODIC mode and cfl_hydro.cu's reduction in one launch.
//
// Replaces the TPU kernel ramsesgpu_tpu/pallas/zcarry_hydro3d.py:58
// make_zcarry_hydro_packed_io with with_inv_dt=True (the only form its
// loop uses, pallas/fused_hydro3d.py:232-233): the hydro step streamed
// over z, the stage planes carried, the inverse dt of the new state
// reduced in the kernel. Plain twin: solvers/godunov.py
// hydro_3d_state_update, then solvers/timestep.py compute_inv_dt_hydro on
// its result (kernels/zcarry_hydro3d.py).
//
// Design (first, simple version), as zcarry_mhd.cu: a work item is an
// (x, y) tile of TX x TY columns and a z chunk [z0, z1); one block walks
// its planes m = z0-2 .. z1+1 and runs, each as a phase over the tile
// (block_phase, block_sync; the per-cell physics is hydro_stages.cuh's):
//   prim (m)        columns -2 .. W+1   Q                       ring of 3 planes
//   trace (m - 1)   -1 .. W             the cell's primitives,  ring of 2
//                                       half slopes and sources
//                                       (CellTrace, 25 values)
//   fluxes (m - 1)  0 .. W              x and y faces of plane  ring of 2
//                                       m-1, z face below it
//   update (m - 2)  0 .. W-1            the new state into So, and its
//                                       cell's inverse dt (cfl_hydro.cuh)
// Each cell is traced once (hydro_step.cu traces it once per face state,
// six times) and each face state is formed from the stored trace.
// Ring: 95 values per ring cell (Q 15, traces 50, fluxes 30) x 20 x 12
// cells (a 16 x 8 tile) = 22,800 values per block, in shared memory: 91 KB
// in f32 (two blocks per SM), 182 KB in f64, under the 227 KB a block may
// opt into. The grid is persistent, so nothing grows with nz. The block's
// max inverse dt goes into *inv through one atomic max on the float's bits
// (common.cuh atomic_max_nonneg).
//
// Bound on the H100: the step reads and writes the 5 conserved values of
// each cell, 40 B/cell in f32 (0.20 ms at 256^3 at 3.35 TB/s), and does
// ~0.75 kflop per cell with the approx solver (hydro_step.cu), 0.19 ms at
// the f32 peak, plus the CFL's ~25 flops: the bound is the bytes.
#include "cfl_hydro.cuh"
#include "hydro_stages.cuh"

#ifndef __CUDACC__
#include <vector>
#endif

namespace ramses::zhydro {

using namespace ramses::hydro;

// the (x, y) tile of a work item and the threads of a block
constexpr int TX = 16, TY = 8;
constexpr int NT = 256;  // threads per block
constexpr int LO = 2;             // ring columns (rows) below the tile
constexpr int PW = TX + 4, PH = TY + 4;
constexpr long long PLANE = (long long)PW * PH;
constexpr int RQ = 3, RC = 2, RF = 2;   // ring planes: primitives, traces, fluxes
constexpr int NCT = NV * 5;             // a CellTrace: q, h[3], s
// ring layout: Q [NV][RQ], CT [NCT][RC], FX, FY, FZ [NV][RF] planes each
constexpr long long OFF_CT = NV * RQ * PLANE;
constexpr long long OFF_F = OFF_CT + NCT * RC * PLANE;
constexpr long long RING_VALUES = OFF_F + 3 * NV * RF * PLANE;   // per block
// the f64 ring and the reduction's 32 values (atomic_max_nonneg) fit
static_assert(RING_VALUES * 8 + 32 * 8 <= SMEM_LIMIT, "the ring must fit a block's shared memory");

template <typename T>
struct ZArgs {
  const T* S;      // [5][nz][ny][nx]
  T* So;           // its new value (another buffer)
  T* inv;          // the max inverse dt of the new state (zeroed by the launcher)
  const T* dt;
  const unsigned char* active;
  Dims d;
  HydroPhys<T> ph;
  Phys<T> cfl;     // the CFL's constants (cfl_hydro.cuh)
  T c_iso;
  int ntx, nty, bz;
  long long items;
};

HD long long plane_at(int li, int lj) { return (long long)(lj + LO) * PW + (li + LO); }

// the primitives on the ring, as hydro_step.cu's Prim loads them: (li, lj)
// tile-local, m the z plane
template <typename T>
struct RingPrim {
  const T* Q;
  HD void load(int li, int lj, int m, T* q) const {
    const long long c = mod_n(m, RQ) * PLANE + plane_at(li, lj);
#pragma unroll
    for (int ch = 0; ch < NV; ++ch) q[ch] = Q[ch * RQ * PLANE + c];
  }
};

// the stored trace of ring cell (li, lj) of plane m: what face_state<AX>
// reads of it (q, s and the half slopes along AX)
template <int AX, typename T>
HD void load_trace(const T* CT, int li, int lj, int m, CellTrace<T>& c) {
  const long long o = mod_n(m, RC) * PLANE + plane_at(li, lj);
  const long long s = RC * PLANE;
#pragma unroll
  for (int ch = 0; ch < NV; ++ch) {
    c.q[ch] = CT[ch * s + o];
    c.h[AX][ch] = CT[(NV * (1 + AX) + ch) * s + o];
    c.s[ch] = CT[(4 * NV + ch) * s + o];
  }
}

// the flux through the face between the traced cells l and r along AX
template <int AX, typename T>
HD void traced_flux(const HydroPhys<T>& ph, const CellTrace<T>& l, const CellTrace<T>& r, T* f) {
  T qm[NV], qp[NV];
  face_state<AX>(ph, l, T(1), qm);
  face_state<AX>(ph, r, T(-1), qp);
  face_flux<AX>(ph, qm, qp, f);
}

template <typename T>
HD T run_block(const ZArgs<T>& z, T* ring, long long block, long long nblocks) {
  const Dims& d = z.d;
  const HydroPhys<T>& ph = z.ph;
  T* Q = ring;
  T* CT = ring + OFF_CT;
  T* F[3] = {ring + OFF_F, ring + OFF_F + NV * RF * PLANE, ring + OFF_F + 2 * NV * RF * PLANE};
  const long long sf = RF * PLANE;   // channel stride of a flux ring
  const T dt = *z.dt;
  const T dtdx = dt / ph.dx, dtdy = dt / ph.dy, dtdz = dt / ph.dz;
  T inv = T(0);
  for (long long item = block; item < z.items; item += nblocks) {
    const int tx = (int)(item % z.ntx);
    const long long r = item / z.ntx;
    const int ty = (int)(r % z.nty);
    const int x0 = tx * TX, y0 = ty * TY, z0 = (int)(r / z.nty) * z.bz;
    const int W = d.nx - x0 < TX ? d.nx - x0 : TX;
    const int H = d.ny - y0 < TY ? d.ny - y0 : TY;
    const int z1 = d.nz - z0 < z.bz ? d.nz : z0 + z.bz;
    if (!*z.active) {
      // the step is skipped: its output is its input
      for (int k = z0; k < z1; ++k) {
        block_phase(W, H, 0, [&](int li, int lj) {
          const long long cs = cell_at(d, x0 + li, y0 + lj, k);
          for (int ch = 0; ch < NV; ++ch) z.So[ch * d.n + cs] = z.S[ch * d.n + cs];
          inv = pmax(inv, hydro_inv_dt_cell(z.cfl, z.c_iso, z.S + cs, d.n));
        });
      }
      continue;
    }
    for (int m = z0 - 2; m <= z1 + 1; ++m) {
      block_phase(W + 4, H + 4, -2, [&](int li, int lj) {
        const long long cs = cell_at(d, wrap_any(x0 + li, d.nx), wrap_any(y0 + lj, d.ny),
                                     wrap_any(m, d.nz));
        prim_cell(ph, z.S + cs, d.n, Q + mod_n(m, RQ) * PLANE + plane_at(li, lj), RQ * PLANE);
      });
      block_sync();
      if (m >= z0) {
        block_phase(W + 2, H + 2, -1, [&](int li, int lj) {
          CellTrace<T> c;
          trace_cell(ph, RingPrim<T>{Q}, li, lj, m - 1, dtdx, dtdy, dtdz, c);
          const long long o = mod_n(m - 1, RC) * PLANE + plane_at(li, lj);
          const long long s = RC * PLANE;
#pragma unroll
          for (int ch = 0; ch < NV; ++ch) {   // q, h[0..2], s (load_trace)
            CT[ch * s + o] = c.q[ch];
            for (int ax = 0; ax < 3; ++ax) CT[(NV * (1 + ax) + ch) * s + o] = c.h[ax][ch];
            CT[(4 * NV + ch) * s + o] = c.s[ch];
          }
        });
        block_sync();
      }
      if (m - 1 >= z0) {
        const int k = m - 1;
        const long long o = mod_n(k, RF) * PLANE;
        block_phase(W + 1, H + 1, 0, [&](int li, int lj) {
          CellTrace<T> l, c;
          T f[NV];
          if (k < z1 && lj < H) {   // the x face left of (li, lj)
            load_trace<0>(CT, li - 1, lj, k, l);
            load_trace<0>(CT, li, lj, k, c);
            traced_flux<0>(ph, l, c, f);
            for (int ch = 0; ch < NV; ++ch) F[0][ch * sf + o + plane_at(li, lj)] = f[ch];
          }
          if (k < z1 && li < W) {   // the y face below (li, lj)
            load_trace<1>(CT, li, lj - 1, k, l);
            load_trace<1>(CT, li, lj, k, c);
            traced_flux<1>(ph, l, c, f);
            for (int ch = 0; ch < NV; ++ch) F[1][ch * sf + o + plane_at(li, lj)] = f[ch];
          }
          if (li < W && lj < H) {   // the z face below plane k
            load_trace<2>(CT, li, lj, k - 1, l);
            load_trace<2>(CT, li, lj, k, c);
            traced_flux<2>(ph, l, c, f);
            for (int ch = 0; ch < NV; ++ch) F[2][ch * sf + o + plane_at(li, lj)] = f[ch];
          }
        });
        block_sync();
      }
      if (m - 2 >= z0) {
        // no sync after: the next plane's prim and trace write no ring
        // array the update reads, and its flux phase comes after two syncs
        const int k = m - 2;
        const long long o = mod_n(k, RF) * PLANE, o1 = mod_n(k + 1, RF) * PLANE;
        block_phase(W, H, 0, [&](int li, int lj) {
          const long long cs = cell_at(d, x0 + li, y0 + lj, k);
          const long long c = plane_at(li, lj);
          T u[NV];
#pragma unroll
          for (int ch = 0; ch < NV; ++ch) {
            const long long f = ch * sf + o + c;
            u[ch] = update_value(z.S[ch * d.n + cs], F[0][f], F[0][f + 1], F[1][f], F[1][f + PW],
                                 F[2][f], F[2][ch * sf + o1 + c], dtdx, dtdy, dtdz);
            z.So[ch * d.n + cs] = u[ch];
          }
          inv = pmax(inv, hydro_inv_dt_cell(z.cfl, z.c_iso, u, 1));
        });
      }
    }
    block_sync();  // the next item's prim overwrites the ring
  }
  return inv;
}

#ifdef __CUDACC__
template <typename T>
__global__ void __launch_bounds__(NT) zcarry_hydro_kernel(ZArgs<T> z) {
  extern __shared__ __align__(16) unsigned char smem[];
  const T inv = run_block<T>(z, reinterpret_cast<T*>(smem), blockIdx.x, gridDim.x);
  atomic_max_nonneg(z.inv, inv);
}

template <typename T>
int resident(int* blocks) {
  const int smem = (int)(RING_VALUES * sizeof(T));
  int err = (int)cudaFuncSetAttribute(zcarry_hydro_kernel<T>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int per_sm = 0, dev = 0, sms = 0;
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, zcarry_hydro_kernel<T>,
                                                            NT, smem);
  if (!err) err = (int)cudaGetDevice(&dev);
  if (!err) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *blocks = per_sm * sms;
  return err;
}
#endif

template <typename T>
int zcarry_hydro(const T* S, T* So, int blocks, T* inv, const T* dt,
                 const unsigned char* active, int nx, int ny, int nz, const double* prm,
                 void* stream) {
  ZArgs<T> z;
  z.S = S;
  z.So = So;
  z.inv = inv;
  z.dt = dt;
  z.active = active;
  z.d = make_dims(nx, ny, nz);
  z.ph = make_hydro_phys<T>(prm);
  z.cfl = make_phys<T>(prm);
  z.c_iso = T(prm[P_CISO]);
  z.ntx = (nx + TX - 1) / TX;
  z.nty = (ny + TY - 1) / TY;
  const long long tiles = (long long)z.ntx * z.nty;
  const int nzc = pick_z_chunks(tiles, blocks, nz);
  z.bz = (nz + nzc - 1) / nzc;
  z.items = tiles * ((nz + z.bz - 1) / z.bz);
#ifdef __CUDACC__
  cudaStream_t s = (cudaStream_t)stream;
  const int smem = (int)(RING_VALUES * sizeof(T));
  int err = (int)cudaMemsetAsync(inv, 0, sizeof(T), s);
  if (!err)
    err = (int)cudaFuncSetAttribute(zcarry_hydro_kernel<T>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return err;
  zcarry_hydro_kernel<T><<<blocks, NT, smem, s>>>(z);
  return (int)cudaGetLastError();
#else
  (void)stream;
  std::vector<T> ring(RING_VALUES);  // the serial blocks take turns on one ring
  T m = T(0);
  for (int b = 0; b < blocks; ++b) m = pmax(m, run_block<T>(z, ring.data(), b, blocks));
  *inv = m;
  return 0;
#endif
}

}  // namespace ramses::zhydro

extern "C" {

// the persistent grid: as many blocks as the card holds at once (host
// build: 3, so the serial build strides over the items as the blocks do)
int ramses_zcarry_hydro_blocks(int f64) {
#ifdef __CUDACC__
  using namespace ramses::zhydro;
  int blocks = 0;
  const int err = f64 ? resident<double>(&blocks) : resident<float>(&blocks);
  return err ? -err : blocks;
#else
  (void)f64;
  return 3;
#endif
}

// S: the fully periodic state [5][nz][ny][nx]; So: its new value (another
// buffer); blocks: the persistent grid (ramses_zcarry_hydro_blocks); inv:
// the new state's max inverse dt
int ramses_zcarry_hydro_f32(const float* S, float* So, int blocks, float* inv,
                            const float* dt, const unsigned char* active, int nx, int ny, int nz,
                            const double* prm, void* stream) {
  return ramses::zhydro::zcarry_hydro<float>(S, So, blocks, inv, dt, active, nx, ny, nz,
                                             prm, stream);
}

int ramses_zcarry_hydro_f64(const double* S, double* So, int blocks, double* inv,
                            const double* dt, const unsigned char* active, int nx, int ny,
                            int nz, const double* prm, void* stream) {
  return ramses::zhydro::zcarry_hydro<double>(S, So, blocks, inv, dt, active, nx, ny, nz,
                                              prm, stream);
}

}  // extern "C"
