// One 3D MHD+CT step streamed over z: every stage of mhd_step.cu in one
// launch, with no buffer that grows with the grid's depth.
//
// Replaces the TPU kernel ramsesgpu_tpu/pallas/zcarry_mhd3d.py:102
// make_zcarry_mhd_packed_io ([implementation] kernel=zcarry): the MHD+CT
// step streamed over z blocks, the stage planes a z block needs from the
// one below carried instead of recomputed, the next step's CFL reduction
// optionally folded in, in the periodic, shearing-box and stratified modes,
// plain or Kahan-compensated. Plain twin: the step twin
// (solvers/godunov_mhd.py mhd_3d_periodic_update / mhd_3d_shear_update)
// and, folded, solvers/timestep.py inv_dt_mhd_periodic on its result
// (kernels/zcarry_mhd3d.py).
//
// It computes the function of mhd_step.cu, whose stages (mhd_stages.cuh)
// it runs as they are, on another site: RingSite below maps each
// intermediate array of a stage cell's neighbours into a per-block ring in
// shared memory instead of a full-grid stage buffer.
//
// Design (first, simple version):
// - A work item is an (x, y) tile of TX x TY columns and a z chunk
//   [z0, z1). One thread block walks its item's z planes m = z0-2 .. z1+1
//   and at each plane runs, each as a phase over the tile's cells (the
//   block's threads stride over it; block_phase, block_sync):
//     prim (m)         columns -2 .. W+1   Q
//     efield (m)       -1 .. W+1          E
//     precursor (m-1)  -1 .. W            what the 18 face / edge states
//                                         are formed from (mhd_stages.cuh)
//     flux, emf (m-1)  0 .. W             x, y, z face fluxes and the
//                                         z, y, x edge EMFs of plane m-1,
//                                         each of the six a work item
//                                         forming its states (FluxEmf)
//     update (m - 2)   0 .. W-1           the new state into So (not S)
//   (rows likewise; W, H: the tile's own extent, smaller at the grid's
//   edge). The tile's halo columns and rows and the chunk's two warm-up
//   planes are computed again by the neighbouring items.
// - The ring keeps of each array only the planes a later phase reads:
//     Q, Se       3 planes (the precursors read m-2 .. m)   8 + 8 values
//     E           2 planes (the precursors read m-1, m)     3
//     precursors  2 planes (a z face or edge reads m-2)     NPRE = 48
//     fluxes, EMFs  2 planes (update reads m-2, m-1)        15 + 3
//   189 values per ring cell with the folded CFL's three face values (Se:
//   the state, copied by prim), where the 18 traced states made it 277.
//   The tile: f32 8 x 8 (12 x 12 ring cells, 108,864 B), so two blocks of
//   256 threads share an SM; f64 8 x 4 (12 x 8 ring cells, 145,152 B), one
//   block of 160 threads per SM. The grid is persistent: as many blocks as
//   the card holds at once, each striding over the work items, so nothing
//   grows with nz.
// - Two state buffers: a block reads halo cells of its neighbours' tiles,
//   so the step reads S and writes So (a single launch cannot update in
//   place). The Python loop swaps them each step.
// - Folded CFL (periodic mode, no dissipation): each updated cell's
//   inverse dt (cfl_mhd.cuh inv_dt_cell) needs B on its +1 x, y and z
//   faces, which belong to the next cell's update, possibly another
//   block's. Those three face values are recomputed here with the update's
//   own CT arithmetic (ct_delta, Kahan-added when compensated) from EMFs
//   this block holds (the +1 edges of the tile and of plane m-2 are in its
//   flux / EMF extent), so they equal the neighbour's output; the block's
//   max then goes into *inv through one atomic max on the float's bits
//   (common.cuh atomic_max_nonneg; the caller's value is zeroed first).
// - The shear modes read the sheared x slabs and (stratified) the z slabs
//   through mhd_stages.cuh's load rule and write the five x-face planes,
//   as mhd_step.cu; their CFL stays a separate launch, as in the JAX loop.
//
// Bound on the H100: the step's arithmetic, as mhd_step.cu (2979 counted
// flops per cell in the periodic mode, 0.75 ms at 256^3 at the f32 peak;
// state in and out 64 B/cell, 0.32 ms), plus the folded CFL's ~69 flops
// per cell; the halo recomputation adds 1.56x the precursors' cells and
// 1.27x the fluxes' at the f32 tile.
#include "cfl_mhd.cuh"
#include "mhd_stages.cuh"

namespace ramses::zmhd {

using namespace ramses::mhd;

// the (x, y) tile of a work item, the threads of a block and the blocks an
// SM holds, per dtype
template <typename T>
struct Tile;
template <>
struct Tile<float> {
  static constexpr int TX = 8, TY = 8, NT = 256, PER_SM = 2;
};
template <>
struct Tile<double> {
  static constexpr int TX = 8, TY = 4, NT = 160, PER_SM = 1;
};

constexpr int LO = 2;        // ring columns (rows) below the tile: prim reaches -2

// a block's ring in shared memory: PP cells per plane; Q and the state
// Se [8][3 planes], E [3][2], the precursors [2][NPRE], fluxes [3][5][2]
// and EMFs [3][2], and the folded CFL's face values [3], each plane PP
// values
template <typename T>
struct Ring {
  static constexpr int TX = Tile<T>::TX, TY = Tile<T>::TY, NT = Tile<T>::NT;
  static constexpr int PW = TX + 4, PH = TY + 4;
  static constexpr long long PP = (long long)PW * PH;
  static constexpr int RQ = 3;  // planes of Q and Se (the others: 2)
  static constexpr long long OFF_SE = 8 * RQ * PP;
  static constexpr long long OFF_E = OFF_SE + 8 * RQ * PP;
  static constexpr long long OFF_PRE = OFF_E + 3 * 2 * PP;
  static constexpr long long OFF_F = OFF_PRE + 2 * NPRE * PP;
  static constexpr long long OFF_EMF = OFF_F + 3 * NFLUX * 2 * PP;
  static constexpr long long OFF_FACE = OFF_EMF + 3 * 2 * PP;  // folded CFL: [3]
  static constexpr long long VALUES = OFF_FACE + 3 * PP;
  static constexpr long long BYTES = VALUES * (long long)sizeof(T);
  // an SM's 228 KB hold PER_SM rings, each with the reduction's 32 values
  // (atomic_max_nonneg) and the 1 KB the runtime keeps per block
  static_assert(Tile<T>::PER_SM * (BYTES + 32 * (long long)sizeof(T) + 1024) <= 233472,
                "the rings of the blocks an SM holds fit its shared memory");
  static_assert(BYTES + 32 * (long long)sizeof(T) <= SMEM_LIMIT,
                "the ring and the reduction's 32 values fit a block");
};

template <typename T>
struct ZArgs {
  StepArgs<T> a;   // the state, its output, slabs, planes, dt, active (stage pointers: per block)
  T* inv;          // folded CFL: the max inverse dt of the new state; null: none
  int ntx, nty, bz;      // tiles along x and y; depth of a z chunk
  long long items;       // ntx * nty * z chunks
};

// a stage cell of the ring: global cell (i, j, k) of tile-local column li,
// row lj, z plane k (unwrapped: the halo reaches outside the grid); its
// neighbours' intermediates are ring cells of each array's planes, its
// state loads go through the load rule (periodic wrap, or the slabs)
template <typename T, typename M>
struct RingSite {
  using R = Ring<T>;
  const StepArgs<T>& a;
  int i, j, k, li, lj;
  int sq[3], s2[3];  // the planes of Q and of the 2-plane arrays at k - 1, k, k + 1
  long long cs;      // on_state: the state's index of (i, j, k)

  HD RingSite(const StepArgs<T>& a_, int x0, int y0, int li_, int lj_, int m, bool on_state = false)
      : a(a_), i(x0 + li_), j(y0 + lj_), k(m), li(li_), lj(lj_) {
    const int s0 = mod_n(m, R::RQ);
    sq[0] = s0 == 0 ? R::RQ - 1 : s0 - 1;
    sq[1] = s0;
    sq[2] = s0 == R::RQ - 1 ? 0 : s0 + 1;
    s2[1] = m & 1;
    s2[0] = s2[2] = 1 - s2[1];
    cs = on_state ? cell_at(a.d, i, j, k) : 0;
  }
  HD long long cell(int di, int dj) const {
    return (long long)(lj + dj + LO) * R::PW + (li + di + LO);
  }
  HD long long iq(int di, int dj, int dk) const { return sq[dk + 1] * R::PP + cell(di, dj); }
  HD long long ie(int di, int dj, int dk) const { return s2[dk + 1] * R::PP + cell(di, dj); }
  HD long long iflux(int di, int dj, int dk) const { return ie(di, dj, dk); }
  // precursor v of this cell (the precursor stage's output) and of the
  // neighbour (di, dj, dk), dk = 0 or -1
  HD long long ipre(int v) const { return ((long long)s2[1] * NPRE + v) * R::PP + cell(0, 0); }
  HD T pre(int v, int di, int dj, int dk) const {
    return a.pre[((long long)s2[dk + 1] * NPRE + v) * R::PP + cell(di, dj)];
  }
  HD long long cq() const { return iq(0, 0, 0); }
  HD long long ce() const { return ie(0, 0, 0); }
  HD long long cflux() const { return ie(0, 0, 0); }
  HD long long nq() const { return R::RQ * R::PP; }
  HD long long ne() const { return 2 * R::PP; }
  HD long long nflux() const { return 2 * R::PP; }
  // prim's copy of the cell's state, which the later stages read (s)
  HD void keep_state(const T* sc) const {
    const long long c = cq();
#pragma unroll
    for (int ch = 0; ch < 8; ++ch) a.Se[ch * nq() + c] = sc[ch];
  }
  HD T src(int ch, int di, int dj, int dk) const {
    const int jj = wrap_any(j + dj, a.d.ny);
    if constexpr (M::SHEAR) {
      return load_shear<T, M>(a, ch, i + di, jj, M::STRAT ? k + dk : wrap_any(k + dk, a.d.nz));
    } else {
      return a.S[ch * a.d.n +
                 cell_at(a.d, wrap_any(i + di, a.d.nx), jj, wrap_any(k + dk, a.d.nz))];
    }
  }
  HD T s(int ch, int di, int dj, int dk) const { return a.Se[ch * nq() + iq(di, dj, dk)]; }
  HD T xpos() const { return a.ph.xpos0 + r_mul(T(i), a.ph.dx); }
  HD T gz() const { return a.gz[k + SLAB]; }
};

// the new face field ch (IA, IB, IC) of the cell (di, dj, dk) from p, by
// the update's CT (UpdateStage): from the ring's EMFs, which cover the +1
// edges of that cell (IC's increment, on the plane above, reads no +1 z
// EMF)
template <bool COMP, typename T, typename M>
HD T face_after(const StepArgs<T>& a, const RingSite<T, M>& p, int ch, int di, int dj, int dk,
                T dtdx, T dtdy, T dtdz) {
  const long long c = p.iflux(di, dj, dk);
  const long long czp = dk == 0 ? p.iflux(di, dj, 1) : c;
  const long long cs = cell_at(a.d, wrap_any(p.i + di, a.d.nx), wrap_any(p.j + dj, a.d.ny),
                               wrap_any(p.k + dk, a.d.nz));
  const T d = ct_delta<COMP>(a.emf, p.nflux(), ch, c, p.iflux(di + 1, dj, dk),
                             p.iflux(di, dj + 1, dk), czp, dtdx, dtdy, dtdz);
  T u = a.S[ch * a.d.n + cs];
  if constexpr (COMP) {
    T cc = a.C[ch * a.d.n + cs];
    kahan_add(u, cc, d);
    return u;
  } else {
    return u + d;
  }
}

// the new B of the state cell p's +1 face along axis f (Bx at +1 x, By
// at +1 y, Bz at +1 z), by face_after
template <bool COMP, typename T, typename M>
HD T folded_face(const StepArgs<T>& a, const RingSite<T, M>& p, int f) {
  const T dt = *a.dt;
  const T dtdx = dt / a.ph.dx, dtdy = dt / a.ph.dy, dtdz = dt / a.ph.dz;
  // (one call per axis: the ring's plane slots are then indexed by
  // constants, not through a stack frame)
  switch (f) {
    case 0: return face_after<COMP>(a, p, IA, 1, 0, 0, dtdx, dtdy, dtdz);
    case 1: return face_after<COMP>(a, p, IB, 0, 1, 0, dtdx, dtdy, dtdz);
    default: return face_after<COMP>(a, p, IC, 0, 0, 1, dtdx, dtdy, dtdz);
  }
}

// the folded CFL of the state cell p after its update (So): the cell's
// channels and B on its +1 faces (folded_face, at face[f PP + cell]),
// through inv_dt_cell
template <typename T, typename M>
HD T folded_inv_dt(const StepArgs<T>& a, const RingSite<T, M>& p, const T* face) {
  using R = Ring<T>;
  const long long c = p.cell(0, 0);
  // channel ch of the cell at v[3 ch]; By at +1 y: v[3 IB + 1]; Bz at +1
  // z: v[3 IC + 2]
  T v[8 * 3];
#pragma unroll
  for (int ch = 0; ch < 8; ++ch) v[3 * ch] = a.So[ch * a.d.n + p.cs];
  v[3 * IB + 1] = face[R::PP + c];
  v[3 * IC + 2] = face[2 * R::PP + c];
  return inv_dt_cell<T, false>(a.ph, v, 3, 0, face[c], 1, 2);
}

// One block's work: its items in turn, on `ring` (its own); returns the
// max inverse dt of the cells it updated (folded CFL), else 0.
template <typename T, typename M>
HD T run_block(const ZArgs<T>& z, T* ring, long long block, long long nblocks) {
  using R = Ring<T>;
  StepArgs<T> a = z.a;
  a.Q = ring;
  a.Se = ring + R::OFF_SE;
  a.E = ring + R::OFF_E;
  a.pre = ring + R::OFF_PRE;
  a.fl = ring + R::OFF_F;
  a.emf = ring + R::OFF_EMF;
  T* face = ring + R::OFF_FACE;
  const bool fold = z.inv != nullptr;
  const bool comp = a.C != nullptr;
  T inv = T(0);
  for (long long item = block; item < z.items; item += nblocks) {
    const int tx = (int)(item % z.ntx);
    const long long r = item / z.ntx;
    const int ty = (int)(r % z.nty);
    const int x0 = tx * R::TX, y0 = ty * R::TY, z0 = (int)(r / z.nty) * z.bz;
    const int W = a.d.nx - x0 < R::TX ? a.d.nx - x0 : R::TX;
    const int H = a.d.ny - y0 < R::TY ? a.d.ny - y0 : R::TY;
    const int z1 = a.d.nz - z0 < z.bz ? a.d.nz : z0 + z.bz;
    if (!*a.active) {
      // the step is skipped: its output is its input
      for (int k = z0; k < z1; ++k) {
        block_phase(W, H, 0, [&](int li, int lj) {
          const long long cs = cell_at(a.d, x0 + li, y0 + lj, k);
          for (int ch = 0; ch < 8; ++ch) {
            a.So[ch * a.d.n + cs] = a.S[ch * a.d.n + cs];
            if (comp) a.Co[ch * a.d.n + cs] = a.C[ch * a.d.n + cs];
          }
          if (fold) inv = pmax(inv, inv_dt_at<T, false>(a.ph, a.d, a.S, nullptr, cs));
        });
      }
      continue;
    }
    for (int m = z0 - 2; m <= z1 + 1; ++m) {
      block_phase(W + 4, H + 4, -2, [&](int li, int lj) {
        PrimStage<T, M>{a}.at(RingSite<T, M>(a, x0, y0, li, lj, m));
      });
      block_sync();
      if (m >= z0 - 1) {
        block_phase(W + 3, H + 3, -1, [&](int li, int lj) {
          EFieldStage<T, M>{a}.at(RingSite<T, M>(a, x0, y0, li, lj, m));
        });
        block_sync();
      }
      if (m >= z0) {
        block_phase(W + 2, H + 2, -1, [&](int li, int lj) {
          PrecursorStage<T, M>{a}.at(RingSite<T, M>(a, x0, y0, li, lj, m - 1));
        });
        block_sync();
      }
      if (m - 1 >= z0) {
        // the three face fluxes and the three edge EMFs of each cell, one
        // work item each, so that every thread of the block has work
        const int w = W + 1, cells = (W + 1) * (H + 1);
        block_items(6 * cells, [&](int t) {
          const int part = t / cells, c = t - part * cells;
          FluxEmf<T, M>{a}.part(RingSite<T, M>(a, x0, y0, c % w, c / w, m - 1), part);
        });
        block_sync();
      }
      if (m - 2 >= z0) {
        // the update of each cell and, with the folded CFL, B on its three
        // +1 faces, each a work item; then the cells' inverse dt. No sync
        // after: the next plane's prim, efield and precursors write no
        // ring array these phases read, and its flux phase comes after
        // three syncs
        const int cells = W * H;
        block_items(fold ? 4 * cells : cells, [&](int t) {
          const int part = t / cells, c = t - part * cells;
          const RingSite<T, M> p(a, x0, y0, c % W, c / W, m - 2, true);
          if (part == 0) {
            if (comp)
              UpdateStage<T, M, true>{a}.at(p);
            else
              UpdateStage<T, M, false>{a}.at(p);
          } else if constexpr (!M::SHEAR) {
            face[(part - 1) * R::PP + p.cell(0, 0)] =
                comp ? folded_face<true>(a, p, part - 1) : folded_face<false>(a, p, part - 1);
          }
        });
        if constexpr (!M::SHEAR) {
          if (fold) {
            block_sync();
            block_phase(W, H, 0, [&](int li, int lj) {
              const RingSite<T, M> p(a, x0, y0, li, lj, m - 2, true);
              inv = pmax(inv, folded_inv_dt(a, p, face));
            });
          }
        }
      }
    }
    block_sync();  // the next item's prim overwrites the ring
  }
  return inv;
}

#ifdef __CUDACC__
template <typename T, typename M>
__global__ void __launch_bounds__(Ring<T>::NT, Tile<T>::PER_SM) zcarry_kernel(ZArgs<T> z) {
  extern __shared__ __align__(16) unsigned char smem[];
  const T inv = run_block<T, M>(z, reinterpret_cast<T*>(smem), blockIdx.x, gridDim.x);
  if (z.inv != nullptr) atomic_max_nonneg(z.inv, inv);
}

template <typename T, typename M>
int resident(int* blocks) {
  int per_sm = 0, dev = 0, sms = 0;
  int err = (int)cudaFuncSetAttribute(zcarry_kernel<T, M>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)Ring<T>::BYTES);
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, zcarry_kernel<T, M>,
                                                            Ring<T>::NT, Ring<T>::BYTES);
  if (!err) err = (int)cudaGetDevice(&dev);
  if (!err) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *blocks = per_sm * sms;
  return err;
}
#endif

// blocks: the persistent grid (ramses_zcarry_mhd_blocks)
template <typename T, typename M>
int zcarry_step(ZArgs<T> z, int blocks, void* stream) {
  using R = Ring<T>;
  const int ntx = (z.a.d.nx + R::TX - 1) / R::TX, nty = (z.a.d.ny + R::TY - 1) / R::TY;
  const int nzc = pick_z_chunks((long long)ntx * nty, blocks, z.a.d.nz);
  z.ntx = ntx;
  z.nty = nty;
  z.bz = (z.a.d.nz + nzc - 1) / nzc;
  z.items = (long long)ntx * nty * ((z.a.d.nz + z.bz - 1) / z.bz);
#ifdef __CUDACC__
  cudaStream_t s = (cudaStream_t)stream;
  int err = z.inv != nullptr ? (int)cudaMemsetAsync(z.inv, 0, sizeof(T), s) : 0;
  if (!err)
    err = (int)cudaFuncSetAttribute(zcarry_kernel<T, M>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)R::BYTES);
  if (err) return err;
  zcarry_kernel<T, M><<<blocks, R::NT, R::BYTES, s>>>(z);
  return (int)cudaGetLastError();
#else
  (void)stream;
  std::vector<T> ring(R::VALUES);  // the serial blocks take turns on one ring
  T inv = T(0);
  for (int b = 0; b < blocks; ++b) inv = pmax(inv, run_block<T, M>(z, ring.data(), b, blocks));
  if (z.inv != nullptr) *z.inv = inv;
  return 0;
#endif
}

// the mode from the inputs, as mhd_step.cu: shear (slabs given), its
// isothermal form (cIso > 0) and stratified (zslabs and gz given, only
// isothermal)
template <typename T, typename F>
int with_mode(const T* slabs, const T* zslabs, const T* gz, const double* prm, const F& f) {
  if (slabs == nullptr) return f(Periodic{});
  if (zslabs != nullptr) {
    if (!(prm[P_CISO] > 0.0) || gz == nullptr) return 1;  // cudaErrorInvalidValue
    return f(Mode<true, true, true>{});
  }
  if (prm[P_CISO] > 0.0) return f(Mode<true, true>{});
  return f(Mode<true, false>{});
}

template <typename T>
int zcarry_entry(const T* S, T* So, int blocks, const T* slabs, T* planes,
                 const T* zslabs, const T* gz, T* inv, const T* dt, const unsigned char* active,
                 int comp, int nx, int ny, int nz, const double* prm, void* stream) {
  ZArgs<T> z;
  StepArgs<T>& a = z.a;
  a.d = make_dims(nx, ny, nz);
  a.ph = make_phys<T>(prm);
  a.S = S;
  a.So = So;
  a.C = comp ? S + 8 * a.d.n : nullptr;
  a.Co = comp ? So + 8 * a.d.n : nullptr;
  a.slabs = slabs;
  a.planes = planes;
  a.zslabs = zslabs;
  a.gz = gz;
  a.dt = dt;
  a.active = active;
  // the folded CFL: periodic mode only (the shear modes keep their launch)
  z.inv = slabs == nullptr ? inv : nullptr;
  return with_mode(slabs, zslabs, gz, prm, [&](auto mode) {
    return zcarry_step<T, decltype(mode)>(z, blocks, stream);
  });
}

}  // namespace ramses::zmhd

extern "C" {

// the bytes of one block's ring in shared memory
long long ramses_zcarry_mhd_ring_bytes(int f64) {
  using namespace ramses::zmhd;
  return f64 ? Ring<double>::BYTES : Ring<float>::BYTES;
}

// the tile of a work item and the threads of a block: out[0] TX, out[1]
// TY, out[2] the threads
void ramses_zcarry_mhd_tile(int f64, int* out) {
  using namespace ramses::zmhd;
  out[0] = f64 ? Tile<double>::TX : Tile<float>::TX;
  out[1] = f64 ? Tile<double>::TY : Tile<float>::TY;
  out[2] = f64 ? Tile<double>::NT : Tile<float>::NT;
}

// the persistent grid of the mode (shear, stratified; isothermal from prm)
// and dtype: as many blocks as the card holds at once (host build: 3, so
// the serial build strides over the items as the blocks do)
int ramses_zcarry_mhd_blocks(int shear, int strat, int f64, const double* prm) {
#ifdef __CUDACC__
  using namespace ramses::zmhd;
  int blocks = 0;
  const auto pick = [&](auto t) {
    using T = decltype(t);
    const T* some = reinterpret_cast<const T*>(prm);  // non-null marks a given input
    return with_mode<T>(shear ? some : nullptr, strat ? some : nullptr, strat ? some : nullptr,
                        prm, [&](auto mode) { return resident<T, decltype(mode)>(&blocks); });
  };
  const int err = f64 ? pick(0.0) : pick(0.0f);
  return err ? -err : blocks;
#else
  (void)shear;
  (void)strat;
  (void)f64;
  (void)prm;
  return 3;
#endif
}

// S: the state [8 or 16][nz][ny][nx] (comp: with its carry), So: its new
// value (another buffer); blocks: the persistent grid
// (ramses_zcarry_mhd_blocks); the shear modes pass slabs and planes (and,
// stratified, zslabs and gz), else null; inv: the folded CFL's output
// (periodic mode), or null
int ramses_zcarry_mhd_f32(const float* S, float* So, int blocks, const float* slabs,
                          float* planes, const float* zslabs, const float* gz, float* inv,
                          const float* dt, const unsigned char* active, int comp, int nx, int ny,
                          int nz, const double* prm, void* stream) {
  return ramses::zmhd::zcarry_entry<float>(S, So, blocks, slabs, planes, zslabs, gz, inv,
                                           dt, active, comp, nx, ny, nz, prm, stream);
}

int ramses_zcarry_mhd_f64(const double* S, double* So, int blocks,
                          const double* slabs, double* planes, const double* zslabs,
                          const double* gz, double* inv, const double* dt,
                          const unsigned char* active, int comp, int nx, int ny, int nz,
                          const double* prm, void* stream) {
  return ramses::zmhd::zcarry_entry<double>(S, So, blocks, slabs, planes, zslabs, gz, inv,
                                            dt, active, comp, nx, ny, nz, prm, stream);
}

}  // extern "C"
