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
// Design (for Hopper):
// - A work item is an (x, y) tile of TX x TY columns and a z chunk
//   [z0, z1). One thread block walks its items' z planes in turn, item
//   after item. Each plane m runs these phases over the tile's cells:
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
//   edge). The tile's halo columns and rows and the chunk's warm-up
//   planes are computed again by the neighbouring items.
// - Two planes in flight, in two warp groups. The producer (NA threads)
//   runs the state loads, prim, efield and the precursors of one plane;
//   the consumer (NB threads) runs the fluxes, EMFs and the update of the
//   planes before it (with the folded CFL: each cell's +1 faces and its
//   inverse dt by the thread that updates it, from its registers). Each
//   group meets its own named barrier between its phases; the precursor
//   planes pass from one to the other through a ring of RP = 3 planes and
//   named barriers, not block-wide ones (common.cuh Pipe): the producer may
//   write precursor plane g once the consumer is done with plane g - 3, so
//   it writes plane g while the consumer forms the fluxes of g - 1 from
//   g - 1 and g - 2.
// - The state is loaded early: while a plane computes, the producer copies
//   plane m + 2's state (8 channels on the tile and a halo of 2 below and
//   3 above; the shear and stratified modes through the slabs' load rule)
//   into its ring slot with cp.async, so prim and the stages after it read
//   the state from shared memory only.
// - The ring keeps of each array only the planes a later phase reads, each
//   on its own extent (the columns and rows its readers reach):
//     state   5 planes (m - 2 .. m + 2)   8 values   (W + 5) x (H + 5)
//     Q       3 planes (m - 2 .. m)       8          (W + 4) x (H + 4)
//     E       2 planes                    3          (W + 3) x (H + 3)
//     precursors  3 planes                NPRE = 48  (W + 2) x (H + 2)
//     fluxes, EMFs  2 planes              15 + 3     (W + 1) x (H + 1)
//   The tile: f32 16 x 8 (197,448 B; one block of 256 + 256 threads per
//   SM: prim, efield and the precursors fill 94, 82 and 70 % of the
//   producer's threads, the flux items 90 % of the consumer's); f64 8 x 8
//   (226,064 B, 64 + 192 threads). The grid is persistent: as many blocks
//   as the card holds at once, each striding over the work items, so
//   nothing grows with nz.
// - The host build runs the same per-plane steps of both groups in one
//   serial schedule, the producer two planes ahead of the consumer (the
//   most the ring allows), so the CPU tests check the ring's plane slots
//   as the card uses them at the widest gap.
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
// per cell; the halo recomputation adds 1.41x the precursors' cells and
// 1.20x the fluxes' at the f32 tile.
#include "cfl_mhd.cuh"
#include "mhd_stages.cuh"

namespace ramses::zmhd {

using namespace ramses::mhd;

// the (x, y) tile of a work item and the threads of its producer and
// consumer groups, per dtype
template <typename T>
struct Tile;
template <>
struct Tile<float> {
  static constexpr int TX = 16, TY = 8, NA = 256, NB = 256;
};
template <>
struct Tile<double> {
  static constexpr int TX = 8, TY = 8, NA = 64, NB = 192;
};

// a block's ring in shared memory: each array [channel][plane slot][cell]
// (the precursors [plane slot][NPRE][cell]) on its own extent, a cell at
// tile-local (li, lj) at (lj + lo) * width + li + lo
template <typename T>
struct Ring {
  static constexpr int TX = Tile<T>::TX, TY = Tile<T>::TY;
  static constexpr int NA = Tile<T>::NA, NB = Tile<T>::NB, NT = NA + NB;
  static constexpr int RS = 5, RQ = 3, RE = 2, RP = 3, RF = 2;  // plane slots
  static constexpr int SW = TX + 5, QW = TX + 4, EW = TX + 3, PW = TX + 2, FW = TX + 1;
  static constexpr int SPP = SW * (TY + 5), QPP = QW * (TY + 4), EPP = EW * (TY + 3);
  static constexpr int PPP = PW * (TY + 2), FPP = FW * (TY + 1);
  // a flux part's work items: its cells, rounded up to whole warps (a warp
  // then runs one part's code)
  static constexpr int FPART = (FPP + 31) / 32 * 32;
  static constexpr long long OFF_Q = 8LL * RS * SPP;
  static constexpr long long OFF_E = OFF_Q + 8LL * RQ * QPP;
  static constexpr long long OFF_PRE = OFF_E + 3LL * RE * EPP;
  static constexpr long long OFF_F = OFF_PRE + (long long)NPRE * RP * PPP;
  static constexpr long long OFF_EMF = OFF_F + 3LL * NFLUX * RF * FPP;
  static constexpr long long VALUES = OFF_EMF + 3LL * RF * FPP;
  static constexpr long long BYTES = VALUES * (long long)sizeof(T);
  // one block an SM: the ring, the reduction's 32 values (atomic_max_nonneg)
  // and the 1 KB the runtime keeps per block in the SM's 228 KB
  static_assert(BYTES + 32 * (long long)sizeof(T) + 1024 <= 233472,
                "the ring of a block fits an SM's shared memory");
  static_assert(BYTES + 32 * (long long)sizeof(T) <= SMEM_LIMIT,
                "the ring and the reduction's 32 values fit a block");
  static_assert(NA % 32 == 0 && NB % 32 == 0, "the groups are whole warps");
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
// neighbours' intermediates and state are ring cells of each array's
// planes (the state: loaded into the ring through the load rule, Stream
// load). The precursor planes take their slots by their index in the
// block's walk, k + walk (the hand-over counts planes so, Pipe), the
// other arrays by k.
template <typename T, typename M>
struct RingSite {
  using R = Ring<T>;
  const StepArgs<T>& a;
  int i, j, k, li, lj;
  // the plane slots of k - 1, k, k + 1: the state, Q, and the 2-plane
  // arrays (E, fluxes, EMFs); the precursors' of k - 1, k
  int ss[3], sq[3], s2[3], sp[2];
  long long cs;      // on_state: the state's index of (i, j, k)
  const T* pb[2];    // this cell's precursors in the planes k, k - 1
  const T* sb[3];    // this cell's state in the planes k - 1, k, k + 1

  HD RingSite(const StepArgs<T>& a_, int x0, int y0, int li_, int lj_, int m, int walk,
              bool on_state)
      : a(a_), i(x0 + li_), j(y0 + lj_), k(m), li(li_), lj(lj_) {
    const int s0 = mod_n(m, R::RS);
    ss[0] = s0 == 0 ? R::RS - 1 : s0 - 1;
    ss[1] = s0;
    ss[2] = s0 == R::RS - 1 ? 0 : s0 + 1;
    const int q0 = mod_n(m, R::RQ);
    sq[0] = q0 == 0 ? R::RQ - 1 : q0 - 1;
    sq[1] = q0;
    sq[2] = q0 == R::RQ - 1 ? 0 : q0 + 1;
    s2[1] = m & 1;
    s2[0] = s2[2] = 1 - s2[1];
    sp[1] = mod_n(m + walk, R::RP);
    sp[0] = sp[1] == 0 ? R::RP - 1 : sp[1] - 1;
    cs = on_state ? cell_at(a.d, i, j, k) : 0;
    pb[0] = a.pre + sp[1] * NPRE * R::PPP + cell(0, 0, 1, R::PW);
    pb[1] = a.pre + sp[0] * NPRE * R::PPP + cell(0, 0, 1, R::PW);
#pragma unroll
    for (int d = 0; d < 3; ++d) sb[d] = a.Se + ss[d] * R::SPP + cell(0, 0, 2, R::SW);
  }
  // the neighbour (di, dj)'s cell in an array whose extent starts lo
  // cells below the tile and whose rows are w wide
  HD int cell(int di, int dj, int lo, int w) const { return (lj + dj + lo) * w + li + di + lo; }
  HD long long iq(int di, int dj, int dk) const { return sq[dk + 1] * R::QPP + cell(di, dj, 2, R::QW); }
  HD long long ie(int di, int dj, int dk) const { return s2[dk + 1] * R::EPP + cell(di, dj, 1, R::EW); }
  HD long long iflux(int di, int dj, int dk) const {
    return s2[dk + 1] * R::FPP + cell(di, dj, 0, R::FW);
  }
  // precursor v of this cell (the precursor stage's output) and of the
  // neighbour (di, dj, dk), dk = 0 or -1
  HD long long ipre(int v) const { return (pb[0] - a.pre) + v * R::PPP; }
  HD T pre(int v, int di, int dj, int dk) const {
    return pb[-dk][v * R::PPP + dj * R::PW + di];
  }
  HD long long cq() const { return iq(0, 0, 0); }
  HD long long ce() const { return ie(0, 0, 0); }
  HD long long cflux() const { return iflux(0, 0, 0); }
  HD long long nq() const { return R::RQ * R::QPP; }
  HD long long ne() const { return R::RE * R::EPP; }
  HD long long nflux() const { return R::RF * R::FPP; }
  // the state is in the ring already
  HD void keep_state(const T*) const {}
  HD T s(int ch, int di, int dj, int dk) const {
    return sb[dk + 1][ch * R::RS * R::SPP + dj * R::SW + di];
  }
  HD T src(int ch, int di, int dj, int dk) const { return s(ch, di, dj, dk); }
  HD T xpos() const { return a.ph.xpos0 + r_mul(T(i), a.ph.dx); }
  HD T gz() const { return a.gz[k + SLAB]; }
};

// where the state's channel ch at the (unwrapped) cell (i, j, k) lies: the
// periodic wrap, or the shear modes' load rule (as mhd_step.cu's Site src)
template <typename T, typename M>
HD const T* state_at(const StepArgs<T>& a, int ch, int i, int j, int k) {
  const int jj = wrap_any(j, a.d.ny);
  if constexpr (M::SHEAR) {
    return at_shear<T, M>(a, ch, i, jj, M::STRAT ? k : wrap_any(k, a.d.nz));
  } else {
    return a.S + ch * a.d.n + cell_at(a.d, wrap_any(i, a.d.nx), jj, wrap_any(k, a.d.nz));
  }
}

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

// the folded CFL of a state cell after its update: its new channels u and
// B on its +1 x, y, z faces (folded_face) through inv_dt_cell
template <typename T>
HD T folded_inv_dt(const Phys<T>& ph, const T* u, const T* face) {
  // channel ch of the cell at v[3 ch]; By at +1 y: v[3 IB + 1]; Bz at +1
  // z: v[3 IC + 2]
  T v[8 * 3];
#pragma unroll
  for (int ch = 0; ch < 8; ++ch) v[3 * ch] = u[ch];
  v[3 * IB + 1] = face[1];
  v[3 * IC + 2] = face[2];
  return inv_dt_cell<T, false>(ph, v, 3, 0, face[0], 1, 2);
}

// the precursor planes a block's group walks, item after item: plane p of
// the item whose tile is (x0, y0, W x H) and z chunk [z0, z1) (the planes
// z0 - 1 .. z1), and its index g in the block's whole walk
template <typename T>
struct Cursor {
  using R = Ring<T>;
  const ZArgs<T>& z;
  long long item, stride, g = 0;
  int x0 = 0, y0 = 0, z0 = 0, z1 = 0, W = 0, H = 0, p = 0;

  HD Cursor(const ZArgs<T>& z_, long long block, long long nblocks)
      : z(z_), item(block), stride(nblocks) {
    enter();
  }
  HD bool valid() const { return item < z.items; }
  HD bool first() const { return p == z0 - 1; }
  HD void enter() {
    if (!valid()) return;
    const Dims& d = z.a.d;
    x0 = (int)(item % z.ntx) * R::TX;
    const long long r = item / z.ntx;
    y0 = (int)(r % z.nty) * R::TY;
    z0 = (int)(r / z.nty) * z.bz;
    W = d.nx - x0 < R::TX ? d.nx - x0 : R::TX;
    H = d.ny - y0 < R::TY ? d.ny - y0 : R::TY;
    z1 = d.nz - z0 < z.bz ? d.nz : z0 + z.bz;
    p = z0 - 1;
  }
  HD void next() {
    ++g;
    if (++p > z1) next_item();
  }
  HD void next_item() {
    item += stride;
    enter();
  }
};

// The phases of common.cuh Clocks here: producer 0 state loads, prim,
// efield; 1 the wait for a free precursor plane; 2 the precursors and their
// hand-over. Consumer: 3 the wait for a precursor plane; 4 fluxes and EMFs;
// 5 the update (and folded CFL).

// One block's step on its ring: the producer's and the consumer's part of
// each precursor plane (produce, consume), and the inactive step's copy.
template <typename T, typename M>
struct Stream {
  using R = Ring<T>;
  StepArgs<T> a;
  bool fold, comp;
  T inv = T(0);  // the max inverse dt of the cells this thread updated (folded CFL)
  Clocks clk;

  HD Stream(const ZArgs<T>& z, T* ring) : a(z.a), fold(z.inv != nullptr) {
    a.Se = ring;  // the state's planes
    a.Q = ring + R::OFF_Q;
    a.E = ring + R::OFF_E;
    a.pre = ring + R::OFF_PRE;
    a.fl = ring + R::OFF_F;
    a.emf = ring + R::OFF_EMF;
    comp = a.C != nullptr;
  }
  // f(li, lj) on the tile's columns lo .. lo + w - 1 and rows lo .. lo + h
  // - 1, the items laid out WMAX (>= w) to a row: a division by a constant
  template <int WMAX, typename F>
  HD static void cells(const Group& g, int w, int h, int lo, const F& f) {
    g.items(WMAX * h, [&](int t) {
      const int li = t % WMAX;
      if (li < w) f(lo + li, lo + t / WMAX);
    });
  }
  HD RingSite<T, M> site(const Cursor<T>& c, int li, int lj, int m, bool on_state = false) const {
    return RingSite<T, M>(a, c.x0, c.y0, li, lj, m, (int)(c.g - c.p), on_state);
  }

  // producer: start the copy of plane k's state (columns -2 .. W+2, rows
  // likewise) into its ring slot
  HD void load(const Cursor<T>& c, const Group& g, int k) {
    T* dst = a.Se + mod_n(k, R::RS) * R::SPP;
    const int rows = c.H + 5;
    g.items(8 * rows * R::SW, [&](int t) {
      const int r = t / R::SW, li = t - r * R::SW - 2;
      const int ch = r / rows, lj = r - ch * rows - 2;
      if (li <= c.W + 2)
        copy_async(dst + ch * R::RS * R::SPP + (lj + 2) * R::SW + li + 2,
                   state_at<T, M>(a, ch, c.x0 + li, c.y0 + lj, k));
    });
  }
  // producer: prim and (past the first warm-up plane) efield of plane m;
  // first the copy of plane m + 2 (prim reads m + 1's Bz)
  HD void prim_efield(const Cursor<T>& c, const Group& g, int m) {
    if (m + 2 <= c.z1 + 2) load(c, g, m + 2);
    cells<R::QW>(g, c.W + 4, c.H + 4, -2,
                 [&](int li, int lj) { PrimStage<T, M>{a}.at(site(c, li, lj, m)); });
    if (m >= c.z0 - 1) {
      g.sync();
      cells<R::EW>(g, c.W + 3, c.H + 3, -1,
                   [&](int li, int lj) { EFieldStage<T, M>{a}.at(site(c, li, lj, m)); });
    }
  }
  // producer: precursor plane c.p (the item's first: after the warm-up
  // planes z0 - 2, z0 - 1 and their state)
  HD void produce(const Cursor<T>& c, const Group& g) {
    if (c.first()) {
      load(c, g, c.z0 - 2);
      load(c, g, c.z0 - 1);
      copy_async_wait();
      g.sync();
      for (int m = c.z0 - 2; m < c.z0; ++m) {
        prim_efield(c, g, m);
        copy_async_wait();
        g.sync();
      }
    }
    prim_efield(c, g, c.p + 1);
    g.sync();
    clk.lap(0);
    if (c.g >= R::RP) Pipe<R::NT>::empty_wait(c.g - R::RP);
    clk.lap(1);
    cells<R::PW>(g, c.W + 2, c.H + 2, -1,
                 [&](int li, int lj) { PrecursorStage<T, M>{a}.at(site(c, li, lj, c.p)); });
    Pipe<R::NT>::full_arrive(c.g);
    copy_async_wait();
    g.sync();  // the next plane's prim overwrites the Q and state this plane read
    clk.lap(2);
  }
  // consumer: the fluxes and EMFs of plane q = c.p, from precursor planes
  // q and q - 1 (each part's items a whole number of warps), then the
  // update of plane q - 1 (with the folded CFL: B on each cell's +1 faces
  // and its inverse dt, by the same thread, from its registers)
  HD void consume(const Cursor<T>& c, const Group& g) {
    clk.lap(5);
    Pipe<R::NT>::full_wait(c.g);  // (also the group's barrier: its last update is done)
    clk.lap(3);
    const int q = c.p;
    if (!c.first()) {
      g.items(6 * R::FPART, [&](int t) {
        const int part = t / R::FPART, cc = t - part * R::FPART;
        const int li = cc % R::FW, lj = cc / R::FW;
        if (cc < R::FPP && li <= c.W && lj <= c.H)
          FluxEmf<T, M>{a}.part(site(c, li, lj, q), part);
      });
      g.sync();
    }
    clk.lap(4);
    if (c.g >= 1) Pipe<R::NT>::empty_arrive(c.g - 1);
    if (c.first() || q - 1 < c.z0) return;
    cells<R::TX>(g, c.W, c.H, 0, [&](int li, int lj) {
      const RingSite<T, M> p = site(c, li, lj, q - 1, true);
      if (comp)
        update<true>(p);
      else
        update<false>(p);
    });
  }
  // the update of the state cell p and, with the folded CFL, its inverse dt
  // (the faces first: their loads then overlap the update's)
  template <bool COMP>
  HD void update(const RingSite<T, M>& p) {
    if constexpr (!M::SHEAR) {
      if (fold) {
        const T face[3] = {folded_face<COMP>(a, p, 0), folded_face<COMP>(a, p, 1),
                           folded_face<COMP>(a, p, 2)};
        T u[8];
        UpdateStage<T, M, COMP>{a}.at(p, u);
        inv = pmax(inv, folded_inv_dt(a.ph, u, face));
        return;
      }
    }
    UpdateStage<T, M, COMP>{a}.at(p);
  }
  // the skipped step: its output is its input (every thread of the block)
  HD void copy(Cursor<T> c, const Group& g) {
    for (; c.valid(); c.next_item()) {
      for (int k = c.z0; k < c.z1; ++k) {
        cells<R::TX>(g, c.W, c.H, 0, [&](int li, int lj) {
          const long long cs = cell_at(a.d, c.x0 + li, c.y0 + lj, k);
          for (int ch = 0; ch < 8; ++ch) {
            a.So[ch * a.d.n + cs] = a.S[ch * a.d.n + cs];
            if (comp) a.Co[ch * a.d.n + cs] = a.C[ch * a.d.n + cs];
          }
          if (fold) inv = pmax(inv, inv_dt_at<T, false>(a.ph, a.d, a.S, nullptr, cs));
        });
      }
    }
  }
};

// One block's work: its items in turn, on `ring` (its own), by thread tid
// of the block; returns the max inverse dt of the cells this thread
// updated (folded CFL), else 0.
template <typename T, typename M>
HD T run_block(const ZArgs<T>& z, T* ring, long long block, long long nblocks, int tid) {
  using R = Ring<T>;
  Stream<T, M> st(z, ring);
  if (!*z.a.active) {
    st.copy(Cursor<T>(z, block, nblocks), Group{tid, R::NT, 0});
    return st.inv;
  }
#ifdef __CUDA_ARCH__
  st.clk.lap(-1);
  if (tid < R::NA) {
    const Group g{tid, R::NA, BAR_A};
    Cursor<T> c(z, block, nblocks);
    for (; c.valid(); c.next()) st.produce(c, g);
    // the consumer's releases of the last planes, which no write waits for
    for (long long r = c.g < R::RP ? 0 : c.g - R::RP; r <= c.g - 2; ++r)
      Pipe<R::NT>::empty_wait(r);
#ifdef RAMSES_ZCARRY_CLOCKS
    const long long* t = st.clk.t;
    if (block == 0 && tid == 0)
      printf("[clocks] producer, block 0: %lld precursor planes; cycles: loads, prim, efield "
             "%lld; wait for a free plane %lld; precursors and hand-over %lld\n",
             c.g, t[0], t[1], t[2]);
#endif
  } else {
    const Group g{tid - R::NA, R::NB, BAR_B};
    long long planes = 0;
    for (Cursor<T> c(z, block, nblocks); c.valid(); c.next(), ++planes) st.consume(c, g);
    st.clk.lap(5);
#ifdef RAMSES_ZCARRY_CLOCKS
    const long long* t = st.clk.t;
    if (block == 0 && tid == R::NA)
      printf("[clocks] consumer, block 0: %lld precursor planes; cycles: wait for a plane "
             "%lld; fluxes, EMFs %lld; update (folded CFL) %lld\n", planes, t[3], t[4], t[5]);
#else
    (void)planes;
#endif
  }
#else
  // one serial schedule of both groups' steps, in an order the barriers
  // allow: the consumer's plane g - 2 (which releases g - 3) just before
  // the producer's plane g
  (void)tid;
  const Group g{0, 1, 0};
  Cursor<T> ca(z, block, nblocks), cb(z, block, nblocks);
  while (ca.valid() || cb.valid()) {
    if (cb.valid() && (!ca.valid() || ca.g >= cb.g + R::RP - 1)) {
      st.consume(cb, g);
      cb.next();
    } else {
      st.produce(ca, g);
      ca.next();
    }
  }
#endif
  return st.inv;
}

#ifdef __CUDACC__
template <typename T, typename M>
__global__ void __launch_bounds__(Ring<T>::NT, 1) zcarry_kernel(ZArgs<T> z) {
  extern __shared__ __align__(16) unsigned char smem[];
  const T inv = run_block<T, M>(z, reinterpret_cast<T*>(smem), blockIdx.x, gridDim.x, threadIdx.x);
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

// the depth of a z chunk on a grid for a persistent grid of `blocks`
template <typename T>
int chunk_depth(int nx, int ny, int nz, int blocks) {
  using R = Ring<T>;
  const int ntx = (nx + R::TX - 1) / R::TX, nty = (ny + R::TY - 1) / R::TY;
  const int nzc = pick_z_chunks((long long)ntx * nty, blocks, nz);
  return (nz + nzc - 1) / nzc;
}

// blocks: the persistent grid (ramses_zcarry_mhd_blocks)
template <typename T, typename M>
int zcarry_step(ZArgs<T> z, int blocks, void* stream) {
  using R = Ring<T>;
  z.ntx = (z.a.d.nx + R::TX - 1) / R::TX;
  z.nty = (z.a.d.ny + R::TY - 1) / R::TY;
  z.bz = chunk_depth<T>(z.a.d.nx, z.a.d.ny, z.a.d.nz, blocks);
  z.items = (long long)z.ntx * z.nty * ((z.a.d.nz + z.bz - 1) / z.bz);
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
  for (int b = 0; b < blocks; ++b) inv = pmax(inv, run_block<T, M>(z, ring.data(), b, blocks, 0));
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
// TY, out[2] the threads, out[3] the producer group's, out[4] the
// consumer group's
void ramses_zcarry_mhd_tile(int f64, int* out) {
  using namespace ramses::zmhd;
  out[0] = f64 ? Tile<double>::TX : Tile<float>::TX;
  out[1] = f64 ? Tile<double>::TY : Tile<float>::TY;
  out[3] = f64 ? Tile<double>::NA : Tile<float>::NA;
  out[4] = f64 ? Tile<double>::NB : Tile<float>::NB;
  out[2] = out[3] + out[4];
}

// the depth of the z chunks a step on an nx x ny x nz grid takes with a
// persistent grid of `blocks`
int ramses_zcarry_mhd_chunk_depth(int f64, int nx, int ny, int nz, int blocks) {
  using namespace ramses::zmhd;
  return f64 ? chunk_depth<double>(nx, ny, nz, blocks) : chunk_depth<float>(nx, ny, nz, blocks);
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
