// The block body of one 3D hydro step streamed over z, shared by
// hydro_step.cu (the step kernel: interior mode with any mix of DIRICHLET /
// NEUMANN / PERIODIC faces, and the ghosted modes) and zcarry_hydro.cu (the
// periodic step with the next step's CFL folded in). The per-cell physics
// is hydro_stages.cuh's.
//
// Design (for Hopper):
// - A work item is an (x, y) tile of TX x TY columns and a z chunk
//   [z0, z1). One thread block walks its items' z planes in turn, item
//   after item (a persistent grid: as many blocks as the card holds at
//   once). For each plane p = z0-2 .. z1 of an item it runs, over the
//   tile's cells (W, H: the tile's own extent, smaller at the grid's edge):
//     state (p + 2)   columns -2 .. W+1   copied in by cp.async through
//                                         the load rule
//     prim (p + 1)    -2 .. W+1           Q
//     trace (p)       -1 .. W             q + s and the half slopes along
//                                         x, y, z (20 values): each cell
//                                         is traced once
//     fluxes (p)      0 .. W              the x and y faces of plane p - 1
//                                         and the z faces between p - 1
//                                         and p, one list of items, one
//                                         face (one Riemann solve) each
//     update (p - 1)  0 .. W-1            the new state into So, with the
//                                         folded CFL each cell's inverse dt
//   (rows likewise). The tile's halo columns and rows and the chunk's
//   warm-up planes are computed again by the neighbouring items.
// - Two planes in flight, in two warp groups. The producer (NA threads)
//   runs the state copies, prim and the trace of plane p; the consumer (NB
//   threads) runs the fluxes and the update of the planes before it. Each
//   group meets its own named barrier between its phases; trace planes
//   pass from one to the other through a ring of RP = 3 planes on named
//   barriers (common.cuh Pipe). The consumer releases plane g (EMPTY) once
//   its update of g is done, which also frees state plane g: the producer
//   copies plane g + 5 into that slot only after it.
// - The ring slots of the state, Q and trace planes go by a plane's index
//   in the block's whole walk (g; plane k of the cursor's item has index
//   g + k - p), so the hand-over needs no case at an item's start.
// - The load rule runs once per copied value: the interior mode wraps
//   (PERIODIC), clamps (NEUMANN) or mirrors (DIRICHLET, the copied momentum
//   of that axis negated: prim then gives the velocity the twin's ghost
//   fill gives, bit for bit); the ghosted mode reads its ghost frame at a
//   plain offset. The update reads the state from the ring.
// - Two state buffers: a block reads its neighbours' halo cells, so the
//   step reads S and writes So (a single launch cannot update in place).
// - The host build runs the same per-plane steps of both groups in one
//   serial schedule, the producer as far ahead as the ring allows, so the
//   CPU tests check the ring's plane slots at the widest gap the card can
//   reach.
//
// The tile and groups (measured on the H100 with scripts/torch_ab.py
// hydro; PERF.md section 6): f32 32 x 8, 6 + 13 warps, one block an
// SM (174,480 B of ring); f64 16 x 8, 3 + 13 warps, one block an SM
// (187,680 B). More warps an SM beat the halo's recomputation: f32 16 x 8
// with 3 + 5 warps and two blocks an SM ran 2.84 ms, 32 x 8 with 6 + 13
// 2.36 ms. The producer's state copy and prim fill 75 % (f64 83 %) of its
// threads and its trace 89 % (94 %); the consumer's face items 97 % (98 %),
// its update 62 % (31 %).
#pragma once

#include <cstddef>

#include "cfl_hydro.cuh"
#include "hydro_stages.cuh"

namespace ramses::hydro {

// the (x, y) tile of a work item, the producer's and the consumer's
// threads and the blocks an SM holds, per dtype
template <typename T>
struct Tile;
template <>
struct Tile<float> {
  static constexpr int TX = 32, TY = 8, NA = 192, NB = 416, PER_SM = 1;
};
template <>
struct Tile<double> {
  static constexpr int TX = 16, TY = 8, NA = 96, NB = 416, PER_SM = 1;
};

// a block's ring in shared memory: each array [plane slot][value][cell] on
// its own extent, a cell at tile-local (li, lj) at (lj + lo) * width + li +
// lo (lo: the extent's columns below the tile)
template <typename T>
struct Ring {
  static constexpr int TX = Tile<T>::TX, TY = Tile<T>::TY;
  static constexpr int NA = Tile<T>::NA, NB = Tile<T>::NB, NT = NA + NB;
  static constexpr int PER_SM = Tile<T>::PER_SM;
  static constexpr int RS = 5, RQ = 3, RP = 3;  // plane slots: state, Q, traces
  static constexpr int NTR = 4 * NV;            // a trace: q + s, half slopes along x, y, z
  static constexpr int SW = TX + 4, SPP = SW * (TY + 4);  // state and Q: lo 2
  static constexpr int PW = TX + 2, PPP = PW * (TY + 2);  // traces: lo 1
  static constexpr int FW = TX + 1, FPP = FW * (TY + 1);  // fluxes: lo 0
  // the flux items: x faces (W + 1) x H, y faces W x (H + 1), z faces W x H,
  // laid out FW, TX and TX to a row
  static constexpr int NFX = FW * TY, NFY = TX * (TY + 1), NFZ = TX * TY;
  static constexpr long long OFF_Q = (long long)RS * NV * SPP;
  static constexpr long long OFF_TR = OFF_Q + (long long)RQ * NV * SPP;
  static constexpr long long OFF_F = OFF_TR + (long long)RP * NTR * PPP;
  // Fx, Fy: one plane each; Fz: two
  static constexpr long long VALUES = OFF_F + 4LL * NV * FPP;
  static constexpr long long BYTES = VALUES * (long long)sizeof(T);
  // PER_SM blocks an SM: the rings, the reductions' 32 values
  // (atomic_max_nonneg) and the 1 KB the runtime keeps per block in the
  // SM's 228 KB
  static_assert(PER_SM * (BYTES + 32 * (long long)sizeof(T) + 1024) <= 233472,
                "the rings of PER_SM blocks fit an SM's shared memory");
  static_assert(NA % 32 == 0 && NB % 32 == 0, "the groups are whole warps");
};

template <typename T>
struct ZArgs {
  const T* S;      // the state: interior [5][nz][ny][nx], or ghosted [5][nz+4][ny+4][nx+4]
  T* So;           // its new interior [5][nz][ny][nx] (another buffer)
  T* inv;          // the folded CFL: the max inverse dt of So (zeroed first); null: none
  const T* dt;
  const unsigned char* active;  // 0: the step is skipped (So = the interior of S)
  unsigned long long* newton;   // optional: the sum of the approx solver's iterations
  Dims d;
  bool ghosted;    // S carries a ghost frame of G (else the load rule of bc)
  long long ng;    // cells per channel of S
  int bc[6];       // xmin, xmax, ymin, ymax, zmin, zmax (interior mode)
  HydroPhys<T> ph;
  Phys<T> cfl;     // the folded CFL's constants (cfl_hydro.cuh)
  int ntx, nty, bz;      // tiles along x and y; depth of a z chunk
  long long items;       // ntx * nty * z chunks
  T grav[3];             // the uniform static gravity (the gravity instance)
};

// the planes a block's group walks, item after item: plane p of the item
// whose tile is (x0, y0, W x H) and z chunk [z0, z1) (the planes z0 - 2 ..
// z1), and its index g in the block's whole walk
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
  HD bool first() const { return p == z0 - 2; }
  HD void enter() {
    if (!valid()) return;
    x0 = (int)(item % z.ntx) * R::TX;
    const long long r = item / z.ntx;
    y0 = (int)(r % z.nty) * R::TY;
    z0 = (int)(r / z.nty) * z.bz;
    W = z.d.nx - x0 < R::TX ? z.d.nx - x0 : R::TX;
    H = z.d.ny - y0 < R::TY ? z.d.ny - y0 : R::TY;
    z1 = z.d.nz - z0 < z.bz ? z.d.nz : z0 + z.bz;
    p = z0 - 2;
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

// the primitives of the ring's planes p - 1, p, p + 1, as trace_cell loads
// them: (li, lj) tile-local, k the z plane
template <typename T>
struct RingQ {
  using R = Ring<T>;
  const T* base[3];
  int p;
  HD void load(int li, int lj, int k, T* q) const {
    const T* b = base[k - p + 1] + (lj + 2) * R::SW + li + 2;
#pragma unroll
    for (int ch = 0; ch < NV; ++ch) q[ch] = b[ch * R::SPP];
  }
};

// One block's step on its ring: the producer's and the consumer's part of
// each plane (produce, consume), and the inactive step's copy. GRAV: the
// uniform static gravity (godunov.py:115-160): the trace adds the half-dt
// kick 0.5 dt g to each cell's centred velocities, so all six face states
// of the cell carry it (the twin kicks each face state: the same sum up to
// rounding), and the update adds the conservative source with the
// time-centred momentum from the ring's old state.
template <typename T, bool GRAV = false>
struct Stream {
  using R = Ring<T>;
  const ZArgs<T>& z;
  T* ring;
  T dt, dtdx, dtdy, dtdz;
  T kick[3];  // GRAV: 0.5 dt g
  T inv = T(0);  // the max inverse dt of the cells this thread updated (folded CFL)
  // common.cuh Clocks: producer 0 state copies and prim; 1 the wait for a
  // free plane; 2 the trace and its hand-over. Consumer: 3 the wait for a
  // trace plane; 4 the faces; 5 the update (and folded CFL).
  Clocks clk;

  HD Stream(const ZArgs<T>& z_, T* ring_) : z(z_), ring(ring_) {
    dt = *z.dt;
    dtdx = dt / z.ph.dx;
    dtdy = dt / z.ph.dy;
    dtdz = dt / z.ph.dz;
    if constexpr (GRAV) {
      for (int a = 0; a < 3; ++a) kick[a] = (T(0.5) * dt) * z.grav[a];
    }
  }
  HD T* state(long long w) const { return ring + (w % R::RS) * NV * R::SPP; }
  HD T* prims(long long w) const { return ring + R::OFF_Q + (w % R::RQ) * NV * R::SPP; }
  HD T* traces(long long w) const { return ring + R::OFF_TR + (w % R::RP) * R::NTR * R::PPP; }
  // the fluxes: x and y faces of the plane being updated, z faces below
  // plane w (two slots)
  HD T* flux(int ax, long long w) const {
    return ring + R::OFF_F + (ax < 2 ? ax : 2 + (int)(w % 2)) * NV * R::FPP;
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

  // where the state's (unwrapped) cell (i, j, k) lies (its channel 0), and
  // which of its momenta the load rule negates (flip[a]: a DIRICHLET
  // mirror along axis a)
  HD const T* source(int i, int j, int k, bool* flip) const {
    const Dims& d = z.d;
    flip[0] = flip[1] = flip[2] = false;
    if (z.ghosted)
      return z.S + ((long long)(k + G) * (d.ny + 2 * G) + (j + G)) * (d.nx + 2 * G) + (i + G);
    const int ii = map_axis(i, d.nx, z.bc[0], z.bc[1], flip[0]);
    const int jj = map_axis(j, d.ny, z.bc[2], z.bc[3], flip[1]);
    const int kk = map_axis(k, d.nz, z.bc[4], z.bc[5], flip[2]);
    return z.S + cell_at(d, ii, jj, kk);
  }

  // producer: start the copy of plane k's state (walk index w; columns -2
  // .. W+1, rows likewise) into its slot, the load rule once per cell and
  // its five values
  HD void load(const Cursor<T>& c, const Group& g, int k, long long w) {
    T* dst = state(w);
    cells<R::SW>(g, c.W + 4, c.H + 4, -2, [&](int li, int lj) {
      bool flip[3];
      const T* src = source(c.x0 + li, c.y0 + lj, k, flip);
      T* to = dst + (lj + 2) * R::SW + li + 2;
#pragma unroll
      for (int ch = 0; ch < NV; ++ch) {
        if (ch >= IU && flip[ch - IU])
          to[ch * R::SPP] = -src[ch * z.ng];
        else
          copy_async(to + ch * R::SPP, src + ch * z.ng);
      }
    });
  }
  // producer: the primitives of the plane of walk index w
  HD void prim(const Cursor<T>& c, const Group& g, long long w) {
    const T* s = state(w);
    T* q = prims(w);
    cells<R::SW>(g, c.W + 4, c.H + 4, -2, [&](int li, int lj) {
      const int o = (lj + 2) * R::SW + li + 2;
      prim_cell(z.ph, s + o, R::SPP, q + o, R::SPP);
    });
  }
  // producer: the trace of plane c.p, once per cell: q + s, then the half
  // slopes along x, y, z (what face_state reads)
  HD void trace(const Cursor<T>& c, const Group& g) {
    const RingQ<T> rq{{prims(c.g - 1), prims(c.g), prims(c.g + 1)}, c.p};
    T* out = traces(c.g);
    cells<R::PW>(g, c.W + 2, c.H + 2, -1, [&](int li, int lj) {
      CellTrace<T> t;
      trace_cell(z.ph, rq, li, lj, c.p, dtdx, dtdy, dtdz, t);
      T* o = out + (lj + 1) * R::PW + li + 1;
#pragma unroll
      for (int ch = 0; ch < NV; ++ch) {
        o[ch * R::PPP] = t.q[ch] + t.s[ch];
        if constexpr (GRAV) {
          if (ch >= IU) o[ch * R::PPP] = o[ch * R::PPP] + kick[ch - IU];
        }
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) o[(NV * (1 + ax) + ch) * R::PPP] = t.h[ax][ch];
      }
    });
  }
  // producer: plane c.p (the item's first: the state and primitives of its
  // first two planes before)
  HD void produce(const Cursor<T>& c, const Group& g) {
    if (c.g >= R::RP) Pipe<R::NT>::empty_wait(c.g - R::RP);  // frees traces, state g - 3
    clk.lap(1);
    if (c.first()) {
      load(c, g, c.p, c.g);
      load(c, g, c.p + 1, c.g + 1);
      copy_async_wait();
      g.sync();
      prim(c, g, c.g);
    }
    if (c.p + 2 <= c.z1 + 1) load(c, g, c.p + 2, c.g + 2);
    prim(c, g, c.g + 1);
    g.sync();
    clk.lap(0);
    if (!c.first()) trace(c, g);
    Pipe<R::NT>::full_arrive(c.g);
    copy_async_wait();
    g.sync();  // the next plane's prim reads this copy and overwrites Q this trace read
    clk.lap(2);
  }

  // consumer: the flux through one face (one Riemann solve): item t of the
  // x faces of plane c.p - 1 (xy), its y faces (xy), then the z faces
  // between c.p - 1 and c.p
  HD void face(const Cursor<T>& c, int t, bool xy) {
    int ax, li, lj;
    if (!xy || t >= R::NFX + R::NFY) {
      t -= xy ? R::NFX + R::NFY : 0;
      ax = 2;
      li = t % R::TX;
      lj = t / R::TX;
      if (li >= c.W || lj >= c.H) return;
    } else if (t < R::NFX) {
      ax = 0;
      li = t % R::FW;
      lj = t / R::FW;
      if (li > c.W || lj >= c.H) return;
    } else {
      t -= R::NFX;
      ax = 1;
      li = t % R::TX;
      lj = t / R::TX;
      if (li >= c.W || lj > c.H) return;
    }
    // the traces of the cells left and right of the face
    const T* lo = traces(c.g - 1);
    const int o = (lj + 1) * R::PW + li + 1;
    const T* l = lo + o - (ax == 0 ? 1 : (ax == 1 ? R::PW : 0));
    const T* r = (ax == 2 ? traces(c.g) : lo) + o;
    T qs[NV], h[NV], qm[NV], qp[NV], f[NV];
#pragma unroll
    for (int ch = 0; ch < NV; ++ch) {
      qs[ch] = l[ch * R::PPP];
      h[ch] = l[(NV * (1 + ax) + ch) * R::PPP];
    }
    face_state(z.ph, qs, h, T(1), qm);
#pragma unroll
    for (int ch = 0; ch < NV; ++ch) {
      qs[ch] = r[ch * R::PPP];
      h[ch] = r[(NV * (1 + ax) + ch) * R::PPP];
    }
    face_state(z.ph, qs, h, T(-1), qp);
    const int it = face_flux(z.ph, ax, qm, qp, f);
    if (z.ph.solver == SOLVER_APPROX && z.newton) {
#ifdef __CUDA_ARCH__
      const unsigned mask = __activemask();
      const unsigned total = __reduce_add_sync(mask, (unsigned)it);
      if ((threadIdx.x & 31) == __ffs(mask) - 1) atomicAdd(z.newton, (unsigned long long)total);
#else
      *z.newton += (unsigned long long)it;
#endif
    }
    T* out = flux(ax, c.g) + lj * R::FW + li;
#pragma unroll
    for (int ch = 0; ch < NV; ++ch) out[ch * R::FPP] = f[ch];
  }
  // consumer: the update of plane c.p - 1 from its fluxes and its state in
  // the ring, into So (with the folded CFL: the cell's inverse dt, from the
  // updating thread's registers)
  HD void update(const Cursor<T>& c, const Group& g) {
    const int k = c.p - 1;
    const T* s = state(c.g - 1);
    const T* fx = flux(0, 0);
    const T* fy = flux(1, 0);
    const T* fzl = flux(2, c.g - 1);
    const T* fzr = flux(2, c.g);
    const long long n = z.d.n;
    cells<R::TX>(g, c.W, c.H, 0, [&](int li, int lj) {
      const long long cs = cell_at(z.d, c.x0 + li, c.y0 + lj, k);
      const int so = (lj + 2) * R::SW + li + 2, f = lj * R::FW + li;
      T u[NV];
#pragma unroll
      for (int ch = 0; ch < NV; ++ch) {
        const int cf = ch * R::FPP + f;
        u[ch] = update_value(s[ch * R::SPP + so], fx[cf], fx[cf + 1], fy[cf], fy[cf + R::FW],
                             fzl[cf], fzr[cf], dtdx, dtdy, dtdz);
      }
      if constexpr (GRAV) {
        // godunov.py:145-158: per axis, the energy from the time-centred
        // momentum (before its own source), the momentum from rho_old
        const T rho_old = s[ID * R::SPP + so];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const T mom_half = T(0.5) * (s[(IU + a) * R::SPP + so] + u[IU + a]);
          u[IU + a] = u[IU + a] + dt * rho_old * z.grav[a];
          u[IP] = u[IP] + dt * mom_half * z.grav[a];
        }
      }
#pragma unroll
      for (int ch = 0; ch < NV; ++ch) z.So[ch * n + cs] = u[ch];
      if (z.inv != nullptr) inv = pmax(inv, hydro_inv_dt_cell(z.cfl, z.ph.c_iso, u, 1));
    });
  }
  // consumer: plane c.p's fluxes (from trace planes c.p - 1 and c.p), then
  // the update of c.p - 1; then the release of c.p - 1's trace and state
  HD void consume(const Cursor<T>& c, const Group& g) {
    Pipe<R::NT>::full_wait(c.g);  // (also the group's barrier: its last update is done)
    clk.lap(3);
    if (c.p >= c.z0) {
      const bool xy = c.p > c.z0;  // plane c.p - 1 is the item's
      g.items((xy ? R::NFX + R::NFY : 0) + R::NFZ, [&](int t) { face(c, t, xy); });
      g.sync();
      clk.lap(4);
      if (xy) update(c, g);
    }
    if (c.g >= 1) Pipe<R::NT>::empty_arrive(c.g - 1);
    clk.lap(5);
  }

  // the skipped step: its output is the state's interior (every thread of
  // the block)
  HD void copy(Cursor<T> c, const Group& g) {
    const Dims& d = z.d;
    for (; c.valid(); c.next_item()) {
      for (int k = c.z0; k < c.z1; ++k) {
        cells<R::TX>(g, c.W, c.H, 0, [&](int li, int lj) {
          const int i = c.x0 + li, j = c.y0 + lj;
          const long long cs = cell_at(d, i, j, k);
          const long long src =
              z.ghosted ? ((long long)(k + G) * (d.ny + 2 * G) + (j + G)) * (d.nx + 2 * G) + (i + G)
                        : cs;
          for (int ch = 0; ch < NV; ++ch) z.So[ch * d.n + cs] = z.S[ch * z.ng + src];
          if (z.inv != nullptr) inv = pmax(inv, hydro_inv_dt_cell(z.cfl, z.ph.c_iso, z.S + src,
                                                                   z.ng));
        });
      }
    }
  }
};

// One block's work: its items in turn, on `ring` (its own), by thread tid
// of the block; returns the max inverse dt of the cells this thread
// updated (folded CFL), else 0.
template <typename T, bool GRAV = false>
HD T run_block(const ZArgs<T>& z, T* ring, long long block, long long nblocks, int tid) {
  using R = Ring<T>;
  Stream<T, GRAV> st(z, ring);
  if (!*z.active) {
    st.copy(Cursor<T>(z, block, nblocks), Group{tid, R::NT, 0});
    return st.inv;
  }
#ifdef __CUDA_ARCH__
  st.clk.lap(-1);
  if (tid < R::NA) {
    const Group g{tid, R::NA, BAR_A};
    Cursor<T> c(z, block, nblocks);
    for (; c.valid(); c.next()) st.produce(c, g);
    // the consumer's releases of the last planes, which no copy waits for
    for (long long r = c.g < R::RP ? 0 : c.g - R::RP; r <= c.g - 2; ++r)
      Pipe<R::NT>::empty_wait(r);
#ifdef RAMSES_ZCARRY_CLOCKS
    const long long* t = st.clk.t;
    if (block == 0 && tid == 0)
      printf("[clocks] hydro producer, block 0: %lld planes; cycles: state copies, prim %lld; "
             "wait for a free plane %lld; trace and hand-over %lld\n", c.g, t[0], t[1], t[2]);
#endif
  } else {
    const Group g{tid - R::NA, R::NB, BAR_B};
    long long planes = 0;
    for (Cursor<T> c(z, block, nblocks); c.valid(); c.next(), ++planes) st.consume(c, g);
#ifdef RAMSES_ZCARRY_CLOCKS
    const long long* t = st.clk.t;
    if (block == 0 && tid == R::NA)
      printf("[clocks] hydro consumer, block 0: %lld planes; cycles: wait for a plane %lld; "
             "faces %lld; update (folded CFL) %lld\n", planes, t[3], t[4], t[5]);
#else
    (void)planes;
#endif
  }
#else
  // one serial schedule of both groups' steps, in an order the barriers
  // allow: the consumer's plane g - 2 (which releases plane g - 3's trace
  // and state) just before the producer's plane g
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
// the body of a streamed step kernel of NT threads
template <typename T, bool GRAV = false>
__device__ void stream_block(const ZArgs<T>& z) {
  extern __shared__ __align__(16) unsigned char smem[];
  const T inv =
      run_block<T, GRAV>(z, reinterpret_cast<T*>(smem), blockIdx.x, gridDim.x, threadIdx.x);
  if (z.inv != nullptr) atomic_max_nonneg(z.inv, inv);
}

// the persistent grid of a streamed step kernel: as many blocks as the
// card holds at once
template <typename T, typename K>
int stream_resident(K kernel, int* blocks) {
  int per_sm = 0, dev = 0, sms = 0;
  int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)Ring<T>::BYTES);
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, Ring<T>::NT,
                                                            Ring<T>::BYTES);
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

// One streamed step: the work items of z's grid on `blocks` blocks of
// `kernel` (a __global__ running stream_block; the host build runs the
// blocks in turn on one ring and ignores it).
template <typename T, typename K, bool GRAV = false>
int stream_step(K kernel, ZArgs<T> z, int blocks, void* stream) {
  using R = Ring<T>;
  z.ntx = (z.d.nx + R::TX - 1) / R::TX;
  z.nty = (z.d.ny + R::TY - 1) / R::TY;
  z.bz = chunk_depth<T>(z.d.nx, z.d.ny, z.d.nz, blocks);
  z.items = (long long)z.ntx * z.nty * ((z.d.nz + z.bz - 1) / z.bz);
#ifdef __CUDACC__
  cudaStream_t s = (cudaStream_t)stream;
  int err = z.inv != nullptr ? (int)cudaMemsetAsync(z.inv, 0, sizeof(T), s) : 0;
  if (!err)
    err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)R::BYTES);
  if (err) return err;
  kernel<<<blocks, R::NT, R::BYTES, s>>>(z);
  return (int)cudaGetLastError();
#else
  (void)kernel;
  (void)stream;
  std::vector<T> ring(R::VALUES);  // the serial blocks take turns on one ring
  T inv = T(0);
  for (int b = 0; b < blocks; ++b)
    inv = pmax(inv, run_block<T, GRAV>(z, ring.data(), b, blocks, 0));
  if (z.inv != nullptr) *z.inv = inv;
  return 0;
#endif
}

// the arguments of a step of the nx x ny x nz state S (ghosted: with its
// ghost frame of G) into So
template <typename T>
ZArgs<T> stream_args(const T* S, T* So, T* inv, const T* dt, const unsigned char* active,
                     unsigned long long* newton, int nx, int ny, int nz, bool ghosted,
                     const int* bc, const double* prm) {
  ZArgs<T> z;
  z.S = S;
  z.So = So;
  z.inv = inv;
  z.dt = dt;
  z.active = active;
  z.newton = newton;
  z.d = make_dims(nx, ny, nz);
  z.ghosted = ghosted;
  z.ng = ghosted ? (long long)(nx + 2 * G) * (ny + 2 * G) * (nz + 2 * G) : z.d.n;
  for (int b = 0; b < 6; ++b) z.bc[b] = bc[b];
  z.ph = make_hydro_phys<T>(prm);
  z.cfl = make_phys<T>(prm);
  for (int a = 0; a < 3; ++a) z.grav[a] = T(prm[P_GX + a]);
  return z;
}

}  // namespace ramses::hydro
