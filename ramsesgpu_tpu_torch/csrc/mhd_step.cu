// One unsplit MUSCL-Hancock step of 3D ideal MHD with constrained
// transport (HLLD face fluxes, 2D-HLLD corner EMFs; or, in each mode's
// general instance, the face solver HLLD, LLF or HLL and the corner solver
// 2D-HLLD, HLLA, HLLF or LLF that the parameter block names: the JAX
// dispatch of godunov_mhd.py:226 mhd_fluxes_emfs_from_parts through
// ops/riemann_mhd.py riemann_mhd and compute_emf), in five modes:
//
// - periodic: the fully periodic state. Replaces the TPU kernel
//   ramsesgpu_tpu/pallas/packed_io.py:148 make_packed_io_step with the
//   MHD body pallas/fused_mhd3d.py:228 -> solvers/godunov_mhd.py:437
//   mhd_3d_interior_update_staged. Plain twin:
//   ramsesgpu_tpu_torch/solvers/godunov_mhd.py mhd_3d_periodic_update.
//   With cIso > 0 (the turbulence inputs, isothermal Orszag-Tang) its
//   isothermal instance runs (Mode<false, true>, mhd_stages.cuh
//   PeriodicIso: the solvers read rho cIso^2 as the gas pressure), chosen
//   at launch from the parameter block, plain or compensated; the ghosted
//   mode below has its isothermal instance likewise (GhostedIso). The
//   adiabatic instances are the code earlier builds ran.
// - shearing box: the rotating frame (Coriolis half-kick, the shear terms
//   of the trace and of the x and z EMFs, per-column x), the isothermal
//   EOS (cIso > 0) or the adiabatic one, sheared-periodic x faces, y and z
//   periodic. Replaces the MRI main kernel shear_packed.py:89
//   _make_main_kernel and the border strip kernel shear_packed.py:237
//   _make_strip_kernel (mode "godunov"): the TPU strip exists because
//   x-ghost-free lane-exact rows cannot hold ghost columns; here an x
//   load outside [0, nx) reads the sheared ghost slabs (built each step
//   by shear_border.cu), and the stages' x extent grows just enough for
//   the faces and edges 0..nx, so every face is computed once. The update
//   writes the unremapped x-face planes (density flux at faces 0 and nx,
//   emfY there, emfZ at face nx) that shear_border.cu remaps. Plain twin:
//   solvers/godunov_mhd.py mhd_3d_shear_update.
// - stratified (the shear mode with BC_Z_STRATIFIED z faces and the static
//   vertical gravity; isothermal): replaces the MRI main kernel with its
//   gravity_z aux plane (shear_packed.py:89, :117-131) and the strip's
//   gravity. A z load outside [0, nz) reads the stratified z slabs
//   (shear_border.cu ZSlabBuild, whose x extent covers the x slabs'
//   columns), the stage grid grows by ZH rows on each z side as it does by
//   XH columns in x, the traced states get the half-dt kick of g_z and the
//   update the conservative source with the time-centred momentum
//   (godunov_mhd.py:213-218, 375-413). g_z comes in per z row, ghost rows
//   included (the run's gravity field column).
// - ghosted: a ghosted state U[8][nz+2g][ny+2g][nx+2g] whose ghosts some
//   fill has written (walls of any DIRICHLET / NEUMANN / PERIODIC mix, the
//   inflow jet), updated in place. Replaces the TPU kernel
//   pallas/fused_mhd3d.py:80 make_fused_mhd_update (pallas_call at :173),
//   with the semantics of the JAX whole-array step it stands for
//   (godunov_mhd.py:596-744): every stage runs on the whole ghosted array
//   as on a periodic box of its extent (the rolls of that step: a +1 face
//   of the last ghost layer wraps to the first), loads are plain offsets
//   into U with no load rule, the update adds the flux divergence to the
//   interior and the CT curl to the cube g .. n + g of every axis, so the
//   max-side face layer (Bx[nx+g], By[ny+g], Bz[nz+g] and the rest of that
//   layer) changes too, as the reference C++'s CT range does
//   (mhd_ct_update.cuh:124-213). The stage grid is the ghosted array: the
//   outer edges of that CT layer read the last ghost layer's primitives,
//   whose +1 face wraps, so a grid of the interior plus 2 cells could not
//   give that step's values there. A uniform static gravity (the
//   parameter block's P_GX .. P_GZ) selects its gravity instance
//   (GhostedGrav, GhostedIsoGrav): the half-dt kick of every traced state
//   and the conservative source of the interior, a constant vector in the
//   launch's arguments. Plain twin:
//   solvers/godunov_mhd.py mhd_3d_ghosted_update.
// - shear window (Mode<true, ISO, STRAT, true>): one rank's block of the
//   sharded shearing box. Replaces the TPU kernel pallas/fused_mhd3d.py:587
//   make_fused_mhd_shear (pallas_call at :691), whose body is
//   solvers/godunov_mhd.py:294 mhd_3d_interior_update(params, U, dt,
//   margin=(g, g, g), shear_planes=True, xpos=..., gravity=...). Input: a
//   ghosted window U[8][nz+2g][ny+2g][nx+2g] whose ghosts the halo exchange
//   and the sheared x fill have written (parallel/shear_dist.py); x0, the
//   window's global x offset, travels as prm[P_XMIN], so column i's centre
//   is x0 + dx/2 + i dx; g_z of the window's rows (from its z offset z0)
//   comes in gz[nz + 2g] when stratified. Output, out of place: the new
//   interior [8][nz][ny][nx] and the five planes of the remap, [5][nz][ny]
//   in the order fpl[0], fpl[1], eypl[0], eypl[1], ezpl. Not the ghosted
//   mode's whole-array semantics: nothing wraps, only the interior is
//   written, and the CT face layer n+g is left to the next exchange.
//   Stage grid: the interior and WH = 2 cells beyond each face of every
//   axis. The update of the interior reads fluxes and EMFs on cells 0..n
//   of each axis; those read the traced states on -1..n; the trace reads
//   the primitives on -2..n+1 and the edge fields on -1..n+1, which read
//   the primitives on -2..n+1 too; prim at cell n+1 reads the state at
//   n+2. So primitives are needed on -2..n+1, the grid's extent, and every
//   state load (at most 1 past a stage cell) lies within the window when
//   g >= 3. The grid's other cells read clamped neighbours and are never
//   read themselves. With g = 3 the TPU kernel's window (n + 6 per axis)
//   is one cell larger on each side than this grid. Plain twin:
//   solvers/godunov_mhd.py mhd_3d_shear_window_update.
// - compensated (the periodic and shear modes; TPU row A'-compensated,
//   fused_mhd3d.py:247-259):
//   S holds 16 channels, the state and then its Kahan carry; the update
//   stage Kahan-adds each channel's increment (and chains the gravity
//   source through the carry), every operation of that stage rounded on
//   its own with intrinsics (r_mul, r_add, r_sub), so on the same fluxes
//   and EMFs it repeats the twin's roundings exactly. The file keeps FMA
//   contraction elsewhere: -fmad=false on the whole file costs the plain
//   periodic step ~1 % (PERF.md), the intrinsics cost the plain modes
//   nothing (their update stage is another instantiation).
//
// Layout: the interior-only state S[8][nz][ny][nx], x fastest
// (common.cuh). Neighbours wrap by index in y and z (and in x, periodic
// mode), so the TPU layout's 8-row y ghost bands and in-kernel ghost band
// writes have no counterpart: pack is a slice, unpack the ghost fill.
//
// Design: five stages; prim, efield, the precursors and the update run one
// thread per cell, the fused flux + EMF stage one block per tile; the
// intermediates live in one scratch buffer the Python wrapper allocates
// once per advance:
//   1 prim      S -> Q[8]           constoprim, cell-centred B
//   2 efield    Q, S -> E[3]        edge-centred Ex, Ey, Ez of the trace
//   3 precursor Q, S, E -> pre[48]  the trace up to what its 18 face / edge
//                                    states are formed from: q2, the
//                                    half-slopes of Q, the half-step face
//                                    fields and their transverse
//                                    half-slopes (mhd_stages.cuh PQ ... PKICK)
//   4 flux+EMF  pre -> fl[3][5],    HLLD flux at each cell's left x/y/z face,
//               emf[3]              2D-HLLD EMF on its z, y, x edges (the
//                                    general instances: the block's solvers)
//   5 update    S += dU, CT curl    in place (reads only fluxes, EMFs and the
//                                    cell's own S)
// No traced state is stored: each of the 18 is a sum of a few precursors of
// its cell with signs +-1, then the floors (and the stratified kick), so
// stage 4 forms each where it is read (mhd_stages.cuh traced), with the
// same bits as the trace would have stored, and each is read by one face
// or edge only. Stage 4 needs the precursors of a cell and of its -1
// neighbours in x, y, z and the pairs xy, xz, yz: a block takes a tile of
// TX x TY columns (FluxTile) and a chunk of z planes, and walks the planes
// upwards with the precursors of the tile and a one-cell halo on its -x and
// -y sides staged in shared memory, for the plane and the one below
// (TileSite); its threads stride over the cells' six outputs, a work item
// each.
// The stage buffer holds 77 values per stage-grid cell (8 + 3 + 48 + 15 +
// 3; shear: + 8), where the trace's 144 stored states made it 173.
// In the shearing-box mode the intermediates live on a stage grid of
// nx + 2*XH columns (XH = 2 on each side). Stages 1-4 compute every cell
// of it, with their x reads clamped to the grid (and the state's to its
// slabs): the cells later stages read, columns -2..nx+1 for prim down to
// 0..nx for the fluxes and EMFs, see only unclamped data, and the stages
// write whole rows: skipping the unneeded edge columns left partly
// written cache lines on every row, whose read-modify-write slowed the
// store-heavy trace far below the periodic mode's rate (PERF.md). The
// update runs on the state's cells. Only prim loads the state through the
// slab rule (a branch per load); it copies its cell's state onto the
// stage grid (Se[8]), which efield and the precursors then read by plain
// index.
// The per-cell physics is transcribed from the JAX formulas (ops/eos.py,
// ops/slopes.py, ops/trace_mhd3d.py, ops/riemann_mhd.py,
// solvers/godunov_mhd.py) keeping their hoisted reciprocals and shared
// fast-speed precursors. Parity with the twins is tolerance-based (FMA
// contraction, rsqrtf), never bitwise.
//
// A device flag `active` (the loop's t < t_end test) is read by every
// stage; when it is 0 the step is skipped, so a chunk needs no host sync.
//
// The general instances (mhd_stages.cuh Mode with GEN; compiled from this
// file in mhd_step_general.cu, so the build compiles them beside the
// others) branch on the solver pair where a flux or an EMF is formed; the
// entry points below take them where the block asks for another pair than
// HLLD / 2D-HLLD (common.cuh general_solvers), so the HLLD instances are
// the code earlier builds ran.
//
// Bound on the H100: the step's least time is its arithmetic, 2979
// counted flops per cell (op_count.cuh), 0.75 ms at 256^3 at the f32
// peak, against 64 B/cell of state read and written (0.32 ms at
// 3.35 TB/s). This staged version moves its stage buffer besides: per
// cell and step the stages write 8+3+48+15+3 = 77 values (shear: +8) and
// read about as many again (the precursors once more for a tile's halo,
// 1.2x at the f32 tile), ~0.8 kB per cell in f32, where storing the 144
// traced states made it ~1.4 kB.
#include "mhd_stages.cuh"

namespace ramses::mhd {


// the intermediates' places in the scratch buffer, by the stage grid a.e
template <typename T, typename M>
void carve(StepArgs<T>& a, T* scratch) {
  const long long n = a.e.n;
  a.Q = scratch;
  a.E = a.Q + 8 * n;
  a.pre = a.E + 3 * n;
  a.fl = a.pre + (long long)NPRE * n;
  a.emf = a.fl + 3 * NFLUX * n;
  a.Se = M::SHEAR && !M::WINDOW ? a.emf + 3 * n : nullptr;
}

template <typename T, typename M>
StepArgs<T> step_args(T* S, T* scratch, const T* slabs, T* planes, const T* zslabs,
                      const T* gz, bool comp, const T* dt, const unsigned char* active, int nx,
                      int ny, int nz, const double* prm) {
  StepArgs<T> a;
  a.d = make_dims(nx, ny, nz);
  a.e = M::SHEAR ? make_dims(nx + 2 * XH, ny, nz + (M::STRAT ? 2 * ZH : 0)) : a.d;
  a.ph = make_phys<T>(prm);
  a.S = S;
  a.So = S;
  carve<T, M>(a, scratch);
  a.slabs = slabs;
  a.planes = planes;
  a.C = comp ? S + 8 * a.d.n : nullptr;
  a.Co = comp ? S + 8 * a.d.n : nullptr;
  a.zslabs = zslabs;
  a.gz = gz;
  a.dt = dt;
  a.active = active;
  return a;
}

// the fused flux + EMF stage's tile of TX x TY output columns, per dtype
// (the primary template: f64, and the operation counts' Counted): a block
// of TX TY threads stages the precursors of (TX + 1) x (TY + 1) cells of
// two planes, 58,752 B in f32 and 62,208 B in f64, so three blocks share
// an SM (MIN_BLOCKS, which also caps the registers at 168 a thread)
template <typename T>
struct FluxTile {
  static constexpr int TX = 8, TY = 8;
};
template <>
struct FluxTile<float> {
  static constexpr int TX = 16, TY = 8;
};
constexpr int FLUX_BZ = 32;  // z planes of a block's chunk (one more below it is staged)

// a stage-grid cell of the fused stage's tile: its Site (output index,
// x) and its precursors and its -1 neighbours' from the tile, the plane of
// the cell in slot z & 1 and the one below in the other
template <typename T, typename M, int W, int PP>
struct TileSite {
  const Site<T, M>& s;
  const T* tile;  // [2 planes][NPRE][PP]
  int slot;       // the cell's plane
  int cell;       // the cell's place in a plane: (row + 1) W + column + 1
  HD T pre(int v, int di, int dj, int dk) const {
    return tile[((dk == 0 ? slot : 1 - slot) * NPRE + v) * PP + cell + dj * W + di];
  }
  HD long long nflux() const { return s.nflux(); }
  HD long long cflux() const { return s.cflux(); }
  HD T xpos() const { return s.xpos(); }
};

// 4: the fused flux + EMF stage (FluxEmf) on the whole stage grid, one
// block per tile and z chunk: at each plane z of its chunk (and the one
// below it, first) the block loads the plane's precursors of the tile and
// its halo into the tile slot z & 1, then the block's threads stride over
// the six outputs of each cell from the tile, each a work item (part k of
// FluxEmf), as the streamed kernel's flux phase does. The halo's -1
// neighbours follow the site's rule (Site::grid_index); cells beyond the
// grid's far edges are neither loaded nor computed.
template <typename T, typename M>
struct FluxEmfStage {
  static constexpr int TX = FluxTile<T>::TX, TY = FluxTile<T>::TY;
  static constexpr int W = TX + 1, PP = (TX + 1) * (TY + 1), CELLS = TX * TY;
  static constexpr int NT = CELLS, MIN_BLOCKS = 3;
  static constexpr long long BYTES = 2LL * NPRE * PP * (long long)sizeof(T);
  StepArgs<T> a;
  int ntx, nty;
  long long blocks;

  explicit FluxEmfStage(const StepArgs<T>& a_) : a(a_) {
    ntx = (a.e.nx + TX - 1) / TX;
    nty = (a.e.ny + TY - 1) / TY;
    blocks = (long long)ntx * nty * ((a.e.nz + FLUX_BZ - 1) / FLUX_BZ);
  }
  HD void operator()(long long b, T* tile) const {
    if (!*a.active) return;
    const int x0 = (int)(b % ntx) * TX;
    const long long r = b / ntx;
    const int y0 = (int)(r % nty) * TY, z0 = (int)(r / nty) * FLUX_BZ;
    const int z1 = a.e.nz - z0 < FLUX_BZ ? a.e.nz : z0 + FLUX_BZ;
    for (int z = z0 - 1; z < z1; ++z) {
      T* plane = tile + (long long)(z & 1) * NPRE * PP;
      block_sync();  // the slot's last readers (plane z - 1's cells) are done
      block_items(PP, [&](int cell) {
        const int x = x0 - 1 + cell % W, y = y0 - 1 + cell / W;
        if (x >= a.e.nx || y >= a.e.ny) return;
        const long long g = Site<T, M>::grid_index(a, x, y, z);
#pragma unroll
        for (int v = 0; v < NPRE; ++v) plane[v * PP + cell] = a.pre[(long long)v * a.e.n + g];
      });
      block_sync();
      if (z < z0) continue;
      block_items(6 * CELLS, [&](int t) {
        const int k = t / CELLS, c = t - k * CELLS;
        const int x = x0 + c % TX, y = y0 + c / TX;
        if (x >= a.e.nx || y >= a.e.ny) return;
        const Site<T, M> s(a, x, y, z);
        FluxEmf<T, M>{a}.part(
            TileSite<T, M, W, PP>{s, tile, z & 1, (c / TX + 1) * W + c % TX + 1}, k);
      });
    }
  }
};

// stages 1-4 over the stage grid, the update over n_update cells (the
// state's; ghosted: the cube g .. n + g)
template <typename T, typename M>
int run_stages(const StepArgs<T>& a, bool comp, long long n_update, void* stream) {
  const long long n = a.e.n;
  int err;
  if ((err = launch_cells(PrimStage<T, M>{a}, n, stream))) return err;
  if ((err = launch_cells(EFieldStage<T, M>{a}, n, stream))) return err;
  if ((err = launch_cells(PrecursorStage<T, M>{a}, n, stream))) return err;
  const FluxEmfStage<T, M> flux_emf(a);
  if ((err = launch_blocks<T>(flux_emf, flux_emf.blocks, stream))) return err;
  if constexpr (!M::WINDOW && !M::GRAV) {  // (they have no compensated update)
    if (comp) return launch_cells(UpdateStage<T, M, true>{a}, n_update, stream);
  }
  return launch_cells(UpdateStage<T, M, false>{a}, n_update, stream);
}

// comp: S holds 16 channels, the state and then its Kahan carry
template <typename T, typename M>
int mhd_step(T* S, T* scratch, const T* slabs, T* planes, const T* zslabs, const T* gz,
             bool comp, const T* dt, const unsigned char* active, int nx, int ny, int nz,
             const double* prm, void* stream) {
  const StepArgs<T> a = step_args<T, M>(S, scratch, slabs, planes, zslabs, gz, comp, dt, active,
                                        nx, ny, nz, prm);
  return run_stages<T, M>(a, comp, a.d.n, stream);
}

// the ghosted mode's arguments: the interior nx x ny x nz at offset g of U
template <typename T, typename M = Ghosted>
StepArgs<T> ghosted_args(T* U, T* scratch, const T* dt, const unsigned char* active, int nx,
                         int ny, int nz, int g, const double* prm) {
  StepArgs<T> a = step_args<T, M>(U, scratch, nullptr, nullptr, nullptr, nullptr, false, dt,
                                  active, nx + 2 * g, ny + 2 * g, nz + 2 * g, prm);
  a.in = make_dims(nx, ny, nz);
  a.g = g;
  return a;
}

// the cells of the ghosted mode's update: the cube g .. n + g
HD long long ghosted_update_cells(int nx, int ny, int nz) {
  return (nx + 1LL) * (ny + 1LL) * (nz + 1LL);
}

// the ghosted mode: U [8][nz+2g][ny+2g][nx+2g], its ghosts filled; plain
// update only (the JAX package's walled step has no compensated branch);
// its isothermal instance where cIso > 0. GEN (here and in the other
// modes' entries below): the general instances, the solvers from prm
template <typename T, bool GEN>
int mhd_step_ghosted(T* U, T* scratch, const T* dt, const unsigned char* active, int nx, int ny,
                     int nz, int g, const double* prm, void* stream) {
  const auto run = [&](auto mode) {
    using M = WithSolvers<decltype(mode), GEN>;
    const StepArgs<T> a = ghosted_args<T, M>(U, scratch, dt, active, nx, ny, nz, g, prm);
    return run_stages<T, M>(a, false, ghosted_update_cells(nx, ny, nz), stream);
  };
  if (has_gravity(prm))
    return prm[P_CISO] > 0.0 ? run(GhostedIsoGrav{}) : run(GhostedGrav{});
  return prm[P_CISO] > 0.0 ? run(GhostedIso{}) : run(Ghosted{});
}

// the periodic mode, and its isothermal instance where cIso > 0 (the
// adiabatic instance is the one every earlier build ran)
template <typename T, bool GEN>
int mhd_step_periodic(T* S, T* scratch, bool comp, const T* dt, const unsigned char* active,
                      int nx, int ny, int nz, const double* prm, void* stream) {
  if (prm[P_CISO] > 0.0)
    return mhd_step<T, WithSolvers<PeriodicIso, GEN>>(S, scratch, nullptr, nullptr, nullptr,
                                                      nullptr, comp, dt, active, nx, ny, nz, prm,
                                                      stream);
  return mhd_step<T, WithSolvers<Periodic, GEN>>(S, scratch, nullptr, nullptr, nullptr, nullptr,
                                                 comp, dt, active, nx, ny, nz, prm, stream);
}

// the shear window mode's arguments: U the ghosted window
// [8][nz+2g][ny+2g][nx+2g], out its new interior [8][nz][ny][nx], the
// stage grid the interior and WH cells beyond each face
template <typename T, typename M>
StepArgs<T> window_args(const T* U, T* out, T* scratch, T* planes, const T* gz, const T* dt,
                        const unsigned char* active, int nx, int ny, int nz, int g,
                        const double* prm) {
  StepArgs<T> a{};
  a.d = make_dims(nx + 2 * g, ny + 2 * g, nz + 2 * g);
  a.e = make_dims(nx + 2 * WH, ny + 2 * WH, nz + 2 * WH);
  a.in = make_dims(nx, ny, nz);
  a.g = g;
  a.ph = make_phys<T>(prm);
  a.S = U;
  a.So = out;
  carve<T, M>(a, scratch);
  a.planes = planes;
  a.gz = gz;
  a.dt = dt;
  a.active = active;
  return a;
}

// the shear window mode (TPU row 4): the window's ghosts filled by the
// exchange, x0 in prm[P_XMIN], g_z of the window's rows in gz (stratified)
// or null; the stencil reaches 1 cell past the stage grid, so g >= WH + 1
template <typename T, bool GEN>
int mhd_step_window(const T* U, T* out, T* planes, T* scratch, const T* gz, const T* dt,
                    const unsigned char* active, int nx, int ny, int nz, int g,
                    const double* prm, void* stream) {
  if (g != SLAB) return 1;  // cudaErrorInvalidValue (gz rows sit at k + SLAB)
  if (gz != nullptr) {
    if (!(prm[P_CISO] > 0.0)) return 1;
    using M = Mode<true, true, true, true, false, GEN>;
    return run_stages<T, M>(
        window_args<T, M>(U, out, scratch, planes, gz, dt, active, nx, ny, nz, g, prm), false,
        (long long)nx * ny * nz, stream);
  }
  if (prm[P_CISO] > 0.0) {
    using M = Mode<true, true, false, true, false, GEN>;
    return run_stages<T, M>(
        window_args<T, M>(U, out, scratch, planes, nullptr, dt, active, nx, ny, nz, g, prm),
        false, (long long)nx * ny * nz, stream);
  }
  using M = Mode<true, false, false, true, false, GEN>;
  return run_stages<T, M>(
      window_args<T, M>(U, out, scratch, planes, nullptr, dt, active, nx, ny, nz, g, prm),
      false, (long long)nx * ny * nz, stream);
}

// the shear modes: isothermal or adiabatic; stratified (zslabs and gz
// given) only isothermal, as its scale height cIso / omega0 needs
template <typename T, bool GEN>
int mhd_step_shear(T* S, T* scratch, const T* slabs, T* planes, const T* zslabs, const T* gz,
                   bool comp, const T* dt, const unsigned char* active, int nx, int ny, int nz,
                   const double* prm, void* stream) {
  if (zslabs != nullptr) {
    if (!(prm[P_CISO] > 0.0) || gz == nullptr) return 1;  // cudaErrorInvalidValue
    return mhd_step<T, Mode<true, true, true, false, false, GEN>>(
        S, scratch, slabs, planes, zslabs, gz, comp, dt, active, nx, ny, nz, prm, stream);
  }
  if (prm[P_CISO] > 0.0)
    return mhd_step<T, Mode<true, true, false, false, false, GEN>>(
        S, scratch, slabs, planes, nullptr, nullptr, comp, dt, active, nx, ny, nz, prm, stream);
  return mhd_step<T, Mode<true, false, false, false, false, GEN>>(
      S, scratch, slabs, planes, nullptr, nullptr, comp, dt, active, nx, ny, nz, prm, stream);
}

// the general instances of the four entries above, per dtype: compiled in
// mhd_step_general.cu (this file with RAMSES_MHD_GENERAL_TU), declared
// extern here, so the build compiles the two sets side by side
#define RAMSES_MHD_STEP_GENERAL(SPEC, T)                                                     \
  SPEC template int mhd_step_ghosted<T, true>(T*, T*, const T*, const unsigned char*, int, int, \
                                              int, int, const double*, void*);               \
  SPEC template int mhd_step_periodic<T, true>(T*, T*, bool, const T*, const unsigned char*,  \
                                               int, int, int, const double*, void*);          \
  SPEC template int mhd_step_window<T, true>(const T*, T*, T*, T*, const T*, const T*,       \
                                             const unsigned char*, int, int, int, int,        \
                                             const double*, void*);                           \
  SPEC template int mhd_step_shear<T, true>(T*, T*, const T*, T*, const T*, const T*, bool,  \
                                            const T*, const unsigned char*, int, int, int,    \
                                            const double*, void*);
#ifdef RAMSES_MHD_GENERAL_TU
RAMSES_MHD_STEP_GENERAL(, float)
RAMSES_MHD_STEP_GENERAL(, double)
#else
RAMSES_MHD_STEP_GENERAL(extern, float)
RAMSES_MHD_STEP_GENERAL(extern, double)
#endif

}  // namespace ramses::mhd

#ifndef RAMSES_MHD_GENERAL_TU

extern "C" {

long long ramses_mhd_step_scratch_per_cell(void) { return ramses::mhd::SCRATCH_PER_CELL; }

// the shear mode's scratch: its stage grid has nx + 2 XH columns (and,
// stratified, nz + 2 ZH rows)
long long ramses_mhd_step_shear_scratch(int nx, int ny, int nz, int strat) {
  return ramses::mhd::SHEAR_SCRATCH_PER_CELL * (nx + 2LL * ramses::mhd::XH) * ny *
         (nz + (strat ? 2LL * ramses::mhd::ZH : 0));
}

// the ghosted mode's scratch: its stage grid is the ghosted array
long long ramses_mhd_step_ghosted_scratch(int nx, int ny, int nz, int g) {
  return ramses::mhd::SCRATCH_PER_CELL * (nx + 2LL * g) * (ny + 2LL * g) * (nz + 2LL * g);
}

// the shear window mode's scratch: its stage grid has WH cells beyond
// each face of the interior
long long ramses_mhd_step_window_scratch(int nx, int ny, int nz) {
  using ramses::mhd::WH;
  return ramses::mhd::SCRATCH_PER_CELL * (nx + 2LL * WH) * (ny + 2LL * WH) * (nz + 2LL * WH);
}

// the shear window mode: U [8][nz+2g][ny+2g][nx+2g] (ghosts filled) ->
// out [8][nz][ny][nx] and planes [5][nz][ny]; gz [nz + 2g] or null
int ramses_mhd_step_window_f32(const float* U, float* out, float* planes, float* scratch,
                               const float* gz, const float* dt, const unsigned char* active,
                               int nx, int ny, int nz, int g, const double* prm, void* stream) {
  using namespace ramses::mhd;
  return with_solvers(prm, [&](auto gen) {
    return mhd_step_window<float, decltype(gen)::value>(
        U, out, planes, scratch, gz, dt, active, nx, ny, nz, g, prm, stream);
  });
}

int ramses_mhd_step_window_f64(const double* U, double* out, double* planes, double* scratch,
                               const double* gz, const double* dt, const unsigned char* active,
                               int nx, int ny, int nz, int g, const double* prm, void* stream) {
  using namespace ramses::mhd;
  return with_solvers(prm, [&](auto gen) {
    return mhd_step_window<double, decltype(gen)::value>(
        U, out, planes, scratch, gz, dt, active, nx, ny, nz, g, prm, stream);
  });
}

// the ghosted mode: U [8][nz+2g][ny+2g][nx+2g], ghosts filled, updated in
// place (its interior and the CT face layer n + g)
int ramses_mhd_step_ghosted_f32(float* U, float* scratch, const float* dt,
                                const unsigned char* active, int nx, int ny, int nz, int g,
                                const double* prm, void* stream) {
  using namespace ramses::mhd;
  return with_solvers(prm, [&](auto gen) {
    return mhd_step_ghosted<float, decltype(gen)::value>(
        U, scratch, dt, active, nx, ny, nz, g, prm, stream);
  });
}

int ramses_mhd_step_ghosted_f64(double* U, double* scratch, const double* dt,
                                const unsigned char* active, int nx, int ny, int nz, int g,
                                const double* prm, void* stream) {
  using namespace ramses::mhd;
  return with_solvers(prm, [&](auto gen) {
    return mhd_step_ghosted<double, decltype(gen)::value>(
        U, scratch, dt, active, nx, ny, nz, g, prm, stream);
  });
}

// the periodic step (isothermal where cIso > 0); comp: S holds 16
// channels, the state and its carry
int ramses_mhd_step_f32(float* S, float* scratch, const float* dt, const unsigned char* active,
                        int comp, int nx, int ny, int nz, const double* prm, void* stream) {
  using namespace ramses::mhd;
  return with_solvers(prm, [&](auto gen) {
    return mhd_step_periodic<float, decltype(gen)::value>(
        S, scratch, comp != 0, dt, active, nx, ny, nz, prm, stream);
  });
}

int ramses_mhd_step_f64(double* S, double* scratch, const double* dt,
                        const unsigned char* active, int comp, int nx, int ny, int nz,
                        const double* prm, void* stream) {
  using namespace ramses::mhd;
  return with_solvers(prm, [&](auto gen) {
    return mhd_step_periodic<double, decltype(gen)::value>(
        S, scratch, comp != 0, dt, active, nx, ny, nz, prm, stream);
  });
}

// the shear modes: comp (S holds 16 channels); stratified (zslabs
// [2][8][3][ny][nx + 6] and gz [nz + 6] given, else null)
int ramses_mhd_step_shear_f32(float* S, float* scratch, const float* slabs, float* planes,
                              const float* zslabs, const float* gz, const float* dt,
                              const unsigned char* active, int comp, int nx, int ny, int nz,
                              const double* prm, void* stream) {
  using namespace ramses::mhd;
  return with_solvers(prm, [&](auto gen) {
    return mhd_step_shear<float, decltype(gen)::value>(
        S, scratch, slabs, planes, zslabs, gz, comp != 0, dt, active, nx, ny, nz, prm, stream);
  });
}

int ramses_mhd_step_shear_f64(double* S, double* scratch, const double* slabs, double* planes,
                              const double* zslabs, const double* gz, const double* dt,
                              const unsigned char* active, int comp, int nx, int ny, int nz,
                              const double* prm, void* stream) {
  using namespace ramses::mhd;
  return with_solvers(prm, [&](auto gen) {
    return mhd_step_shear<double, decltype(gen)::value>(
        S, scratch, slabs, planes, zslabs, gz, comp != 0, dt, active, nx, ny, nz, prm, stream);
  });
}

}  // extern "C"

#ifndef __CUDACC__
namespace ramses::mhd {

// the traced states S.. of stage cell p, formed as the flux + EMF stage
// forms them, into out [18][8][n]
template <int S = 0, typename T, typename P>
void store_traced(const Phys<T>& ph, const P& p, T* out, long long n) {
  for (int ch = 0; ch < 8; ++ch)
    out[((long long)S * 8 + ch) * n + p.c] = traced<Periodic, S>(ph, p, 0, 0, 0, ch);
  if constexpr (S + 1 < NSTATE) store_traced<S + 1>(ph, p, out, n);
}

// the periodic step's 18 traced states of every cell, formed from the
// precursor stage's output (stages 1-3 on S)
template <typename T>
int traced_states(T* S, T* scratch, T* out, const T* dt, int nx, int ny, int nz,
                  const double* prm) {
  const unsigned char active = 1;
  const StepArgs<T> a = step_args<T, Periodic>(S, scratch, nullptr, nullptr, nullptr, nullptr,
                                               false, dt, &active, nx, ny, nz, prm);
  launch_cells(PrimStage<T, Periodic>{a}, a.e.n, nullptr);
  launch_cells(EFieldStage<T, Periodic>{a}, a.e.n, nullptr);
  launch_cells(PrecursorStage<T, Periodic>{a}, a.e.n, nullptr);
  for (long long t = 0; t < a.e.n; ++t) store_traced(a.ph, Site<T, Periodic>(a, t), out, a.e.n);
  return 0;
}

}  // namespace ramses::mhd

// host builds: the 18 traced states [18][8][nz][ny][nx] (ops/trace_mhd3d.py
// STATE_NAMES order) of the periodic step of S [8][nz][ny][nx] by dt, formed
// from the precursors as the kernel's flux + EMF stage forms them
extern "C" int ramses_mhd_traced_states_f32(float* S, float* scratch, float* out,
                                            const float* dt, int nx, int ny, int nz,
                                            const double* prm) {
  return ramses::mhd::traced_states<float>(S, scratch, out, dt, nx, ny, nz, prm);
}

extern "C" int ramses_mhd_traced_states_f64(double* S, double* scratch, double* out,
                                            const double* dt, int nx, int ny, int nz,
                                            const double* prm) {
  return ramses::mhd::traced_states<double>(S, scratch, out, dt, nx, ny, nz, prm);
}
#endif

#ifdef RAMSES_COUNT_OPS
// the floating-point operations of one step of S (op_count.cuh): S holds 8
// channels, or 16 with comp (the state and its Kahan carry)
extern "C" long long ramses_mhd_step_ops(const double* S, int comp, int nx, int ny, int nz,
                                         const double* prm, double dt) {
  using ramses::Counted;
  const long long n = (long long)nx * ny * nz;
  std::vector<Counted> s = ramses::counted_copy(S, (comp ? 16 : 8) * n);
  std::vector<Counted> scratch(ramses::mhd::SCRATCH_PER_CELL * n);
  const Counted dtc(dt);
  const unsigned char active = 1;
  Counted::ops = 0;
  ramses::mhd::with_solvers(prm, [&](auto gen) {
    return ramses::mhd::mhd_step_periodic<Counted, decltype(gen)::value>(
        s.data(), scratch.data(), comp != 0, &dtc, &active, nx, ny, nz, prm, nullptr);
  });
  return Counted::ops;
}

namespace ramses::mhd {

// the operations of stage f on the stage-grid cells (shear mode) of columns
// lo..nx+hi and, stratified, rows lo..nz+hi: those a later stage reads, for
// stages run on every cell
template <typename M, typename F>
long long counted_cells(const F& f, const Dims& e, int lo, int hi, int nx, int nz) {
  long long ops = 0;
  for (long long t = 0; t < e.n; ++t) {
    const long long before = Counted::ops;
    f(t);
    int i, j, k;
    cell_ijk(e, t, i, j, k);
    i -= XH;
    k -= M::STRAT ? ZH : 0;
    const bool in_z = !M::STRAT || (k >= lo && k <= nz + hi);
    if (i >= lo && i <= nx + hi && in_z) ops += Counted::ops - before;
  }
  return ops;
}

// the shear mode's step as it needs to be done: prim on columns -2..nx+1,
// efield on -1..nx+1, trace on -1..nx, fluxes and EMFs on faces 0..nx
// (stratified: the same rows in z), the update on the state; the stage
// grid's other cells are computed by the kernel but never read
template <typename M>
long long shear_step_ops(Counted* S, Counted* scratch, const Counted* slabs, Counted* planes,
                         const Counted* zslabs, const Counted* gz, bool comp, const Counted* dt,
                         int nx, int ny, int nz, const double* prm) {
  const unsigned char active = 1;
  const StepArgs<Counted> a = step_args<Counted, M>(S, scratch, slabs, planes, zslabs, gz, comp,
                                                    dt, &active, nx, ny, nz, prm);
  long long ops = counted_cells<M>(PrimStage<Counted, M>{a}, a.e, -XH, XH - 1, nx, nz);
  ops += counted_cells<M>(EFieldStage<Counted, M>{a}, a.e, -1, 1, nx, nz);
  ops += counted_cells<M>(PrecursorStage<Counted, M>{a}, a.e, -1, 0, nx, nz);
  ops += counted_cells<M>(FluxEmf<Counted, M>{a}, a.e, 0, 0, nx, nz);
  const long long before = Counted::ops;
  if (comp) {
    const UpdateStage<Counted, M, true> update{a};
    for (long long t = 0; t < a.d.n; ++t) update(t);
  } else {
    const UpdateStage<Counted, M, false> update{a};
    for (long long t = 0; t < a.d.n; ++t) update(t);
  }
  return ops + Counted::ops - before;
}

// the ghosted mode's operations on the interior: each stage on the cells
// of the interior only, the work per interior cell of its function (the
// halo cells it computes besides are the stage grid's edges)
template <typename M>
long long ghosted_step_ops(Counted* U, Counted* scratch, const Counted* dt, int nx, int ny,
                           int nz, int g, const double* prm) {
  const unsigned char active = 1;
  const StepArgs<Counted> a = ghosted_args<Counted, M>(U, scratch, dt, &active, nx, ny, nz, g,
                                                       prm);
  long long ops = 0;
  auto count = [&](const auto& f) {
    for (long long t = 0; t < a.e.n; ++t) {
      const long long before = Counted::ops;
      f(t);
      int i, j, k;
      cell_ijk(a.e, t, i, j, k);
      if (i >= g && i < g + nx && j >= g && j < g + ny && k >= g && k < g + nz)
        ops += Counted::ops - before;
    }
  };
  count(PrimStage<Counted, M>{a});
  count(EFieldStage<Counted, M>{a});
  count(PrecursorStage<Counted, M>{a});
  count(FluxEmf<Counted, M>{a});
  const UpdateStage<Counted, M, false> update{a};
  for (long long t = 0; t < ghosted_update_cells(nx, ny, nz); ++t) {
    const long long before = Counted::ops;
    update(t);
    const Site<Counted, M> p(a, t, true);
    if (p.interior()) ops += Counted::ops - before;
  }
  return ops;
}

// the window mode's step as it needs to be done: prim on cells -2..n+1 of
// every axis, efield on -1..n+1, the precursors on -1..n, fluxes and EMFs
// on 0..n, the update on the interior; the stage grid's other cells are
// computed by the kernel but never read. per_stage (5 entries, or null)
// gets each stage's share, in that order.
template <typename M>
long long window_step_ops(const StepArgs<Counted>& a, long long* per_stage) {
  long long ops = 0;
  int stage = 0;
  auto count = [&](const auto& f, int lo, int hi) {
    const long long start = ops;
    for (long long t = 0; t < a.e.n; ++t) {
      const long long before = Counted::ops;
      f(t);
      int i, j, k;
      cell_ijk(a.e, t, i, j, k);
      i -= WH;
      j -= WH;
      k -= WH;
      if (i >= lo && i <= a.in.nx + hi && j >= lo && j <= a.in.ny + hi && k >= lo &&
          k <= a.in.nz + hi)
        ops += Counted::ops - before;
    }
    if (per_stage != nullptr) per_stage[stage] = ops - start;
    ++stage;
  };
  count(PrimStage<Counted, M>{a}, -WH, WH - 1);
  count(EFieldStage<Counted, M>{a}, -1, 1);
  count(PrecursorStage<Counted, M>{a}, -1, 0);
  count(FluxEmf<Counted, M>{a}, 0, 0);
  const long long before = Counted::ops;
  const UpdateStage<Counted, M, false> update{a};
  for (long long t = 0; t < a.in.n; ++t) update(t);
  if (per_stage != nullptr) per_stage[4] = Counted::ops - before;
  return ops + Counted::ops - before;
}

}  // namespace ramses::mhd

// the window mode's operations on a ghosted window U [8][nz+2g][ny+2g][nx+2g]
// (ghosts filled), with g_z of its rows gz [nz + 2g] or null; prm[P_XMIN]
// holds the window's x0; per_stage (5 entries: prim, efield, precursors,
// fluxes and EMFs, update) or null
extern "C" long long ramses_mhd_step_window_ops(const double* U, const double* gz, int nx,
                                                int ny, int nz, int g, const double* prm,
                                                double dt, long long* per_stage) {
  using ramses::Counted;
  using ramses::mhd::Mode;
  std::vector<Counted> u =
      ramses::counted_copy(U, 8LL * (nx + 2 * g) * (ny + 2 * g) * (nz + 2 * g));
  std::vector<Counted> gzc;
  if (gz != nullptr) gzc = ramses::counted_copy(gz, nz + 2LL * g);
  std::vector<Counted> scratch(ramses_mhd_step_window_scratch(nx, ny, nz));
  std::vector<Counted> out(8LL * nx * ny * nz);
  std::vector<Counted> planes(ramses::mhd::NPLANE * (long long)nz * ny);
  const Counted dtc(dt);
  const unsigned char active = 1;
  const Counted* gzp = gz != nullptr ? gzc.data() : nullptr;
  auto count = [&](auto mode) {
    return ramses::mhd::with_solvers(prm, [&](auto gen) {
      using M = ramses::mhd::WithSolvers<decltype(mode), decltype(gen)::value>;
      return ramses::mhd::window_step_ops<M>(
          ramses::mhd::window_args<Counted, M>(u.data(), out.data(), scratch.data(),
                                               planes.data(), gzp, &dtc, &active, nx, ny, nz, g,
                                               prm),
          per_stage);
    });
  };
  if (gz != nullptr) return count(Mode<true, true, true, true>{});
  if (prm[ramses::P_CISO] > 0.0) return count(Mode<true, true, false, true>{});
  return count(Mode<true, false, false, true>{});
}

// the ghosted mode's operations on the interior of a ghosted state U
// [8][nz+2g][ny+2g][nx+2g] (ghosts filled)
extern "C" long long ramses_mhd_step_ghosted_ops(const double* U, int nx, int ny, int nz, int g,
                                                 const double* prm, double dt) {
  using ramses::Counted;
  std::vector<Counted> u =
      ramses::counted_copy(U, 8LL * (nx + 2 * g) * (ny + 2 * g) * (nz + 2 * g));
  std::vector<Counted> scratch(ramses_mhd_step_ghosted_scratch(nx, ny, nz, g));
  const Counted dtc(dt);
  using namespace ramses::mhd;
  const bool iso = prm[ramses::P_CISO] > 0.0;
  const auto count = [&](auto mode) {
    return with_solvers(prm, [&](auto gen) {
      return ghosted_step_ops<WithSolvers<decltype(mode), decltype(gen)::value>>(
          u.data(), scratch.data(), &dtc, nx, ny, nz, g, prm);
    });
  };
  if (ramses::has_gravity(prm)) return iso ? count(GhostedIsoGrav{}) : count(GhostedGrav{});
  return iso ? count(GhostedIso{}) : count(Ghosted{});
}

// the same for the shearing-box modes, with the sheared slabs beside S (and,
// stratified, the z slabs and g_z; else null)
extern "C" long long ramses_mhd_step_shear_ops(const double* S, const double* slabs,
                                               const double* zslabs, const double* gz, int comp,
                                               int nx, int ny, int nz, const double* prm,
                                               double dt) {
  using ramses::Counted;
  using ramses::mhd::Mode;
  using ramses::mhd::SLAB;
  const long long n = (long long)nx * ny * nz;
  const bool strat = zslabs != nullptr;
  std::vector<Counted> s = ramses::counted_copy(S, (comp ? 16 : 8) * n);
  std::vector<Counted> sl = ramses::counted_copy(slabs, 2LL * 8 * nz * ny * SLAB);
  std::vector<Counted> zs, g;
  if (strat) {
    zs = ramses::counted_copy(zslabs, 2LL * 8 * SLAB * ny * (nx + 2 * SLAB));
    g = ramses::counted_copy(gz, nz + 2LL * SLAB);
  }
  std::vector<Counted> scratch(ramses_mhd_step_shear_scratch(nx, ny, nz, strat));
  std::vector<Counted> planes(ramses::mhd::NPLANE * (long long)nz * ny);
  const Counted dtc(dt);
  const auto count = [&](auto mode) {
    return ramses::mhd::with_solvers(prm, [&](auto gen) {
      return ramses::mhd::shear_step_ops<
          ramses::mhd::WithSolvers<decltype(mode), decltype(gen)::value>>(
          s.data(), scratch.data(), sl.data(), planes.data(), strat ? zs.data() : nullptr,
          strat ? g.data() : nullptr, comp != 0, &dtc, nx, ny, nz, prm);
    });
  };
  if (strat) return count(Mode<true, true, true>{});
  return prm[ramses::P_CISO] > 0.0 ? count(Mode<true, true>{}) : count(Mode<true, false>{});
}
#endif
#endif  // RAMSES_MHD_GENERAL_TU
