// The shearing box's x borders (and, stratified, its z ghosts), around the
// step kernel's shear mode (mhd_step.cu), in two kernels:
//
// - shear_slabs: the sheared x ghost slabs G[2][8][nz][ny][3] (XMIN,
//   XMAX) at time t + dt from the loop state (S, kept): each ghost is the
//   opposite border shifted in y by deltay = 1.5 omega0 Lx (t + dt) mod Ly,
//   interpolated linearly with a limited-slope correction; By takes the
//   conservative form b + eps * slope; the XMAX slab's first Bx column is
//   the kept face. Plain twin: ramsesgpu_tpu_torch/solvers/shear.py
//   shear_slabs (JAX: pallas/shear_packed.py:167
//   _shear_slabs_from_interior, solvers/shear.py:106). Given Z (the
//   stratified z faces, BC_Z_STRATIFIED), the same launch builds the z
//   ghost slabs Z[2][8][3][ny][nx + 6] of the block [XMIN slab | S | XMAX
//   slab]: the slabs' x columns get their z ghosts by the same rule applied
//   to the slab itself, the reference's Z-after-X fill order
//   (shear_packed.py:963-975, the z band refills :1006-1021). Plain twin:
//   solvers/shear.py stratified_zslabs.
// - shear_border: the conservative remap at the two domain x faces at
//   t + dt/2 and what it changes (pallas/shear_packed.py:1108-1168): the
//   step kernel's density flux and emfY planes of faces 0 and nx are
//   remapped against each other; the border columns 0 and nx-1 get the
//   density, Bx and Bz deltas and the density floor; the kept Bx face gets
//   its CT update with the remapped emfY; the remapped planes are written
//   out. Compensated (S of 16 channels, kept [2][nz][ny]): Kahan adds with
//   the carries, the carry reset where the density floor fires, the kept
//   face's carry (shear_packed.py:1127-1166). Plain twin:
//   solvers/godunov_mhd.py shear_border_update.
//
// Together with the step kernel they replace the TPU kernels
// pallas/shear_packed.py:237 _make_strip_kernel (the border strip with its
// true sheared ghosts and remap planes) and the XLA glue around it
// (:952-1004 the slab build, :1108-1174 remap and corrections); the TPU's
// fused variant :432 _make_strip_kernel_fused (a dissipative run's
// default) runs on these kernels too.
//
// The file is compiled without FMA contraction (kernels/build.py) in the
// twins' op order, and the twins divide by tensors, so both kernels repeat
// their twins' roundings: bitwise on the same inputs, carries included.
//
// Bound on the H100: bytes, a few planes of values (128x256x128 f32: the x
// slabs read 6 border columns and write 6, 12.6 MB, 3.8 us at 3.35 TB/s;
// the z slabs read 2 rows of 6 channels and write 48 rows, 8.1 MB, 2.4 us;
// the border kernel reads 5 planes and 5 border values a row and writes 5
// and 4 planes, 2.8 MB, 0.8 us), near a launch's own latency. But a border
// value costs a 32-byte sector of its 4 nx-byte row (3 values of a slab
// column share one): the x slabs read 2 x 8 sectors a (z, y) row, 16.8 MB,
// and the border kernel moves 5 (compensated 10) sectors a row each way,
// in scattered rows of planes a power of two of bytes apart. Those sectors,
// not the values, set the time of the slab kernel and of the compensated
// border kernel (PERF.md section 6).
//
// Design: the shifts and their weights are formed once per block, from one
// load each of t and dt. The slab build: a block owns a run of SLAB_RUN y
// rows of one (side, z): it copies the source window (the run and its 3
// rows of halo, 3 columns, 8 channels) into shared memory with cp.async,
// each value once, then forms every output value of the run from there,
// consecutive threads on consecutive outputs; with Z, the blocks of the
// rows z = 0 and nz - 1 also write the z ghosts of their slab columns, and
// blocks of their own build the z ghosts of the interior columns, a thread
// a column of a row, its six loads before its 24 stores. The border kernel,
// also a launch_blocks body: a thread a (z, y) row; it loads its border
// values and the planes it reads unshifted into shared memory while thread
// 0 forms the block's shift, then after the barrier its twelve shifted
// gathers and, compensated, its six carries, then the arithmetic. Index
// arithmetic is 32-bit around one 64-bit base per block or row. (H100 at
// 700 W, 128x256x128 f32, scripts/torch_ab.py parent, device time, each
// pair in one call: x slabs on runs of 16 rows 0.0217 ms against 0.0237 on
// 8; 32 rows 0.0230 against 16's 0.0218; 64 rows 0.0276 against 32's
// 0.0230; 32 rows on 64 threads 0.0270 against 128 threads' 0.0231. The
// compensated border kernel with its carries loaded after the shift 0.0241
// ms against 0.0268 loaded with the state's.)
#include "common.cuh"

namespace ramses::shear {

constexpr int SLAB = 3;  // ghost columns per side (ghost_width)
constexpr int NPLANE = 5;

template <typename T>
struct Consts {
  T fill_k, fill_ly, remap_k, remap_ly;
};

template <typename T>
Consts<T> make_consts(const double* p) {
  return Consts<T>{T(p[P_FILL_K]), T(p[P_FILL_LY]), T(p[P_REMAP_K]), T(p[P_REMAP_LY])};
}

// the y shift of the fill at time tf (solvers/shear.py:44-49): jplus and
// epsi = deltay mod dy
template <typename T>
HD void fill_offset(const Consts<T>& k, const Phys<T>& ph, T tf, int& jplus, T& epsi) {
  const T deltay = r_fmod(r_mul(k.fill_k, tf), k.fill_ly);
  jplus = to_int(r_floor(deltay / ph.dy));
  epsi = r_fmod(deltay, ph.dy);
}

// The stratified z ghost of channel ch in row `row` of side zside (ZMIN 0,
// ZMAX 1) above or below a source cell whose channel c is at(c)
// (solvers/stratified.py stratified_ghost_slabs): density extrapolated
// hydrostatically by the factor cum, the horizontal momenta at the source's
// velocity, the vertical momentum outflow only, Bx and By zero, Bz and E
// continued.
template <typename T, typename A>
HD T zghost(int ch, int zside, T cum, const A& at) {
  if (ch == IA || ch == IB) return T(0);
  if (ch == IP || ch == IC) return at(ch);
  if (ch == IW) return zside ? pmax(at(IW), T(0)) : pmin(at(IW), T(0));
  const T rho_src = at(ID);
  const T rho_k = rho_src * cum;
  return ch == ID ? rho_k : at(ch) / rho_src * rho_k;
}

constexpr int SLAB_NT = 128;                 // threads of a slab block
constexpr int SLAB_RUN = 16;                 // y rows of an x slab block
constexpr int SLAB_WIN = SLAB_RUN + 3;       // source rows it reads
constexpr int SLAB_SRC = 8 * SLAB_WIN * SLAB;  // values of its source window
constexpr int SLAB_OUT = 8 * SLAB_RUN * SLAB;  // values it forms

// a slab block's threads stride over a phase's n items (unrolled: n and
// the stride are constants); the host build runs each phase as a loop
template <typename F>
HD void slab_items(int n, const F& f) {
#ifdef __CUDA_ARCH__
#pragma unroll
  for (int t = threadIdx.x; t < n; t += SLAB_NT) f(t);
#else
  for (int t = 0; t < n; ++t) f(t);
#endif
}

// The slab build, a block body of launch_blocks. Blocks [0, xblocks): the
// x slabs of a run of SLAB_RUN y rows of one (side, z), the z ghosts of
// their columns when Z is given and z is 0 or nz - 1. Blocks [xblocks,
// xblocks + zblocks) (Z only): the z ghosts of the interior columns, a
// block SLAB_NT cells of the row z = 0 (ZMIN) or nz - 1 (ZMAX).
template <typename T>
struct SlabBuild {
  static constexpr int NT = SLAB_NT;
  static constexpr int MIN_BLOCKS = 8;
  // the shift (eps, lam, jplus), the source window, the formed values
  static constexpr long long BYTES = (4 + SLAB_SRC + SLAB_OUT) * (long long)sizeof(T);
  const T* S;
  const T* kept;
  T* slabs;
  T* Z;  // the stratified z slabs, or null
  const T* t;
  const T* dt;
  Dims d;
  Phys<T> ph;
  Consts<T> k;
  T lo[SLAB], hi[SLAB];  // density factors of the rows z = -1, -2, -3 and nz, nz+1, nz+2
  int runs;              // x slab blocks per (side, z)
  long long xblocks, zper;  // x slab blocks; z blocks per side

  // Z's offset of channel ch, ghost row `row` of side zside, y row j,
  // column 0 of the block
  HD long long zat(int zside, int ch, int row, int j) const {
    return (((long long)(zside * 8 + ch) * SLAB + row) * d.ny + j) * (d.nx + 2 * SLAB);
  }

  HD void operator()(long long b, T* tile) const {
    if (b < xblocks)
      xslab(b, tile);
    else
      zslab(b - xblocks);
  }

  HD void xslab(long long b, T* tile) const {
    const int run = (int)(b % runs);
    const int kz = (int)(b / runs % d.nz);
    const int side = (int)(b / runs / d.nz);
    const int j0 = run * SLAB_RUN;
    const int nrow = d.ny - j0 < SLAB_RUN ? d.ny - j0 : SLAB_RUN;
    T* sh = tile;
    T* src = tile + 4;
    T* vals = src + SLAB_SRC;
    // the fill's shift at t + dt, once per block; XMIN ghosts <- the XMAX
    // border shifted down (make_boundary_shear.h:213-247), XMAX ghosts <-
    // the XMIN border shifted up (:251-299)
    block_items(1, [&](int) {
      int jplus;
      T epsi;
      fill_offset(k, ph, *t + *dt, jplus, epsi);
      const T eps = side == 0 ? T(1) - epsi / ph.dy : epsi / ph.dy;
      sh[0] = eps;
      sh[1] = T(0.5) * eps * (eps - T(1));
      sh[2] = T(jplus);
    });
    block_sync();
    const T eps = sh[0], lam = sh[1];
    const int jplus = to_int(sh[2]);
    // the source window: rows ys .. ys + SLAB_WIN - 1 (periodic y) of the
    // three border columns; src[(ch SLAB_WIN + r) SLAB + col]
    const int ys = side == 0 ? j0 - jplus - 2 : j0 + jplus - 1;
    const T* base = S + (long long)kz * d.ny * d.nx + (side == 0 ? d.nx - SLAB : 0);
    slab_items(8 * SLAB_WIN, [&](int i) {
      const T* row = base + i / SLAB_WIN * d.n + mod_n(ys + i % SLAB_WIN, d.ny) * d.nx;
#pragma unroll
      for (int col = 0; col < SLAB; ++col) copy_async(src + i * SLAB + col, row + col);
    });
    copy_async_wait();
    block_sync();
    // each value from its two samples: the lower rows (r, r + 1, r + 2)
    // and the upper (r + 1 .. r + 3) of row jl, each value b and its
    // limited slope s; XMIN interpolates from the upper to the lower
    // sample (b0 upper, b1 lower), XMAX from the lower to the upper
    const bool zfix = Z != nullptr && (kz == 0 || kz == d.nz - 1);
    T* out = slabs + ((long long)(side * 8) * d.nz + kz) * d.ny * SLAB;
    slab_items(SLAB_OUT, [&](int i) {
      const int col = i % SLAB, jl = i / SLAB % SLAB_RUN, ch = i / (SLAB * SLAB_RUN);
      if (jl >= nrow) return;
      const T* s = src + (ch * SLAB_WIN + jl) * SLAB + col;
      const T q0 = s[0], q1 = s[SLAB], q2 = s[2 * SLAB], q3 = s[3 * SLAB];
      const T s_lo = slope1(q0, q1, q2, ph.slope), s_hi = slope1(q1, q2, q3, ph.slope);
      T val;
      if (ch == IB)
        val = q1 + eps * s_lo;
      else if (side == 0)
        val = (T(1) - eps) * q1 + eps * q2 + lam * (s_lo - s_hi);
      else
        val = (T(1) - eps) * q1 + eps * q2 - lam * (s_lo - s_hi);
      if (side == 1 && ch == IA && col == 0)
        val = kept[(long long)kz * d.ny + j0 + jl];  // the kept face
      out[((long long)ch * d.nz * d.ny + j0 + jl) * SLAB + col] = val;
      if (zfix) vals[i] = val;
    });
    if (!zfix) return;
    block_sync();
    // the z ghosts of these slab columns (a source row of Z)
    for (int zside = 0; zside < 2; ++zside) {
      if (kz != (zside ? d.nz - 1 : 0)) continue;
      const int x0 = side == 0 ? 0 : d.nx + SLAB;
      slab_items(8 * SLAB * SLAB_RUN * SLAB, [&](int i) {
        const int col = i % SLAB, jl = i / SLAB % SLAB_RUN, row = i / (SLAB * SLAB_RUN) % SLAB;
        const int ch = i / (SLAB * SLAB_RUN * SLAB);
        if (jl >= nrow) return;
        const T cum = zside ? hi[row] : lo[SLAB - 1 - row];
        const T v = zghost(ch, zside, cum,
                           [&](int c) { return vals[(c * SLAB_RUN + jl) * SLAB + col]; });
        Z[zat(zside, ch, row, j0 + jl) + x0 + col] = v;
      });
    }
  }

  // the z ghosts of the interior columns: cell c of the source row's plane
  HD void zslab(long long b) const {
    const int zside = (int)(b / zper);
    const int c0 = (int)(b % zper) * SLAB_NT;
    const int plane = d.nx * d.ny;
    const T* base = S + (long long)(zside ? d.nz - 1 : 0) * plane;
    block_items(SLAB_NT, [&](int i) {
      const int c = c0 + i;
      if (c >= plane) return;
      const int j = c / d.nx, x = c - j * d.nx;
      T v[8];
#pragma unroll
      for (int ch = 0; ch < 8; ++ch)
        if (ch != IA && ch != IB) v[ch] = base[ch * d.n + c];
#pragma unroll
      for (int ch = 0; ch < 8; ++ch)
#pragma unroll
        for (int row = 0; row < SLAB; ++row) {
          const T cum = zside ? hi[row] : lo[SLAB - 1 - row];
          Z[zat(zside, ch, row, j) + SLAB + x] =
              zghost(ch, zside, cum, [&](int q) { return v[q]; });
        }
    });
  }
};

// the remap's shift at t + dt/2 (godunov_mhd.py:583-585) and the step's
// ratios, formed once per block
template <typename T>
struct Remap {
  T w, dtdx, dtdy, dtdz;
  int jplus;
  bool active;
};

// indices of a border row's loaded values
enum { U_F0, U_F1, U_E2, U_E3, U_E2P, U_E3P, U_Z4, U_Z4P, NU };  // planes at j (P: +1 z; Z4P: j + 1)
enum {  // planes at the sheared y: "m" j - jplus - 1 / j - jplus, "p" j + jplus / j + jplus + 1
  G_F1M1, G_F1M0, G_F0P0, G_F0P1, G_E3M1, G_E3M0, G_E2P0, G_E2P1,
  G_E3M1P, G_E3M0P, G_E2P0P, G_E2P1P, NG
};
enum { B_RHO_LO, B_BX_LO, B_BZ_LO, B_RHO_HI, B_BZ_HI, B_KEPT, NB };  // border values

template <typename T>
struct BorderRow {
  T u[NU], g[NG], b[NB], cb[NB];  // cb: the carries of b (compensated)
};

// godunov_mhd.py:574 _shear_remap_pair_stacked at one row: each side's
// half-sum with the other side interpolated at the sheared y
template <typename T>
HD T remap_min(T here, T m1, T m0, T w) {
  return T(0.5) * (here + (w * m1 + (T(1) - w) * m0));
}
template <typename T>
HD T remap_max(T here, T p0, T p1, T w) {
  return T(0.5) * (here + ((T(1) - w) * p0 + w * p1));
}

constexpr int BORDER_NT = 128;  // threads (rows) of a border block
constexpr int BORDER_SHIFT = 6;  // tile values of the block's shift
constexpr int BORDER_ROW = NU + NB;  // tile values of a row's early loads

// The border kernel, a block body of launch_blocks: block b fixes the rows
// c = b BORDER_NT + i, i < BORDER_NT, of the nz ny (z, y) rows.
template <typename T>
struct BorderFix {
  static constexpr int NT = BORDER_NT;
  static constexpr int MIN_BLOCKS = 8;
  // the shift (Remap), then value q of row i's early loads at q NT + i
  static constexpr long long BYTES = (BORDER_SHIFT + BORDER_ROW * NT) * (long long)sizeof(T);
  T* S;
  T* kept;
  T* C;       // compensated: [8][n] the state's Kahan carry, else null
  T* kept_c;  // compensated: [nz][ny] the kept face's carry
  const T* planes;   // [5][nz][ny]: fpl_min, fpl_max, eypl_min, eypl_max, ezpl_max
  T* remapped;       // [4][nz][ny]: the first four after the remap
  const T* t;
  const T* dt;
  const unsigned char* active;
  Dims d;
  Phys<T> ph;
  Consts<T> k;

  // Each row's border values and unshifted planes go to the tile while
  // thread 0 forms the shift (the row's loads issued first, so they are in
  // flight while it waits on t and dt); after the barrier, each row its
  // shifted gathers, carries and arithmetic.
  HD void operator()(long long b, T* tile) const {
    const int c0 = (int)b * NT, rows = d.nz * d.ny;
    block_items(NT, [&](int i) {
      const int c = c0 + i;
      BorderRow<T> r;
      if (c < rows) load(c, r);
      if (i == 0) {
        const Remap<T> m = remap();
        tile[0] = m.w;
        tile[1] = m.dtdx;
        tile[2] = m.dtdy;
        tile[3] = m.dtdz;
        tile[4] = T(m.jplus);
        tile[5] = T(m.active ? 1 : 0);
      }
      if (c >= rows) return;
      T* v = tile + BORDER_SHIFT + i;
#pragma unroll
      for (int q = 0; q < NU; ++q) v[q * NT] = r.u[q];
#pragma unroll
      for (int q = 0; q < NB; ++q) v[(NU + q) * NT] = r.b[q];
    });
    block_sync();
    if (tile[5] == T(0)) return;
    Remap<T> m;
    m.w = tile[0];
    m.dtdx = tile[1];
    m.dtdy = tile[2];
    m.dtdz = tile[3];
    m.jplus = to_int(tile[4]);
    m.active = true;
    block_items(NT, [&](int i) {
      const int c = c0 + i;
      if (c >= rows) return;
      const T* v = tile + BORDER_SHIFT + i;
      BorderRow<T> r;
#pragma unroll
      for (int q = 0; q < NU; ++q) r.u[q] = v[q * NT];
#pragma unroll
      for (int q = 0; q < NB; ++q) r.b[q] = v[(NU + q) * NT];
      apply(c, m, r);
    });
  }

  HD Remap<T> remap() const {
    Remap<T> m;
    m.active = *active != 0;
    const T tv = *t, dtv = *dt;
    const T deltay = r_fmod(r_mul(k.remap_k, tv + T(0.5) * dtv), k.remap_ly);
    m.jplus = to_int(r_floor(deltay / ph.dy));
    m.w = r_fmod(deltay, ph.dy) / ph.dy;
    m.dtdx = dtv / ph.dx;
    m.dtdy = dtv / ph.dy;
    m.dtdz = dtv / ph.dz;
    return m;
  }
  // plane p of z row kz
  HD const T* P(int p, int kz) const { return planes + ((long long)p * d.nz + kz) * d.ny; }

  // row c = kz ny + j: the border values (and their carries) and the
  // planes read at j, none of which depends on the shift
  HD void load(int c, BorderRow<T>& r) const {
    const int j = c % d.ny, kz = c / d.ny, kp = wrap_p(kz, d.nz);
    const long long n = d.n, lo = (long long)c * d.nx, hi = lo + d.nx - 1;
    r.b[B_RHO_LO] = S[ID * n + lo];
    r.b[B_BX_LO] = S[IA * n + lo];
    r.b[B_BZ_LO] = S[IC * n + lo];
    r.b[B_RHO_HI] = S[ID * n + hi];
    r.b[B_BZ_HI] = S[IC * n + hi];
    r.b[B_KEPT] = kept[c];
    r.u[U_F0] = P(0, kz)[j];
    r.u[U_F1] = P(1, kz)[j];
    r.u[U_E2] = P(2, kz)[j];
    r.u[U_E3] = P(3, kz)[j];
    r.u[U_E2P] = P(2, kp)[j];
    r.u[U_E3P] = P(3, kp)[j];
    r.u[U_Z4] = P(4, kz)[j];
    r.u[U_Z4P] = P(4, kz)[wrap_p(j, d.ny)];
  }

  // the sheared gathers, then the remap, the deltas and the stores
  HD void apply(int c, const Remap<T>& m, BorderRow<T>& r) const {
    const int j = c % d.ny, kz = c / d.ny, kp = wrap_p(kz, d.nz), ny = d.ny;
    const int jm1 = mod_n(j - m.jplus - 1, ny), jm0 = mod_n(j - m.jplus, ny);
    const int jp0 = mod_n(j + m.jplus, ny), jp1 = mod_n(j + m.jplus + 1, ny);
    const T *p0 = P(0, kz), *p1 = P(1, kz), *p2 = P(2, kz), *p3 = P(3, kz);
    const T *p2p = P(2, kp), *p3p = P(3, kp);
    r.g[G_F1M1] = p1[jm1];
    r.g[G_F1M0] = p1[jm0];
    r.g[G_F0P0] = p0[jp0];
    r.g[G_F0P1] = p0[jp1];
    r.g[G_E3M1] = p3[jm1];
    r.g[G_E3M0] = p3[jm0];
    r.g[G_E2P0] = p2[jp0];
    r.g[G_E2P1] = p2[jp1];
    r.g[G_E3M1P] = p3p[jm1];
    r.g[G_E3M0P] = p3p[jm0];
    r.g[G_E2P0P] = p2p[jp0];
    r.g[G_E2P1P] = p2p[jp1];
    if (C) {
      const long long n = d.n, lo = (long long)c * d.nx, hi = lo + d.nx - 1;
      r.cb[B_RHO_LO] = C[ID * n + lo];
      r.cb[B_BX_LO] = C[IA * n + lo];
      r.cb[B_BZ_LO] = C[IC * n + lo];
      r.cb[B_RHO_HI] = C[ID * n + hi];
      r.cb[B_BZ_HI] = C[IC * n + hi];
      r.cb[B_KEPT] = kept_c[c];
    }

    const T w = m.w;
    const T fmin_r = remap_min(r.u[U_F0], r.g[G_F1M1], r.g[G_F1M0], w);
    const T fmax_r = remap_max(r.u[U_F1], r.g[G_F0P0], r.g[G_F0P1], w);
    const T emin_r = remap_min(r.u[U_E2], r.g[G_E3M1], r.g[G_E3M0], w);
    const T emax_r = remap_max(r.u[U_E3], r.g[G_E2P0], r.g[G_E2P1], w);
    const T d_emin = emin_r - r.u[U_E2];
    const T d_emin_p = remap_min(r.u[U_E2P], r.g[G_E3M1P], r.g[G_E3M0P], w) - r.u[U_E2P];
    const T d_emax = emax_r - r.u[U_E3];
    const T emax_r_p = remap_max(r.u[U_E3P], r.g[G_E2P0P], r.g[G_E2P1P], w);

    // border-column deltas (shear_packed.py:1128-1157): density remap with
    // the floor (shearingBox_utils.cuh:484-485), dbx at the xmin face, dbz;
    // the CT of the kept Bx face with the remapped emfY (:1161-1168)
    T d_[NB];
    d_[B_RHO_LO] = m.dtdx * (fmin_r - r.u[U_F0]);
    d_[B_BX_LO] = -m.dtdz * (d_emin_p - d_emin);
    d_[B_BZ_LO] = -m.dtdx * d_emin;
    d_[B_RHO_HI] = -m.dtdx * (fmax_r - r.u[U_F1]);
    d_[B_BZ_HI] = m.dtdx * d_emax;
    d_[B_KEPT] = m.dtdy * (r.u[U_Z4P] - r.u[U_Z4]) - m.dtdz * (emax_r_p - emax_r);
    if (C) {
      // Kahan adds with the carries; where the density floor fires the
      // carry is reset (shear_packed.py:1139-1147)
#pragma unroll
      for (int q = 0; q < NB; ++q) kahan_add(r.b[q], r.cb[q], d_[q]);
#pragma unroll
      for (int q = B_RHO_LO; q <= B_RHO_HI; q += B_RHO_HI - B_RHO_LO) {
        const T fl = pmax(r.b[q], ph.smallr);
        r.cb[q] = fl == r.b[q] ? r.cb[q] : T(0);
        r.b[q] = fl;
      }
    } else {
#pragma unroll
      for (int q = 0; q < NB; ++q) r.b[q] = r.b[q] + d_[q];
      r.b[B_RHO_LO] = pmax(r.b[B_RHO_LO], ph.smallr);
      r.b[B_RHO_HI] = pmax(r.b[B_RHO_HI], ph.smallr);
    }
    const long long n = d.n, lo = (long long)c * d.nx, hi = lo + d.nx - 1;
    S[ID * n + lo] = r.b[B_RHO_LO];
    S[IA * n + lo] = r.b[B_BX_LO];
    S[IC * n + lo] = r.b[B_BZ_LO];
    S[ID * n + hi] = r.b[B_RHO_HI];
    S[IC * n + hi] = r.b[B_BZ_HI];
    kept[c] = r.b[B_KEPT];
    if (C) {
      C[ID * n + lo] = r.cb[B_RHO_LO];
      C[IA * n + lo] = r.cb[B_BX_LO];
      C[IC * n + lo] = r.cb[B_BZ_LO];
      C[ID * n + hi] = r.cb[B_RHO_HI];
      C[IC * n + hi] = r.cb[B_BZ_HI];
      kept_c[c] = r.cb[B_KEPT];
    }
    const int np = d.nz * d.ny;
    remapped[c] = fmin_r;
    remapped[np + c] = fmax_r;
    remapped[2 * np + c] = emin_r;
    remapped[3 * np + c] = emax_r;
  }
};

// Z: the stratified z slabs [2][8][SLAB][ny][nx + 2 SLAB], built in the
// same launch, or null
template <typename T>
int shear_slabs(const T* S, const T* kept, T* slabs, T* Z, const T* t, const T* dt, int nx,
                int ny, int nz, const double* prm, void* stream) {
  SlabBuild<T> f;
  f.S = S;
  f.kept = kept;
  f.slabs = slabs;
  f.Z = Z;
  f.t = t;
  f.dt = dt;
  f.d = make_dims(nx, ny, nz);
  f.ph = make_phys<T>(prm);
  f.k = make_consts<T>(prm);
  for (int r = 0; r < SLAB; ++r) {
    f.lo[r] = T(prm[P_ZLO0 + r]);
    f.hi[r] = T(prm[P_ZHI0 + r]);
  }
  f.runs = (ny + SLAB_RUN - 1) / SLAB_RUN;
  f.xblocks = 2LL * nz * f.runs;
  f.zper = ((long long)nx * ny + SLAB_NT - 1) / SLAB_NT;
  return launch_blocks<T>(f, f.xblocks + (Z ? 2 * f.zper : 0), stream);
}

// comp: S holds 16 channels (the state, then its carry), kept two planes
// (the face, then its carry)
template <typename T>
int shear_border(T* S, T* kept, const T* planes, T* remapped, const T* t, const T* dt,
                 const unsigned char* active, bool comp, int nx, int ny, int nz,
                 const double* prm, void* stream) {
  const Dims d = make_dims(nx, ny, nz);
  BorderFix<T> f{S, kept, comp ? S + 8 * d.n : nullptr, comp ? kept + (long long)ny * nz : nullptr,
                 planes, remapped, t, dt, active, d, make_phys<T>(prm), make_consts<T>(prm)};
  return launch_blocks<T>(f, ((long long)nz * ny + BORDER_NT - 1) / BORDER_NT, stream);
}

}  // namespace ramses::shear

extern "C" {

// Z: the stratified z slabs, built in the same launch, or null
int ramses_shear_slabs_f32(const float* S, const float* kept, float* slabs, float* Z,
                           const float* t, const float* dt, int nx, int ny, int nz,
                           const double* prm, void* stream) {
  return ramses::shear::shear_slabs<float>(S, kept, slabs, Z, t, dt, nx, ny, nz, prm, stream);
}

int ramses_shear_slabs_f64(const double* S, const double* kept, double* slabs, double* Z,
                           const double* t, const double* dt, int nx, int ny, int nz,
                           const double* prm, void* stream) {
  return ramses::shear::shear_slabs<double>(S, kept, slabs, Z, t, dt, nx, ny, nz, prm, stream);
}

// comp: S holds 16 channels (the state, then its carry), kept two planes
int ramses_shear_border_f32(float* S, float* kept, const float* planes, float* remapped,
                            const float* t, const float* dt, const unsigned char* active,
                            int comp, int nx, int ny, int nz, const double* prm, void* stream) {
  return ramses::shear::shear_border<float>(S, kept, planes, remapped, t, dt, active, comp != 0,
                                            nx, ny, nz, prm, stream);
}

int ramses_shear_border_f64(double* S, double* kept, const double* planes, double* remapped,
                            const double* t, const double* dt, const unsigned char* active,
                            int comp, int nx, int ny, int nz, const double* prm, void* stream) {
  return ramses::shear::shear_border<double>(S, kept, planes, remapped, t, dt, active, comp != 0,
                                             nx, ny, nz, prm, stream);
}

}  // extern "C"

#ifdef RAMSES_COUNT_OPS
// the floating-point operations of the kernels on a state (op_count.cuh):
// out[0] the x slab build, out[1] the border kernel (comp: S of 16
// channels, kept two planes), out[2] what the z slabs add to the slab build
extern "C" void ramses_shear_border_ops(const double* S, const double* kept,
                                        const double* planes, int comp, int nx, int ny, int nz,
                                        const double* prm, double t, double dt, long long* out) {
  using ramses::Counted;
  using ramses::shear::SLAB;
  const long long np = (long long)nz * ny, nc = comp ? 16 : 8;
  std::vector<Counted> s = ramses::counted_copy(S, nc * nx * np);
  std::vector<Counted> kp = ramses::counted_copy(kept, (comp ? 2 : 1) * np);
  std::vector<Counted> pl = ramses::counted_copy(planes, ramses::shear::NPLANE * np);
  std::vector<Counted> slabs(2LL * 8 * np * SLAB), rem(4 * np);
  std::vector<Counted> zs(2LL * 8 * SLAB * ny * (nx + 2 * SLAB));
  const Counted tc(t), dtc(dt);
  const unsigned char active = 1;
  Counted::ops = 0;
  ramses::shear::shear_slabs<Counted>(s.data(), kp.data(), slabs.data(), nullptr, &tc, &dtc, nx,
                                      ny, nz, prm, nullptr);
  out[0] = Counted::ops;
  Counted::ops = 0;
  ramses::shear::shear_border<Counted>(s.data(), kp.data(), pl.data(), rem.data(), &tc, &dtc,
                                       &active, comp != 0, nx, ny, nz, prm, nullptr);
  out[1] = Counted::ops;
  Counted::ops = 0;
  ramses::shear::shear_slabs<Counted>(s.data(), kp.data(), slabs.data(), zs.data(), &tc, &dtc, nx,
                                      ny, nz, prm, nullptr);
  out[2] = Counted::ops - out[0];
}
#endif
