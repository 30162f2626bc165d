// One unsplit MUSCL-Hancock step of 3D hydrodynamics (g = 2): primitives
// -> slopes (slope_type 0/1/2) -> trace to face states -> approx / HLL /
// HLLC face Riemann problems -> flux-difference update. f32 and f64.
//
// Replaces three TPU kernels, which all run this body
// (ramsesgpu_tpu/solvers/godunov.py:78 hydro_3d_interior_update):
//   A'-hydro  pallas/packed_io.py:148 make_packed_io_step with the hydro
//             body pallas/fused_hydro3d.py:182 (the periodic loop);
//   5         pallas/fused_hydro3d.py:46 make_fused_hydro_update (a
//             ghosted state in, its interior out);
//   6         pallas/packed_bc.py:126 make_packed_bc_step (the walled loop,
//             ghost lanes and bands rebuilt in-kernel).
// Plain twins: ramsesgpu_tpu_torch/solvers/godunov.py
// hydro_3d_state_update (interior mode) and hydro_3d_interior_update
// (ghosted mode).
//
// One launch of the streamed block body (hydro_stream.cuh, which describes
// the design; zcarry_hydro.cu runs it too, with the CFL folded in), in
// three modes:
//  - interior mode (the loops, rows A'-hydro and 6): the state is
//    interior-only, S[5][nz][ny][nx], and the new state goes to another
//    buffer (the loop swaps the two). A copied value outside the interior
//    maps its index per axis (hydro_stages.cuh map_axis): PERIODIC wraps,
//    NEUMANN clamps, DIRICHLET mirrors and negates that axis's momentum; so
//    the TPU kernel's in-kernel ghost rebuild becomes a load rule, and no
//    ghost is ever written.
//  - ghosted mode (row 5): reads a ghosted U[5][nz+4][ny+4][nx+4] as it
//    is and writes the interior to a separate out[5][nz][ny][nx];
//  - in place (ghosted = 2; the jet's loop on the ghosted state): the same
//    into out, then out copied into U's interior (a second launch).
// A uniform static gravity (the parameter block's P_GX .. P_GZ, the
// [gravity] static_field_*) selects the gravity instance in every mode:
// the half-dt kick in the trace and the conservative source in the update
// (godunov.py:115-160); the vector rides in the launch's arguments, no
// gravity array goes to the device.
// Each cell is traced once, the intermediates stay in a per-block ring in
// shared memory, and the state is read once per copied value.
// The approx solver's fixed-count masked Newton loop (riemann.py:87-103)
// breaks per thread once conv <= 1e-6: a masked iteration changes nothing,
// so the result is the same.
//
// The per-cell physics is transcribed from the JAX formulas (ops/eos.py,
// ops/slopes.py, ops/trace.py, ops/riemann.py, solvers/godunov.py) in their
// op order, hoisted 1/pl, 1/pr and rsqrt included. Parity with the twin is
// tolerance-based (FMA contraction, rsqrtf), never bitwise.
//
// A device flag `active` (the loop's t < t_end test) is read by every
// thread; when it is 0 the step copies, so a chunk needs no host sync.
//
// Bound on the H100: the step must read the 5 conserved values of each cell
// and write them back, 40 B/cell in f32 (0.67 GB at 256^3, 0.20 ms at
// 3.35 TB/s). The arithmetic it needs (op_count.cuh, ramses_hydro_step_ops)
// is 356 flops per cell (primitives, one trace, update), 96 per face
// (Riemann solve) and 36 per Newton iteration of the approx solver, ~0.75
// kflop per cell on the implode state (~1 iteration per face), 0.19 ms at
// the f32 peak: the bound is the bytes. The ring's halo recomputes 1.9x
// the primitives and 1.4x the traces of a 16 x 8 tile's cells.
#include "hydro_stream.cuh"

namespace ramses::hydro {

// GRAV: the uniform static gravity's instance (hydro_stream.cuh Stream),
// chosen at launch when the parameter block carries one
#ifdef __CUDACC__
template <typename T, bool GRAV = false>
__global__ void __launch_bounds__(Ring<T>::NT, Ring<T>::PER_SM) hydro_step_kernel(ZArgs<T> z) {
  stream_block<T, GRAV>(z);
}
template <typename T, bool GRAV>
auto step_kernel() {
  return hydro_step_kernel<T, GRAV>;
}
#else
template <typename T, bool GRAV>
std::nullptr_t step_kernel() {
  return nullptr;
}
#endif

// the in-place mode's second launch: out into the interior of the ghosted U
template <typename T>
struct CopyBack {
  T* U;
  const T* out;
  const unsigned char* active;
  Dims d;
  long long ng;
  HD void operator()(long long c) const {
    if (!*active) return;
    int i, j, k;
    cell_ijk(d, c, i, j, k);
    const long long cu = ((long long)(k + G) * (d.ny + 2 * G) + (j + G)) * (d.nx + 2 * G) + (i + G);
    for (int ch = 0; ch < NV; ++ch) U[ch * ng + cu] = out[ch * d.n + c];
  }
};

// in: the state (interior mode: S; ghosted mode: the ghosted U); out: the
// new interior (another buffer); ghosted: 0 interior mode, 1 ghosted mode
// into out, 2 ghosted mode in place (out a buffer, then copied into U's
// interior); bc: the six face types (interior mode)
template <typename T>
int hydro_step_entry(T* in, T* out, int blocks, const T* dt, const unsigned char* active,
                     int nx, int ny, int nz, int ghosted, const int* bc, const double* prm,
                     unsigned long long* newton, void* stream) {
  const ZArgs<T> z = stream_args<T>(in, out, nullptr, dt, active, newton, nx, ny, nz,
                                    ghosted != 0, bc, prm);
  int err = has_gravity(prm)
                ? stream_step<T, decltype(step_kernel<T, true>()), true>(step_kernel<T, true>(), z,
                                                                         blocks, stream)
                : stream_step<T>(step_kernel<T, false>(), z, blocks, stream);
  if (!err && ghosted == 2)
    err = launch_cells(CopyBack<T>{in, out, active, z.d, z.ng}, z.d.n, stream);
  return err;
}

}  // namespace ramses::hydro

extern "C" {

// the persistent grid: as many blocks as the card holds at once (host
// build: 3, so the serial build strides over the items as the blocks do)
int ramses_hydro_step_blocks(int f64) {
#ifdef __CUDACC__
  using namespace ramses::hydro;
  int blocks = 0;
  const int err = f64 ? stream_resident<double>(hydro_step_kernel<double>, &blocks)
                      : stream_resident<float>(hydro_step_kernel<float>, &blocks);
  return err ? -err : blocks;
#else
  (void)f64;
  return 3;
#endif
}

// the streamed body's tile and threads (hydro_stream.cuh Tile): out[0] TX,
// out[1] TY, out[2] the threads, out[3] the producer group's, out[4] the
// consumer group's, out[5] the blocks an SM is built for
void ramses_hydro_stream_tile(int f64, int* out) {
  using namespace ramses::hydro;
  const auto fill = [&](auto t) {
    using R = Ring<decltype(t)>;
    out[0] = R::TX;
    out[1] = R::TY;
    out[2] = R::NT;
    out[3] = R::NA;
    out[4] = R::NB;
    out[5] = R::PER_SM;
  };
  if (f64)
    fill(0.0);
  else
    fill(0.0f);
}

// the bytes of one block's ring in shared memory
long long ramses_hydro_stream_ring_bytes(int f64) {
  using namespace ramses::hydro;
  return f64 ? Ring<double>::BYTES : Ring<float>::BYTES;
}

// the depth of the z chunks a step on an nx x ny x nz grid takes with a
// persistent grid of `blocks`
int ramses_hydro_stream_chunk_depth(int f64, int nx, int ny, int nz, int blocks) {
  using namespace ramses::hydro;
  return f64 ? chunk_depth<double>(nx, ny, nz, blocks) : chunk_depth<float>(nx, ny, nz, blocks);
}

// in: S [5][nz][ny][nx] (ghosted: [5][nz+4][ny+4][nx+4]); out: the new
// interior, another buffer; blocks: the persistent grid
// (ramses_hydro_step_blocks); newton: optional
int ramses_hydro_step_f32(float* in, float* out, int blocks, const float* dt,
                          const unsigned char* active, int nx, int ny, int nz, int ghosted,
                          const int* bc, const double* prm, unsigned long long* newton,
                          void* stream) {
  return ramses::hydro::hydro_step_entry<float>(in, out, blocks, dt, active, nx, ny, nz, ghosted,
                                                bc, prm, newton, stream);
}

int ramses_hydro_step_f64(double* in, double* out, int blocks, const double* dt,
                          const unsigned char* active, int nx, int ny, int nz, int ghosted,
                          const int* bc, const double* prm, unsigned long long* newton,
                          void* stream) {
  return ramses::hydro::hydro_step_entry<double>(in, out, blocks, dt, active, nx, ny, nz,
                                                 ghosted, bc, prm, newton, stream);
}

}  // extern "C"

#ifdef RAMSES_COUNT_OPS
namespace ramses::hydro {

// the primitives Q[5][cells] of an interior-only state through the load
// rule, as trace_cell loads them (the count's own loader: the kernel reads
// them from its ring)
template <typename T>
struct CountPrim {
  const T* Q;
  int nx, ny, nz;
  const int* bc;
  void load(int i, int j, int k, T* q) const {
    bool fx = false, fy = false, fz = false;
    const int ii = map_axis(i, nx, bc[0], bc[1], fx);
    const int jj = map_axis(j, ny, bc[2], bc[3], fy);
    const int kk = map_axis(k, nz, bc[4], bc[5], fz);
    const long long n = (long long)nx * ny * nz, c = ((long long)kk * ny + jj) * nx + ii;
    for (int ch = 0; ch < NV; ++ch) q[ch] = Q[ch * n + c];
    if (fx) q[IU] = -q[IU];
    if (fy) q[IV] = -q[IV];
    if (fz) q[IW] = -q[IW];
  }
};

// the flux of every face along AX, counting only the rotation and the
// Riemann solve: the two face states are formed with the count paused
template <int AX>
void count_face_fluxes(const HydroPhys<Counted>& ph, const CountPrim<Counted>& prim,
                       Counted dtdx, Counted dtdy, Counted dtdz, unsigned long long* newton) {
  for (int k = 0; k < prim.nz + (AX == 2); ++k)
    for (int j = 0; j < prim.ny + (AX == 1); ++j)
      for (int i = 0; i < prim.nx + (AX == 0); ++i) {
        Counted qm[NV], qp[NV], f[NV];
        const long long paused = Counted::ops;
        CellTrace<Counted> l, r;
        trace_cell(ph, prim, i - (AX == 0), j - (AX == 1), k - (AX == 2), dtdx, dtdy, dtdz, l);
        trace_cell(ph, prim, i, j, k, dtdx, dtdy, dtdz, r);
        face_state<AX>(ph, l, Counted(1), qm);
        face_state<AX>(ph, r, Counted(-1), qp);
        Counted::ops = paused;
        const int it = face_flux(ph, AX, qm, qp, f);
        if (newton) *newton += (unsigned long long)it;
      }
}

}  // namespace ramses::hydro

// The floating-point operations one interior-mode step of S[5][nz][ny][nx]
// needs (op_count.cuh), on the kernel's own per-cell functions: ops[0] the
// primitives of every cell; ops[1] one trace of every cell (its slopes and
// sources once, and its six face states); ops[2] the rotated Riemann solve
// of every face (the approx solver's Newton iterations included, summed
// into *newton); ops[3] the update (with its dt / dx, dt / dy, dt / dz).
// The ring's halo recomputation is the kernel's cost, not the step's, so
// it is not counted.
extern "C" void ramses_hydro_step_ops(const double* S, int nx, int ny, int nz, const int* bc,
                                      const double* prm, double dt, long long* ops,
                                      unsigned long long* newton) {
  using namespace ramses;
  using namespace ramses::hydro;
  const long long n = (long long)nx * ny * nz;
  std::vector<Counted> s = counted_copy(S, NV * n), q(NV * n), fl(6);
  const HydroPhys<Counted> ph = make_hydro_phys<Counted>(prm);
  const Counted dtc(dt);

  Counted::ops = 0;
  for (long long c = 0; c < n; ++c) prim_cell(ph, s.data() + c, n, q.data() + c, n);
  ops[0] = Counted::ops;

  const CountPrim<Counted> prim{q.data(), nx, ny, nz, bc};
  const Counted dtdx = dtc / ph.dx, dtdy = dtc / ph.dy, dtdz = dtc / ph.dz;
  Counted::ops = 0;
  for (int k = 0; k < nz; ++k)
    for (int j = 0; j < ny; ++j)
      for (int i = 0; i < nx; ++i) {
        CellTrace<Counted> c;
        Counted out[NV];
        trace_cell(ph, prim, i, j, k, dtdx, dtdy, dtdz, c);
        for (const Counted sign : {Counted(1), Counted(-1)}) {
          face_state<0>(ph, c, sign, out);
          face_state<1>(ph, c, sign, out);
          face_state<2>(ph, c, sign, out);
        }
      }
  ops[1] = Counted::ops;

  Counted::ops = 0;
  count_face_fluxes<0>(ph, prim, dtdx, dtdy, dtdz, newton);
  count_face_fluxes<1>(ph, prim, dtdx, dtdy, dtdz, newton);
  count_face_fluxes<2>(ph, prim, dtdx, dtdy, dtdz, newton);
  ops[2] = Counted::ops;

  Counted::ops = 0;  // the update's operations do not depend on the fluxes' values
  for (long long c = 0; c < n; ++c) {
    const Counted cdx = dtc / ph.dx, cdy = dtc / ph.dy, cdz = dtc / ph.dz;
    for (int ch = 0; ch < NV; ++ch)
      update_value(s[ch * n + c], fl[0], fl[1], fl[2], fl[3], fl[4], fl[5], cdx, cdy, cdz);
  }
  ops[3] = Counted::ops;
}
#endif
