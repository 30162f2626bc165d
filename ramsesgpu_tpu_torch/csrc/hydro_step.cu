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
// Two load layouts, chosen by the template parameter GHOSTED:
//  - interior mode (the loops, rows A'-hydro and 6): the state is
//    interior-only, S[5][nz][ny][nx], updated in place. A neighbour load
//    outside the interior maps its index per axis: PERIODIC wraps, NEUMANN
//    clamps, DIRICHLET mirrors (i -> -1-i on the min side, 2n-1-i on the
//    max side; boundary.py:87-92) and flips the sign of that axis's normal
//    velocity. Composing the per-axis maps gives exactly what the X->Y->Z
//    make_boundaries writes into edge and corner ghosts, since copies and
//    sign flips are exact; so the TPU kernel's in-kernel ghost rebuild
//    becomes a load rule, and no ghost is ever written.
//  - ghosted mode (row 5): reads a ghosted U[5][nz+4][ny+4][nx+4] as it
//    is and writes the interior to a separate out[5][nz][ny][nx], or, in
//    place (ghosted = 2; the jet's loop on the ghosted state), into U's
//    own interior: the update reads only its cell of U, after the stages
//    that read the rest.
//
// Design (first, simple version): three kinds of stage, one thread per
// cell or face each, intermediates in one scratch buffer the wrapper
// allocates once per advance:
//   1 prim          U -> Q[5]          constoprim (the interior, or the
//                                      whole ghosted array)
//   2 flux x, y, z  Q -> F_ax[5]       per face: the trace of both adjacent
//                                      cells (7-point Q stencils), the
//                                      rotation into the x slots, the
//                                      Riemann solver, the rotation back
//   3 update        U + dt/dx dF       (in place in the interior mode)
// Face fluxes are stored with one more face along their axis
// ([5][nz][ny][nx+1] for x ...), so walls need no special case. Each face
// traces both its cells instead of reading stored face states: a cell's
// slopes and sources (trace_cell) are computed six times, once for each of
// its face states, which keeps the scratch at ~20 values/cell.
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
// stage; when it is 0 the step is skipped, so a chunk needs no host sync.
//
// Bound on the H100: the step must read the 5 conserved values of each cell
// and write them back, 40 B/cell in f32 (0.67 GB at 256^3, 0.20 ms at
// 3.35 TB/s). The arithmetic it needs (op_count.cuh, ramses_hydro_step_ops)
// is 356 flops per cell (primitives, one trace, update), 96 per face
// (Riemann solve) and 36 per Newton iteration of the approx solver, ~0.75
// kflop per cell on the implode state (~1 iteration per face), 0.19 ms at
// the f32 peak: the bound is the bytes. This version moves ~6x the minimum
// bytes (Q and the face fluxes round-trip through device memory) and
// traces every cell six times; one trace per cell, kept on chip around a
// shared-memory z-plane ring, is the next step for speed.
#include "hydro_stages.cuh"

namespace ramses::hydro {

// ---------------------------------------------------------------------------
// stages
// ---------------------------------------------------------------------------

template <typename T>
struct StepArgs {
  const T* U;   // the state: interior [5][n] or ghosted [5][ng]
  T* out;       // the new interior [5][n] (== U in the interior mode), or,
                // in place in the ghosted mode, U itself ([5][nq])
  bool in_place;  // ghosted mode: out is U, the interior at its ghosted index
  T* Q;         // [5][nq] primitives (nq = n, or ng in the ghosted mode)
  T* F[3];      // face fluxes x [5][nz][ny][nx+1], y [5][nz][ny+1][nx], z [5][nz+1][ny][nx]
  const T* dt;  // device scalar
  const unsigned char* active;  // device flag: 0 skips the step
  unsigned long long* newton;   // optional: sum of the approx solver's iterations
  int nx, ny, nz;
  long long n, nq;
  int bc[6];
  HydroPhys<T> ph;
};

// 1: eos.py constoprim_hydro over nq cells
template <typename T>
struct PrimStage {
  StepArgs<T> a;
  HD void operator()(long long c) const {
    if (!*a.active) return;
    prim_cell(a.ph, a.U + c, a.nq, a.Q + c, a.nq);
  }
};

template <typename T, bool GHOSTED>
HD Prim<T, GHOSTED> prim_of(const StepArgs<T>& a) {
  Prim<T, GHOSTED> prim;
  prim.Q = a.Q;
  prim.stride = a.nq;
  prim.nx = a.nx;
  prim.ny = a.ny;
  prim.nz = a.nz;
#pragma unroll
  for (int b = 0; b < 6; ++b) prim.bc[b] = a.bc[b];
  return prim;
}

// 2: the flux through the left face of cell (i, j, k) along AX: the qm of
// the previous cell against this cell's qp
template <typename T, bool GHOSTED, int AX>
struct FluxStage {
  StepArgs<T> a;
  HD void operator()(long long c) const {
    if (!*a.active) return;
    // faces: one more along AX than cells
    const int fx = a.nx + (AX == 0), fy = a.ny + (AX == 1);
    const int i = (int)(c % fx);
    const long long r = c / fx;
    const int j = (int)(r % fy);
    const int k = (int)(r / fy);
    const Prim<T, GHOSTED> prim = prim_of<T, GHOSTED>(a);
    const HydroPhys<T>& ph = a.ph;
    const T dt = *a.dt;
    const T dtdx = dt / ph.dx, dtdy = dt / ph.dy, dtdz = dt / ph.dz;

    T qm[NV], qp[NV], f[NV];
    trace_face<AX>(ph, prim, i - (AX == 0), j - (AX == 1), k - (AX == 2), T(1), dtdx, dtdy,
                   dtdz, qm);
    trace_face<AX>(ph, prim, i, j, k, T(-1), dtdx, dtdy, dtdz, qp);
    const int it = face_flux<AX>(ph, qm, qp, f);
    if (ph.solver == SOLVER_APPROX && a.newton) {
#ifdef __CUDA_ARCH__
      const unsigned mask = __activemask();
      const unsigned total = __reduce_add_sync(mask, (unsigned)it);
      if ((threadIdx.x & 31) == __ffs(mask) - 1) atomicAdd(a.newton, (unsigned long long)total);
#else
      *a.newton += (unsigned long long)it;
#endif
    }
    T* out = a.F[AX];
    const long long nf = (long long)fx * fy * (a.nz + (AX == 2));
#pragma unroll
    for (int ch = 0; ch < NV; ++ch) out[ch * nf + c] = f[ch];
  }
};

// 3: godunov.py hydro_3d_interior_update: ((U + x part) + y part) + z part
template <typename T, bool GHOSTED>
struct UpdateStage {
  StepArgs<T> a;
  HD void operator()(long long c) const {
    if (!*a.active) return;
    const int nx = a.nx, ny = a.ny, nz = a.nz;
    const int i = (int)(c % nx);
    const long long r = c / nx;
    const int j = (int)(r % ny);
    const int k = (int)(r / ny);
    const long long cu =
        GHOSTED ? ((long long)(k + G) * (ny + 2 * G) + (j + G)) * (nx + 2 * G) + (i + G) : c;
    const T dt = *a.dt;
    const HydroPhys<T>& ph = a.ph;
    const T dtdx = dt / ph.dx, dtdy = dt / ph.dy, dtdz = dt / ph.dz;
    const long long nfx = (long long)nz * ny * (nx + 1);
    const long long nfy = (long long)nz * (ny + 1) * nx;
    const long long nfz = (long long)(nz + 1) * ny * nx;
    const long long cx = ((long long)k * ny + j) * (nx + 1) + i;
    const long long cy = ((long long)k * (ny + 1) + j) * nx + i;
    const long long cz = c;  // z faces: [nz+1][ny][nx], face k of cell c sits at c
#pragma unroll
    for (int ch = 0; ch < NV; ++ch) {
      const T* fx = a.F[0] + ch * nfx;
      const T* fy = a.F[1] + ch * nfy;
      const T* fz = a.F[2] + ch * nfz;
      T* out = a.in_place ? a.out + ch * a.nq + cu : a.out + ch * a.n + c;
      *out = update_value(a.U[ch * a.nq + cu], fx[cx], fx[cx + 1], fy[cy],
                                         fy[cy + nx], fz[cz], fz[cz + (long long)ny * nx],
                                         dtdx, dtdy, dtdz);
    }
  }
};

template <typename T>
long long scratch_values(int nx, int ny, int nz, int ghosted) {
  const long long nq = ghosted ? (long long)(nx + 2 * G) * (ny + 2 * G) * (nz + 2 * G)
                               : (long long)nx * ny * nz;
  const long long nf = (long long)nz * ny * (nx + 1) + (long long)nz * (ny + 1) * nx +
                       (long long)(nz + 1) * ny * nx;
  return NV * (nq + nf);
}

template <typename T, bool GHOSTED>
int hydro_step(StepArgs<T> a, void* stream) {
  int err;
  if ((err = launch_cells(PrimStage<T>{a}, a.nq, stream))) return err;
  const long long nx = a.nx, ny = a.ny, nz = a.nz;
  if ((err = launch_cells(FluxStage<T, GHOSTED, 0>{a}, nz * ny * (nx + 1), stream))) return err;
  if ((err = launch_cells(FluxStage<T, GHOSTED, 1>{a}, nz * (ny + 1) * nx, stream))) return err;
  if ((err = launch_cells(FluxStage<T, GHOSTED, 2>{a}, (nz + 1) * ny * nx, stream))) return err;
  return launch_cells(UpdateStage<T, GHOSTED>{a}, a.n, stream);
}

// in: the state (interior mode: S, updated in place, so out == in;
// ghosted mode: the ghosted U); ghosted: 0 interior mode, 1 ghosted mode
// into out, 2 ghosted mode in place (out == in); bc: the six face types
// (interior mode)
template <typename T>
int hydro_step_entry(const T* in, T* out, T* scratch, const T* dt, const unsigned char* active,
                     int nx, int ny, int nz, int ghosted, const int* bc, const double* prm,
                     unsigned long long* newton, void* stream) {
  StepArgs<T> a;
  a.U = in;
  a.out = out;
  a.in_place = ghosted == 2;
  a.nx = nx;
  a.ny = ny;
  a.nz = nz;
  a.n = (long long)nx * ny * nz;
  a.nq = ghosted ? (long long)(nx + 2 * G) * (ny + 2 * G) * (nz + 2 * G) : a.n;
  a.Q = scratch;
  a.F[0] = a.Q + NV * a.nq;
  a.F[1] = a.F[0] + NV * (long long)nz * ny * (nx + 1);
  a.F[2] = a.F[1] + NV * (long long)nz * (ny + 1) * nx;
  a.dt = dt;
  a.active = active;
  a.newton = newton;
  for (int b = 0; b < 6; ++b) a.bc[b] = bc[b];
  a.ph = make_hydro_phys<T>(prm);
  return ghosted ? hydro_step<T, true>(a, stream) : hydro_step<T, false>(a, stream);
}

}  // namespace ramses::hydro

extern "C" {

long long ramses_hydro_step_scratch(int nx, int ny, int nz, int ghosted) {
  return ramses::hydro::scratch_values<float>(nx, ny, nz, ghosted);
}

int ramses_hydro_step_f32(const float* in, float* out, float* scratch, const float* dt,
                          const unsigned char* active, int nx, int ny, int nz, int ghosted,
                          const int* bc, const double* prm, unsigned long long* newton,
                          void* stream) {
  return ramses::hydro::hydro_step_entry<float>(in, out, scratch, dt, active, nx, ny, nz, ghosted, bc,
                                         prm, newton, stream);
}

int ramses_hydro_step_f64(const double* in, double* out, double* scratch, const double* dt,
                          const unsigned char* active, int nx, int ny, int nz, int ghosted,
                          const int* bc, const double* prm, unsigned long long* newton,
                          void* stream) {
  return ramses::hydro::hydro_step_entry<double>(in, out, scratch, dt, active, nx, ny, nz, ghosted, bc,
                                          prm, newton, stream);
}

}  // extern "C"

#ifdef RAMSES_COUNT_OPS
namespace ramses::hydro {

// the flux of every face along AX, counting only the rotation and the
// Riemann solve: the two face states are formed with the count paused
template <int AX>
void count_face_fluxes(const StepArgs<Counted>& a, const Prim<Counted, false>& prim,
                       Counted dtdx, Counted dtdy, Counted dtdz, unsigned long long* newton) {
  for (int k = 0; k < a.nz + (AX == 2); ++k)
    for (int j = 0; j < a.ny + (AX == 1); ++j)
      for (int i = 0; i < a.nx + (AX == 0); ++i) {
        Counted qm[NV], qp[NV], f[NV];
        const long long paused = Counted::ops;
        trace_face<AX>(a.ph, prim, i - (AX == 0), j - (AX == 1), k - (AX == 2), Counted(1),
                       dtdx, dtdy, dtdz, qm);
        trace_face<AX>(a.ph, prim, i, j, k, Counted(-1), dtdx, dtdy, dtdz, qp);
        Counted::ops = paused;
        const int it = face_flux<AX>(a.ph, qm, qp, f);
        if (newton) *newton += (unsigned long long)it;
      }
}

}  // namespace ramses::hydro

// The floating-point operations one interior-mode step of S[5][nz][ny][nx]
// needs (op_count.cuh), on the kernel's own per-cell functions: ops[0] the
// primitives of every cell; ops[1] one trace of every cell (its slopes and
// sources once, and its six face states); ops[2] the rotated Riemann solve
// of every face (the approx solver's Newton iterations included, summed
// into *newton); ops[3] the update. The staged kernel traces each cell six
// times (once per face state, each beside a fresh copy of the shared
// slopes and sources); that recomputation is the kernel's cost, not the
// step's, so it is not counted.
extern "C" void ramses_hydro_step_ops(const double* S, int nx, int ny, int nz, const int* bc,
                                      const double* prm, double dt, long long* ops,
                                      unsigned long long* newton) {
  using namespace ramses;
  using namespace ramses::hydro;
  const long long n = (long long)nx * ny * nz;
  std::vector<Counted> s = counted_copy(S, NV * n);
  std::vector<Counted> scratch(scratch_values<Counted>(nx, ny, nz, 0));
  const Counted dtc(dt);
  const unsigned char active = 1;
  StepArgs<Counted> a;
  a.U = s.data();
  a.out = s.data();
  a.in_place = false;
  a.nx = nx;
  a.ny = ny;
  a.nz = nz;
  a.n = a.nq = n;
  a.Q = scratch.data();
  a.F[0] = a.Q + NV * n;
  a.F[1] = a.F[0] + NV * (long long)nz * ny * (nx + 1);
  a.F[2] = a.F[1] + NV * (long long)nz * (ny + 1) * nx;
  a.dt = &dtc;
  a.active = &active;
  a.newton = nullptr;
  for (int b = 0; b < 6; ++b) a.bc[b] = bc[b];
  a.ph = make_hydro_phys<Counted>(prm);

  Counted::ops = 0;
  launch_cells(PrimStage<Counted>{a}, n, nullptr);
  ops[0] = Counted::ops;

  const Prim<Counted, false> prim = prim_of<Counted, false>(a);
  const Counted dtdx = dtc / a.ph.dx, dtdy = dtc / a.ph.dy, dtdz = dtc / a.ph.dz;
  Counted::ops = 0;
  for (int k = 0; k < nz; ++k)
    for (int j = 0; j < ny; ++j)
      for (int i = 0; i < nx; ++i) {
        CellTrace<Counted> c;
        Counted out[NV];
        trace_cell(a.ph, prim, i, j, k, dtdx, dtdy, dtdz, c);
        for (const Counted sign : {Counted(1), Counted(-1)}) {
          face_state<0>(a.ph, c, sign, out);
          face_state<1>(a.ph, c, sign, out);
          face_state<2>(a.ph, c, sign, out);
        }
      }
  ops[1] = Counted::ops;

  Counted::ops = 0;
  count_face_fluxes<0>(a, prim, dtdx, dtdy, dtdz, newton);
  count_face_fluxes<1>(a, prim, dtdx, dtdy, dtdz, newton);
  count_face_fluxes<2>(a, prim, dtdx, dtdy, dtdz, newton);
  ops[2] = Counted::ops;

  Counted::ops = 0;  // the update's operations do not depend on the fluxes' values
  launch_cells(UpdateStage<Counted, false>{a}, n, nullptr);
  ops[3] = Counted::ops;
}
#endif
