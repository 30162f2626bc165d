// One 3D hydro step of a fully periodic state streamed over z, with the
// next step's CFL reduction folded in: hydro_step.cu's interior PERIODIC
// mode and cfl_hydro.cu's reduction in one launch.
//
// Replaces the TPU kernel ramsesgpu_tpu/pallas/zcarry_hydro3d.py:58
// make_zcarry_hydro_packed_io with with_inv_dt=True (the only form its
// loop uses, pallas/fused_hydro3d.py:232-233): the hydro step streamed
// over z, the stage planes carried, the inverse dt of the new state
// reduced in the kernel. Plain twin: solvers/godunov.py
// hydro_3d_state_update, then solvers/timestep.py compute_inv_dt_hydro on
// its result (kernels/zcarry_hydro3d.py).
//
// It runs the streamed block body of hydro_step.cu (hydro_stream.cuh,
// which describes the design) on the periodic load rule, so its new state
// is bitwise that kernel's; the thread that updates a cell also computes
// its inverse dt (cfl_hydro.cuh) from its registers, and the block's max
// goes into *inv through one atomic max on the float's bits (common.cuh
// atomic_max_nonneg).
//
// Bound on the H100: the step reads and writes the 5 conserved values of
// each cell, 40 B/cell in f32 (0.20 ms at 256^3 at 3.35 TB/s), and does
// ~0.75 kflop per cell with the approx solver (hydro_step.cu), 0.19 ms at
// the f32 peak, plus the CFL's ~25 flops: the bound is the bytes.
#include "hydro_stream.cuh"

namespace ramses::zhydro {

using namespace ramses::hydro;

#ifdef __CUDACC__
template <typename T>
__global__ void __launch_bounds__(Ring<T>::NT, Ring<T>::PER_SM) zcarry_hydro_kernel(ZArgs<T> z) {
  stream_block<T>(z);
}
template <typename T>
auto step_kernel() {
  return zcarry_hydro_kernel<T>;
}
#else
template <typename T>
std::nullptr_t step_kernel() {
  return nullptr;
}
#endif

template <typename T>
int zcarry_hydro(const T* S, T* So, int blocks, T* inv, const T* dt,
                 const unsigned char* active, int nx, int ny, int nz, const double* prm,
                 void* stream) {
  const int periodic[6] = {BC_PERIODIC, BC_PERIODIC, BC_PERIODIC,
                           BC_PERIODIC, BC_PERIODIC, BC_PERIODIC};
  const ZArgs<T> z = stream_args<T>(S, So, inv, dt, active, nullptr, nx, ny, nz, false,
                                    periodic, prm);
  return stream_step<T>(step_kernel<T>(), z, blocks, stream);
}

}  // namespace ramses::zhydro

extern "C" {

// the persistent grid: as many blocks as the card holds at once (host
// build: 3, so the serial build strides over the items as the blocks do)
int ramses_zcarry_hydro_blocks(int f64) {
#ifdef __CUDACC__
  using namespace ramses::zhydro;
  int blocks = 0;
  const int err = f64 ? stream_resident<double>(zcarry_hydro_kernel<double>, &blocks)
                      : stream_resident<float>(zcarry_hydro_kernel<float>, &blocks);
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
