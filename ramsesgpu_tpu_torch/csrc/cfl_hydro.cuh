// The per-cell inverse dt of 3D hydro (solvers/timestep.py:33
// compute_inv_dt_hydro), shared by the CFL kernel (cfl_hydro.cu) and the
// z-streaming step's folded reduction (zcarry_hydro.cu). Its products are
// never fused into FMAs (r_mul), so it is bitwise the twin's.
#pragma once

#include "common.cuh"

namespace ramses {

// the cell whose channel ch lies at A[ch * stride]
template <typename T>
HD T hydro_inv_dt_cell(const Phys<T>& ph, T c_iso, const T* A, long long stride) {
  const T rho = pmax(A[ID * stride], ph.smallr);
  const T u = A[IU * stride] / rho;
  const T v = A[IV * stride] / rho;
  const T w = A[IW * stride] / rho;
  T cs;
  if (c_iso > T(0)) {
    cs = c_iso;
  } else {
    const T eken = r_mul(T(0.5), r_mul(u, u) + r_mul(v, v) + r_mul(w, w));
    const T eint = A[IP * stride] / rho - eken;
    const T p = pmax(r_mul(r_mul(ph.gm1, rho), eint), r_mul(rho, ph.smallp));
    cs = r_sqrt(r_mul(ph.gamma0, p) / rho);
  }
  return (cs + r_abs(u)) / ph.dx + (cs + r_abs(v)) / ph.dy + (cs + r_abs(w)) / ph.dz;
}

}  // namespace ramses
