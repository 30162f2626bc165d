// The per-cell inverse dt of 3D MHD (solvers/timestep.py:114
// _inv_dt_mhd_fields), shared by the CFL kernel (cfl_mhd.cu) and the
// z-streaming step's folded reduction (zcarry_mhd.cu), so both reduce the
// same arithmetic.
#pragma once

#include "common.cuh"

namespace ramses {

template <typename T>
HD T fast_speed_cfl(T d2, T c2, T bn, T rho) {
  return r_sqrt(d2 + r_sqrt(pmax(d2 * d2 - c2 * bn * bn / rho, T(0))));
}

// timestep.py _inv_dt_mhd_fields on one cell c: bx_r is Bx on its +1 x
// face, cyp/czp its +1 y/z neighbours. ISO: the isothermal pressure
// rho cIso^2 (timestep.py:117-118), chosen at compile time for the
// periodic and ghosted instances; the shear instances read ph.iso
template <typename T, bool SHEAR, bool ISO = false>
HD T inv_dt_cell(const Phys<T>& ph, const T* S, long long n, long long c,
                 T bx_r, long long cyp, long long czp) {
  const T rho_raw = S[ID * n + c];
  const T rho0 = pmax(rho_raw, ph.smallr);
  const T u = S[IU * n + c] / rho0;
  const T v = S[IV * n + c] / rho0;
  const T w = S[IW * n + c] / rho0;
  const T bx = T(0.5) * (S[IA * n + c] + bx_r);
  const T by = T(0.5) * (S[IB * n + c] + S[IB * n + cyp]);
  const T bz = T(0.5) * (S[IC * n + c] + S[IC * n + czp]);

  const T rho = pmax(rho_raw, ph.smallr);
  T p;
  if (ISO || (SHEAR && ph.iso)) {
    p = rho * ph.ciso2;
  } else {
    const T eken = T(0.5) * (u * u + v * v + w * w);
    const T emag = T(0.5) * (bx * bx + by * by + bz * bz);
    const T eint = (S[IP * n + c] - emag) / rho - eken;
    p = pmax(ph.gm1 * rho * eint, rho * ph.smallp);
  }

  const T b2 = bx * bx + by * by + bz * bz;
  const T c2 = ph.gamma0 * p / rho;
  const T d2 = T(0.5) * (b2 / rho + c2);
  const T vy = SHEAR ? v + ph.vy_shift : v;
  return (fast_speed_cfl(d2, c2, bx, rho) + r_abs(u)) / ph.dx +
         (fast_speed_cfl(d2, c2, by, rho) + r_abs(vy)) / ph.dy +
         (fast_speed_cfl(d2, c2, bz, rho) + r_abs(w)) / ph.dz;
}

// the cell's inverse dt; the shearing-box mode reads the last column's +1
// x face from kept
template <typename T, bool SHEAR, bool ISO = false>
HD T inv_dt_at(const Phys<T>& ph, const Dims& d, const T* S, const T* kept, long long c) {
  int i, j, k;
  cell_ijk(d, c, i, j, k);
  T bx_r;
  if (SHEAR && i == d.nx - 1)
    bx_r = kept[(long long)k * d.ny + j];
  else
    bx_r = S[IA * d.n + cell_at(d, wrap_p(i, d.nx), j, k)];
  // stratified z faces: the top row's +1 z ghost continues its Bz
  // (solvers/stratified.py), so its +1 z face is its own
  const long long czp =
      SHEAR && ph.zstrat && k == d.nz - 1 ? c : cell_at(d, i, j, wrap_p(k, d.nz));
  return inv_dt_cell<T, SHEAR, ISO>(ph, S, d.n, c, bx_r, cell_at(d, i, wrap_p(j, d.ny), k),
                                   czp);
}

}  // namespace ramses
