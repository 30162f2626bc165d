"""On-line history diagnostics (the port's counterpart of
ramsesgpu_tpu/io/history.py; reference HydroRunBase.cpp:7235-7396
history_hydro, MHDRunBase.cpp:3414-3810 history_mhd/mri/turbulence):
scalar diagnostics appended to a text file at a configured cadence.

Every quantity is a reduction over the ghosted state on its own device;
``compute_history`` moves them to the host in one transfer, then forms
the few host-side combinations the JAX package forms from Python floats
(the MRI's alpha).

Columns:
  hydro: totalTime dt mass totalEnergy
  MHD:   totalTime dt mass totalEnergy divB magneticEnergy
  MRI (omega0>0) adds: maxwellStress reynoldsStress alpha
  turbulence problems add (history_turbulence,
  reference: src/hydro/MHDRunBase.cpp:3626-3810): eKin eMag helicity
  divB_sum mean_rho mean_B mean_B{x,y,z} mean_rhov{x,y,z} Ma_s Ma_alfven
  coef_{x,y,z} (|Bx| Fourier amplitude at kfft=nx-3 along each axis)
  inertial-wave problems use the reference's single-point probe
  (history_inertial_wave, MHDRunBase.cpp:3414-3470): rho dvx/cIso dvy/cIso
"""
from __future__ import annotations

import math
import os
from pathlib import Path

import torch

from ..config.params import RunParams
from ..core.constants import IA, IB, IC, ID, IP, IU, IV, IW
from ..ops.backend import xp
from ..solvers.godunov_mhd import xpos_array


def _interior(params: RunParams, a: torch.Tensor) -> torch.Tensor:
    g = params.ghost_width
    return a[(slice(g, -g),) * params.dim]


def _to_host(values: dict) -> dict[str, float]:
    """The dict's 0-d device tensors as Python floats, in one transfer."""
    keys = list(values)
    host = torch.stack([values[k].to(torch.float64) for k in keys]).tolist()
    return dict(zip(keys, host))


def compute_history(params: RunParams, U: torch.Tensor, t, dt) -> dict[str, float]:
    """The history sample of the ghosted state U: its reductions on U's
    device, then one transfer to the host."""
    dv = params.dx * params.dy * (params.dz if params.dim == 3 else 1.0)
    rho = _interior(params, U[ID])
    dev = {
        "mass": torch.sum(rho) * dv,
        "totalEnergy": torch.sum(_interior(params, U[IP])) * dv,
    }
    if params.mhd:
        bx, by, bz = U[IA], U[IB], U[IC]
        div = (torch.roll(bx, -1, -1) - bx) / params.dx + (
            torch.roll(by, -1, -2) - by
        ) / params.dy
        if params.dim == 3:
            div = div + (torch.roll(bz, -1, -3) - bz) / params.dz
        g = params.ghost_width
        sl = (slice(g, -g - 1),) * params.dim
        dev["divB"] = torch.abs(div[sl]).max()
        emag = 0.5 * (
            _interior(params, bx) ** 2
            + _interior(params, by) ** 2
            + _interior(params, bz) ** 2
        )
        dev["magneticEnergy"] = torch.sum(emag) * dv

        if params.omega0 > 0:
            # MRI stresses (MHDRunBase.cpp:3476-3619): Maxwell = -<Bx By>,
            # Reynolds = <rho vx dvy> with dvy the shear-subtracted vy
            u = _interior(params, U[IU]) / rho
            v = _interior(params, U[IV]) / rho
            # subtract the background shear -1.5 Omega0 x
            xpos = _interior(params, torch.broadcast_to(
                xpos_array(params, U.dtype, U.device), U.shape[1:]))
            dv_shear = v + 1.5 * params.omega0 * xpos
            bxc = _interior(params, 0.5 * (bx + torch.roll(bx, -1, -1)))
            byc = _interior(params, 0.5 * (by + torch.roll(by, -1, -2)))
            dev["maxwellStress"] = torch.mean(-bxc * byc)
            dev["reynoldsStress"] = torch.mean(rho * u * dv_shear)
            dev["_pres_mean"] = torch.mean((params.gamma0 - 1.0) * _interior(params, U[IP]))

        problem = str(params.problem).lower()
        if problem.startswith("turbulence") and params.dim == 3:
            dev.update(_turbulence_channels(params, U))
        elif problem in ("inertialwave", "inertial-wave"):
            dev.update(_inertial_wave_channels(params, U))

    host = _to_host(dev)
    pres_mean = host.pop("_pres_mean", None)
    out = {"totalTime": float(t), "dt": float(dt)}
    for key, value in host.items():
        out[key] = value
        if key == "reynoldsStress":
            out["alpha"] = (out["maxwellStress"] + value) / max(pres_mean, 1e-30)
    return out


def _turbulence_channels(params: RunParams, U: torch.Tensor) -> dict[str, torch.Tensor]:
    """Volume-averaged turbulence diagnostics as 0-d device tensors
    (reference history_turbulence, MHDRunBase.cpp:3684-3790): sonic and
    Alfvenic Mach numbers, cross helicity < rho_v . B/sqrt(rho) >, mean
    fields, and the |Bx| Fourier amplitude at kfft = nx-3 along each axis;
    sums use the reference's volume normalization dTau = dV / (Lx Ly Lz)."""
    g = params.ghost_width
    sl = (slice(g, -g),) * params.dim
    rho = U[ID][sl]
    mx, my_, mz_ = U[IU][sl], U[IV][sl], U[IW][sl]
    bx, by, bz = U[IA][sl], U[IB][sl], U[IC][sl]

    lx = params.xmax - params.xmin
    ly = params.ymax - params.ymin
    lz = params.zmax - params.zmin
    dtau = params.dx * params.dy * params.dz / (lx * ly * lz)

    v2 = (mx / rho) ** 2 + (my_ / rho) ** 2 + (mz_ / rho) ** 2
    ekin = torch.sum((mx**2 + my_**2 + mz_**2) / rho) * dtau
    emag = torch.sum(bx**2 + by**2 + bz**2) * dtau
    sq = xp.sqrt(rho)
    helicity = torch.sum((mx * bx + my_ * by + mz_ * bz) / sq) * dtau
    mean_rho = torch.sum(rho) * dtau
    mean_bx = torch.sum(bx) * dtau
    mean_by = torch.sum(by) * dtau
    mean_bz = torch.sum(bz) * dtau
    mean_b = xp.sqrt(mean_bx**2 + mean_by**2 + mean_bz**2)
    mean_v2 = torch.sum(v2) * dtau

    # signed divB *sum* over the interior (the reference's turbulence
    # history uses the sum, not the max, MHDRunBase.cpp:3772-3785)
    div = (
        (torch.roll(U[IA], -1, -1) - U[IA]) / params.dx
        + (torch.roll(U[IB], -1, -2) - U[IB]) / params.dy
        + (torch.roll(U[IC], -1, -3) - U[IC]) / params.dz
    )
    divb_sum = torch.sum(div[sl])

    # Fourier amplitude of Bx at kfft=nx-3 along each axis; the constant
    # ghost-offset phase of the reference's absolute indices drops out of
    # the modulus
    kfft = params.nx - 3

    def phase(n: int) -> torch.Tensor:
        return 2.0 * math.pi * kfft * torch.arange(n, dtype=U.dtype, device=U.device) / n

    def coef(ph: torch.Tensor, axis: int) -> torch.Tensor:
        shape = [1, 1, 1]
        shape[axis] = -1
        ph = ph.reshape(shape)
        re = torch.sum(bx * torch.cos(ph))
        im = torch.sum(bx * torch.sin(ph))
        return xp.sqrt(re**2 + im**2) * dtau

    c_iso = params.c_iso if params.c_iso > 0 else 1.0
    vrms = xp.sqrt(mean_v2)
    return {
        "eKin": ekin,
        "eMag": emag,
        "helicity": helicity,
        "divB_sum": divb_sum,
        "mean_rho": mean_rho,
        "mean_B": mean_b,
        "mean_Bx": mean_bx,
        "mean_By": mean_by,
        "mean_Bz": mean_bz,
        "mean_rhovx": torch.sum(mx) * dtau,
        "mean_rhovy": torch.sum(my_) * dtau,
        "mean_rhovz": torch.sum(mz_) * dtau,
        "Ma_s": vrms / c_iso,
        "Ma_alfven": vrms / (mean_b / xp.sqrt(4.0 * math.pi * mean_rho) + 1e-30),
        "coef_x": coef(phase(params.nx), 2),
        "coef_y": coef(phase(params.ny), 1),
        "coef_z": coef(phase(params.nz), 0),
    }


def _inertial_wave_channels(params: RunParams, U: torch.Tensor) -> dict[str, torch.Tensor]:
    """Single-point wave probe (reference: MHDRunBase.cpp:3448-3466): rho
    and the velocity perturbations in units of cIso at the cell (i = nx/2,
    the first interior y/z row)."""
    g = params.ghost_width
    i = g + params.nx // 2
    idx = (g, g, i) if params.dim == 3 else (g, i)
    rho = U[(ID, *idx)]
    dvx = U[(IU, *idx)] / rho
    dvy = U[(IV, *idx)] / rho
    c_iso = params.c_iso if params.c_iso > 0 else 1.0
    return {
        "rho_probe": rho,
        "dvx_over_cIso": dvx / c_iso,
        "dvy_over_cIso": dvy / c_iso,
    }


class HistoryWriter:
    """Append-only text history file ``<prefix>.history`` in the output
    directory, one line per sample, its header the sample's keys (the JAX
    package's format, after the reference's history files, e.g.
    HydroRunBaseMpi.cpp:10908 'totalTime dt mass divB')."""

    def __init__(self, params: RunParams, output_dir: str, prefix: str):
        self.params = params
        os.makedirs(output_dir, exist_ok=True)
        self.path = Path(output_dir) / f"{prefix}.history"
        self._header_written = self.path.exists()

    def append(self, sample: dict[str, float]) -> None:
        if not self._header_written:
            self.path.write_text("# " + " ".join(sample.keys()) + "\n")
            self._header_written = True
        with self.path.open("a") as f:
            f.write(" ".join(f"{v:.10e}" for v in sample.values()) + "\n")


def read_history(path) -> dict[str, list[float]]:
    """The columns of a history file by name."""
    lines = Path(path).read_text().splitlines()
    names = lines[0].lstrip("#").split()
    rows = [[float(v) for v in line.split()] for line in lines[1:] if line.strip()]
    return {name: [r[i] for r in rows] for i, name in enumerate(names)}
