"""Shell-binned power spectrum E(k) of a field (the port's counterpart of
ramsesgpu_tpu/analysis/power_spectrum.py; reference
powerSpectrumMpi.cpp, fft_mpi.cpp:72-81): ``torch.fft.fftn`` on the
field's device and the same shell binning, the bins rint(|k|) (half to
even, as np.rint) summed in float64 by a bincount on that device. Reads
the port's HDF5 snapshots.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config.configmap import ConfigMap
from ..config.params import RunParams
from ..core.constants import ID, IU, IV, IW


def shell_bins(shape, device) -> torch.Tensor:
    """rint(|k|) of every mode of an FFT of ``shape`` (k in units of the
    box's fundamental mode), int64 on ``device``."""
    ks = [torch.fft.fftfreq(n, d=1.0 / n, dtype=torch.float64, device=device) for n in shape]
    grids = torch.meshgrid(*ks, indexing="ij")
    return torch.round(torch.sqrt(sum(g * g for g in grids))).to(torch.int64)


def power_spectrum(field, dx: float = 1.0):
    """The shell-binned isotropic spectrum of one scalar field (numpy or a
    tensor, on its device): (k, E_k) as float64 numpy arrays, k in units of
    the box's fundamental mode."""
    field = torch.as_tensor(field)
    fhat = torch.fft.fftn(field)
    psd = torch.abs(fhat) ** 2 / field.numel() ** 2
    kbin = shell_bins(field.shape, field.device)
    n_bins = int(kbin.max()) + 1
    ek = torch.bincount(kbin.ravel(), weights=psd.ravel().double(), minlength=n_bins)
    return np.arange(n_bins, dtype=np.float64), ek.cpu().numpy()


def velocity_power_spectrum(params: RunParams, U):
    """E(k) of the velocity field of the ghosted state U (numpy or a
    tensor): the sum of its components' spectra."""
    U = torch.as_tensor(U)
    g = params.ghost_width
    sl = (slice(g, -g),) * params.dim
    rho = U[ID][sl]
    k, ek = power_spectrum(U[IU][sl] / rho)
    for c in (IV, IW)[: params.dim - 1]:
        ek = ek + power_spectrum(U[c][sl] / rho)[1]
    return k, ek


def main(argv=None) -> int:
    import argparse

    from ..config.params import params_from_config
    from ..io.hdf5 import dataset_names, input_hdf5

    parser = argparse.ArgumentParser(description="shell-binned power spectrum from HDF5 snapshots")
    parser.add_argument("--param", required=True)
    parser.add_argument("files", nargs="+")
    parser.add_argument("--field", default="velocity",
                        help="'velocity', or a dataset name like 'density'")
    parser.add_argument("--out", default="spectrum.npz")
    parser.add_argument("--device", default="cuda" if torch.cuda.is_available() else "cpu")
    args = parser.parse_args(argv)

    config = ConfigMap(args.param)
    params = params_from_config(config)
    spectra = []
    for fname in args.files:
        U, _t, _step = input_hdf5(params, fname)
        U = torch.from_numpy(U).to(args.device)
        if args.field == "velocity":
            k, ek = velocity_power_spectrum(params, U)
        else:
            g = params.ghost_width
            idx = dataset_names(params).index(args.field)
            k, ek = power_spectrum(U[idx][(slice(g, -g),) * params.dim])
        spectra.append(ek)
    np.savez(args.out, k=k, ek=np.mean(spectra, axis=0))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
