"""2D Riemann problems (the 19 Lax-Liu quadrant configurations).

The port's own copy of ramsesgpu_tpu/problems/riemann2d.py (numpy): the
port imports nothing of the JAX package.

Data tables from the published Lax & Liu (1998) test suite, as carried by
the reference (src/hydro/initHydro.cpp:25-426, HydroRunBase.cpp
init_hydro_Riemann). Quadrant layout: q1 = x>=xt,y>=yt (top-right),
q2 = x<xt,y>=yt, q3 = x<xt,y<yt, q4 = x>=xt,y<yt. Each entry is
(rho, u, v, p).
"""
from __future__ import annotations

import numpy as np

from ..config.configmap import ConfigMap
from ..config.params import RunParams
from ..core.constants import ID, IP, IU, IV
from . import register_hydro
from .grid import coords

# (q1, q2, q3, q4) per configuration; each quadrant is (rho, u, v, p)
RIEMANN_CONFIGS: tuple[tuple[tuple[float, float, float, float], ...], ...] = (
    # 1
    ((1.0, 0.0, 0.0, 1.0), (0.5197, -0.7259, 0.0, 0.4),
     (0.1072, -0.7259, -1.4045, 0.0439), (0.2579, 0.0, -1.4045, 0.15)),
    # 2
    ((1.0, 0.0, 0.0, 1.0), (0.5197, -0.7259, 0.0, 0.4),
     (1.0, -0.7259, -0.7259, 1.0), (0.5197, 0.0, -0.7259, 0.4)),
    # 3
    ((1.5, 0.0, 0.0, 1.5), (0.5323, 1.206, 0.0, 0.3),
     (0.138, 1.206, 1.206, 0.029), (0.5323, 0.0, 1.206, 0.3)),
    # 4
    ((1.1, 0.0, 0.0, 1.1), (0.5065, 0.8939, 0.0, 0.35),
     (1.1, 0.8939, 0.8939, 1.1), (0.5065, 0.0, 0.8939, 0.35)),
    # 5
    ((1.0, -0.75, -0.5, 1.0), (2.0, -0.75, 0.5, 1.0),
     (1.0, 0.75, 0.5, 1.0), (3.0, 0.75, -0.5, 1.0)),
    # 6
    ((1.0, 0.75, -0.5, 1.0), (2.0, 0.75, 0.5, 0.5),
     (1.0, -0.75, 0.5, 1.0), (3.0, -0.75, -0.5, 1.0)),
    # 7
    ((1.0, 0.1, 0.1, 1.0), (0.5197, -0.6259, 0.1, 0.4),
     (0.8, 0.1, 0.1, 0.4), (0.5197, 0.1, -0.6259, 0.4)),
    # 8
    ((0.5197, 0.1, 0.1, 0.4), (1.0, -0.6259, 0.1, 1.0),
     (0.8, 0.1, 0.1, 1.0), (1.0, 0.1, -0.6259, 1.0)),
    # 9
    ((1.0, 0.0, 0.3, 1.0), (2.0, 0.0, -0.3, 1.0),
     (1.039, 0.0, -0.8133, 0.4), (0.5197, 0.0, -0.4259, 0.4)),
    # 10
    ((1.0, 0.0, 0.4297, 1.0), (0.5, 0.0, 0.6076, 1.0),
     (0.2281, 0.0, -0.6076, 0.3333), (0.4562, 0.0, -0.4259, 0.3333)),
    # 11
    ((1.0, 0.1, 0.0, 1.0), (0.5313, 0.8276, 0.0, 0.4),
     (0.8, 0.1, 0.0, 0.4), (0.5313, 0.1, 0.7276, 0.4)),
    # 12
    ((0.5313, 0.0, 0.0, 0.4), (1.0, 0.7276, 0.0, 1.0),
     (0.8, 0.0, 0.0, 1.0), (1.0, 0.0, 0.7276, 1.0)),
    # 13
    ((1.0, 0.0, -0.3, 1.0), (2.0, 0.0, 0.3, 1.0),
     (1.0625, 0.0, 0.8145, 0.4), (0.5313, 0.0, 0.4276, 0.4)),
    # 14
    ((2.0, 0.0, -0.5606, 8.0), (1.0, 0.0, -1.2172, 8.0),
     (0.4736, 0.0, 1.2172, 2.6667), (0.9474, 0.0, 1.1606, 2.6667)),
    # 15
    ((1.0, 0.1, -0.3, 1.0), (0.5197, -0.6259, -0.3, 0.4),
     (0.8, 0.1, -0.3, 0.4), (0.5313, 0.1, 0.4276, 0.4)),
    # 16
    ((0.5313, 0.1, 0.1, 0.4), (1.0222, -0.6179, 0.1, 1.0),
     (0.8, 0.1, 0.1, 1.0), (1.0, 0.1, 0.8276, 1.0)),
    # 17
    ((1.0, 0.0, -0.4, 1.0), (2.0, 0.0, -0.3, 1.0),
     (1.0625, 0.0, 0.2145, 0.4), (0.5197, 0.0, -1.1259, 0.4)),
    # 18
    ((1.0, 0.0, 1.0, 1.0), (2.0, 0.0, -0.3, 1.0),
     (1.0625, 0.0, 0.2145, 0.4), (0.5197, 0.0, 0.2741, 0.4)),
    # 19
    ((1.0, 0.0, 0.3, 1.0), (2.0, 0.0, -0.3, 1.0),
     (1.0625, 0.0, 0.2145, 0.4), (0.5197, 0.0, -0.4259, 0.4)),
)

NB_RIEMANN_CONFIG = len(RIEMANN_CONFIGS)


def init_hydro_riemann2d(params: RunParams, config: ConfigMap) -> np.ndarray:
    conf_id = config.get_integer("hydro", "riemann_config_number", 0)
    conf_id = min(max(conf_id, 0), NB_RIEMANN_CONFIG - 1)
    xt = config.get_float("riemann2d", "x", 0.5)
    yt = config.get_float("riemann2d", "y", 0.5)

    dtype = np.float64 if params.dtype == "float64" else np.float32
    U = np.zeros(params.shape, dtype=dtype)
    X, Y = coords(params)
    q1, q2, q3, q4 = RIEMANN_CONFIGS[conf_id]

    gamma = params.gamma0
    for quad, mask in (
        (q1, (X >= xt) & (Y >= yt)),
        (q2, (X < xt) & (Y >= yt)),
        (q3, (X < xt) & (Y < yt)),
        (q4, (X >= xt) & (Y < yt)),
    ):
        rho, u, v, p = quad
        U[ID][mask] = rho
        U[IU][mask] = rho * u
        U[IV][mask] = rho * v
        U[IP][mask] = p / (gamma - 1.0) + 0.5 * rho * (u * u + v * v)
    return U


register_hydro("riemann2d", init_hydro_riemann2d)
