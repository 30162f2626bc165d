"""Per-function parity of the PyTorch port's numerics (ramsesgpu_tpu_torch
ops/ and solvers/timestep.py) against the JAX package on the CPU.

Inputs are physical random states (rho, p > 0) made with numpy from a fixed
seed and handed to both packages. float32 runs in process with rtol 1e-5
and an atol of 1e-6 times each field's largest magnitude (several fields
are near zero, where a relative bound means nothing). float64 runs in one
subprocess, because jax_enable_x64 is process-global (tests/test_float64.py
pattern), with rtol 1e-12 and atol 1e-12 times the field magnitude.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ramsesgpu_tpu.config.configmap import ConfigMap
from ramsesgpu_tpu.config.params import params_from_config
from ramsesgpu_tpu.core.constants import IA, IB, IC

torch.set_num_threads(1)

OPS_INI = """
[mesh]
nx=5
ny=4
nz=3
xmin=-0.5
xmax=0.5
ymin=-0.5
ymax=0.5
zmin=-0.5
zmax=0.5
boundary_xmin=3
boundary_xmax=3
boundary_ymin=3
boundary_ymax=3
boundary_zmin=3
boundary_zmax=3
[hydro]
problem=Orszag-Tang
cfl=0.4
gamma0=1.666
slope_type=2.0
riemannSolver=hlld
smallr=1e-7
smallc=1e-7
[MHD]
enable=true
magRiemannSolver=hlld
[implementation]
dtype={dtype}
"""

RTOL = {"float32": 1e-5, "float64": 1e-12}
ATOL_SCALE = {"float32": 1e-6, "float64": 1e-12}


def _params(dtype):
    return params_from_config(ConfigMap(text=OPS_INI.format(dtype=dtype)))


def random_state(params, rng, dtype):
    """A ghosted conserved state with positive density and pressure and a
    total energy consistent with the cell-centred field."""
    shape = params.shape[1:]
    rho = rng.uniform(0.5, 1.5, shape)
    p = rng.uniform(0.5, 1.5, shape)
    vel = 0.5 * rng.standard_normal((3,) + shape)
    bf = 0.5 * rng.standard_normal((3,) + shape)
    bc = [0.5 * (bf[d] + np.roll(bf[d], -1, axis=-1 - d)) for d in range(3)]
    e = p / (params.gamma0 - 1.0) + 0.5 * rho * (vel**2).sum(0) + 0.5 * sum(b * b for b in bc)
    return np.stack([rho, e, *(rho * vel), *bf]).astype(dtype)


def random_prim(rng, shape, dtype):
    """A primitive state [8, *shape] with positive density and pressure."""
    return np.concatenate([
        rng.uniform(0.5, 1.5, (2,) + shape),
        0.5 * rng.standard_normal((6,) + shape),
    ]).astype(dtype)


def _t(a):
    return torch.from_numpy(np.array(a))


def _n(a):
    return np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a)


def case_constoprim(params, rng, dtype):
    from ramsesgpu_tpu.ops.eos import constoprim_mhd as jf
    from ramsesgpu_tpu_torch.ops.eos import constoprim_mhd as tf

    U = random_state(params, rng, dtype)
    Qj, cj = jf(params, jnp.asarray(U), None)
    Qt, ct = tf(params, _t(U), None)
    return [("Q", _n(Qt), _n(Qj)), ("c", _n(ct), _n(cj))]


def case_eos(params, rng, dtype):
    from ramsesgpu_tpu.ops.eos import eos as jf
    from ramsesgpu_tpu_torch.ops.eos import eos as tf

    rho = rng.uniform(0.5, 1.5, (400,)).astype(dtype)
    eint = rng.uniform(-0.1, 2.0, (400,)).astype(dtype)  # some below the floor
    (pt, ct), (pj, cj) = tf(params, _t(rho), _t(eint)), jf(params, jnp.asarray(rho), jnp.asarray(eint))
    return [("p", _n(pt), _n(pj)), ("c", _n(ct), _n(cj))]


def case_slopes(params, rng, dtype):
    from ramsesgpu_tpu.ops.slopes import slopes_unsplit as jf
    from ramsesgpu_tpu_torch.ops.slopes import slopes_unsplit as tf

    Q = random_prim(rng, params.shape[1:], dtype)
    return [(f"d{ax}", _n(t), _n(j)) for ax, t, j in
            zip("xyz", tf(params, _t(Q)), jf(params, jnp.asarray(Q)))]


def case_trace_states(params, rng, dtype):
    from ramsesgpu_tpu.ops.eos import constoprim_mhd as j_prim
    from ramsesgpu_tpu.ops.trace_mhd3d import trace_unsplit_mhd_3d_parts as jf
    from ramsesgpu_tpu_torch.ops.eos import constoprim_mhd as t_prim
    from ramsesgpu_tpu_torch.ops.trace_mhd3d import STATE_NAMES
    from ramsesgpu_tpu_torch.ops.trace_mhd3d import trace_unsplit_mhd_3d_parts as tf

    U = random_state(params, rng, dtype)
    dt = 0.01
    Uj, Ut = jnp.asarray(U), _t(U)
    Pj = jf(params, j_prim(params, Uj, None)[0], Uj[IA], Uj[IB], Uj[IC],
            jnp.asarray(dt, Uj.dtype), None)
    Pt = tf(params, t_prim(params, Ut, None)[0], Ut[IA], Ut[IB], Ut[IC],
            torch.tensor(dt, dtype=Ut.dtype))
    assert set(Pj) == set(STATE_NAMES) == set(Pt)
    return [(k, _n(Pt[k]()), _n(Pj[k]())) for k in STATE_NAMES]


def case_riemann_hlld(params, rng, dtype):
    from ramsesgpu_tpu.ops.riemann_mhd import riemann_hlld as jf
    from ramsesgpu_tpu_torch.ops.riemann_mhd import riemann_hlld as tf

    ql, qr = random_prim(rng, (400,), dtype), random_prim(rng, (400,), dtype)
    return [("flux", _n(tf(params, _t(ql), _t(qr))),
             _n(jf(params, jnp.asarray(ql), jnp.asarray(qr))))]


def _case_emf(emf_dir):
    def case(params, rng, dtype):
        from ramsesgpu_tpu.ops.riemann_mhd import compute_emf as jf
        from ramsesgpu_tpu_torch.ops.riemann_mhd import compute_emf as tf

        qs = [random_prim(rng, (400,), dtype) for _ in range(4)]
        return [(f"emf_{emf_dir}", _n(tf(params, *map(_t, qs), emf_dir)),
                 _n(jf(params, *map(jnp.asarray, qs), emf_dir)))]
    return case


def case_inv_dt(params, rng, dtype):
    from ramsesgpu_tpu.solvers.timestep import compute_inv_dt_mhd as jf
    from ramsesgpu_tpu_torch.solvers.timestep import compute_inv_dt_mhd as tf

    U = random_state(params, rng, dtype)
    return [("inv_dt", _n(tf(params, _t(U))), _n(jf(params, jnp.asarray(U))))]


def case_compute_dt(params, rng, dtype):
    from ramsesgpu_tpu.solvers.timestep import compute_dt as jf
    from ramsesgpu_tpu_torch.solvers.timestep import compute_dt as tf

    U = random_state(params, rng, dtype)
    return [("dt", _n(tf(params, _t(U))), _n(jf(params, jnp.asarray(U))))]


CASES = {
    "eos": case_eos,
    "constoprim_mhd": case_constoprim,
    "slopes_unsplit": case_slopes,
    "trace_states": case_trace_states,
    "riemann_hlld": case_riemann_hlld,
    "compute_emf_x": _case_emf("x"),
    "compute_emf_y": _case_emf("y"),
    "compute_emf_z": _case_emf("z"),
    "compute_inv_dt_mhd": case_inv_dt,
    "compute_dt": case_compute_dt,
}


def worst_ratio(name, dtype):
    """max |got - want| / (rtol |want| + atol) over a case's outputs, with
    atol scaled per channel to the field's largest magnitude (<= 1 passes)."""
    params = _params(dtype)
    rng = np.random.default_rng(20261016 + list(CASES).index(name))
    worst = 0.0
    for label, got, want in CASES[name](params, rng, dtype):
        assert got.shape == want.shape and got.dtype == want.dtype == np.dtype(dtype), label
        assert np.isfinite(got).all() and np.isfinite(want).all(), label
        w = want.reshape(want.shape[0], -1) if want.ndim > 1 else want.reshape(1, -1)
        g = got.reshape(w.shape)
        scale = np.abs(w).max(axis=1, keepdims=True)
        tol = RTOL[dtype] * np.abs(w) + ATOL_SCALE[dtype] * scale
        # an all-zero field (tol 0) must match exactly
        err = np.abs(g.astype(np.float64) - w)
        worst = max(worst, float(np.max(err / np.maximum(tol, np.finfo(np.float64).tiny))))
    return worst


@pytest.mark.parametrize("name", list(CASES))
def test_op_parity_f32(name):
    assert worst_ratio(name, "float32") <= 1.0


_F64_SCRIPT = r"""
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
sys.path.insert(0, sys.argv[1])
import test_torch_ops as m
print("RESULT " + json.dumps({k: m.worst_ratio(k, "float64") for k in m.CASES}))
"""


@pytest.fixture(scope="module")
def f64_ratios():
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    tests_dir = Path(__file__).resolve().parent
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(tests_dir.parent), env.get("PYTHONPATH")) if p
    )
    res = subprocess.run(
        [sys.executable, "-c", _F64_SCRIPT, str(tests_dir)],
        capture_output=True, text=True, env=env, timeout=600,
    )
    assert res.returncode == 0, res.stderr[-4000:]
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


@pytest.mark.parametrize("name", list(CASES))
def test_op_parity_f64(name, f64_ratios):
    assert f64_ratios[name] <= 1.0


def test_backend_sqrt_correctly_rounded():
    """ops/backend.py sqrt: the float32 square root, rounded as np.sqrt,
    g++, XLA and CUDA's sqrtf round it (correctly), bit for bit."""
    from ramsesgpu_tpu_torch.ops.backend import sqrt

    x = np.random.default_rng(10).uniform(0.5, 1.5, 100_000).astype(np.float32)
    x[:4] = [0.0, 1e-38, 3.0e38, 2.0]
    got = sqrt(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.sqrt(x).view(np.uint32))
    assert torch.isnan(sqrt(torch.tensor([-1.0]))).all()
    x64 = torch.from_numpy(x.astype(np.float64))
    assert torch.equal(sqrt(x64), torch.sqrt(x64))
