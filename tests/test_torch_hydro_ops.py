"""Per-function parity of the PyTorch port's 3D hydro numerics (eos,
slopes, trace, the approx / HLL / HLLC Riemann solvers, the Godunov step,
the CFL reduction and the boundary fill) against the JAX package on the
CPU.

Inputs are physical random states (rho, p > 0) made with numpy from a
fixed seed and handed to both packages. The CFL reduction and the boundary
fill are copies, sign flips and the same per-cell op chain, so they must be
bitwise equal. Everything else is held to rtol 1e-5 plus an atol of 1e-6
times each field's largest magnitude in float32, and 1e-12 / 1e-12 in
float64, as in tests/test_torch_ops.py. float32 runs here, in process;
float64 needs jax_enable_x64, which is process-global, so its cases run in
the one subprocess of tests/test_torch_hydro_step.py, beside the slice's
float64 reference, to pay for one JAX start-up.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ramsesgpu_tpu.config.configmap import ConfigMap
from ramsesgpu_tpu.config.params import params_from_config
from ramsesgpu_tpu_torch.config.configmap import ConfigMap as TConfigMap
from ramsesgpu_tpu_torch.config.params import params_from_config as t_params_from_config

torch.set_num_threads(1)

HYDRO_INI = """
[mesh]
nx=16
ny=16
nz=16
xmin=0.0
xmax=1.0
ymin=0.0
ymax=0.8
zmin=0.0
zmax=0.7
boundary_xmin={bx0}
boundary_xmax={bx1}
boundary_ymin={by0}
boundary_ymax={by1}
boundary_zmin={bz0}
boundary_zmax={bz1}
[hydro]
problem=implode
cfl=0.8
gamma0=1.4
slope_type={slope}
riemannSolver={solver}
niter_riemann=10
smallr=1e-7
smallc=1e-7
cIso={ciso}
[implementation]
dtype={dtype}
"""

RTOL = {"float32": 1e-5, "float64": 1e-12}
ATOL_SCALE = {"float32": 1e-6, "float64": 1e-12}
# every face type, and a mix of all three
BC_SETS = {
    "dirichlet": (1, 1, 1, 1, 1, 1),
    "neumann": (2, 2, 2, 2, 2, 2),
    "periodic": (3, 3, 3, 3, 3, 3),
    "mixed": (1, 2, 2, 1, 3, 3),
}


def ini_text(dtype, solver="approx", bcs=(1,) * 6, slope=1.0, ciso=0.0):
    keys = ("bx0", "bx1", "by0", "by1", "bz0", "bz1")
    return HYDRO_INI.format(dtype=dtype, solver=solver, slope=slope, ciso=ciso,
                            **dict(zip(keys, bcs)))


def both_params(dtype, **kw):
    """The JAX package's RunParams and the port's, from the same INI text."""
    text = ini_text(dtype, **kw)
    return params_from_config(ConfigMap(text=text)), t_params_from_config(TConfigMap(text=text))


def random_state(params, rng, dtype):
    """A ghosted 3D hydro conserved state with positive density and pressure."""
    shape = params.shape[1:]
    rho = rng.uniform(0.5, 1.5, shape)
    p = rng.uniform(0.5, 1.5, shape)
    vel = 0.5 * rng.standard_normal((3,) + shape)
    e = p / (params.gamma0 - 1.0) + 0.5 * rho * (vel**2).sum(0)
    return np.stack([rho, e, *(rho * vel)]).astype(dtype)


def random_prim(rng, shape, dtype):
    """A primitive state [5, *shape] with positive density and pressure."""
    return np.concatenate([rng.uniform(0.5, 1.5, (2,) + shape),
                           0.5 * rng.standard_normal((3,) + shape)]).astype(dtype)


def _t(a):
    return torch.from_numpy(np.array(a))


def _n(a):
    return np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a)


def case_constoprim(dtype, rng, ciso=0.0):
    from ramsesgpu_tpu.ops.eos import constoprim_hydro as jf, prim_to_cons_hydro as jp
    from ramsesgpu_tpu_torch.ops.eos import constoprim_hydro as tf, prim_to_cons_hydro as tp

    pj, pt = both_params(dtype, ciso=ciso)
    U = random_state(pj, rng, dtype)
    (Qj, cj), (Qt, ct) = jf(pj, jnp.asarray(U)), tf(pt, _t(U))
    return [("Q", _n(Qt), _n(Qj)), ("c", _n(ct), _n(cj)),
            ("U", _n(tp(pt, Qt)), _n(jp(pj, Qj)))]


def case_trace(dtype, rng, slope=1.0):
    from ramsesgpu_tpu.ops.slopes import slopes_unsplit as j_slopes
    from ramsesgpu_tpu.ops.trace import trace_unsplit_hydro as jf
    from ramsesgpu_tpu_torch.ops.slopes import slopes_unsplit as t_slopes
    from ramsesgpu_tpu_torch.ops.trace import trace_unsplit_hydro as tf

    pj, pt = both_params(dtype, slope=slope)
    Q = random_prim(rng, pj.shape[1:], dtype)
    dt = 0.01
    dqj, dqt = j_slopes(pj, jnp.asarray(Q)), t_slopes(pt, _t(Q))
    (qmj, qpj) = jf(pj, jnp.asarray(Q), dqj, jnp.asarray(dt, Q.dtype))
    (qmt, qpt) = tf(pt, _t(Q), dqt, torch.tensor(dt, dtype=_t(Q).dtype))
    out = [(f"dq{ax}", _n(t), _n(j)) for ax, t, j in zip("xyz", dqt, dqj)]
    for ax in range(3):
        out += [(f"qm{ax}", _n(qmt[ax]), _n(qmj[ax])), (f"qp{ax}", _n(qpt[ax]), _n(qpj[ax]))]
    return out


def case_riemann(dtype, rng, solver):
    from ramsesgpu_tpu.ops.riemann import riemann_hydro as jf
    from ramsesgpu_tpu_torch.ops.riemann import riemann_hydro as tf

    pj, pt = both_params(dtype, solver=solver)
    ql, qr = (random_prim(rng, pj.shape[1:], dtype) for _ in range(2))
    # strong shocks in a tenth of the faces, where the approx solver's
    # Newton loop works hardest
    ql[1, :2] *= 50.0
    return [("flux", _n(tf(pt, _t(ql), _t(qr))), _n(jf(pj, jnp.asarray(ql), jnp.asarray(qr))))]


def case_step(dtype, rng):
    """One Godunov step on mixed walls, both forms of the update."""
    from ramsesgpu_tpu.solvers.boundary import make_boundaries as j_fill
    from ramsesgpu_tpu.solvers.godunov import godunov_unsplit_hydro as j_step
    from ramsesgpu_tpu.solvers.godunov import hydro_3d_interior_update as j_int
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries as t_fill
    from ramsesgpu_tpu_torch.solvers.godunov import godunov_unsplit_hydro as t_step
    from ramsesgpu_tpu_torch.solvers.godunov import hydro_3d_interior_update as t_int

    pj, pt = both_params(dtype, bcs=BC_SETS["mixed"])
    U = random_state(pj, rng, dtype)
    Uj, Ut = j_fill(pj, jnp.asarray(U)), t_fill(pt, _t(U))
    dtj, dtt = jnp.asarray(0.002, Uj.dtype), torch.tensor(0.002, dtype=Ut.dtype)
    return [("step", _n(t_step(pt, Ut, dtt)), _n(j_step(pj, Uj, dtj))),
            ("interior", _n(t_int(pt, Ut, dtt)), _n(j_int(pj, Uj, dtj)))]


CASES = {
    "constoprim": case_constoprim,
    "constoprim_ciso": lambda d, r: case_constoprim(d, r, ciso=0.7),
    "trace_minmod": case_trace,
    "trace_moncen": lambda d, r: case_trace(d, r, slope=2.0),
    "riemann_approx": lambda d, r: case_riemann(d, r, "approx"),
    "riemann_hll": lambda d, r: case_riemann(d, r, "hll"),
    "riemann_hllc": lambda d, r: case_riemann(d, r, "hllc"),
    "godunov_step": case_step,
}


def worst_ratio(name, dtype):
    """max |got - want| / (rtol |want| + atol) over a case's outputs, with
    atol scaled per channel to the field's largest magnitude (<= 1 passes)."""
    rng = np.random.default_rng(20261017 + list(CASES).index(name))
    worst = 0.0
    for label, got, want in CASES[name](dtype, rng):
        assert got.shape == want.shape and got.dtype == want.dtype == np.dtype(dtype), label
        assert np.isfinite(got).all() and np.isfinite(want).all(), label
        w = want.reshape(want.shape[0], -1) if want.ndim > 1 else want.reshape(1, -1)
        g = got.reshape(w.shape)
        tol = RTOL[dtype] * np.abs(w) + ATOL_SCALE[dtype] * np.abs(w).max(axis=1, keepdims=True)
        err = np.abs(g.astype(np.float64) - w)
        worst = max(worst, float(np.max(err / np.maximum(tol, np.finfo(np.float64).tiny))))
    return worst


def exact_mismatches(dtype):
    """The bitwise cases: labels whose port result differs from the JAX
    package's in any bit (an empty list passes)."""
    from ramsesgpu_tpu.solvers.boundary import make_boundaries as j_fill
    from ramsesgpu_tpu.solvers.boundary import make_boundaries_concat as j_concat
    from ramsesgpu_tpu.solvers.timestep import compute_dt as j_dt
    from ramsesgpu_tpu.solvers.timestep import compute_inv_dt_hydro as j_inv
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries as t_fill
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries_concat as t_concat
    from ramsesgpu_tpu_torch.solvers.timestep import compute_dt as t_dt
    from ramsesgpu_tpu_torch.solvers.timestep import compute_inv_dt_hydro as t_inv

    rng = np.random.default_rng(99)
    bad = []
    # every face kind and the mix; the isothermal CFL on half of them
    for (name, bcs), ciso in zip(BC_SETS.items(), (0.0, 0.7, 0.0, 0.7)):
        pj, pt = both_params(dtype, bcs=bcs, ciso=ciso)
        U = random_state(pj, rng, dtype)
        g = pj.ghost_width
        want = _n(j_fill(pj, jnp.asarray(U)))
        results = {
            "fill": (_n(t_fill(pt, _t(U))), want),
            "concat": (_n(t_concat(pt, _t(U))), _n(j_concat(pj, jnp.asarray(U)))),
            "concat_interior_only": (
                _n(t_concat(pt, _t(U[:, g:-g, g:-g, g:-g]), interior_only=True)), want),
            "inv_dt": (_n(t_inv(pt, _t(U))), _n(j_inv(pj, jnp.asarray(U)))),
            "inv_dt_ghost0": (_n(t_inv(pt, _t(U[:, g:-g, g:-g, g:-g]), ghost=0)),
                              _n(j_inv(pj, jnp.asarray(U)))),
            "dt": (_n(t_dt(pt, _t(U))), _n(j_dt(pj, jnp.asarray(U)))),
        }
        for label, (got, ref) in results.items():
            if got.shape != ref.shape or got.dtype != ref.dtype or got.tobytes() != ref.tobytes():
                bad.append(f"{label}[{name}, cIso={ciso}]")
    return bad


@pytest.mark.parametrize("name", list(CASES))
def test_hydro_op_parity_f32(name):
    assert worst_ratio(name, "float32") <= 1.0


def test_fill_and_cfl_bitwise_f32():
    assert exact_mismatches("float32") == []
