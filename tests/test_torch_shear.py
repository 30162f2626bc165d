"""The port's ideal MRI shearing-box slice against the JAX package on the
CPU: 16x32x16 (g = 3), isothermal, rotating frame, sheared-periodic x
faces, HLLD + 2D-HLLD.

- Per function, float32 in process, inputs made with numpy from a seed:
  the rotating-frame constoprim, trace and EMFs with omega0 = cIso = 1
  (the JAX shear tests' coefficients, where a wrong sign cannot hide
  under the tolerance) to rtol 1e-5 and an atol of 1e-6 times each
  field's largest magnitude, as tests/test_torch_ops.py; the shear CFL,
  the sheared fill and the remap pair bitwise (the same op order).
- The slice: 5 steps of the port's loop against the JAX whole-array run
  (``make_advance_n`` with ``kernel=jnp``, op by op under
  ``jax.disable_jit()``, every reference in one subprocess with
  jax_enable_x64), from a t0 whose shear offset is 2.5 cells (at t = 0
  the fill is periodic and tests nothing): t within rtol 1e-6 (f32) /
  1e-12 (f64), interior and kept face within relative L2 2e-6 / 1e-11.
- Conservation: mass and the net vertical flux (sum of Bz, which the emfY
  remap keeps) to rounding; divB with the kept face.
- The loop, the state conversion, the C++ host build of the CUDA sources
  against the twins, and the configurations the port refuses.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ramsesgpu_tpu_torch.config.configmap import ConfigMap
from ramsesgpu_tpu_torch.config.params import params_from_config
from ramsesgpu_tpu_torch.core.constants import IA, IB, IC, ID

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
N_STEPS = 5
TOL_T = {"float32": 1e-6, "float64": 1e-12}
TOL_L2 = {"float32": 2e-6, "float64": 1e-11}
TOL_ZCARRY = {"float32": 2e-6, "float64": 1e-13}

# tests/test_shear.py's MRI box; amp 0.2 instead of 0.01 so the random
# velocities drive every solver branch within 5 steps
MRI_INI = """
[run]
tend={tend}
noutput=100
[mesh]
nx=16
ny=32
nz=16
xmin=-0.5
xmax=0.5
ymin=0.0
ymax=2.0
zmin=-0.5
zmax=0.5
boundary_xmin=4
boundary_xmax=4
boundary_ymin=3
boundary_ymax=3
boundary_zmin=3
boundary_zmax=3
[hydro]
problem=MRI
cfl=0.4
gamma0=1.001
cIso={coeffs}
slope_type=2.0
riemannSolver=hlld
smallr=1e-8
smallc=1e-8
[MHD]
enable=true
magRiemannSolver=hlld
omega0={coeffs}
[MRI]
density=1.0
beta=400.0
type=noflux
amp=0.2
seed=3
[implementation]
dtype={dtype}
kernel={kernel}
[output]
outputDir={outdir}
outputPrefix=mri
outputVtk=yes
"""
# (dtype, omega0 = cIso) of the slice runs: the JAX tests' and the
# data/mhd_mri_3d.ini coefficients
SLICES = [("float32", 1.0), ("float64", 1.0), ("float32", 0.001)]


def ini(dtype="float32", kernel="auto", coeffs=1.0, tend=1000.0, outdir="."):
    return MRI_INI.format(dtype=dtype, kernel=kernel, coeffs=coeffs, tend=tend, outdir=outdir)


def t_start(params) -> float:
    """A time whose sheared-fill offset deltay/dy is 2.5 (jplus 2)."""
    return 2.5 * params.dy / (1.5 * params.omega0 * params.dx * params.nx)


def setup(dtype="float32", coeffs=1.0, **kw):
    """The port's params, config, t0 and ghosted initial state: the MRI
    initial condition with its sheared fill at t0."""
    from ramsesgpu_tpu_torch.convert import torch_dtype
    from ramsesgpu_tpu_torch.problems import init_problem
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries
    from ramsesgpu_tpu_torch.solvers.shear import make_all_boundaries_shear

    config = ConfigMap(text=ini(dtype, coeffs=coeffs, **kw))
    params = params_from_config(config)
    U0 = torch.from_numpy(init_problem(params, config)).to(torch_dtype(params))
    t0 = torch.tensor(t_start(params), dtype=U0.dtype)
    return params, config, t0, make_all_boundaries_shear(params, make_boundaries(params, U0), t0)


def port_advance(params, config, U0, t0, n):
    from ramsesgpu_tpu_torch.solvers.step import make_advance_n

    U, t, k = make_advance_n(params, "cpu", config)(U0.clone(), t0.clone(), n)
    return U, float(t), int(k)


def loop_state(params, U):
    """(interior, kept face) of a ghosted state, numpy."""
    g, nx = params.ghost_width, params.nx
    U = np.asarray(U)
    return U[:, g:-g, g:-g, g:g + nx], U[IA, g:-g, g:-g, nx + g]


def state_rel(a, b) -> float:
    num = sum(np.linalg.norm((x - y).ravel().astype(np.float64)) ** 2 for x, y in zip(a, b))
    den = sum(np.linalg.norm(y.ravel().astype(np.float64)) ** 2 for y in b)
    return float(np.sqrt(num / den))


def jax_reference(text, n_steps):
    """The JAX whole-array run from the same initial state: (U0, U, t, k)."""
    from ramsesgpu_tpu.config.configmap import ConfigMap as JConfigMap
    from ramsesgpu_tpu.config.params import params_from_config as j_params
    from ramsesgpu_tpu.problems import init_problem
    from ramsesgpu_tpu.solvers.boundary import make_boundaries
    from ramsesgpu_tpu.solvers.shear import make_all_boundaries_shear
    from ramsesgpu_tpu.solvers.step import make_advance_n

    config = JConfigMap(text=text)
    params = j_params(config)
    with jax.disable_jit():
        U = make_boundaries(params, jnp.asarray(init_problem(params, config)))
        t0 = jnp.asarray(t_start(params), U.dtype)
        U0 = make_all_boundaries_shear(params, U, t0)
        U, t, k = make_advance_n(params, config)(U0, t0, jnp.array(n_steps, jnp.int32))
    return np.asarray(U0), np.asarray(U), float(t), int(k)


_JAX_SCRIPT = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import numpy as np
sys.path.insert(0, sys.argv[1])
import test_torch_shear as m
out = {}
for dtype, coeffs in m.SLICES:
    key = f"{dtype}_{coeffs}"
    out[key + "_U0"], out[key + "_U"], out[key + "_t"], out[key + "_k"] = m.jax_reference(
        m.ini(dtype, kernel="jnp", coeffs=coeffs), m.N_STEPS)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    """{(dtype, coeffs): (U0, U, t, k)} of the JAX package, one subprocess."""
    out = tmp_path_factory.mktemp("jax_shear") / "ref.npz"
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    # a quick, single-threaded backend: the suite's other workers share the cores
    flags = "--xla_backend_optimization_level=0 --xla_cpu_multi_thread_eigen=false"
    env["XLA_FLAGS"] = " ".join(f for f in (env.get("XLA_FLAGS"), flags) if f)
    res = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(REPO / "tests"), str(out)],
                         capture_output=True, text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    ref = np.load(out)
    return {(d, c): tuple(ref[f"{d}_{c}_{x}"] for x in ("U0", "U", "t", "k"))
            for d, c in SLICES}


def check_slice(dtype, coeffs, jax_refs, kernel, tol_l2):
    U0_ref, U_ref, t_ref, k_ref = jax_refs[dtype, coeffs]
    params, config, t0, U0 = setup(dtype, coeffs, kernel=kernel)
    assert params.kernel == kernel
    np.testing.assert_array_equal(U0.numpy(), U0_ref)  # the same start, fill bitwise
    U, t, k = port_advance(params, config, U0, t0, N_STEPS)
    assert k == int(k_ref) == N_STEPS
    assert U.dtype == (torch.float64 if dtype == "float64" else torch.float32)
    assert np.isfinite(U.numpy()).all()
    assert abs(t - float(t_ref)) <= TOL_T[dtype] * abs(float(t_ref))
    assert state_rel(loop_state(params, U), loop_state(params, U_ref)) <= tol_l2[dtype]


@pytest.mark.parametrize("dtype, coeffs", SLICES)
def test_slice_matches_jax(dtype, coeffs, jax_refs):
    check_slice(dtype, coeffs, jax_refs, "auto", TOL_L2)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_zcarry_slice_matches_jax(dtype, jax_refs):
    """kernel=zcarry (the streamed step's shear mode between the same slab,
    border and CFL launches; two buffers that take turns, the kept face in
    place; its twins on the CPU) against the same JAX run, at the zcarry
    tests' tolerance (tests/test_torch_zcarry.py TOL_L2)."""
    check_slice(dtype, 1.0, jax_refs, "zcarry", TOL_ZCARRY)


# -------------------------------------------------------------------------
# per-function parity, float32 in process
# -------------------------------------------------------------------------
RTOL, ATOL_SCALE = 1e-5, 1e-6


def _jparams(coeffs=1.0):
    from ramsesgpu_tpu.config.configmap import ConfigMap as JConfigMap
    from ramsesgpu_tpu.config.params import params_from_config as j_params

    return j_params(JConfigMap(text=ini("float32", coeffs=coeffs)))


def random_state(params, rng):
    """A ghosted conserved state, rho and p > 0, B of order one."""
    shape = params.shape[1:]
    rho = rng.uniform(0.5, 1.5, shape)
    vel = 0.5 * rng.standard_normal((3,) + shape)
    bf = 0.5 * rng.standard_normal((3,) + shape)
    e = rng.uniform(0.5, 1.5, shape) / (params.gamma0 - 1.0) + 0.5 * rho * (vel ** 2).sum(0) \
        + 0.5 * (bf ** 2).sum(0)
    return np.stack([rho, e, *(rho * vel), *bf]).astype(np.float32)


def assert_close(got, want, label):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, label
    atol = ATOL_SCALE * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol, err_msg=label)


@pytest.mark.parametrize("ciso", [1.0, 0.0])
def test_constoprim_rotating_frame(ciso):
    from ramsesgpu_tpu.ops.eos import constoprim_mhd as jf
    from ramsesgpu_tpu_torch.ops.eos import constoprim_mhd as tf

    params = _jparams().replace(c_iso=ciso)
    U = random_state(params, np.random.default_rng(1))
    dt = np.float32(0.01)
    Qj, cj = jf(params, jnp.asarray(U), jnp.asarray(dt))
    Qt, ct = tf(params, torch.from_numpy(U), torch.tensor(dt))
    assert_close(Qt.numpy(), Qj, "Q")
    assert_close(ct.numpy(), cj, "c")


def test_trace_rotating_frame():
    from ramsesgpu_tpu.ops.trace_mhd3d import trace_unsplit_mhd_3d as jf
    from ramsesgpu_tpu.solvers.godunov_mhd import xpos_array as j_xpos
    from ramsesgpu_tpu_torch.ops.trace_mhd3d import trace_unsplit_mhd_3d as tf
    from ramsesgpu_tpu_torch.solvers.godunov_mhd import xpos_array as t_xpos

    params = _jparams()
    rng = np.random.default_rng(2)
    Q = np.concatenate([rng.uniform(0.5, 1.5, (2,) + params.shape[1:]),
                        0.5 * rng.standard_normal((6,) + params.shape[1:])]).astype(np.float32)
    bf = (0.5 * rng.standard_normal((3,) + params.shape[1:])).astype(np.float32)
    dt = np.float32(0.01)
    xj, xt = j_xpos(params, jnp.float32), t_xpos(params, torch.float32)
    np.testing.assert_array_equal(xt.numpy()[0, 0], np.asarray(xj)[0, 0])
    outj = jf(params, jnp.asarray(Q), *map(jnp.asarray, bf), jnp.asarray(dt), xj)
    outt = tf(params, torch.from_numpy(Q), *map(torch.from_numpy, bf), torch.tensor(dt), xt)
    for group, (gj, gt) in enumerate(zip(outj, outt)):
        for i, (a, b) in enumerate(zip(gj, gt)):
            assert_close(b.numpy(), a, f"trace group {group} state {i}")


@pytest.mark.parametrize("emf_dir", ["x", "y", "z"])
def test_compute_emf_shear_term(emf_dir):
    from ramsesgpu_tpu.ops.riemann_mhd import compute_emf as jf
    from ramsesgpu_tpu_torch.ops.riemann_mhd import compute_emf as tf

    params = _jparams()
    rng = np.random.default_rng({"x": 3, "y": 4, "z": 5}[emf_dir])
    shape = (4, 6, params.isize)
    qs = [np.concatenate([rng.uniform(0.5, 1.5, (2,) + shape),
                          0.5 * rng.standard_normal((6,) + shape)]).astype(np.float32)
          for _ in range(4)]
    xpos = (params.xmin + params.dx / 2
            + (np.arange(params.isize, dtype=np.float32) - 3) * np.float32(params.dx))
    xpos = xpos.astype(np.float32).reshape(1, 1, -1)
    ej = jf(params, *map(jnp.asarray, qs), emf_dir, jnp.asarray(xpos))
    et = tf(params, *map(torch.from_numpy, qs), emf_dir, torch.from_numpy(xpos))
    assert_close(et.numpy(), ej, f"emf {emf_dir}")


def test_shear_cfl_bitwise():
    """inv_dt_mhd_shear on (S, kept) == the JAX CFL of the ghosted state,
    whose last column's +1 x face is the kept face."""
    from ramsesgpu_tpu.solvers.timestep import compute_inv_dt_mhd
    from ramsesgpu_tpu_torch.solvers.timestep import inv_dt_mhd_shear

    for ciso in (1.0, 0.0):
        params = _jparams().replace(c_iso=ciso)
        U = random_state(params, np.random.default_rng(6))
        S, kept = loop_state(params, U)
        want = compute_inv_dt_mhd(params, jnp.asarray(U))
        got = inv_dt_mhd_shear(params, torch.from_numpy(S.copy()), torch.from_numpy(kept.copy()))
        assert float(got) == float(want), ciso


@pytest.mark.parametrize("t", [0.0, 0.1234, 0.77, 3.5])
def test_sheared_fill_bitwise(t):
    """make_all_boundaries_shear at several t."""
    from ramsesgpu_tpu.solvers.shear import make_all_boundaries_shear as j_all
    from ramsesgpu_tpu_torch.solvers.shear import make_all_boundaries_shear as t_all

    params = _jparams()
    U = random_state(params, np.random.default_rng(7))
    tj, tt = jnp.asarray(t, jnp.float32), torch.tensor(t, dtype=torch.float32)
    np.testing.assert_array_equal(t_all(params, torch.from_numpy(U), tt).numpy(),
                                  np.asarray(j_all(params, jnp.asarray(U), tj)))


def test_remap_pairs_bitwise():
    """_shear_remap_pair_stacked at several t, and each channel equal to
    the JAX package's single-field _shear_remap_pair."""
    from ramsesgpu_tpu.solvers.godunov_mhd import _shear_remap_pair as j_pair
    from ramsesgpu_tpu.solvers.godunov_mhd import _shear_remap_pair_stacked as j_stacked
    from ramsesgpu_tpu_torch.solvers.godunov_mhd import _shear_remap_pair_stacked as t_stacked

    params = _jparams()
    rng = np.random.default_rng(8)
    f = rng.standard_normal((2, 2, params.nz, params.ny)).astype(np.float32)
    for t in (0.1, 0.37, 2.9):
        tj, dtj = jnp.asarray(t, jnp.float32), jnp.asarray(0.013, jnp.float32)
        tt, dtt = torch.tensor(t), torch.tensor(0.013)
        want = j_stacked(params, jnp.asarray(f[0]), jnp.asarray(f[1]), tj, dtj)
        got = t_stacked(params, torch.from_numpy(f[0]), torch.from_numpy(f[1]), tt, dtt)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for c in range(2):
            pair_j = j_pair(params, jnp.asarray(f[0, c]), jnp.asarray(f[1, c]), tj, dtj)
            for a, s in zip(pair_j, got):
                np.testing.assert_array_equal(s[c].numpy(), np.asarray(a))


# -------------------------------------------------------------------------
# conservation, the loop, conversion
# -------------------------------------------------------------------------
def div_b(params, S, kept):
    bx, by, bz = S[IA], S[IB], S[IC]
    bx_r = np.concatenate([bx[..., 1:], kept[..., None]], axis=-1)
    return ((bx_r - bx) / params.dx + (np.roll(by, -1, -2) - by) / params.dy
            + (np.roll(bz, -1, -3) - bz) / params.dz)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_conservation_and_divb(dtype):
    """Mass and the net Bz flux are conserved through the remap to
    rounding (tests/test_shear.py:141: 5e-9 in f32 over 30 steps), and
    the CT keeps divB, the kept face included, at rounding."""
    params, config, t0, U0 = setup(dtype)
    U, _t, k = port_advance(params, config, U0, t0, 20)
    assert k == 20
    S0, _ = loop_state(params, U0.numpy())
    S, kept = loop_state(params, U.numpy())
    S0, S, kept = S0.astype(np.float64), S.astype(np.float64), kept.astype(np.float64)
    eps = {"float32": 5e-9, "float64": 1e-14}[dtype]
    assert abs(S[ID].sum() - S0[ID].sum()) <= eps * S0[ID].sum()
    assert abs(S[IC].sum() - S0[IC].sum()) <= eps * np.abs(S0[IC]).sum()
    b_over_dx = np.abs(S[IA:]).max() / params.dx
    bound = {"float32": 1e-5, "float64": 1e-12}[dtype]
    assert np.abs(div_b(params, S, kept)).max() <= bound * b_over_dx
    assert np.abs(kept).max() > 0  # the kept face evolved


def test_chained_chunks_equal_unchained_and_fill_ghosts():
    from ramsesgpu_tpu_torch.solvers.shear import make_all_boundaries_shear
    from ramsesgpu_tpu_torch.solvers.step import make_packed_advance_chain

    params, config, t0, U0 = setup(kernel="pallas")
    U_ref, t_ref, k_ref = port_advance(params, config, U0, t0, N_STEPS)
    pack, advance, unpack = make_packed_advance_chain(params, "cpu", config)
    state, t = pack(U0.clone()), t0.clone()
    state, t, k1 = advance(state, t, 3)
    state, t, k2 = advance(state, t, 2)
    U = unpack(state, t)
    assert torch.equal(U, U_ref)
    assert torch.equal(U, make_all_boundaries_shear(params, U, t))  # a fresh fill at t
    assert float(t) == t_ref and int(k1) + int(k2) == k_ref


def test_stops_at_t_end():
    params, config, t0, U0 = setup()
    _, t3, _ = port_advance(params, config, U0, t0, 3)
    _, t2, _ = port_advance(params, config, U0, t0, 2)
    # t_end between the 2nd and 3rd step's end: the loop runs 3 steps
    params_end, config_end, _, _ = setup(tend=0.5 * (t2 + t3))
    U, t, k = port_advance(params_end, config_end, U0, t0, 10)
    U_ref, _, _ = port_advance(params, config, U0, t0, 3)
    assert k == 3 and t == t3
    assert torch.equal(U, U_ref)


def test_step_fn_equals_the_loop_and_wrappers_do_not_count_on_cpu():
    from ramsesgpu_tpu_torch.kernels import cfl_mhd, mhd_step, shear_border
    from ramsesgpu_tpu_torch.solvers.step import make_step_fn

    params, config, t0, U0 = setup()
    wrappers = (cfl_mhd.cfl_mhd, mhd_step.mhd_step, shear_border.shear_slabs,
                shear_border.shear_border)
    before = [w.launches for w in wrappers]
    U, dt = make_step_fn(params, "cpu", config)(U0.clone(), t0)
    U_loop, t, k = port_advance(params, config, U0, t0, 1)
    assert k == 1 and float(t0 + dt) == t
    assert torch.equal(U, U_loop)
    assert [w.launches for w in wrappers] == before == [0, 0, 0, 0]


def test_convert_roundtrips_match_pack_shear():
    from ramsesgpu_tpu.pallas.shear_packed import pack_shear
    from ramsesgpu_tpu_torch.convert import shear_carry_from_jax, shear_carry_to_jax
    from ramsesgpu_tpu_torch.kernels.shear import pack

    params, _config, _t0, U = setup()
    P, kept = map(np.asarray, pack_shear(params, jnp.asarray(U.numpy())))
    S_t, kept_t = shear_carry_from_jax(params, (P, kept), "cpu")
    S_p, kept_p = pack(params, U)
    assert torch.equal(S_t, S_p) and torch.equal(kept_t, kept_p)
    P2, kept2 = shear_carry_to_jax(params, (S_p, kept_p))
    np.testing.assert_array_equal(P2, P)
    np.testing.assert_array_equal(kept2, kept)


# relative-L2 bounds of the C++ host build against the twins (ULP-level
# differences only; the slabs and the border kernel repeat the twins' op
# order exactly)
TOL_HOST = {"float32": 1e-6, "float64": 1e-13}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_csrc_host_build_matches_shear_twins(dtype):
    """The shearing-box modes of csrc/cfl_mhd.cu and csrc/mhd_step.cu and
    the kernels of csrc/shear_border.cu, built with g++, against the twins
    on a random state, isothermal and adiabatic; the inactive step and
    border kernels change nothing."""
    from ramsesgpu_tpu_torch.kernels.build import load_library, param_block
    from ramsesgpu_tpu_torch.solvers.godunov_mhd import mhd_3d_shear_update, shear_border_update
    from ramsesgpu_tpu_torch.solvers.shear import shear_slabs
    from ramsesgpu_tpu_torch.solvers.timestep import dt_from_inv, inv_dt_mhd_shear

    lib = load_library("host")
    sfx = "f32" if dtype == "float32" else "f64"
    tdt = torch.float32 if dtype == "float32" else torch.float64

    def rel(a, b):
        return float(torch.linalg.norm((a - b).flatten()) / torch.linalg.norm(b.flatten()))

    for ciso in (1.0, 0.0):
        params = params_from_config(ConfigMap(text=ini(dtype))).replace(c_iso=ciso)
        nx, ny, nz = params.nx, params.ny, params.nz
        dims, blk = (nx, ny, nz), param_block(params)
        U = random_state(params, np.random.default_rng(9))
        S0, kept0 = (torch.from_numpy(np.ascontiguousarray(a)).to(tdt)
                     for a in loop_state(params, U))

        inv = torch.zeros((), dtype=tdt)
        assert getattr(lib, f"ramses_cfl_mhd_shear_{sfx}")(
            S0.data_ptr(), kept0.data_ptr(), None, None, inv.data_ptr(), *dims, blk, None) == 0
        inv_ref = inv_dt_mhd_shear(params, S0, kept0)
        assert abs(float(inv) - float(inv_ref)) <= TOL_HOST[dtype] * float(inv_ref), ciso
        dt = dt_from_inv(params, inv_ref)
        t = torch.tensor(t_start(params), dtype=tdt)

        slabs = torch.empty((2, 8, nz, ny, 3), dtype=tdt)
        assert getattr(lib, f"ramses_shear_slabs_{sfx}")(
            S0.data_ptr(), kept0.data_ptr(), slabs.data_ptr(), t.data_ptr(), dt.data_ptr(),
            *dims, blk, None) == 0
        slabs_ref = shear_slabs(params, S0, kept0, t + dt)
        assert torch.equal(slabs, slabs_ref), ciso

        step = getattr(lib, f"ramses_mhd_step_shear_{sfx}")
        scratch = torch.empty(lib.ramses_mhd_step_shear_scratch(*dims, 0), dtype=tdt)
        S1_ref, planes_ref = mhd_3d_shear_update(params, S0, slabs_ref, dt)
        border = getattr(lib, f"ramses_shear_border_{sfx}")
        S2_ref, kept2_ref, rem_ref = shear_border_update(params, S1_ref, kept0, planes_ref, t, dt)
        for active in (False, True):
            flag = torch.tensor(active)
            S1, planes = S0.clone(), torch.zeros_like(planes_ref)
            assert step(S1.data_ptr(), scratch.data_ptr(), slabs_ref.data_ptr(),
                        planes.data_ptr(), None, None, dt.data_ptr(), flag.data_ptr(), 0, *dims,
                        blk, None) == 0
            S2, kept2, rem = S1_ref.clone(), kept0.clone(), torch.zeros_like(rem_ref)
            assert border(S2.data_ptr(), kept2.data_ptr(), planes_ref.data_ptr(), rem.data_ptr(),
                          t.data_ptr(), dt.data_ptr(), flag.data_ptr(), 0, *dims, blk, None) == 0
            if not active:
                assert torch.equal(S1, S0) and torch.equal(S2, S1_ref)
                assert torch.equal(kept2, kept0)
                continue
            assert rel(S1, S1_ref) <= TOL_HOST[dtype], ciso
            assert rel(planes, planes_ref) <= TOL_HOST[dtype], ciso
            assert torch.equal(S2, S2_ref) and torch.equal(kept2, kept2_ref), ciso
            assert torch.equal(rem, rem_ref), ciso


# -------------------------------------------------------------------------
# what the port refuses
# -------------------------------------------------------------------------
@pytest.mark.parametrize(
    "section, key, value",
    [
        ("mesh", "boundary_zmin", "6"),
        ("gravity", "enabled", "yes"),
        ("implementation", "kernel", "zcarry"),
    ],
)
def test_out_of_scope_configurations_raise(section, key, value):
    from ramsesgpu_tpu_torch.solvers.run import Run
    from ramsesgpu_tpu_torch.solvers.step import make_advance_n, require_slice

    text = ini() + f"\n[{section}]\n{key}={value}\n"
    config = ConfigMap(text=text)
    params = params_from_config(config)
    require_slice(params_from_config(ConfigMap(text=ini())), "cpu", ConfigMap(text=ini()))
    if value == "zcarry":
        # in the scope since the z-streaming kernels (tests/test_torch_zcarry.py)
        run = Run(config, "cpu")
        run.start(max_steps=1, do_output=False)
        assert np.isfinite(run.interior()).all()
        make_advance_n(params, "cpu", config)
        return
    with pytest.raises(NotImplementedError):
        Run(config, "cpu")
    with pytest.raises(NotImplementedError):
        make_advance_n(params, "cpu", config)


@pytest.mark.parametrize(
    "section, key, value",
    [
        ("hydro", "nu", "4e-5"),
        ("MHD", "eta", "1e-5"),
        ("implementation", "stripFused", "yes"),
        ("implementation", "compensated", "yes"),
    ],
)
def test_dissipative_and_strip_fused_configurations_run(section, key, value):
    """Viscosity, resistivity (tests/test_torch_dissip.py holds them against
    the JAX package), stripFused=yes, which selects the same kernels as no,
    and the Kahan-compensated state (tests/test_torch_compensated.py) run
    through Run and the loop."""
    from ramsesgpu_tpu_torch.solvers.run import Run
    from ramsesgpu_tpu_torch.solvers.step import make_advance_n

    config = ConfigMap(text=ini() + f"\n[{section}]\n{key}={value}\n")
    params = params_from_config(config)
    assert (params.nu, params.eta, params.strip_fused, params.compensated) != (0.0, 0.0, None,
                                                                             False)
    run = Run(config, "cpu")
    run.start(max_steps=1, do_output=False)
    assert np.isfinite(run.interior()).all()
    make_advance_n(params, "cpu", config)


def test_stratified_mri_and_keplerian_disk_raise():
    """The stratified MRI runs (tests/test_torch_stratified.py) but not with
    viscosity or resistivity, nor adiabatic; a [gravity] section without
    stratified z faces and the Keplerian disk raise."""
    from ramsesgpu_tpu_torch.solvers.run import Run
    from ramsesgpu_tpu_torch.solvers.step import require_slice

    text = (REPO / "data" / "mhd_mri_3d_stratified.ini").read_text()
    for change in ("nu=4e-5", "eta=1e-5", "cIso=0"):
        key, value = change.split("=")
        stratified = ConfigMap(text=text)
        stratified.set_float("MHD" if key == "eta" else "hydro", key, float(value))
        with pytest.raises(NotImplementedError):
            Run(stratified, "cpu")
    # MRI with a [gravity] section but periodic z: the gravity gate alone
    config = ConfigMap(text=ini() + "\n[gravity]\nstatic=yes\n")
    with pytest.raises(NotImplementedError, match="gravity"):
        require_slice(params_from_config(config), "cpu", config)
    kepler = ConfigMap(text=(REPO / "data" / "implode3d.ini").read_text().replace(
        "problem=implode", "problem=Keplerian-disk"))
    assert "Keplerian-disk" in kepler.get_string("hydro", "problem", "")
    with pytest.raises(NotImplementedError, match="gravity"):
        require_slice(params_from_config(kepler), "cpu", kepler)


def test_cli_runs_mri_on_cpu(tmp_path, capsys):
    from ramsesgpu_tpu_torch.cli.main import main

    path = tmp_path / "mri.ini"
    path.write_text(ini(outdir=tmp_path))
    assert main(["--param", str(path), "--device", "cpu", "--max-steps", "2"]) == 0
    out = capsys.readouterr().out
    assert "number of time steps   : 2" in out and "problem        : MRI" in out
    assert (tmp_path / "mri_0000002.vti").exists()
