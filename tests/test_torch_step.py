"""The port's main-path slice against the JAX package on the CPU: 3D
Orszag-Tang, fully periodic, HLLD + 2D-HLLD, 16^3 (g = 3), 5 steps.

The JAX reference is ``make_advance_n`` with ``[implementation] kernel=jnp``
(its whole-array path, which tests/test_pallas.py holds equal to the
Pallas kernel in interpret mode), run op by op under ``jax.disable_jit()``:
the same functions without XLA's whole-step compile, which costs ~50 s of
CPU time per dtype at this size. The port runs its kernel loop, whose
wrappers run their plain twins on CPU tensors. Pass criteria: equal step
counts; t within rtol 1e-6 (f32) / 1e-12 (f64); state relative L2 <= 2e-6
(f32) / 1e-11 (f64).

The CUDA sources themselves are also checked here, compiled as plain C++
(kernels/build.py ``build("host")``) and held against the twins.
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

from ramsesgpu_tpu.config.configmap import ConfigMap
from ramsesgpu_tpu.config.params import params_from_config
from ramsesgpu_tpu.core.constants import IA, IB, IC, ID, IP

torch.set_num_threads(2)

OT3D_INI = """
[run]
tend={tend}
[mesh]
nx=16
ny=16
nz=16
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
kernel={kernel}
"""
N_STEPS = 5
TOL_T = {"float32": 1e-6, "float64": 1e-12}
TOL_L2 = {"float32": 2e-6, "float64": 1e-11}


def ot_params(dtype="float32", kernel="jnp", tend=100.0):
    config = ConfigMap(text=OT3D_INI.format(dtype=dtype, kernel=kernel, tend=tend))
    return params_from_config(config), config


def initial_state(params, config):
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries
    from ramsesgpu_tpu_torch.problems import init_problem

    dtype = torch.float64 if params.dtype == "float64" else torch.float32
    return make_boundaries(params, torch.from_numpy(init_problem(params, config)).to(dtype))


def port_advance(params, U0, n):
    from ramsesgpu_tpu_torch.solvers.step import make_advance_n

    U, t, k = make_advance_n(params, "cpu")(U0.clone(), torch.zeros((), dtype=U0.dtype), n)
    return U.numpy(), float(t), int(k)


def rel_l2(a, b, g=3):
    a, b = a[:, g:-g, g:-g, g:-g], b[:, g:-g, g:-g, g:-g]
    return float(np.linalg.norm((a - b).ravel()) / np.linalg.norm(b.ravel()))


@pytest.fixture(scope="module")
def jax_f32():
    from ramsesgpu_tpu.solvers.step import make_advance_n

    params, config = ot_params("float32")
    U0 = jnp.asarray(initial_state(params, config).numpy())
    with jax.disable_jit():
        U, t, k = make_advance_n(params, config)(
            U0, jnp.asarray(0.0, jnp.float32), jnp.array(N_STEPS, jnp.int32)
        )
    return np.asarray(U), float(t), int(k)


_JAX_F64 = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
from ramsesgpu_tpu.config.configmap import ConfigMap
from ramsesgpu_tpu.config.params import params_from_config
from ramsesgpu_tpu.problems.mhd_inits import init_orszag_tang
from ramsesgpu_tpu.solvers.boundary import make_boundaries
from ramsesgpu_tpu.solvers.step import make_advance_n
config = ConfigMap(text=sys.argv[1])
params = params_from_config(config)
U = make_boundaries(params, jnp.asarray(init_orszag_tang(params, config)))
assert U.dtype == jnp.float64
with jax.disable_jit():
    U, t, k = make_advance_n(params, config)(
        U, jnp.asarray(0.0, U.dtype), jnp.array(int(sys.argv[3]), jnp.int32))
np.savez(sys.argv[2], U=np.asarray(U), t=float(t), k=int(k))
"""


@pytest.fixture(scope="module")
def jax_f64(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_f64") / "ref.npz"
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    repo_root = str(Path(__file__).resolve().parent.parent)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (repo_root, env.get("PYTHONPATH")) if p)
    ini = OT3D_INI.format(dtype="float64", kernel="jnp", tend=100.0)
    res = subprocess.run([sys.executable, "-c", _JAX_F64, ini, str(out), str(N_STEPS)],
                         capture_output=True, text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    ref = np.load(out)
    return ref["U"], float(ref["t"]), int(ref["k"])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_slice_matches_jax(dtype, request):
    U_ref, t_ref, k_ref = request.getfixturevalue("jax_f32" if dtype == "float32" else "jax_f64")
    params, config = ot_params(dtype, "auto")
    U, t, k = port_advance(params, initial_state(params, config), N_STEPS)
    assert k == k_ref == N_STEPS
    assert U.dtype == U_ref.dtype == np.dtype(dtype)
    assert np.isfinite(U).all()
    assert abs(t - t_ref) <= TOL_T[dtype] * abs(t_ref)
    assert rel_l2(U, U_ref) <= TOL_L2[dtype]


def test_chained_chunks_equal_unchained():
    from ramsesgpu_tpu_torch.solvers.step import make_packed_advance_chain

    params, config = ot_params("float32", "pallas")
    U0 = initial_state(params, config)
    U_ref, t_ref, k_ref = port_advance(params, U0, N_STEPS)
    pack, advance, unpack = make_packed_advance_chain(params, "cpu")
    S, t = pack(U0.clone()), torch.zeros(())
    S, t, k1 = advance(S, t, 3)
    S, t, k2 = advance(S, t, 2)
    np.testing.assert_array_equal(unpack(S, t).numpy(), U_ref)
    assert float(t) == t_ref and int(k1) + int(k2) == k_ref


@pytest.mark.parametrize("kernel", ["auto", "pallas", "jnp"])
def test_step_fn_equals_twin_step(kernel):
    """Every kernel choice runs the one kernel loop on the CPU, whose
    wrappers take the twins: the step equals the twins' step exactly."""
    from ramsesgpu_tpu_torch.solvers.boundary import interior, make_boundaries_concat
    from ramsesgpu_tpu_torch.solvers.godunov_mhd import mhd_3d_periodic_update
    from ramsesgpu_tpu_torch.solvers.step import make_step_fn
    from ramsesgpu_tpu_torch.solvers.timestep import dt_from_inv, inv_dt_mhd_periodic

    params, config = ot_params("float32", kernel)
    U0 = initial_state(params, config)
    U, dt = make_step_fn(params, "cpu")(U0.clone(), torch.zeros(()))
    S0 = interior(params, U0)
    dt_ref = dt_from_inv(params, inv_dt_mhd_periodic(params, S0))
    assert torch.equal(dt, dt_ref)
    want = mhd_3d_periodic_update(params, S0, dt_ref)
    assert torch.equal(U, make_boundaries_concat(params, want, interior_only=True))


def test_stops_at_t_end():
    params, config = ot_params("float32", "pallas")
    U0 = initial_state(params, config)
    _, t3, _ = port_advance(params, U0, 3)
    _, t2, _ = port_advance(params, U0, 2)
    # t_end between the 2nd and 3rd step's end: the loop runs 3 steps
    params_end, _ = ot_params("float32", "pallas", tend=0.5 * (t2 + t3))
    U, t, k = port_advance(params_end, U0, 10)
    U_ref, _, _ = port_advance(params, U0, 3)
    assert k == 3 and t == t3
    np.testing.assert_array_equal(U, U_ref)


def div_b(params, U):
    bx, by, bz = U[IA], U[IB], U[IC]
    d = ((np.roll(bx, -1, -1) - bx) / params.dx + (np.roll(by, -1, -2) - by) / params.dy
         + (np.roll(bz, -1, -3) - bz) / params.dz)
    g = params.ghost_width
    return d[(slice(g, -g - 1),) * 3]


def test_divb_and_conservation():
    """As tests/test_mhd.py test_mhd_3d_divb_and_conservation, on the port."""
    params, config = ot_params("float32", "pallas")
    U0 = initial_state(params, config)
    U, _, k = port_advance(params, U0, 25)
    U0 = U0.numpy()
    assert k == 25 and np.isfinite(U).all()
    b_over_dx = max(np.abs(U[IA]).max(), 1e-10) / params.dx
    assert np.abs(div_b(params, U)).max() < 1e-3 * b_over_dx
    sl = (slice(3, -3),) * 3
    np.testing.assert_allclose(U[ID][sl].sum(), U0[ID][sl].sum(), rtol=1e-5)
    np.testing.assert_allclose(U[IP][sl].sum(), U0[IP][sl].sum(), rtol=1e-4)


# relative-L2 bounds of the C++ host build of csrc/ against the twins
# after one step (ULP-level differences only)
TOL_HOST = {"float32": 1e-6, "float64": 1e-13}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_csrc_host_build_matches_twins(dtype):
    from ramsesgpu_tpu_torch.kernels.build import load_library, param_block
    from ramsesgpu_tpu_torch.solvers.boundary import interior
    from ramsesgpu_tpu_torch.solvers.godunov_mhd import mhd_3d_periodic_update
    from ramsesgpu_tpu_torch.solvers.timestep import dt_from_inv, inv_dt_mhd_periodic

    lib = load_library("host")
    sfx = "f32" if dtype == "float32" else "f64"
    params, config = ot_params(dtype)
    S0 = interior(params, initial_state(params, config))
    rng = np.random.default_rng(7)
    noise = torch.from_numpy(rng.standard_normal(S0.shape)).to(S0.dtype)
    S0 = (S0 * (1 + 0.05 * noise)).contiguous()
    blk = param_block(params)

    inv = torch.zeros((), dtype=S0.dtype)
    assert getattr(lib, f"ramses_cfl_mhd_{sfx}")(
        S0.data_ptr(), None, inv.data_ptr(), 16, 16, 16, blk, None) == 0
    inv_ref = inv_dt_mhd_periodic(params, S0)
    assert abs(float(inv) - float(inv_ref)) <= TOL_HOST[dtype] * float(inv_ref)

    dt = dt_from_inv(params, inv_ref)
    scratch = torch.empty(lib.ramses_mhd_step_scratch_per_cell() * S0[0].numel(), dtype=S0.dtype)
    step = getattr(lib, f"ramses_mhd_step_{sfx}")
    for active, want in ((False, S0), (True, mhd_3d_periodic_update(params, S0, dt))):
        S = S0.clone()
        flag = torch.tensor(active)
        assert step(S.data_ptr(), scratch.data_ptr(), dt.data_ptr(), flag.data_ptr(), 0,
                    16, 16, 16, blk, None) == 0
        err = float(torch.linalg.norm((S - want).flatten()) / torch.linalg.norm(want.flatten()))
        assert err <= TOL_HOST[dtype]
