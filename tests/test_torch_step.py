"""The port's main-path slice against the JAX package on the CPU: 3D
Orszag-Tang, fully periodic, HLLD + 2D-HLLD, 16^3 (g = 3), 5 steps.

The JAX reference is ``make_advance_n`` with ``[implementation] kernel=jnp``
(its whole-array path, which tests/test_pallas.py holds equal to the
Pallas kernel in interpret mode), run op by op under ``jax.disable_jit()``
in one subprocess: the same functions without XLA's whole-step compile,
which costs ~50 s of CPU time per dtype at this size. The port runs its kernel loop, whose
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

import numpy as np
import pytest
import torch

from ramsesgpu_tpu.config.configmap import ConfigMap
from ramsesgpu_tpu.config.params import params_from_config
from ramsesgpu_tpu.core.constants import IA, IB, IC, ID, IP

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent

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
TOL_ZCARRY = {"float32": 2e-6, "float64": 1e-13}


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


_JAX_SCRIPT = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
sys.path.insert(0, sys.argv[4])
from ramsesgpu_tpu.config.configmap import ConfigMap
from ramsesgpu_tpu.config.params import params_from_config
from ramsesgpu_tpu.problems import init_problem
from ramsesgpu_tpu.problems.mhd_inits import init_orszag_tang
from ramsesgpu_tpu.solvers.boundary import make_boundaries
from ramsesgpu_tpu.solvers.shear import make_all_boundaries_shear
from ramsesgpu_tpu.solvers.step import make_advance_n, uses_shear
import test_torch_step as m
config = ConfigMap(text=sys.argv[1])
params = params_from_config(config)
U = make_boundaries(params, jnp.asarray(init_orszag_tang(params, config)))
assert U.dtype == jnp.float64
with jax.disable_jit():
    U, t, k = make_advance_n(params, config)(
        U, jnp.asarray(0.0, U.dtype), jnp.array(int(sys.argv[3]), jnp.int32))
out = dict(U=np.asarray(U), t=float(t), k=int(k))
# the f32 slice from the port's f32 initial state (the same arrays, bitwise,
# as without jax_enable_x64)
params, config = m.ot_params("float32")
U0 = jnp.asarray(m.initial_state(params, config).numpy())
with jax.disable_jit():
    U, t, k = make_advance_n(params, config)(
        U0, jnp.asarray(0.0, jnp.float32), jnp.array(int(sys.argv[3]), jnp.int32))
out.update(f32_U=np.asarray(U), f32_t=float(t), f32_k=int(k))
# the short-axis cases (test_short_axis_periodic_ghosts_match_jax)
for name in m.NZ2_CASES:
    config = ConfigMap(text=m.nz2_text(name, "jnp"))
    params = params_from_config(config)
    U = make_boundaries(params, jnp.asarray(init_problem(params, config), jnp.float64))
    t0 = jnp.asarray(0.0, jnp.float64)
    if uses_shear(params):
        U = make_all_boundaries_shear(params, U, t0)
    with jax.disable_jit():
        U, t, k = make_advance_n(params, config)(U, t0, jnp.array(m.NZ2_STEPS, jnp.int32))
    out[name + "_U"], out[name + "_t"], out[name + "_k"] = np.asarray(U), float(t), int(k)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    """The JAX package's runs, one subprocess: the slice in f64 and f32,
    and the short-axis cases."""
    out = tmp_path_factory.mktemp("jax_f64") / "ref.npz"
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    here = Path(__file__).resolve().parent
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(here.parent), env.get("PYTHONPATH")) if p)
    # a quick, single-threaded backend: the suite's other workers share the
    # cores (the arrays are bitwise those of the default backend)
    flags = ("--xla_backend_optimization_level=0 --xla_cpu_multi_thread_eigen=false "
             "intra_op_parallelism_threads=1")
    env["XLA_FLAGS"] = " ".join(f for f in (env.get("XLA_FLAGS"), flags) if f)
    ini = OT3D_INI.format(dtype="float64", kernel="jnp", tend=100.0)
    res = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, ini, str(out), str(N_STEPS),
                          str(here)],
                         capture_output=True, text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return dict(np.load(out))


@pytest.fixture(scope="module")
def jax_f64(jax_refs):
    return jax_refs["U"], float(jax_refs["t"]), int(jax_refs["k"])


@pytest.fixture(scope="module")
def jax_f32(jax_refs):
    return jax_refs["f32_U"], float(jax_refs["f32_t"]), int(jax_refs["f32_k"])


def check_slice(dtype, kernel, request, tol_l2):
    U_ref, t_ref, k_ref = request.getfixturevalue("jax_f32" if dtype == "float32" else "jax_f64")
    params, config = ot_params(dtype, kernel)
    assert params.kernel == kernel
    U, t, k = port_advance(params, initial_state(params, config), N_STEPS)
    assert k == k_ref == N_STEPS
    assert U.dtype == U_ref.dtype == np.dtype(dtype)
    assert np.isfinite(U).all()
    assert abs(t - t_ref) <= TOL_T[dtype] * abs(t_ref)
    assert rel_l2(U, U_ref) <= tol_l2[dtype]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_slice_matches_jax(dtype, request):
    check_slice(dtype, "auto", request, TOL_L2)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_zcarry_slice_matches_jax(dtype, request):
    """kernel=zcarry (the streamed step's loop: two buffers that take
    turns, the folded inverse dt, the copy back after an odd step count;
    its twins on the CPU) against the same JAX run, at the zcarry tests'
    tolerance (tests/test_torch_zcarry.py TOL_L2)."""
    check_slice(dtype, "zcarry", request, TOL_ZCARRY)


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


# every mode of csrc/cfl_mhd.cu on a shape that is no multiple of its row
# split (a warp takes a row, a lane 4 cells 32 apart): the mode, its input
# (an INI text or a shipped input) and whether its state is ghosted
CFL_MODES = {"periodic": ("ot", False), "shear": ("data/mhd_mri_3d.ini", False),
             "stratified": ("data/mhd_mri_3d_stratified.ini", False),
             "ghosted": ("ot", True), "ghosted_shear": ("data/mhd_mri_3d.ini", True)}


@pytest.mark.parametrize("mode", list(CFL_MODES))
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_csrc_host_build_cfl_mhd_modes(dtype, mode):
    """csrc/cfl_mhd.cu built with g++, each mode at 37x11x5 (and 133x3x2:
    rows longer than a warp's 128 cells) on a random physical state against
    its twin (TOL_HOST); a NaN cell makes the result NaN."""
    import re

    from ramsesgpu_tpu_torch.config.configmap import ConfigMap as PortConfigMap
    from ramsesgpu_tpu_torch.config.params import params_from_config as port_params
    from ramsesgpu_tpu_torch.kernels.build import load_library, param_block
    from ramsesgpu_tpu_torch.solvers.timestep import (inv_dt_mhd_ghosted,
                                                      inv_dt_mhd_ghosted_shear,
                                                      inv_dt_mhd_periodic, inv_dt_mhd_shear)

    lib = load_library("host")
    sfx = "f32" if dtype == "float32" else "f64"
    tdt = torch.float32 if dtype == "float32" else torch.float64
    source, ghosted = CFL_MODES[mode]
    rng = np.random.default_rng(9)
    for nx, ny, nz in ((37, 11, 5), (133, 3, 2)):
        text = (OT3D_INI.format(dtype=dtype, kernel="auto", tend=1.0) if source == "ot"
                else Path(REPO, source).read_text())
        for axis, n in (("nx", nx), ("ny", ny), ("nz", nz)):
            text = re.sub(rf"^{axis}=\d+$", f"{axis}={n}", text, count=1, flags=re.M)
        params = port_params(PortConfigMap(text=text)).replace(compensated=False)
        g = params.ghost_width
        shape = params.shape[1:] if ghosted else (nz, ny, nx)
        rho = rng.uniform(0.5, 1.5, shape)
        vel = 0.5 * rng.standard_normal((3,) + shape)
        bf = 0.5 * rng.standard_normal((3,) + shape)
        e = rng.uniform(0.5, 1.5, shape) / (params.gamma0 - 1.0) + 0.5 * rho * (
            vel ** 2).sum(0) + 0.5 * (bf ** 2).sum(0)
        S = torch.from_numpy(np.stack([rho, e, *(rho * vel), *bf])).to(tdt).contiguous()
        kept = torch.from_numpy(0.5 * rng.standard_normal((nz, ny))).to(tdt)
        blk = param_block(params)

        def host(S):
            inv = torch.zeros((), dtype=tdt)
            fn = getattr(lib, f"ramses_cfl_mhd_{mode}_{sfx}" if mode != "periodic" and
                         mode != "stratified" else
                         f"ramses_cfl_mhd_{'shear_' if mode == 'stratified' else ''}{sfx}")
            if mode == "ghosted":
                err = fn(S.data_ptr(), None, None, inv.data_ptr(), nx, ny, nz, g,
                         float("-inf"), blk, None)
            elif mode == "ghosted_shear":
                err = fn(S.data_ptr(), None, None, inv.data_ptr(), nx, ny, nz, g, blk, None)
            elif mode in ("shear", "stratified"):
                err = fn(S.data_ptr(), kept.data_ptr(), None, None, inv.data_ptr(), nx, ny, nz,
                         blk, None)
            else:
                err = fn(S.data_ptr(), None, None, inv.data_ptr(), nx, ny, nz, blk, None)
            assert err == 0
            return inv

        def twin(S):
            if mode == "periodic":
                return inv_dt_mhd_periodic(params, S)
            if mode in ("shear", "stratified"):
                return inv_dt_mhd_shear(params, S, kept)
            if mode == "ghosted":
                return inv_dt_mhd_ghosted(params, S)
            return inv_dt_mhd_ghosted_shear(params, S)

        got, want = host(S), twin(S)
        assert abs(float(got) - float(want)) <= TOL_HOST[dtype] * float(want), (nx, ny, nz)
        o = g if ghosted else 0  # an interior cell
        S[ID, nz // 2 + o, 1 + o, 2 + o] = float("nan")
        assert torch.isnan(host(S)) and torch.isnan(twin(S)), (nx, ny, nz)


# the cases: one step and its CFL, or (states) the 18 traced states the
# step kernel forms from its precursor stage's output
@pytest.mark.parametrize("dtype,part", [("float32", "step"), ("float64", "step"),
                                        ("float32", "states"), ("float64", "states")],
                         ids=["float32", "float64", "float32-states", "float64-states"])
def test_csrc_host_build_matches_twins(dtype, part):
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
    if part == "states":
        check_host_traced_states(lib, sfx, params, S0, blk)
        return

    inv = torch.zeros((), dtype=S0.dtype)
    assert getattr(lib, f"ramses_cfl_mhd_{sfx}")(
        S0.data_ptr(), None, None, inv.data_ptr(), 16, 16, 16, blk, None) == 0
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


def check_host_traced_states(lib, sfx, params, S0, blk):
    """Each of the 18 traced states, formed from the host build's precursor
    stage as the step kernel's flux + EMF stage forms them, against the
    twin's (ops/trace_mhd3d.py) on the same state and dt."""
    from ramsesgpu_tpu_torch.ops.eos import constoprim_mhd
    from ramsesgpu_tpu_torch.ops.trace_mhd3d import STATE_NAMES, trace_unsplit_mhd_3d_parts
    from ramsesgpu_tpu_torch.solvers.timestep import dt_from_inv, inv_dt_mhd_periodic

    dt = dt_from_inv(params, inv_dt_mhd_periodic(params, S0))
    n = S0[0].numel()
    scratch = torch.empty(lib.ramses_mhd_step_scratch_per_cell() * n, dtype=S0.dtype)
    got = torch.empty((18, 8) + tuple(S0.shape[1:]), dtype=S0.dtype)
    assert getattr(lib, f"ramses_mhd_traced_states_{sfx}")(
        S0.data_ptr(), scratch.data_ptr(), got.data_ptr(), dt.data_ptr(), params.nx,
        params.ny, params.nz, blk) == 0
    Q, _c = constoprim_mhd(params, S0, dt)
    parts = trace_unsplit_mhd_3d_parts(params, Q, S0[IA], S0[IB], S0[IC], dt)
    for s, name in enumerate(STATE_NAMES):
        want = parts[name]()
        err = float(torch.linalg.norm((got[s] - want).flatten()) / torch.linalg.norm(want.flatten()))
        assert err <= TOL_HOST[params.dtype], (name, err)


# -------------------------------------------------------------------------
# an axis shorter than the ghost width: periodic ghosts by modular index
# -------------------------------------------------------------------------
# two shipped inputs at 16x16x2 under g = 3 ghost layers: the field loop in
# the shearing box (shipped with nz = 2) and Orszag-Tang; 3 f64 steps of
# the port's loop against the JAX whole-array run (kernel=jnp), interiors
# within relative L2 TOL_NZ2 and t equal
NZ2_CASES = {"fieldloop3d_shear": "data/mhd_fieldloop3d_shear.ini",
             "orszag-tang3d": "data/orszag-tang3d.ini"}
NZ2_STEPS = 3
TOL_NZ2 = 1e-14


def nz2_text(name: str, kernel: str) -> str:
    """The INI of one case at 16x16x2, f64, with the kernel choice."""
    import re

    text = (Path(__file__).resolve().parent.parent / NZ2_CASES[name]).read_text()
    for key, value in (("nx", 16), ("ny", 16), ("nz", 2)):
        text = re.sub(rf"^{key}=.*$", f"{key}={value}", text, flags=re.M)
    return text + f"\n[implementation]\ndtype=float64\nkernel={kernel}\n"


@pytest.mark.parametrize("name", list(NZ2_CASES))
def test_short_axis_periodic_ghosts_match_jax(name, jax_refs):
    """nz = 2 under 3 ghost layers: the unpack's periodic ghosts wrap by
    modular index (solvers/boundary.py periodic_band), as jnp.pad does, so
    the loop, its unpack and the next chunk run as the JAX package's."""
    from ramsesgpu_tpu_torch.config.configmap import ConfigMap as TConfigMap
    from ramsesgpu_tpu_torch.config.params import params_from_config as t_params
    from ramsesgpu_tpu_torch.problems import init_problem
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries
    from ramsesgpu_tpu_torch.solvers.shear import make_all_boundaries_shear
    from ramsesgpu_tpu_torch.solvers.step import make_advance_n

    config = TConfigMap(text=nz2_text(name, "auto"))
    params = t_params(config)
    U = make_boundaries(params, torch.from_numpy(init_problem(params, config)).double())
    t0 = torch.zeros((), dtype=torch.float64)
    if name == "fieldloop3d_shear":
        U = make_all_boundaries_shear(params, U, t0)
    advance = make_advance_n(params, "cpu", config)
    U1, t1, k1 = advance(U, t0, 2)        # two chunks: the unpack feeds the next pack
    U2, t2, k2 = advance(U1, t1, NZ2_STEPS - 2)
    assert U2.shape == U.shape and int(k1) + int(k2) == int(jax_refs[name + "_k"]) == NZ2_STEPS
    assert float(t2) == float(jax_refs[name + "_t"])
    assert rel_l2(U2.numpy(), jax_refs[name + "_U"]) <= TOL_NZ2
