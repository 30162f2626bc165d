"""The port's static gravity and the walled dissipation against the JAX
package on the CPU.

The six single-device gravity inputs (rayleigh_taylor_gpu_2d,
falling_bubble_gpu_2d, Keplerian_disk2d, rayleigh_taylor_cpu_2d_mhd:
the 2D whole-array step with the field; rayleigh_taylor_gpu_3d: the hydro
step kernel's gravity instance, walls in z; rayleigh_taylor_gpu_3d_mhd:
the MHD step kernel's ghosted gravity instance), and walled or jet MHD
with nu or eta (the dissipation kernel's ghosted mode), whose CPU twins
run here through the kernel wrappers.

The JAX references run in one subprocess with jax_enable_x64 (float32
arrays stay float32): ``make_advance_n`` (kernel=jnp, its whole-array
step) op by op under ``jax.disable_jit()``, whose per-op compiles the
cases of one mesh and dtype share (2D 32 x 32, 3D 12 x 10 x 16: partial
edge tiles of every kernel), and ``make_gravity_field``. Pass criteria:

- initial states bitwise; the fields bitwise;
- 3 steps in f64 of the port's CPU make_advance_n (kernel=auto, and
  kernel=zcarry for the 3D pair): t after each step within rtol 1e-14
  (the 3D CFL twins round dt at ULP level), the interior within relative
  L2 1e-12 (the walled and jet MHD with nu or eta: the whole ghosted
  array, whose max-side face layer the whole-array step's CT updates);
- falling_bubble_gpu_2d and rayleigh_taylor_gpu_3d in f32: the interior
  within relative L2 2e-6 of JAX's f32 run (tests/test_torch_walls.py's
  f32 budget);
- the g++ host build of the new instances and modes (hydro_step.cu's
  gravity instance, interior and ghosted; mhd_step.cu's ghosted gravity
  instances, adiabatic and isothermal; dissip_step.cu's ghosted mode)
  against the twins at odd sizes (partial tiles): relative L2 <= TOL_HOST
  after one step, an inactive step changes nothing;
- the six inputs as shipped, one step each through the CLI's main();
- chip_smoke.py ghosted_reads (the bytes of the ghosted steps' bounds)
  equal to the support of each twin's gradient at 6 x 7 x 5.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ramsesgpu_tpu_torch.config.configmap import ConfigMap
from ramsesgpu_tpu_torch.config.params import params_from_config

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
N_STEPS = 3
TOL = 1e-12
TOL_T = 1e-14
TOL_F32 = 2e-6
TOL_HOST = {"float32": 1e-6, "float64": 1e-13}
MESH_2D = (32, 32, 1)
MESH_3D = (12, 10, 16)
INPUTS = {
    "rt2": "rayleigh_taylor_gpu_2d",
    "bubble": "falling_bubble_gpu_2d",
    "kepler": "Keplerian_disk2d",
    "rt2_mhd": "rayleigh_taylor_cpu_2d_mhd",
    "rt3": "rayleigh_taylor_gpu_3d",
    "rt3_mhd": "rayleigh_taylor_gpu_3d_mhd",
}
# walled Brio-Wu with viscosity and resistivity; the MHD jet (an ambient
# field, so that the currents are not 0) with resistivity
DISSIP = {
    "walls": ("testRiemannHLLD", {"[hydro]": "nu=2e-3", "[MHD]": "eta=2e-3"}),
    "jet": ("mhd_jet3d", {"ijet": 3, "offsetJet": 2, "[jet]": "bamb=0.7",
                          "[MHD]": "eta=2e-3"}),
}
F32 = ("bubble", "rt3")


def ini(name, dtype="float64", kernel="auto", keys=None, mesh=None):
    """data/<name>.ini cut to ``mesh`` (2D inputs: 32 x 32; 3D: 12 x 10 x
    16), with the dtype, the kernel choice and other keys ("[section]": a
    line added to that section)."""
    text = (REPO / "data" / f"{name}.ini").read_text()
    if mesh is None:
        mesh = MESH_2D if re.search(r"^nz=1\s*$", text, flags=re.M) else MESH_3D
    subs = dict(zip(("nx", "ny", "nz"), mesh), **(keys or {}))
    for key, value in subs.items():
        if key.startswith("["):
            assert text.count(key + "\n") == 1, key
            text = text.replace(key + "\n", f"{key}\n{value}\n")
        else:
            text, n = re.subn(rf"^{key}=.*$", f"{key}={value}", text, flags=re.M)
            assert n == 1, (name, key)
    return text + f"\n[implementation]\ndtype={dtype}\nkernel={kernel}\n"


def cases():
    """(key, INI text builder) of every JAX reference run."""
    out = [(k, lambda dtype, kernel, n=n: ini(n, dtype, kernel)) for k, n in INPUTS.items()]
    out += [(k, lambda dtype, kernel, n=n, keys=keys: ini(n, dtype, kernel, keys))
            for k, (n, keys) in DISSIP.items()]
    return out


def rel_l2(a, b):
    """|a - b| / |b| in L2; sums of squares (no BLAS threads)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.square(a - b).sum())) / (float(np.sqrt(np.square(b).sum())) or 1.0)


def inner(U, g, dim):
    return U[(slice(None),) + (slice(g, -g),) * dim]


def jax_references():
    """Every JAX reference of this file: numpy arrays by key."""
    import jax
    import jax.numpy as jnp

    from ramsesgpu_tpu.config.configmap import ConfigMap as JConfigMap
    from ramsesgpu_tpu.config.params import params_from_config as j_params
    from ramsesgpu_tpu.problems import init_problem
    from ramsesgpu_tpu.solvers.boundary import make_boundaries
    from ramsesgpu_tpu.solvers.step import make_advance_n, make_gravity_field

    out = {}
    with jax.disable_jit():
        for key, text_of in cases():
            for dtype in ("float64", "float32") if key in F32 else ("float64",):
                text = text_of(dtype, "jnp")
                config = JConfigMap(text=text)
                params = j_params(config)
                U0 = np.asarray(init_problem(params, config))
                name = f"{key}_{dtype}"
                out[name + "_U0"] = U0
                if key in INPUTS and dtype == "float64":
                    out[name + "_g"] = np.asarray(make_gravity_field(params, config))
                advance = make_advance_n(params, JConfigMap(text=text))
                U = make_boundaries(params, jnp.asarray(U0))
                t = jnp.asarray(0.0, U.dtype)
                ts = []
                for _ in range(N_STEPS):
                    U, t, _k = advance(U, t, jnp.array(1, jnp.int32))
                    ts.append(float(t))
                out[name + "_U"], out[name + "_t"] = np.asarray(U), np.asarray(ts)
    return out


_JAX_SCRIPT = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import numpy as np
sys.path.insert(0, sys.argv[1])
import test_torch_gravity as m
np.savez(sys.argv[2], **m.jax_references())
"""


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    """Every JAX reference of this file, from one subprocess."""
    out = tmp_path_factory.mktemp("jax_gravity") / "ref.npz"
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    # a quick, single-threaded backend: the suite's other workers share the
    # cores; without XLA's CPU fusion emitters the per-op compiles take 24 s
    # of CPU instead of 34 (the arrays agree to rounding)
    flags = ("--xla_backend_optimization_level=0 --xla_cpu_multi_thread_eigen=false "
             "--xla_cpu_use_fusion_emitters=false")
    env["XLA_FLAGS"] = " ".join(f for f in (env.get("XLA_FLAGS"), flags) if f)
    res = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(REPO / "tests"), str(out)],
                         capture_output=True, text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return dict(np.load(out))


def port(text):
    config = ConfigMap(text=text)
    return params_from_config(config), config


def port_run(text, ref_U0):
    """The port's CPU make_advance_n from the JAX initial state (checked
    bitwise against the port's own): (U after N_STEPS, t after each step,
    params)."""
    from ramsesgpu_tpu_torch.problems import init_problem
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries
    from ramsesgpu_tpu_torch.solvers.step import make_advance_n

    params, config = port(text)
    U0 = init_problem(params, config)
    np.testing.assert_array_equal(U0, ref_U0)
    advance = make_advance_n(params, "cpu", config)
    U = make_boundaries(params, torch.from_numpy(U0))
    t = torch.zeros((), dtype=U.dtype)
    ts = []
    for _ in range(N_STEPS):
        U, t, k = advance(U, t, 1)
        assert int(k) == 1
        ts.append(float(t))
    return U.numpy(), np.asarray(ts), params


def check(key, dtype, kernel, jax_refs, whole=False):
    name = f"{key}_{dtype}"
    text = dict(cases())[key](dtype, kernel)
    U, ts, params = port_run(text, jax_refs[name + "_U0"])
    want, t_want = jax_refs[name + "_U"], jax_refs[name + "_t"]
    assert U.dtype == want.dtype == np.dtype(dtype) and np.isfinite(U).all()
    if dtype == "float64":
        np.testing.assert_allclose(ts, t_want, rtol=TOL_T, atol=0)
    g, dim = params.ghost_width, params.dim
    err = rel_l2(U, want) if whole else rel_l2(inner(U, g, dim), inner(want, g, dim))
    assert err <= (TOL if dtype == "float64" else TOL_F32), (key, kernel, err)
    return U, params


@pytest.mark.parametrize("key", list(INPUTS))
def test_gravity_inputs_match_jax(key, jax_refs):
    """Each gravity input at 32^2 (2D) or 12 x 10 x 16 (3D), 3 f64 steps of
    the port's loop (kernel=auto) against JAX make_advance_n (kernel=jnp);
    the field the run's step takes bitwise JAX make_gravity_field's."""
    from ramsesgpu_tpu_torch.convert import gravity_from_jax
    from ramsesgpu_tpu_torch.config.params import static_gravity
    from ramsesgpu_tpu_torch.problems import has_gravity_field
    from ramsesgpu_tpu_torch.solvers.step import make_gravity_field

    U, params = check(key, "float64", "auto", jax_refs)
    params, config = port(dict(cases())[key]("float64", "auto"))
    field = make_gravity_field(params, config)
    want = jax_refs[f"{key}_float64_g"]
    np.testing.assert_array_equal(field.numpy(), want)
    _, vec = gravity_from_jax(params, want, "cpu")
    assert vec == (static_gravity(params) if params.dim == 3 else None)
    if key == "kepler":
        assert has_gravity_field(params, config) and static_gravity(params) is None
    if params.mhd:  # the CT state's divB stays at rounding level
        assert div_b(U, params) <= 1e-10 * np.abs(U[5:5 + params.dim]).max() / params.dx


def div_b(U, params):
    """max |div B| over the interior cells of a ghosted MHD state, from the
    face fields of each cell's left and right faces."""
    g, dim = params.ghost_width, params.dim
    div = 0.0
    for d, h in enumerate((params.dx, params.dy, params.dz)[:dim]):
        B = U[5 + d]
        lo = [slice(g, -g)] * dim
        hi = list(lo)
        hi[dim - 1 - d] = slice(g + 1, B.shape[dim - 1 - d] - g + 1)
        div = div + (B[tuple(hi)] - B[tuple(lo)]) / h
    return float(np.abs(div).max())


@pytest.mark.parametrize("key", ["rt3", "rt3_mhd"])
def test_gravity_3d_zcarry_takes_the_same_kernels(key, jax_refs):
    """kernel=zcarry: the 3D gravity runs take the kernels of kernel=auto
    (the hydro step's gravity instance, the ghosted MHD step), against
    the same JAX reference."""
    check(key, "float64", "zcarry", jax_refs)


@pytest.mark.parametrize("key", F32)
def test_gravity_f32_budget(key, jax_refs):
    """f32: the port's run within TOL_F32 of JAX's f32 run."""
    check(key, "float32", "auto", jax_refs)


@pytest.mark.parametrize("key", list(DISSIP))
def test_dissipative_walls_and_jet_match_jax(key, jax_refs):
    """Walled Brio-Wu with nu and eta, the MHD jet with eta, 3 f64 steps:
    the ghosted step, the second fill and the ghosted dissipation against
    JAX's whole-array step, the whole ghosted array (the CT face layer
    n+g included: its resistive CT enters the next step's dt)."""
    check(key, "float64", "auto", jax_refs, whole=True)


def test_ghosted_dissipation_is_apply_dissipation_mhd():
    """The ghosted twin is the whole-array apply_dissipation_mhd (up to the
    order of the energy sums) and differs from the interior form by the
    CT range; its kernel wrapper writes the face layer's B only with eta."""
    from ramsesgpu_tpu_torch.kernels.dissip_step import dissip_step
    from ramsesgpu_tpu_torch.problems import init_problem
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries
    from ramsesgpu_tpu_torch.solvers.dissipation import (apply_dissipation_mhd,
                                                         mhd_dissipation_ghosted_update,
                                                         mhd_dissipation_interior_update)

    name, keys = DISSIP["walls"]
    params, config = port(ini(name, keys=keys))
    rng = np.random.default_rng(5)
    U0 = init_problem(params, config)
    U = make_boundaries(params, torch.from_numpy(U0 * (1 + 0.05 * rng.standard_normal(U0.shape))))
    dt = torch.tensor(1e-3, dtype=U.dtype)
    got = mhd_dissipation_ghosted_update(params, U, dt)
    want = apply_dissipation_mhd(params, U, dt)
    assert rel_l2(got.numpy(), want.numpy()) <= TOL
    g = params.ghost_width
    assert rel_l2(inner(got.numpy(), g, 3),
                  mhd_dissipation_interior_update(params, U, dt).numpy()) > 1e-9
    W = U.clone()
    dissip_step.ghosted_(params, W, dt, torch.tensor(False))
    assert torch.equal(W, U)
    dissip_step.ghosted_(params, W, dt, torch.tensor(True))
    assert torch.equal(W, got)


def host_state(name, dtype, mesh, keys=None, seed=3):
    """A perturbed, filled initial state of data/<name>.ini at ``mesh``."""
    from ramsesgpu_tpu_torch.problems import init_problem
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries

    params, config = port(ini(name, dtype, keys=keys, mesh=mesh))
    U0 = init_problem(params, config)
    rng = np.random.default_rng(seed)
    U0 = (U0 * (1 + 0.02 * rng.standard_normal(U0.shape))).astype(U0.dtype)
    return params, make_boundaries(params, torch.from_numpy(U0))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_csrc_host_build_gravity_instances(dtype):
    """hydro_step.cu's gravity instance (interior mode with the z walls,
    ghosted mode) and mhd_step.cu's ghosted gravity instances (adiabatic,
    isothermal), built with g++, against the twins at 37 x 11 x 9 (partial
    x and y tiles of both kernels)."""
    from ramsesgpu_tpu_torch.kernels.build import load_library, param_block
    from ramsesgpu_tpu_torch.kernels.packed_bc import bc_codes
    from ramsesgpu_tpu_torch.solvers.boundary import interior
    from ramsesgpu_tpu_torch.solvers.godunov import gravity_vector, hydro_3d_state_update
    from ramsesgpu_tpu_torch.solvers.godunov_mhd import mhd_3d_ghosted_update

    lib = load_library("host")
    sfx = "f32" if dtype == "float32" else "f64"
    mesh = (37, 11, 9)
    params, U = host_state("rayleigh_taylor_gpu_3d", dtype, mesh)
    S = interior(params, U).contiguous()
    dims, blk = (params.nx, params.ny, params.nz), param_block(params)
    dt = torch.tensor(4e-3, dtype=S.dtype)
    grav = gravity_vector(params, S)
    assert grav is not None
    want = hydro_3d_state_update(params, S, dt, grav)
    assert rel_l2(want.numpy(), hydro_3d_state_update(params, S, dt).numpy()) > 1e-6
    step = getattr(lib, f"ramses_hydro_step_{sfx}")
    blocks = lib.ramses_hydro_step_blocks(int(dtype == "float64"))
    for ghosted, src in ((0, S), (1, U)):
        out = torch.zeros_like(S)
        for active in (False, True):
            flag = torch.tensor(active)
            assert step(src.data_ptr(), out.data_ptr(), blocks, dt.data_ptr(), flag.data_ptr(),
                        *dims, ghosted, bc_codes(params), blk, None, None) == 0
            if not active:
                assert torch.equal(out, S)
        assert rel_l2(out.numpy(), want.numpy()) <= TOL_HOST[dtype], ghosted

    step = getattr(lib, f"ramses_mhd_step_ghosted_{sfx}")
    for keys in (None, {"[hydro]": "cIso=0.3"}):
        params, U0 = host_state("rayleigh_taylor_gpu_3d_mhd", dtype, (17, 11, 9), keys)
        dims, g, blk = (params.nx, params.ny, params.nz), params.ghost_width, param_block(params)
        want = mhd_3d_ghosted_update(params, U0, dt, gravity_vector(params, U0))
        scratch = torch.empty(lib.ramses_mhd_step_ghosted_scratch(*dims, g), dtype=U0.dtype)
        U = U0.clone()
        for active in (False, True):
            flag = torch.tensor(active)
            assert step(U.data_ptr(), scratch.data_ptr(), dt.data_ptr(), flag.data_ptr(), *dims,
                        g, blk, None) == 0
            if not active:
                assert torch.equal(U, U0)
        assert rel_l2(U.numpy(), want.numpy()) <= TOL_HOST[dtype], keys


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_csrc_host_build_dissip_ghosted(dtype):
    """dissip_step.cu's ghosted mode, built with g++, against the twin on a
    perturbed walled Brio-Wu state at 17 x 11 x 9 (partial tiles; one z
    chunk ends at the top face): nu and eta (adiabatic), eta alone
    (isothermal), nu alone; the interior, and B of the face layer with
    eta."""
    from ramsesgpu_tpu_torch.kernels.build import load_library, param_block
    from ramsesgpu_tpu_torch.solvers.dissipation import mhd_dissipation_ghosted_update

    lib = load_library("host")
    fn = getattr(lib, f"ramses_dissip_step_ghosted_{'f32' if dtype == 'float32' else 'f64'}")
    for keys in ({"[hydro]": "nu=2e-3", "[MHD]": "eta=2e-3"},
                 {"[hydro]": "cIso=0.7", "[MHD]": "eta=2e-3"}, {"[hydro]": "nu=2e-3"}):
        params, U = host_state("testRiemannHLLD", dtype, (17, 11, 9), keys)
        g, nx, ny, nz = params.ghost_width, params.nx, params.ny, params.nz
        dt = torch.tensor(2e-3, dtype=U.dtype)
        want = mhd_dissipation_ghosted_update(params, U, dt)
        out = torch.zeros((8, nz + 1, ny + 1, nx + 1), dtype=U.dtype)
        for active in (False, True):
            flag = torch.tensor(active)
            assert fn(U.data_ptr(), out.data_ptr(), dt.data_ptr(), flag.data_ptr(), nx, ny, nz, g,
                      param_block(params), None) == 0
            if not active:
                assert torch.equal(out, U[:, g:g + nz + 1, g:g + ny + 1, g:g + nx + 1])
        cube = want[:, g:g + nz + 1, g:g + ny + 1, g:g + nx + 1]
        got = out[:, :nz, :ny, :nx]
        assert rel_l2(got.numpy(), cube[:, :nz, :ny, :nx].numpy()) <= TOL_HOST[dtype], keys
        if params.eta > 0:
            assert rel_l2(out[5:].numpy(), cube[5:].numpy()) <= TOL_HOST[dtype], keys


@pytest.mark.parametrize("kind", ["hydro", "mhd", "window", "dissip"])
def test_ghosted_reads_are_the_twins_support(kind):
    """chip_smoke.py ghosted_reads, the values a ghosted step must read
    (its bounds' bytes), is the support of the plain twin's gradient at 6 x
    7 x 5 (the union over seeded random states): the hydro step's, the MHD
    step's and the MRI's shear window's in rho (each cell whose rho is read
    is read in every channel), the dissipation's (nu and eta, adiabatic) in
    all channels. A gradient's support holds no value the function does
    not read."""
    import importlib.util

    from ramsesgpu_tpu_torch.solvers.dissipation import mhd_dissipation_ghosted_update
    from ramsesgpu_tpu_torch.solvers.godunov import hydro_3d_interior_update
    from ramsesgpu_tpu_torch.solvers.godunov_mhd import (mhd_3d_ghosted_update,
                                                         mhd_3d_shear_window_update)

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    mesh = nx, ny, nz = (6, 7, 5)
    name, keys, seeds = {"hydro": ("rayleigh_taylor_gpu_3d", None, 8),
                         "mhd": ("rayleigh_taylor_gpu_3d_mhd", None, 2),
                         "window": ("mhd_mri_3d", None, 2),
                         "dissip": (DISSIP["walls"][0], DISSIP["walls"][1], 2)}[kind]
    params, U = host_state(name, "float64", mesh, keys)
    g, dt = params.ghost_width, torch.tensor(2e-3, dtype=torch.float64)
    fn = {"hydro": lambda V: hydro_3d_interior_update(params, V, dt),
          "mhd": lambda V: mhd_3d_ghosted_update(params, V, dt),
          "window": lambda V: torch.cat([t.flatten() for t in
                                         mhd_3d_shear_window_update(params, V, dt, 0.3)]),
          "dissip": lambda V: mhd_dissipation_ghosted_update(params, V, dt)}[kind]
    support = torch.zeros(U.shape, dtype=torch.bool)
    for seed in range(seeds):
        rng = np.random.default_rng(seed)
        V = U + 0.05 * torch.from_numpy(rng.standard_normal(U.shape))
        V[0], V[1] = V[0].abs() + 0.5, V[1].abs() + 3.0
        V.requires_grad_(True)
        out = fn(V)
        written = torch.ones(out.shape, dtype=torch.bool)
        if kind in ("mhd", "dissip"):  # the interior, and B on the CT cube 0 .. n
            written = torch.zeros(out.shape, dtype=torch.bool)
            written[:, g:g + nz, g:g + ny, g:g + nx] = True
            written[5:, g:g + nz + 1, g:g + ny + 1, g:g + nx + 1] = True
        (out * torch.from_numpy(rng.standard_normal(out.shape)) * written).sum().backward()
        support |= V.grad != 0
    if kind == "dissip":
        assert int(support.sum()) == smoke.ghosted_reads("dissip", mesh, True, True, False)
    else:
        assert int(support[0].sum()) * U.shape[0] == smoke.ghosted_reads(kind, mesh)


@pytest.mark.parametrize("key", list(INPUTS))
def test_inputs_run_as_shipped_through_the_cli(key, tmp_path, monkeypatch):
    """Each gravity input as shipped (its mesh, solver, faces and field),
    one step through the CLI's main() on the CPU: finite, rho > 0."""
    from ramsesgpu_tpu_torch.cli import main as cli
    from ramsesgpu_tpu_torch.solvers import run as run_mod

    states = []
    real = run_mod.Run.start

    def start(self, *a, **k):
        res = real(self, *a, **k)
        states.append(self.U.cpu().numpy())
        return res

    monkeypatch.setattr(run_mod.Run, "start", start)
    monkeypatch.chdir(tmp_path)
    cli.main(["--param", str(REPO / "data" / f"{INPUTS[key]}.ini"), "--device", "cpu",
              "--max-steps", "1", "--no-output"])
    (U,) = states
    assert np.isfinite(U).all() and U[0].min() > 0
