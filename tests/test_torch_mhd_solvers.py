"""The MHD solvers other than HLLD (LLF and HLL faces; HLLA, HLLF and LLF
corners) in the port against the JAX package on the CPU.

- Per function (ops/riemann_mhd.py): ``_find_mhd_flux``,
  ``_find_speed_info``, ``riemann_llf_mhd``, ``riemann_hll_mhd``,
  ``mag_riemann2d_hll_family`` (HLLA and HLLF), ``mag_riemann2d_llf`` and
  ``compute_emf`` with each new corner solver on all three edge families
  (and, HLLA, with the shearing-box upwind term on the x and z families),
  adiabatic and isothermal, on inputs made with numpy from a seed: f32 rtol
  1e-5, f64 rtol 1e-12 (atol 1e-6 / 1e-12 of each output's largest
  magnitude). The JAX side runs each function under its own jit.
- The g++ host build (kernels/build.py ``build("host")``) of the step
  kernels' general instances (csrc/mhd_stages.cuh Mode with GEN): every
  (face, corner) pair but HLLD / 2D-HLLD on the periodic mode at 8^3, the
  streamed kernel (csrc/zcarry_mhd.cu) bitwise the staged one and both
  within TOL_HOST of the twin; one pair each on the ghosted, shear,
  stratified, shear window and streamed shear modes.
- The slices, f64, 3 steps, against JAX ``make_advance_n`` with
  kernel=jnp (op by op under ``jax.disable_jit()``): 3D Orszag-Tang at
  16^3 through the port's loop with kernel=auto and kernel=zcarry, and 2D
  Orszag-Tang at 32^2 (solvers/step2d.py), each for the pairs (hll, hlla),
  (llf, llf) and (hlld, hllf), which take each new solver at least once:
  equal step counts, t and the interior within relative 1e-12.
- The pairs neither package computes raise the JAX dispatchers' ValueError.

Every JAX reference comes from one subprocess (jax_enable_x64; float32
arrays stay float32).
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import test_torch_zcarry as zc

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
N_STEPS = 3
TOL = 1e-12
RTOL = {"float32": 1e-5, "float64": 1e-12}
ATOL_SCALE = {"float32": 1e-6, "float64": 1e-12}
TOL_HOST = {torch.float32: 1e-6, torch.float64: 1e-13}
# the slices' pairs: between them every new solver
PAIRS = [("hll", "hlla"), ("llf", "llf"), ("hlld", "hllf")]
FACES = ("hlld", "llf", "hll")
CORNERS = ("hlld", "hlla", "hllf", "llf")
ALL_PAIRS = [(f, c) for f in FACES for c in CORNERS if (f, c) != ("hlld", "hlld")]

OT3D_INI = """
[run]
tend=100.0
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
riemannSolver={face}
smallr=1e-7
smallc=1e-7
cIso={ciso}
[MHD]
enable=true
omega0={omega0}
magRiemannSolver={corner}
[implementation]
dtype={dtype}
kernel={kernel}
"""


def ot3d_text(face="hlld", corner="hlld", dtype="float64", kernel="auto", ciso=0.0,
              omega0=0.0) -> str:
    return OT3D_INI.format(face=face, corner=corner, dtype=dtype, kernel=kernel, ciso=ciso,
                           omega0=omega0)


def ot2d_text(face, corner) -> str:
    """data/orszag-tang.ini at 32^2, f64, with the solver pair."""
    text = (REPO / "data" / "orszag-tang.ini").read_text()
    for key, value in {"nx": 32, "ny": 32, "riemannSolver": face,
                       "magRiemannSolver": corner}.items():
        text, k = re.subn(rf"^\s*{key}\s*=.*$", f"{key}={value}", text, flags=re.M)
        assert k == 1, key
    return text + "\n[implementation]\ndtype=float64\n"


def with_solvers(params, face, corner):
    """The port's params with the (face, corner) solver pair (the INI's
    names)."""
    from ramsesgpu_tpu_torch.core.constants import MagneticRiemannSolver, RiemannSolver

    return params.replace(riemann_solver=RiemannSolver[face.upper()],
                          mag_riemann_solver=MagneticRiemannSolver[f"MAG_{corner.upper()}"])


# -------------------------------------------------------------------------
# per-function inputs and outputs (either package)
# -------------------------------------------------------------------------
N_FN = 64


def prim(rng, dtype, n=N_FN):
    """Primitive states [8, n]: rho, p > 0, velocities and field."""
    return np.concatenate([rng.uniform(0.5, 1.5, (2, n)),
                           0.5 * rng.standard_normal((6, n))]).astype(dtype)


def fn_inputs(dtype):
    rng = np.random.default_rng(19)
    return {"ql": prim(rng, dtype), "qr": prim(rng, dtype),
            "corners": [prim(rng, dtype) for _ in range(4)],
            "emfs": [(0.3 * rng.standard_normal(N_FN)).astype(dtype) for _ in range(4)],
            "edges": [prim(rng, dtype) for _ in range(4)],
            "xpos": rng.uniform(-0.5, 0.5, N_FN).astype(dtype)}


def function_outputs(package, dtype):
    """{name: [arrays]} of the new solvers of the JAX package ("jax", each
    function under its own jit) or the port ("port") on the same inputs."""
    if package == "jax":
        import jax
        import jax.numpy as jnp
        from ramsesgpu_tpu.config.configmap import ConfigMap
        from ramsesgpu_tpu.config.params import params_from_config
        from ramsesgpu_tpu.ops import riemann_mhd as rm
        array, back = jnp.asarray, np.asarray

        def run(f, *args):
            return jax.jit(f)(*args)
    else:
        from ramsesgpu_tpu_torch.config.configmap import ConfigMap
        from ramsesgpu_tpu_torch.config.params import params_from_config
        from ramsesgpu_tpu_torch.ops import riemann_mhd as rm
        array, back = torch.from_numpy, (lambda a: a.numpy())

        def run(f, *args):
            return f(*args)

    x = fn_inputs(dtype)
    ql, qr = array(x["ql"]), array(x["qr"])
    corners = [array(q) for q in x["corners"]]
    emfs = [array(e) for e in x["emfs"]]
    edges = [array(q) for q in x["edges"]]
    xpos = array(x["xpos"])
    out = {}
    for eos, ciso in (("adiabatic", 0.0), ("isothermal", 0.7)):
        params = params_from_config(ConfigMap(text=ot3d_text(dtype=dtype, ciso=ciso)))
        out[f"find_mhd_flux {eos}"] = [back(a) for a in run(
            lambda q: rm._find_mhd_flux(params, q), ql)]
        out[f"find_speed_info {eos}"] = [back(run(lambda q: rm._find_speed_info(params, q), ql))]
        out[f"riemann_llf_mhd {eos}"] = [back(run(
            lambda a, b: rm.riemann_llf_mhd(params, a, b), ql, qr))]
        out[f"riemann_hll_mhd {eos}"] = [back(run(
            lambda a, b: rm.riemann_hll_mhd(params, a, b), ql, qr))]
        for form, fast in (("hlla", False), ("hllf", True)):
            out[f"mag_riemann2d_{form} {eos}"] = [back(run(
                lambda *a, fast=fast: rm.mag_riemann2d_hll_family(params, *a, use_fast=fast),
                *corners, *emfs))]
        out[f"mag_riemann2d_llf {eos}"] = [back(run(
            lambda *a: rm.mag_riemann2d_llf(params, *a), *corners, *emfs))]
    # compute_emf: each new corner solver on the three edge families (the
    # rotation of the corner states), and HLLA in the rotating frame with
    # the shearing-box upwind term on the x and z families
    cases = [(c, 0.0, d) for c in ("hlla", "hllf", "llf") for d in ("x", "y", "z")]
    for corner, omega0, d in cases + [("hlla", 1.3, "x"), ("hlla", 1.3, "z")]:
        params = params_from_config(ConfigMap(text=ot3d_text(corner=corner, dtype=dtype,
                                                             omega0=omega0)))
        pos = None if omega0 == 0.0 else xpos
        out[f"compute_emf {corner} {d} omega0={omega0}"] = [back(run(
            lambda *q, d=d, pos=pos: rm.compute_emf(params, *q, d, xpos=pos), *edges))]
    return out


# -------------------------------------------------------------------------
# the JAX references
# -------------------------------------------------------------------------
def jax_runs():
    """The JAX whole-array runs of the slices, op by op, f64: {key: array}
    with the initial ghosted state, the final one, t and the step count of
    3D and 2D Orszag-Tang for each pair."""
    import jax
    import jax.numpy as jnp
    from ramsesgpu_tpu.config.configmap import ConfigMap
    from ramsesgpu_tpu.config.params import params_from_config
    from ramsesgpu_tpu.problems import init_problem
    from ramsesgpu_tpu.solvers.boundary import make_boundaries
    from ramsesgpu_tpu.solvers.step import make_advance_n

    out = {}
    for dim, text_of in (("3d", lambda f, c: ot3d_text(f, c, kernel="jnp")), ("2d", ot2d_text)):
        for face, corner in PAIRS:
            config = ConfigMap(text=text_of(face, corner))
            params = params_from_config(config)
            U = make_boundaries(params, jnp.asarray(init_problem(params, config), jnp.float64))
            key = f"{dim}_{face}_{corner}"
            out[key + "_U0"] = np.asarray(U)
            with jax.disable_jit():
                U, t, k = make_advance_n(params, config)(
                    U, jnp.asarray(0.0, jnp.float64), jnp.array(N_STEPS, jnp.int32))
            out[key + "_U"], out[key + "_t"], out[key + "_k"] = np.asarray(U), float(t), int(k)
    return out


_JAX_SCRIPT = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import numpy as np
sys.path.insert(0, sys.argv[1])
import test_torch_mhd_solvers as m
out = {f"run_{k}": v for k, v in m.jax_runs().items()}
for dtype in ("float32", "float64"):
    for name, arrays in m.function_outputs("jax", dtype).items():
        for j, a in enumerate(arrays):
            out[f"fn_{name}_{dtype}_{j}"] = a
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module", autouse=True)
def jax_refs(tmp_path_factory):
    """The JAX references in one subprocess, started at the module's first
    test; ``jax_refs()`` waits for it."""
    out = tmp_path_factory.mktemp("jax_solvers") / "refs.npz"
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    flags = ("--xla_backend_optimization_level=0 --xla_cpu_multi_thread_eigen=false "
             "--xla_cpu_use_fusion_emitters=false")
    env["XLA_FLAGS"] = " ".join(f for f in (env.get("XLA_FLAGS"), flags) if f)
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_SCRIPT, str(REPO / "tests"), str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    refs: dict = {}

    def get() -> dict:
        if not refs:
            _stdout, stderr = proc.communicate(timeout=600)
            assert proc.returncode == 0, stderr[-4000:]
            refs.update(np.load(out))
        return refs

    yield get
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm((a - b).ravel()) / np.linalg.norm(b.ravel()))


# -------------------------------------------------------------------------
# per function
# -------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_functions_match_jax(dtype, jax_refs):
    refs = jax_refs()
    got = function_outputs("port", dtype)
    assert {k.rsplit("_", 2)[0][3:] for k in refs if k.startswith("fn_")} == set(got)
    for name, arrays in got.items():
        for j, a in enumerate(arrays):
            want = refs[f"fn_{name}_{dtype}_{j}"]
            assert a.shape == want.shape and a.dtype == want.dtype, name
            atol = ATOL_SCALE[dtype] * max(float(np.abs(want).max()), 1e-30)
            np.testing.assert_allclose(a, want, rtol=RTOL[dtype], atol=atol,
                                       err_msg=f"{name} output {j}")


def test_unsupported_solvers_raise_the_jax_value_error():
    """approx and HLLC faces, the ROE and UPWIND corners: the dispatchers'
    ValueError (JAX riemann_mhd.py:266, :524), from the twins and, before any
    launch, from the step kernels' scope; every other pair is in it."""
    from ramsesgpu_tpu_torch.config.configmap import ConfigMap
    from ramsesgpu_tpu_torch.config.params import params_from_config
    from ramsesgpu_tpu_torch.kernels.fused_mhd3d import packed_supported
    from ramsesgpu_tpu_torch.kernels.mhd_step import require_step_scope, require_window_scope
    from ramsesgpu_tpu_torch.ops.riemann_mhd import mag_riemann2d, riemann_mhd
    from ramsesgpu_tpu_torch.solvers.step2d import require_2d_scope

    q = torch.from_numpy(prim(np.random.default_rng(3), "float64", 4))
    for face, corner in [("approx", "hlld"), ("hllc", "hlld"), ("hlld", "roe"),
                         ("hlld", "upwind")]:
        params = params_from_config(ConfigMap(text=ot3d_text(face, corner)))
        with pytest.raises(ValueError, match="unsupported"):
            require_step_scope(params)
        with pytest.raises(ValueError, match="unsupported"):
            require_window_scope(params.replace(omega0=1.0))
        assert not packed_supported(params)
        if corner == "hlld":
            with pytest.raises(ValueError, match="unsupported MHD Riemann solver"):
                riemann_mhd(params, q, q)
        else:
            with pytest.raises(ValueError, match="unsupported magnetic Riemann solver"):
                mag_riemann2d(params, q, q, q, q, q[0], q[0], q[0], q[0])
    for face, corner in ALL_PAIRS:
        params = params_from_config(ConfigMap(text=ot3d_text(face, corner)))
        require_step_scope(params)
        assert params.replace(nz=1).dim == 2
        require_2d_scope(params.replace(nz=1))


# -------------------------------------------------------------------------
# the slices
# -------------------------------------------------------------------------
def check_slice(refs, key, U, t, k, g=3):
    assert k == int(refs[key + "_k"]) == N_STEPS
    np.testing.assert_allclose(t, float(refs[key + "_t"]), rtol=TOL)
    want = refs[key + "_U"]
    inner = (slice(None),) + (slice(g, -g),) * (want.ndim - 1)
    got = U[inner]
    assert np.isfinite(got).all()
    assert rel_l2(got, want[inner]) <= TOL, key


@pytest.mark.parametrize("kernel", ["auto", "zcarry"])
@pytest.mark.parametrize("face, corner", PAIRS)
def test_3d_slice_matches_jax(face, corner, kernel, jax_refs):
    """3D Orszag-Tang at 16^3, f64, 3 steps of the port's loop (kernel=auto:
    the staged step's wrappers; zcarry: the streamed step's, its folded CFL)
    against the JAX whole-array run."""
    from ramsesgpu_tpu_torch.config.configmap import ConfigMap
    from ramsesgpu_tpu_torch.config.params import params_from_config
    from ramsesgpu_tpu_torch.solvers.step import make_advance_n

    config = ConfigMap(text=ot3d_text(face, corner, kernel=kernel))
    params = params_from_config(config)
    refs = jax_refs()
    key = f"run_3d_{face}_{corner}"
    U0 = torch.from_numpy(refs[key + "_U0"])
    U, t, k = make_advance_n(params, "cpu", config)(U0, torch.zeros((), dtype=U0.dtype), N_STEPS)
    check_slice(refs, key, U.numpy(), float(t), int(k))


@pytest.mark.parametrize("face, corner", PAIRS)
def test_2d_slice_matches_jax(face, corner, jax_refs):
    """2D Orszag-Tang at 32^2, f64, 3 steps of the port's whole-array loop
    (solvers/step2d.py), refused before this slice, against the JAX run."""
    from ramsesgpu_tpu_torch.config.configmap import ConfigMap
    from ramsesgpu_tpu_torch.config.params import params_from_config
    from ramsesgpu_tpu_torch.solvers.step import make_advance_n

    config = ConfigMap(text=ot2d_text(face, corner))
    params = params_from_config(config)
    assert params.dim == 2
    refs = jax_refs()
    key = f"run_2d_{face}_{corner}"
    U0 = torch.from_numpy(refs[key + "_U0"])
    U, t, k = make_advance_n(params, "cpu", config)(U0, torch.zeros((), dtype=U0.dtype), N_STEPS)
    # (the CT face layer n+g of the MHD state is the whole-array step's too)
    check_slice(refs, key, U.numpy(), float(t), int(k))


# -------------------------------------------------------------------------
# the CUDA sources' general instances (g++ host build)
# -------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_host_build_periodic_every_pair(dtype):
    """csrc/mhd_step.cu's and csrc/zcarry_mhd.cu's periodic mode for every
    new solver pair at 8^3, plain: the streamed kernel bitwise the staged
    one (the same stages), both within TOL_HOST of the twin
    (mhd_3d_periodic_update), the folded inverse dt bitwise the CFL
    kernel's; an inactive step copies its input (tests/test_torch_zcarry.py
    check_host_periodic)."""
    lib = zc.host_lib()
    params, S = zc.ot_state(dtype, 8, 8, 8, False)
    for face, corner in ALL_PAIRS:
        p = with_solvers(params, face, corner)
        zc.check_host_periodic(lib, p, S, False, 3)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_host_build_compensated_isothermal_pair(dtype):
    """The periodic mode's compensated update and isothermal instance with
    the general solvers: (llf, hllf) on isothermal Orszag-Tang with a Kahan
    carry, staged and streamed."""
    lib = zc.host_lib()
    params, S = zc.ot_state(dtype, 10, 6, 5, True)
    params = with_solvers(params.replace(c_iso=0.7), "llf", "hllf")
    zc.check_host_periodic(lib, params, S, True, 3)


@pytest.mark.parametrize("mode, face, corner", [("isothermal", "hll", "llf"),
                                                ("adiabatic", "llf", "hlla"),
                                                ("stratified", "hll", "hllf")])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_host_build_shear_modes(dtype, mode, face, corner):
    """The shearing-box modes (compensated) with one pair each: the staged
    and the streamed kernel bitwise alike, within TOL_HOST of the twin
    (mhd_3d_shear_update), state and x-face planes."""
    lib = zc.host_lib()
    params, S, _kept, slabs, zslabs, gz, dt = zc.shear_state(dtype, mode, (12, 10, 5))
    zc.check_host_shear(lib, with_solvers(params, face, corner), S, slabs, zslabs, gz, dt, 3)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_host_build_ghosted_mode(dtype):
    """csrc/mhd_step.cu's ghosted mode (walls: NEUMANN x faces, DIRICHLET y,
    periodic z) with (hll, hllf), updated in place: the interior and the CT
    face layer n+g within TOL_HOST of the twin (mhd_3d_ghosted_update)."""
    from ramsesgpu_tpu_torch.config.configmap import ConfigMap
    from ramsesgpu_tpu_torch.config.params import params_from_config
    from ramsesgpu_tpu_torch.kernels.build import param_block
    from ramsesgpu_tpu_torch.problems import init_problem
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries
    from ramsesgpu_tpu_torch.solvers.godunov_mhd import mhd_3d_ghosted_update
    from ramsesgpu_tpu_torch.solvers.timestep import dt_from_inv, inv_dt_ghosted

    lib = zc.host_lib()
    tdt = zc.TORCH_DTYPE[dtype]
    text = ot3d_text("hll", "hllf", dtype)
    for key, value in (("nx", 9), ("ny", 7), ("nz", 6), ("boundary_xmin", 2),
                       ("boundary_xmax", 2), ("boundary_ymin", 1), ("boundary_ymax", 1)):
        text = re.sub(rf"^{key}=.*$", f"{key}={value}", text, flags=re.M)
    config = ConfigMap(text=text)
    params = params_from_config(config)
    U0 = make_boundaries(params, zc.noisy(torch.from_numpy(init_problem(params, config)).to(tdt),
                                          5))
    dt = dt_from_inv(params, inv_dt_ghosted(params, U0))
    want = mhd_3d_ghosted_update(params, U0, dt, None)
    U = U0.clone()
    scratch = torch.empty(lib.ramses_mhd_step_ghosted_scratch(9, 7, 6, 3), dtype=tdt)
    sfx = "f32" if dtype == "float32" else "f64"
    assert getattr(lib, f"ramses_mhd_step_ghosted_{sfx}")(
        U.data_ptr(), scratch.data_ptr(), dt.data_ptr(), torch.tensor(True).data_ptr(), 9, 7, 6,
        3, param_block(params), None) == 0
    cube = (slice(None), slice(3, 10), slice(3, 11), slice(3, 13))
    assert zc.rel(U[cube], want[cube]) <= TOL_HOST[tdt]
    assert torch.equal(U[:, :3], U0[:, :3])   # the low z ghosts stay


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_host_build_window_mode(dtype):
    """csrc/mhd_step.cu's shear window mode (TPU row 4) with (llf, hlla) on
    the ghosted MRI box as one window (its ghosts the sheared fill's):
    the new interior and the five x-face planes within TOL_HOST of the
    twin (mhd_3d_shear_window_update)."""
    import test_torch_shear as shear
    from ramsesgpu_tpu_torch.config.configmap import ConfigMap
    from ramsesgpu_tpu_torch.config.params import params_from_config
    from ramsesgpu_tpu_torch.kernels.build import window_block
    from ramsesgpu_tpu_torch.problems import init_problem
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries
    from ramsesgpu_tpu_torch.solvers.godunov_mhd import mhd_3d_shear_window_update
    from ramsesgpu_tpu_torch.solvers.shear import make_all_boundaries_shear
    from ramsesgpu_tpu_torch.solvers.timestep import dt_from_inv, inv_dt_mhd_ghosted_shear

    lib = zc.host_lib()
    tdt = zc.TORCH_DTYPE[dtype]
    text = zc.with_mesh(shear.ini(dtype, coeffs=1.0), 10, 8, 6, old=(16, 32, 16))
    config = ConfigMap(text=text)
    params = with_solvers(params_from_config(config), "llf", "hlla")
    U = make_boundaries(params, torch.from_numpy(init_problem(params, config)).to(tdt))
    U = make_all_boundaries_shear(params, zc.noisy(U, 9), torch.tensor(0.3, dtype=tdt))
    dt = dt_from_inv(params, inv_dt_mhd_ghosted_shear(params, U))
    x0 = params.xmin
    want, want_planes = mhd_3d_shear_window_update(params, U, dt, x0, None)
    out, planes = torch.empty_like(want), torch.empty_like(want_planes)
    dims = (params.nx, params.ny, params.nz)
    scratch = torch.empty(lib.ramses_mhd_step_window_scratch(*dims), dtype=tdt)
    sfx = "f32" if dtype == "float32" else "f64"
    assert getattr(lib, f"ramses_mhd_step_window_{sfx}")(
        U.data_ptr(), out.data_ptr(), planes.data_ptr(), scratch.data_ptr(), None,
        dt.data_ptr(), torch.tensor(True).data_ptr(), *dims, 3, window_block(params, x0),
        None) == 0
    assert zc.rel(out, want) <= TOL_HOST[tdt]
    for p, q in zip(planes, want_planes):
        assert zc.rel(p, q) <= TOL_HOST[tdt]
