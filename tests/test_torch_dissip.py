"""The port's viscous and resistive sub-step of 3D MHD against the JAX
package on the CPU.

- Per function, inputs made with numpy from a seed: the twin of
  ramsesgpu_tpu/solvers/dissipation.py (viscosity fluxes, resistive EMF,
  CT, energy fluxes, ``apply_dissipation_mhd`` and the kernel's
  interior-only form with the xmax planes), adiabatic and isothermal, f32
  in process (rtol 1e-5, atol 1e-6 of each output's largest magnitude, as
  tests/test_torch_shear.py) and f64 from the JAX subprocess (rtol 1e-12).
- The slice: 3 steps of the port's loop against the JAX whole-array run
  (``make_advance_n`` with ``kernel=jnp``, op by op under
  ``jax.disable_jit()``; every reference in one subprocess with
  jax_enable_x64): periodic Orszag-Tang at 16^3 with (nu, eta) = (2e-3,
  1e-3), (0, 1e-3), (2e-3, 0) in f32 and (2e-3, 1e-3) in f64; the MRI at
  16x32x16 from a t0 whose shear offset is 2.5 cells, isothermal with the
  ini's coefficients (omega0 = cIso = 0.001, nu = 4e-5, eta = 1e-5),
  isothermal with omega0 = cIso = 1 and the JAX tests' (nu, eta), and
  adiabatic with eta > 0, in f32, the adiabatic box also in f64.
  Tolerances of tests/test_torch_shear.py's test_slice_matches_jax: t
  within rtol 1e-6 (f32) / 1e-12 (f64), interior and kept face within
  relative L2 2e-6 / 1e-11. The f64 Orszag-Tang run is held at 1e-11
  against the JAX run whose dissipative sub-step is the JAX kernel's
  interior form (the port's); against the whole-array form it differs by
  the resistive CT of one ghost layer (solvers/dissipation.py, PERF.md),
  bounded at TOL_FORMS.
- stripFused=yes gives bitwise the state of stripFused=no.
- The g++ host build of csrc/dissip_step.cu against the twin, both modes,
  holding the increment and the kept face's change each on its own.
- Mass and divB (with the kept face) of the dissipative runs; the
  configurations the port still refuses.
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
N_STEPS = 3
TOL_T = {"float32": 1e-6, "float64": 1e-12}
TOL_L2 = {"float32": 2e-6, "float64": 1e-11}
# the port (the JAX kernel's interior form) against the JAX whole-array
# form on the f64 Orszag-Tang run with eta > 0: the two forms differ by the
# resistive CT of one ghost layer in the energy flux, 5.8e-8 of the state
# after the 3 steps (PERF.md)
TOL_FORMS = 1e-7

OT_INI = """
[run]
tend={tend}
[mesh]
nx=16
ny=16
nz=16
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
nu={nu}
[MHD]
enable=true
magRiemannSolver=hlld
eta={eta}
[implementation]
dtype={dtype}
kernel={kernel}
"""

# tests/test_torch_shear.py's MRI box with viscosity and resistivity
MRI_INI = """
[run]
tend={tend}
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
cIso={ciso}
slope_type=2.0
riemannSolver=hlld
smallr=1e-8
smallc=1e-8
nu={nu}
[MHD]
enable=true
magRiemannSolver=hlld
omega0={omega0}
eta={eta}
[MRI]
density=1.0
beta=400.0
type=noflux
amp=0.2
seed=3
[implementation]
dtype={dtype}
kernel={kernel}
stripFused={strip}
"""
# (omega0, cIso, nu, eta) of the MRI runs; the adiabatic box starts from
# the isothermal box's state (with cIso = 0 the MRI init is a state at rest)
MRI_COEFFS = {"ini": (0.001, 0.001, 4e-5, 1e-5), "unit": (1.0, 1.0, 2e-3, 1e-3),
              "adiabatic": (1.0, 0.0, 2e-3, 1e-3)}
SLICES = [("ot", "float32", (2e-3, 1e-3)), ("ot", "float32", (0.0, 1e-3)),
          ("ot", "float32", (2e-3, 0.0)), ("ot", "float64", (2e-3, 1e-3)),
          ("mri", "float32", "ini"), ("mri", "float32", "unit"),
          ("mri", "float32", "adiabatic"), ("mri", "float64", "adiabatic")]
SLICE_IDS = [f"{p}-{d}-{c if isinstance(c, str) else 'nu%g-eta%g' % c}" for p, d, c in SLICES]


def forms_differ(problem, dtype, coeffs) -> bool:
    """Whether the JAX whole-array and interior forms differ beyond the f64
    tolerance here: the adiabatic Orszag-Tang run with eta > 0 (on the
    adiabatic MRI box, whose field is weak, they differ by 1.8e-12)."""
    return problem == "ot" and dtype == "float64" and coeffs[1] > 0


def ini(problem, dtype="float32", coeffs=(2e-3, 1e-3), kernel="auto", tend=1000.0,
        strip="auto", init=False):
    """The INI text of a run; ``init``: the configuration whose initial state
    the run starts from (the adiabatic MRI: the isothermal box's)."""
    if problem == "ot":
        nu, eta = coeffs
        return OT_INI.format(dtype=dtype, nu=nu, eta=eta, kernel=kernel, tend=tend)
    omega0, ciso, nu, eta = MRI_COEFFS[coeffs]
    if init and ciso == 0:
        ciso = 1.0
    return MRI_INI.format(dtype=dtype, omega0=omega0, ciso=ciso, nu=nu, eta=eta, kernel=kernel,
                          tend=tend, strip=strip)


def t_start(params) -> float:
    """0 (periodic), or a time whose sheared-fill offset deltay/dy is 2.5."""
    if params.omega0 == 0:
        return 0.0
    return 2.5 * params.dy / (1.5 * params.omega0 * params.dx * params.nx)


def setup(problem, dtype="float32", coeffs=(2e-3, 1e-3), **kw):
    """The port's params, config, t0 and ghosted initial state."""
    from ramsesgpu_tpu_torch.convert import torch_dtype
    from ramsesgpu_tpu_torch.problems import init_problem
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries
    from ramsesgpu_tpu_torch.solvers.shear import make_all_boundaries_shear

    config = ConfigMap(text=ini(problem, dtype, coeffs, **kw))
    params = params_from_config(config)
    init_config = ConfigMap(text=ini(problem, dtype, coeffs, init=True, **kw))
    U0 = torch.from_numpy(init_problem(params_from_config(init_config), init_config))
    U = make_boundaries(params, U0.to(torch_dtype(params)))
    t0 = torch.tensor(t_start(params), dtype=U.dtype)
    if problem == "mri":
        U = make_all_boundaries_shear(params, U, t0)
    return params, config, t0, U


def loop_state(params, U):
    """(interior, kept face) of a ghosted state, numpy (kept: the first
    xmax ghost column of Bx; for a periodic state, the wrap of column 0)."""
    g, nx = params.ghost_width, params.nx
    U = np.asarray(U)
    return U[:, g:-g, g:-g, g:g + nx], U[IA, g:-g, g:-g, nx + g]


def state_rel(a, b) -> float:
    num = sum(np.linalg.norm((x - y).ravel().astype(np.float64)) ** 2 for x, y in zip(a, b))
    den = sum(np.linalg.norm(y.ravel().astype(np.float64)) ** 2 for y in b)
    return float(np.sqrt(num / den))


# -------------------------------------------------------------------------
# the JAX references
# -------------------------------------------------------------------------
def jax_run(text, init_text, n_steps, interior_form=False):
    """The JAX whole-array run from the same initial state: (U0, U, t, k).
    ``interior_form``: the dissipative sub-step of each step is the JAX
    kernel's interior form (mhd_dissipation_interior_update, the kept
    face's resistive CT) instead of apply_dissipation_mhd."""
    import ramsesgpu_tpu.solvers.dissipation as jd
    from ramsesgpu_tpu.config.configmap import ConfigMap as JConfigMap
    from ramsesgpu_tpu.config.params import params_from_config as j_params
    from ramsesgpu_tpu.problems import init_problem
    from ramsesgpu_tpu.solvers.boundary import make_boundaries
    from ramsesgpu_tpu.solvers.shear import make_all_boundaries_shear
    from ramsesgpu_tpu.solvers.step import make_advance_n, uses_shear

    config = JConfigMap(text=text)
    params = j_params(config)
    init_config = JConfigMap(text=init_text)
    g, nx = params.ghost_width, params.nx
    whole_array = jd.apply_dissipation_mhd

    def interior(p, U, dt):
        new, eypl, ezpl = jd.mhd_dissipation_interior_update(p, U, dt, shear_planes=True)
        U = U.at[:, g:-g, g:-g, g:-g].set(new)
        if not uses_shear(p):
            return make_boundaries(p, U)
        if p.eta > 0:
            dkept = (dt / p.dy * (jnp.roll(ezpl, -1, 1) - ezpl)
                     - dt / p.dz * (jnp.roll(eypl, -1, 0) - eypl))
            U = U.at[IA, g:-g, g:-g, nx + g].add(dkept)
        return U

    jd.apply_dissipation_mhd = interior if interior_form else whole_array
    try:
        with jax.disable_jit():
            U = make_boundaries(params, jnp.asarray(
                init_problem(j_params(init_config), init_config), params.dtype))
            t0 = jnp.asarray(t_start(params), U.dtype)
            if uses_shear(params):
                U = make_all_boundaries_shear(params, U, t0)
            Uf, t, k = make_advance_n(params, config)(U, t0, jnp.array(n_steps, jnp.int32))
    finally:
        jd.apply_dissipation_mhd = whole_array
    return np.asarray(U), np.asarray(Uf), float(t), int(k)


def random_state(params, rng, dtype):
    """A ghosted conserved state, rho and p > 0, B of order one."""
    shape = params.shape[1:]
    rho = rng.uniform(0.5, 1.5, shape)
    vel = 0.5 * rng.standard_normal((3,) + shape)
    bf = 0.5 * rng.standard_normal((3,) + shape)
    e = rng.uniform(0.5, 1.5, shape) / (params.gamma0 - 1.0) + 0.5 * rho * (vel ** 2).sum(0) \
        + 0.5 * (bf ** 2).sum(0)
    return np.stack([rho, e, *(rho * vel), *bf]).astype(dtype)


FUNCTIONS = ["viscosity_fluxes", "resistivity_emf", "resistivity_ct", "energy_fluxes",
             "apply_dissipation_mhd", "interior_update"]


def function_outputs(mod, params, U, dt):
    """The outputs of one dissipation function of module ``mod`` (the JAX
    package's or the port's) as a flat list, per name of FUNCTIONS."""
    def flat(fluxes):
        return [f for _axis, comp in sorted(fluxes.items()) for _slot, f in sorted(comp.items())]

    return {
        "viscosity_fluxes": lambda: flat(mod.compute_viscosity_fluxes(params, U, dt)),
        "resistivity_emf": lambda: list(mod.compute_resistivity_emf(params, U)),
        "resistivity_ct": lambda: [mod.apply_resistivity_ct(params, U, dt)],
        "energy_fluxes": lambda: flat(mod.compute_resistivity_energy_fluxes(params, U, dt)),
        "apply_dissipation_mhd": lambda: [mod.apply_dissipation_mhd(params, U, dt)],
        "interior_update": lambda: list(
            mod.mhd_dissipation_interior_update(params, U, dt, shear_planes=True)),
    }


def function_inputs(ciso, dtype):
    """The JAX params, a random ghosted state and dt of the per-function
    tests (the MRI box's mesh, adiabatic or isothermal)."""
    from ramsesgpu_tpu.config.configmap import ConfigMap as JConfigMap
    from ramsesgpu_tpu.config.params import params_from_config as j_params

    params = j_params(JConfigMap(text=ini("mri", dtype, "unit"))).replace(c_iso=ciso)
    U = random_state(params, np.random.default_rng(11), dtype)
    return params, U, np.asarray(0.01, dtype)


_JAX_SCRIPT = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
sys.path.insert(0, sys.argv[1])
import ramsesgpu_tpu.solvers.dissipation as jd
import test_torch_dissip as m
out = {}
for i, (problem, dtype, coeffs) in enumerate(m.SLICES):
    text = m.ini(problem, dtype, coeffs, kernel="jnp")
    init_text = m.ini(problem, dtype, coeffs, kernel="jnp", init=True)
    out[f"{i}_U0"], out[f"{i}_U"], out[f"{i}_t"], out[f"{i}_k"] = m.jax_run(
        text, init_text, m.N_STEPS)
    if m.forms_differ(problem, dtype, coeffs):
        _U0, out[f"{i}_Ui"], out[f"{i}_ti"], _k = m.jax_run(text, init_text, m.N_STEPS,
                                                           interior_form=True)
for ciso in (0.0, 1.0):
    params, U, dt = m.function_inputs(ciso, "float64")
    with jax.disable_jit():
        funcs = m.function_outputs(jd, params, jnp.asarray(U), jnp.asarray(dt))
        for name, fn in funcs.items():
            for j, a in enumerate(fn()):
                out[f"fn_{name}_{ciso}_{j}"] = np.asarray(a)
np.savez(sys.argv[2], **out)
"""
@pytest.fixture(scope="module", autouse=True)
def jax_refs(tmp_path_factory):
    """The JAX package's runs and f64 function outputs, all in one
    subprocess started at the module's first test, so the tests that need
    no reference run meanwhile; ``jax_refs()`` waits for it and returns its
    outputs."""
    out = tmp_path_factory.mktemp("jax_dissip") / "refs.npz"
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    # a quick, single-threaded backend: the suite's other workers share the cores
    flags = "--xla_backend_optimization_level=0 --xla_cpu_multi_thread_eigen=false"
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


_port_runs: dict = {}


def port_run(problem, dtype, coeffs, n_steps=N_STEPS, **kw):
    """(params, U0, U, t, k) of the port's loop on the CPU, memoised."""
    from ramsesgpu_tpu_torch.solvers.step import make_advance_n

    key = (problem, dtype, coeffs, n_steps, tuple(sorted(kw.items())))
    if key not in _port_runs:
        params, config, t0, U0 = setup(problem, dtype, coeffs, **kw)
        U, t, k = make_advance_n(params, "cpu", config)(U0.clone(), t0.clone(), n_steps)
        _port_runs[key] = (params, U0, U, float(t), int(k))
    return _port_runs[key]


# -------------------------------------------------------------------------
# per-function parity
# -------------------------------------------------------------------------
RTOL, ATOL_SCALE = 1e-5, 1e-6


def assert_close(got, want, label, rtol=RTOL, atol_scale=ATOL_SCALE):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, label
    atol = atol_scale * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=label)


@pytest.mark.parametrize("ciso", [0.0, 1.0])
@pytest.mark.parametrize("name", FUNCTIONS)
def test_function_f32_matches_jax(name, ciso):
    import ramsesgpu_tpu.solvers.dissipation as jd
    import ramsesgpu_tpu_torch.solvers.dissipation as td

    params, U, dt = function_inputs(ciso, "float32")
    want = function_outputs(jd, params, jnp.asarray(U), jnp.asarray(dt))[name]()
    got = function_outputs(td, params, torch.from_numpy(U), torch.from_numpy(dt))[name]()
    assert len(got) == len(want) > 0
    for j, (a, b) in enumerate(zip(got, want)):
        assert_close(a.numpy(), b, f"{name} cIso={ciso} output {j}")


def test_interior_forms_equal_the_ghosted_form():
    """The twin's periodic and shear forms equal the interior update of the
    filled ghosted state bitwise (rolls are permutations)."""
    from ramsesgpu_tpu_torch.solvers.boundary import interior
    from ramsesgpu_tpu_torch.solvers.dissipation import (mhd_dissipation_interior_update,
                                                          mhd_dissipation_periodic_update,
                                                          mhd_dissipation_shear_update)
    from ramsesgpu_tpu_torch.solvers.shear import _shear_ghost_slabs

    dt = torch.tensor(0.01, dtype=torch.float64)
    params, _config, _t0, U = setup("ot", "float64")
    S = interior(params, U).contiguous()
    assert torch.equal(mhd_dissipation_periodic_update(params, S, dt),
                       mhd_dissipation_interior_update(params, U, dt))
    params, _config, t0, U = setup("mri", "float64", "adiabatic")
    S = interior(params, U).contiguous()
    got = mhd_dissipation_shear_update(params, S, _shear_ghost_slabs(params, U, t0), dt)
    want = mhd_dissipation_interior_update(params, U, dt, shear_planes=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# -------------------------------------------------------------------------
# the CUDA source's arithmetic (g++ host build) against the twin
# -------------------------------------------------------------------------
TOL_HOST = {"float32": 1e-6, "float64": 1e-13}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_csrc_host_build_matches_dissip_twins(dtype):
    """csrc/dissip_step.cu built with g++, both modes, adiabatic and
    isothermal (shear), each coefficient set: the increment of the state
    and the kept face's change each against the twin's, relative to its own
    norm; the inactive kernel changes nothing."""
    from ramsesgpu_tpu_torch.kernels.build import load_library, param_block
    from ramsesgpu_tpu_torch.solvers.boundary import interior
    from ramsesgpu_tpu_torch.solvers.dissipation import (kept_face_resistive_ct,
                                                          mhd_dissipation_periodic_update,
                                                          mhd_dissipation_shear_update)
    from ramsesgpu_tpu_torch.solvers.shear import shear_slabs

    lib = load_library("host")
    sfx = "f32" if dtype == "float32" else "f64"
    tdt = torch.float32 if dtype == "float32" else torch.float64
    rng = np.random.default_rng(12)

    def rel(a, b):
        return float(torch.linalg.norm((a - b).flatten()) / torch.linalg.norm(b.flatten()))

    dt = torch.tensor(0.01, dtype=tdt)
    for problem, ciso in (("ot", 0.0), ("mri", 1.0), ("mri", 0.0)):
        for nu, eta in ((2e-3, 1e-3), (0.0, 1e-3), (2e-3, 0.0)):
            coeffs = (2e-3, 1e-3) if problem == "ot" else "unit"
            params = params_from_config(ConfigMap(text=ini(problem, dtype, coeffs))).replace(
                nu=nu, eta=eta, c_iso=ciso)
            nx, ny, nz = params.nx, params.ny, params.nz
            dims, blk = (nx, ny, nz), param_block(params)
            U = torch.from_numpy(random_state(params, rng, dtype))
            S = interior(params, U).contiguous()
            kept = U[IA, 3:-3, 3:-3, nx + 3].contiguous()
            shear = problem == "mri"
            if shear:
                slabs = shear_slabs(params, S, kept, torch.tensor(t_start(params), dtype=tdt))
                want, eypl, ezpl = mhd_dissipation_shear_update(params, S, slabs, dt)
                kept_want = (kept_face_resistive_ct(params, kept, eypl, ezpl, dt) if eta > 0
                             else kept)
            else:
                want = mhd_dissipation_periodic_update(params, S, dt)
            fn = getattr(lib, f"ramses_dissip_step_{sfx}")
            label = f"{problem} cIso={ciso} nu={nu} eta={eta}"
            for active in (False, True):
                flag = torch.tensor(active)
                got, kept_got = torch.full_like(S, float("nan")), kept.clone()
                ptrs = ((slabs.data_ptr(), kept_got.data_ptr()) if shear else (None, None))
                assert fn(S.data_ptr(), got.data_ptr(), *ptrs, dt.data_ptr(),
                          flag.data_ptr(), 0, *dims, blk, None) == 0
                if not active:
                    assert torch.equal(got, S) and torch.equal(kept_got, kept), label
                    continue
                assert rel(got - S, want - S) <= TOL_HOST[dtype], label
                if shear and eta > 0:
                    assert rel(kept_got - kept, kept_want - kept) <= TOL_HOST[dtype], label
                else:
                    assert torch.equal(kept_got, kept), label


# shapes where csrc/dissip_step.cu's tiling meets trouble: no multiple of
# its x or y tile (f32 32 x 8, f64 16 x 8), and an axis shorter than its z
# halo of two planes (nz = 2; ny = 3)
EDGE_SHAPES = [(37, 11, 2), (21, 13, 5), (40, 3, 2)]


def mesh_ini(text: str, nx: int, ny: int, nz: int) -> str:
    """An INI text with its [mesh] extent set to nx x ny x nz (the cell
    sizes follow)."""
    import re

    for axis, n in (("nx", nx), ("ny", ny), ("nz", nz)):
        text = re.sub(rf"^{axis}=\d+$", f"{axis}={n}", text, count=1, flags=re.M)
    return text


@pytest.mark.parametrize("comp", [False, True], ids=["plain", "compensated"])
@pytest.mark.parametrize("mode", ["periodic", "shear"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_csrc_host_build_dissip_edge_tiles(dtype, mode, comp):
    """csrc/dissip_step.cu built with g++ on EDGE_SHAPES, adiabatic with nu
    and eta: the new state against the twin's (the increment within
    TOL_HOST; compensated, the state and carry bitwise, the code being
    FMA-free), the kept face's change likewise, S untouched; an inactive
    sub-step writes S itself into S_out, bitwise, and leaves the kept face."""
    from ramsesgpu_tpu_torch.kernels.build import load_library, param_block
    from ramsesgpu_tpu_torch.solvers.boundary import interior
    from ramsesgpu_tpu_torch.solvers.dissipation import (kept_face_resistive_ct,
                                                          mhd_dissipation_periodic_update,
                                                          mhd_dissipation_shear_update)
    from ramsesgpu_tpu_torch.solvers.shear import shear_slabs

    lib = load_library("host")
    tdt = torch.float32 if dtype == "float32" else torch.float64
    fn = getattr(lib, f"ramses_dissip_step_{'f32' if dtype == 'float32' else 'f64'}")
    rng = np.random.default_rng(21)
    dt = torch.tensor(0.01, dtype=tdt)
    shear = mode == "shear"

    def rel(a, b):
        return float(torch.linalg.norm((a - b).flatten()) / torch.linalg.norm(b.flatten()))

    for nx, ny, nz in EDGE_SHAPES:
        text = ini("mri", dtype, "adiabatic") if shear else ini("ot", dtype)
        params = params_from_config(ConfigMap(text=mesh_ini(text, nx, ny, nz))).replace(
            compensated=comp)
        U = torch.from_numpy(random_state(params, rng, dtype))
        S = interior(params, U).contiguous()
        kept = U[IA, 3:-3, 3:-3, nx + 3].contiguous()
        if comp:
            eps = torch.finfo(tdt).eps
            S = torch.cat([S, eps * S * torch.from_numpy(rng.standard_normal(S.shape)).to(tdt)])
            kept = torch.stack([kept, eps * kept * torch.from_numpy(
                rng.standard_normal(kept.shape)).to(tdt)])
        face = kept[0] if comp else kept
        if shear:
            slabs = shear_slabs(params, S[:8], face, torch.tensor(t_start(params), dtype=tdt))
            want, eypl, ezpl = mhd_dissipation_shear_update(params, S, slabs, dt)
            old = torch.stack([slabs[1, IA, ..., 0], kept[1]]) if comp else slabs[1, IA, ..., 0]
            kept_want = kept_face_resistive_ct(params, old, eypl, ezpl, dt)
        else:
            want = mhd_dissipation_periodic_update(params, S, dt)
        label = f"{mode} {dtype} {nx}x{ny}x{nz}"
        S_in = S.clone()
        for active in (True, False):
            got, kept_got = torch.full_like(S, float("nan")), kept.clone()
            ptrs = (slabs.data_ptr(), kept_got.data_ptr()) if shear else (None, None)
            assert fn(S.data_ptr(), got.data_ptr(), *ptrs, dt.data_ptr(),
                      torch.tensor(active).data_ptr(), int(comp), nx, ny, nz,
                      param_block(params), None) == 0
            assert torch.equal(S, S_in), label
            if not active:
                assert torch.equal(got, S) and torch.equal(kept_got, kept), label
            elif comp:
                assert torch.equal(got, want), label
                if shear:
                    assert torch.equal(kept_got, kept_want), label
            else:
                assert rel(got - S, want - S) <= TOL_HOST[dtype], label
                if shear:
                    assert rel(kept_got - kept, kept_want - kept) <= TOL_HOST[dtype], label


# -------------------------------------------------------------------------
# what the port refuses
# -------------------------------------------------------------------------
@pytest.mark.parametrize(
    "case",
    ["compensated", "stratified", "zcarry", "2d"],
)
def test_out_of_scope_dissipative_configurations_raise(case):
    from ramsesgpu_tpu_torch.solvers.dissipation import apply_dissipation_mhd
    from ramsesgpu_tpu_torch.solvers.run import Run
    from ramsesgpu_tpu_torch.solvers.step import make_advance_n

    text = ini("mri", coeffs="unit")
    if case == "compensated":
        # compensated dissipative runs are ported (tests/test_torch_compensated.py);
        # a compensated stratified one is not
        text = text.replace("boundary_zmin=3", "boundary_zmin=6").replace(
            "boundary_zmax=3", "boundary_zmax=6") + "\n[gravity]\nstatic=yes\n"
        text = text.replace("[implementation]\n", "[implementation]\ncompensated=yes\n")
    elif case == "stratified":
        text = text.replace("boundary_zmin=3", "boundary_zmin=6").replace(
            "boundary_zmax=3", "boundary_zmax=6") + "\n[gravity]\nstatic=yes\n"
    elif case == "zcarry":
        # dissipative zcarry runs are ported (tests/test_torch_zcarry.py); a
        # zcarry stratified one, like any stratified one with nu / eta, is not
        text = text.replace("kernel=auto", "kernel=zcarry")
        text = text.replace("boundary_zmin=3", "boundary_zmin=6").replace(
            "boundary_zmax=3", "boundary_zmax=6") + "\n[gravity]\nstatic=yes\n"
    else:
        text = ini("ot").replace("nz=16", "nz=1")
    config = ConfigMap(text=text)
    params = params_from_config(config)
    assert params.nu > 0 and params.eta > 0
    with pytest.raises(NotImplementedError):
        Run(config, "cpu")
    with pytest.raises(NotImplementedError):
        make_advance_n(params, "cpu", config)
    if case == "2d":
        U = torch.zeros(params.shape, dtype=torch.float32)
        with pytest.raises(NotImplementedError):
            apply_dissipation_mhd(params, U, torch.tensor(0.01))


def div_b(params, S, kept):
    bx, by, bz = S[IA], S[IB], S[IC]
    bx_r = np.concatenate([bx[..., 1:], kept[..., None]], axis=-1)
    return ((bx_r - bx) / params.dx + (np.roll(by, -1, -2) - by) / params.dy
            + (np.roll(bz, -1, -3) - bz) / params.dz)


@pytest.mark.parametrize("problem, dtype, coeffs", [("ot", "float64", (2e-3, 1e-3)),
                                                    ("mri", "float64", "adiabatic"),
                                                    ("mri", "float32", "unit")])
def test_mass_and_divb(problem, dtype, coeffs):
    """The dissipative sub-step moves no mass and keeps divB at rounding,
    the kept face included; the resistive CT changes the kept face."""
    params, U0, U, _t, k = port_run(problem, dtype, coeffs)
    assert k == N_STEPS
    S0, kept0 = (a.astype(np.float64) for a in loop_state(params, U0.numpy()))
    S, kept = (a.astype(np.float64) for a in loop_state(params, U.numpy()))
    eps = {"float32": 5e-9, "float64": 1e-14}[dtype]
    assert abs(S[ID].sum() - S0[ID].sum()) <= eps * S0[ID].sum()
    bound = {"float32": 1e-5, "float64": 1e-12}[dtype]
    div0 = np.abs(div_b(params, S0, kept0)).max()
    assert np.abs(div_b(params, S, kept)).max() <= div0 + bound * np.abs(S[IA:]).max() / params.dx
    if problem == "mri":
        assert not np.array_equal(kept, kept0)


# -------------------------------------------------------------------------
# the slice
# -------------------------------------------------------------------------
@pytest.mark.parametrize("ciso", [0.0, 1.0])
@pytest.mark.parametrize("name", FUNCTIONS)
def test_function_f64_matches_jax(name, ciso, jax_refs):
    import ramsesgpu_tpu_torch.solvers.dissipation as td

    params, U, dt = function_inputs(ciso, "float64")
    got = function_outputs(td, params, torch.from_numpy(U), torch.from_numpy(dt))[name]()
    jax_refs = jax_refs()
    for j, a in enumerate(got):
        assert_close(a.numpy(), jax_refs[f"fn_{name}_{ciso}_{j}"], f"{name} cIso={ciso} {j}",
                     rtol=1e-12, atol_scale=1e-13)
    assert f"fn_{name}_{ciso}_{len(got)}" not in jax_refs


@pytest.mark.parametrize("problem, dtype, coeffs", SLICES, ids=SLICE_IDS)
def test_slice_matches_jax(problem, dtype, coeffs, jax_refs):
    i = SLICES.index((problem, dtype, coeffs))
    params, U0, U, t, k = port_run(problem, dtype, coeffs)
    jax_refs = jax_refs()
    np.testing.assert_array_equal(U0.numpy(), jax_refs[f"{i}_U0"])  # the same start
    assert k == int(jax_refs[f"{i}_k"]) == N_STEPS
    assert U.dtype == (torch.float64 if dtype == "float64" else torch.float32)
    assert np.isfinite(U.numpy()).all()
    got = loop_state(params, U)
    t_wa = float(jax_refs[f"{i}_t"])
    whole_array = state_rel(got, loop_state(params, jax_refs[f"{i}_U"]))
    if forms_differ(problem, dtype, coeffs):
        t_ref = float(jax_refs[f"{i}_ti"])
        assert abs(t - t_ref) <= TOL_T[dtype] * abs(t_ref)
        assert state_rel(got, loop_state(params, jax_refs[f"{i}_Ui"])) <= TOL_L2[dtype]
        assert abs(t - t_wa) <= TOL_FORMS * abs(t_wa) and whole_array <= TOL_FORMS
    else:
        assert abs(t - t_wa) <= TOL_T[dtype] * abs(t_wa)
        assert whole_array <= TOL_L2[dtype]


ZCARRY_SLICES = [("ot", "float32", (2e-3, 1e-3)), ("mri", "float32", "ini")]


@pytest.mark.parametrize("problem, dtype, coeffs", ZCARRY_SLICES,
                         ids=[SLICE_IDS[SLICES.index(c)] for c in ZCARRY_SLICES])
def test_zcarry_slice_matches_jax(problem, dtype, coeffs, jax_refs):
    """kernel=zcarry (the streamed step into the other buffer, then the
    dissipation kernel on it, the CFL a launch of its own; its twins on
    the CPU) against the same JAX run: dissipative Orszag-Tang and the
    viscous-resistive MRI as the ini gives it."""
    i = SLICES.index((problem, dtype, coeffs))
    params, U0, U, t, k = port_run(problem, dtype, coeffs, kernel="zcarry")
    assert params.kernel == "zcarry" and not forms_differ(problem, dtype, coeffs)
    jax_refs = jax_refs()
    np.testing.assert_array_equal(U0.numpy(), jax_refs[f"{i}_U0"])  # the same start
    assert k == int(jax_refs[f"{i}_k"]) == N_STEPS
    assert np.isfinite(U.numpy()).all()
    t_ref = float(jax_refs[f"{i}_t"])
    assert abs(t - t_ref) <= TOL_T[dtype] * abs(t_ref)
    assert state_rel(loop_state(params, U), loop_state(params, jax_refs[f"{i}_U"])) <= TOL_L2[dtype]


@pytest.mark.parametrize("problem, coeffs", [("ot", (2e-3, 1e-3)), ("mri", "adiabatic")])
def test_step_fn_equals_one_loop_step(problem, coeffs):
    """make_step_fn (the ghosted-state step, where the JAX package runs its
    dissipation kernel, pallas/fused_dissip3d.py) takes the loop's step:
    bitwise the state one loop step gives, and its dt."""
    from ramsesgpu_tpu_torch.solvers.step import make_advance_n, make_step_fn

    params, config, t0, U0 = setup(problem, "float64", coeffs)
    U1, dt = make_step_fn(params, "cpu", config)(U0.clone(), t0.clone())
    U_loop, t_loop, k = make_advance_n(params, "cpu", config)(U0.clone(), t0.clone(), 1)
    assert int(k) == 1 and float(t0 + dt) == float(t_loop)
    assert torch.equal(U1, U_loop)


def test_strip_fused_yes_equals_no_bitwise(jax_refs):
    """stripFused=yes runs the same kernels as no (the port has no border
    strip): bitwise the same state, and both the JAX whole-array run's."""
    i = SLICES.index(("mri", "float32", "ini"))
    params, _U0, U_no, t_no, _ = port_run("mri", "float32", "ini", strip="no")
    params_yes, _U0, U_yes, t_yes, _ = port_run("mri", "float32", "ini", strip="yes")
    assert params_yes.strip_fused is True and params.strip_fused is False
    assert torch.equal(U_yes, U_no) and t_yes == t_no
    _, _, U_auto, _, _ = port_run("mri", "float32", "ini")
    assert torch.equal(U_auto, U_no)
    ref = loop_state(params, jax_refs()[f"{i}_U"])
    assert state_rel(loop_state(params, U_yes), ref) <= TOL_L2["float32"]
