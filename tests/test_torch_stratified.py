"""The port's stratified MRI (BC_Z_STRATIFIED z faces and the static
vertical gravity, data/mhd_mri_3d_stratified.ini) against the JAX package
on the CPU.

- Per function, inputs made with numpy from a seed:
  ``make_boundary_z_stratified`` (with and without the floor option),
  ``_stratified_ghost_slabs`` and ``mri_gravity_field``, f32 (rtol 1e-5,
  atol 1e-6 of each output's largest magnitude) and f64 (rtol 1e-12), both
  from the JAX subprocess.
- The slice: the shipped ini at 16x32x32 (its z extent and coefficients,
  compensated as shipped) through the port's loop, 3 steps from a t0 whose
  shear offset is 2.5 cells, against the JAX whole-array
  ``make_step_fn(kernel="jnp")`` (uncompensated: the whole-array path has no
  carry) in one subprocess (as the functions run by default: the same
  arrays bitwise as op by op under ``jax.disable_jit()``, at less compile
  time), at test_slice_matches_jax's tolerances (t rtol 1e-6, interior and
  kept face relative L2 2e-6).
- Mass accounting: each step's mass change equals the outflow through the
  z faces that the step's own z density fluxes give, and that outflow
  equals the JAX run's mass change of the same step.
- With viscosity and resistivity (nu 4e-5, eta 1e-5, the viscous-resistive
  MRI's of scripts/perf_table.py): the dissipative sub-step on the
  refilled box (the sheared x slabs and the stratified z slabs of that
  block, then the twin and the kept face's resistive CT) against JAX
  ``apply_dissipation_mhd`` on ``make_all_boundaries_shear``'s fill, per
  function as above; and the same slice as above with nu and eta, through
  the port's loop with kernel=auto and kernel=zcarry, plain and
  compensated, against the JAX whole-array run with nu and eta, at the
  slice's tolerances.
- The g++ host build of the stratified kernel modes against the twins
  (the dissipation kernel's stratified shear mode too).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ramsesgpu_tpu_torch.config.configmap import ConfigMap
from ramsesgpu_tpu_torch.config.params import params_from_config

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
N_STEPS = 3
TOL_T = 1e-6
TOL_L2 = 2e-6
# |mass change - z-face outflow| of one step, over the mass (f32 rounding)
TOL_MASS = 1e-8


# the viscous-resistive box's coefficients (scripts/perf_table.py:93-102)
NU, ETA = 4e-5, 1e-5


def strat_text(dtype="float32", nx=16, ny=32, nz=32, dissip=False) -> str:
    """data/mhd_mri_3d.ini's stratified sibling as shipped but for the mesh
    (same z extent, compensated, slope_type 3); ``dissip``: with nu NU and
    eta ETA."""
    text = (REPO / "data" / "mhd_mri_3d_stratified.ini").read_text()
    assert "nx=16\nny=64\nnz=128" in text and "compensated=yes" in text
    text = text.replace("nx=16\nny=64\nnz=128", f"nx={nx}\nny={ny}\nnz={nz}")
    if dissip:
        text = text.replace("cIso=0.001\n", f"cIso=0.001\nnu={NU}\n", 1).replace(
            "omega0=0.001\n", f"omega0=0.001\neta={ETA}\n", 1)
    return text.replace("[implementation]\n", f"[implementation]\ndtype={dtype}\n", 1)


def t_start(params) -> float:
    return 2.5 * params.dy / (1.5 * params.omega0 * params.dx * params.nx)


def random_state(params, rng, dtype, shape=None):
    """A conserved state, rho > 0, small velocities and field."""
    shape = params.shape[1:] if shape is None else shape
    rho = rng.uniform(0.5, 1.5, shape)
    vel = 1e-3 * rng.standard_normal((3,) + shape)
    bf = 1e-4 * rng.standard_normal((3,) + shape)
    e = rng.uniform(0.5, 1.5, shape) + 0.5 * rho * (vel ** 2).sum(0)
    return np.stack([rho, e, *(rho * vel), *bf]).astype(dtype)


# -------------------------------------------------------------------------
# per-function inputs and outputs (either package)
# -------------------------------------------------------------------------
def fn_inputs(dtype):
    params = params_from_config(ConfigMap(text=strat_text(dtype)))
    rng = np.random.default_rng(43)
    U = random_state(params, rng, dtype)
    g = params.ghost_width
    mid = random_state(params, rng, dtype, (params.nz, params.ny, params.nx + 2 * g))
    return params, U, mid


def function_outputs(package, dtype):
    """{name: [arrays]} of the stratified functions of the JAX package
    ("jax") or the port ("port") on the same inputs."""
    text = strat_text(dtype)
    if package == "jax":
        from ramsesgpu_tpu.config.configmap import ConfigMap as C
        from ramsesgpu_tpu.config.params import params_from_config as P
        from ramsesgpu_tpu.problems.mhd_inits import mri_gravity_field
        from ramsesgpu_tpu.solvers.dissipation import apply_dissipation_mhd
        from ramsesgpu_tpu.solvers.shear import _stratified_ghost_slabs, make_all_boundaries_shear
        from ramsesgpu_tpu.solvers.stratified import make_boundary_z_stratified
        array, back = jnp.asarray, np.asarray

        def dissipation(params, U, t, dt):
            g, nx = params.ghost_width, params.nx
            W = apply_dissipation_mhd(params, make_all_boundaries_shear(params, U, t), dt)
            return W[:, g:-g, g:-g, g:g + nx], W[5, g:-g, g:-g, nx + g]
    else:
        from ramsesgpu_tpu_torch.config.configmap import ConfigMap as C
        from ramsesgpu_tpu_torch.config.params import params_from_config as P
        from ramsesgpu_tpu_torch.problems.mhd_inits import mri_gravity_field
        from ramsesgpu_tpu_torch.solvers.stratified import make_boundary_z_stratified
        from ramsesgpu_tpu_torch.solvers.stratified import \
            stratified_ghost_slabs as _stratified_ghost_slabs
        array, back = torch.from_numpy, (lambda a: a.numpy())

        def dissipation(params, U, t, dt):
            from ramsesgpu_tpu_torch.solvers.dissipation import (kept_face_resistive_ct,
                                                                  mhd_dissipation_shear_update)
            from ramsesgpu_tpu_torch.solvers.shear import shear_slabs, stratified_zslabs

            g, nx = params.ghost_width, params.nx
            S, kept = U[:, g:-g, g:-g, g:g + nx], U[5, g:-g, g:-g, nx + g]
            slabs = shear_slabs(params, S, kept, t)
            zslabs = stratified_zslabs(params, S, slabs)
            S_new, eypl, ezpl = mhd_dissipation_shear_update(params, S, slabs, dt, zslabs)
            return S_new, kept_face_resistive_ct(params, slabs[1, 5, ..., 0], eypl, ezpl, dt)
    config = C(text=text)
    params = P(config)
    _p, U, mid = fn_inputs(dtype)
    out = {}
    for floor in (False, True):
        for side in (None, True):
            out[f"boundary floor={floor} side={side}"] = [back(make_boundary_z_stratified(
                params, array(U), side_max=side, floor=floor))]
    out["ghost slabs"] = [back(a) for a in _stratified_ghost_slabs(params, array(mid))]
    out["gravity field"] = [np.asarray(mri_gravity_field(params, config))]
    # the dissipative sub-step on the refilled box at t0, dt 10 (nu dt / dx^2
    # = 0.1), its interior and kept face
    dparams = P(C(text=strat_text(dtype, dissip=True)))
    t = array(np.asarray(t_start(dparams), dtype))
    out["dissipation"] = [back(a) for a in dissipation(dparams, array(U), t,
                                                        array(np.asarray(10.0, dtype)))]
    return out


# -------------------------------------------------------------------------
# the JAX references
# -------------------------------------------------------------------------
def jax_run(n_steps=N_STEPS, dissip=False):
    """The JAX whole-array stratified run from t0: the ghosted state, t and
    the interior's mass after each step; ``dissip``: with nu and eta."""
    from ramsesgpu_tpu.config.configmap import ConfigMap as JConfigMap
    from ramsesgpu_tpu.config.params import params_from_config as j_params
    from ramsesgpu_tpu.problems import init_problem
    from ramsesgpu_tpu.solvers.boundary import make_boundaries
    from ramsesgpu_tpu.solvers.shear import make_all_boundaries_shear
    from ramsesgpu_tpu.solvers.step import make_step_fn

    config = JConfigMap(text=strat_text(dissip=dissip))
    params = j_params(config)
    g = params.ghost_width
    out = {}
    U = make_boundaries(params, jnp.asarray(init_problem(params, config), params.dtype))
    t = jnp.asarray(t_start(params), U.dtype)
    U = make_all_boundaries_shear(params, U, t)
    out["U0"] = np.asarray(U)
    masses = [float(np.asarray(U[0, g:-g, g:-g, g:-g], np.float64).sum())]
    step = make_step_fn(params.replace(kernel="jnp", compensated=False), config)
    for _ in range(n_steps):
        U, dt = step(U, t)
        t = t + dt
        masses.append(float(np.asarray(U[0, g:-g, g:-g, g:-g], np.float64).sum()))
    out["U"], out["t"], out["mass"] = np.asarray(U), float(t), np.asarray(masses)
    return out


_JAX_SCRIPT = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import numpy as np
sys.path.insert(0, sys.argv[1])
import test_torch_stratified as m
out = {f"run_{k}": v for k, v in m.jax_run().items()}
out.update({f"dissip_{k}": v for k, v in m.jax_run(dissip=True).items()})
for dtype in ("float32", "float64"):
    for name, arrays in m.function_outputs("jax", dtype).items():
        for j, a in enumerate(arrays):
            out[f"fn_{name}_{dtype}_{j}"] = a
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module", autouse=True)
def jax_refs(tmp_path_factory):
    """The JAX references in one subprocess (jax_enable_x64), started at the
    module's first test; ``jax_refs()`` waits for it."""
    out = tmp_path_factory.mktemp("jax_strat") / "refs.npz"
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


def assert_close(got, want, label, rtol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, label
    atol = 1e-6 * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=label)


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm((a - b).ravel()) / np.linalg.norm(b.ravel()))


# -------------------------------------------------------------------------
# per function
# -------------------------------------------------------------------------
def test_functions_f32_match_jax(jax_refs):
    refs = jax_refs()
    got = function_outputs("port", "float32")
    assert {k.rsplit("_", 2)[0][3:] for k in refs if k.startswith("fn_")} == set(got)
    for name, arrays in got.items():
        for j, a in enumerate(arrays):
            assert_close(a, refs[f"fn_{name}_float32_{j}"], f"{name} output {j}")


@pytest.mark.parametrize("name", ["boundary", "ghost slabs", "gravity field", "dissipation"])
def test_functions_f64_match_jax(name, jax_refs):
    refs = jax_refs()
    got = function_outputs("port", "float64")
    for key, arrays in got.items():
        if key.startswith(name):
            for j, a in enumerate(arrays):
                assert_close(a, refs[f"fn_{key}_float64_{j}"], f"{key} output {j}",
                             rtol=1e-12)


def test_gravity_column_is_the_field_the_jax_package_uses():
    """The step's g_z per z row is the registry field's column, in the
    state's dtype, ghost rows included."""
    from ramsesgpu_tpu_torch.problems import gravity_field
    from ramsesgpu_tpu_torch.solvers.step import gravity_z

    config = ConfigMap(text=strat_text())
    params = params_from_config(config)
    field = gravity_field(params, config)
    gz = gravity_z(params, config, "cpu")
    assert gz.dtype == torch.float32 and gz.shape == (params.nz + 2 * params.ghost_width,)
    assert np.array_equal(gz.numpy(), field[2, :, 0, 0])
    assert not field[:2].any() and (field[2] == field[2, :, :1, :1]).all()


# -------------------------------------------------------------------------
# the slice
# -------------------------------------------------------------------------
_port_runs: dict = {}


def port_run(jax_refs):
    """(params, U, t, masses, outflows) of the port's loop from the JAX
    run's initial state: 3 steps one at a time, each step's z-face outflow
    from the twin's own z fluxes on the step's inputs. Memoised."""
    if _port_runs:
        return _port_runs["run"]
    from ramsesgpu_tpu_torch.kernels.shear import pack
    from ramsesgpu_tpu_torch.solvers.godunov_mhd import mhd_fluxes_emfs, xpos_array
    from ramsesgpu_tpu_torch.solvers.shear import shear_slabs, stratified_zslabs
    from ramsesgpu_tpu_torch.solvers.step import gravity_z, make_packed_advance_chain
    from ramsesgpu_tpu_torch.solvers.timestep import dt_from_inv, inv_dt_mhd_shear

    config = ConfigMap(text=strat_text())
    params = params_from_config(config)
    g, nx, nz = params.ghost_width, params.nx, params.nz
    refs = jax_refs()
    _pack, advance, unpack = make_packed_advance_chain(params, "cpu", config)
    state = pack(params, torch.from_numpy(refs["run_U0"]))
    t = torch.tensor(t_start(params), dtype=torch.float32)
    gz = gravity_z(params, config, "cpu")
    masses, outflows = [float(state[0][0].double().sum())], []
    for _ in range(N_STEPS):
        S, kept = state
        dt = dt_from_inv(params, inv_dt_mhd_shear(params, S, kept[0]))
        slabs = shear_slabs(params, S[:8], kept[0], t + dt)
        W = torch.cat([slabs[0], S[:8], slabs[1]], dim=-1)
        zslabs = stratified_zslabs(params, S[:8], slabs)
        W = torch.cat([zslabs[0], W, zslabs[1]], dim=-3)
        fz = mhd_fluxes_emfs(params, W, dt, xpos_array(params, W.dtype), gz.view(-1, 1, 1))[0][2]
        fz = fz[0, :, :, g:g + nx].double()
        outflows.append(float(dt) / params.dz * float(fz[g].sum() - fz[g + nz].sum()))
        state, t, k = advance(state, t, 1)
        assert int(k) == 1
        masses.append(float(state[0][0].double().sum()))
    _port_runs["run"] = (params, unpack(state, t), float(t), masses, outflows)
    return _port_runs["run"]


def check_run(params, U, t, refs, run="run"):
    """The port's run against the JAX one (``run``: its key prefix): t, and
    the loop state (interior, kept face) as one vector, as
    tests/test_torch_shear.py test_slice_matches_jax holds it."""
    from ramsesgpu_tpu_torch.core.constants import IA

    g, nx = params.ghost_width, params.nx
    np.testing.assert_allclose(t, float(refs[f"{run}_t"]), rtol=TOL_T)
    want = refs[f"{run}_U"]
    got = U.numpy()
    assert np.isfinite(got).all()
    inner = (slice(None), slice(g, -g), slice(g, -g), slice(g, -g))
    kept = (IA, slice(g, -g), slice(g, -g), nx + g)
    diff = np.linalg.norm((got[inner] - want[inner]).astype(np.float64)) ** 2 + \
        np.linalg.norm((got[kept] - want[kept]).astype(np.float64)) ** 2
    norm = np.linalg.norm(want[inner].astype(np.float64)) ** 2 + \
        np.linalg.norm(want[kept].astype(np.float64)) ** 2
    assert np.sqrt(diff / norm) <= TOL_L2


def test_stratified_mri_matches_jax(jax_refs):
    params, U, t, _masses, _outflows = port_run(jax_refs)
    check_run(params, U, t, jax_refs())


def test_zcarry_stratified_mri_matches_jax(jax_refs):
    """kernel=zcarry (the streamed step's stratified mode between the same
    slab, z-slab, border and CFL launches, two buffers that take turns;
    its twins on the CPU): the 3 steps in one chunk, so the state ends in
    the other buffer and is copied back, against the same JAX run."""
    from ramsesgpu_tpu_torch.solvers.step import make_advance_n

    config = ConfigMap(text=strat_text().replace("[implementation]\n",
                                                 "[implementation]\nkernel=zcarry\n", 1))
    params = params_from_config(config)
    assert params.kernel == "zcarry"
    refs = jax_refs()
    t0 = torch.tensor(t_start(params), dtype=torch.float32)
    U, t, k = make_advance_n(params, "cpu", config)(torch.from_numpy(refs["run_U0"]), t0, N_STEPS)
    assert int(k) == N_STEPS
    check_run(params, U, float(t), refs)


@pytest.mark.parametrize("comp", ["yes", "no"])
@pytest.mark.parametrize("kernel", ["auto", "zcarry"])
def test_dissipative_stratified_mri_matches_jax(kernel, comp, jax_refs):
    """The stratified box with nu and eta: each step's sheared and
    stratified refill of the updated state and the dissipation kernel's
    stratified shear mode after the step (kernels/shear.py; its twins on
    the CPU), 3 steps in one chunk from the JAX run's initial state, plain
    and compensated (the JAX whole-array run has no carry), staged and
    streamed, against the JAX whole-array run with nu and eta."""
    from ramsesgpu_tpu_torch.solvers.step import make_advance_n

    text = strat_text(dissip=True).replace("compensated=yes", f"compensated={comp}")
    config = ConfigMap(text=text.replace("[implementation]\n",
                                         f"[implementation]\nkernel={kernel}\n", 1))
    params = params_from_config(config)
    assert (params.nu, params.eta, params.kernel) == (NU, ETA, kernel)
    assert params.compensated == (comp == "yes")
    refs = jax_refs()
    t0 = torch.tensor(t_start(params), dtype=torch.float32)
    U, t, k = make_advance_n(params, "cpu", config)(torch.from_numpy(refs["dissip_U0"]), t0,
                                                    N_STEPS)
    assert int(k) == N_STEPS
    check_run(params, U, float(t), refs, "dissip")
    # the dissipation moves the run: the ideal run's state differs by more
    # than ten times the tolerance (by 1.5e-4 relative)
    assert rel_l2(refs["dissip_U"], refs["run_U"]) > 10 * TOL_L2


def test_stratified_fill_equals_jax(jax_refs):
    """The port's ghost fill of the initial state (make_boundaries with the
    stratified z faces, then the sheared x slabs and the stratified z slabs
    of the block) is bitwise the JAX package's."""
    from ramsesgpu_tpu_torch.problems import init_problem
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries
    from ramsesgpu_tpu_torch.solvers.shear import make_all_boundaries_shear

    config = ConfigMap(text=strat_text())
    params = params_from_config(config)
    U = make_boundaries(params, torch.from_numpy(init_problem(params, config)))
    U = make_all_boundaries_shear(params, U, torch.tensor(t_start(params), dtype=torch.float32))
    np.testing.assert_array_equal(U.numpy(), jax_refs()["run_U0"])


def test_stratified_mass_change_is_the_z_outflow(jax_refs):
    """Each step's mass change is the outflow through the z faces that the
    step's z density fluxes give (the remapped x-face fluxes cancel, y is
    periodic), to f32 rounding. That alone shows only that the update is
    conservative; the outflow is also held against the JAX run's mass
    change of the same step (its update is conservative too), so a z slab
    rule that lets more or less mass through shows as a difference of
    outflows."""
    _params, _U, _t, masses, outflows = port_run(jax_refs)
    jax_mass = jax_refs()["run_mass"]
    for n, outflow in enumerate(outflows):
        change = masses[n + 1] - masses[n]
        jax_change = jax_mass[n + 1] - jax_mass[n]
        print(f"step {n + 1}: mass change {change:.6e} (JAX {jax_change:.6e}),"
              f" z-face outflow {outflow:.6e}")
        assert abs(change - outflow) <= TOL_MASS * masses[0]
        assert abs(outflow - jax_change) <= TOL_MASS * masses[0]
    print(f"{len(outflows)} steps: mass change {(masses[-1] - masses[0]) / masses[0]:.3e} of the "
          f"mass (JAX {(jax_mass[-1] - jax_mass[0]) / jax_mass[0]:.3e})")
    assert abs((masses[-1] - masses[0]) - (jax_mass[-1] - jax_mass[0])) <= TOL_MASS * masses[0]


def test_step_fn_equals_one_loop_step(jax_refs):
    """make_step_fn's stratified step (pack with zero carries, one step,
    fresh fill) is bitwise one step of the loop from the same state."""
    from ramsesgpu_tpu_torch.solvers.step import make_advance_n, make_step_fn

    config = ConfigMap(text=strat_text())
    params = params_from_config(config)
    U0 = torch.from_numpy(jax_refs()["run_U0"])
    t0 = torch.tensor(t_start(params), dtype=torch.float32)
    U1, dt = make_step_fn(params, "cpu", config)(U0.clone(), t0)
    U2, t2, k = make_advance_n(params, "cpu", config)(U0.clone(), t0, 1)
    assert int(k) == 1 and float(t2) == float(t0 + dt)
    assert torch.equal(U1, U2)


# -------------------------------------------------------------------------
# the CUDA sources' arithmetic (g++ host build)
# -------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_csrc_host_build_matches_stratified_twins(dtype):
    """The stratified modes of csrc/cfl_mhd.cu and csrc/mhd_step.cu and the
    slab kernel of csrc/shear_border.cu with its z slabs, built with g++,
    against the twins on the shipped ini's state with non-zero carries: the
    CFL and the step within 1e-6 / 1e-13, the x and z slabs and the update
    stage on its own fluxes bitwise."""
    from ramsesgpu_tpu_torch.kernels.build import load_library, param_block
    from ramsesgpu_tpu_torch.kernels.mhd_step import scratch_fluxes
    from ramsesgpu_tpu_torch.kernels.shear import pack
    from ramsesgpu_tpu_torch.problems import init_problem
    from ramsesgpu_tpu_torch.solvers import godunov_mhd as gm
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries
    from ramsesgpu_tpu_torch.solvers.shear import shear_slabs, stratified_zslabs
    from ramsesgpu_tpu_torch.solvers.step import gravity_z
    from ramsesgpu_tpu_torch.solvers.timestep import dt_from_inv, inv_dt_mhd_shear

    lib = load_library("host")
    sfx = "f32" if dtype == "float32" else "f64"
    tdt = torch.float32 if dtype == "float32" else torch.float64
    tol = 1e-6 if dtype == "float32" else 1e-13
    eps = torch.finfo(tdt).eps
    gen = torch.Generator().manual_seed(47)
    config = ConfigMap(text=strat_text(dtype, 8, 16, 16))
    params = params_from_config(config)
    U = make_boundaries(params, torch.from_numpy(init_problem(params, config)).to(tdt))
    S, kept = pack(params, U)
    S[8:] = eps * S[:8] * torch.randn(S[:8].shape, generator=gen, dtype=tdt)
    kept[1] = eps * kept[0] * torch.randn(kept[0].shape, generator=gen, dtype=tdt)
    gz = gravity_z(params, config, "cpu")
    dims, blk = (params.nx, params.ny, params.nz), param_block(params)

    inv = torch.zeros((), dtype=tdt)
    assert getattr(lib, f"ramses_cfl_mhd_shear_{sfx}")(
        S.data_ptr(), kept.data_ptr(), None, None, inv.data_ptr(), *dims, blk, None) == 0
    inv_ref = inv_dt_mhd_shear(params, S, kept[0])
    assert abs(float(inv) - float(inv_ref)) <= tol * float(inv_ref)
    dt = dt_from_inv(params, inv_ref)
    t0 = torch.tensor(t_start(params), dtype=tdt)
    slabs = shear_slabs(params, S[:8], kept[0], t0 + dt)
    zslabs = torch.empty((2, 8, 3, params.ny, params.nx + 6), dtype=tdt)
    slabs_k = torch.empty_like(slabs)
    assert getattr(lib, f"ramses_shear_slabs_{sfx}")(
        S.data_ptr(), kept.data_ptr(), slabs_k.data_ptr(), zslabs.data_ptr(), t0.data_ptr(),
        dt.data_ptr(), *dims, blk, None) == 0
    assert torch.equal(slabs_k, slabs)
    assert torch.equal(zslabs, stratified_zslabs(params, S[:8], slabs))
    scratch = torch.empty(lib.ramses_mhd_step_shear_scratch(*dims, 1), dtype=tdt)
    planes = torch.zeros((5, params.nz, params.ny), dtype=tdt)
    for active in (False, True):
        S1 = S.clone()
        flag = torch.tensor(active)
        assert getattr(lib, f"ramses_mhd_step_shear_{sfx}")(
            S1.data_ptr(), scratch.data_ptr(), slabs.data_ptr(), planes.data_ptr(),
            zslabs.data_ptr(), gz.to(tdt).data_ptr(), dt.data_ptr(), flag.data_ptr(), 1, *dims,
            blk, None) == 0
        if not active:
            assert torch.equal(S1, S)
    fluxes, emfs, x0, z0 = scratch_fluxes(params, scratch)
    gzw = gz.to(tdt)[3 - z0:3 - z0 + fluxes[0].shape[1]].view(-1, 1, 1)
    assert torch.equal(S1, gm.mhd_apply_update(params, S[:8], fluxes, emfs, dt, x0, z0,
                                               comp=S[8:], gz=gzw))
    S1_t, planes_t = gm.mhd_3d_shear_update(params, S, slabs, dt, zslabs, gz.to(tdt))
    for got, want in ((S1[:8], S1_t[:8]), (planes, planes_t)):
        err = torch.linalg.norm((got - want).double()) / torch.linalg.norm(want.double())
        assert float(err) <= tol


# ny = 70: a partial y run of csrc/shear_border.cu's slab and border
# blocks; nz = 2: every slab block writes z ghosts
@pytest.mark.parametrize("nz", [2, 5])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_csrc_host_build_stratified_slabs_partial_blocks(dtype, nz):
    """csrc/shear_border.cu's stratified slab launch built with g++ on a
    6x70xnz box: the x slabs and the z slabs bitwise the twins and the
    wrappers' CPU entry points (kernels/shear_border.py shear_slabs with
    zout, shear_zslabs); then the border kernel on the shipped
    (compensated) state, inactive (nothing changes) and active (bitwise the
    twin)."""
    from ramsesgpu_tpu_torch.kernels import shear_border as wrappers
    from ramsesgpu_tpu_torch.kernels.build import load_library, param_block
    from ramsesgpu_tpu_torch.solvers.godunov_mhd import shear_border_update
    from ramsesgpu_tpu_torch.solvers.shear import shear_slabs, stratified_zslabs

    lib = load_library("host")
    sfx = "f32" if dtype == "float32" else "f64"
    tdt = torch.float32 if dtype == "float32" else torch.float64
    params = params_from_config(ConfigMap(text=strat_text(dtype, 6, 70, nz)))
    rng = np.random.default_rng(29)
    U = torch.from_numpy(random_state(params, rng, dtype))
    g, nx, ny = params.ghost_width, params.nx, params.ny
    S8 = U[:, g:-g, g:-g, g:g + nx].contiguous()
    eps = torch.finfo(tdt).eps
    S = torch.cat([S8, eps * S8 * torch.from_numpy(rng.standard_normal(S8.shape)).to(tdt)])
    kept = torch.stack([U[5, g:-g, g:-g, nx + g], eps * U[5, g:-g, g:-g, nx + g]]).contiguous()
    dims, blk = (nx, ny, nz), param_block(params)
    t = torch.tensor(t_start(params), dtype=tdt)
    dt = torch.tensor(0.01 * float(t), dtype=tdt)

    slabs = torch.full((2, 8, nz, ny, 3), float("nan"), dtype=tdt)
    zslabs = torch.full((2, 8, 3, ny, nx + 6), float("nan"), dtype=tdt)
    assert getattr(lib, f"ramses_shear_slabs_{sfx}")(
        S.data_ptr(), kept.data_ptr(), slabs.data_ptr(), zslabs.data_ptr(), t.data_ptr(),
        dt.data_ptr(), *dims, blk, None) == 0
    assert torch.equal(slabs, shear_slabs(params, S8, kept[0], t + dt))
    assert torch.equal(zslabs, stratified_zslabs(params, S8, slabs))
    zout = torch.empty_like(zslabs)
    assert torch.equal(wrappers.shear_slabs(params, S, kept, t, dt, zout=zout), slabs)
    assert torch.equal(zout, zslabs)
    assert torch.equal(wrappers.shear_zslabs(params, S, slabs), zslabs)

    planes = torch.from_numpy(1e-3 * rng.standard_normal((5, nz, ny))).to(tdt)
    want = shear_border_update(params, S, kept, planes, t, dt)
    for active in (False, True):
        S1, k1, rem = S.clone(), kept.clone(), torch.zeros((4, nz, ny), dtype=tdt)
        assert getattr(lib, f"ramses_shear_border_{sfx}")(
            S1.data_ptr(), k1.data_ptr(), planes.data_ptr(), rem.data_ptr(), t.data_ptr(),
            dt.data_ptr(), torch.tensor(active).data_ptr(), 1, *dims, blk, None) == 0
        expect = want if active else (S, kept, torch.zeros_like(rem))
        assert all(torch.equal(a, b) for a, b in zip((S1, k1, rem), expect)), active


@pytest.mark.parametrize("comp", [False, True], ids=["plain", "compensated"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_csrc_host_build_stratified_dissipation(dtype, comp):
    """csrc/dissip_step.cu's stratified shear mode built with g++ (z loads
    outside the interior read the z slabs) on a 12x10x5 box, with nu and
    eta: the new state against the twin's (the increment within 1e-6 /
    1e-13; compensated, the state and carry bitwise, the file being
    FMA-free), the kept face's change likewise, S untouched; an inactive
    sub-step copies S and leaves the kept face."""
    from ramsesgpu_tpu_torch.kernels.build import load_library, param_block
    from ramsesgpu_tpu_torch.solvers.dissipation import (kept_face_resistive_ct,
                                                          mhd_dissipation_shear_update)
    from ramsesgpu_tpu_torch.solvers.shear import shear_slabs, stratified_zslabs

    lib = load_library("host")
    tdt = torch.float32 if dtype == "float32" else torch.float64
    tol = 1e-6 if dtype == "float32" else 1e-13
    fn = getattr(lib, f"ramses_dissip_step_strat_{'f32' if dtype == 'float32' else 'f64'}")
    params = params_from_config(ConfigMap(text=strat_text(dtype, 12, 10, 5, dissip=True)))
    params = params.replace(compensated=comp)
    rng = np.random.default_rng(31)
    U = torch.from_numpy(random_state(params, rng, dtype))
    g, nx, ny, nz = params.ghost_width, params.nx, params.ny, params.nz
    S = U[:, g:-g, g:-g, g:g + nx].contiguous()
    kept = U[5, g:-g, g:-g, nx + g].contiguous()
    if comp:
        eps = torch.finfo(tdt).eps
        S = torch.cat([S, eps * S * torch.from_numpy(rng.standard_normal(S.shape)).to(tdt)])
        kept = torch.stack([kept, eps * kept * torch.from_numpy(
            rng.standard_normal(kept.shape)).to(tdt)])
    face = kept[0] if comp else kept
    slabs = shear_slabs(params, S[:8], face, torch.tensor(t_start(params), dtype=tdt))
    zslabs = stratified_zslabs(params, S[:8], slabs)
    dt = torch.tensor(10.0, dtype=tdt)
    want, eypl, ezpl = mhd_dissipation_shear_update(params, S, slabs, dt, zslabs)
    old = torch.stack([slabs[1, 5, ..., 0], kept[1]]) if comp else slabs[1, 5, ..., 0]
    kept_want = kept_face_resistive_ct(params, old, eypl, ezpl, dt)
    S_in = S.clone()
    for active in (True, False):
        got, kept_got = torch.full_like(S, float("nan")), kept.clone()
        assert fn(S.data_ptr(), got.data_ptr(), slabs.data_ptr(), kept_got.data_ptr(),
                  zslabs.data_ptr(), dt.data_ptr(), torch.tensor(active).data_ptr(), int(comp),
                  nx, ny, nz, param_block(params), None) == 0
        assert torch.equal(S, S_in)
        if not active:
            assert torch.equal(got, S) and torch.equal(kept_got, kept)
        elif comp:
            assert torch.equal(got, want) and torch.equal(kept_got, kept_want)
        else:
            assert rel_l2(got - S, want - S) <= tol
            assert rel_l2(kept_got - kept, kept_want - kept) <= tol
