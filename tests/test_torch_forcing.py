"""The port's turbulence slice against the JAX package on the CPU: the two
forcings (ops/forcing.py), the turbulence initial conditions, the history
diagnostics (io/history.py), isothermal periodic MHD (the isothermal
instances of csrc/mhd_step.cu, cfl_mhd.cu and zcarry_mhd.cu, whose twins
run here) and the forced chunk loop (solvers/step.py make_forced_*).

The JAX references run in one subprocess: with jax_enable_x64 for the
float64 cases, and without it for the float32 ones, as a float32 JAX run
has it (jax.random.normal and the OU projection tensor then take float32).
The OU draws of a JAX run are replayed into the port through its state's
``draw``. Pass criteria: the tables, mode signs, projection tensor,
static field, initial states and random deviates bitwise; the
normalization, static kick, OU update, OU basis and OU kick within
relative L2 TOL_FN (1e-13 in f64, 1e-6 in f32); each history channel
within 1e-12 (f64) of the larger of its value and its value on |U| (the
mean momenta are sums that cancel, and a sum's rounding scales with its
terms); the four turbulence inputs as shipped but at
16^3, f64, 3 steps of the port's forced loop against JAX
make_forced_advance_n, and isothermal Orszag-Tang (plain and dissipative)
against JAX make_advance_n (kernel=jnp): equal step counts, t and the
interior within TOL_SLICE = 1e-12. The host build of the isothermal
kernel instances (g++) against their twins within TOL_HOST.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
DTYPES = ("float32", "float64")
N = 16
N_STEPS = 3
TOL_FN = {"float32": 1e-6, "float64": 1e-13}
TOL_HIST = 1e-12
TOL_SLICE = 1e-12
TOL_HOST = {"float32": 1e-6, "float64": 1e-13}
INPUTS = ("turbulence_hydro", "turbulence_hydro_ou", "turbulence_mhd", "turbulence_mhd_ou")
# the JAX dissipation tests' coefficients (tests/test_pallas_dissip.py:46)
NU, ETA = 2e-3, 1e-3
C_ISO = 0.6
DT = 1e-3
# the static forcing's states: the momenta of the turbulence state times these
STATIC_SPEEDS = (1.0, 0.01)


def shipped(name, dtype="float64", n=N, kernel=None, extra=""):
    """data/<name>.ini at n^3 with the dtype (and the kernel choice)."""
    text = (REPO / "data" / f"{name}.ini").read_text()
    for axis in ("nx", "ny", "nz"):
        text, k = re.subn(rf"^{axis}=.*$", f"{axis}={n}", text, flags=re.M)
        assert k == 1
    impl = f"dtype={dtype}\n" + (f"kernel={kernel}\n" if kernel else "") + extra
    return text.replace("[implementation]\n", "[implementation]\n" + impl, 1)


def ot_iso(dtype="float64", dissipative=False):
    """Isothermal Orszag-Tang at 16^3 (cIso = C_ISO), with the JAX
    dissipation tests' nu and eta when ``dissipative``."""
    text = (REPO / "data" / "orszag-tang3d.ini").read_text()
    for axis in ("nx", "ny", "nz"):
        text = re.sub(rf"^{axis}=.*$", f"{axis}={N}", text, flags=re.M)
    coeffs = f"cIso={C_ISO}\n" + (f"nu={NU}\n" if dissipative else "")
    text = text.replace("[hydro]\n", "[hydro]\n" + coeffs, 1)
    if dissipative:
        text = text.replace("[MHD]\n", f"[MHD]\neta={ETA}\n", 1)
    return text + f"\n[implementation]\ndtype={dtype}\nkernel=jnp\n"


def perturbed(U, seed):
    """U times (1 + 0.05 N(0, 1)) on every cell, from a numpy seed."""
    rng = np.random.default_rng(seed)
    return (U * (1 + 0.05 * rng.standard_normal(U.shape))).astype(U.dtype)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.square(a - b).sum())) / (float(np.sqrt(np.square(b).sum())) or 1.0)


def interior(U, g):
    return U[:, g:-g, g:-g, g:-g]


def jax_references():
    """Every JAX reference of this file: numpy arrays by key."""
    import jax
    import jax.numpy as jnp

    from ramsesgpu_tpu.config.configmap import ConfigMap as JConfigMap
    from ramsesgpu_tpu.config.params import params_from_config as j_params
    from ramsesgpu_tpu.io.history import compute_history
    from ramsesgpu_tpu.ops import forcing as fz
    from ramsesgpu_tpu.problems import init_problem
    from ramsesgpu_tpu.solvers.boundary import make_boundaries
    from ramsesgpu_tpu.solvers.step import make_advance_n, make_forced_advance_n
    from ramsesgpu_tpu.utils.randomgen import RandomGen

    out = {}

    def setup(text):
        config = JConfigMap(text=text)
        return j_params(config), config

    rg = RandomGen(5)
    out["rand_rans"] = rg.rans(3, 11)
    out["rand_dev"] = np.array([rg.gauss_dev(), rg.poisson_dev(3.5), rg.uniform()])
    for dtype in DTYPES:
        jax.config.update("jax_enable_x64", dtype == "float64")
        for name in INPUTS:
            params, config = setup(shipped(name, dtype))
            out[f"init_{name}_{dtype}"] = np.asarray(init_problem(params, config))
        # the static forcing on the MHD turbulence state
        params, config = setup(shipped("turbulence_mhd", dtype))
        mach = config.get_float("turbulence", "machNumber", 0.0)
        F = fz.turbulence_init_field(params, mach)
        out[f"field_{dtype}"] = F
        edot = fz.default_edot(params, config)
        out["edot"] = np.asarray(edot)
        U0 = perturbed(np.asarray(init_problem(params, config)), 3)
        dt = jnp.asarray(DT, U0.dtype)
        for speed in STATIC_SPEEDS:
            U = U0.copy()
            U[2:5] *= np.asarray(speed, U.dtype)
            U = jnp.asarray(U)
            norm = fz.random_forcing_normalization(params, U, jnp.asarray(F), dt, edot)
            key = f"static_{speed}_{dtype}"
            out[key + "_U"], out[key + "_norm"] = np.asarray(U), np.asarray(norm)
            out[key + "_kick"] = np.asarray(fz.add_random_forcing(params, U, jnp.asarray(F),
                                                                  norm))
        # the OU forcing on the OU MHD state: 3 mode updates with their
        # draws, the basis and the kick
        params, config = setup(shipped("turbulence_mhd_ou", dtype))
        fp = fz.OUForcingParams.from_config(config)
        fstate = fz.init_ou_forcing(fp)
        out[f"ou_mode_{dtype}"] = np.asarray(fstate["mode"])
        out[f"ou_proj_{dtype}"] = np.asarray(fstate["projTens"])
        key, draws, fields = fstate["key"], [], []
        for _ in range(N_STEPS):
            key, sub = jax.random.split(key)
            draws.append(np.asarray(jax.random.normal(sub, (3, fz.N_MODE_OU))))
            fstate = fz.update_forcing_field_mode(params, fp, fstate, dt)
            fields.append(np.asarray(fstate["forcingField"]))
        out[f"ou_draws_{dtype}"], out[f"ou_fields_{dtype}"] = np.stack(draws), np.stack(fields)
        np_dtype = np.float64 if dtype == "float64" else np.float32
        basis = fz.ou_phase_basis(params, fstate, np_dtype)
        out[f"ou_basis_{dtype}"] = np.asarray(basis)
        U = jnp.asarray(perturbed(np.asarray(init_problem(params, config)), 5))
        # a moving state (the OU input starts at rest)
        U = U.at[2:5].add(0.1 * U[0])
        out[f"ou_U_{dtype}"] = np.asarray(U)
        out[f"ou_kick_{dtype}"] = np.asarray(fz.add_ou_forcing_field(params, U, fstate,
                                                                     basis, dt))
        # the whole slice, f64: 3 forced steps of each input, op by op
        if dtype == "float64":
            with jax.disable_jit():
                for name in INPUTS:
                    params, config = setup(shipped(name, dtype))
                    advance, fstate = make_forced_advance_n(params, config)
                    U = make_boundaries(params, jnp.asarray(init_problem(params, config)))
                    U, fstate, t, k = advance(U, fstate, jnp.asarray(0.0, U.dtype),
                                              jnp.array(N_STEPS, jnp.int32))
                    out[f"slice_{name}"] = np.asarray(U)
                    out[f"slice_{name}_tk"] = np.array([float(t), int(k)])
                    if "key" in fstate:
                        key, draws = jax.random.PRNGKey(fp.init_random), []
                        for _ in range(N_STEPS):
                            key, sub = jax.random.split(key)
                            draws.append(np.asarray(jax.random.normal(sub, (3, fz.N_MODE_OU))))
                        out[f"slice_{name}_draws"] = np.stack(draws)
                for dissipative in (False, True):
                    text = ot_iso(dtype, dissipative)
                    params, config = setup(text)
                    advance = make_advance_n(params, config)
                    U = make_boundaries(params, jnp.asarray(init_problem(params, config)))
                    U, t, k = advance(U, jnp.asarray(0.0, U.dtype),
                                      jnp.array(N_STEPS, jnp.int32))
                    out[f"ot_iso_{dissipative}"] = np.asarray(U)
                    out[f"ot_iso_{dissipative}_tk"] = np.array([float(t), int(k)])
            # history: every channel set on one moving MHD turbulence state
            params, config = setup(shipped("turbulence_mhd", dtype))
            U = np.asarray(make_boundaries(params, jnp.asarray(
                perturbed(np.asarray(init_problem(params, config)), 7))))
            out["hist_U"] = U
            for case, p in (("turbulence", params), ("mri", params.replace(omega0=0.3)),
                            ("inertial", params.replace(problem="inertial-wave")),
                            ("hydro", params.replace(mhd=False))):
                V = U[:5] if case == "hydro" else U
                sample = compute_history(p, jnp.asarray(V), 0.25, 0.0)
                out[f"hist_{case}_keys"] = np.array(list(sample))
                out[f"hist_{case}"] = np.array(list(sample.values()))
    return out


_JAX_SCRIPT = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
sys.path.insert(0, sys.argv[1])
import test_torch_forcing as m
np.savez(sys.argv[2], **m.jax_references())
"""


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    """Every JAX reference of this file, from one subprocess."""
    out = tmp_path_factory.mktemp("jax_forcing") / "ref.npz"
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    # a quick, single-threaded backend: the suite's other workers share the cores
    flags = ("--xla_backend_optimization_level=0 --xla_cpu_multi_thread_eigen=false "
             "--xla_cpu_use_fusion_emitters=false")
    env["XLA_FLAGS"] = " ".join(f for f in (env.get("XLA_FLAGS"), flags) if f)
    res = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(REPO / "tests"), str(out)],
                         capture_output=True, text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return dict(np.load(out))


def port(text):
    from ramsesgpu_tpu_torch.config.configmap import ConfigMap
    from ramsesgpu_tpu_torch.config.params import params_from_config

    config = ConfigMap(text=text)
    return params_from_config(config), config


def tdtype(dtype):
    return getattr(torch, dtype)


# -------------------------------------------------------------------------
# numpy parts: bitwise
# -------------------------------------------------------------------------
def test_randomgen_and_tables_bitwise(jax_refs):
    """utils/randomgen.py's deviates, the static field (both dtypes), the
    OU mode signs and projection tensor, bitwise the JAX package's."""
    from ramsesgpu_tpu_torch.ops import forcing as fz
    from ramsesgpu_tpu_torch.utils.randomgen import RandomGen

    rg = RandomGen(5)
    np.testing.assert_array_equal(rg.rans(3, 11), jax_refs["rand_rans"])
    np.testing.assert_array_equal([rg.gauss_dev(), rg.poisson_dev(3.5), rg.uniform()],
                                  jax_refs["rand_dev"])
    for dtype in DTYPES:
        params, config = port(shipped("turbulence_mhd", dtype))
        F = fz.turbulence_init_field(params, config.get_float("turbulence", "machNumber", 0.0))
        assert F.dtype == jax_refs[f"field_{dtype}"].dtype
        np.testing.assert_array_equal(F, jax_refs[f"field_{dtype}"])
        assert fz.default_edot(params, config) == float(jax_refs["edot"])
        params, config = port(shipped("turbulence_mhd_ou", dtype))
        state = fz.init_ou_forcing(fz.OUForcingParams.from_config(config))
        np.testing.assert_array_equal(state.mode.numpy(), jax_refs["ou_mode_float64"])
        np.testing.assert_array_equal(state.projTens.numpy(), jax_refs["ou_proj_float64"])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", INPUTS)
def test_turbulence_inits_bitwise(name, dtype, jax_refs):
    """The four turbulence initial states (the port's problem registry)."""
    from ramsesgpu_tpu_torch.problems import init_problem

    params, config = port(shipped(name, dtype))
    U = init_problem(params, config)
    want = jax_refs[f"init_{name}_{dtype}"]
    assert U.dtype == want.dtype
    np.testing.assert_array_equal(U, want)


# -------------------------------------------------------------------------
# the forcing functions on the device's tensors (here the CPU's)
# -------------------------------------------------------------------------
@pytest.mark.parametrize("speed", STATIC_SPEEDS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_static_forcing_matches_jax(dtype, speed, jax_refs):
    """The normalization and the kick on the interior-only state: the
    initial state of turbulence_mhd.ini (its velocity the field itself)
    perturbed, its momenta scaled by ``speed``. On the moving state (speed
    1) the formula cancels: sqrt(s0^2 + X) - s0 with X ~ s0^2 / 10, which
    scales the float32 rounding of the JAX package's sums and square root
    by ~20 in norm, where the port forms norm in float64 (ops/forcing.py);
    there the float32 norm enters through the kick, whose momentum change
    is ~1 % of the momentum, and the normalization is held on its own on
    the slow state (speed 0.01), where nothing cancels."""
    from ramsesgpu_tpu_torch.ops import forcing as fz

    params, config = port(shipped("turbulence_mhd", dtype))
    g = params.ghost_width
    key = f"static_{speed}_{dtype}"
    F = torch.from_numpy(interior(jax_refs[f"field_{dtype}"], g).copy())
    S = torch.from_numpy(interior(jax_refs[key + "_U"], g).copy())
    dt = torch.tensor(DT, dtype=tdtype(dtype))
    norm = fz.random_forcing_normalization(params, S, F, dt, fz.default_edot(params, config))
    want = float(jax_refs[key + "_norm"])
    assert norm.dtype == tdtype(dtype)
    if dtype == "float64" or speed != 1.0:
        assert abs(float(norm) - want) <= TOL_FN[dtype] * abs(want)
    fz.add_random_forcing(params, S, F, norm)
    assert rel_l2(S.numpy(), interior(jax_refs[key + "_kick"], g)) <= TOL_FN[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_ou_forcing_matches_jax(dtype, jax_refs):
    """Three OU mode updates with the JAX draws replayed, the basis on the
    interior and the kick; the field stays float32."""
    from ramsesgpu_tpu_torch.ops import forcing as fz

    params, config = port(shipped("turbulence_mhd_ou", dtype))
    fp = fz.OUForcingParams.from_config(config)
    state = fz.init_ou_forcing(fp, dtype=tdtype(dtype))
    draws = iter(torch.from_numpy(jax_refs[f"ou_draws_{dtype}"]))
    state.draw = lambda: next(draws)
    dt = torch.tensor(DT, dtype=tdtype(dtype))
    for k in range(N_STEPS):
        fz.update_forcing_field_mode(params, fp, state, dt)
        assert state.forcingField.dtype == torch.float32
        assert rel_l2(state.forcingField.numpy(), jax_refs[f"ou_fields_{dtype}"][k]) \
            <= TOL_FN[dtype]
    g = params.ghost_width
    basis = fz.ou_phase_basis(params, state, tdtype(dtype))
    assert rel_l2(basis.numpy(), interior(jax_refs[f"ou_basis_{dtype}"], g)) <= TOL_FN[dtype]
    S = torch.from_numpy(interior(jax_refs[f"ou_U_{dtype}"], g).copy())
    fz.add_ou_forcing_field(params, S, state, basis, dt)
    assert rel_l2(S.numpy(), interior(jax_refs[f"ou_kick_{dtype}"], g)) <= TOL_FN[dtype]


def test_forcing_gated_and_checkpoint_round_trip(tmp_path):
    """A false ``active`` leaves the state and the OU field as they were
    (a block is drawn all the same); the OU checkpoint (the JAX npz
    layout, gaussSeed = [seed, draws]) reloads the arrays and continues
    the same stream; the key rule of convert.py round-trips."""
    from ramsesgpu_tpu_torch.convert import forcing_state_from_jax, forcing_state_to_jax
    from ramsesgpu_tpu_torch.ops import forcing as fz
    from ramsesgpu_tpu_torch.problems import init_problem

    dt = torch.tensor(DT, dtype=torch.float64)
    for name, cls in (("turbulence_mhd", fz.StaticForcing), ("turbulence_mhd_ou", fz.OUForcing)):
        params, config = port(shipped(name, "float64"))
        S0 = torch.from_numpy(interior(init_problem(params, config), params.ghost_width).copy())
        S0[2:5] += 0.1 * S0[0]
        forcing = cls(params, config, "cpu", torch.float64)
        S = S0.clone()
        field = None if forcing.state is None else forcing.state.forcingField.clone()
        forcing(S, dt, torch.tensor(False))
        assert torch.equal(S, S0)
        if field is not None:
            assert torch.equal(forcing.state.forcingField, field) and forcing.state.draws == 1
        forcing(S, dt, torch.tensor(True))
        assert not torch.equal(S, S0)
    state = forcing.state
    path = tmp_path / "f.npz"
    fz.save_ou_forcing(state, path)
    back = fz.load_ou_forcing(path, dtype=torch.float64)
    assert back.seed == state.seed and back.draws == state.draws == 2
    for name in ("mode", "projTens", "forcingField"):
        assert torch.equal(getattr(back, name), getattr(state, name))
    assert torch.equal(back.draw(), state.draw())
    j = forcing_state_to_jax(state)
    assert list(j["key"]) == [0, 600] and j["forcingField"].dtype == np.float32
    again = forcing_state_from_jax(j, "cpu", torch.float64)
    assert again.seed == 600 and torch.equal(again.forcingField, state.forcingField)


# -------------------------------------------------------------------------
# history
# -------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["turbulence", "mri", "inertial", "hydro"])
def test_history_matches_jax(case, jax_refs):
    """compute_history's channels, their names and order, on a moving MHD
    turbulence state (f64): MHD with the turbulence channels, the MRI
    stresses (omega0 > 0), the inertial-wave probe, hydro."""
    from ramsesgpu_tpu_torch.io.history import compute_history

    params, _ = port(shipped("turbulence_mhd", "float64"))
    params = {"turbulence": params, "mri": params.replace(omega0=0.3),
              "inertial": params.replace(problem="inertial-wave"),
              "hydro": params.replace(mhd=False)}[case]
    U = torch.from_numpy(jax_refs["hist_U"])
    U = U[:5] if case == "hydro" else U
    sample = compute_history(params, U, 0.25, 0.0)
    # a sum's rounding scales with its terms' magnitudes: the channel on |U|
    scale = compute_history(params, U.abs(), 0.25, 0.0)
    assert list(sample) == list(jax_refs[f"hist_{case}_keys"])
    bad = [(key, got, want) for (key, got), want in zip(sample.items(), jax_refs[f"hist_{case}"])
           if abs(got - want) > TOL_HIST * max(abs(want), abs(scale[key]), 1e-300)]
    assert not bad, bad


# -------------------------------------------------------------------------
# the forced loop and isothermal periodic MHD
# -------------------------------------------------------------------------
def forced_run(text, n=N_STEPS, draws=None):
    """n steps of the port's forced CPU loop from the initial state: the
    ghosted state, t, k (and the forcing)."""
    from ramsesgpu_tpu_torch.problems import init_problem
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries
    from ramsesgpu_tpu_torch.solvers.step import make_forced_advance_n

    params, config = port(text)
    advance, forcing = make_forced_advance_n(params, "cpu", config)
    if draws is not None:
        it = iter(torch.from_numpy(draws))
        forcing.state.draw = lambda: next(it)
    U0 = make_boundaries(params, torch.from_numpy(init_problem(params, config)))
    U, t, k = advance(U0, torch.zeros((), dtype=U0.dtype), n)
    return params, U, float(t), int(k), forcing


@pytest.mark.parametrize("name", INPUTS)
def test_forced_slice_matches_jax(name, jax_refs):
    """Each turbulence input as shipped but at 16^3, f64: 3 steps of the
    port's forced loop (kernel=auto; OU draws replayed) against JAX
    make_forced_advance_n, the interiors and t."""
    params, U, t, k, _ = forced_run(shipped(name), draws=jax_refs.get(f"slice_{name}_draws"))
    t_ref, k_ref = jax_refs[f"slice_{name}_tk"]
    g = params.ghost_width
    assert k == int(k_ref) == N_STEPS
    assert abs(t - t_ref) <= TOL_SLICE * t_ref
    got, want = interior(U.numpy(), g), interior(jax_refs[f"slice_{name}"], g)
    assert np.isfinite(got).all() and rel_l2(got, want) <= TOL_SLICE, rel_l2(got, want)


@pytest.mark.parametrize("dissipative", [False, True], ids=["ideal", "dissipative"])
def test_isothermal_periodic_mhd_matches_jax(dissipative, jax_refs):
    """Isothermal Orszag-Tang at 16^3, f64, 3 steps of the port's loop
    (the isothermal step and CFL instances; dissipative: then the
    dissipation kernel's isothermal mode) against JAX make_advance_n."""
    from ramsesgpu_tpu_torch.problems import init_problem
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries
    from ramsesgpu_tpu_torch.solvers.step import make_advance_n

    params, config = port(ot_iso("float64", dissipative).replace("kernel=jnp", "kernel=auto"))
    assert params.c_iso == C_ISO and (params.nu > 0) == dissipative
    U0 = make_boundaries(params, torch.from_numpy(init_problem(params, config)))
    U, t, k = make_advance_n(params, "cpu", config)(U0, torch.zeros((), dtype=U0.dtype),
                                                     N_STEPS)
    t_ref, k_ref = jax_refs[f"ot_iso_{dissipative}_tk"]
    g = params.ghost_width
    assert int(k) == int(k_ref) == N_STEPS and abs(float(t) - t_ref) <= TOL_SLICE * t_ref
    got, want = interior(U.numpy(), g), interior(jax_refs[f"ot_iso_{dissipative}"], g)
    assert rel_l2(got, want) <= TOL_SLICE, rel_l2(got, want)


@pytest.mark.parametrize("name", ["turbulence_mhd", "turbulence_hydro_ou"])
def test_forced_zcarry_and_compensated_equal_auto(name):
    """On the CPU the forced loop with kernel=zcarry (streamed steps, the
    CFL each step) and with compensated=yes (the plain state, as the JAX
    forced step has no compensated branch) is bitwise the kernel=auto
    run; a chunk past t_end stops, and its inactive steps leave the state
    and t as they were."""
    base = shipped(name, n=12)
    _p, U, t, k, _f = forced_run(base)
    for text in (shipped(name, n=12, kernel="zcarry"),
                 shipped(name, n=12, extra="compensated=yes\n")):
        _p, U2, t2, k2, _f = forced_run(text)
        assert (k2, t2) == (k, t) and torch.equal(U2, U)
    # t_end after the first step: the other steps of the chunk are inactive
    _p, U1, t1, k1, _f = forced_run(base, n=1)
    _p, U3, t3, k3, _f = forced_run(re.sub(r"^tend=.*$", f"tend={t1 * 0.5}", base,
                                           flags=re.M), n=3)
    assert k3 == 1 and t3 == t1 and torch.equal(U3, U1)


# -------------------------------------------------------------------------
# the g++ host build of the isothermal kernel instances
# -------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
def test_host_build_isothermal_instances(dtype):
    """csrc/cfl_mhd.cu (periodic and ghosted), mhd_step.cu (periodic,
    compensated and ghosted) and zcarry_mhd.cu (periodic, folded CFL)
    built with g++, on a moving isothermal turbulence state at 16^3,
    against their twins (TOL_HOST); an inactive step leaves the state."""
    from ramsesgpu_tpu_torch.kernels.build import load_library, param_block
    from ramsesgpu_tpu_torch.problems import init_problem
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries
    from ramsesgpu_tpu_torch.solvers.godunov_mhd import (mhd_3d_ghosted_update,
                                                         mhd_3d_periodic_update)
    from ramsesgpu_tpu_torch.solvers.timestep import (dt_from_inv, inv_dt_mhd_ghosted,
                                                      inv_dt_mhd_periodic)

    lib = load_library("host")
    sfx = "f32" if dtype == "float32" else "f64"
    params, config = port(shipped("turbulence_mhd_ou", dtype))
    assert params.c_iso > 0
    g, n = params.ghost_width, N
    U0 = init_problem(params, config)
    U0[2:5] += 0.3 * U0[0] * np.random.default_rng(4).standard_normal(U0[2:5].shape)
    U0[5:8] += 0.1 * np.random.default_rng(6).standard_normal(U0[5:8].shape)
    U = make_boundaries(params, torch.from_numpy(U0.astype(U0.dtype))).contiguous()
    S = interior(U, g).contiguous()
    blk = param_block(params)

    def close(got, want):
        return rel_l2(got, want) <= TOL_HOST[dtype]

    inv = torch.zeros((), dtype=S.dtype)
    assert getattr(lib, f"ramses_cfl_mhd_{sfx}")(S.data_ptr(), None, None, inv.data_ptr(),
                                                 n, n, n, blk, None) == 0
    assert close(inv, inv_dt_mhd_periodic(params, S))
    assert getattr(lib, f"ramses_cfl_mhd_ghosted_{sfx}")(
        U.data_ptr(), None, None, inv.data_ptr(), n, n, n, g, float("-inf"), blk, None) == 0
    assert close(inv, inv_dt_mhd_ghosted(params, U))
    # the adiabatic instance differs on this state: the isothermal one ran
    adiabatic = param_block(params.replace(c_iso=0.0))
    assert getattr(lib, f"ramses_cfl_mhd_{sfx}")(S.data_ptr(), None, None, inv.data_ptr(),
                                                 n, n, n, adiabatic, None) == 0
    assert not close(inv, inv_dt_mhd_periodic(params, S))

    dt = dt_from_inv(params, inv_dt_mhd_periodic(params, S))
    want = mhd_3d_periodic_update(params, S, dt)
    scratch = torch.empty(lib.ramses_mhd_step_scratch_per_cell() * S[0].numel(), dtype=S.dtype)
    step = getattr(lib, f"ramses_mhd_step_{sfx}")
    for comp in (0, 1):
        for active in (False, True):
            X = torch.cat([S, torch.zeros_like(S)]).contiguous() if comp else S.clone()
            assert step(X.data_ptr(), scratch.data_ptr(), dt.data_ptr(),
                        torch.tensor(active).data_ptr(), comp, n, n, n, blk, None) == 0
            assert close(X[:8] + X[8:] if comp else X, want) if active else torch.equal(X[:8], S)
    X = U.clone()
    ghosted = torch.empty(lib.ramses_mhd_step_ghosted_scratch(n, n, n, g), dtype=S.dtype)
    assert getattr(lib, f"ramses_mhd_step_ghosted_{sfx}")(
        X.data_ptr(), ghosted.data_ptr(), dt.data_ptr(), torch.tensor(True).data_ptr(), n, n, n,
        g, blk, None) == 0
    assert close(X, mhd_3d_ghosted_update(params, U, dt))
    out = torch.empty_like(S)
    inv = torch.zeros((), dtype=S.dtype)
    blocks = lib.ramses_zcarry_mhd_blocks(0, 0, int(dtype == "float64"), blk)
    assert getattr(lib, f"ramses_zcarry_mhd_{sfx}")(
        S.data_ptr(), out.data_ptr(), blocks, None, None, None, None, inv.data_ptr(),
        dt.data_ptr(), torch.tensor(True).data_ptr(), 0, n, n, n, blk, None) == 0
    assert close(out, want) and close(inv, inv_dt_mhd_periodic(params, want))
