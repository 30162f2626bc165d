"""The port's 2D slice against the JAX package on the CPU: 2D hydro
(approx / HLL / HLLC) and ideal 2D MHD with constrained transport (HLLD
faces, 2D-HLLD corner EMF, the rotating frame), with walls, periodic faces
and the 2D jet (solvers/step2d.py).

The JAX package has no 2D kernel: its 2D run is the whole-array step in a
while loop, and so is the port's. The JAX references run in one
subprocess with jax_enable_x64 (float32 arrays stay float32). The single
functions and the 19 three-step loops run op by op under
``jax.disable_jit()``, whose per-op compiles all cases of one mesh and
dtype share (an MHD loop's own jit costs ~3 s of CPU); the four 20-step
loops of the f32 budget run under their own jits, built without XLA's CPU
fusion emitters (a third of the compile time; the same arithmetic).
Pass criteria:

- each ported module (slopes, eos, trace, mhd_utils, trace_mhd, the MHD
  Riemann solver and EMF on 2D states, the hydro and MHD Godunov steps,
  the time step, make_step_fn) on the same seeded inputs, f64, relative
  L2 <= TOL (1e-12); the boundary fill bitwise;
- the 19 single-device 2D inputs without gravity, as shipped but at
  32 x 32 (the jets' strips scaled to fit), f64, 3 steps of the port's CPU
  make_advance_n against JAX make_advance_n: equal step counts, t and the
  interior (with the CT face layer n+g of an MHD state) within TOL;
- Orszag-Tang and the 2D Sod tube at 32^2 for 20 steps in f32: the port's
  relative L2 error against the JAX f64 run <= 2x the JAX f32 run's own
  + 1e-7 (the reference's own f32 budget);
- a CPU Run of each of those two writes its VTI (and, for Orszag-Tang,
  HDF5) snapshots, and the arrays read back match the JAX 3-step state.
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
N = 32
N_STEPS = 3
N_F32 = 20
TOL = 1e-12
HYDRO_INPUTS = ("hydro_sod2d", "implode2d", "blast2d", "Gresho_vortex2d", "riemann2d",
                "kelvin_helmholtz_cpu_2d", "kelvin_helmholtz_gpu_2d",
                "kelvin_helmholtz_gpu_2d_large", "jet2d_cpu", "jet2d_gpu")
MHD_INPUTS = ("orszag-tang", "mhd_rotor", "mhd_BrioWu", "mhd_currentSheet_2d",
              "mhd_fieldloop2d", "mhd_kelvin_helmholtz_2d", "kelvin_helmholtz_gpu_2d_mhd",
              "mhd_jet2d", "mhd_inertialWave_2d")
INPUTS = HYDRO_INPUTS + MHD_INPUTS
# the jets' strips at 32 cells (shipped: ijet 10 at offsetJet 10, 50 and 20)
JETS = {"jet2d_cpu": {"ijet": 4, "offsetJet": 2}, "jet2d_gpu": {"ijet": 4, "offsetJet": 8},
        "mhd_jet2d": {"ijet": 4, "offsetJet": 3}}
F32_INPUTS = ("orszag-tang", "hydro_sod2d")
MODULES = ("slopes", "eos", "trace", "mhd_utils", "trace_mhd", "riemann_mhd", "godunov",
           "godunov_mhd", "boundary", "timestep", "step")
FACE_MIXES = {"dirichlet": (1, 1, 1, 1), "neumann": (2, 2, 2, 2), "periodic": (3, 3, 3, 3),
              "mixed": (1, 2, 3, 3)}
DT = 2e-3


def cut(name, dtype="float64", extra=""):
    """data/<name>.ini at N x N (the jets' strips scaled), with the dtype."""
    text = (REPO / "data" / f"{name}.ini").read_text()
    for key, value in {"nx": N, "ny": N, **JETS.get(name, {})}.items():
        text, k = re.subn(rf"^\s*{key}\s*=.*$", f"{key}={value}", text, flags=re.M)
        assert k == 1, (name, key)
    return text + f"\n[implementation]\ndtype={dtype}\n" + extra


def module_ini(mhd, omega0=0.0, c_iso=0.0, solver=None, faces=(3, 3, 3, 3), jet=False):
    """The module cases' configuration: Orszag-Tang (MHD) or the 2D Sod
    tube (hydro) at N x N (the inputs' mesh, whose op-by-op compiles the
    JAX references share), f64, with the given faces, solver, rotation and
    EOS; ``jet``: the jet problem with a strip of 4 at offset 3."""
    text = (REPO / "data" / ("orszag-tang.ini" if mhd else "hydro_sod2d.ini")).read_text()
    subs = {"nx": N, "ny": N}
    subs.update({f"boundary_{f}": b for f, b in zip(("xmin", "xmax", "ymin", "ymax"), faces)})
    if mhd:
        subs["omega0"] = omega0
    if solver is not None:
        subs["riemannSolver"] = solver
    if jet:
        subs["problem"] = "jet"
    for key, value in subs.items():
        text, k = re.subn(rf"^\s*{key}\s*=.*$", f"{key}={value}", text, flags=re.M)
        assert k == 1, key
    extra = f"\n[hydro]\ncIso={c_iso}\n" if c_iso else ""
    if jet:
        extra += "\n[jet]\nijet=4\ndjet=1.\nujet=30.\npjet=1.\noffsetJet=3\n"
    return text + extra + "\n[implementation]\ndtype=float64\n"


MODULE_CONFIGS = {
    "mhd": module_ini(True),
    "mhd_rot": module_ini(True, omega0=0.7),
    "mhd_iso": module_ini(True, omega0=0.7, c_iso=0.8),
    **{f"hydro_{s}": module_ini(False, solver=s) for s in ("approx", "hll", "hllc")},
    **{f"faces_{k}": module_ini(False, faces=f) for k, f in FACE_MIXES.items()},
    **{f"mhd_faces_{k}": module_ini(True, faces=f) for k, f in FACE_MIXES.items()},
    "hydro_jet": module_ini(False, faces=(1, 2, 1, 2), jet=True),
    "mhd_jet": module_ini(True, faces=(2, 2, 2, 2), jet=True),
}


def hydro_prim(rng, shape):
    """A physical primitive hydro state [4, *shape]: rho, p, u, v."""
    return np.stack([rng.uniform(0.5, 1.5, shape), rng.uniform(0.5, 1.5, shape),
                     rng.normal(0.0, 0.3, shape), rng.normal(0.0, 0.3, shape)])


def mhd_prim(rng, shape):
    """A physical primitive MHD state [8, *shape]."""
    return np.stack([rng.uniform(0.5, 1.5, shape), rng.uniform(0.5, 1.5, shape),
                     *(rng.normal(0.0, 0.3, shape) for _ in range(3)),
                     *(rng.uniform(-0.6, 0.6, shape) for _ in range(3))])


def hydro_cons(params, rng):
    """A physical conservative hydro state of the ghosted shape."""
    r, p, u, v = hydro_prim(rng, params.shape[1:])
    return np.stack([r, p / (params.gamma0 - 1.0) + 0.5 * r * (u * u + v * v), r * u, r * v])


def mhd_cons(params, rng):
    """A physical conservative MHD state of the ghosted shape (face-centred
    B; the energy's margin keeps the pressure of the cell-centred B > 0)."""
    r, p, u, v, w, a, b, c = mhd_prim(rng, params.shape[1:])
    e = p / (params.gamma0 - 1.0) + 0.5 * r * (u * u + v * v + w * w) + 0.5 * (
        a * a + b * b + c * c) + 0.5
    return np.stack([r, e, r * u, r * v, r * w, a, b, c])


def module_cases(pkg):
    """{name: (function of the package's modules -> outputs)} for the case
    ``name`` of each module; ``pkg`` is "ramsesgpu_tpu" or
    "ramsesgpu_tpu_torch". Every input is made here from a numpy seed;
    ``arr`` turns it into the package's array type."""
    import importlib

    mod = lambda m: importlib.import_module(f"{pkg}.{m}")  # noqa: E731
    if pkg == "ramsesgpu_tpu":
        import jax.numpy as jnp

        arr = jnp.asarray
    else:
        arr = torch.from_numpy
    params = {k: mod("config.params").params_from_config(mod("config.configmap").ConfigMap(
        text=t)) for k, t in MODULE_CONFIGS.items()}
    dt = arr(np.asarray(DT))
    const = mod("core.constants")
    ia, ib = const.IA, const.IB

    def slopes():
        p = params["hydro_hllc"]
        Q = arr(hydro_prim(np.random.default_rng(1), p.shape[1:]))
        out = {}
        for st in (1.0, 2.0):
            out.update({f"st{st}_{d}": s for d, s in zip(
                "xy", mod("ops.slopes").slopes_unsplit(p.replace(slope_type=st), Q))})
        return out

    def eos():
        out = {}
        for k in ("mhd", "mhd_rot", "mhd_iso"):
            Q, c = mod("ops.eos").constoprim_mhd(
                params[k], arr(mhd_cons(params[k], np.random.default_rng(2))), dt)
            out.update({f"{k}_Q": Q, f"{k}_c": c})
        Q, c = mod("ops.eos").constoprim_hydro(
            params["hydro_hllc"], arr(hydro_cons(params["hydro_hllc"], np.random.default_rng(3))))
        return {**out, "hydro_Q": Q, "hydro_c": c}

    def trace():
        p = params["hydro_hllc"]
        Q = arr(hydro_prim(np.random.default_rng(4), p.shape[1:]))
        qm, qp = mod("ops.trace").trace_unsplit_hydro(
            p, Q, mod("ops.slopes").slopes_unsplit(p, Q), dt)
        return {**{f"qm{d}": q for d, q in zip("xy", qm)},
                **{f"qp{d}": q for d, q in zip("xy", qp)}}

    def mhd_utils():
        p = params["mhd"]
        Q = arr(mhd_prim(np.random.default_rng(5), p.shape[1:]))
        return dict(zip("xyz", mod("ops.mhd_utils").fast_magnetosonic_speeds(p, Q)))

    def xpos(p):
        gm = mod("solvers.godunov_mhd")
        return gm.xpos_array(p, torch.float64) if pkg.endswith("torch") else gm.xpos_array(
            p, np.float64)

    def trace_mhd():
        out = {}
        for k in ("mhd", "mhd_rot"):
            p = params[k]
            rng = np.random.default_rng(6)
            Q = arr(mhd_prim(rng, p.shape[1:]))
            U = arr(mhd_cons(p, rng))
            faces, faces_p, corners = mod("ops.trace_mhd").trace_unsplit_mhd_2d(
                p, Q, U[ia], U[ib], dt, xpos(p))
            names = ("qm_x", "qm_y", "qp_x", "qp_y", "qRT", "qRB", "qLT", "qLB")
            out.update({f"{k}_{n}": q for n, q in zip(names, (*faces, *faces_p, *corners))})
        return out

    def riemann_mhd():
        out = {}
        for k in ("mhd", "mhd_iso"):
            p = params[k]
            rng = np.random.default_rng(7)
            ql, qr, *corners = (arr(mhd_prim(rng, p.shape[1:])) for _ in range(6))
            out[f"{k}_flux"] = mod("ops.riemann_mhd").riemann_mhd(p, ql, qr)
            out[f"{k}_emf"] = mod("ops.riemann_mhd").compute_emf(p, *corners, "z", xpos(p))
        return out

    def godunov():
        return {s: mod("solvers.godunov").godunov_unsplit_hydro(
            params[f"hydro_{s}"], mod("solvers.boundary").make_boundaries(
                params[f"hydro_{s}"], arr(hydro_cons(params[f"hydro_{s}"],
                                                     np.random.default_rng(8)))), dt)
            for s in ("approx", "hll", "hllc")}

    def godunov_mhd():
        out = {}
        for k in ("mhd", "mhd_rot", "mhd_iso", "mhd_faces_mixed"):
            p = params[k]
            U = mod("solvers.boundary").make_boundaries(p, arr(mhd_cons(p, np.random.default_rng(9))))
            out[k] = mod("solvers.godunov_mhd").godunov_unsplit_mhd(p, U, dt)
        return out

    def boundary():
        out = {}
        for k in [*(f"faces_{f}" for f in FACE_MIXES), *(f"mhd_faces_{f}" for f in FACE_MIXES),
                  "hydro_jet", "mhd_jet"]:
            p = params[k]
            make = mhd_cons if p.mhd else hydro_cons
            out[k] = mod("solvers.boundary").make_boundaries(p, arr(make(p, np.random.default_rng(10))))
        return out

    def timestep():
        out = {}
        for k in ("hydro_hllc", "hydro_jet", "mhd", "mhd_rot", "mhd_iso", "mhd_jet"):
            p = params[k]
            make = mhd_cons if p.mhd else hydro_cons
            out[k] = mod("solvers.timestep").compute_dt(p, arr(make(p, np.random.default_rng(11))))
        return out

    def step():
        """make_step_fn's one step (dt from the state as it stands, the
        fill, the update) of a state whose ghosts are not its fill."""
        out = {}
        for k in ("hydro_jet", "mhd_rot", "mhd_jet"):
            p = params[k]
            make = mhd_cons if p.mhd else hydro_cons
            U = arr(make(p, np.random.default_rng(12)))
            args = (p, "cpu") if pkg.endswith("torch") else (p,)
            out[f"{k}_U"], out[f"{k}_dt"] = mod("solvers.step").make_step_fn(*args)(
                U, arr(np.asarray(0.0)))
        return out

    return {"slopes": slopes, "eos": eos, "trace": trace, "mhd_utils": mhd_utils,
            "trace_mhd": trace_mhd, "riemann_mhd": riemann_mhd, "godunov": godunov,
            "godunov_mhd": godunov_mhd, "boundary": boundary, "timestep": timestep,
            "step": step}


def jax_references():
    """Every JAX reference of this file (numpy), keyed by case."""
    import jax
    import jax.numpy as jnp

    from ramsesgpu_tpu.config.configmap import ConfigMap
    from ramsesgpu_tpu.config.params import params_from_config
    from ramsesgpu_tpu.problems import init_problem
    from ramsesgpu_tpu.solvers.boundary import make_boundaries
    from ramsesgpu_tpu.solvers.step import make_advance_n

    jax.config.update("jax_enable_x64", True)
    out = {}
    with jax.disable_jit():
        for name, fn in module_cases("ramsesgpu_tpu").items():
            for key, value in fn().items():
                out[f"mod/{name}/{key}"] = np.asarray(value)

    def advance(text, n, jit):
        config = ConfigMap(text=text)
        params = params_from_config(config)
        U0 = np.asarray(init_problem(params, config))
        U = make_boundaries(params, jnp.asarray(U0))
        t = jnp.asarray(0.0, U.dtype)
        with jax.disable_jit(not jit):
            U, t, k = make_advance_n(params, config)(U, t, n)
        return U0, np.asarray(U), np.asarray(t), np.asarray(k)

    for name in INPUTS:
        out[f"init/{name}"], out[f"U/{name}"], out[f"t/{name}"], out[f"k/{name}"] = advance(
            cut(name), N_STEPS, jit=False)
    for name in F32_INPUTS:
        out[f"U20/{name}"] = advance(cut(name), N_F32, jit=True)[1]
        _U0, out[f"U32/{name}"], out[f"t32/{name}"], _k = advance(
            cut(name, "float32"), N_F32, jit=True)
    return out


_JAX_SCRIPT = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
sys.path.insert(0, sys.argv[1])
import test_torch_2d as m
np.savez(sys.argv[2], **m.jax_references())
"""


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    """Every JAX reference of this file, from one subprocess."""
    out = tmp_path_factory.mktemp("jax_2d") / "ref.npz"
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


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm((got - want).ravel()) / np.linalg.norm(want.ravel()))


def port(text):
    from ramsesgpu_tpu_torch.config.configmap import ConfigMap
    from ramsesgpu_tpu_torch.config.params import params_from_config

    config = ConfigMap(text=text)
    return params_from_config(config), config


def compared(params, U):
    """The interior of a ghosted 2D state and, for MHD, its CT face layer
    n+g (Bx at column nx+g, By at row ny+g), flattened: what the two
    packages' steps both define (the ghosts are the fill before the step)."""
    g = params.ghost_width
    U = np.asarray(U)
    parts = [U[:, g:-g, g:-g].ravel()]
    if params.mhd:
        from ramsesgpu_tpu_torch.core.constants import IA, IB

        parts += [U[IA, g:-g, -g], U[IB, -g, g:-g]]
    return np.concatenate(parts)


# -------------------------------------------------------------------------
# modules 1-10
# -------------------------------------------------------------------------
@pytest.mark.parametrize("module", MODULES)
def test_module_matches_jax(jax_refs, module):
    """The port's function of each module against the JAX package's on the
    same seeded f64 inputs: relative L2 <= TOL; the fill bitwise."""
    got = {k: v.numpy() for k, v in module_cases("ramsesgpu_tpu_torch")[module]().items()}
    want = {k.split("/", 2)[2]: v for k, v in jax_refs.items()
            if k.startswith(f"mod/{module}/")}
    assert sorted(got) == sorted(want) and got
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape and g.dtype == w.dtype, (key, g.shape, w.shape)
        assert np.isfinite(g).all(), key
        if module == "boundary":
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            assert rel_l2(g, w) <= TOL, (key, rel_l2(g, w))


# -------------------------------------------------------------------------
# the 19 inputs
# -------------------------------------------------------------------------
def port_advance(text, n, device="cpu"):
    """(params, U0, U, t, k) after n steps of the port's make_advance_n."""
    from ramsesgpu_tpu_torch.convert import torch_dtype
    from ramsesgpu_tpu_torch.problems import init_problem
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries
    from ramsesgpu_tpu_torch.solvers.step import make_advance_n

    params, config = port(text)
    U0 = init_problem(params, config)
    U = make_boundaries(params, torch.from_numpy(U0).to(device, torch_dtype(params)))
    t = torch.zeros((), dtype=U.dtype, device=device)
    U, t, k = make_advance_n(params, device, config)(U, t, n)
    return params, U0, U.cpu(), float(t), int(k)


@pytest.mark.parametrize("name", INPUTS)
def test_input_matches_jax(jax_refs, name):
    """data/<name>.ini at 32 x 32, f64, 3 steps of the port's CPU loop
    against JAX make_advance_n: the same initial state, step count, t and
    interior (with the CT face layer)."""
    params, U0, U, t, k = port_advance(cut(name), N_STEPS)
    assert params.dim == 2 and params.mhd == (name in MHD_INPUTS)
    np.testing.assert_array_equal(U0, jax_refs[f"init/{name}"])
    assert k == int(jax_refs[f"k/{name}"]) == N_STEPS
    assert abs(t - float(jax_refs[f"t/{name}"])) <= TOL * abs(t) and t > 0
    want = compared(params, jax_refs[f"U/{name}"])
    got = compared(params, U)
    assert np.isfinite(got).all()
    assert rel_l2(got, want) <= TOL, rel_l2(got, want)


@pytest.mark.parametrize("name", F32_INPUTS)
def test_f32_within_reference_budget(jax_refs, name):
    """20 f32 steps: the port's error against the JAX f64 run is at most
    twice the JAX f32 run's own, plus 1e-7."""
    params, _U0, U, t, k = port_advance(cut(name, "float32"), N_F32)
    assert U.dtype == torch.float32 and k == N_F32
    ref = compared(params, jax_refs[f"U20/{name}"])
    err_port = rel_l2(compared(params, U), ref)
    err_jax = rel_l2(compared(params, jax_refs[f"U32/{name}"]), ref)
    assert err_port <= 2 * err_jax + 1e-7, (err_port, err_jax)
    assert abs(t - float(jax_refs[f"t32/{name}"])) <= 1e-5 * t


# -------------------------------------------------------------------------
# Run, the simulation loop behind the CLI, with its outputs
# -------------------------------------------------------------------------
@pytest.mark.parametrize("name", F32_INPUTS)
def test_run_writes_outputs(jax_refs, tmp_path, name):
    """A CPU Run of 3 steps writes the VTI snapshots of steps 0 and 3 (and
    Orszag-Tang, ghosts included, its HDF5 ones); the arrays read back are
    the initial state and the JAX 3-step state."""
    from ramsesgpu_tpu_torch.io.hdf5 import input_hdf5
    from ramsesgpu_tpu_torch.io.vtk import read_vti
    from ramsesgpu_tpu_torch.solvers.run import Run

    text = re.sub(r"^outputDir=.*$", f"outputDir={tmp_path}", cut(name), flags=re.M)
    if name == "orszag-tang":
        text = text.replace("outputHdf5=no", "outputHdf5=yes")
    params, config = port(text)
    run = Run(config, "cpu", params)
    run.start(max_steps=N_STEPS)
    assert run.n_step == N_STEPS and run.interior().shape == (params.nb_var, N, N)
    g = params.ghost_width
    prefix = config.get_string("output", "outputPrefix", "")
    for step, U in ((0, jax_refs[f"init/{name}"]), (N_STEPS, jax_refs[f"U/{name}"])):
        fields, _extent = read_vti(tmp_path / f"{prefix}_{step:07d}.vti")
        got = np.stack(list(fields.values()))
        assert got.dtype == np.float64
        if run.ghost_included:
            assert got.shape == U.shape
            got = got[:, g:-g, g:-g]
        assert got.shape == (params.nb_var, N, N)
        assert rel_l2(got, U[:, g:-g, g:-g]) <= TOL
        if name == "orszag-tang":
            back, t, n = input_hdf5(params, tmp_path / f"{prefix}_{step:07d}.h5")
            assert n == step and rel_l2(back[:, g:-g, g:-g], U[:, g:-g, g:-g]) <= TOL


def test_convert_roundtrip_2d(jax_refs):
    """A JAX 2D state [nvar, ny+2g, nx+2g] into the port and back."""
    from ramsesgpu_tpu_torch.convert import state_from_jax, state_to_jax

    for name in ("orszag-tang", "hydro_sod2d"):
        params, _config = port(cut(name))
        U = jax_refs[f"U/{name}"]
        S = state_from_jax(params, U, "cpu")
        assert S.dtype == torch.float64 and tuple(S.shape) == params.shape
        np.testing.assert_array_equal(state_to_jax(params, S), U)
        with pytest.raises(ValueError):
            state_to_jax(params, S[:, 1:])


@pytest.mark.parametrize("name", ["implode2d", "orszag-tang"])
def test_compensated_switch_runs_plain_in_2d(name):
    """``[implementation] compensated=yes`` selects nothing in 2D (the JAX
    package reads it on its 3D MHD paths only): 3 steps of the port's CPU
    loop are bitwise the compensated=no run, which is held against JAX
    make_advance_n in test_input_matches_jax."""
    plain = port_advance(cut(name), N_STEPS)
    comp = port_advance(cut(name, extra="compensated=yes\n"), N_STEPS)
    assert comp[0].compensated and not plain[0].compensated
    assert (comp[3], comp[4]) == (plain[3], plain[4]) and plain[4] == N_STEPS
    assert torch.equal(comp[2], plain[2])
