"""The port's alternative schemes (solvers/alt_schemes.py, alt_laxliu.py,
run2d_alt.py), the whole-array z slabs (solvers/zslab.py) and the CLI
switches that select them, against the JAX package on the CPU.

The JAX references run in one subprocess with jax_enable_x64, op by op
under ``jax.disable_jit()`` (per-op compiles shared by the cases of one
shape). Pass criteria:

- each scheme's steps on a seeded random physical f64 state (split
  Godunov and relaxing TVD at 16^2, each parity three times, and at 16^3,
  each of the six sweep orders once; Kurganov-Tadmor each parity three
  times and Lax-Liu three steps at 16^2), dt from each package's own CFL:
  relative L2 <= TOL;
- ``ramses-tpu-torch --scheme`` (each value) and ``[hydro] unsplit=no`` on
  data/hydro_sod2d.ini at 32 x 8 in f64, 10 steps, against JAX
  AltSchemeRun: the same step count, t within TOL, the interior within
  TOL;
- the Sod runs of tests/test_alt_schemes.py on the port's CPU path, at
  that file's 128 x 16, against the same exact-solution L1 bounds;
- zslab_apply bitwise the monolithic update (hydro and MHD), and the
  whole-array make_step_fn with zSlabNb = 4 against JAX make_step_fn
  (hydro; the MHD update's slabs are the bitwise case's);
- ``--dump-param-file`` prints the JAX CLI's text.
"""
import contextlib
import io
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
sys.path.insert(0, str(Path(__file__).resolve().parent))
TOL = 1e-12
N_RUN = 10
SCHEMES = ("godunov-split", "kurganov", "laxliu", "relaxingTVD", "unsplit=no")

STEP_INI = """
[mesh]
nx=16
ny=16
nz={nz}
boundary_xmin=2
boundary_xmax=1
boundary_ymin=3
boundary_ymax=3
boundary_zmin=1
boundary_zmax=2
[hydro]
problem=sod
iorder=2
slope_type={slope}
riemannSolver=hllc
cfl=0.41
XLAMBDA=0.1
YLAMBDA=0.1
[implementation]
dtype=float64
"""
# (scheme, dim, ghost width, steps, slope_type)
STEP_CASES = {
    "split2d": ("split", 2, 2, 6, 2.0),
    "split3d": ("split", 3, 2, 6, 1.0),
    "relaxing2d": ("relaxing", 2, 3, 6, 2.0),
    "relaxing3d": ("relaxing", 3, 3, 6, 2.0),
    "kt2d": ("kt", 2, 2, 6, 2.0),
    "laxliu2d": ("laxliu", 2, 2, 3, 2.0),
}

MHD_ZSLAB_INI = (REPO / "tests" / "test_zslab.py").read_text().split('MHD3D_INI = """')[1].split(
    '"""')[0]
ZSLAB_CASES = {
    "hydro": re.sub(r"^n([xyz])=.*$", lambda m: f"n{m.group(1)}={32 if m.group(1) == 'z' else 16}",
                    (REPO / "data" / "implode3d.ini").read_text(), flags=re.M),
    "mhd": MHD_ZSLAB_INI,
}


ZSLAB_JAX = ("hydro",)


def zslab_ini(name: str) -> str:
    return ZSLAB_CASES[name] + "\n[implementation]\ndtype=float64\nzSlabNb=4\nkernel=jnp\n"


def sod_run_ini() -> str:
    """data/hydro_sod2d.ini at 32 x 8 in f64."""
    text = (REPO / "data" / "hydro_sod2d.ini").read_text()
    text = re.sub(r"^nx=.*$", "nx=32", text, flags=re.M)
    text = re.sub(r"^ny=.*$", "ny=8", text, flags=re.M)
    return text + "\n[implementation]\ndtype=float64\n"


def random_state(params, seed: int) -> np.ndarray:
    """A physical conservative hydro state of the ghosted shape."""
    rng = np.random.default_rng(seed)
    shape = params.shape[1:]
    r, p = rng.uniform(0.5, 1.5, shape), rng.uniform(0.5, 1.5, shape)
    vel = [rng.normal(0.0, 0.3, shape) for _ in range(params.dim)]
    e = p / (params.gamma0 - 1.0) + 0.5 * r * sum(v * v for v in vel)
    return np.stack([r, e, *(r * v for v in vel)])


def step_case(pkg: str, name: str):
    """(U, t) after the case's steps in the package ``pkg``."""
    import importlib

    mod = lambda m: importlib.import_module(f"{pkg}.{m}")  # noqa: E731
    scheme, dim, g, n_steps, slope = STEP_CASES[name]
    config = mod("config.configmap").ConfigMap(text=STEP_INI.format(nz=16 if dim == 3 else 1,
                                                                   slope=slope))
    params = mod("config.params").params_from_config(config).replace(ghost_width=g)
    if pkg == "ramsesgpu_tpu":
        import jax.numpy as jnp

        U = jnp.asarray(random_state(params, 21))
    else:
        U = torch.from_numpy(random_state(params, 21))
    alt = mod("solvers.alt_schemes")
    compute_dt = mod("solvers.timestep").compute_dt
    t = 0.0
    for k in range(n_steps):
        if scheme in ("split", "relaxing"):
            dt = compute_dt(params, U)
            fn = alt.godunov_split_step if scheme == "split" else alt.relaxing_tvd_step
            U = fn(params, U, dt, k)
            t += float(dt)
        elif scheme == "kt":
            U = alt.kt_step(params, U, k % 2 == 1, params.xlambda, params.ylambda)
        else:
            U = mod("solvers.alt_laxliu").laxliu_step(params, U)
    return np.asarray(U), t


def jax_references(workdir: str) -> dict:
    """Every JAX reference of this file (numpy), keyed by case."""
    import jax
    import jax.numpy as jnp

    from ramsesgpu_tpu.cli.main import main
    from ramsesgpu_tpu.config.configmap import ConfigMap
    from ramsesgpu_tpu.config.params import params_from_config
    from ramsesgpu_tpu.problems import init_problem
    from ramsesgpu_tpu.solvers.boundary import make_boundaries
    from ramsesgpu_tpu.solvers.run2d_alt import AltSchemeRun
    from ramsesgpu_tpu.solvers.step import make_step_fn

    jax.config.update("jax_enable_x64", True)
    out = {}
    with jax.disable_jit():
        for name in STEP_CASES:
            out[f"step/{name}"], out[f"t/{name}"] = step_case("ramsesgpu_tpu", name)
        for scheme in SCHEMES[:-1]:
            # (the JAX CLI runs unsplit=no as godunov-split: the same run)
            run = AltSchemeRun(ConfigMap(text=sod_run_ini()), scheme=scheme)
            run.start(max_steps=N_RUN, do_output=False)
            for s in (scheme, "unsplit=no") if scheme == "godunov-split" else (scheme,):
                out[f"run/{s}"] = np.asarray(run.U)
                out[f"run_t/{s}"] = np.asarray(run.t)
                out[f"run_k/{s}"] = np.asarray(run.n_step)
        for name in ZSLAB_JAX:
            config = ConfigMap(text=zslab_ini(name))
            params = params_from_config(config)
            U = make_boundaries(params, jnp.asarray(init_problem(params, config)))
            U, dt = make_step_fn(params, config)(U, jnp.asarray(0.0))
            out[f"zslab/{name}"], out[f"zslab_dt/{name}"] = np.asarray(U), np.asarray(dt)
    path = Path(workdir) / "sod.ini"
    path.write_text(sod_run_ini())
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(["--param", str(path), "--dump-param-file"])
    out["dump"] = np.asarray(buf.getvalue())
    return out


_JAX_SCRIPT = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
sys.path.insert(0, sys.argv[1])
import test_torch_alt_schemes as m
np.savez(sys.argv[2], **m.jax_references(sys.argv[3]))
"""


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    """Every JAX reference of this file, from one subprocess."""
    work = tmp_path_factory.mktemp("jax_alt")
    out = work / "ref.npz"
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    flags = ("--xla_backend_optimization_level=0 --xla_cpu_multi_thread_eigen=false "
             "--xla_cpu_use_fusion_emitters=false")
    env["XLA_FLAGS"] = " ".join(f for f in (env.get("XLA_FLAGS"), flags) if f)
    res = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(REPO / "tests"), str(out),
                          str(work)], capture_output=True, text=True, env=env, timeout=600)
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


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_scheme_steps_match_jax(jax_refs, name):
    """Each scheme's steps on the same seeded f64 state: the whole ghosted
    state (the fill of the last sweep's input and the updated interior)
    within TOL, and t."""
    U, t = step_case("ramsesgpu_tpu_torch", name)
    want = jax_refs[f"step/{name}"]
    assert U.shape == want.shape and U.dtype == np.float64 and np.isfinite(U).all()
    assert rel_l2(U, want) <= TOL, rel_l2(U, want)
    assert abs(t - float(jax_refs[f"t/{name}"])) <= TOL * max(abs(t), 1.0)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_cli_scheme_matches_jax_run(jax_refs, scheme, tmp_path, monkeypatch, capsys):
    """``ramses-tpu-torch --scheme <scheme>`` (or ``[hydro] unsplit=no``
    without the switch) on the Sod tube at 32 x 8, f64, 10 steps on the CPU
    against JAX AltSchemeRun: equal step counts, t and interior within
    TOL; relaxing TVD on a ghost width of 3."""
    from ramsesgpu_tpu_torch.cli.main import main
    from ramsesgpu_tpu_torch.solvers.run2d_alt import AltSchemeRun

    runs = []
    start = AltSchemeRun.start

    def kept(self, *args, **kw):
        runs.append(self)
        return start(self, *args, **kw)

    monkeypatch.setattr(AltSchemeRun, "start", kept)
    text = sod_run_ini()
    argv = ["--device", "cpu", "--max-steps", str(N_RUN), "--no-output"]
    if scheme == "unsplit=no":
        text = text.replace("[hydro]\n", "[hydro]\nunsplit=no\n")
    else:
        argv += ["--scheme", scheme]
    path = tmp_path / "sod.ini"
    path.write_text(text)
    assert main(["--param", str(path), *argv]) == 0
    assert f"number of time steps   : {N_RUN}" in capsys.readouterr().out
    (run,) = runs
    assert run.scheme == scheme.replace("unsplit=no", "godunov-split")
    assert run.params.ghost_width == (3 if scheme == "relaxingTVD" else 2)
    want = jax_refs[f"run/{scheme}"]
    g = run.params.ghost_width
    got = run.U.numpy()
    assert got.shape == want.shape and run.n_step == int(jax_refs[f"run_k/{scheme}"]) == N_RUN
    assert abs(run.t - float(jax_refs[f"run_t/{scheme}"])) <= TOL * run.t
    assert rel_l2(got[:, g:-g, g:-g], want[:, g:-g, g:-g]) <= TOL


def test_dump_param_file_matches_jax(jax_refs, tmp_path, capsys):
    """``--dump-param-file`` prints the JAX CLI's text, bitwise."""
    from ramsesgpu_tpu_torch.cli.main import main

    path = tmp_path / "sod.ini"
    path.write_text(sod_run_ini())
    assert main(["--param", str(path), "--dump-param-file"]) == 0
    assert capsys.readouterr().out == str(jax_refs["dump"])


def test_alternatives_refuse_what_the_jax_cli_refuses(tmp_path):
    """Kurganov-Tadmor and Lax-Liu in 3D raise the JAX ValueError; an
    ``[mpi]`` input with --scheme exits with the JAX text; MHD is refused."""
    from ramsesgpu_tpu_torch.cli.main import main
    from ramsesgpu_tpu_torch.solvers.run2d_alt import AltSchemeRun

    text3d = STEP_INI.format(nz=8, slope=1.0)
    for scheme in ("kurganov", "laxliu"):
        with pytest.raises(ValueError, match=f"scheme {scheme} is 2D only"):
            AltSchemeRun(port(text3d)[1], "cpu", scheme)
    path = tmp_path / "mpi.ini"
    path.write_text(sod_run_ini() + "\n[mpi]\nmx=2\n")
    with pytest.raises(SystemExit, match="--scheme alternatives run single-device only"):
        main(["--param", str(path), "--device", "cpu", "--scheme", "kurganov"])
    mhd = (REPO / "data" / "orszag-tang.ini").read_text()
    with pytest.raises(ValueError, match="hydro only"):
        AltSchemeRun(port(mhd)[1], "cpu", "godunov-split")


SOD_INI = (REPO / "tests" / "test_alt_schemes.py").read_text().split('SOD_INI = """')[1].split(
    '"""')[0]
# the exact-solution L1 bounds of tests/test_alt_schemes.py
SOD_BOUNDS = {"split": 1.2e-2, "kt": 4e-2, "laxliu": 4e-2, "relaxing": 4e-2}


@pytest.mark.parametrize("scheme", list(SOD_BOUNDS))
def test_sod_within_exact_l1(scheme):
    """tests/test_alt_schemes.py's Sod runs (128 x 16, to t = 0.2) on the
    port's CPU path: finite, and the density's L1 error against the exact
    solution within that file's bound."""
    from exact_riemann import sod_exact

    from ramsesgpu_tpu_torch.core.constants import ID
    from ramsesgpu_tpu_torch.problems import init_problem
    from ramsesgpu_tpu_torch.solvers import alt_laxliu, alt_schemes
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries
    from ramsesgpu_tpu_torch.solvers.timestep import compute_dt

    params, config = port(SOD_INI)
    if scheme == "relaxing":
        params = params.replace(ghost_width=3)
    U = make_boundaries(params, torch.from_numpy(init_problem(params, config)))
    t = 0.0
    if scheme in ("kt", "laxliu"):
        dt = params.xlambda * params.dx
        for k in range(int(0.2 / dt) + 1):
            if scheme == "kt":
                U = alt_schemes.kt_step(params, U, k % 2 == 1, params.xlambda, params.ylambda)
            else:
                U = alt_laxliu.laxliu_step(params, U)
            t += dt
    else:
        step = alt_schemes.godunov_split_step if scheme == "split" else \
            alt_schemes.relaxing_tvd_step
        for k in range(400):
            if t >= 0.2:
                break
            dt = compute_dt(params, U)
            U = step(params, U, dt, k)
            t += float(dt)
    U = U.numpy()
    g = params.ghost_width
    rho = U[ID, g:-g, g:-g].mean(axis=0)
    x = (np.arange(params.nx) + 0.5) / params.nx
    x0 = (params.isize / 2 - g) / params.nx
    rho_e, _, _ = sod_exact(x, t, gamma=params.gamma0, x0=x0)
    l1 = np.mean(np.abs(rho - rho_e))
    assert np.isfinite(U).all()
    assert l1 < SOD_BOUNDS[scheme], l1


@pytest.mark.parametrize("name", list(ZSLAB_CASES))
def test_zslab_apply_is_the_monolithic_update(name):
    """zslab_apply of the whole-array Godunov update with 4 z slabs is the
    monolithic update bitwise on the interior (ghosts: the input's)."""
    from ramsesgpu_tpu_torch.problems import init_problem
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries
    from ramsesgpu_tpu_torch.solvers.godunov import godunov_unsplit_hydro
    from ramsesgpu_tpu_torch.solvers.godunov_mhd import godunov_unsplit_mhd
    from ramsesgpu_tpu_torch.solvers.timestep import compute_dt
    from ramsesgpu_tpu_torch.solvers.zslab import zslab_apply

    params, config = port(zslab_ini(name))
    U = make_boundaries(params, torch.from_numpy(init_problem(params, config)))
    dt = compute_dt(params, U)
    update = godunov_unsplit_mhd if params.mhd else godunov_unsplit_hydro
    whole = update(params, U, dt)
    slabbed = zslab_apply(params, U, lambda w: update(params, w, dt), 4)
    g = params.ghost_width
    inner = (slice(None),) + (slice(g, -g),) * 3
    assert torch.equal(slabbed[inner], whole[inner])
    assert torch.equal(zslab_apply(params, U, lambda w: update(params, w, dt), 1), whole)
    with pytest.raises(ValueError, match="not divisible by zSlabNb=3"):
        zslab_apply(params, U, lambda w: update(params, w, dt), 3)


@pytest.mark.parametrize("name", ZSLAB_JAX)
def test_zslab_step_matches_jax(jax_refs, name):
    """make_step_fn with kernel=jnp and zSlabNb = 4 (the whole-array step
    slab by slab) against JAX make_step_fn: dt and the interior within TOL."""
    from ramsesgpu_tpu_torch.problems import init_problem
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries
    from ramsesgpu_tpu_torch.solvers.step import make_step_fn

    params, config = port(zslab_ini(name))
    U = make_boundaries(params, torch.from_numpy(init_problem(params, config)))
    U, dt = make_step_fn(params, "cpu", config)(U, torch.zeros((), dtype=torch.float64))
    g = params.ghost_width
    inner = (slice(None),) + (slice(g, -g),) * 3
    want = jax_refs[f"zslab/{name}"]
    assert abs(float(dt) - float(jax_refs[f"zslab_dt/{name}"])) <= TOL * float(dt)
    assert rel_l2(U.numpy()[inner], want[inner]) <= TOL
