"""The port's sharded dissipation and forcing (parallel/sharded_step.py, the
counterpart of JAX ``make_local_step``'s dissipative sub-step and
``make_sharded_forced_advance_n``), the distributed run's history and the
single-device hydro viscosity, against the JAX package on the CPU.

(a) The forced sharded advance (one world of 4 gloo processes on the CPU,
    file:// init, every port case in it) against JAX
    ``make_sharded_forced_advance_n`` on the 8-device virtual CPU mesh at
    (2, 2, 1), f64, 3 steps: the static MHD forcing of
    ``data/turbulence_mhd_mpi.ini`` as shipped (16 x 16 x 32); the static
    hydro forcing of ``data/turbulence_hydro_mpi.ini`` with edot = 0.5 (as
    shipped its edot = 0 makes the normalization 0, so the sum over the
    ranks would go untested); the OU hydro forcing of
    ``data/turbulence_hydro_ou.ini`` at 16^3 with the JAX draws replayed on
    every rank; the static forcing with a uniform gravity
    (tests/test_parallel.py:319-370's input). Equal k, t within rtol 1e-14
    (the forced state enters the next dt), the interior within relative
    L2 1e-12, the OU mode field within 1e-12.
(b) The sharded dissipation against JAX ``make_sharded_advance_n``, f64,
    3 steps from a perturbed state: periodic MHD with nu and eta
    (tests/test_parallel.py:233-245's input) at (1, 2, 2), so that z is
    exchanged, the walled Brio-Wu with nu and eta at (2, 2, 1), the 3D
    implode (walls) with nu at (1, 2, 2). Equal k and t, relative L2
    1e-12 (each JAX sharded MHD advance costs ~11 s of CPU here, so each
    input takes one topology). The JAX ranks on the CPU run the whole-array
    ``apply_dissipation_mhd`` / ``apply_viscosity``; the port's MHD ranks
    the dissipation kernel's ghosted mode (its twin here), interior only.
(c) The sharded MRI with nu and eta (cIso = 1, below the explicit limit)
    at (2, 1, 2) against JAX's shearing-box advance, 4 steps from a t0
    whose shear offset is 2.5 cells: the interior within
    tests/test_torch_sharded.py's 1e-13 (ROADMAP Queue 3 item 10: the JAX
    whole-array dissipation also moves the block's CT face layer).
(d) Single-device hydro with nu (the implode with walls, and the static
    forcing with nu) against JAX ``make_advance_n`` /
    ``make_forced_advance_n`` (kernel=jnp, under its jit) within 1e-12.
(e) A rank's OU basis block and static field block are bitwise the
    global ones' slices.
(f) The CLI (``main()`` in the world's 4 ranks, as under torchrun): both
    turbulence ``[mpi]`` inputs as shipped (f32, 3 steps) write their
    HDF5 state, which is held against the port's single-device run within
    relative L2 1e-5; ``data/turbulence_mhd_mpi.ini`` with ``[history]
    enabled``, in f64: the history file that rank 0 alone writes equals
    the single-device run's within 1e-12 of each channel's scale.

Every JAX reference comes from one subprocess with jax_enable_x64 and the
8 virtual devices, on the quick single-threaded XLA backend without its
fusion emitters (tests/test_torch_sharded.py).
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
N_STEPS = 3
N_MRI = 4
TOL = 1e-12
TOL_T = 1e-14
TOL_MRI = 1e-13
TOL_F32 = 1e-5
TOL_HIST = 1e-12


def ini(path, topo, mesh=None, dtype: str = "float64", **keys) -> str:
    """The INI at ``path`` (a data/ file, or INI text) with [mpi] mx, my, mz
    = topo (None: no [mpi]), the mesh (nx, ny, nz) and each ``key=value``
    of ``keys`` set (``section__key``: in that section, added where it is
    not there; a bare key must be there once); and [implementation]
    dtype."""
    text = (REPO / path).read_text() if path.startswith("data/") else path
    sets = dict(zip(("nx", "ny", "nz"), mesh or ()), **keys)
    for key, value in sets.items():
        section, _, name = key.rpartition("__")
        if not section:
            text, n = re.subn(rf"^{name}\s*=.*$", f"{name}={value}", text, flags=re.M)
            assert n == 1, (path, key)
            continue
        head, sep, rest = text.partition(f"[{section}]\n")
        assert sep, (path, key)
        body, nxt, tail = rest.partition("\n[")
        body, n = re.subn(rf"^{name}\s*=.*$", f"{name}={value}", body, flags=re.M)
        text = head + sep + ("" if n else f"{name}={value}\n") + body + nxt + tail
    text = re.sub(r"^\[mpi\]\s*\n(m[xyz]=\d+\s*\n)*", "", text, flags=re.M)
    if topo is not None:
        mx, my, mz = topo
        text += f"\n[mpi]\nmx={mx}\nmy={my}\nmz={mz}\n"
    if "[implementation]" in text:
        return text.replace("[implementation]", f"[implementation]\ndtype={dtype}", 1)
    return text + f"\n[implementation]\ndtype={dtype}\n"


# tests/test_parallel.py:44-79 (MHD3D_INI) and :319-370 (the forced gravity run)
FIELDLOOP_INI = """
[run]
tend=10.0
[mesh]
nx=32
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
problem=FieldLoop
cfl=0.4
nu=0.003
gamma0=1.666
slope_type=2.0
riemannSolver=hlld
smallr=1e-7
smallc=1e-7
[MHD]
enable=true
eta=0.005
magRiemannSolver=hlld
[FieldLoop]
radius=0.3
amplitude=0.001
vflow=1.0
amp=0.0
"""
GRAVITY_INI = """
[run]
tend=10.0
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
problem=turbulence
riemannSolver=hllc
cfl=0.5
[turbulence]
density=1.0
pressure=1.0
machNumber=1.0
edot=0.5
[gravity]
static_field_z=-0.1
"""
# tests/test_torch_sharded.py's MRI input (16 x 32 x 16, cIso = 1) with nu
# and eta: nu dt (1/dx^2 + 1/dy^2 + 1/dz^2) ~ 0.01, far below 0.5
MRI_INI = """
[run]
tend=10.0
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
cIso=1.0
nu=1e-3
slope_type=2.0
riemannSolver=hlld
smallr=1e-8
smallc=1e-8
[MHD]
enable=true
eta=1e-3
magRiemannSolver=hlld
omega0=1.0
[MRI]
density=1.0
beta=400.0
type=noflux
amp=0.01
seed=3
"""

# (a)
FORCED = {
    "static-mhd": ini("data/turbulence_mhd_mpi.ini", (2, 2, 1)),
    "static-hydro": ini("data/turbulence_hydro_mpi.ini", (2, 2, 1), edot=0.5),
    "ou-hydro": ini("data/turbulence_hydro_ou.ini", (2, 2, 1), (16, 16, 16)),
    "static-gravity": ini(GRAVITY_INI, (2, 2, 1)),
}
# (b), from a perturbed state
DISSIP_INPUTS = {
    "fieldloop": FIELDLOOP_INI,
    "briowu": ini("data/testRiemannHLLD.ini", None, (16, 8, 8), hydro__nu=2e-3, MHD__eta=2e-3),
    "implode": ini("data/implode3d.ini", None, (16, 8, 8), hydro__nu=2e-3),
}
DISSIP = {f"{name}-{''.join(map(str, topo))}": ini(DISSIP_INPUTS[name], topo)
          for name, topo in (("fieldloop", (1, 2, 2)), ("briowu", (2, 2, 1)),
                             ("implode", (1, 2, 2)))}
MRI = {"mri-212": ini(MRI_INI, (2, 1, 2))}
# (d): single-device hydro with nu, against JAX kernel=jnp
SINGLE = {
    "implode": ini("data/implode3d.ini", None, (16, 8, 8), hydro__nu=2e-3),
    "forced": ini("data/turbulence_hydro.ini", None, (16, 16, 16), edot=0.5, hydro__nu=2e-3),
}
SHIPPED = {"hydro": "data/turbulence_hydro_mpi.ini", "mhd": "data/turbulence_mhd_mpi.ini"}
HISTORY_INI = ini("data/turbulence_mhd_mpi.ini", (2, 2, 1), history__enabled="yes",
                  history__dtHist=0.0, run__noutput=1)


def topo_of(text: str):
    return tuple(int(re.search(rf"^{k}=(\d+)", text, re.M).group(1)) for k in ("mx", "my", "mz"))


def perturbed(U0) -> np.ndarray:
    """U0 times (1 + 0.01 N(0, 1)) from a numpy seed."""
    rng = np.random.default_rng(17)
    return (U0 * (1 + 0.01 * rng.standard_normal(U0.shape))).astype(U0.dtype)


def shear_t0(params) -> float:
    """A start time whose shear offset is 2.5 cells."""
    return 2.5 * params.dy / (1.5 * params.omega0 * (params.xmax - params.xmin))


def jax_references() -> dict:
    """Every JAX reference of this file (run in the JAX subprocess)."""
    import jax
    import jax.numpy as jnp

    from ramsesgpu_tpu.config.configmap import ConfigMap
    from ramsesgpu_tpu.config.params import params_from_config
    from ramsesgpu_tpu.ops import forcing as fz
    from ramsesgpu_tpu.parallel.mesh import make_mesh
    from ramsesgpu_tpu.parallel.sharded_step import (make_sharded_advance_n,
                                                     make_sharded_forced_advance_n,
                                                     shard_global_state)
    from ramsesgpu_tpu.problems import init_problem
    from ramsesgpu_tpu.solvers.boundary import make_boundaries
    from ramsesgpu_tpu.solvers.step import make_advance_n, make_forced_advance_n

    out = {}
    n = jnp.array(N_STEPS, jnp.int32)
    for name, text in FORCED.items():
        config = ConfigMap(text=text)
        params = params_from_config(config)
        U0 = np.asarray(init_problem(params, config))
        mesh = make_mesh(*topo_of(text))
        advance, fstate = make_sharded_forced_advance_n(params, mesh, config)
        Us = shard_global_state(params, mesh, U0)
        U, fstate_f, t, k = advance(Us, fstate, jnp.asarray(0.0, Us.dtype), n)
        out.update({name + "_U0": U0, name + "_U": np.asarray(U), name + "_t": np.asarray(t),
                    name + "_k": np.asarray(k)})
        if "key" in fstate:
            key, draws = fstate["key"], []
            for _ in range(N_STEPS):
                key, sub = jax.random.split(key)
                draws.append(np.asarray(jax.random.normal(sub, (3, fz.N_MODE_OU))))
            out[name + "_draws"] = np.stack(draws)
            out[name + "_field"] = np.asarray(fstate_f["forcingField"])
    for cases, steps in ((DISSIP, N_STEPS), (MRI, N_MRI)):
        for name, text in cases.items():
            config = ConfigMap(text=text)
            params = params_from_config(config)
            U0 = np.asarray(init_problem(params, config))
            t0 = shear_t0(params) if cases is MRI else 0.0
            if cases is DISSIP:
                U0 = perturbed(U0)
            mesh = make_mesh(*topo_of(text))
            Us = shard_global_state(params, mesh, U0)
            U, t, k = make_sharded_advance_n(params, mesh, config)(
                Us, jnp.asarray(t0, Us.dtype), jnp.array(steps, jnp.int32))
            out.update({name + "_U0": U0, name + "_t0": np.float64(t0),
                        name + "_U": np.asarray(U), name + "_t": np.asarray(t),
                        name + "_k": np.asarray(k)})
    for name, text in SINGLE.items():
        config = ConfigMap(text=text.replace("[implementation]", "[implementation]\nkernel=jnp"))
        params = params_from_config(config)
        U0 = np.asarray(init_problem(params, config))
        U0 = perturbed(U0) if name == "implode" else U0
        Ug = make_boundaries(params, jnp.asarray(U0))
        t0 = jnp.asarray(0.0, U0.dtype)
        # under its jit: a third less CPU than op by op here
        if name == "forced":
            advance, fstate = make_forced_advance_n(params, config)
            U, _f, t, k = advance(Ug, fstate, t0, n)
        else:
            U, t, k = make_advance_n(params, config)(Ug, t0, n)
        g = params.ghost_width
        out.update({name + "_single_U0": U0,
                    name + "_single_U": np.asarray(U)[:, g:-g, g:-g, g:-g],
                    name + "_single_t": np.asarray(t), name + "_single_k": np.asarray(k)})
    return out


_JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = " ".join(
    f for f in (os.environ.get("XLA_FLAGS"), "--xla_force_host_platform_device_count=8") if f)
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
sys.path.insert(0, sys.argv[1])
import test_torch_sharded_dissip_forced as T
np.savez(sys.argv[2], **T.jax_references())
"""


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.square(a - b).sum())) / (float(np.sqrt(np.square(b).sum())) or 1.0)


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_dissip_forced")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("JAX_PLATFORMS", None)
    flags = ("--xla_backend_optimization_level=0 --xla_cpu_multi_thread_eigen=false "
             "--xla_cpu_use_fusion_emitters=false")
    env["XLA_FLAGS"] = " ".join(f for f in (env.get("XLA_FLAGS"), flags) if f)
    res = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(REPO / "tests"),
                          str(tmp / "refs.npz")], capture_output=True, text=True, env=env,
                         timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    return dict(np.load(tmp / "refs.npz"))


def rank_jobs_cli(jobs: list) -> list:
    """One rank of the world (a spawned process): each job in turn, the
    CLI's ``main(argv)`` in ``workdir`` (``{"argv", "workdir"}``; this
    process joins as one rank, as under torchrun) or parallel/
    sharded_step.py rank_advance's keyword arguments."""
    from ramsesgpu_tpu_torch.cli.main import main
    from ramsesgpu_tpu_torch.parallel.sharded_step import rank_advance

    out = []
    for job in jobs:
        if "argv" in job:
            os.chdir(job["workdir"])
            out.append({"rc": main(job["argv"])})
        else:
            out.append(rank_advance(**job))
    return out


@pytest.fixture(scope="module")
def port_runs(jax_refs, tmp_path_factory):
    """Every sharded run of this file in one world of 4 gloo ranks: rank
    0's results by name, every rank's, and the CLI runs' directories."""
    from ramsesgpu_tpu_torch.parallel.launch import spawn_ranks

    names, jobs = [], []
    for name in list(FORCED) + list(DISSIP) + list(MRI):
        text = {**FORCED, **DISSIP, **MRI}[name]
        names.append(name)
        jobs.append(dict(config_text=text, device="cpu",
                         n_steps=N_MRI if name in MRI else N_STEPS, U0=jax_refs[name + "_U0"],
                         t0=float(jax_refs.get(name + "_t0", 0.0)),
                         ou_draws=jax_refs.get(name + "_draws")))
    dirs = {}
    for name, path in list(SHIPPED.items()) + [("history", None)]:
        dirs[name] = tmp_path_factory.mktemp(f"cli_{name}")
        if path is None:
            path = dirs[name] / "input.ini"
            path.write_text(HISTORY_INI)
        names.append("cli-" + name)
        argv = ["--param", str(REPO / path), "--device", "cpu", "--max-steps", str(N_STEPS)]
        jobs.append(dict(argv=argv + (["--no-output"] if name == "history" else []),
                         workdir=str(dirs[name])))
    per_rank = spawn_ranks(rank_jobs_cli, 4, (jobs,))
    return dict(zip(names, per_rank[0])), [dict(zip(names, r)) for r in per_rank], dirs


def port(text):
    from ramsesgpu_tpu_torch.config.configmap import ConfigMap
    from ramsesgpu_tpu_torch.config.params import params_from_config

    config = ConfigMap(text=text)
    return params_from_config(config), config


def check_run(name, want_U, want_t, want_k, got, tol, tol_t):
    assert got["k"] == int(want_k)
    err = rel_l2(got["U"], want_U)
    print(f"{name}: relative L2 {err:.3e}, t {got['t']!r} vs {float(want_t)!r}")
    assert abs(got["t"] - float(want_t)) <= tol_t * abs(float(want_t))
    assert err <= tol


@pytest.mark.parametrize("name", list(FORCED))
def test_sharded_forced_advance_matches_jax(name, jax_refs, port_runs):
    """(a) The forced sharded advance against JAX's, and the OU mode field
    every rank carries."""
    got = port_runs[0][name]
    check_run(name, jax_refs[name + "_U"], jax_refs[name + "_t"], jax_refs[name + "_k"], got,
              TOL, TOL_T)
    assert got["k"] == N_STEPS
    if name + "_field" in jax_refs:
        for r in port_runs[1]:
            assert rel_l2(r[name]["forcingField"], jax_refs[name + "_field"]) <= TOL
    assert all(not any(r[name]["counts"].values()) for r in port_runs[1])


@pytest.mark.parametrize("name", list(DISSIP) + list(MRI))
def test_sharded_dissipation_matches_jax(name, jax_refs, port_runs):
    """(b), (c) The sharded dissipation against JAX's sharded advance; the
    ranks' twins count no launch."""
    got = port_runs[0][name]
    mri = name in MRI
    check_run(name, jax_refs[name + "_U"], jax_refs[name + "_t"], jax_refs[name + "_k"], got,
              TOL_MRI if mri else TOL, TOL_T if mri else 0.0)
    assert got["k"] == (N_MRI if mri else N_STEPS)
    assert all(not any(r[name]["counts"].values()) for r in port_runs[1])


@pytest.mark.parametrize("name", list(SINGLE))
def test_single_device_hydro_viscosity_matches_jax(name, jax_refs):
    """(d) One-device hydro with nu (the ghosted loop: step, refill,
    viscous sub-step; forced: then the kick) against JAX kernel=jnp."""
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries
    from ramsesgpu_tpu_torch.solvers.step import make_advance_n, make_forced_advance_n

    params, config = port(SINGLE[name])
    U0 = make_boundaries(params, torch.from_numpy(jax_refs[name + "_single_U0"]))
    t0 = torch.zeros((), dtype=U0.dtype)
    if name == "forced":
        U, t, k = make_forced_advance_n(params, "cpu", config)[0](U0, t0, N_STEPS)
    else:
        U, t, k = make_advance_n(params, "cpu", config)(U0, t0, N_STEPS)
    g = params.ghost_width
    check_run(name, jax_refs[name + "_single_U"], jax_refs[name + "_single_t"],
              jax_refs[name + "_single_k"],
              {"U": U[:, g:-g, g:-g, g:-g].numpy(), "t": float(t), "k": int(k)}, TOL, TOL_T)


@pytest.mark.parametrize("topo", [(2, 2, 1), (1, 2, 2)])
def test_rank_forcing_blocks_are_global_slices(topo):
    """(e) Each rank's OU basis block (built from the sliced global
    coordinates) and static field block, bitwise the global ones' slices."""
    from ramsesgpu_tpu_torch.ops.forcing import (OUForcingParams, StaticForcing,
                                                 init_ou_forcing, ou_phase_basis)
    from ramsesgpu_tpu_torch.parallel.mesh import ProcessGrid, block_slices

    params, config = port(ini("data/turbulence_mhd_mpi.ini", topo, (8, 12, 16)))
    state = init_ou_forcing(OUForcingParams(), dtype=torch.float32)
    basis = ou_phase_basis(params, state, torch.float32)
    static = StaticForcing(params, config, "cpu", torch.float64).F
    for rank in range(4):
        grid = ProcessGrid(*topo, rank, "gloo", torch.device("cpu"))
        block = block_slices(params, grid, rank)
        assert torch.equal(ou_phase_basis(params, state, torch.float32, block=block),
                           basis[block])
        part = StaticForcing(params, config, "cpu", torch.float64, block=block).F
        assert part.is_contiguous() and torch.equal(part, static[block])


@pytest.mark.parametrize("name", list(SHIPPED))
def test_cli_runs_shipped_input(name, port_runs):
    """(f) Both turbulence [mpi] inputs as shipped through the CLI on the 4
    ranks: the HDF5 state at step 3 (every rank exits 0, rank 0 writes one
    global file) against the port's single-device run of the input
    without [mpi]."""
    from ramsesgpu_tpu_torch.io.hdf5 import input_hdf5
    from ramsesgpu_tpu_torch.problems import init_problem
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries
    from ramsesgpu_tpu_torch.solvers.step import make_forced_advance_n

    assert all(r["cli-" + name]["rc"] == 0 for r in port_runs[1])
    text = (REPO / SHIPPED[name]).read_text()
    params, _ = port(text)
    prefix = re.search(r"^outputPrefix=(\S+)", text, re.M).group(1)
    U, t, step = input_hdf5(params, port_runs[2][name] / f"{prefix}_{N_STEPS:07d}.h5")
    g = params.ghost_width
    got = U[:, g:-g, g:-g, g:-g]
    single_params, config = port(ini(text, None, dtype="float32"))
    U0 = make_boundaries(single_params, torch.from_numpy(init_problem(single_params, config)))
    Us, ts, ks = make_forced_advance_n(single_params, "cpu", config)[0](
        U0, torch.zeros((), dtype=U0.dtype), N_STEPS)
    want = Us[:, g:-g, g:-g, g:-g].numpy()
    err = rel_l2(got, want)
    print(f"{name}: as shipped, relative L2 against the single-device run {err:.3e}")
    assert step == N_STEPS and np.isfinite(got).all() and got[0].min() > 0
    assert abs(t - float(ts)) <= 1e-6 * float(ts) and err <= TOL_F32


def test_cli_history_matches_single_device(port_runs, tmp_path, monkeypatch):
    """(f) [history] enabled in the distributed run: rank 0 alone writes
    one sample a chunk (a header and 3 lines), equal to the single-device
    run's within TOL_HIST of each channel's scale (the larger of its
    largest value and, for divB, max|B| / dx)."""
    from ramsesgpu_tpu_torch.io.history import read_history
    from ramsesgpu_tpu_torch.solvers.run import Run

    assert all(r["cli-history"]["rc"] == 0 for r in port_runs[1])
    path = port_runs[2]["history"] / "turbulence_mhd_cpu.history"
    lines = path.read_text().splitlines()
    assert len(lines) == 1 + N_STEPS and lines[0].startswith("#")
    monkeypatch.chdir(tmp_path)
    params, config = port(ini(HISTORY_INI, None))
    Run(config, "cpu", params).start(max_steps=N_STEPS, do_output=False)
    want, got = read_history(tmp_path / "turbulence_mhd_cpu.history"), read_history(path)
    assert list(got) == list(want)
    for key, values in want.items():
        scale = max(abs(v) for v in values + got[key])
        if key.startswith("divB"):
            scale = max(scale, 1.0 / params.dx)
        diff = max(abs(a - b) for a, b in zip(got[key], values))
        assert diff <= TOL_HIST * scale, (key, got[key], values)
