"""The port's sharded shearing box against the JAX package on the CPU:
TPU row 4 (pallas/fused_mhd3d.py:587 make_fused_mhd_shear) and the
distributed MRI over torch.distributed.

(a) The row-4 twin (solvers/godunov_mhd.py mhd_3d_shear_window_update,
    through the kernel wrapper, whose CPU path runs it) against JAX
    ``mhd_3d_interior_update(params, U, dt, margin=(g, g, g),
    shear_planes=True, xpos=..., gravity=...)``, the body of the Pallas
    kernel, under its own jit, on one ghosted window of a rank with
    x0 != xmin (stratified: z0 != zmin too), from a numpy seed: the
    interior within relative L2 1e-12 (f64) / 1e-6 (f32), each of the five
    planes within TOL_PLANES (1e-12 / 1e-4: they are differences of much
    larger terms); the ghosted-shear CFL twin within rtol 1e-14 (f64) /
    1e-6 (f32) of JAX compute_inv_dt_mhd.
(b) The window mode of csrc/mhd_step.cu and the ghosted-shear CFL of
    csrc/cfl_mhd.cu, built with g++ (``build("host")``), against the
    twins in f64: the step within relative L2 1e-13, the CFL bitwise.
(c) The port's sharded advance (4 gloo processes on the CPU, file://
    init, all cases in one world) against JAX ``make_sharded_advance_n``
    on the 8-device virtual CPU mesh (tests/conftest.py), same topology,
    same state, f64, 4 steps from a t0 whose shear offset is 2.5 cells:
    the ideal MRI at (2, 2, 1), (2, 1, 2) and (4, 1, 1) (x ranks that are
    neither domain edge), the stratified MRI at (2, 1, 2). The JAX side
    runs kernel=auto, on the CPU its whole-array route, which (a) holds
    equal to its kernel route's body. Equal t and k; the state within
    relative L2 1e-13.
(d) DistributedRun through the CLI on the shipped
    data/mhd_mri_3d_mpi_debug.ini (it spawns its 4 ranks), 3 steps on the
    CPU: its gathered HDF5 interior equals the gathered state of the same
    run in (c)'s world.
(e) The transport rule and the WORLD_SIZE check; sharded configurations
    outside the slice raise NotImplementedError naming the ROADMAP item.

Every JAX reference comes from one subprocess with jax_enable_x64 and the
8 virtual devices (float32 arrays stay float32), on a quick single-threaded
XLA backend without its fusion emitters (the arrays agree with the default
backend's to 1e-16 relative; a quarter of the CPU time).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
N_STEPS = 4
TOL_WINDOW = {"float32": 1e-6, "float64": 1e-12}
# each x-face plane before the remap on its own: differences of much larger
# terms (tests/test_torch_cuda.py TOL_PLANES)
TOL_PLANES = {"float32": 1e-4, "float64": 1e-12}
TOL_INV = {"float32": 1e-6, "float64": 1e-14}
TOL_HOST = 1e-13
TOL_SHARDED = 1e-13
CASES = {"mri-221": ("mri", (2, 2, 1)), "mri-212": ("mri", (2, 1, 2)),
         "mri-411": ("mri", (4, 1, 1)), "strat-212": ("strat", (2, 1, 2))}
WINDOWS = [(kind, dtype) for kind in ("mri", "strat") for dtype in ("float32", "float64")]
DEBUG_INI = REPO / "data" / "mhd_mri_3d_mpi_debug.ini"

# tests/test_parallel.py's MRI and stratified MRI inputs (16 x 32 x 16)
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
slope_type=2.0
riemannSolver=hlld
smallr=1e-8
smallc=1e-8
[MHD]
enable=true
magRiemannSolver=hlld
omega0=1.0
[MRI]
density=1.0
beta=400.0
type=noflux
amp=0.01
seed=3
"""
STRAT_INI = """
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
zmin=-1.0
zmax=1.0
boundary_xmin=4
boundary_xmax=4
boundary_ymin=3
boundary_ymax=3
boundary_zmin=6
boundary_zmax=6
[hydro]
problem=MRI
cfl=0.4
gamma0=1.001
cIso=0.3
slope_type=2.0
riemannSolver=hlld
smallr=1e-8
smallc=1e-8
[MHD]
enable=true
magRiemannSolver=hlld
omega0=1.0
[MRI]
density=1.0
beta=100.0
type=none
amp=0.01
seed=12
smoothGravity=true
zFloor=4.0
[gravity]
static=yes
"""


def ini(kind: str, dtype: str, topo) -> str:
    base = MRI_INI if kind == "mri" else STRAT_INI
    mx, my, mz = topo
    return base + f"\n[implementation]\ndtype={dtype}\n[mpi]\nmx={mx}\nmy={my}\nmz={mz}\n"


# the window of rank (iz, iy, ix) = (1, 0, 1) of a (2, 1, 2) grid: x0 and
# z0 are not the domain's
WINDOW_TOPO, WINDOW_RANK = (2, 1, 2), (1, 0, 1)

_JAX_SCRIPT = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = " ".join(
    f for f in (os.environ.get("XLA_FLAGS"), "--xla_force_host_platform_device_count=8") if f)
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
sys.path.insert(0, sys.argv[1])
import test_torch_sharded as T
from ramsesgpu_tpu.config.configmap import ConfigMap
from ramsesgpu_tpu.config.params import params_from_config
from ramsesgpu_tpu.parallel.mesh import make_mesh
from ramsesgpu_tpu.parallel.sharded_step import make_sharded_advance_n, shard_global_state
from ramsesgpu_tpu.problems import init_problem
from ramsesgpu_tpu.solvers.godunov_mhd import mhd_3d_interior_update
from ramsesgpu_tpu.solvers.timestep import compute_inv_dt_mhd

out = {}
for kind, dtype in T.WINDOWS:
    config = ConfigMap(text=T.ini(kind, dtype, T.WINDOW_TOPO))
    params = params_from_config(config)
    W, x0, z0, gz = T.window_input(params, config, init_problem(params, config))
    lp = T.window_params(params)
    g = params.ghost_width
    xpos = jnp.asarray(x0, W.dtype) + params.dx / 2 + (
        jnp.arange(W.shape[-1], dtype=W.dtype) - g).reshape(1, 1, -1) * params.dx
    # a full-window field, as the kernel's gravity channel (fused_mhd3d.py:740-745)
    grav = None if gz is None else (None, None, jnp.broadcast_to(
        jnp.asarray(gz).reshape(-1, 1, 1), W.shape[1:]))
    inv = jax.jit(lambda W: compute_inv_dt_mhd(lp, W))(jnp.asarray(W))
    dt = params.cfl / inv
    new, fpl, eypl, ezpl = jax.jit(lambda W, dt, xpos, grav: mhd_3d_interior_update(
        lp, W, dt, margin=(g, g, g), shear_planes=True, xpos=xpos, gravity=grav))(
        jnp.asarray(W), dt, xpos, grav)
    key = f"{kind}_{dtype}"
    out[key + "_W"], out[key + "_inv"], out[key + "_dt"] = W, np.asarray(inv), np.asarray(dt)
    out[key + "_new"] = np.asarray(new)
    out[key + "_planes"] = np.concatenate(
        [np.asarray(fpl), np.asarray(eypl), np.asarray(ezpl)[None]])
for name, (kind, topo) in T.CASES.items():
    config = ConfigMap(text=T.ini(kind, "float64", topo))
    params = params_from_config(config)
    U0 = np.asarray(init_problem(params, config))
    t0 = T.shear_t0(params)
    mesh = make_mesh(*topo)
    Ug = shard_global_state(params, mesh, U0)
    U, t, k = make_sharded_advance_n(params, mesh, config)(
        Ug, jnp.asarray(t0, Ug.dtype), jnp.array(T.N_STEPS, jnp.int32))
    out[name + "_U0"], out[name + "_t0"] = U0, np.float64(t0)
    out[name + "_U"], out[name + "_t"], out[name + "_k"] = (
        np.asarray(U), np.asarray(t), np.asarray(k))
np.savez(sys.argv[2], **out)
"""


def shear_t0(params) -> float:
    """A start time whose shear offset is 2.5 cells (at t = 0 the sheared
    fill is the periodic one)."""
    return 2.5 * params.dy / (1.5 * params.omega0 * (params.xmax - params.xmin))


def window_params(params):
    """The window's RunParams (JAX sharded_step.py:420-425), for either
    package's RunParams."""
    mx, my, mz = WINDOW_TOPO
    lnx, lny, lnz = params.nx // mx, params.ny // my, params.nz // mz
    return params.replace(nx=lnx, ny=lny, nz=lnz, xmax=params.xmin + lnx * params.dx,
                          ymax=params.ymin + lny * params.dy,
                          zmax=params.zmin + lnz * params.dz)


def window_input(params, config, U0):
    """The ghosted window of rank WINDOW_RANK cut from the ghosted initial
    state U0 (numpy), times (1 + 0.01 N(0, 1)) from a numpy seed; its x0,
    z0 and, stratified, g_z of its rows (the MRI's smooth profile in
    double, rounded to the dtype)."""
    lp = window_params(params)
    g = params.ghost_width
    iz, iy, ix = WINDOW_RANK
    lnz, lny, lnx = lp.nz, lp.ny, lp.nx
    W = np.asarray(U0)[:, iz * lnz:iz * lnz + lnz + 2 * g, iy * lny:iy * lny + lny + 2 * g,
                       ix * lnx:ix * lnx + lnx + 2 * g]
    rng = np.random.default_rng(11)
    W = np.ascontiguousarray(W * (1 + 0.01 * rng.standard_normal(W.shape))).astype(U0.dtype)
    x0 = params.xmin + ix * lnx * params.dx
    z0 = params.zmin + iz * lnz * params.dz
    gz = None
    if config.get_bool("gravity", "static", False):
        zc = z0 + params.dz / 2 + (np.arange(lnz + 2 * g) - g) * params.dz
        H = params.c_iso / params.omega0
        zf = config.get_float("MRI", "zFloor", 5.0)
        gz = (-params.omega0 ** 2 * zc * np.exp(-((np.abs(zc) / (zf * H)) ** 8))).astype(U0.dtype)
    return W, x0, z0, gz


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.square(a - b).sum())) / (float(np.sqrt(np.square(b).sum())) or 1.0)


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax") / "refs.npz"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    # a quick, single-threaded backend: the suite's other workers share the
    # cores (tests/test_torch_step.py); without the fusion emitters the
    # sharded advances compile and run in a quarter of the CPU time
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


@pytest.fixture(scope="module")
def port_runs(jax_refs):
    """Every sharded run of (c) and (d) in one world of 4 gloo ranks."""
    from ramsesgpu_tpu_torch.parallel.launch import spawn_ranks
    from ramsesgpu_tpu_torch.parallel.sharded_step import rank_jobs

    jobs = [dict(config_text=ini(kind, "float64", topo), device="cpu", n_steps=N_STEPS,
                 U0=jax_refs[name + "_U0"], t0=float(jax_refs[name + "_t0"]))
            for name, (kind, topo) in CASES.items()]
    jobs.append(dict(config_text=DEBUG_INI.read_text(), device="cpu", n_steps=3))
    per_rank = spawn_ranks(rank_jobs, 4, (jobs,))
    return dict(zip(list(CASES) + ["debug"], per_rank[0])), per_rank


@pytest.mark.parametrize("kind, dtype", WINDOWS)
def test_window_twin_matches_jax(kind, dtype, jax_refs):
    """(a) Row 4's twin through its wrapper, and the ghosted-shear CFL's."""
    from ramsesgpu_tpu_torch.kernels.cfl_mhd import cfl_mhd_window
    from ramsesgpu_tpu_torch.kernels.fused_mhd3d import make_fused_mhd_shear
    from ramsesgpu_tpu_torch.kernels.mhd_step import mhd_window

    params, config = port(ini(kind, dtype, WINDOW_TOPO))
    key = f"{kind}_{dtype}"
    W, x0, z0, gz = window_input(params, config, jax_refs[key + "_W"])
    W = torch.from_numpy(jax_refs[key + "_W"])
    lp = window_params(params)
    inv = cfl_mhd_window(lp, W)
    assert abs(float(inv) / float(jax_refs[key + "_inv"]) - 1) <= TOL_INV[dtype]
    dt = torch.tensor(jax_refs[key + "_dt"])
    new, planes = mhd_window(lp, W, dt, x0, None if gz is None else torch.from_numpy(gz))
    assert rel_l2(new, jax_refs[key + "_new"]) <= TOL_WINDOW[dtype]
    for p, q in zip(planes, jax_refs[key + "_planes"]):
        assert rel_l2(p, q) <= TOL_PLANES[dtype]
    if gz is None:
        # the outside contract: (new_int, fpl, eypl, ezpl)
        out = make_fused_mhd_shear(lp, "cpu")(W, dt, x0, z0)
        assert [tuple(o.shape) for o in out] == [tuple(new.shape), (2, lp.nz, lp.ny),
                                                 (2, lp.nz, lp.ny), (lp.nz, lp.ny)]
        assert torch.equal(out[0], new) and torch.equal(out[3], planes[4])


@pytest.mark.parametrize("kind", ["mri", "strat"])
def test_window_host_build_matches_twin(kind, jax_refs):
    """(b) csrc/mhd_step.cu's window mode and csrc/cfl_mhd.cu's ghosted
    shearing-box form, built with g++, against the twins in f64."""
    from ramsesgpu_tpu_torch.kernels.build import load_library, param_block, window_block
    from ramsesgpu_tpu_torch.solvers.godunov_mhd import mhd_3d_shear_window_update
    from ramsesgpu_tpu_torch.solvers.timestep import dt_from_inv, inv_dt_mhd_ghosted_shear

    params, config = port(ini(kind, "float64", WINDOW_TOPO))
    key = f"{kind}_float64"
    _W, x0, _z0, gz = window_input(params, config, jax_refs[key + "_W"])
    W = torch.from_numpy(jax_refs[key + "_W"])
    gz = None if gz is None else torch.from_numpy(gz)
    lp = window_params(params)
    lib = load_library("host")
    dims, g = (lp.nx, lp.ny, lp.nz), lp.ghost_width
    inv = torch.zeros((), dtype=W.dtype)
    assert lib.ramses_cfl_mhd_ghosted_shear_f64(W.data_ptr(), None, None, inv.data_ptr(), *dims,
                                                g, param_block(lp), None) == 0
    inv_ref = inv_dt_mhd_ghosted_shear(lp, W)
    assert torch.equal(inv, inv_ref)
    dt = dt_from_inv(lp, inv_ref)
    want, want_planes = mhd_3d_shear_window_update(lp, W, dt, x0, gz)
    out = torch.empty_like(want)
    planes = torch.empty_like(want_planes)
    scratch = torch.empty(lib.ramses_mhd_step_window_scratch(*dims), dtype=W.dtype)
    active = torch.tensor(True)
    assert lib.ramses_mhd_step_window_f64(
        W.data_ptr(), out.data_ptr(), planes.data_ptr(), scratch.data_ptr(),
        None if gz is None else gz.data_ptr(), dt.data_ptr(), active.data_ptr(), *dims, g,
        window_block(lp, x0), None) == 0
    assert rel_l2(out, want) <= TOL_HOST
    for p, q in zip(planes, want_planes):
        assert rel_l2(p, q) <= TOL_HOST


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_advance_matches_jax(name, jax_refs, port_runs):
    """(c) The port's 4-rank sharded MRI against JAX's 8-device mesh."""
    got = port_runs[0][name]
    assert got["k"] == int(jax_refs[name + "_k"]) == N_STEPS
    assert got["t"] == float(jax_refs[name + "_t"])
    assert rel_l2(got["U"], jax_refs[name + "_U"]) <= TOL_SHARDED
    assert all(r[list(CASES).index(name)]["backend"] == "gloo" for r in port_runs[1])


def test_cli_distributed_run_writes_the_gathered_state(tmp_path, port_runs):
    """(d) The CLI spawns the shipped debug input's 4 ranks; its gathered
    HDF5 (ghostIncluded=yes) holds the state of the same run in (c)'s
    world."""
    from ramsesgpu_tpu_torch.io.hdf5 import input_hdf5

    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("WORLD_SIZE", None)
    res = subprocess.run([sys.executable, "-m", "ramsesgpu_tpu_torch.cli.main", "--param",
                          str(DEBUG_INI), "--device", "cpu", "--max-steps", "3"],
                         capture_output=True, text=True, env=env, timeout=300, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "ranks          : 2 x 2 x 1 ranks over gloo" in res.stdout
    assert "number of time steps   : 3" in res.stdout
    params, _ = port(DEBUG_INI.read_text())
    U, t, step = input_hdf5(params, tmp_path / "mhd_mri_3d_mpi_debug_0000003.h5")
    g = params.ghost_width
    want = port_runs[0]["debug"]
    assert step == 3 and t == want["t"]
    np.testing.assert_array_equal(U[:, g:-g, g:-g, g:-g], want["U"])


def test_transport_rule_and_world_size(monkeypatch):
    """(e) nccl only when every rank has a card; gloo otherwise; the
    WORLD_SIZE must be the [mpi] grid's."""
    from ramsesgpu_tpu_torch.parallel.mesh import choose_transport, init_process_group

    assert choose_transport("cpu", 4, 3) == ("gloo", torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert choose_transport("cuda", 4, 3) == ("gloo", torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert choose_transport("cuda", 4, 3) == ("nccl", torch.device("cuda", 3))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert choose_transport("cuda", 4, 3) == ("gloo", torch.device("cuda", 1))
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "3")
    with pytest.raises(ValueError, match="WORLD_SIZE 3"):
        init_process_group("cpu", (2, 2, 1))


def test_unported_sharded_configurations_raise():
    """(e) A sharded run outside the shearing box, or a dissipative one,
    raises NotImplementedError naming ROADMAP Queue 1 item 7, before any
    rank starts."""
    from ramsesgpu_tpu_torch.cli.main import main

    periodic = MRI_INI.replace("boundary_xmin=4", "boundary_xmin=3").replace(
        "boundary_xmax=4", "boundary_xmax=3").replace("omega0=1.0", "omega0=0.0").replace(
        "cIso=1.0", "cIso=0.0").replace("problem=MRI", "problem=Orszag-Tang")
    dissip = MRI_INI.replace("cIso=1.0", "cIso=1.0\nnu=1e-3")
    for text in (periodic, dissip):
        path = Path(os.environ.get("TMPDIR", "/tmp")) / f"sharded_{os.getpid()}.ini"
        path.write_text(text + "\n[mpi]\nmx=2\n")
        try:
            with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 7"):
                main(["--param", str(path), "--device", "cpu"])
        finally:
            path.unlink()


@pytest.mark.parametrize("faces", [(3,) * 6, (2, 2, 1, 1, 3, 3)])
def test_one_rank_halos_are_the_fill(faces):
    """parallel/halo.py attach_halos on a one-rank grid (every ring wraps
    onto the rank itself) is solvers/boundary.py make_boundaries: X, then
    Y, then Z, the physical fill on the domain's faces; periodic and mixed
    NEUMANN / DIRICHLET / PERIODIC faces."""
    from ramsesgpu_tpu_torch.parallel.halo import attach_halos, strip_halos
    from ramsesgpu_tpu_torch.parallel.mesh import single_rank_grid
    from ramsesgpu_tpu_torch.problems import init_problem
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries

    text = (REPO / "data" / "testRiemannHLLD.ini").read_text()
    for key, value in zip(("nx", "ny", "nz"), (8, 6, 5)):
        text = text.replace(f"\n{key}=", f"\n{key}={value}\n#", 1)
    for face, bc in zip(("xmin", "xmax", "ymin", "ymax", "zmin", "zmax"), faces):
        text = text.replace(f"\nboundary_{face}=", f"\nboundary_{face}={bc}\n#", 1)
    params, config = port(text)
    rng = np.random.default_rng(5)
    U = torch.from_numpy(init_problem(params, config))
    U = U * (1 + 0.1 * torch.from_numpy(rng.standard_normal(U.shape)).to(U.dtype))
    got = attach_halos(params, single_rank_grid(), strip_halos(params, U).contiguous())
    assert torch.equal(got, make_boundaries(params, U))
