"""The port's sharded periodic, walled and jet runs (parallel/sharded_step.py,
the counterpart of JAX ``make_local_step``) and its per-piece writers
(io/sharded.py) against the JAX package on the CPU.

(a) The port's sharded advance (one world of 4 gloo processes on the CPU,
    file:// init, every case in it) against JAX ``make_sharded_advance_n``
    on the 8-device virtual CPU mesh, the same topology and state, f64, 3
    steps: 3D MHD with NEUMANN walls (the shipped 3D Brio-Wu, perturbed)
    at (2, 2, 1) and at (1, 2, 2) so that z is exchanged, the 3D implode
    (DIRICHLET walls) at (2, 1, 2), 2D Orszag-Tang (periodic) at (2, 2), the
    2D implode at (4, 1), and the 2D MHD Rayleigh-Taylor with its static
    gravity at (2, 2). Equal k; equal t (the gravity run: within rtol
    1e-14, tests/test_torch_gravity.py's TOL_T); the interior within
    relative L2 1e-12.
    The port's 3D ranks run their kernels' twins here (the step and CFL
    kernels' ghosted modes); the JAX ranks on the CPU run the whole-array
    step.
(b) The inflow jet: the JAX sharded step has none (ROADMAP Queue 3 item
    15), so the port's sharded 2D hydro jet at (2, 2) and 3D MHD jet at (2,
    2, 1), whose jet strip or square spans the x ranks, are held against
    the JAX single-device ``make_advance_n`` (kernel=jnp, op by op) within
    tests/test_parallel.py's budget (atol 5e-6), the distance printed, and
    against the port's own single-device run within relative L2 1e-12.
(c) The writers: the ``.pvti`` master and the ``.vti`` pieces that the
    port's 4 ranks write of a state equal, byte for byte, what JAX
    ``output_vtk_pieces`` writes of it; the HDF5 file's datasets and
    attributes equal those of JAX ``output_hdf5_sharded`` but for
    ``creation date``.
(d) The CLI: ``data/orszag-tang_mpi.ini`` as shipped, 3 steps, on the 4
    ranks it spawns: its pieces and its HDF5 file reassemble to the
    gathered state of the same run in (a)'s world.
(e) Refusals: ``data/implode3d_mpi.ini`` raises the JAX package's zslab
    ValueError (local nz = 7, zSlabNb = 4); 2D viscosity, the stratified
    box with viscosity and ``haloOverlap`` raise NotImplementedError
    naming their ROADMAP items.
(f) The halo fill on a one-rank grid is make_boundaries in 2D, with the
    jet too; the in-place fill equals attach_halos.

Every JAX reference comes from one subprocess with jax_enable_x64 and the
8 virtual devices, on the quick single-threaded XLA backend without its
fusion emitters that tests/test_torch_sharded.py uses.
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
TOL_SHARDED = 1e-12
# JAX's sharded-vs-single budget (tests/test_parallel.py:83-120)
JET_ATOL = 5e-6
TOL_SELF = 1e-12
# t is equal but on the gravity run, whose single-device step already
# differs from the JAX one at ULP level (tests/test_torch_gravity.py TOL_T):
# there the dt of a later step may differ in its last bit
TOL_T = {"rt2d-22": 1e-14}


def ini(path: str, topo, mesh=None, dtype: str = "float64", **keys) -> str:
    """The shipped INI at ``path`` with [mpi] mx, my, mz = topo, the mesh
    (nx, ny, nz) and each ``key=value`` of ``keys`` replaced (the key must
    be there), and [implementation] dtype."""
    text = (REPO / path).read_text()
    sets = dict(zip(("nx", "ny", "nz"), mesh or ()), **keys)
    for key, value in sets.items():
        text, n = re.subn(rf"^{key}\s*=.*$", f"{key}={value}", text, flags=re.M)
        assert n == 1, (path, key)
    text = re.sub(r"^\[mpi\]\s*\n(m[xyz]=\d+\s*\n)*", "", text, flags=re.M)
    mx, my, mz = topo
    text += f"\n[mpi]\nmx={mx}\nmy={my}\nmz={mz}\n"
    if "[implementation]" in text:
        return text.replace("[implementation]", f"[implementation]\ndtype={dtype}", 1)
    return text + f"\n[implementation]\ndtype={dtype}\n"


# (INI, perturbed) of each case held against JAX make_sharded_advance_n
CASES = {
    "mhd3d-221": (ini("data/testRiemannHLLD.ini", (2, 2, 1), (16, 8, 8)), True),
    "mhd3d-122": (ini("data/testRiemannHLLD.ini", (1, 2, 2), (16, 8, 8)), True),
    "hydro3d-212": (ini("data/implode3d_mpi_zslab.ini", (2, 1, 2), (16, 8, 16)), True),
    "ot2d-22": (ini("data/orszag-tang_mpi.ini", (2, 2, 1), (32, 32, 1)), False),
    "implode2d-41": (ini("data/implode2d_mpi.ini", (4, 1, 1), (32, 32, 1)), False),
    "rt2d-22": (ini("data/rayleigh_taylor_2d_mpi_mhd.ini", (2, 2, 1), (16, 32, 1)), False),
}
# the jet runs, held against single-device runs: the strip (offsetJet 10,
# ijet 10: ghosted x 12 .. 21) spans both x ranks of 16 cells; the square
# (offsetJet 4, ijet 6: ghosted x and y 7 .. 12) the four ranks of 8 cells
JETS = {
    "jet2d-22": ini("data/jet2d_mpi_gpu.ini", (2, 2, 1), (32, 32, 1), offsetJet=10, ijet=10),
    "jetmhd3d-221": ini("data/jet3d_mhd_mpi_gpu.ini", (2, 2, 1), (16, 16, 8), offsetJet=4,
                        ijet=6),
}
# the states whose snapshots both packages write: (case, prefix)
WRITERS = {"ot2d-22": "ot2d", "hydro3d-212": "hydro3d"}
OT_INI = REPO / "data" / "orszag-tang_mpi.ini"


def topo_of(text: str):
    return tuple(int(re.search(rf"^{k}=(\d+)", text, re.M).group(1)) for k in ("mx", "my", "mz"))


def initial_state(init_problem, params, config, perturbed: bool) -> np.ndarray:
    """The ghosted initial state of either package's ``init_problem``, times
    (1 + 0.01 N(0, 1)) from a numpy seed where ``perturbed`` (the Brio-Wu
    tube varies along x only)."""
    U0 = np.asarray(init_problem(params, config))
    if perturbed:
        rng = np.random.default_rng(17)
        U0 = (U0 * (1 + 0.01 * rng.standard_normal(U0.shape))).astype(U0.dtype)
    return U0


def jax_references(outdir: str) -> dict:
    """Every JAX reference of this file (run in the JAX subprocess)."""
    import jax
    import jax.numpy as jnp

    from ramsesgpu_tpu.config.configmap import ConfigMap
    from ramsesgpu_tpu.config.params import params_from_config
    from ramsesgpu_tpu.io.sharded import output_hdf5_sharded, output_vtk_pieces
    from ramsesgpu_tpu.parallel.mesh import make_mesh
    from ramsesgpu_tpu.parallel.sharded_step import make_sharded_advance_n, shard_global_state
    from ramsesgpu_tpu.problems import init_problem
    from ramsesgpu_tpu.solvers.boundary import make_boundaries
    from ramsesgpu_tpu.solvers.step import make_advance_n

    out = {}
    for name, (text, perturbed) in CASES.items():
        config = ConfigMap(text=text)
        params = params_from_config(config)
        U0 = initial_state(init_problem, params, config, perturbed)
        mesh = make_mesh(*topo_of(text))
        Us = shard_global_state(params, mesh, U0)
        U, t, k = make_sharded_advance_n(params, mesh, config)(
            Us, jnp.asarray(0.0, Us.dtype), jnp.array(N_STEPS, jnp.int32))
        out.update({name + "_U0": U0, name + "_U": np.asarray(U), name + "_t": np.asarray(t),
                    name + "_k": np.asarray(k)})
        if name in WRITERS:
            output_vtk_pieces(params, Us, 0, output_dir=outdir, prefix=WRITERS[name])
            output_hdf5_sharded(params, Us, 0, total_time=0.0, output_dir=outdir,
                                prefix=WRITERS[name])
    for name, text in JETS.items():
        config = ConfigMap(text=text.replace("[implementation]", "[implementation]\nkernel=jnp"))
        params = params_from_config(config)
        U0 = initial_state(init_problem, params, config, False)
        with jax.disable_jit():
            U, t, k = make_advance_n(params, config)(
                make_boundaries(params, jnp.asarray(U0)), jnp.asarray(0.0, U0.dtype),
                jnp.array(N_STEPS, jnp.int32))
        g = params.ghost_width
        out.update({name + "_U0": U0,
                    name + "_U": np.asarray(U)[(slice(None),) + (slice(g, -g),) * params.dim],
                    name + "_t": np.asarray(t), name + "_k": np.asarray(k)})
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
import test_torch_sharded_local as T
np.savez(sys.argv[2], **T.jax_references(sys.argv[3]))
"""


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.square(a - b).sum())) / (float(np.sqrt(np.square(b).sum())) or 1.0)


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    """(references, the directory of the JAX writers' files)."""
    tmp = tmp_path_factory.mktemp("jax_local")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("JAX_PLATFORMS", None)
    flags = ("--xla_backend_optimization_level=0 --xla_cpu_multi_thread_eigen=false "
             "--xla_cpu_use_fusion_emitters=false")
    env["XLA_FLAGS"] = " ".join(f for f in (env.get("XLA_FLAGS"), flags) if f)
    (tmp / "files").mkdir()
    res = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(REPO / "tests"),
                          str(tmp / "refs.npz"), str(tmp / "files")],
                         capture_output=True, text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return dict(np.load(tmp / "refs.npz")), tmp / "files"


@pytest.fixture(scope="module")
def port_runs(jax_refs, tmp_path_factory):
    """Every sharded run of this file in one world of 4 gloo ranks: rank
    0's results by name, and the directory of the port's writers' files."""
    from ramsesgpu_tpu_torch.parallel.launch import spawn_ranks
    from ramsesgpu_tpu_torch.parallel.sharded_step import rank_jobs

    refs, _ = jax_refs
    files = tmp_path_factory.mktemp("port_local")
    names, jobs = [], []
    for name, text in [(n, c[0]) for n, c in CASES.items()] + list(JETS.items()):
        names.append(name)
        jobs.append(dict(config_text=text, device="cpu", n_steps=N_STEPS,
                         U0=refs[name + "_U0"]))
    for name, prefix in WRITERS.items():
        names.append("write-" + name)
        jobs.append(dict(config_text=CASES[name][0], device="cpu", n_steps=0,
                         U0=refs[name + "_U0"], snapshot=(str(files), prefix)))
    names.append("ot-shipped")
    jobs.append(dict(config_text=OT_INI.read_text(), device="cpu", n_steps=3))
    per_rank = spawn_ranks(rank_jobs, 4, (jobs,))
    return dict(zip(names, per_rank[0])), files, per_rank


def port(text):
    from ramsesgpu_tpu_torch.config.configmap import ConfigMap
    from ramsesgpu_tpu_torch.config.params import params_from_config

    config = ConfigMap(text=text)
    return params_from_config(config), config


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_advance_matches_jax(name, jax_refs, port_runs):
    """(a) The port's 4 ranks against JAX's sharded advance, and each 3D
    rank's launches: one ghosted step and one ghosted CFL a step (here
    the twins, which count nothing)."""
    refs, _ = jax_refs
    got = port_runs[0][name]
    assert got["k"] == int(refs[name + "_k"]) == N_STEPS
    err = rel_l2(got["U"], refs[name + "_U"])
    print(f"{name}: relative L2 {err:.3e}, t {got['t']!r} vs {float(refs[name + '_t'])!r}")
    assert abs(got["t"] - float(refs[name + "_t"])) <= TOL_T.get(name, 0.0) * got["t"]
    assert err <= TOL_SHARDED
    assert all(not any(r[list(port_runs[0]).index(name)]["counts"].values())
               for r in port_runs[2])


@pytest.mark.parametrize("name", list(JETS))
def test_sharded_jet_matches_single_device(name, jax_refs, port_runs):
    """(b) The sharded jet against the JAX single-device run (the JAX
    sharded step has no jet) and against the port's single-device run."""
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries
    from ramsesgpu_tpu_torch.solvers.step import make_advance_n

    refs, _ = jax_refs
    got = port_runs[0][name]
    assert got["k"] == int(refs[name + "_k"]) == N_STEPS
    assert abs(got["t"] / float(refs[name + "_t"]) - 1) <= 1e-12
    dist_jax = float(np.abs(got["U"] - refs[name + "_U"]).max())
    print(f"{name}: max |sharded - JAX single-device| {dist_jax:.3e} (atol {JET_ATOL})")
    assert dist_jax <= JET_ATOL
    params, config = port(JETS[name])
    U0 = make_boundaries(params, torch.from_numpy(refs[name + "_U0"]))
    U, t, k = make_advance_n(params, "cpu", config)(U0, torch.zeros((), dtype=U0.dtype),
                                                    N_STEPS)
    g = params.ghost_width
    single = U.numpy()[(slice(None),) + (slice(g, -g),) * params.dim]
    assert int(k) == got["k"] and float(t) == got["t"]
    err = rel_l2(got["U"], single)
    print(f"{name}: relative L2 against the port's single-device run {err:.3e}")
    assert err <= TOL_SELF


@pytest.mark.parametrize("name", list(WRITERS))
def test_vtk_pieces_equal_jax_bytes(name, jax_refs, port_runs):
    """(c) The .pvti and every .vti piece, byte for byte."""
    _, jax_dir = jax_refs
    port_dir = port_runs[1]
    prefix = WRITERS[name]
    want = sorted(p.name for p in jax_dir.glob(f"{prefix}_*.*vti"))
    assert want == sorted(p.name for p in port_dir.glob(f"{prefix}_*.*vti"))
    assert len(want) == 5
    for fname in want:
        assert (port_dir / fname).read_bytes() == (jax_dir / fname).read_bytes(), fname


@pytest.mark.parametrize("name", list(WRITERS))
def test_hdf5_equals_jax(name, jax_refs, port_runs):
    """(c) The HDF5 datasets and attributes (but the creation date), and
    the XDMF wrapper."""
    import h5py

    _, jax_dir = jax_refs
    port_dir = port_runs[1]
    fname = f"{WRITERS[name]}_0000000"
    with h5py.File(port_dir / f"{fname}.h5") as a, h5py.File(jax_dir / f"{fname}.h5") as b:
        assert sorted(a) == sorted(b)
        for key in b:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key][()], b[key][()])
        attrs = sorted(set(b.attrs) - {"creation date"})
        assert sorted(set(a.attrs) - {"creation date"}) == attrs
        for key in attrs:
            assert a.attrs[key] == b.attrs[key] and a.attrs[key].dtype == b.attrs[key].dtype
    assert (port_dir / f"{fname}.xmf").read_bytes() == (jax_dir / f"{fname}.xmf").read_bytes()


def test_cli_writes_pieces_of_the_gathered_state(tmp_path, port_runs, monkeypatch):
    """(d) The shipped 2D Orszag-Tang [mpi] input through the CLI's main()
    on the 4 ranks it spawns, 3 steps: its .pvti pieces and its HDF5 file
    at step 3 hold the gathered state of the same run in (a)'s world."""
    from ramsesgpu_tpu_torch.cli.main import main
    from ramsesgpu_tpu_torch.core.constants import var_names
    from ramsesgpu_tpu_torch.io.hdf5 import input_hdf5
    from ramsesgpu_tpu_torch.io.vtk import read_pvti

    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert main(["--param", str(OT_INI), "--device", "cpu", "--max-steps", "3"]) == 0
    want = port_runs[0]["ot-shipped"]
    params, _ = port(OT_INI.read_text())
    prefix = "orszag-tang2d_mpi_0000003"
    pieces = read_pvti(tmp_path / f"{prefix}.pvti")
    np.testing.assert_array_equal(
        np.stack([pieces[n] for n in var_names(params.nb_var)]), want["U"])
    U, t, step = input_hdf5(params, tmp_path / f"{prefix}.h5")
    g = params.ghost_width
    assert step == 3 and t == want["t"]
    np.testing.assert_array_equal(U[:, g:-g, g:-g], want["U"])
    assert (tmp_path / f"{prefix}.xmf").exists()
    assert len(list(tmp_path.glob("orszag-tang2d_mpi_0000000_p*.vti"))) == 4


REFUSED = {
    "zslab": ("data/implode3d_mpi.ini", "", ValueError,
              r"local nz=7 \(nz=14 over mz shards\) not divisible by zSlabNb=4"),
    # 2D viscosity, refused on one device too (the 3D sharded dissipation
    # runs: tests/test_torch_sharded_dissip_forced.py)
    "dissipation": ("data/orszag-tang_mpi.ini", "[hydro]\nnu=1e-3\n", NotImplementedError,
                    r"2D viscosity / resistivity \(ROADMAP Queue 1 item 3\.2\)"),
    # the stratified box with viscosity, refused on one device too (the
    # sharded forcing runs: tests/test_torch_sharded_dissip_forced.py)
    "forcing": ("data/mhd_mri_3d_stratified_mpi.ini", "[hydro]\nnu=1e-3\n", NotImplementedError,
                r"stratified z faces \(ROADMAP Queue 1 item 4\)"),
    "overlap": ("data/orszag-tang_mpi.ini", "[implementation]\nhaloOverlap=yes\n",
                NotImplementedError, r"haloOverlap \(ROADMAP Queue 1 item 7\.5\)"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_refused_before_any_rank_starts(case, tmp_path):
    """(e) The refusals, raised by the CLI before it spawns a rank."""
    from ramsesgpu_tpu_torch.cli.main import main

    path, extra, exc, match = REFUSED[case]
    text = (REPO / path).read_text()
    if extra:
        section, line = extra.split("\n", 1)
        text = text.replace(section, extra.rstrip("\n"), 1) if section in text else text + extra
    param = tmp_path / "input.ini"
    param.write_text(text)
    with pytest.raises(exc, match=match):
        main(["--param", str(param), "--device", "cpu"])


@pytest.mark.parametrize("name", ["jet2d-22", "rt2d-22"])
def test_one_rank_halos_are_the_fill_2d(name):
    """(f) attach_halos on a one-rank grid is make_boundaries in 2D (the
    jet's strip included), and fill_halos_ then attach_jet in place equal
    it."""
    from ramsesgpu_tpu_torch.parallel.halo import (attach_halos, attach_jet, fill_halos_,
                                                   strip_halos)
    from ramsesgpu_tpu_torch.parallel.mesh import single_rank_grid
    from ramsesgpu_tpu_torch.problems import init_problem
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries

    params, config = port(JETS.get(name) or CASES[name][0])
    rng = np.random.default_rng(3)
    U = torch.from_numpy(initial_state(init_problem, params, config, False))
    U = U * (1 + 0.1 * torch.from_numpy(rng.standard_normal(U.shape)).to(U.dtype))
    want = make_boundaries(params, U)
    got = attach_halos(params, single_rank_grid(), strip_halos(params, U).contiguous())
    assert torch.equal(got, want)
    grid = single_rank_grid()
    assert torch.equal(attach_jet(params, grid, fill_halos_(params, grid, U.clone())), want)


def test_jet_window_is_the_single_device_strip():
    """(f) make_jet on a block at a global offset writes the single-device
    jet's cells that fall in the block's ghosted window, ghost columns
    included, and no others."""
    from ramsesgpu_tpu_torch.solvers.boundary import make_jet

    params, _ = port(JETS["jetmhd3d-221"])
    g = params.ghost_width
    full = make_jet(params, torch.zeros(params.shape, dtype=torch.float64))
    lny, lnx = params.ny // 2, params.nx // 2
    for iy in range(2):
        for ix in range(2):
            block = torch.zeros((8, params.nz + 2 * g, lny + 2 * g, lnx + 2 * g),
                                dtype=torch.float64)
            make_jet(params, block, origin=(iy * lny, ix * lnx))
            window = full[:, :, iy * lny:iy * lny + lny + 2 * g, ix * lnx:ix * lnx + lnx + 2 * g]
            assert torch.equal(block, window)
            assert bool(block.any())
