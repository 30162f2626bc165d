"""The port's analysis tools (analysis/*), the live view (gui/live_view.py),
the step profiler, the flop accounting and the memory planner
(utils/{profile,flops,memory_footprint}.py), on the CPU.

The JAX references run in one subprocess with jax_enable_x64. Pass
criteria:

- power_spectrum and velocity_power_spectrum of seeded fields at 32^3
  against the JAX functions within TOL (relative L2), the bins bitwise;
  the fBm slope check of tests/test_analysis.py:25 on the port's tools;
- compute_structure_functions of the 16^3 blast state of
  tests/test_analysis.py (8 samples, max_q 3) against JAX's: distances and
  counts bitwise, the sums within TOL; the same state in f32 against the
  f64 result within SF_F32_TOL (rho^1/3 is pow, not cbrt, and the
  increments are float32 sums);
- the sharded structure functions on 4 gloo ranks (2x2x1) against the
  port's single device within TOL, and the distributed --profile of an
  [mpi] input in the same world;
- projected_density, read_slice and generate_fbm bitwise the JAX ones;
- the live view's PNG frames of a 2D run and one animate_snapshots gif;
- --profile printing the JAX phase names;
- step_cost: the counting build's operations of the kernels each
  configuration launches (kernels/build.py build("count"));
- the planner's state, loop-state and buffer bytes equal to the tensors
  the port's CPU loops allocate, and its stage-buffer sizes to the step
  kernel's own (the host build's entry points).
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
TOL = 1e-12
# an f32 state's structure functions against the f64 ones (relative L2 of
# each type's sums over the bins; 2.2e-8 to 3.7e-8 measured on the blast
# state: the state's rounding to f32 and the f32 increments)
SF_F32_TOL = 1e-6
SF_SAMPLES, SF_MAXQ = 8, 3

BLAST_INI = (REPO / "tests" / "test_analysis.py").read_text().split(
    'MINI_INI = """')[1].split('"""')[0] + "\n[implementation]\ndtype={dtype}\n"
OT_INI = (REPO / "chip_smoke.py").read_text().split('INI = """')[1].split('"""')[0]


def field32() -> np.ndarray:
    return np.random.default_rng(31).normal(size=(32, 32, 32))


def blast(pkg: str, dtype: str = "float64", n: int = 16):
    """(params, the ghosted blast state numpy) in the package ``pkg``, its
    density and velocity made non-trivial by seeded fields."""
    import importlib

    mod = lambda m: importlib.import_module(f"{pkg}.{m}")  # noqa: E731
    text = BLAST_INI.format(dtype=dtype).replace("nx=16\nny=16\nnz=16", f"nx={n}\nny={n}\nnz={n}")
    config = mod("config.configmap").ConfigMap(text=text)
    params = mod("config.params").params_from_config(config)
    U = np.asarray(mod("problems").init_problem(params, config)).astype(np.float64)
    rng = np.random.default_rng(5)
    U[0] = U[0] * rng.uniform(0.5, 1.5, U[0].shape)
    for c in (2, 3, 4):
        U[c] = U[0] * rng.normal(0.0, 0.4, U[0].shape)
    return params, U.astype(np.float64 if dtype == "float64" else np.float32)


def jax_references(workdir: str) -> dict:
    import jax

    from ramsesgpu_tpu.analysis.generate_fbm import generate_fbm
    from ramsesgpu_tpu.analysis.power_spectrum import power_spectrum, velocity_power_spectrum
    from ramsesgpu_tpu.analysis.projected_density import projected_density
    from ramsesgpu_tpu.analysis.read_slice import read_slice
    from ramsesgpu_tpu.analysis.structure_functions import compute_structure_functions

    jax.config.update("jax_enable_x64", True)
    out = {}
    out["ps_k"], out["ps_ek"] = power_spectrum(field32())
    params, U = blast("ramsesgpu_tpu", n=32)
    out["vps_k"], out["vps_ek"] = velocity_power_spectrum(params, U)
    params, U = blast("ramsesgpu_tpu")
    for key, value in compute_structure_functions(params, U, SF_SAMPLES, SF_MAXQ).items():
        out[f"sf_{key}"] = value
    for axis in "xyz":
        out[f"proj_{axis}"] = projected_density(params, U, axis)
    for axis in "xyz":
        out[f"slice_{axis}"] = read_slice(str(Path(workdir) / "s_0000000.h5"), "density", axis, 5)
    out["fbm"] = generate_fbm((16, 12), hurst=0.3, seed=4)
    return out


_JAX_SCRIPT = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
sys.path.insert(0, sys.argv[1])
import test_torch_analysis as m
np.savez(sys.argv[2], **m.jax_references(sys.argv[3]))
"""


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """The port's HDF5 snapshot of the blast state (s_0000000.h5)."""
    from ramsesgpu_tpu_torch.io.hdf5 import output_hdf5

    work = tmp_path_factory.mktemp("snap")
    params, U = blast("ramsesgpu_tpu_torch")
    output_hdf5(params, U, 0, output_dir=str(work), prefix="s")
    return work


@pytest.fixture(scope="module")
def jax_refs(snapshot):
    """Every JAX reference of this file, from one subprocess."""
    out = snapshot / "ref.npz"
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    flags = ("--xla_backend_optimization_level=0 --xla_cpu_multi_thread_eigen=false "
             "--xla_cpu_use_fusion_emitters=false")
    env["XLA_FLAGS"] = " ".join(f for f in (env.get("XLA_FLAGS"), flags) if f)
    res = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(REPO / "tests"), str(out),
                          str(snapshot)], capture_output=True, text=True, env=env, timeout=600)
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


# -------------------------------------------------------------------------
# power spectrum, fBm, projections, slices
# -------------------------------------------------------------------------
def test_power_spectra_match_jax(jax_refs):
    from ramsesgpu_tpu_torch.analysis.power_spectrum import power_spectrum, velocity_power_spectrum

    k, ek = power_spectrum(torch.from_numpy(field32()))
    np.testing.assert_array_equal(k, jax_refs["ps_k"])
    assert ek.shape == jax_refs["ps_ek"].shape and rel_l2(ek, jax_refs["ps_ek"]) <= TOL
    params, U = blast("ramsesgpu_tpu_torch", n=32)
    k, ek = velocity_power_spectrum(params, torch.from_numpy(U))
    np.testing.assert_array_equal(k, jax_refs["vps_k"])
    assert rel_l2(ek, jax_refs["vps_ek"]) <= TOL


def test_power_spectrum_fbm_slope():
    """tests/test_analysis.py:25 on the port: an fBm field with H = 0.5
    reads back E(k) ~ k^-(2H+1)."""
    from ramsesgpu_tpu_torch.analysis.generate_fbm import generate_fbm
    from ramsesgpu_tpu_torch.analysis.power_spectrum import power_spectrum

    k, ek = power_spectrum(generate_fbm((128, 128), hurst=0.5, seed=1))
    sel = (k >= 4) & (k <= 32) & (ek > 0)
    slope = np.polyfit(np.log(k[sel]), np.log(ek[sel]), 1)[0]
    assert -2.6 < slope < -1.4, slope


def test_projection_slice_fbm_bitwise_jax(jax_refs, snapshot):
    from ramsesgpu_tpu_torch.analysis.generate_fbm import generate_fbm
    from ramsesgpu_tpu_torch.analysis.projected_density import projected_density
    from ramsesgpu_tpu_torch.analysis.read_slice import read_slice

    params, U = blast("ramsesgpu_tpu_torch")
    for axis in "xyz":
        np.testing.assert_array_equal(projected_density(params, U, axis), jax_refs[f"proj_{axis}"])
        np.testing.assert_array_equal(
            read_slice(str(snapshot / "s_0000000.h5"), "density", axis, 5),
            jax_refs[f"slice_{axis}"])
    np.testing.assert_array_equal(generate_fbm((16, 12), hurst=0.3, seed=4), jax_refs["fbm"])


# -------------------------------------------------------------------------
# structure functions
# -------------------------------------------------------------------------
def check_sf(got: dict, want: dict, tol: float) -> None:
    assert sorted(got) == sorted(want)
    for k in ("distance", "counts", "types", "max_q"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("sf_long", "sf_tran"):
        assert got[k].shape == want[k].shape and np.isfinite(got[k]).all()
        for t in range(3):
            assert rel_l2(got[k][t], want[k][t]) <= tol, (k, t, rel_l2(got[k][t], want[k][t]))


def test_structure_functions_match_jax(jax_refs):
    """16^3, 8 samples, max_q 3, f64: the JAX result; the zero-distance
    bin zero; the counts sum to samples x cells."""
    from ramsesgpu_tpu_torch.analysis.structure_functions import compute_structure_functions

    params, U = blast("ramsesgpu_tpu_torch")
    got = compute_structure_functions(params, torch.from_numpy(U), SF_SAMPLES, SF_MAXQ)
    want = {k[3:]: v for k, v in jax_refs.items() if k.startswith("sf_")}
    check_sf(got, want, TOL)
    assert got["sf_long"].dtype == np.float64 and got["counts"].sum() == SF_SAMPLES * 16 ** 3
    assert got["sf_long"][:, :, 0].max() == 0.0 and got["sf_tran"][:, :, 0].max() == 0.0


def test_structure_functions_f32_state(jax_refs):
    """The same state in f32: its means in float32, within SF_F32_TOL of
    the f64 result (the bins and counts equal; the counts in float64)."""
    from ramsesgpu_tpu_torch.analysis.structure_functions import compute_structure_functions

    params, U = blast("ramsesgpu_tpu_torch", "float32")
    got = compute_structure_functions(params, torch.from_numpy(U), SF_SAMPLES, SF_MAXQ)
    assert got["sf_long"].dtype == np.float32 and got["counts"].dtype == np.float64
    want = {k[3:]: v for k, v in jax_refs.items() if k.startswith("sf_")}
    check_sf(got, want, SF_F32_TOL)


MPI_SF_INI = BLAST_INI.format(dtype="float64") + "\n[mpi]\nmx=2\nmy=2\nmz=1\n"


def rank_world(mpi_ini: str) -> dict:
    """One rank: the sharded structure functions of the blast state, and
    the CLI's --profile of an [mpi] input (rank 0's output)."""
    from ramsesgpu_tpu_torch.analysis.structure_functions import (
        compute_structure_functions_sharded)
    from ramsesgpu_tpu_torch.cli.main import main
    from ramsesgpu_tpu_torch.parallel.mesh import init_process_group
    from ramsesgpu_tpu_torch.parallel.sharded_step import shard_global_state

    torch.set_num_threads(1)
    params, _config = port(MPI_SF_INI)
    grid = init_process_group("cpu", (2, 2, 1))
    _p, U = blast("ramsesgpu_tpu_torch")
    sf = compute_structure_functions_sharded(params, grid, shard_global_state(params, grid, U),
                                             SF_SAMPLES, SF_MAXQ)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(["--param", mpi_ini, "--device", "cpu", "--profile"]) == 0
    return {"sf": sf, "profile": buf.getvalue()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from ramsesgpu_tpu_torch.parallel.launch import spawn_ranks

    path = tmp_path_factory.mktemp("world") / "ot_mpi.ini"
    text = (REPO / "data" / "orszag-tang_mpi.ini").read_text()
    path.write_text(re.sub(r"^n([xy])=.*$", r"n\1=32", text, flags=re.M))
    return spawn_ranks(rank_world, 4, (str(path),))


def test_sharded_structure_functions_match_single_device(world):
    """4 gloo ranks on 2x2x1 blocks of the blast state: rank 0's result is
    the single device's (distances and counts bitwise, sums within TOL);
    the other ranks get None."""
    from ramsesgpu_tpu_torch.analysis.structure_functions import compute_structure_functions

    params, U = blast("ramsesgpu_tpu_torch")
    want = compute_structure_functions(params, torch.from_numpy(U), SF_SAMPLES, SF_MAXQ)
    check_sf(world[0]["sf"], want, TOL)
    assert all(r["sf"] is None for r in world[1:])


def test_profile_prints_the_jax_phase_names(world, tmp_path, capsys):
    """--profile on the CPU (the twins): the JAX phase names, "dissipative"
    with nu and eta; on an [mpi] input (4 ranks) the distributed phases and
    the JAX line on halo overlap."""
    from ramsesgpu_tpu_torch.cli.main import main

    path = tmp_path / "ot.ini"
    text = OT_INI.format(n=8, dtype="float64").replace("smallc=1e-7", "smallc=1e-7\nnu=1e-3")
    path.write_text(text.replace("magRiemannSolver=hlld", "magRiemannSolver=hlld\neta=1e-3"))
    assert main(["--param", str(path), "--device", "cpu", "--profile"]) == 0
    out = capsys.readouterr().out
    for name in ("dt reduction", "boundary fill", "godunov update", "dissipative",
                 "sum of phases", "full fused step"):
        assert re.search(rf"^  {name}\s*: +\d+\.\d\d ms", out, flags=re.M), (name, out)
    dist = world[0]["profile"]
    assert "distributed step profile (4 devices, best-of-N):" in dist
    for name in ("halo exchange", "sync step"):
        assert re.search(rf"^  {name}\s*: +\d+\.\d\d ms$", dist, flags=re.M), (name, dist)
    assert "halo overlap      : not supported for this configuration" in dist
    assert all(r["profile"] == "" for r in world[1:])


# -------------------------------------------------------------------------
# the live view
# -------------------------------------------------------------------------
def test_live_view_frames_and_animation(tmp_path, monkeypatch):
    """A 2D run's PNG frames (16 x 16 Sod tube, 2 frames of 3 steps) and
    the gif of two HDF5 snapshots."""
    from PIL import Image

    from ramsesgpu_tpu_torch.gui.live_view import main
    from ramsesgpu_tpu_torch.io.hdf5 import output_hdf5

    path = tmp_path / "sod.ini"
    text = (REPO / "data" / "hydro_sod2d.ini").read_text().replace("nx=128\nny=128",
                                                                  "nx=16\nny=16")
    path.write_text(text)
    monkeypatch.chdir(tmp_path)
    assert main(["--param", str(path), "--frames", "--steps", "6", "--interval", "3",
                 "--device", "cpu"]) == 0
    frames = sorted(tmp_path.glob("frame_*.png"))
    assert [f.name for f in frames] == ["frame_00000.png", "frame_00001.png"]
    assert Image.open(frames[0]).size[0] > 100
    params, config = port(text)
    from ramsesgpu_tpu_torch.problems import init_problem

    U = init_problem(params, config)
    for step in (0, 1):
        output_hdf5(params, U * (1 + step), step, output_dir=str(tmp_path), prefix="a")
    gif = tmp_path / "movie.gif"
    assert main(["--param", str(path), "--animate", str(tmp_path / "a_*.h5"),
                 "--out", str(gif)]) == 0
    assert Image.open(gif).n_frames == 2


# -------------------------------------------------------------------------
# flops and the memory planner
# -------------------------------------------------------------------------
def test_step_cost_is_the_count_builds():
    """step_cost's operations are the counting build's for the kernels the
    configuration launches, on the corner block of its initial state (OT:
    row A's 2979 flop a cell and the CFL's 69, as chip_smoke.py's bounds);
    bytes as the bounds count them."""
    import ctypes

    from ramsesgpu_tpu_torch.kernels.build import load_library, param_block
    from ramsesgpu_tpu_torch.kernels.packed_bc import bc_codes
    from ramsesgpu_tpu_torch.problems import init_problem
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries
    from ramsesgpu_tpu_torch.solvers.timestep import compute_dt
    from ramsesgpu_tpu_torch.utils.flops import step_cost

    lib = load_library("count")
    params, config = port(OT_INI.format(n=16, dtype="float32"))
    cost = step_cost(params, config)
    assert cost["kernels"] == {"mhd_step": 2979.0, "cfl_mhd": 69.0}
    assert cost["flops"] == 3048.0 * 16 ** 3 and cost["bytes_accessed"] == 3 * 8 * 4 * 16 ** 3

    implode = re.sub(r"^n([xyz])=.*$", r"n\1=16", (REPO / "data" / "implode3d.ini").read_text(),
                     flags=re.M)
    params, config = port(implode)
    cost = step_cost(params, config)
    U = make_boundaries(params, torch.from_numpy(init_problem(params, config)).double())
    dt = float(compute_dt(params.replace(dtype="float64"), U))
    S = np.ascontiguousarray(U[:, 2:-2, 2:-2, 2:-2].numpy())
    parts = (ctypes.c_longlong * 4)()
    lib.ramses_hydro_step_ops(S.ctypes.data, 16, 16, 16, bc_codes(params), param_block(params),
                              dt, parts, (ctypes.c_ulonglong * 1)())
    cfl = lib.ramses_cfl_hydro_ops(S.ctypes.data, 16, 16, 16, 0, param_block(params))
    assert cost["kernels"] == {"hydro_step": sum(parts) / 16 ** 3, "cfl_hydro": cfl / 16 ** 3}
    assert cost["flops"] == sum(parts) + cfl
    with pytest.raises(NotImplementedError):
        step_cost(*port((REPO / "data" / "hydro_sod2d.ini").read_text()))


def closure_tensors(fn, S) -> list:
    """The tensors a bound step holds, but the loop state S itself."""
    return [c.cell_contents for c in (fn.__closure__ or ())
            if isinstance(c.cell_contents, torch.Tensor) and c.cell_contents is not S]


@pytest.mark.parametrize("case", ["ot", "ot_zcarry", "ot_comp", "implode", "walls", "sod2d"])
def test_estimate_is_what_the_cpu_loops_allocate(case):
    """The planner's ghosted state and loop state are the CPU loop's
    tensors, the streamed step's second buffer the one its bound step
    holds; the stage buffers are the step kernel's sizes (the host
    build's entry points; the CPU twins allocate none)."""
    from ramsesgpu_tpu_torch.kernels.build import load_library
    from ramsesgpu_tpu_torch.problems import init_problem
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries
    from ramsesgpu_tpu_torch.solvers.step import make_packed_advance_chain
    from ramsesgpu_tpu_torch.utils import memory_footprint as mf

    text = {"ot": OT_INI.format(n=16, dtype="float32"),
            "ot_zcarry": OT_INI.format(n=16, dtype="float32") + "kernel=zcarry\n",
            "ot_comp": OT_INI.format(n=16, dtype="float32") + "compensated=yes\n",
            "implode": re.sub(r"^n([xyz])=.*$", r"n\1=16",
                              (REPO / "data" / "implode3d.ini").read_text(), flags=re.M),
            "walls": (REPO / "data" / "testRiemannHLLD.ini").read_text().replace(
                "nx=32\nny=32\nnz=12", "nx=16\nny=16\nnz=16"),
            "sod2d": (REPO / "data" / "hydro_sod2d.ini").read_text()}[case]
    params, config = port(text)
    U = make_boundaries(params, torch.from_numpy(init_problem(params, config)))
    pack, advance, _unpack = make_packed_advance_chain(params, "cpu", config)
    S = pack(U)
    est = mf.estimate(params, config)
    path = mf.run_path(params, config)
    assert est["state_GiB"] * 1024 ** 3 == U.nbytes == mf.state_bytes(params)
    work = mf.CFL_PARTIALS * U.element_size() + 4
    loop = est["loop_GiB"] * 1024 ** 3 - work
    buffers = sum(t.nbytes for t in closure_tensors(advance.bind_step(S), S))
    lib = load_library("host")
    n = params.nx * params.ny * params.nz
    if path in ("zcarry", "hydro"):
        assert S.nbytes == mf.loop_state_bytes(params)
        assert loop == S.nbytes + buffers == 2 * S.nbytes
    elif path == "staged":
        assert S.nbytes == mf.loop_state_bytes(params) and buffers == 0
        stage = lib.ramses_mhd_step_scratch_per_cell() * n * S.element_size()
        assert loop == S.nbytes + stage
    elif path == "ghosted":
        stage = lib.ramses_mhd_step_ghosted_scratch(params.nx, params.ny, params.nz,
                                                    params.ghost_width) * S.element_size()
        assert S.nbytes == U.nbytes and loop == S.nbytes + stage
    else:
        assert path == "whole_array_2d" and S.nbytes == U.nbytes and loop == 13 * U.nbytes
    assert {"ot": "staged", "ot_zcarry": "zcarry", "ot_comp": "staged", "implode": "hydro",
            "walls": "ghosted", "sod2d": "whole_array_2d"}[case] == path
    # the stratified (compensated, f32) shearing box's stage buffer
    shear = port((REPO / "data" / "mhd_mri_3d_stratified.ini").read_text())[0]
    kept, work = 2 * shear.nz * shear.ny * 4, mf.CFL_PARTIALS * 4 + 4
    stage = lib.ramses_mhd_step_shear_scratch(shear.nx, shear.ny, shear.nz, 1) * 4
    assert mf.path_bytes(shear)["shear_staged"] == mf.loop_state_bytes(shear) + kept + work + stage
