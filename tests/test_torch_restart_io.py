"""Checkpoint / restart, the numerics guard and the snapshot writers of the
port (io/netcdf.py, io/restart.py, utils/guard.py, io/misc_formats.py,
io/png.py, solvers/run.py, solvers/run_distributed.py, io/sharded.py)
against the JAX package on the CPU, at small sizes. Every JAX result comes
from one subprocess (``jax_refs``), started once the port has written the
files it reads:

(a) NetCDF both ways: the port's files through JAX ``input_netcdf``, the
    JAX package's files through the port's reader (f32 / f64, ghosted /
    interior, 2D / 3D), and byte for byte the same file;
(b) ``load_restart`` on the same ``.h5`` and ``.nc`` files: JAX's (U, t,
    step) bitwise, with ``restart_upscale`` and both resets, an
    interior-only file, and the MRI's post-restart work;
(c) a resumed run equals the straight run bitwise (f64, the port's CPU
    loops): periodic OT (kernel=auto and zcarry), the walled implode (also
    from interior-only files), the MRI, the stratified MRI, OU-forced MHD
    and 2D Sod;
(d) the compensated OT run resumed from its checkpoint against JAX's
    resumed run (the whole-array compensated functions its packed kernel
    runs, from the zero carry that its pack gives a loaded state) within
    1e-12, and its difference from the straight run, whose carry the
    checkpoint does not hold;
(e) ``check_finite``'s text for a planted NaN and a negative density, 2D
    and 3D, equal to JAX's; ``dump_debug_state``'s datasets equal to JAX's
    (U bitwise, Q and c to 1e-12); through Run the guard's NumericsError
    reaches the caller after the dump;
(f) the NRRD, XSM, BIN, NetCDF files of a Run's output, byte for byte, and
    its faces' arrays and PNG pixels equal to those of the JAX Run's
    output of the same state;
(g) both newly runnable inputs as shipped: ``data/implode3d_debug.ini``
    through the CLI; ``data/mhd_mri_3d_stratified_restart.ini`` on 4 gloo
    ranks from the checkpoint the port's own sharded run of
    ``mhd_mri_3d_stratified_mpi.ini`` wrote at step N, capped at step 2N
    (both drivers cap the total step count), bitwise the straight sharded
    run's step 2N; in the same world of 4 ranks the sharded NetCDF file and
    the gathered PNG / NRRD / XSM / BIN / faces files equal the
    single-device writers' on the gathered state, and a NaN planted on one
    rank raises the global state's NumericsError text on every rank;
(h) ``structureFunctions`` and ``outputZarr`` still raise in both drivers,
    naming their ROADMAP items, and so do zarr and piece-set checkpoints.
"""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
N = 2          # steps between checkpoints of the loop runs (c), (d)
N_STRAT = 5    # the shipped restart input's steps (g): chunks of 5 in both runs
# the compensated MRI as shipped (f32) resumed after 5 steps against the
# straight run, relative L2 of the state: the Kahan carry the checkpoint does
# not hold (5e-8 to 7e-8 measured after 2, 5 and 10 steps; chip_smoke.py
# phase 52a holds the full-width run to the same bound)
COMP_RESUME_L2 = 1e-6

OT = """
[run]
tend=1000.0
[mesh]
nx={n}
ny={n}
nz={n}
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
[MHD]
enable=true
magRiemannSolver=hlld
[implementation]
dtype={dtype}
compensated={comp}
"""
SOD2D = """
[mesh]
nx=6
ny=5
nz=1
[hydro]
problem=sod
riemannSolver=hllc
[implementation]
dtype={dtype}
"""


def with_keys(text: str, section: str, **kv) -> str:
    """The INI text with the keys of ``section`` set (replaced, else added)."""
    for k in kv:
        text = re.sub(rf"^{k}=.*\n", "", text, flags=re.M)
    lines = "".join(f"{k}={v}\n" for k, v in kv.items())
    if f"[{section}]\n" in text:
        return text.replace(f"[{section}]\n", f"[{section}]\n{lines}", 1)
    return text + f"\n[{section}]\n{lines}"


def shipped(name: str, mesh: dict, **impl) -> str:
    """data/<name> with its mesh cut to ``mesh`` and f64 (and ``impl``)."""
    text = (REPO / "data" / name).read_text()
    for k, v in mesh.items():
        text, n = re.subn(rf"^{k}=\d+", f"{k}={v}", text, flags=re.M)
        assert n == 1, (name, k)
    return with_keys(text, "implementation", dtype="float64", **impl)


def port_config(text: str):
    from ramsesgpu_tpu_torch.config.configmap import ConfigMap
    from ramsesgpu_tpu_torch.config.params import params_from_config

    config = ConfigMap(text=text)
    return params_from_config(config), config


def jax_config(text: str):
    from ramsesgpu_tpu.config.configmap import ConfigMap
    from ramsesgpu_tpu.config.params import params_from_config

    config = ConfigMap(text=text)
    return params_from_config(config), config


def random_state(params, seed: int, dtype) -> np.ndarray:
    """A ghosted conserved state with rho, p > 0."""
    rng = np.random.default_rng(seed)
    U = rng.uniform(-0.5, 0.5, params.shape)
    U[0] = rng.uniform(0.5, 1.5, params.shape[1:])
    U[1] = rng.uniform(2.0, 3.0, params.shape[1:])
    return U.astype(dtype)


# --------------------------------------------------------------------------- #
# the cases
# --------------------------------------------------------------------------- #
def nc_case(name: str):
    """(params text, state, step, t, ghost_included) of NetCDF case ``name``:
    dim, dtype and layout in its name."""
    dim, dtype, layout = name.split("-")
    text = OT.format(n=4, dtype=dtype, comp="no").replace("ny=4", "ny=5").replace(
        "nz=4", "nz=3") if dim == "3d" else SOD2D.format(dtype=dtype)
    params, _ = port_config(text)
    return text, random_state(params, len(name), dtype), 7 + len(name), 0.25 + len(name) / 7, \
        layout == "ghosted"


NC_CASES = [f"{d}-{t}-{g}" for d in ("3d", "2d") for t in ("float32", "float64")
            for g in ("ghosted", "interior")]

# load_restart variants (b): the [run] keys and the file's stem
RESTART_CASES = {
    "h5": dict(restart_filename="ck.h5"),
    "nc": dict(restart_filename="ck.nc"),
    "nc-interior": dict(restart_filename="ck_interior.nc"),
    "h5-upscale": dict(restart_filename="half.h5", restart_upscale="yes"),
    "nc-upscale-resets": dict(restart_filename="half.nc", restart_upscale="yes",
                              restart_reset_totaltime="yes", restart_reset_timestep="yes"),
    "nc-reset-step": dict(restart_filename="ck.nc", restart_reset_timestep="yes"),
    "mri-nc": dict(restart_filename="mri.nc"),
}
STRAT_SMALL = dict(nx=8, ny=8, nz=16)


def restart_text(case: str, outdir) -> str:
    keys = RESTART_CASES[case]
    if case.startswith("mri"):
        base = shipped("mhd_mri_3d_stratified.ini", STRAT_SMALL)
    else:
        base = OT.format(n=8, dtype="float64", comp="no")
    text = with_keys(base, "run", restart="yes", **keys)
    return with_keys(text, "output", outputDir=outdir)


# the planted faults (e): (dim, the fault, its channel and ghosted index)
GUARD_CASES = {
    "3d-nan": ("3d", np.nan, (3, 5, 4, 6)),
    "3d-negative": ("3d", -1e-3, (0, 4, 7, 3)),
    "2d-nan": ("2d", np.inf, (2, 4, 6)),
    "2d-negative": ("2d", 0.0, (0, 6, 3)),
}


def guard_state(case: str):
    dim, value, where = GUARD_CASES[case]
    text = OT.format(n=6, dtype="float64", comp="no") if dim == "3d" else \
        SOD2D.format(dtype="float64").replace("nx=6", "nx=8")
    params, _ = port_config(text)
    U = random_state(params, 11, np.float64)
    U[where] = value
    # a second fault later in C order: the first one is the one named
    U[(1,) + tuple(n - 4 for n in U.shape[1:])] = np.nan
    return text, U


WRITER_CASES = {
    "3d": OT.format(n=6, dtype="float32", comp="no"),
    "2d": SOD2D.format(dtype="float64").replace("nx=6", "nx=12").replace("ny=5", "ny=10"),
}
WRITER_KEYS = dict(outputVtk="no", outputNetcdf="yes", outputPng="yes", outputNrrd="yes",
                   outputXsm="yes", outputBin="yes", outputFaces="yes", outputPrefix="snap")


def writer_text(case: str, outdir) -> str:
    return with_keys(WRITER_CASES[case], "output", outputDir=outdir, **WRITER_KEYS)


def comp_text(outdir) -> str:
    """The compensated OT run of (d), checkpoints every N steps."""
    text = with_keys(OT.format(n=16, dtype="float64", comp="yes"), "run", noutput=N,
                     nstepmax=2 * N)
    return with_keys(text, "output", outputDir=outdir, outputPrefix="comp", outputVtk="no",
                     outputNetcdf="yes", ghostIncluded="yes")


# --------------------------------------------------------------------------- #
# the port's runs
# --------------------------------------------------------------------------- #
def straight_and_resumed(text: str, workdir: Path, ghost: str = "yes", device: str = "cpu"):
    """The run of ``text`` for 2N steps writing NetCDF checkpoints at N and
    2N into workdir/straight, and a fresh Run restarted from the step-N file
    for N steps in workdir/resumed (beside the step-N OU forcing state);
    returns (params, the straight step-2N file's (U, t, step), the resumed
    Run)."""
    from ramsesgpu_tpu_torch.io.netcdf import input_netcdf
    from ramsesgpu_tpu_torch.solvers.run import Run

    a, b = workdir / "straight", workdir / "resumed"
    b.mkdir(parents=True)
    base = with_keys(text, "run", noutput=N, nstepmax=2 * N)
    base = with_keys(base, "output", outputDir=a, outputPrefix="ck", outputVtk="no",
                     outputHdf5="no", outputNetcdf="yes", ghostIncluded=ghost)
    params, config = port_config(base)
    Run(config, device, params).start()
    for f in a.glob(f"ck_forcing_{N:07d}.npz"):
        shutil.copy(f, b)
    resumed_text = with_keys(base, "run", restart="yes", restart_filename=a / f"ck_{N:07d}.nc")
    _, config = port_config(with_keys(resumed_text, "output", outputDir=b))
    run = Run(config, device, params)
    assert (run.n_step, run.t) == input_netcdf(params, a / f"ck_{N:07d}.nc")[:0:-1]
    run.start()
    return params, input_netcdf(params, a / f"ck_{2 * N:07d}.nc"), run


# --------------------------------------------------------------------------- #
# the JAX side (run in the subprocess)
# --------------------------------------------------------------------------- #
def jax_side(tmp: Path) -> dict:
    import jax.numpy as jnp

    from ramsesgpu_tpu.io.netcdf import input_netcdf, output_netcdf
    from ramsesgpu_tpu.io.restart import load_restart
    from ramsesgpu_tpu.utils.guard import NumericsError, check_finite, dump_debug_state

    out = {}
    for name in NC_CASES:
        text, U, step, t, ghost = nc_case(name)
        params, _ = jax_config(text)
        output_netcdf(params, U, step, str(tmp / f"jax_{name}.nc"), total_time=t,
                      ghost_included=ghost)
        out[f"nc/{name}/U"], out[f"nc/{name}/t"], out[f"nc/{name}/step"] = input_netcdf(
            params, tmp / f"port_{name}.nc")
    for case in RESTART_CASES:
        params, config = jax_config(restart_text(case, tmp))
        U, t, step = load_restart(params, config)
        out[f"restart/{case}/U"], out[f"restart/{case}/t"] = np.asarray(U), t
        out[f"restart/{case}/step"] = step
    for case in GUARD_CASES:
        text, U = guard_state(case)
        params, config = jax_config(text)
        try:
            check_finite(params, U, 17, where="chunk")
        except NumericsError as exc:
            out[f"guard/{case}"] = np.array(str(exc))
        if case in ("3d-negative", "2d-nan"):
            d = tmp / f"jax_dump_{case}"
            d.mkdir()
            dump_debug_state(params, config, U, 0.0, 17, str(d))
    out.update(jax_comp_resumed(tmp))
    from ramsesgpu_tpu.io.convert import convert

    params, _ = jax_config(OT.format(n=8, dtype="float64", comp="no"))
    for fmt in CONVERT_FORMATS:
        convert(params, str(tmp / "ck.h5"), fmt, out=str(tmp / f"jax_convert.{fmt}"))
    for case in WRITER_CASES:
        from ramsesgpu_tpu.solvers.run import Run

        d = tmp / f"jax_writers_{case}"
        d.mkdir()
        params, config = jax_config(writer_text(case, d))
        run = Run(config)
        run.U = jnp.asarray(random_state(params, 5, params.dtype))
        run.n_step, run.t = 9, 0.125
        run.output()
    return out


def jax_comp_resumed(tmp: Path) -> dict:
    """JAX's resumed compensated run (d): its load_restart of the port's
    step-N checkpoint, then N steps of the whole-array compensated update
    (the CFL on the ghosted state, ``mhd_3d_interior_update(comp=)``, the
    periodic fill) from a zero carry, as the packed loop's pack gives."""
    import jax.numpy as jnp

    from ramsesgpu_tpu.io.restart import load_restart
    from ramsesgpu_tpu.solvers.boundary import make_boundaries
    from ramsesgpu_tpu.solvers.godunov_mhd import mhd_3d_interior_update
    from ramsesgpu_tpu.solvers.timestep import compute_dt

    text = with_keys(comp_text(tmp / "comp" / "straight"), "run", restart="yes",
                     restart_filename=f"comp_{N:07d}.nc")
    params, config = jax_config(text)
    g = params.ghost_width
    inner = (slice(None), slice(g, -g), slice(g, -g), slice(g, -g))
    U, t, step = load_restart(params, config)
    U = make_boundaries(params, jnp.asarray(U))
    C = jnp.zeros_like(U)
    for _ in range(N):
        dt = compute_dt(params, U)
        res = mhd_3d_interior_update(params, U, dt, comp=C)
        U = make_boundaries(params, U.at[inner].set(res[:8]))
        C = C.at[inner].set(res[8:])
        t = t + float(dt)
    return {"comp/U": np.asarray(U[inner]), "comp/t": t, "comp/step": step + N}


_JAX_SCRIPT = r"""
import sys
from pathlib import Path
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import numpy as np
sys.path.insert(0, sys.argv[1])
import test_torch_restart_io as m
np.savez(sys.argv[2] + "/refs.npz", **m.jax_side(Path(sys.argv[2])))
"""


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    """The files the JAX side reads (written here by the port), then every
    JAX result of this file from one subprocess; (refs, directory)."""
    from ramsesgpu_tpu_torch.io.hdf5 import output_hdf5
    from ramsesgpu_tpu_torch.io.netcdf import output_netcdf
    from ramsesgpu_tpu_torch.solvers.run import Run

    tmp = tmp_path_factory.mktemp("restart_io")
    for name in NC_CASES:
        text, U, step, t, ghost = nc_case(name)
        params, _ = port_config(text)
        output_netcdf(params, U, step, str(tmp / f"port_{name}.nc"), total_time=t,
                      ghost_included=ghost)
    params, _ = port_config(OT.format(n=8, dtype="float64", comp="no"))
    half, _ = port_config(OT.format(n=4, dtype="float64", comp="no"))
    U, Uh = random_state(params, 1, np.float64), random_state(half, 2, np.float64)
    output_hdf5(params, U, 12, total_time=0.5, output_dir=tmp, prefix="ck",
                ghost_included=True)
    os.rename(tmp / "ck_0000012.h5", tmp / "ck.h5")
    output_hdf5(half, Uh, 6, total_time=0.25, output_dir=tmp, prefix="half")
    os.rename(tmp / "half_0000006.h5", tmp / "half.h5")
    output_netcdf(params, U, 12, str(tmp / "ck.nc"), total_time=0.5, ghost_included=True)
    output_netcdf(params, U, 12, str(tmp / "ck_interior.nc"), total_time=0.5)
    output_netcdf(half, Uh, 6, str(tmp / "half.nc"), total_time=0.25)
    strat, _ = port_config(shipped("mhd_mri_3d_stratified.ini", STRAT_SMALL))
    output_netcdf(strat, random_state(strat, 3, np.float64), 40, str(tmp / "mri.nc"),
                  total_time=3.5, ghost_included=True)
    (tmp / "comp" / "straight").mkdir(parents=True)
    _, config = port_config(comp_text(tmp / "comp" / "straight"))
    Run(config, "cpu").start()

    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("JAX_PLATFORMS", None)
    flags = ("--xla_backend_optimization_level=0 --xla_cpu_multi_thread_eigen=false "
             "--xla_cpu_use_fusion_emitters=false")
    env["XLA_FLAGS"] = " ".join(f for f in (env.get("XLA_FLAGS"), flags) if f)
    res = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(REPO / "tests"), str(tmp)],
                         capture_output=True, text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return dict(np.load(tmp / "refs.npz")), tmp


# --------------------------------------------------------------------------- #
# (a) NetCDF both ways
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", NC_CASES)
def test_netcdf_crosses_between_the_packages(name, jax_refs):
    from ramsesgpu_tpu_torch.io.netcdf import input_netcdf

    refs, tmp = jax_refs
    text, U, step, t, ghost = nc_case(name)
    params, _ = port_config(text)
    g = params.ghost_width
    inner = (slice(None),) + (slice(g, -g),) * params.dim
    want = U if ghost else np.where(np.pad(np.ones(U[0][inner[1:]].shape, bool),
                                           g)[None], U, 0)
    for got, got_t, got_step in (
            (refs[f"nc/{name}/U"], refs[f"nc/{name}/t"], refs[f"nc/{name}/step"]),
            input_netcdf(params, tmp / f"jax_{name}.nc")):
        assert got.dtype == U.dtype and np.array_equal(got, want)
        assert float(got_t) == t and int(got_step) == step
    assert (tmp / f"jax_{name}.nc").read_bytes() == (tmp / f"port_{name}.nc").read_bytes()


def test_sharded_netcdf_stream_is_scipys_file(tmp_path):
    """io/netcdf.py write_classic_stream writes scipy's NetCDF-3 file
    byte for byte (the sharded writer's path), f32 and f64, 2D and 3D."""
    from ramsesgpu_tpu_torch.io.hdf5 import dataset_names
    from ramsesgpu_tpu_torch.io.netcdf import output_netcdf, write_classic_stream

    for name in NC_CASES:
        text, U, step, t, ghost = nc_case(name)
        params, _ = port_config(text)
        output_netcdf(params, U, step, str(tmp_path / "a.nc"), total_time=t,
                      ghost_included=True)
        dims = dict(zip(("z", "y", "x")[-params.dim:], U.shape[1:]))
        write_classic_stream(tmp_path / "b.nc", dims, dataset_names(params), U.dtype,
                             {"time_step": np.int32(step), "total_time": np.float64(t),
                              "ghost_included": np.int32(1)}, lambda i: U[i])
        assert (tmp_path / "a.nc").read_bytes() == (tmp_path / "b.nc").read_bytes(), name


# --------------------------------------------------------------------------- #
# (b) load_restart
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("case", list(RESTART_CASES))
def test_load_restart_matches_jax(case, jax_refs, monkeypatch):
    from ramsesgpu_tpu_torch.io import restart

    refs, tmp = jax_refs
    calls = []
    fixup = restart.RESTART_EXTRA_WORK["mri"]
    monkeypatch.setitem(restart.RESTART_EXTRA_WORK, "mri",
                        lambda *a: calls.append(a[0].problem) or fixup(*a))
    params, config = port_config(restart_text(case, tmp))
    U, t, step = restart.load_restart(params, config)
    assert U.dtype == np.float64 and np.array_equal(U, refs[f"restart/{case}/U"])
    assert (t, step) == (float(refs[f"restart/{case}/t"]), int(refs[f"restart/{case}/step"]))
    assert calls == (["MRI"] if case.startswith("mri") else [])


CONVERT_FORMATS = ("vti", "nrrd", "npz", "nc")


@pytest.mark.parametrize("fmt", CONVERT_FORMATS)
def test_convert_writes_what_jax_convert_writes(fmt, jax_refs, tmp_path):
    """io/convert.py on the HDF5 checkpoint of (b): the JAX converter's file
    (the npz's arrays: a zip member carries its write time)."""
    from ramsesgpu_tpu_torch.io.convert import main

    _refs, tmp = jax_refs
    ini = tmp_path / "ot.ini"
    ini.write_text(OT.format(n=8, dtype="float64", comp="no"))
    shutil.copy(tmp / "ck.h5", tmp_path / "ck.h5")
    assert main(["--param", str(ini), "--to", fmt, str(tmp_path / "ck.h5")]) == 0
    got, want = tmp_path / f"ck.{fmt}", tmp / f"jax_convert.{fmt}"
    if fmt == "npz":
        a, b = np.load(got), np.load(want)
        assert sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in b)
    else:
        assert got.read_bytes() == want.read_bytes()


# --------------------------------------------------------------------------- #
# (c) straight vs resumed on the port's loops
# --------------------------------------------------------------------------- #
RESUME_CASES = {
    "ot": lambda: OT.format(n=16, dtype="float64", comp="no"),
    "ot-zcarry": lambda: with_keys(OT.format(n=16, dtype="float64", comp="no"),
                                   "implementation", kernel="zcarry"),
    "implode": lambda: shipped("implode3d.ini", dict(nx=16, ny=16, nz=16)),
    "mri": lambda: shipped("mhd_mri_3d.ini", dict(nx=16, ny=32, nz=16), compensated="no"),
    "mri-stratified": lambda: shipped("mhd_mri_3d_stratified.ini", dict(nx=8, ny=16, nz=32),
                                      compensated="no"),
    "turbulence-ou": lambda: shipped("turbulence_mhd_ou.ini", dict(nx=16, ny=16, nz=16)),
    "sod2d": lambda: shipped("hydro_sod2d.ini", dict(nx=32, ny=32)),
}


@pytest.mark.parametrize("ghost", ["yes", "no"])
@pytest.mark.parametrize("case", list(RESUME_CASES))
def test_resumed_run_equals_straight_run(case, ghost, tmp_path):
    """A Run restarted from the step-N checkpoint and run N steps has the
    straight run's step-2N interior, t and step bitwise. From an
    interior-only checkpoint (ghostIncluded=no) the same holds but on the
    shearing box, whose kept Bx face at x = nx lives in an x ghost: the
    file does not hold it, and the loaded state (the JAX package's too,
    test_load_restart_matches_jax) starts from a zero kept face."""
    params, (U, t, step), run = straight_and_resumed(RESUME_CASES[case](), tmp_path, ghost)
    g = params.ghost_width
    inner = (slice(None),) + (slice(g, -g),) * params.dim
    assert (run.n_step, step) == (2 * N, 2 * N) and run.t == t
    if ghost == "no" and case.startswith("mri"):
        err = np.linalg.norm(run.interior() - U[inner]) / np.linalg.norm(U[inner])
        print(f"{case} resumed from an interior-only file: relative L2 {err:.3e}")
        assert err > 0
        return
    assert np.array_equal(run.interior(), U[inner])


def test_ou_forcing_state_resumes_bitwise(tmp_path):
    """The OU forcing state reloaded beside the checkpoint equals the
    straight run's at the same step: the mode field (float32 in every run,
    so the reload's float32 cast is exact) and the draw count."""
    from ramsesgpu_tpu_torch.ops.forcing import load_ou_forcing

    text = RESUME_CASES["turbulence-ou"]()
    straight_and_resumed(text, tmp_path)
    a = load_ou_forcing(tmp_path / "straight" / f"ck_forcing_{2 * N:07d}.npz")
    b = load_ou_forcing(tmp_path / "resumed" / f"ck_forcing_{2 * N:07d}.npz")
    assert torch.equal(a.forcingField, b.forcingField) and a.draws == b.draws == 2 * N


# --------------------------------------------------------------------------- #
# (d) the compensated run
# --------------------------------------------------------------------------- #
def test_compensated_resume_matches_jax_resume(jax_refs, tmp_path):
    from ramsesgpu_tpu_torch.io.netcdf import input_netcdf
    from ramsesgpu_tpu_torch.solvers.run import Run

    refs, tmp = jax_refs
    straight = tmp / "comp" / "straight"
    text = with_keys(comp_text(tmp_path), "run", restart="yes",
                     restart_filename=straight / f"comp_{N:07d}.nc")
    params, config = port_config(text)
    run = Run(config, "cpu", params)
    run.start()
    got, want = run.interior(), refs["comp/U"]
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    U2, t2, _ = input_netcdf(params, straight / f"comp_{2 * N:07d}.nc")
    g = params.ghost_width
    vs_straight = np.linalg.norm(got - U2[:, g:-g, g:-g, g:-g]) / np.linalg.norm(want)
    print(f"compensated resume: vs JAX's resume {err:.3e}, vs the straight run "
          f"{vs_straight:.3e} (the carry the checkpoint does not hold)")
    assert run.n_step == int(refs["comp/step"]) == 2 * N
    assert abs(run.t - float(refs["comp/t"])) <= 1e-12 * run.t and err <= 1e-12
    assert 0 < vs_straight <= 1e-12


def test_compensated_mri_resume_within_bound(tmp_path, monkeypatch):
    """data/mhd_mri_3d.ini as shipped (compensated, f32) resumed after 5
    steps: its state within COMP_RESUME_L2 of the straight run's, not equal
    to it (the dropped carry shows)."""
    monkeypatch.setattr(sys.modules[__name__], "N", 5)
    text = (REPO / "data" / "mhd_mri_3d.ini").read_text()
    assert "compensated=yes" in text
    params, (U, t, step), run = straight_and_resumed(text, tmp_path)
    g = params.ghost_width
    got, want = run.interior().astype(np.float64), U[:, g:-g, g:-g, g:-g].astype(np.float64)
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    print(f"compensated MRI as shipped, resumed vs straight: relative L2 {err:.3e}")
    assert run.n_step == step == 10 and 0 < err <= COMP_RESUME_L2


# --------------------------------------------------------------------------- #
# (e) the numerics guard
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("case", list(GUARD_CASES))
def test_check_finite_names_what_jax_names(case, jax_refs):
    from ramsesgpu_tpu_torch.utils.guard import NumericsError, check_finite

    refs, _ = jax_refs
    text, U = guard_state(case)
    params, _ = port_config(text)
    for arg in (torch.from_numpy(U), U):
        with pytest.raises(NumericsError) as info:
            check_finite(params, arg, 17, where="chunk")
        assert str(info.value) == str(refs[f"guard/{case}"])
    check_finite(params, random_state(params, 3, np.float64), 17)


@pytest.mark.parametrize("case", ["3d-negative", "2d-nan"])
def test_dump_debug_state_matches_jax(case, jax_refs, tmp_path):
    import h5py

    from ramsesgpu_tpu_torch.utils.guard import dump_debug_state

    refs, tmp = jax_refs
    text, U = guard_state(case)
    params, config = port_config(text)
    paths = dump_debug_state(params, config, torch.from_numpy(U), 0.0, 17, str(tmp_path))
    assert [Path(p).name for p in paths] == ["debug_state_0000017.h5", "debug_prim_0000017.h5"]
    for name in ("debug_state_0000017.h5", "debug_prim_0000017.h5"):
        with h5py.File(tmp_path / name) as got, h5py.File(tmp / f"jax_dump_{case}" / name) as want:
            assert sorted(got) == sorted(want) and dict(got.attrs) == dict(want.attrs)
            for key in want:
                a, b = np.asarray(got[key]), np.asarray(want[key])
                if key == "U":
                    assert np.array_equal(a, b, equal_nan=True)
                else:
                    np.testing.assert_allclose(a, b, rtol=1e-12, atol=0, equal_nan=True)


def test_guard_in_run_raises_after_the_dump(tmp_path):
    """``[debug] dumpData``: a NaN planted in the state fails the chunk's
    check; the NumericsError (check_finite's text on the dumped state)
    reaches the caller, the dump is written, and Run.U is restored."""
    import h5py

    from ramsesgpu_tpu_torch.solvers.run import Run
    from ramsesgpu_tpu_torch.utils.guard import NumericsError, check_finite

    text = shipped("implode3d_debug.ini", dict(nx=8, ny=8, nz=8))
    params, config = port_config(with_keys(text, "output", outputDir=tmp_path))
    run = Run(config, "cpu", params)
    run.U[2, 5, 6, 7] = float("nan")
    with pytest.raises(NumericsError) as info:
        run.start(max_steps=2, do_output=False)
    assert run.n_step == 1 and run.U is not None
    with h5py.File(tmp_path / "debug_state_0000001.h5") as f:
        dumped = np.asarray(f["U"])
        assert f.attrs["step"] == 1 and f.attrs["dt"] == 0.0
    with pytest.raises(NumericsError) as again:
        check_finite(params, dumped, 1)
    assert str(info.value) == str(again.value)
    assert (tmp_path / "debug_prim_0000001.h5").exists()


# --------------------------------------------------------------------------- #
# (f) the writers
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("case", list(WRITER_CASES))
def test_run_output_files_equal_jax_run_output(case, jax_refs, tmp_path):
    from PIL import Image

    from ramsesgpu_tpu_torch.solvers.run import Run

    refs, tmp = jax_refs
    params, config = port_config(writer_text(case, tmp_path))
    run = Run(config, "cpu", params)
    run.U = torch.from_numpy(random_state(params, 5, params.dtype))
    run.n_step, run.t = 9, 0.125
    run.output()
    want_dir = tmp / f"jax_writers_{case}"
    names = sorted(p.name for p in want_dir.iterdir())
    assert sorted(p.name for p in tmp_path.iterdir()) == names
    kinds = {Path(n).suffix for n in names}
    assert kinds == {".nc", ".png", ".nrrd", ".bin", ".npz"} | ({".xsm"} if case == "2d" else set())
    for name in names:
        got, want = tmp_path / name, want_dir / name
        if name.endswith(".npz"):
            a, b = np.load(got), np.load(want)
            assert sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in b)
        elif name.endswith(".png"):
            assert np.array_equal(np.asarray(Image.open(got)), np.asarray(Image.open(want)))
        else:
            assert got.read_bytes() == want.read_bytes(), name


# --------------------------------------------------------------------------- #
# (g) the two inputs as shipped, and the distributed driver
# --------------------------------------------------------------------------- #
def test_implode3d_debug_runs_as_shipped(tmp_path, monkeypatch, capsys):
    """data/implode3d_debug.ini ([debug] dumpData=yes) through the CLI: its
    5 steps with the guard after each chunk, a VTK snapshot a step, no
    debug dump."""
    from ramsesgpu_tpu_torch.cli.main import main
    from ramsesgpu_tpu_torch.io.vtk import read_vti

    monkeypatch.chdir(tmp_path)
    assert main(["--param", str(REPO / "data" / "implode3d_debug.ini"), "--device", "cpu"]) == 0
    assert "number of time steps   : 5" in capsys.readouterr().out
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == [f"implode3d_gpu_v2_{k:07d}.vti" for k in range(6)]
    fields, _ = read_vti(tmp_path / "implode3d_gpu_v2_0000005.vti")
    assert np.isfinite(fields["density"]).all() and fields["density"].min() > 0


STRAT_MPI = "mhd_mri_3d_stratified_mpi.ini"
RESTART_INI = "mhd_mri_3d_stratified_restart.ini"
OT_MPI_2D = with_keys(with_keys(
    (REPO / "data" / "orszag-tang_mpi.ini").read_text().replace("nx=128", "nx=32").replace(
        "ny=128", "ny=32"), "output", outputVtk="no", outputHdf5="no", outputNetcdf="yes",
    outputPng="yes", outputNrrd="yes", outputXsm="yes", outputBin="yes", outputFaces="yes"),
    "run", fpe_check="yes")


def rank_world(workdir: str) -> dict:
    """One rank of the world of (g): the straight sharded run of
    mhd_mri_3d_stratified_mpi.ini through the CLI (NetCDF checkpoints every
    N_STRAT steps, 2 N_STRAT steps), rank 0 copying the step-N_STRAT file to
    the name the restart input reads; the restart input as shipped, capped
    at 2 N_STRAT; OT 2D on 2x2 with every gathered writer and the guard; a
    NaN planted on rank 2 and the guard."""
    import torch.distributed as dist

    from ramsesgpu_tpu_torch.cli.main import main
    from ramsesgpu_tpu_torch.config.configmap import ConfigMap
    from ramsesgpu_tpu_torch.solvers.run_distributed import DistributedRun
    from ramsesgpu_tpu_torch.utils.guard import NumericsError

    torch.set_num_threads(1)  # four ranks on a CPU that other test workers share
    work = Path(workdir)
    os.chdir(work)
    text = with_keys((REPO / "data" / STRAT_MPI).read_text(), "run", noutput=N_STRAT,
                     nstepmax=2 * N_STRAT)
    text = with_keys(text, "output", outputNetcdf="yes", outputVtk="no")
    (work / "straight.ini").write_text(text)
    assert main(["--param", "straight.ini", "--device", "cpu"]) == 0
    if dist.get_rank() == 0:
        shutil.copy(f"mhd_mri_3d_stratified_mpi_{N_STRAT:07d}.nc",
                    "mhd_mri_3d_stratified_mpi_0005000.nc")
    dist.barrier()
    out = {}
    run = DistributedRun(ConfigMap(str(REPO / "data" / RESTART_INI)), "cpu")
    out["restart_start"] = (run.n_step, run.t)
    run.start(max_steps=2 * N_STRAT)
    out["restart"] = (run.n_step, run.t, run.interior())

    (work / "ot").mkdir(exist_ok=True)
    os.chdir(work / "ot")
    run = DistributedRun(ConfigMap(text=OT_MPI_2D), "cpu")
    run.start(max_steps=2)
    out["ot"] = (run.n_step, run.t, run.interior())

    if dist.get_rank() == 2:
        run.U[3, 4, 5] = float("nan")
    try:
        run.check_numerics()
    except NumericsError as exc:
        out["guard"] = str(exc)
    out["ot_nan"] = run.interior()
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from ramsesgpu_tpu_torch.parallel.launch import spawn_ranks

    workdir = tmp_path_factory.mktemp("world")
    return spawn_ranks(rank_world, 4, (str(workdir),)), workdir


def test_stratified_restart_input_runs_as_shipped(world):
    """data/mhd_mri_3d_stratified_restart.ini as shipped on its 4 ranks,
    from the checkpoint the port's straight sharded run wrote at N_STRAT,
    run to step 2 N_STRAT: bitwise the straight run's step-2 N_STRAT file
    (ghostIncluded, gathered by rank 0), its t and its step. The input's
    outputPnetcdf is a key neither package reads: it writes no snapshot."""
    from ramsesgpu_tpu_torch.io.netcdf import input_netcdf

    ranks, workdir = world
    params, _ = port_config((REPO / "data" / RESTART_INI).read_text())
    U, t, step = input_netcdf(params, workdir / f"mhd_mri_3d_stratified_mpi_{2 * N_STRAT:07d}.nc")
    _U5, t5, _s = input_netcdf(params, workdir / "mhd_mri_3d_stratified_mpi_0005000.nc")
    n_step, t_end, got = ranks[0]["restart"]
    assert ranks[0]["restart_start"] == (N_STRAT, t5)
    assert (n_step, step) == (2 * N_STRAT, 2 * N_STRAT) and t_end == t
    g = params.ghost_width
    assert got.dtype == np.float32 and np.array_equal(got, U[:, g:-g, g:-g, g:-g])
    assert all(r["restart"][0] == 2 * N_STRAT for r in ranks)
    assert not list(workdir.glob("*.vti")) and len(list(workdir.glob("*.nc"))) == 4


def test_sharded_writers_equal_single_device_writers(world, tmp_path):
    """The 2D OT run on 2x2: its sharded NetCDF file and its gathered PNG,
    NRRD, XSM, BIN and face files equal the single-device writers' files of
    the gathered state (solvers/run.py OutputSettings, held to the JAX
    Run's by test_run_output_files_equal_jax_run_output)."""
    from PIL import Image

    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries
    from ramsesgpu_tpu_torch.solvers.run import OutputSettings

    ranks, workdir = world
    n_step, t, got = ranks[0]["ot"]
    params, config = port_config(OT_MPI_2D)
    g = params.ghost_width
    Ug = make_boundaries(params, torch.nn.functional.pad(torch.from_numpy(got), (g, g) * 2))
    out = OutputSettings(config)
    out.output_dir = str(tmp_path)
    out.write_snapshots(params, Ug.numpy(), n_step, t)
    names = sorted(p.name for p in tmp_path.iterdir())
    assert len(names) == 1 + 1 + 8 + 8 + 1 + 4
    for name in names:
        a, b = workdir / "ot" / name, tmp_path / name
        if name.endswith(".npz"):
            assert all(np.array_equal(np.load(a)[k], np.load(b)[k]) for k in np.load(b))
        elif name.endswith(".png"):
            assert np.array_equal(np.asarray(Image.open(a)), np.asarray(Image.open(b)))
        else:
            assert a.read_bytes() == b.read_bytes(), name


def test_sharded_guard_names_the_global_cell(world):
    """A NaN planted in rank 2's block: every rank raises the NumericsError
    that check_finite gives on the gathered global state."""
    from ramsesgpu_tpu_torch.utils.guard import NumericsError, check_finite

    ranks, _ = world
    params, _ = port_config(OT_MPI_2D)
    g = params.ghost_width
    glob = np.pad(ranks[0]["ot_nan"], ((0, 0), (g, g), (g, g)))
    with pytest.raises(NumericsError) as info:
        check_finite(params, glob, ranks[0]["ot"][0])
    assert "var=3 cell=(np.int64(20), np.int64(5))" in str(info.value) or \
        "var=3 cell=(20, 5)" in str(info.value)
    assert [r["guard"] for r in ranks] == [str(info.value)] * 4


# --------------------------------------------------------------------------- #
# (h) what stays refused
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("driver", ["Run", "DistributedRun"])
@pytest.mark.parametrize("section, key, item", [("structureFunctions", "enabled", "item 9"),
                                                ("output", "outputZarr", "item 8")])
def test_unported_switches_raise_naming_their_item(driver, section, key, item):
    from ramsesgpu_tpu_torch.solvers.run import Run
    from ramsesgpu_tpu_torch.solvers.run_distributed import DistributedRun

    text = OT.format(n=8, dtype="float64", comp="no")
    if driver == "DistributedRun":
        text = with_keys(text, "mpi", mx=2, my=1, mz=1)
    params, config = port_config(with_keys(text, section, **{key: "yes"}))
    with pytest.raises(NotImplementedError, match=f"{key} is not ported.*{item}"):
        {"Run": Run, "DistributedRun": DistributedRun}[driver](config, "cpu", params)


@pytest.mark.parametrize("name, item", [("ck.zarr", "item 8"), ("ck.pieces.json", "item 7.6")])
def test_unported_checkpoints_raise_naming_their_item(name, item, tmp_path):
    from ramsesgpu_tpu_torch.io.restart import load_restart

    (tmp_path / name).write_text("{}")
    text = with_keys(OT.format(n=8, dtype="float64", comp="no"), "run", restart="yes",
                     restart_filename=name)
    params, config = port_config(with_keys(text, "output", outputDir=tmp_path))
    with pytest.raises(NotImplementedError, match=item):
        load_restart(params, config)
