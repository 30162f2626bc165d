"""Entry points and plumbing of the PyTorch port: jax-free imports, the
CLI on the CPU, state conversion to and from the JAX package, the kernel
wrappers' CPU dispatch, and the configurations the port refuses."""
import os
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ramsesgpu_tpu.config.configmap import ConfigMap
from ramsesgpu_tpu.config.params import params_from_config

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent

INI = """
[run]
tend=100.0
nstepmax=1000
noutput=100
[mesh]
nx={n}
ny={n}
nz={n}
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
problem=Orszag-Tang
cfl=0.4
gamma0=1.666
slope_type=2.0
riemannSolver={solver}
smallr=1e-7
smallc=1e-7
[MHD]
enable=true
magRiemannSolver=hlld
[implementation]
kernel={kernel}
[output]
outputDir={outdir}
outputPrefix=ot3d
outputHdf5={hdf5}
"""


def params_for(n=16, solver="hlld", kernel="auto", outdir="."):
    config = ConfigMap(text=INI.format(n=n, solver=solver, kernel=kernel, outdir=outdir,
                                       hdf5="no"))
    return params_from_config(config), config


def zcarry(text: str) -> str:
    """The INI text with [implementation] kernel=zcarry."""
    if "\nkernel=" in text:
        return re.sub(r"\nkernel=\w+", "\nkernel=zcarry", text)
    if "[implementation]\n" in text:
        return text.replace("[implementation]\n", "[implementation]\nkernel=zcarry\n", 1)
    return text + "\n[implementation]\nkernel=zcarry\n"


def test_port_imports_no_jax(tmp_path):
    """Importing every module of the port (parallel/*, analysis/* and
    gui/* among them) and running a CPU Run of each slice (2D among them),
    a run that writes NetCDF, NRRD, BIN, face and structure-function files
    under the numerics guard and one restarted from its checkpoint, each
    alternative scheme, a power spectrum, the planner and the step
    profile, leaves no jax and no ramsesgpu_tpu module in sys.modules."""
    pkg = REPO / "ramsesgpu_tpu_torch"
    modules = sorted(
        "ramsesgpu_tpu_torch." + ".".join(p.relative_to(pkg).with_suffix("").parts)
        for p in pkg.rglob("*.py") if p.name != "__init__.py")
    code = (
        "import importlib, sys\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "assert all(f'ramsesgpu_tpu_torch.{m}' in sys.modules\n"
        "           for m in ('parallel.mesh', 'parallel.launch', 'parallel.halo',\n"
        "                     'parallel.shear_dist', 'parallel.sharded_step', 'io.netcdf',\n"
        "                     'io.restart', 'io.misc_formats', 'io.png', 'io.convert',\n"
        "                     'utils.guard', 'solvers.alt_schemes', 'solvers.alt_laxliu',\n"
        "                     'solvers.run2d_alt', 'solvers.zslab', 'utils.profile', 'utils.flops',\n"
        "                     'utils.memory_footprint', 'analysis.power_spectrum',\n"
        "                     'analysis.structure_functions', 'analysis.projected_density',\n"
        "                     'analysis.read_slice', 'analysis.generate_fbm', 'gui.live_view'))\n"
        "from ramsesgpu_tpu_torch.solvers.run import Run, config_from_ini\n"
        "for text in sys.argv[2:]:\n"
        "    config, params = config_from_ini(text)\n"
        "    Run(config, 'cpu', params).start(max_steps=1, do_output=False)\n"
        "config, params = config_from_ini(sys.argv[1])\n"
        "Run(config, 'cpu', params).start(max_steps=1)\n"
        "config, params = config_from_ini(sys.argv[1].replace(\n"
        "    '[run]\\n', '[run]\\nrestart=yes\\nrestart_filename=ot3d_0000001.nc\\n'))\n"
        "run = Run(config, 'cpu', params)\n"
        "assert run.n_step == 1\n"
        "run.start(max_steps=2)\n"
        "from ramsesgpu_tpu_torch.solvers.run2d_alt import AltSchemeRun\n"
        "from ramsesgpu_tpu_torch.analysis.power_spectrum import velocity_power_spectrum\n"
        "from ramsesgpu_tpu_torch.utils.memory_footprint import estimate\n"
        "from ramsesgpu_tpu_torch.utils.profile import profile_step\n"
        "sod = next(t for t in sys.argv[2:] if '\\nproblem=sod\\n' in t)\n"
        "for scheme in ('godunov-split', 'kurganov', 'laxliu', 'relaxingTVD'):\n"
        "    AltSchemeRun(config_from_ini(sod)[0], 'cpu', scheme).start(max_steps=2,\n"
        "                                                              do_output=False)\n"
        "velocity_power_spectrum(params, run.U)\n"
        "estimate(params, config)\n"
        "profile_step(params, config, 'cpu', reps=1)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'triton'))\n"
        "             or m == 'ramsesgpu_tpu' or m.startswith('ramsesgpu_tpu.'))\n"
        "assert not bad, bad\n"
        "print('OK')\n"
    )
    hydro = (REPO / "data" / "implode3d.ini").read_text().replace("nx=64", "nx=8").replace(
        "ny=64", "ny=8").replace("nz=64", "nz=8")
    mri = (REPO / "data" / "mhd_mri_3d.ini").read_text().replace(
        "nx=16\nny=32\nnz=16", "nx=8\nny=16\nnz=8").replace("compensated=yes", "compensated=no")
    assert "nx=8\n" in mri and "compensated=no" in mri
    # the viscous-resistive MRI (scripts/perf_table.py's Re = 25000, Pm = 4)
    mri_dissip = mri.replace("cIso=0.001", "cIso=0.001\nnu=4e-5").replace(
        "omega0=0.001", "omega0=0.001\neta=1e-5")
    assert "nu=4e-5" in mri_dissip and "eta=1e-5" in mri_dissip
    # the shipped MRI inputs as shipped (Kahan-compensated) but for the mesh:
    # the flagship and the stratified box
    mri_comp = (REPO / "data" / "mhd_mri_3d.ini").read_text().replace(
        "nx=16\nny=32\nnz=16", "nx=8\nny=16\nnz=8")
    strat = (REPO / "data" / "mhd_mri_3d_stratified.ini").read_text().replace(
        "nx=16\nny=64\nnz=128", "nx=8\nny=8\nnz=16")
    assert "compensated=yes" in mri_comp and "nz=16" in strat and "compensated=yes" in strat
    ot = INI.format(n=8, solver="hlld", kernel="auto", outdir=tmp_path, hdf5="no")
    # the dissipative Orszag-Tang run (tests/test_pallas_dissip.py's nu, eta)
    ot_dissip = ot.replace("smallc=1e-7", "smallc=1e-7\nnu=2e-3").replace(
        "magRiemannSolver=hlld", "magRiemannSolver=hlld\neta=1e-3")
    assert "nu=2e-3" in ot_dissip and "eta=1e-3" in ot_dissip
    # and each of them again with [implementation] kernel=zcarry (the walled
    # implode keeps the staged kernel there; the periodic blast streams)
    blast = hydro.replace("problem=implode", "problem=blast")
    for face in ("xmin", "xmax", "ymin", "ymax", "zmin", "zmax"):
        blast = re.sub(rf"boundary_{face}=\d", f"boundary_{face}=3", blast)
    assert "problem=blast" in blast and "boundary_zmax=3" in blast
    # the walled and jet inputs (the ghosted route): 3D Brio-Wu with six
    # NEUMANN faces, the MHD jet (DIRICHLET walls) and the hydro jet
    walls = (REPO / "data" / "testRiemannHLLD.ini").read_text().replace(
        "nx=32\nny=32\nnz=12", "nx=8\nny=8\nnz=6")
    mhd_jet = (REPO / "data" / "mhd_jet3d.ini").read_text().replace(
        "nx=15\nny=15\nnz=60", "nx=8\nny=8\nnz=12").replace("ijet=5", "ijet=3").replace(
        "offsetJet=5", "offsetJet=2")
    hydro_jet = (REPO / "data" / "jet3d_gpu.ini").read_text().replace(
        "nx=50\nny=50\nnz=200", "nx=8\nny=8\nnz=16").replace("ijet=10", "ijet=3").replace(
        "offsetJet=10", "offsetJet=2")
    assert "nz=6" in walls and "ijet=3" in mhd_jet and "nz=16" in hydro_jet
    # a turbulence input (isothermal MHD, the OU forcing, the history file)
    turb = (REPO / "data" / "turbulence_mhd_ou.ini").read_text().replace(
        "nx=32\nny=32\nnz=32", "nx=8\nny=8\nnz=8")
    assert "nx=8\n" in turb and "[history]\nenabled=yes" in turb
    # 2D inputs (the whole-array 2D path): the Sod tube and the rotating,
    # isothermal MHD inertial wave, as shipped but for the mesh
    sod2d = (REPO / "data" / "hydro_sod2d.ini").read_text().replace(
        "nx=128\nny=128", "nx=8\nny=8")
    wave2d = (REPO / "data" / "mhd_inertialWave_2d.ini").read_text().replace(
        "nx=32\nny=32", "nx=8\nny=8")
    assert "nx=8\nny=8\nnz=1" in sod2d and "nx=8\nny=8\nnz=1" in wave2d
    # a gravity input: the 3D MHD Rayleigh-Taylor (the ghosted step's gravity
    # instance), as shipped but for the mesh, with nu and eta (the ghosted
    # dissipation)
    rt_mhd = (REPO / "data" / "rayleigh_taylor_gpu_3d_mhd.ini").read_text().replace(
        "nx=50\nny=50\nnz=200", "nx=8\nny=8\nnz=12").replace(
        "smallc=1e-8", "smallc=1e-8\nnu=1e-4").replace("omega0=0.0", "omega0=0.0\neta=1e-4")
    assert "nz=12" in rt_mhd and "nu=1e-4" in rt_mhd and "eta=1e-4" in rt_mhd
    texts = [ot, hydro, mri, mri_dissip, ot_dissip, mri_comp, strat, walls, mhd_jet, hydro_jet,
             turb, sod2d, wave2d, rt_mhd]
    texts += [zcarry(text) for text in texts + [blast]]
    # checkpoints every step, the other writers, the guard (and, in the
    # code above, a run restarted from the step-1 checkpoint)
    ck = ot.replace("noutput=100", "noutput=1\nfpe_check=yes").replace(
        "outputHdf5=no", "outputHdf5=no\noutputVtk=no\noutputNetcdf=yes\noutputNrrd=yes\n"
        "outputBin=yes\noutputFaces=yes") + "\n[structureFunctions]\nenabled=yes\nnSampleTotal=4\n"
    assert "fpe_check=yes" in ck and "outputFaces=yes" in ck
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code, ck, *texts],
                         capture_output=True, text=True, env=env, timeout=300, cwd=tmp_path)
    assert res.returncode == 0 and res.stdout.strip().endswith("OK"), res.stderr[-4000:]
    assert (tmp_path / "turbulence_mhd_ou.history").read_text().startswith("# totalTime dt mass")
    assert {p.name for p in tmp_path.glob("ot3d_*0000002.*")} == {
        "ot3d_0000002.nc", "ot3d_0000002.bin", "ot3d_sf_0000002.npz",
        *(f"ot3d_{n}_0000002.nrrd" for n in ("density", "energy", "mx", "my", "mz", "bx", "by",
                                             "bz")),
        *(f"ot3d_face_{f}_0000002.npz" for f in ("xmin", "xmax", "ymin", "ymax", "zmin", "zmax"))}


def test_config_copies_match_the_jax_package(data_dir):
    """The port's own copies of config/ and core/ give the JAX package's
    RunParams, field by field, for every shipped INI file."""
    import dataclasses

    from ramsesgpu_tpu_torch.config.configmap import ConfigMap as TConfigMap
    from ramsesgpu_tpu_torch.config.params import params_from_config as t_params_from_config

    files = sorted(Path(data_dir).glob("*.ini"))
    assert len(files) > 50
    for path in files:
        want = params_from_config(ConfigMap(path))
        got = t_params_from_config(TConfigMap(path))
        assert type(got).__module__.startswith("ramsesgpu_tpu_torch.")
        for field in dataclasses.fields(want):
            a, b = getattr(got, field.name), getattr(want, field.name)
            assert a == b and type(a).__name__ == type(b).__name__, (path.name, field.name, a, b)
        assert (got.shape, got.dx, got.smallp, got.gamma6) == (want.shape, want.dx, want.smallp,
                                                              want.gamma6), path.name


def test_cli_runs_on_cpu_and_writes_vti(tmp_path, capsys):
    from ramsesgpu_tpu.io.vtk import read_vti
    from ramsesgpu_tpu_torch.cli.main import main

    ini = tmp_path / "ot3d.ini"
    ini.write_text(INI.format(n=16, solver="hlld", kernel="auto", outdir=tmp_path, hdf5="yes"))
    assert main(["--param", str(ini), "--device", "cpu", "--max-steps", "3"]) == 0
    out = capsys.readouterr().out
    assert "number of time steps   : 3" in out
    for step in (0, 3):
        fields, _extent = read_vti(tmp_path / f"ot3d_{step:07d}.vti")
        assert set(fields) == {"density", "energy", "mx", "my", "mz", "bx", "by", "bz"}
        for a in fields.values():
            assert np.asarray(a).shape == (16, 16, 16) and np.isfinite(a).all()
        assert (tmp_path / f"ot3d_{step:07d}.h5").exists()


def test_run_restores_the_state_when_a_chunk_raises():
    """The chained loop state is unpacked into Run.U even when a chunk
    raises (the JAX Run left U as None there)."""
    from ramsesgpu_tpu_torch.solvers.run import Run

    params, config = params_for(n=8, kernel="pallas")
    run = Run(config, "cpu")
    U0 = run.U.clone()
    pack, advance, unpack = run._chain

    def failing_advance(S, t, n):
        advance(S, t, 1)  # advances S in place, then fails
        raise RuntimeError("chunk failed")

    run._chain = (pack, failing_advance, unpack)
    with pytest.raises(RuntimeError, match="chunk failed"):
        run.start(max_steps=4, do_output=False)
    assert run._S is None and run.U.shape == U0.shape
    assert not torch.equal(run.U, U0)
    assert run.interior().shape == (8, 8, 8, 8)


def test_convert_roundtrip_matches_jax_pack_state():
    from ramsesgpu_tpu.pallas.packed_io import pack_state
    from ramsesgpu_tpu_torch.convert import packed_from_jax, packed_to_jax, state_from_jax

    params, _ = params_for(n=8)
    rng = np.random.default_rng(3)
    U = rng.standard_normal(params.shape).astype(np.float32)
    g = params.ghost_width
    P = np.asarray(pack_state(params, jnp.asarray(U[:, g:-g, g:-g, g:-g])))
    S = packed_from_jax(params, P, "cpu")
    np.testing.assert_array_equal(S.numpy(), U[:, g:-g, g:-g, g:-g])
    np.testing.assert_array_equal(packed_to_jax(params, S), P)
    np.testing.assert_array_equal(state_from_jax(params, U, "cpu").numpy(), U)


@pytest.mark.parametrize("stratified", [False, True])
def test_convert_roundtrip_of_compensated_shear_carries(stratified):
    """The JAX package's compensated shear carry (pack_shear with its 2 * nvar
    channels and the [2, nz, ny] kept face; ``stratified``: the stratified z
    ghost planes in its bands) to the port's loop state and back."""
    from ramsesgpu_tpu.config.configmap import ConfigMap as JConfigMap
    from ramsesgpu_tpu.config.params import params_from_config as j_params
    from ramsesgpu_tpu.pallas.shear_packed import pack_shear
    from ramsesgpu_tpu.solvers.shear import make_all_boundaries_shear
    from ramsesgpu_tpu_torch.config.configmap import ConfigMap as TConfigMap
    from ramsesgpu_tpu_torch.config.params import params_from_config as t_params
    from ramsesgpu_tpu_torch.convert import shear_carry_from_jax, shear_carry_to_jax
    from ramsesgpu_tpu_torch.kernels.shear import pack

    name = "mhd_mri_3d_stratified.ini" if stratified else "mhd_mri_3d.ini"
    text = (REPO / "data" / name).read_text()
    text = text.replace("nx=16\nny=64\nnz=128", "nx=8\nny=8\nnz=16").replace(
        "nx=16\nny=32\nnz=16", "nx=8\nny=16\nnz=8")
    jparams = j_params(JConfigMap(text=text))
    params = t_params(TConfigMap(text=text))
    assert params.compensated and jparams.compensated
    rng = np.random.default_rng(5)
    U = rng.uniform(0.5, 1.5, params.shape).astype(np.float32)
    U = np.array(make_all_boundaries_shear(jparams, jnp.asarray(U), 0.0))
    P, kept = pack_shear(jparams, jnp.asarray(U), stratified=stratified)
    P, kept = np.asarray(P), np.asarray(kept)
    assert P.shape[0] == 16 and kept.shape == (2, params.nz, params.ny)
    state = shear_carry_from_jax(params, (P, kept), "cpu")
    S_p, kept_p = pack(params, torch.from_numpy(U))
    assert torch.equal(state[0], S_p) and torch.equal(state[1], kept_p)
    P2, kept2 = shear_carry_to_jax(params, state, stratified=stratified)
    np.testing.assert_array_equal(P2, P)
    np.testing.assert_array_equal(kept2, kept)


def test_wrappers_take_twins_on_cpu_without_counting():
    from ramsesgpu_tpu_torch.kernels.cfl_mhd import cfl_mhd
    from ramsesgpu_tpu_torch.kernels.mhd_step import mhd_step
    from ramsesgpu_tpu_torch.solvers.boundary import interior
    from ramsesgpu_tpu_torch.solvers.godunov_mhd import mhd_3d_periodic_update
    from ramsesgpu_tpu_torch.problems import init_problem
    from ramsesgpu_tpu_torch.solvers.timestep import dt_from_inv, inv_dt_mhd_periodic

    params, config = params_for(n=8)
    S = interior(params, torch.from_numpy(init_problem(params, config))).contiguous()
    before = (cfl_mhd.launches, mhd_step.launches)
    inv = cfl_mhd(params, S)
    assert torch.equal(inv, inv_dt_mhd_periodic(params, S))
    dt = dt_from_inv(params, inv)
    want = mhd_3d_periodic_update(params, S, dt)
    assert mhd_step.scratch(params, S) is None
    got = mhd_step(params, S.clone(), dt, torch.tensor(True))
    assert torch.equal(got, want)
    assert torch.equal(mhd_step(params, S.clone(), dt, torch.tensor(False)), S)
    assert (cfl_mhd.launches, mhd_step.launches) == before == (0, 0)


@pytest.mark.parametrize(
    "change, exc",
    [
        # a uniform static gravity in a shearing box (static gravity
        # outside it runs: tests/test_torch_gravity.py); isothermal
        # periodic MHD, refused here before, runs (tests/test_torch_forcing.py)
        ({"gravity_z": -1.0, "boundary_xmin": "BC_SHEARINGBOX",
          "boundary_xmax": "BC_SHEARINGBOX", "omega0": 1.0}, NotImplementedError),
        # an MHD face solver neither package computes: the JAX dispatcher's
        # ValueError (LLF and HLL faces run: tests/test_torch_mhd_solvers.py)
        ({"riemann_solver": "HLLC"}, ValueError),
        ({"boundary_xmin": "BC_COPY"}, NotImplementedError),
        ({"omega0": 1.0}, NotImplementedError),
        # the adiabatic stratified box with viscosity (the isothermal one
        # runs: tests/test_torch_stratified.py; no shipped problem gives the
        # adiabatic one a state)
        ({"boundary_xmin": "BC_SHEARINGBOX", "boundary_xmax": "BC_SHEARINGBOX",
          "boundary_zmin": "BC_Z_STRATIFIED", "boundary_zmax": "BC_Z_STRATIFIED",
          "omega0": 1.0, "c_iso": 0.0, "nu": 1e-3}, NotImplementedError),
    ],
)
def test_out_of_slice_configurations_raise(change, exc):
    from ramsesgpu_tpu.core.constants import BoundaryConditionType, RiemannSolver
    from ramsesgpu_tpu_torch.solvers.step import make_advance_n

    from ramsesgpu_tpu_torch.kernels.fused_mhd3d import packed_supported

    params, _ = params_for(n=8)
    enums = {"riemann_solver": RiemannSolver,
             **{f"boundary_{f}": BoundaryConditionType
                for f in ("xmin", "xmax", "ymin", "ymax", "zmin", "zmax")}}
    change = {k: enums[k][v] if k in enums else v for k, v in change.items()}
    assert packed_supported(params)
    assert not packed_supported(params.replace(**change))
    with pytest.raises(exc):
        make_advance_n(params.replace(**change), "cpu")


def test_kernel_jnp_refused_on_cuda():
    """On a CUDA device the twins must not stand in for the kernels."""
    from ramsesgpu_tpu_torch.solvers.step import require_slice

    params, _ = params_for(n=8, kernel="jnp")
    with pytest.raises(ValueError):
        require_slice(params, "cuda")
    require_slice(params, "cpu")
    for kernel in ("auto", "pallas", "zcarry"):
        require_slice(params.replace(kernel=kernel), "cuda")
    with pytest.raises(ValueError):
        require_slice(params.replace(kernel="auto"), "meta")


def test_build_dir_in_checkout_or_override(monkeypatch, tmp_path):
    from ramsesgpu_tpu_torch.kernels.build import build_dir

    monkeypatch.delenv("RAMSES_TORCH_BUILD_DIR", raising=False)
    assert build_dir() == REPO / "build" / "ramsesgpu_tpu_torch"
    monkeypatch.setenv("RAMSES_TORCH_BUILD_DIR", str(tmp_path))
    assert build_dir() == tmp_path
