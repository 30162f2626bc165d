"""GPU-only tests of the PyTorch port's CUDA kernels against their plain
twins. They skip without a card. This file imports nothing of JAX or of the
JAX package (the machine with the card has no jax), so on the card run it
without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""
import pytest
import torch

from ramsesgpu_tpu_torch.config.configmap import ConfigMap
from ramsesgpu_tpu_torch.config.params import params_from_config

INI = """
[run]
tend={tend}
[mesh]
nx=32
ny=24
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
"""
# relative L2 of kernel vs twin after one step (ULP-level differences:
# FMA contraction, rsqrtf)
TOL = {"float32": 1e-6, "float64": 1e-13}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (on the card: pytest --noconftest -m cuda)")
    return torch.device("cuda")


def ot_state(dtype, device, tend=100.0):
    from ramsesgpu_tpu_torch.convert import torch_dtype
    from ramsesgpu_tpu_torch.solvers.boundary import interior
    from ramsesgpu_tpu_torch.problems import init_problem

    config = ConfigMap(text=INI.format(dtype=dtype, tend=tend))
    params = params_from_config(config)
    U = torch.from_numpy(init_problem(params, config)).to(device, torch_dtype(params))
    return params, interior(params, U).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_kernels_match_twins(cuda_device, dtype):
    from ramsesgpu_tpu_torch.kernels.cfl_mhd import cfl_mhd
    from ramsesgpu_tpu_torch.kernels.mhd_step import mhd_step
    from ramsesgpu_tpu_torch.solvers.godunov_mhd import mhd_3d_periodic_update
    from ramsesgpu_tpu_torch.solvers.timestep import dt_from_inv, inv_dt_mhd_periodic

    params, S = ot_state(dtype, cuda_device)
    inv, inv_ref = cfl_mhd(params, S), inv_dt_mhd_periodic(params, S)
    assert abs(float(inv) - float(inv_ref)) <= TOL[dtype] * float(inv_ref)
    dt = dt_from_inv(params, inv_ref)
    want = mhd_3d_periodic_update(params, S, dt)
    active = torch.ones((), dtype=torch.bool, device=cuda_device)
    got = mhd_step(params, S.clone(), dt, active, mhd_step.scratch(params, S))
    err = torch.linalg.norm((got - want).flatten()) / torch.linalg.norm(want.flatten())
    assert float(err) <= TOL[dtype]


@pytest.mark.cuda
def test_kernel_loop_counts_launches_and_stops_at_t_end(cuda_device):
    from ramsesgpu_tpu_torch.kernels.cfl_mhd import cfl_mhd
    from ramsesgpu_tpu_torch.kernels.mhd_step import mhd_step
    from ramsesgpu_tpu_torch.solvers.step import make_packed_advance_chain

    params, S0 = ot_state("float32", cuda_device)
    pack, advance, unpack = make_packed_advance_chain(params, cuda_device)
    t0 = torch.zeros((), device=cuda_device)
    before = (cfl_mhd.launches, mhd_step.launches)
    S3, t3, k = advance(S0.clone(), t0, 3)
    assert int(k) == 3
    assert (cfl_mhd.launches, mhd_step.launches) == (before[0] + 3, before[1] + 3)
    _, t2, _ = advance(S0.clone(), t0, 2)

    # t_end between the ends of steps 2 and 3: a 10-step chunk runs 3
    params_end, S0 = ot_state("float32", cuda_device, tend=0.5 * (float(t2) + float(t3)))
    _, advance_end, _ = make_packed_advance_chain(params_end, cuda_device)
    S, t, k = advance_end(S0.clone(), t0, 10)
    assert int(k) == 3 and float(t) == float(t3)
    assert torch.equal(S, S3)
    assert unpack(S, t).shape == params.shape


# 3D hydro: data/implode3d.ini (reflecting walls) and a periodic blast, on
# an uneven mesh
HYDRO_INI = """
[run]
tend={tend}
[mesh]
nx=32
ny=24
nz=16
boundary_xmin={bc}
boundary_xmax={bc}
boundary_ymin={bc}
boundary_ymax={bc}
boundary_zmin={bc}
boundary_zmax={bc}
[hydro]
problem={problem}
niter_riemann=10
slope_type=1.0
cfl=0.8
riemannSolver={solver}
cIso={ciso}
[blast]
radius=0.2
[implementation]
dtype={dtype}
"""


def hydro_state(dtype, device, problem="implode", solver="approx", tend=100.0, ciso=0.0):
    from ramsesgpu_tpu_torch.convert import torch_dtype
    from ramsesgpu_tpu_torch.problems import init_problem
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries

    bc = 1 if problem == "implode" else 3
    config = ConfigMap(text=HYDRO_INI.format(dtype=dtype, tend=tend, problem=problem, bc=bc,
                                             solver=solver, ciso=ciso))
    params = params_from_config(config)
    U = torch.from_numpy(init_problem(params, config)).to(device, torch_dtype(params))
    return params, make_boundaries(params, U)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("problem", ["implode", "blast"])
@pytest.mark.parametrize("solver", ["approx", "hll", "hllc"])
def test_hydro_kernels_match_twins(cuda_device, dtype, problem, solver):
    """Both modes of the step kernel and the CFL kernel against their
    twins; the two step modes bitwise equal."""
    from ramsesgpu_tpu_torch.kernels.cfl_hydro import cfl_hydro
    from ramsesgpu_tpu_torch.kernels.hydro_step import hydro_step
    from ramsesgpu_tpu_torch.solvers.boundary import interior
    from ramsesgpu_tpu_torch.solvers.godunov import hydro_3d_state_update
    from ramsesgpu_tpu_torch.solvers.timestep import compute_inv_dt_hydro, dt_from_inv

    params, U = hydro_state(dtype, cuda_device, problem, solver)
    S = interior(params, U).contiguous()
    inv_ref = compute_inv_dt_hydro(params, S, ghost=0)
    for inv in (cfl_hydro(params, S), cfl_hydro(params, U, ghost=params.ghost_width)):
        assert abs(float(inv) - float(inv_ref)) <= TOL[dtype] * float(inv_ref)
    dt = dt_from_inv(params, inv_ref)
    want = hydro_3d_state_update(params, S, dt)
    active = torch.ones((), dtype=torch.bool, device=cuda_device)
    got = hydro_step(params, S.clone(), dt, active, hydro_step.scratch(params, S))
    err = torch.linalg.norm((got - want).flatten()) / torch.linalg.norm(want.flatten())
    assert float(err) <= TOL[dtype]
    ghosted = hydro_step.ghosted(params, U, dt, hydro_step.scratch(params, U, ghosted=True))
    assert torch.equal(ghosted, got)


@pytest.mark.cuda
def test_hydro_isothermal_and_nan(cuda_device):
    """The isothermal EOS (cIso > 0) in both kernels; a NaN cell gives a
    NaN inverse dt."""
    from ramsesgpu_tpu_torch.kernels.cfl_hydro import cfl_hydro
    from ramsesgpu_tpu_torch.kernels.hydro_step import hydro_step
    from ramsesgpu_tpu_torch.solvers.boundary import interior
    from ramsesgpu_tpu_torch.solvers.godunov import hydro_3d_state_update
    from ramsesgpu_tpu_torch.solvers.timestep import compute_inv_dt_hydro, dt_from_inv

    params, U = hydro_state("float32", cuda_device, solver="hllc", ciso=0.7)
    S = interior(params, U).contiguous()
    inv, inv_ref = cfl_hydro(params, S), compute_inv_dt_hydro(params, S, ghost=0)
    assert abs(float(inv) - float(inv_ref)) <= TOL["float32"] * float(inv_ref)
    dt = dt_from_inv(params, inv_ref)
    want = hydro_3d_state_update(params, S, dt)
    active = torch.ones((), dtype=torch.bool, device=cuda_device)
    got = hydro_step(params, S.clone(), dt, active, hydro_step.scratch(params, S))
    err = torch.linalg.norm((got - want).flatten()) / torch.linalg.norm(want.flatten())
    assert float(err) <= TOL["float32"]
    S[2, 3, 4, 5] = float("nan")
    assert torch.isnan(cfl_hydro(params, S))


@pytest.mark.cuda
def test_hydro_loop_counts_launches_and_stops_at_t_end(cuda_device):
    from ramsesgpu_tpu_torch.kernels.cfl_hydro import cfl_hydro
    from ramsesgpu_tpu_torch.kernels.hydro_step import hydro_step
    from ramsesgpu_tpu_torch.solvers.step import make_packed_advance_chain

    params, U0 = hydro_state("float32", cuda_device)
    pack, advance, unpack = make_packed_advance_chain(params, cuda_device)
    t0 = torch.zeros((), device=cuda_device)
    before = (cfl_hydro.launches, hydro_step.launches)
    S3, t3, k = advance(pack(U0), t0, 3)
    assert int(k) == 3
    assert (cfl_hydro.launches, hydro_step.launches) == (before[0] + 3, before[1] + 3)
    _, t2, _ = advance(pack(U0), t0, 2)

    # t_end between the ends of steps 2 and 3: a 10-step chunk runs 3
    params_end, _ = hydro_state("float32", cuda_device, tend=0.5 * (float(t2) + float(t3)))
    _, advance_end, _ = make_packed_advance_chain(params_end, cuda_device)
    S, t, k = advance_end(pack(U0), t0, 10)
    assert int(k) == 3 and float(t) == float(t3)
    assert torch.equal(S, S3)
    assert unpack(S, t).shape == params.shape
