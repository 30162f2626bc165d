"""GPU-only tests of the PyTorch port's CUDA kernels against their plain
twins. They skip without a card. This file imports no JAX (the machine with
the card has none), so on the card run it without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""
import pytest
import torch

from ramsesgpu_tpu.config.configmap import ConfigMap
from ramsesgpu_tpu.config.params import params_from_config

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
    from ramsesgpu_tpu_torch.solvers.run import init_state

    config = ConfigMap(text=INI.format(dtype=dtype, tend=tend))
    params = params_from_config(config)
    U = torch.from_numpy(init_state(params, config)).to(device, torch_dtype(params))
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
