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
# each of the shear step's x-face planes before the remap on its own: they
# are differences of much larger terms (chip_smoke.py TOL_PLANES)
TOL_PLANES = {"float32": 1e-4, "float64": 1e-12}


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


# the ideal MRI shearing box: tests/test_shear.py's box on an uneven mesh,
# with the JAX shear tests' coefficients (omega0 = cIso = 1)
MRI_INI = """
[run]
tend={tend}
[mesh]
nx=32
ny=24
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
cIso={ciso}
slope_type=2.0
riemannSolver=hlld
smallr=1e-8
smallc=1e-8
[MHD]
enable=true
magRiemannSolver=hlld
omega0=1.0
[MRI]
beta=400.0
type=noflux
amp=0.2
seed=3
[implementation]
dtype={dtype}
"""


def mri_state(dtype, device, tend=100.0, ciso=1.0):
    """params, the loop state (S, kept) and a t0 whose shear offset is 2.5
    cells (at t = 0 the sheared fill is periodic). The state is always the
    isothermal box's (with cIso = 0 the MRI init is a uniform state at rest),
    stepped with cIso = ciso."""
    from ramsesgpu_tpu_torch.convert import torch_dtype
    from ramsesgpu_tpu_torch.kernels.shear import pack
    from ramsesgpu_tpu_torch.problems import init_problem
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries

    init_config = ConfigMap(text=MRI_INI.format(dtype=dtype, tend=tend, ciso=1.0))
    params = params_from_config(ConfigMap(text=MRI_INI.format(dtype=dtype, tend=tend, ciso=ciso)))
    U = torch.from_numpy(init_problem(params_from_config(init_config), init_config)).to(
        device, torch_dtype(params))
    t0 = 2.5 * params.dy / (1.5 * params.omega0 * params.dx * params.nx)
    return params, pack(params, make_boundaries(params, U)), torch.tensor(
        t0, dtype=U.dtype, device=device)


def rel_l2(a, b):
    return float(torch.linalg.norm((a - b).flatten()) / torch.linalg.norm(b.flatten()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("ciso", [1.0, 0.0])
def test_shear_kernels_match_twins(cuda_device, dtype, ciso):
    """Each shear kernel against its twin on the same inputs: the CFL with
    the kept face (and NaN), the sheared slabs, the step's shear mode and
    its x-face planes, the remap / border / kept-face kernel."""
    from ramsesgpu_tpu_torch.kernels.cfl_mhd import cfl_mhd
    from ramsesgpu_tpu_torch.kernels.mhd_step import mhd_step
    from ramsesgpu_tpu_torch.kernels.shear_border import shear_border, shear_slabs
    from ramsesgpu_tpu_torch.solvers.godunov_mhd import mhd_3d_shear_update, shear_border_update
    from ramsesgpu_tpu_torch.solvers.shear import shear_slabs as slabs_twin
    from ramsesgpu_tpu_torch.solvers.timestep import dt_from_inv, inv_dt_mhd_shear

    params, (S, kept), t0 = mri_state(dtype, cuda_device, ciso=ciso)
    inv, inv_ref = cfl_mhd(params, S, kept=kept), inv_dt_mhd_shear(params, S, kept)
    assert abs(float(inv) - float(inv_ref)) <= TOL[dtype] * float(inv_ref)
    dt = dt_from_inv(params, inv_ref)
    active = torch.ones((), dtype=torch.bool, device=cuda_device)
    slabs_t = slabs_twin(params, S, kept, t0 + dt)
    assert rel_l2(shear_slabs(params, S, kept, t0, dt), slabs_t) <= TOL[dtype]
    planes = torch.zeros((5, params.nz, params.ny), dtype=S.dtype, device=cuda_device)
    S1 = mhd_step(params, S.clone(), dt, active, mhd_step.scratch(params, S),
                  shear=(slabs_t, planes))
    S1_t, planes_t = mhd_3d_shear_update(params, S, slabs_t, dt)
    assert rel_l2(S1, S1_t) <= TOL[dtype] and rel_l2(planes, planes_t) <= TOL[dtype]
    for c in range(5):
        assert rel_l2(planes[c], planes_t[c]) <= TOL_PLANES[dtype], c
    S2, kept2 = S1_t.clone(), kept.clone()
    rem = shear_border(params, S2, kept2, planes_t, t0, dt, active)
    S2_t, kept2_t, rem_t = shear_border_update(params, S1_t, kept, planes_t, t0, dt)
    assert rel_l2(S2, S2_t) <= TOL[dtype] and rel_l2(rem, rem_t) <= TOL[dtype]
    assert float((kept2 - kept2_t).abs().max()) <= TOL[dtype] * float(S[5:].abs().max())
    # each output of the border kernel on its own
    for c in range(4):
        assert rel_l2(rem[c], rem_t[c]) <= TOL[dtype], c
    for ch in (0, 5, 7):  # the channels it changes on the border columns
        cols = (0, params.nx - 1)
        assert rel_l2(S2[ch][..., cols], S2_t[ch][..., cols]) <= TOL[dtype], ch
    assert rel_l2(kept2, kept2_t) <= TOL[dtype]
    S[0, 3, 4, 5] = float("nan")
    assert torch.isnan(cfl_mhd(params, S, kept=kept))


@pytest.mark.cuda
def test_shear_loop_counts_launches_and_stops_at_t_end(cuda_device):
    from ramsesgpu_tpu_torch.kernels.cfl_mhd import cfl_mhd
    from ramsesgpu_tpu_torch.kernels.mhd_step import mhd_step
    from ramsesgpu_tpu_torch.kernels.shear_border import shear_border, shear_slabs
    from ramsesgpu_tpu_torch.solvers.step import make_packed_advance_chain

    wrappers = (cfl_mhd, mhd_step, shear_slabs, shear_border)
    params, state0, t0 = mri_state("float32", cuda_device)
    _pack, advance, unpack = make_packed_advance_chain(params, cuda_device)
    before = [w.launches for w in wrappers]
    S3, t3, k = advance(tuple(x.clone() for x in state0), t0, 3)
    assert int(k) == 3
    assert [w.launches - b for w, b in zip(wrappers, before)] == [3, 3, 3, 3]
    _, t2, _ = advance(tuple(x.clone() for x in state0), t0, 2)

    # t_end between the ends of steps 2 and 3: a 10-step chunk runs 3
    params_end, _, _ = mri_state("float32", cuda_device, tend=0.5 * (float(t2) + float(t3)))
    _, advance_end, _ = make_packed_advance_chain(params_end, cuda_device)
    state, t, k = advance_end(tuple(x.clone() for x in state0), t0, 10)
    assert int(k) == 3 and float(t) == float(t3)
    assert all(torch.equal(a, b) for a, b in zip(state, S3))
    assert unpack(state, t).shape == params.shape


# the viscous-resistive sub-step (kernels/dissip_step.py), with the JAX
# dissipation tests' coefficients (tests/test_pallas_dissip.py) and each
# term alone
DISSIP_COEFFS = [(2e-3, 1e-3), (0.0, 1e-3), (2e-3, 0.0)]


def increment_rel(got, want, start):
    """Relative L2 of the kernel's increment against the twin's, over the
    twin's increment: the dissipative change is orders of magnitude below
    the state, whose norm would hide a wrong term. Where the twin changes
    nothing, 0 if the kernel changes nothing either, else inf."""
    if torch.equal(want, start):
        return 0.0 if torch.equal(got, start) else float("inf")
    return rel_l2(got - start, want - start)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("mode, ciso", [("periodic", 0.0), ("shear", 1.0), ("shear", 0.0)])
def test_dissip_kernel_matches_twin(cuda_device, dtype, mode, ciso):
    """The dissipation kernel's increment, and in the shear mode the kept
    face's change, each against the twin's on the same inputs; the
    inactive kernel changes nothing."""
    from ramsesgpu_tpu_torch.core.constants import IA
    from ramsesgpu_tpu_torch.kernels.dissip_step import dissip_step
    from ramsesgpu_tpu_torch.solvers.dissipation import (kept_face_resistive_ct,
                                                          mhd_dissipation_periodic_update,
                                                          mhd_dissipation_shear_update)
    from ramsesgpu_tpu_torch.solvers.shear import shear_slabs
    from ramsesgpu_tpu_torch.solvers.timestep import dt_from_inv, inv_dt_mhd_periodic, inv_dt_mhd_shear

    for nu, eta in DISSIP_COEFFS:
        if mode == "periodic":
            params, S = ot_state(dtype, cuda_device)
            params = params.replace(nu=nu, eta=eta)
            dt = dt_from_inv(params, inv_dt_mhd_periodic(params, S))
            shear, want = None, mhd_dissipation_periodic_update(params, S, dt)
        else:
            params, (S, kept), t0 = mri_state(dtype, cuda_device, ciso=ciso)
            params = params.replace(nu=nu, eta=eta)
            # the initial field varies in x only, so its resistive change of
            # the kept face vanishes: perturb every field component
            gen = torch.Generator(device=cuda_device).manual_seed(5)
            scale = 0.2 * float(S[7].abs().max())
            S[5:] += scale * torch.randn(S[5:].shape, generator=gen, device=cuda_device,
                                         dtype=S.dtype)
            kept += scale * torch.randn(kept.shape, generator=gen, device=cuda_device,
                                        dtype=S.dtype)
            dt = dt_from_inv(params, inv_dt_mhd_shear(params, S, kept))
            slabs = shear_slabs(params, S, kept, t0 + dt)
            want, eypl, ezpl = mhd_dissipation_shear_update(params, S, slabs, dt)
            kept_want = (kept_face_resistive_ct(params, kept, eypl, ezpl, dt) if eta > 0
                         else kept)
            kept_got = kept.clone()
            shear = (slabs, kept_got)
        scratch = dissip_step.scratch(params, S)
        off = torch.zeros((), dtype=torch.bool, device=cuda_device)
        assert torch.equal(dissip_step(params, S.clone(), dt, off, scratch, shear=shear), S)
        got = dissip_step(params, S.clone(), dt, ~off, scratch, shear=shear)
        assert increment_rel(got, want, S) <= TOL[dtype], (nu, eta)
        if mode == "shear":
            assert torch.equal(slabs[1, IA, ..., 0], kept)
            if eta > 0:
                assert increment_rel(kept_got, kept_want, kept) <= TOL[dtype], (nu, eta)
            else:
                assert torch.equal(kept_got, kept)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["periodic", "shear"])
def test_dissip_loops_count_launches_and_stop_at_t_end(cuda_device, mode):
    """Each step of a dissipative loop launches the dissipation kernel once
    (and, in the shearing box, the slab kernel twice); the loop stops at
    t_end as the ideal one does."""
    from ramsesgpu_tpu_torch.kernels.cfl_mhd import cfl_mhd
    from ramsesgpu_tpu_torch.kernels.dissip_step import dissip_step
    from ramsesgpu_tpu_torch.kernels.mhd_step import mhd_step
    from ramsesgpu_tpu_torch.kernels.shear_border import shear_border, shear_slabs
    from ramsesgpu_tpu_torch.solvers.step import make_packed_advance_chain

    wrappers = (cfl_mhd, mhd_step, dissip_step, shear_slabs, shear_border)
    nu, eta = DISSIP_COEFFS[0]

    def setup(tend=100.0):
        if mode == "periodic":
            params, S = ot_state("float32", cuda_device, tend=tend)
            return params.replace(nu=nu, eta=eta), S, torch.zeros((), device=cuda_device)
        params, state, t0 = mri_state("float32", cuda_device, tend=tend, ciso=0.0)
        return params.replace(nu=nu, eta=eta), state, t0

    def fresh(state):
        return tuple(x.clone() for x in state) if isinstance(state, tuple) else state.clone()

    params, state0, t0 = setup()
    _pack, advance, unpack = make_packed_advance_chain(params, cuda_device)
    before = [w.launches for w in wrappers]
    S3, t3, k = advance(fresh(state0), t0, 3)
    assert int(k) == 3
    per_step = [1, 1, 1, 0, 0] if mode == "periodic" else [1, 1, 1, 2, 1]
    assert [w.launches - b for w, b in zip(wrappers, before)] == [3 * c for c in per_step]
    _, t2, _ = advance(fresh(state0), t0, 2)

    # t_end between the ends of steps 2 and 3: a 10-step chunk runs 3
    params_end, _, _ = setup(tend=0.5 * (float(t2) + float(t3)))
    _, advance_end, _ = make_packed_advance_chain(params_end, cuda_device)
    state, t, k = advance_end(fresh(state0), t0, 10)
    assert int(k) == 3 and float(t) == float(t3)
    pairs = zip(state, S3) if mode == "shear" else [(state, S3)]
    assert all(torch.equal(a, b) for a, b in pairs)
    assert unpack(state, t).shape == params.shape
