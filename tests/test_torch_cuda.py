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


def ot_state(dtype, device, tend=100.0, mesh=(32, 24, 16)):
    from ramsesgpu_tpu_torch.convert import torch_dtype
    from ramsesgpu_tpu_torch.solvers.boundary import interior
    from ramsesgpu_tpu_torch.problems import init_problem

    text = INI.format(dtype=dtype, tend=tend)
    for key, n in zip(("nx", "ny", "nz"), mesh):
        text = text.replace(f"{key}={dict(nx=32, ny=24, nz=16)[key]}\n", f"{key}={n}\n")
    config = ConfigMap(text=text)
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
nx={nx}
ny={ny}
nz={nz}
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


def hydro_state(dtype, device, problem="implode", solver="approx", tend=100.0, ciso=0.0,
                mesh=(32, 24, 16)):
    from ramsesgpu_tpu_torch.convert import torch_dtype
    from ramsesgpu_tpu_torch.problems import init_problem
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries

    bc = 1 if problem == "implode" else 3
    config = ConfigMap(text=HYDRO_INI.format(dtype=dtype, tend=tend, problem=problem, bc=bc,
                                             solver=solver, ciso=ciso, nx=mesh[0], ny=mesh[1],
                                             nz=mesh[2]))
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
    got = hydro_step(params, S, torch.empty_like(S), dt, active)
    err = torch.linalg.norm((got - want).flatten()) / torch.linalg.norm(want.flatten())
    assert float(err) <= TOL[dtype]
    ghosted = hydro_step.ghosted(params, U, dt)
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
    got = hydro_step(params, S, torch.empty_like(S), dt, active)
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


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["implode", "blast-folded", "in-place"])
def test_hydro_stream_partial_tiles(cuda_device, case):
    """The streamed hydro body on a grid that no tile divides (36 x 20 x 11):
    the step kernel's interior mode with reflecting walls, row 13 on the
    periodic blast (its inverse dt against the CFL kernel's, 4 ULP) and the
    in-place ghosted step, each against its twin; inactive steps copy or
    leave the state."""
    from ramsesgpu_tpu_torch.kernels.cfl_hydro import cfl_hydro
    from ramsesgpu_tpu_torch.kernels.hydro_step import hydro_step
    from ramsesgpu_tpu_torch.kernels.zcarry_hydro3d import zcarry_hydro
    from ramsesgpu_tpu_torch.solvers.boundary import interior
    from ramsesgpu_tpu_torch.solvers.godunov import (hydro_3d_interior_update,
                                                     hydro_3d_state_update)
    from ramsesgpu_tpu_torch.solvers.timestep import compute_inv_dt_hydro, dt_from_inv

    params, U = hydro_state("float32", cuda_device, "blast" if case == "blast-folded"
                            else "implode", mesh=(36, 20, 11))
    S = interior(params, U).contiguous()
    dt = dt_from_inv(params, compute_inv_dt_hydro(params, S, ghost=0))
    on = torch.ones((), dtype=torch.bool, device=cuda_device)
    off = torch.zeros_like(on)
    if case == "in-place":
        want = hydro_3d_interior_update(params, U, dt)
        got, buf = U.clone(), hydro_step.scratch(params, U)
        hydro_step.ghosted_(params, got, dt, off, buf)
        assert torch.equal(got, U)
        hydro_step.ghosted_(params, got, dt, on, buf)
        assert rel_l2(interior(params, got), want) <= TOL["float32"]
        interior(params, got).copy_(interior(params, U))
        assert torch.equal(got, U)  # the ghosts stay
        return
    want = hydro_3d_state_update(params, S, dt)
    out = torch.full_like(S, float("nan"))
    if case == "blast-folded":
        inv = zcarry_hydro(params, S, out, dt, on)
        assert ulp_close(inv, cfl_hydro(params, out))
    else:
        hydro_step(params, S, out, dt, on)
    assert rel_l2(out, want) <= TOL["float32"]
    hydro_step(params, S, out, dt, off)
    assert torch.equal(out, S)


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
        off = torch.zeros((), dtype=torch.bool, device=cuda_device)
        assert torch.equal(dissip_step(params, S, torch.full_like(S, float("nan")), dt, off,
                                       shear=shear), S)
        got = dissip_step(params, S, torch.empty_like(S), dt, ~off, shear=shear)
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


# the Kahan-compensated state and the stratified MRI (the shipped
# data/mhd_mri_3d.ini and data/mhd_mri_3d_stratified.ini, compensated)
def shipped_mri(name, dtype, device, mesh):
    """A shipped MRI input at ``mesh`` as shipped otherwise: params, config,
    the loop state (S [16, ...], kept [2, nz, ny]) with non-zero carries
    (eps |u| N(0, 1)), t0 (shear offset 2.5 cells) and g_z."""
    from pathlib import Path

    from ramsesgpu_tpu_torch.convert import torch_dtype
    from ramsesgpu_tpu_torch.kernels.shear import pack
    from ramsesgpu_tpu_torch.problems import init_problem
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries
    from ramsesgpu_tpu_torch.solvers.step import gravity_z

    config = ConfigMap(Path(__file__).resolve().parent.parent / "data" / name)
    for axis, n in zip(("nx", "ny", "nz"), mesh):
        config.set_integer("mesh", axis, n)
    config.set_string("implementation", "dtype", dtype)
    params = params_from_config(config)
    assert params.compensated
    U = make_boundaries(params, torch.from_numpy(init_problem(params, config)).to(
        device, torch_dtype(params)))
    S, kept = pack(params, U)
    gen = torch.Generator(device=device).manual_seed(9)
    eps = torch.finfo(S.dtype).eps
    S[8:] = eps * S[:8] * torch.randn(S[:8].shape, generator=gen, device=device, dtype=S.dtype)
    kept[1] = eps * kept[0] * torch.randn(kept[0].shape, generator=gen, device=device,
                                          dtype=S.dtype)
    t0 = 2.5 * params.dy / (1.5 * params.omega0 * params.dx * params.nx)
    return (params, config, (S, kept), torch.tensor(t0, dtype=S.dtype, device=device),
            gravity_z(params, config, device))


def own_update(params, S, scratch, dt, gz=None):
    """The twin's update stage on the fluxes and EMFs the last launch left in
    ``scratch`` (compensated: bitwise the kernel's)."""
    from ramsesgpu_tpu_torch.kernels.mhd_step import scratch_fluxes
    from ramsesgpu_tpu_torch.solvers.godunov_mhd import mhd_apply_update

    fluxes, emfs, x0, z0 = scratch_fluxes(params, scratch)
    gzw = None if gz is None else gz[3 - z0:3 - z0 + fluxes[0].shape[1]].view(-1, 1, 1)
    return mhd_apply_update(params, S[:8], fluxes, emfs, dt, x0, z0, comp=S[8:], gz=gzw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", ["mhd_mri_3d.ini", "mhd_mri_3d_stratified.ini"])
def test_compensated_and_stratified_kernels_match_twins(cuda_device, dtype, name):
    """The compensated (and stratified) MRI kernels against their twins from
    non-zero carries: the CFL, the z slabs bitwise, the step's state within
    TOL and its update stage on its own fluxes bitwise, the border kernel
    (state, carries, kept face and its carry) bitwise."""
    from ramsesgpu_tpu_torch.kernels.cfl_mhd import cfl_mhd
    from ramsesgpu_tpu_torch.kernels.mhd_step import mhd_step
    from ramsesgpu_tpu_torch.kernels.mhd_step import zslab_shape
    from ramsesgpu_tpu_torch.kernels.shear_border import shear_border, shear_slabs
    from ramsesgpu_tpu_torch.solvers.godunov_mhd import mhd_3d_shear_update, shear_border_update
    from ramsesgpu_tpu_torch.solvers.shear import shear_slabs as slabs_twin, stratified_zslabs
    from ramsesgpu_tpu_torch.solvers.timestep import dt_from_inv, inv_dt_mhd_shear

    params, _config, (S, kept), t0, gz = shipped_mri(name, dtype, cuda_device, (16, 32, 32))
    inv, inv_ref = cfl_mhd(params, S, kept=kept), inv_dt_mhd_shear(params, S, kept[0])
    assert abs(float(inv) - float(inv_ref)) <= TOL[dtype] * float(inv_ref)
    dt = dt_from_inv(params, inv_ref)
    active = torch.ones((), dtype=torch.bool, device=cuda_device)
    zslabs = None if gz is None else torch.empty(zslab_shape(params), dtype=S.dtype,
                                                 device=cuda_device)
    slabs = shear_slabs(params, S, kept, t0, dt, zout=zslabs)
    assert torch.equal(slabs, slabs_twin(params, S[:8], kept[0], t0 + dt))
    shear = (slabs, torch.zeros((5, params.nz, params.ny), dtype=S.dtype, device=cuda_device))
    if gz is not None:
        assert torch.equal(zslabs, stratified_zslabs(params, S[:8], slabs))
        shear = shear + (zslabs, gz)
    scratch = mhd_step.scratch(params, S)
    S1 = mhd_step(params, S.clone(), dt, active, scratch, shear=shear)
    assert torch.equal(S1, own_update(params, S, scratch, dt, gz))
    S1_t, planes_t = mhd_3d_shear_update(params, S, slabs, dt, zslabs, gz)
    assert rel_l2(S1[:8], S1_t[:8]) <= TOL[dtype]
    S2, kept2 = S1_t.clone(), kept.clone()
    rem = shear_border(params, S2, kept2, planes_t, t0, dt, active)
    S2_t, kept2_t, rem_t = shear_border_update(params, S1_t, kept, planes_t, t0, dt)
    assert torch.equal(S2, S2_t) and torch.equal(kept2, kept2_t) and torch.equal(rem, rem_t)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_compensated_periodic_kernels_match_twins(cuda_device, dtype):
    """The compensated periodic step (its update stage on its own fluxes
    bitwise, the state within TOL) and dissipative sub-step (bitwise) from a
    non-zero carry."""
    from ramsesgpu_tpu_torch.kernels.dissip_step import dissip_step
    from ramsesgpu_tpu_torch.kernels.mhd_step import mhd_step
    from ramsesgpu_tpu_torch.solvers.dissipation import mhd_dissipation_periodic_update
    from ramsesgpu_tpu_torch.solvers.godunov_mhd import mhd_3d_periodic_update
    from ramsesgpu_tpu_torch.solvers.timestep import dt_from_inv, inv_dt_mhd_periodic

    params, S8 = ot_state(dtype, cuda_device)
    params = params.replace(compensated=True, nu=2e-3, eta=1e-3)
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    C = torch.finfo(S8.dtype).eps * S8 * torch.randn(S8.shape, generator=gen, device=cuda_device,
                                                     dtype=S8.dtype)
    S = torch.cat([S8, C]).contiguous()
    dt = dt_from_inv(params, inv_dt_mhd_periodic(params, S8))
    active = torch.ones((), dtype=torch.bool, device=cuda_device)
    scratch = mhd_step.scratch(params, S)
    S1 = mhd_step(params, S.clone(), dt, active, scratch)
    assert torch.equal(S1, own_update(params, S, scratch, dt))
    assert rel_l2(S1[:8], mhd_3d_periodic_update(params, S, dt)[:8]) <= TOL[dtype]
    S2 = dissip_step(params, S1, torch.empty_like(S1), dt, active)
    assert torch.equal(S2, mhd_dissipation_periodic_update(params, S1, dt))


@pytest.mark.cuda
def test_stratified_loop_counts_launches(cuda_device):
    """Each step of the stratified MRI loop launches the CFL, the slab
    kernel (x and z slabs), the step and the border kernel once; the loop
    equals the twins' loop within TOL after 3 steps."""
    from ramsesgpu_tpu_torch.kernels.cfl_mhd import cfl_mhd
    from ramsesgpu_tpu_torch.kernels.mhd_step import mhd_step
    from ramsesgpu_tpu_torch.kernels.shear_border import shear_border, shear_slabs
    from ramsesgpu_tpu_torch.solvers.godunov_mhd import mhd_3d_shear_step
    from ramsesgpu_tpu_torch.solvers.step import make_packed_advance_chain
    from ramsesgpu_tpu_torch.solvers.timestep import dt_from_inv, inv_dt_mhd_shear

    wrappers = (cfl_mhd, shear_slabs, mhd_step, shear_border)
    params, config, state0, t0, gz = shipped_mri("mhd_mri_3d_stratified.ini", "float32",
                                                 cuda_device, (16, 32, 32))
    _pack, advance, unpack = make_packed_advance_chain(params, cuda_device, config)
    before = [w.launches for w in wrappers]
    state, t, k = advance(tuple(x.clone() for x in state0), t0, 3)
    assert int(k) == 3
    assert [w.launches - b for w, b in zip(wrappers, before)] == [3] * 4
    twin, t_t = state0, t0
    for _ in range(3):
        dt = dt_from_inv(params, inv_dt_mhd_shear(params, twin[0], twin[1][0]))
        twin, t_t = mhd_3d_shear_step(params, *twin, t_t, dt, gz), t_t + dt
    assert rel_l2(state[0][:8], twin[0][:8]) <= 1e-5  # chained steps (chip_smoke.py TOL_STEP10)
    assert float(t) == float(t_t)
    assert unpack(state, t).shape == params.shape


# ---------------------------------------------------------------------------
# the z-streaming step kernels ([implementation] kernel=zcarry)
# ---------------------------------------------------------------------------
def ulp_close(a, b, ulps=4) -> bool:
    """|a - b| within `ulps` units of the last place of b (0-d tensors)."""
    eps = torch.finfo(b.dtype).eps
    return abs(float(a) - float(b)) <= ulps * eps * abs(float(b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("mode", ["periodic", "compensated", "shear-iso", "shear-adiabatic",
                                  "stratified"])
def test_zcarry_mhd_matches_twin_and_staged(cuda_device, dtype, mode):
    """The streamed MHD step against its twin and the staged kernel on the
    same input (within TOL; the x-face planes within TOL_PLANES), the folded
    inverse dt against the CFL kernel on the kernel's output (4 ULP), and an
    inactive step (a copy)."""
    from ramsesgpu_tpu_torch.kernels.cfl_mhd import cfl_mhd
    from ramsesgpu_tpu_torch.kernels.mhd_step import mhd_step, zslab_shape
    from ramsesgpu_tpu_torch.kernels.shear_border import shear_slabs
    from ramsesgpu_tpu_torch.kernels.zcarry_mhd3d import zcarry_mhd
    from ramsesgpu_tpu_torch.solvers.godunov_mhd import mhd_3d_periodic_update, mhd_3d_shear_update
    from ramsesgpu_tpu_torch.solvers.timestep import dt_from_inv, inv_dt_mhd_periodic, inv_dt_mhd_shear

    shear = gz = None
    if mode in ("periodic", "compensated"):
        params, S = ot_state(dtype, cuda_device)
        if mode == "compensated":
            params = params.replace(compensated=True)
            S = torch.cat([S, torch.finfo(S.dtype).eps * S]).contiguous()
        dt = dt_from_inv(params, inv_dt_mhd_periodic(params, S[:8]))
    else:
        name = "mhd_mri_3d_stratified.ini" if mode == "stratified" else "mhd_mri_3d.ini"
        params, _config, (S, kept), t0, gz = shipped_mri(name, dtype, cuda_device, (40, 36, 20))
        if mode == "shear-adiabatic":
            params = params.replace(c_iso=0.0)
        dt = dt_from_inv(params, inv_dt_mhd_shear(params, S, kept[0]))
        zslabs = None if gz is None else torch.empty(zslab_shape(params), dtype=S.dtype,
                                                     device=cuda_device)
        slabs = shear_slabs(params, S, kept, t0, dt, zout=zslabs)
        shear = (slabs, torch.zeros((5, params.nz, params.ny), dtype=S.dtype, device=cuda_device))
        if gz is not None:
            shear = shear + (zslabs, gz)
    active = torch.ones((), dtype=torch.bool, device=cuda_device)
    out = torch.empty_like(S)
    fold = shear is None
    inv = zcarry_mhd(params, S, out, dt, active, shear=shear, fold=fold)
    staged_shear = None if shear is None else (shear[0], torch.zeros_like(shear[1])) + shear[2:]
    staged = mhd_step(params, S.clone(), dt, active, mhd_step.scratch(params, S),
                      shear=staged_shear)
    assert rel_l2(out[:8], staged[:8]) <= TOL[dtype]
    if shear is None:
        assert rel_l2(out[:8], mhd_3d_periodic_update(params, S, dt)[:8]) <= TOL[dtype]
        assert ulp_close(inv, cfl_mhd(params, out))
    else:
        want, planes = mhd_3d_shear_update(params, S, shear[0], dt, *shear[2:])
        assert rel_l2(out[:8], want[:8]) <= TOL[dtype]
        for p, q in zip(shear[1], planes):
            assert rel_l2(p, q) <= TOL_PLANES[dtype]
    idle = torch.zeros((), dtype=torch.bool, device=cuda_device)
    zcarry_mhd(params, S, out, dt, idle, shear=shear, fold=fold)
    assert torch.equal(out, S)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["periodic", "shear"])
def test_zcarry_mhd_odd_tiles(cuda_device, mode):
    """The streamed MHD step (f32) on a 37 x 21 x 13 grid, which its tile
    divides along neither x nor y, against its twin within TOL (the folded
    inverse dt within 4 ULP of the CFL kernel on its output; the x-face
    planes within TOL_PLANES)."""
    from ramsesgpu_tpu_torch.kernels.build import load_library
    from ramsesgpu_tpu_torch.kernels.cfl_mhd import cfl_mhd
    from ramsesgpu_tpu_torch.kernels.shear_border import shear_slabs
    from ramsesgpu_tpu_torch.kernels.zcarry_mhd3d import zcarry_mhd
    from ramsesgpu_tpu_torch.solvers.godunov_mhd import mhd_3d_periodic_update, mhd_3d_shear_update
    from ramsesgpu_tpu_torch.solvers.timestep import dt_from_inv, inv_dt_mhd_periodic, inv_dt_mhd_shear

    import ctypes

    mesh = (37, 21, 13)
    tile = (ctypes.c_int * 5)()
    load_library("cuda").ramses_zcarry_mhd_tile(0, tile)
    assert mesh[0] % tile[0] and mesh[1] % tile[1]
    active = torch.ones((), dtype=torch.bool, device=cuda_device)
    if mode == "periodic":
        params, S = ot_state("float32", cuda_device, mesh=mesh)
        dt = dt_from_inv(params, inv_dt_mhd_periodic(params, S))
        out = torch.empty_like(S)
        inv = zcarry_mhd(params, S, out, dt, active, fold=True)
        assert rel_l2(out, mhd_3d_periodic_update(params, S, dt)) <= TOL["float32"]
        assert ulp_close(inv, cfl_mhd(params, out))
    else:
        params, _config, (S, kept), t0, _gz = shipped_mri("mhd_mri_3d.ini", "float32",
                                                         cuda_device, mesh)
        dt = dt_from_inv(params, inv_dt_mhd_shear(params, S, kept[0]))
        slabs = shear_slabs(params, S, kept, t0, dt)
        planes = torch.zeros((5, params.nz, params.ny), dtype=S.dtype, device=cuda_device)
        out = torch.empty_like(S)
        zcarry_mhd(params, S, out, dt, active, shear=(slabs, planes))
        want, want_planes = mhd_3d_shear_update(params, S, slabs, dt)
        assert rel_l2(out[:8], want[:8]) <= TOL["float32"]
        for p, q in zip(planes, want_planes):
            assert rel_l2(p, q) <= TOL_PLANES["float32"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("solver", ["approx", "hll", "hllc"])
def test_zcarry_hydro_matches_twin_and_staged(cuda_device, dtype, solver):
    """The folded-CFL hydro step against its twin and the step kernel (within
    TOL), its inverse dt against the CFL kernel on its output (4 ULP), and
    an inactive step (a copy)."""
    from ramsesgpu_tpu_torch.kernels.cfl_hydro import cfl_hydro
    from ramsesgpu_tpu_torch.kernels.hydro_step import hydro_step
    from ramsesgpu_tpu_torch.kernels.zcarry_hydro3d import zcarry_hydro
    from ramsesgpu_tpu_torch.solvers.boundary import interior
    from ramsesgpu_tpu_torch.solvers.godunov import hydro_3d_state_update
    from ramsesgpu_tpu_torch.solvers.timestep import compute_inv_dt_hydro, dt_from_inv

    params, U = hydro_state(dtype, cuda_device, "blast", solver)
    S = interior(params, U).contiguous()
    dt = dt_from_inv(params, compute_inv_dt_hydro(params, S, ghost=0))
    active = torch.ones((), dtype=torch.bool, device=cuda_device)
    out = torch.empty_like(S)
    inv = zcarry_hydro(params, S, out, dt, active)
    staged = hydro_step(params, S, torch.empty_like(S), dt, active)
    assert rel_l2(out, staged) <= TOL[dtype]
    assert rel_l2(out, hydro_3d_state_update(params, S, dt)) <= TOL[dtype]
    assert ulp_close(inv, cfl_hydro(params, out))
    zcarry_hydro(params, S, out, dt, torch.zeros_like(active))
    assert torch.equal(out, S)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["ot", "ot-dissipative", "blast", "mri"])
def test_zcarry_loops_count_launches(cuda_device, path):
    """kernel=zcarry launches the streamed step once per step and no staged
    step; the CFL once per chunk where it is folded (ideal periodic MHD,
    hydro), once per step elsewhere; 3 steps equal the twins' loop."""
    from ramsesgpu_tpu_torch.kernels.cfl_hydro import cfl_hydro
    from ramsesgpu_tpu_torch.kernels.cfl_mhd import cfl_mhd
    from ramsesgpu_tpu_torch.kernels.hydro_step import hydro_step
    from ramsesgpu_tpu_torch.kernels.mhd_step import mhd_step
    from ramsesgpu_tpu_torch.kernels.zcarry_hydro3d import zcarry_hydro
    from ramsesgpu_tpu_torch.kernels.zcarry_mhd3d import zcarry_mhd
    from ramsesgpu_tpu_torch.solvers.step import make_packed_advance_chain

    if path == "blast":
        params, U = hydro_state("float32", cuda_device, "blast")
        step_k, staged_k, cfl_k, cfl_n = zcarry_hydro, hydro_step, cfl_hydro, 1
    elif path == "mri":
        params, U = mri_ghosted(cuda_device)
        step_k, staged_k, cfl_k, cfl_n = zcarry_mhd, mhd_step, cfl_mhd, 3
    else:
        from ramsesgpu_tpu_torch.problems import init_problem
        from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries

        config = ConfigMap(text=INI.format(dtype="float32", tend=100.0))
        params = params_from_config(config)
        if path == "ot-dissipative":
            params = params.replace(nu=2e-3, eta=1e-3)
        U = make_boundaries(params, torch.from_numpy(init_problem(params, config)).to(cuda_device))
        step_k, staged_k, cfl_k, cfl_n = zcarry_mhd, mhd_step, cfl_mhd, (3 if path != "ot" else 1)
    t0 = torch.tensor(2.5 * params.dy / (1.5 * params.omega0 * params.dx * params.nx)
                      if params.omega0 > 0 else 0.0, device=cuda_device)
    results = {}
    for kernel in ("auto", "zcarry"):
        p = params.replace(kernel=kernel)
        pack, advance, unpack = make_packed_advance_chain(p, cuda_device)
        before = (step_k.launches, staged_k.launches, cfl_k.launches)
        state, t, k = advance(pack(U), t0, 3)
        counts = tuple(x.launches - b for x, b in zip((step_k, staged_k, cfl_k), before))
        results[kernel] = unpack(state, t)
        if kernel == "zcarry":
            assert int(k) == 3 and counts == (3, 0, cfl_n)
    assert rel_l2(results["zcarry"], results["auto"]) <= 1e-5  # chained steps (chip_smoke.py TOL_STEP10)


def mri_ghosted(device):
    """The shipped MRI input at 40 x 36 x 20, ghosted with its sheared fill at
    t0 (shear offset 2.5 cells)."""
    from ramsesgpu_tpu_torch.kernels.shear import unpack

    params, _config, state, t0, _gz = shipped_mri("mhd_mri_3d.ini", "float32", device,
                                                  (40, 36, 20))
    return params, unpack(params, state, t0)


# walls and the inflow jet: the ghosted modes of the step and CFL kernels
# (TPU row 3), on the shipped 3D Brio-Wu under each face mix and on the
# MHD jet, at an odd 21 x 18 x 11
WALL_CASES = {"neumann": (2,) * 6, "dirichlet": (1,) * 6, "mixed": (2, 2, 3, 3, 1, 1),
              "jet": None}


def walled_state(case, dtype, device, seed=5):
    """params and the filled ghosted state of one WALL_CASES case: Brio-Wu
    (testRiemannHLLD.ini) or the MHD jet (mhd_jet3d.ini, ijet 4, offsetJet
    3, ambient field 0.7), times 1 + 0.05 N(0, 1) from a seed."""
    import re
    from pathlib import Path

    from ramsesgpu_tpu_torch.convert import torch_dtype
    from ramsesgpu_tpu_torch.problems import init_problem
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries

    name = "mhd_jet3d.ini" if case == "jet" else "testRiemannHLLD.ini"
    text = (Path(__file__).resolve().parent.parent / "data" / name).read_text()
    subs = {"nx": 21, "ny": 18, "nz": 11, "ijet": 4, "offsetJet": 3}
    if WALL_CASES[case] is not None:
        subs.update(zip(("boundary_xmin", "boundary_xmax", "boundary_ymin", "boundary_ymax",
                         "boundary_zmin", "boundary_zmax"), WALL_CASES[case]))
    for key, value in subs.items():
        text = re.sub(rf"^{key}=.*$", f"{key}={value}", text, flags=re.M)
    text = text.replace("[jet]\n", "[jet]\nbamb=0.7\n") + f"\n[implementation]\ndtype={dtype}\n"
    config = ConfigMap(text=text)
    params = params_from_config(config)
    U = torch.from_numpy(init_problem(params, config))
    gen = torch.Generator().manual_seed(seed)
    U = U * (1 + 0.05 * torch.randn(U.shape, generator=gen, dtype=U.dtype))
    return params, make_boundaries(params, U.to(device, torch_dtype(params))).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", list(WALL_CASES))
def test_ghosted_kernels_match_twins(cuda_device, dtype, case):
    """The step kernel's ghosted mode against its twin on the whole ghosted
    array after 1 step and after 10 steps of the walled loop against the
    twins' loop; the CFL's ghosted mode against its twin; an inactive step
    changes nothing; make_fused_mhd_update is the twin's interior."""
    from ramsesgpu_tpu_torch.kernels.cfl_mhd import cfl_mhd
    from ramsesgpu_tpu_torch.kernels.fused_mhd3d import make_fused_mhd_update
    from ramsesgpu_tpu_torch.kernels.mhd_step import mhd_step
    from ramsesgpu_tpu_torch.solvers.boundary import fill_ghosts_, interior
    from ramsesgpu_tpu_torch.solvers.godunov_mhd import mhd_3d_ghosted_update
    from ramsesgpu_tpu_torch.solvers.step import make_advance_n
    from ramsesgpu_tpu_torch.solvers.timestep import dt_from_inv, inv_dt_mhd_ghosted

    params, U = walled_state(case, dtype, cuda_device)
    g = params.ghost_width
    inv, inv_ref = cfl_mhd(params, U, ghost=g), inv_dt_mhd_ghosted(params, U)
    assert abs(float(inv) - float(inv_ref)) <= TOL[dtype] * float(inv_ref)
    dt = dt_from_inv(params, inv_ref)
    want = mhd_3d_ghosted_update(params, U, dt)
    scratch = mhd_step.scratch(params, U, ghosted=True)
    got = U.clone()
    mhd_step.ghosted(params, got, dt, torch.zeros((), dtype=torch.bool, device=cuda_device),
                     scratch)
    assert torch.equal(got, U)
    mhd_step.ghosted(params, got, dt, torch.ones((), dtype=torch.bool, device=cuda_device),
                     scratch)
    assert rel_l2(got, want) <= TOL[dtype]
    fused = make_fused_mhd_update(params, cuda_device)(U, dt)
    assert rel_l2(fused, interior(params, want)) <= TOL[dtype]

    t0 = torch.zeros((), dtype=U.dtype, device=cuda_device)
    got, t, k = make_advance_n(params, cuda_device)(U, t0, 10)
    want, t_ref = U.clone(), t0.clone()
    for _ in range(10):
        dt = dt_from_inv(params, inv_dt_mhd_ghosted(params, want))
        want = mhd_3d_ghosted_update(params, fill_ghosts_(params, want), dt)
        t_ref = t_ref + dt
    assert int(k) == 10
    assert abs(float(t) - float(t_ref)) <= TOL_STEP10[dtype] * float(t_ref)
    assert rel_l2(got, want) <= TOL_STEP10[dtype]


# after 10 chained steps (chip_smoke.py TOL_STEP10)
TOL_STEP10 = {"float32": 1e-5, "float64": 1e-12}


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mixed", "jet", "hydro_jet"])
def test_ghosted_loops_count_launches_and_stop_at_t_end(cuda_device, case):
    """On CUDA the walled and jet loops launch the ghosted step and the CFL
    once per step each and never a twin; a chunk that reaches t_end stops
    there, its inactive steps leaving the state, ghosts included."""
    from ramsesgpu_tpu_torch.kernels import cfl_hydro, cfl_mhd, hydro_step, mhd_step
    from ramsesgpu_tpu_torch.solvers.step import make_advance_n

    if case == "hydro_jet":
        params, U = hydro_jet_state(cuda_device)
        step_k, cfl_k = hydro_step.hydro_step, cfl_hydro.cfl_hydro
    else:
        params, U = walled_state(case, "float32", cuda_device)
        step_k, cfl_k = mhd_step.mhd_step, cfl_mhd.cfl_mhd
    twins = [(mhd_step, "mhd_3d_ghosted_update"), (cfl_mhd, "inv_dt_mhd_ghosted"),
             (hydro_step, "hydro_3d_interior_update"), (cfl_hydro, "compute_inv_dt_hydro")]
    saved = [(m, a, getattr(m, a)) for m, a in twins]

    def refuse(*args, **kw):
        raise AssertionError("a plain twin ran on the CUDA path")

    t0 = torch.zeros((), dtype=U.dtype, device=cuda_device)
    try:
        for m, a, _fn in saved:
            setattr(m, a, refuse)
        before = (step_k.launches, cfl_k.launches)
        U3, t3, k = make_advance_n(params, cuda_device)(U, t0, 3)
        assert int(k) == 3
        assert (step_k.launches - before[0], cfl_k.launches - before[1]) == (3, 3)
        _, t2, _ = make_advance_n(params, cuda_device)(U, t0, 2)
        params_end = params.replace(t_end=0.5 * (float(t2) + float(t3)))
        U_end, t, k = make_advance_n(params_end, cuda_device)(U, t0, 6)
    finally:
        for m, a, fn in saved:
            setattr(m, a, fn)
    assert int(k) == 3 and float(t) == float(t3)
    assert torch.equal(U_end, U3)


def hydro_jet_state(device):
    """data/jet3d_gpu.ini at 20 x 18 x 30 (ijet 4, offsetJet 5), f32,
    ghosts filled."""
    import re
    from pathlib import Path

    from ramsesgpu_tpu_torch.problems import init_problem
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries

    text = (Path(__file__).resolve().parent.parent / "data" / "jet3d_gpu.ini").read_text()
    for key, value in {"nx": 20, "ny": 18, "nz": 30, "ijet": 4, "offsetJet": 5}.items():
        text = re.sub(rf"^{key}=.*$", f"{key}={value}", text, flags=re.M)
    config = ConfigMap(text=text)
    params = params_from_config(config)
    U = torch.from_numpy(init_problem(params, config)).to(device)
    return params, make_boundaries(params, U)


def window_case(dtype, device, ciso=1.0, gravity=False):
    """A rank's ghosted window of MRI_INI's box as a 2 x 1 x 2 grid cut at
    rank (iz, iy, ix) = (1, 0, 1), so x0 != xmin and z0 != zmin: the
    sheared fill of the box at a t0 whose shear offset is 2.5 cells, times
    (1 + 0.01 N(0, 1)) from a seed; the window's params, its x0, and (with
    ``gravity``) g_z of its rows from the stratified MRI's profile."""
    from ramsesgpu_tpu_torch.kernels.shear import unpack
    from ramsesgpu_tpu_torch.solvers.step import mri_gz_profile

    params, state, t0 = mri_state(dtype, device, ciso=ciso)
    U = unpack(params, state, t0)
    g = params.ghost_width
    lnx, lny, lnz = params.nx // 2, params.ny, params.nz // 2
    W = U[:, lnz:2 * lnz + 2 * g, :, lnx:2 * lnx + 2 * g]
    gen = torch.Generator().manual_seed(7)
    W = (W * (1 + 0.01 * torch.randn(W.shape, generator=gen, dtype=torch.float64).to(
        device, W.dtype))).contiguous()
    lp = params.replace(nx=lnx, ny=lny, nz=lnz, xmax=params.xmin + lnx * params.dx,
                        zmax=params.zmin + lnz * params.dz)
    x0, z0 = params.xmin + lnx * params.dx, params.zmin + lnz * params.dz
    gz = None
    if gravity:
        zc = z0 + params.dz / 2 + (torch.arange(lnz + 2 * g, dtype=W.dtype, device=device)
                                   - g) * params.dz
        gz = mri_gz_profile(params, ConfigMap(text="[MRI]\nsmoothGravity=yes\nzFloor=2.0"))(
            zc).contiguous()
    return lp, W, x0, z0, gz


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("mode", ["iso", "adiabatic", "gravity"])
def test_window_kernel_matches_twin(cuda_device, dtype, mode):
    """TPU row 4 (the step kernel's shear window mode) against its twin on a
    rank's window: the interior within TOL, each x-face plane within
    TOL_PLANES; the ghosted-shear CFL within 4 ULP of its twin."""
    from ramsesgpu_tpu_torch.kernels.cfl_mhd import cfl_mhd_window
    from ramsesgpu_tpu_torch.kernels.fused_mhd3d import make_fused_mhd_shear
    from ramsesgpu_tpu_torch.kernels.mhd_step import mhd_window
    from ramsesgpu_tpu_torch.solvers.godunov_mhd import mhd_3d_shear_window_update
    from ramsesgpu_tpu_torch.solvers.timestep import dt_from_inv, inv_dt_mhd_ghosted_shear

    lp, W, x0, z0, gz = window_case(dtype, cuda_device, 0.0 if mode == "adiabatic" else 1.0,
                                    mode == "gravity")
    inv, inv_ref = cfl_mhd_window(lp, W), inv_dt_mhd_ghosted_shear(lp, W)
    assert ulp_close(inv, inv_ref)
    dt = dt_from_inv(lp, inv_ref)
    before = mhd_window.launches
    out, planes = mhd_window(lp, W, dt, x0, gz, mhd_window.scratch(lp, W))
    assert mhd_window.launches == before + 1
    want, want_planes = mhd_3d_shear_window_update(lp, W, dt, x0, gz)
    assert rel_l2(out, want) <= TOL[dtype]
    for c in range(5):
        assert rel_l2(planes[c], want_planes[c]) <= TOL_PLANES[dtype], c
    if gz is None:
        new, fpl, eypl, ezpl = make_fused_mhd_shear(lp, cuda_device)(W, dt, x0, z0)
        assert torch.equal(new, out) and torch.equal(ezpl, planes[4])


@pytest.mark.cuda
def test_two_rank_sharded_mri_on_the_card(cuda_device):
    """Two ranks of the sharded MRI (a 2 x 1 x 1 grid) share the card over
    gloo: row 4 and the ghosted-shear CFL launch once per rank and step,
    the single-device shear step never; 3 steps in f64 agree with the same
    run on the CPU (the twins) within 1e-12."""
    from ramsesgpu_tpu_torch.parallel.launch import spawn_ranks
    from ramsesgpu_tpu_torch.parallel.sharded_step import rank_jobs

    text = MRI_INI.format(dtype="float64", tend=100.0, ciso=1.0) + "\n[mpi]\nmx=2\n"
    jobs = [dict(config_text=text, device=dev, n_steps=3, t0=0.1) for dev in ("cuda", "cpu")]
    ranks = spawn_ranks(rank_jobs, 2, (jobs,))
    for r in ranks:
        card, host = r
        assert card["backend"] == "gloo" and card["device"] == "cuda:0"
        assert card["counts"] == {**dict.fromkeys(card["counts"], 0), "mhd_window": 3,
                                  "cfl_mhd_window": 3}
        assert card["k"] == host["k"] == 3
    card, host = ranks[0]
    assert abs(card["t"] - host["t"]) <= 1e-12 * host["t"]
    got, want = torch.from_numpy(card["U"]), torch.from_numpy(host["U"])
    assert rel_l2(got, want) <= 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("name, mesh, kind", [
    ("jet3d_mhd_mpi_gpu", (24, 16, 12), "mhd"), ("implode3d_mpi_zslab", (20, 16, 16), "hydro"),
    ("orszag-tang_mpi", (64, 64, 1), None)])
def test_two_rank_sharded_local_runs_on_the_card(cuda_device, name, mesh, kind):
    """Two ranks (a 2 x 1 x 1 grid) of a sharded walled, jet or periodic run
    share the card over gloo: a 3D rank launches the step and CFL kernels'
    ghosted modes once a step and no other mode, a 2D rank no kernel; 3
    steps in f64 agree with the same run on the CPU (the twins) within
    1e-12."""
    import re
    from pathlib import Path

    from ramsesgpu_tpu_torch.parallel.launch import spawn_ranks
    from ramsesgpu_tpu_torch.parallel.sharded_step import rank_jobs

    text = (Path(__file__).resolve().parent.parent / "data" / f"{name}.ini").read_text()
    for key, value in zip(("nx", "ny", "nz", "mx", "my", "mz"), mesh + (2, 1, 1)):
        text = re.sub(rf"^{key}=.*$", f"{key}={value}", text, flags=re.M)
    if "[implementation]" in text:
        text = text.replace("[implementation]", "[implementation]\ndtype=float64", 1)
    else:
        text += "\n[implementation]\ndtype=float64\n"
    jobs = [dict(config_text=text, device=dev, n_steps=3) for dev in ("cuda", "cpu")]
    ranks = spawn_ranks(rank_jobs, 2, (jobs,))
    launched = () if kind is None else (f"{kind}_step", f"{kind}_step_ghosted", f"cfl_{kind}",
                                        f"cfl_{kind}_ghosted")
    for card, host in ranks:
        assert card["backend"] == "gloo" and card["device"] == "cuda:0"
        assert card["counts"] == {name: 3 if name in launched else 0 for name in card["counts"]}
        assert card["k"] == host["k"] == 3
    card, host = ranks[0]
    assert abs(card["t"] - host["t"]) <= 1e-12 * host["t"]
    assert rel_l2(torch.from_numpy(card["U"]), torch.from_numpy(host["U"])) <= 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("name, mesh, extra, kind", [
    ("testRiemannHLLD", (24, 16, 12), "[hydro]\nnu=2e-3\n[MHD]\neta=2e-3\n", "mhd"),
    ("turbulence_mhd_mpi", (24, 16, 16), "", "mhd"),
    ("turbulence_hydro_mpi", (24, 16, 16), "[hydro]\nnu=2e-3\n[turbulence]\nedot=0.5\n",
     "hydro")])
def test_two_rank_sharded_dissipation_and_forcing_on_the_card(cuda_device, name, mesh, extra,
                                                              kind):
    """Two ranks (a 2 x 1 x 1 grid) of a sharded dissipative or forced run
    share the card over gloo: the walled Brio-Wu with nu and eta (row 8's
    ghosted mode once a rank-step beside the step and CFL kernels), the
    static forcing on isothermal MHD and on hydro with nu (the whole-array
    viscosity, no kernel); 3 steps in f64 agree with the same run on the
    CPU (the twins) within 1e-12."""
    import re
    from pathlib import Path

    from ramsesgpu_tpu_torch.parallel.launch import spawn_ranks
    from ramsesgpu_tpu_torch.parallel.sharded_step import rank_jobs

    text = (Path(__file__).resolve().parent.parent / "data" / f"{name}.ini").read_text()
    for key, value in zip(("nx", "ny", "nz"), mesh):
        text = re.sub(rf"^{key}=.*$", f"{key}={value}", text, flags=re.M)
    # later sections' keys win (ConfigMap is not strict)
    text += "\n" + extra + "[mpi]\nmx=2\nmy=1\nmz=1\n[implementation]\ndtype=float64\n"
    jobs = [dict(config_text=text, device=dev, n_steps=3) for dev in ("cuda", "cpu")]
    ranks = spawn_ranks(rank_jobs, 2, (jobs,))
    launched = (f"{kind}_step", f"{kind}_step_ghosted", f"cfl_{kind}", f"cfl_{kind}_ghosted")
    if "eta" in extra:
        launched += ("dissip_step", "dissip_step_ghosted")
    for card, host in ranks:
        assert card["backend"] == "gloo" and card["device"] == "cuda:0"
        assert card["counts"] == {name: 3 if name in launched else 0 for name in card["counts"]}
        assert card["k"] == host["k"] == 3
    card, host = ranks[0]
    assert abs(card["t"] - host["t"]) <= 1e-12 * host["t"]
    assert rel_l2(torch.from_numpy(card["U"]), torch.from_numpy(host["U"])) <= 1e-12


def input_2d(name, device, n=64, dtype="float64"):
    """data/<name>.ini (a 2D input) at n x n in ``dtype``: params and its
    ghosted initial state on ``device``, ghosts filled."""
    import re
    from pathlib import Path

    from ramsesgpu_tpu_torch.convert import torch_dtype
    from ramsesgpu_tpu_torch.problems import init_problem
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries

    text = (Path(__file__).resolve().parent.parent / "data" / f"{name}.ini").read_text()
    for key in ("nx", "ny"):
        text = re.sub(rf"^{key}=.*$", f"{key}={n}", text, flags=re.M)
    config = ConfigMap(text=text + f"\n[implementation]\ndtype={dtype}\n")
    params = params_from_config(config)
    U = torch.from_numpy(init_problem(params, config)).to(device, torch_dtype(params))
    return params, make_boundaries(params, U)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["orszag-tang", "hydro_sod2d"])
def test_2d_path_on_the_card_matches_cpu_without_host_sync(cuda_device, name):
    """The 2D path (whole-array PyTorch; the JAX package has no 2D kernel)
    at 64^2, f64, 10 steps of make_advance_n on the card and on the CPU
    through the same code: equal step counts, t and state within relative
    L2 1e-12; the card's chunk makes no host sync (sync debug mode "error"
    raises on one)."""
    from ramsesgpu_tpu_torch.solvers.step import make_advance_n

    params, U = input_2d(name, cuda_device)
    t0 = torch.zeros((), dtype=U.dtype, device=cuda_device)
    advance = make_advance_n(params, cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        U_gpu, t_gpu, k_gpu = advance(U, t0, 10)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    U_cpu, t_cpu, k_cpu = make_advance_n(params, "cpu")(U.cpu(), t0.cpu(), 10)
    assert int(k_gpu) == int(k_cpu) == 10
    assert abs(float(t_gpu) - float(t_cpu)) <= 1e-12 * float(t_cpu)
    diff = torch.linalg.norm((U_gpu.cpu() - U_cpu).flatten()) / torch.linalg.norm(U_cpu.flatten())
    assert torch.isfinite(U_gpu).all() and float(diff) <= 1e-12, float(diff)


# static gravity (the step kernels' gravity instances) and the walled
# dissipation (dissip_step.cu's ghosted mode), at odd sizes
def gravity_state(name, dtype, device, mesh=(37, 11, 21), keys=None, seed=9):
    """params, config and the filled ghosted state of data/<name>.ini at
    ``mesh`` with ``keys`` (a "[section]" key adds a line to it), times
    1 + 0.02 N(0, 1) from a seed."""
    import re
    from pathlib import Path

    from ramsesgpu_tpu_torch.convert import torch_dtype
    from ramsesgpu_tpu_torch.problems import init_problem
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries

    text = (Path(__file__).resolve().parent.parent / "data" / f"{name}.ini").read_text()
    for key, value in {**dict(zip(("nx", "ny", "nz"), mesh)), **(keys or {})}.items():
        if key.startswith("["):
            text = text.replace(key + "\n", f"{key}\n{value}\n")
        else:
            text = re.sub(rf"^{key}=.*$", f"{key}={value}", text, flags=re.M)
    config = ConfigMap(text=text + f"\n[implementation]\ndtype={dtype}\n")
    params = params_from_config(config)
    U = torch.from_numpy(init_problem(params, config))
    gen = torch.Generator().manual_seed(seed)
    U = U * (1 + 0.02 * torch.randn(U.shape, generator=gen, dtype=U.dtype))
    return params, config, make_boundaries(params, U.to(device, torch_dtype(params))).contiguous()


GRAVITY_CASES = {
    "hydro": ("rayleigh_taylor_gpu_3d", {}),
    "mhd": ("rayleigh_taylor_gpu_3d_mhd", {}),
    "mhd_iso": ("rayleigh_taylor_gpu_3d_mhd", {"[hydro]": "cIso=0.3"}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", list(GRAVITY_CASES))
def test_gravity_kernels_match_twins(cuda_device, dtype, case):
    """The gravity instances against their twins at 37 x 11 x 21: the hydro
    step's interior mode (z walls) and ghosted mode, the MHD step's ghosted
    mode (adiabatic, isothermal); then 10 steps of the loop against the
    twins' loop."""
    from ramsesgpu_tpu_torch.kernels.hydro_step import hydro_step
    from ramsesgpu_tpu_torch.kernels.mhd_step import mhd_step
    from ramsesgpu_tpu_torch.solvers.boundary import interior
    from ramsesgpu_tpu_torch.solvers.godunov import (gravity_vector, hydro_3d_interior_update,
                                                     hydro_3d_state_update)
    from ramsesgpu_tpu_torch.solvers.godunov_mhd import mhd_3d_ghosted_update
    from ramsesgpu_tpu_torch.solvers.step import make_advance_n

    name, keys = GRAVITY_CASES[case]
    params, config, U = gravity_state(name, dtype, cuda_device, keys=keys)
    grav = gravity_vector(params, U)
    dt = torch.tensor(2e-3, dtype=U.dtype, device=cuda_device)
    on = torch.ones((), dtype=torch.bool, device=cuda_device)
    if params.mhd:
        got = U.clone()
        mhd_step.ghosted(params, got, dt, on, mhd_step.scratch(params, U, ghosted=True))
        assert rel_l2(got, mhd_3d_ghosted_update(params, U, dt, grav)) <= TOL[dtype]
    else:
        S = interior(params, U).contiguous()
        out = torch.empty_like(S)
        hydro_step(params, S, out, dt, on)
        assert rel_l2(out, hydro_3d_state_update(params, S, dt, grav)) <= TOL[dtype]
        got = hydro_step.ghosted(params, U, dt)
        assert rel_l2(got, hydro_3d_interior_update(params, U, dt, grav)) <= TOL[dtype]
    t0 = torch.zeros((), dtype=U.dtype, device=cuda_device)
    got, t, k = make_advance_n(params, cuda_device, config)(U, t0, 10)
    want, t_ref, _ = make_advance_n(params, "cpu", config)(U.cpu(), t0.cpu(), 10)
    assert int(k) == 10
    assert abs(float(t) - float(t_ref)) <= TOL_STEP10[dtype] * float(t_ref)
    assert rel_l2(interior(params, got).cpu(), interior(params, want)) <= TOL_STEP10[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("keys", [{"[hydro]": "nu=2e-3", "[MHD]": "eta=2e-3"},
                                  {"[hydro]": "cIso=0.7", "[MHD]": "eta=2e-3"}])
def test_dissip_ghosted_matches_twin(cuda_device, dtype, keys):
    """dissip_step.cu's ghosted mode against its twin on a perturbed walled
    Brio-Wu state at 37 x 11 x 21, in place: the interior and the face
    layer; an inactive sub-step changes nothing; 10 steps of the walled
    dissipative loop against the twins' loop."""
    from ramsesgpu_tpu_torch.kernels.dissip_step import dissip_step
    from ramsesgpu_tpu_torch.solvers.dissipation import mhd_dissipation_ghosted_update
    from ramsesgpu_tpu_torch.solvers.step import make_advance_n

    params, config, U = gravity_state("testRiemannHLLD", dtype, cuda_device, keys=keys)
    dt = torch.tensor(2e-3, dtype=U.dtype, device=cuda_device)
    buf = dissip_step.scratch(params, U)
    got = U.clone()
    dissip_step.ghosted_(params, got, dt, torch.zeros((), dtype=torch.bool, device=cuda_device),
                         buf)
    assert torch.equal(got, U)
    dissip_step.ghosted_(params, got, dt, torch.ones((), dtype=torch.bool, device=cuda_device),
                         buf)
    assert rel_l2(got, mhd_dissipation_ghosted_update(params, U, dt)) <= TOL[dtype]
    t0 = torch.zeros((), dtype=U.dtype, device=cuda_device)
    got, t, k = make_advance_n(params, cuda_device, config)(U, t0, 10)
    want, t_ref, _ = make_advance_n(params, "cpu", config)(U.cpu(), t0.cpu(), 10)
    assert int(k) == 10 and rel_l2(got.cpu(), want) <= TOL_STEP10[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["hydro", "mhd", "walls_dissip"])
def test_gravity_and_walled_dissip_loops_count_launches(cuda_device, case):
    """On CUDA the 3D gravity loops and the walled dissipative loop launch
    their kernels once a step and never a twin."""
    from ramsesgpu_tpu_torch.kernels import cfl_hydro, cfl_mhd, dissip_step, hydro_step, mhd_step
    from ramsesgpu_tpu_torch.solvers import dissipation, godunov
    from ramsesgpu_tpu_torch.solvers.step import make_advance_n

    if case == "walls_dissip":
        params, config, U = gravity_state("testRiemannHLLD", "float32", cuda_device,
                                          keys={"[hydro]": "nu=2e-3", "[MHD]": "eta=2e-3"})
    else:
        params, config, U = gravity_state(GRAVITY_CASES[case][0], "float32", cuda_device)
    kernels = ([hydro_step.hydro_step, cfl_hydro.cfl_hydro] if case == "hydro"
               else [mhd_step.mhd_step, cfl_mhd.cfl_mhd])
    if case == "walls_dissip":
        kernels.append(dissip_step.dissip_step)
    twins = [(mhd_step, "mhd_3d_ghosted_update"), (cfl_mhd, "inv_dt_mhd_ghosted"),
             (hydro_step, "hydro_3d_state_update"), (cfl_hydro, "compute_inv_dt_hydro"),
             (dissip_step, "mhd_dissipation_ghosted_update"), (godunov, "gravity_source"),
             (dissipation, "apply_dissipation_mhd")]
    saved = [(m, a, getattr(m, a)) for m, a in twins]

    def refuse(*args, **kw):
        raise AssertionError("a plain twin ran on the CUDA path")

    try:
        for m, a, _fn in saved:
            setattr(m, a, refuse)
        before = [kern.launches for kern in kernels]
        _, _, k = make_advance_n(params, cuda_device, config)(
            U, torch.zeros((), dtype=U.dtype, device=cuda_device), 3)
        assert int(k) == 3
        assert [kern.launches - b for kern, b in zip(kernels, before)] == [3] * len(kernels)
    finally:
        for m, a, fn in saved:
            setattr(m, a, fn)


# the MHD solvers other than HLLD: the step kernels' general instances
# (csrc/mhd_stages.cuh Mode with GEN), each new face and corner solver at
# least once, and a pair of each kind mixed with HLLD
SOLVER_PAIRS = [("hll", "hlla"), ("llf", "llf"), ("hlld", "hllf"), ("hll", "hlld")]


def with_solvers(params, face, corner):
    from ramsesgpu_tpu_torch.core.constants import MagneticRiemannSolver, RiemannSolver

    return params.replace(riemann_solver=RiemannSolver[face.upper()],
                          mag_riemann_solver=MagneticRiemannSolver[f"MAG_{corner.upper()}"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("face, corner", SOLVER_PAIRS)
def test_general_instances_match_twins(cuda_device, dtype, face, corner):
    """One step of each mode's general instance against its twin, as
    chip_smoke.py phase 51: the periodic mode staged (plain and
    compensated) and streamed (its folded inverse dt within 4 ULP of the
    CFL twin), the isothermal shear mode with its x-face planes, the
    ghosted mode on mixed walls, the shear window mode."""
    from ramsesgpu_tpu_torch.kernels.mhd_step import mhd_step, mhd_window
    from ramsesgpu_tpu_torch.kernels.zcarry_mhd3d import zcarry_mhd
    from ramsesgpu_tpu_torch.solvers.godunov_mhd import (mhd_3d_ghosted_update,
                                                         mhd_3d_periodic_update,
                                                         mhd_3d_shear_update,
                                                         mhd_3d_shear_window_update)
    from ramsesgpu_tpu_torch.solvers.shear import shear_slabs as slabs_twin
    from ramsesgpu_tpu_torch.solvers.timestep import (dt_from_inv, inv_dt_mhd_ghosted,
                                                      inv_dt_mhd_ghosted_shear,
                                                      inv_dt_mhd_periodic, inv_dt_mhd_shear)

    active = torch.ones((), dtype=torch.bool, device=cuda_device)
    params, S = ot_state(dtype, cuda_device)
    params = with_solvers(params, face, corner)
    dt = dt_from_inv(params, inv_dt_mhd_periodic(params, S))
    want = mhd_3d_periodic_update(params, S, dt)
    got = mhd_step(params, S.clone(), dt, active, mhd_step.scratch(params, S))
    assert rel_l2(got, want) <= TOL[dtype]
    out = torch.empty_like(S)
    inv = zcarry_mhd(params, S, out, dt, active, fold=True)
    assert rel_l2(out, want) <= TOL[dtype]
    assert ulp_close(inv, inv_dt_mhd_periodic(params, out))
    comp = params.replace(compensated=True)
    S16 = torch.cat([S, torch.zeros_like(S)])
    got = mhd_step(comp, S16.clone(), dt, active, mhd_step.scratch(comp, S16))
    assert rel_l2(got[:8] - got[8:], mhd_3d_periodic_update(comp, S16, dt)[:8]) <= TOL[dtype]

    mri, (Sm, kept), t0 = mri_state(dtype, cuda_device)
    mri = with_solvers(mri, face, corner)
    dt = dt_from_inv(mri, inv_dt_mhd_shear(mri, Sm, kept))
    slabs = slabs_twin(mri, Sm, kept, t0 + dt)
    planes = torch.zeros((5, mri.nz, mri.ny), dtype=Sm.dtype, device=cuda_device)
    got = mhd_step(mri, Sm.clone(), dt, active, mhd_step.scratch(mri, Sm), shear=(slabs, planes))
    want, want_planes = mhd_3d_shear_update(mri, Sm, slabs, dt)
    assert rel_l2(got, want) <= TOL[dtype]
    for c in range(5):
        assert rel_l2(planes[c], want_planes[c]) <= TOL_PLANES[dtype], c

    walls, U = walled_state("mixed", dtype, cuda_device)
    walls = with_solvers(walls, face, corner)
    dt = dt_from_inv(walls, inv_dt_mhd_ghosted(walls, U))
    got = mhd_step.ghosted(walls, U.clone(), dt, active, mhd_step.scratch(walls, U, ghosted=True))
    assert rel_l2(got, mhd_3d_ghosted_update(walls, U, dt)) <= TOL[dtype]

    lp, W, x0, _z0, gz = window_case(dtype, cuda_device)
    lp = with_solvers(lp, face, corner)
    dt = dt_from_inv(lp, inv_dt_mhd_ghosted_shear(lp, W))
    out, planes = mhd_window(lp, W, dt, x0, gz, mhd_window.scratch(lp, W))
    want, want_planes = mhd_3d_shear_window_update(lp, W, dt, x0, gz)
    assert rel_l2(out, want) <= TOL[dtype]
    for c in range(5):
        assert rel_l2(planes[c], want_planes[c]) <= TOL_PLANES[dtype], c


def strat_dissip_state(dtype, device, comp):
    """data/mhd_mri_3d_stratified.ini at 16x32x32 with nu 4e-5 and eta
    1e-5, plain or compensated (a non-zero carry): params, the loop state
    (S, kept), a t0 whose shear offset is 2.5 cells and the config."""
    from pathlib import Path

    from ramsesgpu_tpu_torch.convert import torch_dtype
    from ramsesgpu_tpu_torch.kernels.shear import pack
    from ramsesgpu_tpu_torch.problems import init_problem
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries

    text = (Path(__file__).resolve().parent.parent / "data" /
            "mhd_mri_3d_stratified.ini").read_text()
    text = text.replace("nx=16\nny=64\nnz=128", "nx=16\nny=32\nnz=32").replace(
        "cIso=0.001\n", "cIso=0.001\nnu=4e-5\n").replace(
        "omega0=0.001\n", "omega0=0.001\neta=1e-5\n")
    text = text.replace("compensated=yes", f"compensated={'yes' if comp else 'no'}")
    config = ConfigMap(text=text + f"\n[implementation]\ndtype={dtype}\n")
    params = params_from_config(config)
    U = torch.from_numpy(init_problem(params, config)).to(device, torch_dtype(params))
    S, kept = pack(params, make_boundaries(params, U))
    # (1 + 0.01 N(0, 1)) on the state and the kept face: the initial field is
    # uniform, which the resistive terms would not change
    gen = torch.Generator().manual_seed(11)

    def noise(x):
        return torch.randn(x.shape, generator=gen, dtype=torch.float64).to(device, x.dtype)

    S[:8] *= 1 + 0.01 * noise(S[:8])
    face = kept[0] if comp else kept
    face *= 1 + 0.01 * noise(face)
    if comp:
        S[8:] = torch.finfo(S.dtype).eps * S[:8] * noise(S[:8])
    t0 = 2.5 * params.dy / (1.5 * params.omega0 * params.dx * params.nx)
    return params, (S, kept), torch.tensor(t0, dtype=S.dtype, device=device), config


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("comp", [False, True], ids=["plain", "compensated"])
def test_stratified_dissipation_matches_twin(cuda_device, dtype, comp):
    """The dissipation kernel's stratified shear mode (z loads outside the
    interior read the z slabs) against its twin on the slab kernel's x and
    z slabs: plain, the increment and the kept face's change within TOL;
    compensated, bitwise (the file is FMA-free)."""
    from ramsesgpu_tpu_torch.kernels.dissip_step import dissip_step
    from ramsesgpu_tpu_torch.kernels.mhd_step import zslab_shape
    from ramsesgpu_tpu_torch.kernels.shear_border import shear_slabs
    from ramsesgpu_tpu_torch.solvers.dissipation import (kept_face_resistive_ct,
                                                          mhd_dissipation_shear_update)
    from ramsesgpu_tpu_torch.solvers.timestep import dt_from_inv, inv_dt_mhd_shear

    params, (S, kept), t0, _config = strat_dissip_state(dtype, cuda_device, comp)
    face = kept[0] if comp else kept
    dt = dt_from_inv(params, inv_dt_mhd_shear(params, S[:8], face))
    zslabs = torch.empty(zslab_shape(params), dtype=S.dtype, device=cuda_device)
    slabs = shear_slabs(params, S, kept, t0, dt, zout=zslabs)
    active = torch.ones((), dtype=torch.bool, device=cuda_device)
    got, kept_got = torch.empty_like(S), kept.clone()
    before = dissip_step.launches
    dissip_step(params, S, got, dt, active, shear=(slabs, kept_got, zslabs))
    assert dissip_step.launches == before + 1
    want, eypl, ezpl = mhd_dissipation_shear_update(params, S, slabs, dt, zslabs)
    old = torch.stack([slabs[1, 5, ..., 0], kept[1]]) if comp else slabs[1, 5, ..., 0]
    kept_want = kept_face_resistive_ct(params, old, eypl, ezpl, dt)
    if comp:
        assert torch.equal(got, want) and torch.equal(kept_got, kept_want)
    else:
        assert rel_l2(got - S, want - S) <= TOL[dtype]
        assert rel_l2(kept_got - kept, kept_want - kept) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["auto", "zcarry"])
def test_stratified_dissipative_loop_counts_launches(cuda_device, kernel):
    """The stratified box with nu and eta through the kernel loop: per step
    the step kernel, the CFL, the border kernel, the dissipation kernel
    once and the slab kernel twice; 3 steps within TOL_STEP10 of the twins'
    loop (the CPU's)."""
    from ramsesgpu_tpu_torch.kernels.cfl_mhd import cfl_mhd
    from ramsesgpu_tpu_torch.kernels.dissip_step import dissip_step
    from ramsesgpu_tpu_torch.kernels.mhd_step import mhd_step
    from ramsesgpu_tpu_torch.kernels.shear_border import shear_border, shear_slabs
    from ramsesgpu_tpu_torch.kernels.zcarry_mhd3d import zcarry_mhd
    from ramsesgpu_tpu_torch.solvers.step import make_packed_advance_chain

    params, state, t0, config = strat_dissip_state("float32", cuda_device, False)
    params = params.replace(kernel=kernel)
    step = zcarry_mhd if kernel == "zcarry" else mhd_step
    wrappers = (step, cfl_mhd, shear_border, dissip_step, shear_slabs)
    before = [w.launches for w in wrappers]
    _pack, advance, _unpack = make_packed_advance_chain(params, cuda_device, config)
    got, t, k = advance(tuple(x.clone() for x in state), t0, 3)
    assert int(k) == 3
    assert [w.launches - b for w, b in zip(wrappers, before)] == [3, 3, 3, 3, 6]
    _pack, advance_cpu, _unpack = make_packed_advance_chain(params, "cpu", config)
    want, t_cpu, _k = advance_cpu(tuple(x.cpu() for x in state), t0.cpu(), 3)
    assert abs(float(t) - float(t_cpu)) <= TOL_STEP10["float32"] * float(t_cpu)
    assert rel_l2(got[0].cpu(), want[0]) <= TOL_STEP10["float32"]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["auto", "zcarry"])
def test_restart_from_netcdf_resumes_bitwise(cuda_device, tmp_path, kernel):
    """Orszag-Tang at 32^3 f32 on the card: a Run restarted from the
    straight run's step-5 NetCDF checkpoint (ghostIncluded) and run 5 steps
    has the straight run's step-10 interior, t and step bitwise."""
    import numpy as np

    from ramsesgpu_tpu_torch.io.netcdf import input_netcdf
    from ramsesgpu_tpu_torch.solvers.run import Run

    text = INI.format(dtype="float32", tend=100.0).replace("ny=24", "ny=32").replace(
        "nz=16", "nz=32").replace("[run]\n", "[run]\nnoutput=5\nnstepmax=10\n")
    text += f"kernel={kernel}\n[output]\noutputVtk=no\noutputNetcdf=yes\nghostIncluded=yes\n"
    straight, resumed = tmp_path / "a", tmp_path / "b"
    config = ConfigMap(text=text + f"outputDir={straight}\n")
    params = params_from_config(config)
    Run(config, "cuda", params).start()
    config = ConfigMap(text=text.replace("[run]\n", f"[run]\nrestart=yes\nrestart_filename="
                                         f"{straight}/output_0000005.nc\n")
                       + f"outputDir={resumed}\n")
    run = Run(config, "cuda", params)
    assert run.n_step == 5
    run.start()
    U, t, step = input_netcdf(params, straight / "output_0000010.nc")
    g = params.ghost_width
    assert (run.n_step, run.t) == (step, t) == (10, t)
    assert np.array_equal(run.interior(), U[:, g:-g, g:-g, g:-g])
