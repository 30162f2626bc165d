"""The port's z-streaming step kernels (``[implementation] kernel=zcarry``)
on the CPU.

- The g++ host build (kernels/build.py ``build("host")``) of
  csrc/zcarry_mhd.cu and csrc/zcarry_hydro.cu, whose block bodies run as
  serial phase loops with the same ring, warm-up and drain logic as on the
  card (the MHD kernel's two warp groups in one serial schedule, the
  producer as far ahead of the consumer as its ring allows), and a
  persistent grid of 3 blocks striding over the work items. Grids whose
  tiles (MHD 16 x 8 in f32, 8 x 8 in f64; hydro 16 x 8) do not divide nx
  and ny, a single z plane, nz = 2, and a single tile whose nz = 7 planes
  the blocks take in z chunks of 3 (a chunk as deep as the ring, and one
  shallower); the MHD modes also on a grid of partial tiles taken by 8
  blocks in z chunks of 4 and 3, with a random Bz. Held against the twins
  (relative L2 1e-6 f32 / 1e-13 f64) and, bitwise, against the host build
  of the staged kernels on the same input (the same arithmetic in the same
  order: csrc/mhd_stages.cuh, csrc/hydro_stages.cuh); an inactive step
  copies its input.
- The folded inverse dt against the CFL kernel's host build on the
  kernel's own output, bitwise, and against the CFL twin.
- Against the JAX package: the port's kernel=zcarry advance, 3 steps,
  against the JAX whole-array run (``make_advance_n`` with kernel=jnp,
  op by op under ``jax.disable_jit()``, in one subprocess with
  jax_enable_x64) for compensated Orszag-Tang and the compensated MRI,
  interiors (and the kept face) within relative L2 2e-6 (f32), t within
  rtol 1e-6, equal step counts. Three steps end in the loop's second
  buffer, so the copy back into the caller's state is held too. The other
  paths' kernel=zcarry runs are held against the JAX runs of their own
  test files (see CASES).
"""
import ctypes
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import test_torch_dissip as dissip
import test_torch_hydro_step as hydro
import test_torch_shear as shear
import test_torch_stratified as strat
from ramsesgpu_tpu_torch.config.configmap import ConfigMap
from ramsesgpu_tpu_torch.config.params import params_from_config

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
N_STEPS = 3
TOL_T = {"float32": 1e-6, "float64": 1e-12}
TOL_L2 = {"float32": 2e-6, "float64": 1e-13}
TOL_HOST = {torch.float32: 1e-6, torch.float64: 1e-13}
TORCH_DTYPE = {"float32": torch.float32, "float64": torch.float64}


def with_mesh(text: str, nx: int, ny: int, nz: int, old=(16, 16, 16)) -> str:
    for key, a, b in zip(("nx", "ny", "nz"), old, (nx, ny, nz)):
        text = text.replace(f"\n{key}={a}\n", f"\n{key}={b}\n", 1)
    return text


def set_impl(text: str, **keys) -> str:
    """The INI text with [implementation] keys set (prepended to the section)."""
    lines = "".join(f"{k}={v}\n" for k, v in keys.items())
    return text.replace("[implementation]\n", "[implementation]\n" + lines, 1)


# -------------------------------------------------------------------------
# the runs held against the JAX package
# -------------------------------------------------------------------------
def case_text(name: str, dtype: str, kernel: str) -> str:
    """The INI of one compensated case: Orszag-Tang at 16^3, the MRI at
    16 x 32 x 16."""
    if name == "ot-comp":
        return set_impl(dissip.ini("ot", dtype, (0.0, 0.0), kernel=kernel), compensated="yes")
    if name == "mri-comp":
        return set_impl(shear.ini(dtype, kernel=kernel, coeffs=1.0), compensated="yes")
    raise ValueError(name)


# the compensated runs (two state buffers of 16 channels, the carry read
# and written per cell); each other path's kernel=zcarry run is held against
# the JAX run of its own test file (test_zcarry_slice_matches_jax in
# tests/test_torch_step.py, test_torch_hydro_step.py, test_torch_shear.py,
# test_torch_dissip.py; test_zcarry_stratified_mri_matches_jax in
# tests/test_torch_stratified.py)
CASES = [("ot-comp", "float32"), ("mri-comp", "float32")]


def t_start(params) -> float:
    """0 (periodic), or a time whose sheared-fill offset deltay/dy is 2.5."""
    return 0.0 if params.omega0 == 0 else shear.t_start(params)


def interior_and_kept(params, U):
    """The interior of a ghosted state, numpy, and (shearing box) the kept
    Bx face: the first xmax ghost column."""
    g, nx = params.ghost_width, params.nx
    U = np.asarray(U)
    parts = [U[:, g:-g, g:-g, g:g + nx]]
    if params.omega0 > 0:
        parts.append(U[5, g:-g, g:-g, nx + g])
    return parts


def jax_case(name, dtype):
    """The JAX whole-array run of one case: (U0, U, t, k)."""
    import jax
    import jax.numpy as jnp
    from ramsesgpu_tpu.config.configmap import ConfigMap as JConfigMap
    from ramsesgpu_tpu.config.params import params_from_config as j_params
    from ramsesgpu_tpu.problems import init_problem
    from ramsesgpu_tpu.solvers.boundary import make_boundaries
    from ramsesgpu_tpu.solvers.shear import make_all_boundaries_shear
    from ramsesgpu_tpu.solvers.step import make_advance_n, uses_shear

    config = JConfigMap(text=case_text(name, dtype, "jnp"))
    params = j_params(config)
    with jax.disable_jit():
        U = make_boundaries(params, jnp.asarray(init_problem(params, config), params.dtype))
        t0 = jnp.asarray(t_start(params), U.dtype)
        if uses_shear(params):
            U = make_all_boundaries_shear(params, U, t0)
        Uf, t, k = make_advance_n(params, config)(U, t0, jnp.array(N_STEPS, jnp.int32))
    return np.asarray(U), np.asarray(Uf), float(t), int(k)


_JAX_SCRIPT = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import numpy as np
sys.path.insert(0, sys.argv[1])
import test_torch_zcarry as m
out = {}
for name, dtype in m.CASES:
    key = f"{name}_{dtype}"
    out[key + "_U0"], out[key + "_U"], out[key + "_t"], out[key + "_k"] = m.jax_case(name, dtype)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    """{(name, dtype): (U0, U, t, k)} of the JAX package, one subprocess."""
    out = tmp_path_factory.mktemp("jax_zcarry") / "ref.npz"
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    # a quick, single-threaded backend: the suite's other workers share the
    # cores (the arrays are bitwise those of the default backend)
    flags = ("--xla_backend_optimization_level=0 --xla_cpu_multi_thread_eigen=false "
             "intra_op_parallelism_threads=1")
    env["XLA_FLAGS"] = " ".join(f for f in (env.get("XLA_FLAGS"), flags) if f)
    res = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(REPO / "tests"), str(out)],
                         capture_output=True, text=True, env=env, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    ref = np.load(out)
    return {(n, d): tuple(ref[f"{n}_{d}_{x}"] for x in ("U0", "U", "t", "k")) for n, d in CASES}


@pytest.mark.parametrize("name, dtype", CASES, ids=[f"{n}-{d}" for n, d in CASES])
def test_zcarry_advance_matches_jax(name, dtype, jax_refs):
    from ramsesgpu_tpu_torch.solvers.step import make_advance_n

    U0_ref, U_ref, t_ref, k_ref = jax_refs[name, dtype]
    config = ConfigMap(text=case_text(name, dtype, "zcarry"))
    params = params_from_config(config)
    assert params.kernel == "zcarry"
    U0 = torch.from_numpy(U0_ref)   # the JAX run's filled start (the port's fill: its tests)
    t0 = torch.tensor(t_start(params), dtype=U0.dtype)
    U, t, k = make_advance_n(params, "cpu", config)(U0, t0, N_STEPS)
    assert int(k) == k_ref == N_STEPS
    assert U.dtype == TORCH_DTYPE[dtype] and torch.isfinite(U).all()
    assert abs(float(t) - t_ref) <= TOL_T[dtype] * abs(t_ref)
    got, want = interior_and_kept(params, U), interior_and_kept(params, U_ref)
    assert dissip.state_rel(got, want) <= TOL_L2[dtype]


# -------------------------------------------------------------------------
# the host build of the kernels
# -------------------------------------------------------------------------
# (nx, ny, nz): several x and y tiles, the last of each partial where
# the tile (hydro and MHD f32 16 x 8, MHD f64 8 x 8) does not divide; a
# single z plane; nz = 2
GRIDS = [(40, 20, 7), (20, 12, 7), (40, 20, 1), (40, 20, 2)]
# and a partial last y tile of 22 rows; and one partial tile of each
# dtype, which the 3 host blocks take in z chunks of 3 (a chunk as deep as
# the precursor ring, and a last one of 1 plane, shallower)
MHD_HOST = ([(d, g) for d in ("float32", "float64") for g in GRIDS]
            + [("float64", (40, 22, 7)), ("float32", (10, 6, 7)), ("float64", (6, 3, 7))])


def host_lib():
    from ramsesgpu_tpu_torch.kernels.build import load_library

    return load_library("host")


def noisy(S, seed):
    """S times (1 + 5 % noise): a state whose every cell differs."""
    rng = np.random.default_rng(seed)
    return (S * (1 + 0.05 * torch.from_numpy(rng.standard_normal(S.shape)).to(S.dtype)))


def rel(got, want) -> float:
    return float(torch.linalg.norm((got - want).double()) / torch.linalg.norm(want.double()))


def ot_state(dtype, nx, ny, nz, comp):
    """Orszag-Tang at (nx, ny, nz), noisy, with a random Kahan carry when
    comp: (params, S). nz = 1 takes the first plane of nz = 2 (the
    params of one plane would be a 2D run)."""
    from ramsesgpu_tpu_torch.problems import init_problem
    from ramsesgpu_tpu_torch.solvers.boundary import interior, make_boundaries

    text = with_mesh(dissip.ini("ot", dtype, (0.0, 0.0), kernel="zcarry"), nx, ny, max(nz, 2))
    config = ConfigMap(text=set_impl(text, compensated="yes") if comp else text)
    params = params_from_config(config)
    U = make_boundaries(params, torch.from_numpy(init_problem(params, config)).to(TORCH_DTYPE[dtype]))
    S = noisy(interior(params, U)[:, :nz], 7)
    if comp:
        S = torch.cat([S, 1e-7 * noisy(torch.ones_like(S), 8) * S])
    return params, S.contiguous()


def check_host_periodic(lib, params, S, comp, blocks):
    """The periodic mode on S: bitwise the staged host kernel, within
    TOL_HOST of the twin; the folded inverse dt bitwise the CFL kernel's
    (and the twin's) on the kernel's output; inactive: a copy."""
    from ramsesgpu_tpu_torch.kernels.build import param_block
    from ramsesgpu_tpu_torch.solvers.godunov_mhd import mhd_3d_periodic_update
    from ramsesgpu_tpu_torch.solvers.timestep import dt_from_inv, inv_dt_mhd_periodic

    nz, ny, nx = S.shape[-3:]
    sfx = "f32" if S.dtype == torch.float32 else "f64"
    blk = param_block(params)
    dt = dt_from_inv(params, inv_dt_mhd_periodic(params, S[:8]))
    for active in (True, False):
        out = torch.full_like(S, float("nan"))
        inv = torch.full((), float("nan"), dtype=S.dtype)
        flag = torch.tensor(active)
        assert getattr(lib, f"ramses_zcarry_mhd_{sfx}")(
            S.data_ptr(), out.data_ptr(), blocks, None, None, None, None,
            inv.data_ptr(), dt.data_ptr(), flag.data_ptr(), int(comp), nx, ny, nz, blk,
            None) == 0
        staged = S.clone()
        scratch = torch.empty(lib.ramses_mhd_step_scratch_per_cell() * nx * ny * nz,
                              dtype=S.dtype)
        assert getattr(lib, f"ramses_mhd_step_{sfx}")(
            staged.data_ptr(), scratch.data_ptr(), dt.data_ptr(), flag.data_ptr(), int(comp),
            nx, ny, nz, blk, None) == 0
        assert torch.equal(out, staged)
        if not active:
            assert torch.equal(out, S)
        else:
            assert rel(out[:8], mhd_3d_periodic_update(params, S, dt)[:8]) <= TOL_HOST[S.dtype]
        inv_cfl = torch.zeros((), dtype=S.dtype)
        assert getattr(lib, f"ramses_cfl_mhd_{sfx}")(
            out.data_ptr(), None, None, inv_cfl.data_ptr(), nx, ny, nz, blk, None) == 0
        assert float(inv) == float(inv_cfl) == float(inv_dt_mhd_periodic(params, out[:8]))


@pytest.mark.parametrize("dtype, grid", MHD_HOST,
                         ids=[f"{d}-{'x'.join(map(str, g))}" for d, g in MHD_HOST])
def test_host_zcarry_mhd_periodic(dtype, grid):
    """The periodic mode, plain and compensated: bitwise the staged host
    kernel, within TOL_HOST of the twin; the folded inverse dt bitwise the
    CFL kernel's (and the twin's) on the kernel's output; inactive: a copy."""
    from ramsesgpu_tpu_torch.kernels.build import param_block

    lib = host_lib()
    for comp in (False, True):
        params, S = ot_state(dtype, *grid, comp)
        blocks = lib.ramses_zcarry_mhd_blocks(0, 0, int(dtype == "float64"), param_block(params))
        check_host_periodic(lib, params, S, comp, blocks)


SHEAR_MODES = ["isothermal", "adiabatic", "stratified"]


def shear_state(dtype, mode, grid=(40, 20, 5)):
    """A shearing-box state at grid (nx, ny, nz) with a random Kahan carry
    and its inputs: (params, S, kept, slabs, zslabs, gz, dt)."""
    from ramsesgpu_tpu_torch.kernels.shear import pack
    from ramsesgpu_tpu_torch.problems import init_problem
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries
    from ramsesgpu_tpu_torch.solvers.shear import shear_slabs, stratified_zslabs
    from ramsesgpu_tpu_torch.solvers.step import gravity_z
    from ramsesgpu_tpu_torch.solvers.timestep import dt_from_inv, inv_dt_mhd_shear

    if mode == "stratified":
        text = strat.strat_text(dtype, *grid)
    else:
        text = with_mesh(shear.ini(dtype, coeffs=1.0), *grid, old=(16, 32, 16))
        text = set_impl(text, compensated="yes")
    config = ConfigMap(text=text)
    params = params_from_config(config)
    tdt = TORCH_DTYPE[dtype]
    init = params if mode != "adiabatic" else params.replace(c_iso=1.0)
    U = make_boundaries(params, torch.from_numpy(init_problem(init, config)).to(tdt))
    if mode == "adiabatic":
        params = params.replace(c_iso=0.0)
    S, kept = pack(params, U)
    S[:8] = noisy(S[:8], 9)
    S[8:] = 1e-7 * noisy(torch.ones_like(S[:8]), 10) * S[:8]
    dt = dt_from_inv(params, inv_dt_mhd_shear(params, S, kept[0]))
    t = torch.tensor(t_start(params), dtype=tdt) + dt
    slabs = shear_slabs(params, S[:8], kept[0], t).contiguous()
    zslabs = gz = None
    if mode == "stratified":
        zslabs = stratified_zslabs(params, S[:8], slabs).contiguous()
        gz = gravity_z(params, config, "cpu").to(tdt).contiguous()
    return params, S.contiguous(), kept, slabs, zslabs, gz, dt


def check_host_shear(lib, params, S, slabs, zslabs, gz, dt, blocks):
    """The shear modes (compensated): state and x-face planes bitwise the
    staged host kernel's, within TOL_HOST of the twin."""
    from ramsesgpu_tpu_torch.kernels.build import param_block
    from ramsesgpu_tpu_torch.solvers.godunov_mhd import mhd_3d_shear_update

    sfx = "f32" if S.dtype == torch.float32 else "f64"
    dims, blk = (params.nx, params.ny, params.nz), param_block(params)
    is_strat = zslabs is not None
    ptr = (lambda x: None if x is None else x.data_ptr())
    out = torch.full_like(S, float("nan"))
    planes = torch.zeros((5, params.nz, params.ny), dtype=S.dtype)
    flag = torch.tensor(True)
    assert getattr(lib, f"ramses_zcarry_mhd_{sfx}")(
        S.data_ptr(), out.data_ptr(), blocks, slabs.data_ptr(),
        planes.data_ptr(), ptr(zslabs), ptr(gz), None, dt.data_ptr(), flag.data_ptr(), 1, *dims,
        blk, None) == 0
    staged = S.clone()
    staged_planes = torch.zeros_like(planes)
    scratch = torch.empty(lib.ramses_mhd_step_shear_scratch(*dims, int(is_strat)), dtype=S.dtype)
    assert getattr(lib, f"ramses_mhd_step_shear_{sfx}")(
        staged.data_ptr(), scratch.data_ptr(), slabs.data_ptr(), staged_planes.data_ptr(),
        ptr(zslabs), ptr(gz), dt.data_ptr(), flag.data_ptr(), 1, *dims, blk, None) == 0
    assert torch.equal(out, staged) and torch.equal(planes, staged_planes)
    want, want_planes = mhd_3d_shear_update(params, S, slabs, dt, zslabs, gz)
    assert rel(out[:8], want[:8]) <= TOL_HOST[S.dtype]
    assert rel(planes, want_planes) <= TOL_HOST[S.dtype]


@pytest.mark.parametrize("mode", SHEAR_MODES)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_host_zcarry_mhd_shear(dtype, mode):
    """The shear modes (compensated): state and x-face planes bitwise the
    staged host kernel's, within TOL_HOST of the twin; no folded CFL."""
    from ramsesgpu_tpu_torch.kernels.build import param_block

    lib = host_lib()
    params, S, _kept, slabs, zslabs, gz, dt = shear_state(dtype, mode)
    blocks = lib.ramses_zcarry_mhd_blocks(1, int(mode == "stratified"),
                                          int(dtype == "float64"), param_block(params))
    check_host_shear(lib, params, S, slabs, zslabs, gz, dt, blocks)


# the edge tiles and a short last z chunk: per dtype a grid that its tile
# divides along neither x nor y (2 x 2 tiles, the last ones 2 columns and
# 2 rows wide), taken by a persistent grid of 8 blocks in z chunks of 4 and
# 3 planes; the periodic state gets a random Bz (Orszag-Tang's is 0), which
# reaches the pressure of the plane above a chunk's top through prim
EDGE_GRID = {"float32": (18, 10, 7), "float64": (10, 10, 7)}
EDGE_BLOCKS = 8


@pytest.mark.parametrize("mode", ["periodic", "adiabatic"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_host_zcarry_mhd_edge_tiles(dtype, mode):
    """The periodic mode (plain and compensated) and the adiabatic shear
    mode on partial edge tiles and a short last z chunk: bitwise the
    staged host kernel, within TOL_HOST of the twin (and the folded inverse
    dt: bitwise the CFL kernel's)."""
    lib = host_lib()
    grid = EDGE_GRID[dtype]
    f64 = int(dtype == "float64")
    assert lib.ramses_zcarry_mhd_chunk_depth(f64, *grid, EDGE_BLOCKS) == 4
    tile = (ctypes.c_int * 5)()
    lib.ramses_zcarry_mhd_tile(f64, tile)
    assert grid[0] % tile[0] and grid[1] % tile[1] and tile[3] + tile[4] == tile[2]
    if mode == "periodic":
        for comp in (False, True):
            params, S = ot_state(dtype, *grid, comp)
            bx = S[5].abs().max()
            rng = np.random.default_rng(11)
            S[7] += 0.1 * bx * torch.from_numpy(rng.standard_normal(S[7].shape)).to(S.dtype)
            check_host_periodic(lib, params, S, comp, EDGE_BLOCKS)
    else:
        params, S, _kept, slabs, zslabs, gz, dt = shear_state(dtype, mode, grid)
        check_host_shear(lib, params, S, slabs, zslabs, gz, dt, EDGE_BLOCKS)


HYDRO_GRIDS = [((40, 20, 7), "approx"), ((20, 12, 7), "hllc"), ((40, 20, 2), "hll"),
               ((10, 6, 7), "approx")]


@pytest.mark.parametrize("grid, solver", HYDRO_GRIDS,
                         ids=[s if i < 3 else f"{s}-{'x'.join(map(str, g))}"
                              for i, (g, s) in enumerate(HYDRO_GRIDS)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_host_zcarry_hydro(dtype, grid, solver):
    """The periodic hydro step: bitwise the step kernel's host build
    (interior PERIODIC mode), within TOL_HOST of the twin; the folded inverse dt
    bitwise the CFL kernel's and the twin's on the kernel's output;
    inactive: a copy."""
    from ramsesgpu_tpu_torch.kernels.build import param_block
    from ramsesgpu_tpu_torch.kernels.packed_bc import bc_codes
    from ramsesgpu_tpu_torch.problems import init_problem
    from ramsesgpu_tpu_torch.solvers.boundary import interior, make_boundaries
    from ramsesgpu_tpu_torch.solvers.godunov import hydro_3d_state_update
    from ramsesgpu_tpu_torch.solvers.timestep import compute_inv_dt_hydro, dt_from_inv

    lib = host_lib()
    nx, ny, nz = grid
    sfx = "f32" if dtype == "float32" else "f64"
    config = ConfigMap(text=with_mesh(hydro.ini("blast", dtype, kernel="zcarry", solver=solver),
                                      nx, ny, nz))
    params = params_from_config(config)
    U = make_boundaries(params, torch.from_numpy(init_problem(params, config)).to(TORCH_DTYPE[dtype]))
    S = noisy(interior(params, U), 11).contiguous()
    blk = param_block(params)
    dt = dt_from_inv(params, compute_inv_dt_hydro(params, S, ghost=0))
    f64 = int(dtype == "float64")
    blocks = lib.ramses_zcarry_hydro_blocks(f64)
    for active in (True, False):
        out = torch.full_like(S, float("nan"))
        inv = torch.full((), float("nan"), dtype=S.dtype)
        flag = torch.tensor(active)
        assert getattr(lib, f"ramses_zcarry_hydro_{sfx}")(
            S.data_ptr(), out.data_ptr(), blocks, inv.data_ptr(), dt.data_ptr(),
            flag.data_ptr(), nx, ny, nz, blk, None) == 0
        staged = torch.empty_like(S)
        assert getattr(lib, f"ramses_hydro_step_{sfx}")(
            S.data_ptr(), staged.data_ptr(), lib.ramses_hydro_step_blocks(f64), dt.data_ptr(),
            flag.data_ptr(), nx, ny, nz, 0, bc_codes(params), blk, None, None) == 0
        assert torch.equal(out, staged)
        if not active:
            assert torch.equal(out, S)
        else:
            assert rel(out, hydro_3d_state_update(params, S, dt)) <= TOL_HOST[S.dtype]
        inv_cfl = torch.zeros((), dtype=S.dtype)
        assert getattr(lib, f"ramses_cfl_hydro_{sfx}")(
            out.data_ptr(), None, inv_cfl.data_ptr(), nx, ny, nz, 0, blk, None) == 0
        assert float(inv) == float(inv_cfl) == float(compute_inv_dt_hydro(params, out, ghost=0))


# 8 serial blocks: on a grid of 2 x 2 partial tiles of the streamed hydro
# body, the z chunks of nz = 7 leave a short last one (4 + 3 planes)
STREAM_BLOCKS = 8


@pytest.mark.parametrize("solver", ["approx", "hll", "hllc"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_host_hydro_stream_edge_tiles(dtype, solver):
    """The streamed hydro body (csrc/hydro_stream.cuh) on partial tiles and
    a short last z chunk: csrc/hydro_step.cu's interior mode on mixed
    DIRICHLET / NEUMANN / PERIODIC faces and on periodic ones, its ghosted
    mode into out and in place, each within TOL_HOST of the twin and
    bitwise one another; an inactive in-place step changes nothing; on the
    periodic faces row 13 (csrc/zcarry_hydro.cu) bitwise the interior mode,
    its folded inverse dt the twin's on its output."""
    from test_torch_hydro_ops import ini_text, random_state

    from ramsesgpu_tpu_torch.kernels.build import param_block
    from ramsesgpu_tpu_torch.kernels.packed_bc import bc_codes
    from ramsesgpu_tpu_torch.solvers.boundary import interior, make_boundaries
    from ramsesgpu_tpu_torch.solvers.godunov import hydro_3d_state_update
    from ramsesgpu_tpu_torch.solvers.timestep import compute_inv_dt_hydro, dt_from_inv

    lib = host_lib()
    f64 = int(dtype == "float64")
    sfx = "f64" if f64 else "f32"
    tile = (ctypes.c_int * 6)()
    lib.ramses_hydro_stream_tile(f64, tile)
    nx, ny, nz = tile[0] + 4, tile[1] + 4, 7
    assert tile[3] + tile[4] == tile[2]
    assert lib.ramses_hydro_stream_chunk_depth(f64, nx, ny, nz, STREAM_BLOCKS) == 4
    step = getattr(lib, f"ramses_hydro_step_{sfx}")
    rng = np.random.default_rng(12)
    on, off = torch.tensor(True), torch.tensor(False)
    for bcs in ((1, 2, 2, 1, 3, 3), (3,) * 6):
        text = with_mesh(ini_text(dtype, solver=solver, bcs=bcs, slope=2.0), nx, ny, nz)
        params = params_from_config(ConfigMap(text=text))
        U = make_boundaries(params, torch.from_numpy(random_state(params, rng, dtype)))
        S = interior(params, U).contiguous()
        blk, codes = param_block(params), bc_codes(params)
        dt = dt_from_inv(params, compute_inv_dt_hydro(params, S, ghost=0))
        want = hydro_3d_state_update(params, S, dt)
        outs = []
        for ghosted, src in ((0, S), (1, U), (2, U.clone())):
            for flag in ((off, on) if ghosted == 2 else (on,)):
                out = torch.full_like(S, float("nan"))
                assert step(src.data_ptr(), out.data_ptr(), STREAM_BLOCKS, dt.data_ptr(),
                            flag.data_ptr(), nx, ny, nz, ghosted, codes, blk, None, None) == 0
                if ghosted == 2 and not flag:
                    assert torch.equal(src, U), (bcs, "inactive in place")
            got = interior(params, src) if ghosted == 2 else out
            assert rel(got, want) <= TOL_HOST[S.dtype], (bcs, ghosted)
            outs.append(got)
        assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2]), bcs
        ghosts = torch.ones_like(U, dtype=torch.bool)
        interior(params, ghosts).fill_(False)
        assert torch.equal(src[ghosts], U[ghosts]), bcs  # the in-place step keeps the ghosts
        if bcs == (3,) * 6:
            out = torch.full_like(S, float("nan"))
            inv = torch.full((), float("nan"), dtype=S.dtype)
            assert getattr(lib, f"ramses_zcarry_hydro_{sfx}")(
                S.data_ptr(), out.data_ptr(), STREAM_BLOCKS, inv.data_ptr(), dt.data_ptr(),
                on.data_ptr(), nx, ny, nz, blk, None) == 0
            assert torch.equal(out, outs[0])
            assert float(inv) == float(compute_inv_dt_hydro(params, out, ghost=0))


def test_zcarry_loops_equal_staged_loops_on_cpu():
    """On the CPU both kernel choices run the twins: the inv-carry loop of
    kernel=zcarry, with its two buffers and its odd-step copy back, gives
    bitwise the staged loop's state, t and step count, chained in chunks
    of 1 and 2 steps, and its packed state stays the caller's tensor."""
    from ramsesgpu_tpu_torch.solvers.step import make_packed_advance_chain

    results = {}
    for kernel in ("auto", "zcarry"):
        config = ConfigMap(text=case_text("mri-comp", "float32", kernel))
        params = params_from_config(config)
        U0 = shear.setup("float32", 1.0)[3]
        pack, advance, unpack = make_packed_advance_chain(params, "cpu", config)
        state = pack(U0)
        t = torch.tensor(t_start(params), dtype=torch.float32)
        before = [x.data_ptr() for x in state]
        state, t, k1 = advance(state, t, 1)
        state, t, k2 = advance(state, t, 2)
        assert [x.data_ptr() for x in state] == before
        results[kernel] = (unpack(state, t), float(t), int(k1) + int(k2))
    assert torch.equal(results["auto"][0], results["zcarry"][0])
    assert results["auto"][1:] == results["zcarry"][1:] == (float(results["auto"][1]), 3)
