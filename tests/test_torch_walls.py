"""The port's walled and jet slice against the JAX package on the CPU: 3D
ideal MHD with reflecting (DIRICHLET), outflow (NEUMANN) and mixed faces,
the MHD inflow jet and the hydro jet, through the step kernel's ghosted
mode (TPU row 3, pallas/fused_mhd3d.py:80 make_fused_mhd_update) and the
CFL kernel's ghosted mode, whose CPU twins run here.

The JAX references run in one subprocess with jax_enable_x64 (float32
arrays stay float32): the whole-array step ``godunov_unsplit_mhd(params,
make_boundaries(U), dt)`` that tests/test_pallas.py:47-67 holds row 3
equal to in interpret mode, and ``make_advance_n`` with kernel=jnp, op by
op under ``jax.disable_jit()``. The port follows that whole-array step on
the whole ghosted array: its CT curl also updates the max-side face layer
n+g (solvers/godunov_mhd.py mhd_3d_ghosted_update), so the ghost frame is
compared too, and the layer on its own. Pass criteria: one step, relative
L2 <= 1e-12 (f64) / 2e-6 (f32); 5-step slices, equal step counts, t within
rtol 1e-12 / 1e-6 and the whole ghosted array within relative L2 1e-11 /
2e-6 (the tolerances of tests/test_torch_hydro_step.py); the inverse dt on
a ghost frame that is not the fill of its interior within rtol 1e-14
(f64); the fills bitwise.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ramsesgpu_tpu_torch.config.configmap import ConfigMap
from ramsesgpu_tpu_torch.config.params import params_from_config

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
DTYPES = ("float32", "float64")
N_STEPS = 5
TOL_ONE = {"float32": 2e-6, "float64": 1e-12}
TOL_T = {"float32": 1e-6, "float64": 1e-12}
TOL_L2 = {"float32": 2e-6, "float64": 1e-11}
TOL_DT = 1e-14
# relative L2 of the C++ host build of csrc/ against the twins after one
# step (ULP-level differences only)
TOL_HOST = {"float32": 1e-6, "float64": 1e-13}

# The one-step cases share the MHD jet slice's mesh, 12 x 12 x 24, so that
# the JAX subprocess compiles its op-by-op primitives for them once per
# dtype (a mesh costs ~5 s of the file's 40 s of CPU)
MHD_MESH = (12, 12, 24)
# one-step cases: the shipped 3D Brio-Wu under each face mix (x NEUMANN,
# y PERIODIC, z DIRICHLET for the mix), and the MHD jet (its walls, and an
# ambient field bamb so that B varies at them)
ONE_STEP = {
    "neumann": ("data/testRiemannHLLD.ini", (2, 2, 2, 2, 2, 2), {}),
    "dirichlet": ("data/testRiemannHLLD.ini", (1, 1, 1, 1, 1, 1), {}),
    "mixed": ("data/testRiemannHLLD.ini", (2, 2, 3, 3, 1, 1), {}),
    "jet": ("data/mhd_jet3d.ini", None, {"ijet": 3, "offsetJet": 2, "[jet]": "bamb=0.7"}),
}
# the 5-step slices: the shipped inputs cut to size
SLICES = {
    "hlld": ("data/testRiemannHLLD.ini", (16, 16, 8), {}),
    "mhd_jet": ("data/mhd_jet3d.ini", MHD_MESH, {"ijet": 4, "offsetJet": 4}),
    "hydro_jet": ("data/jet3d_gpu.ini", (16, 16, 32), {"ijet": 4, "offsetJet": 6}),
}
FACES = ("xmin", "xmax", "ymin", "ymax", "zmin", "zmax")


def ini(path, mesh, dtype, kernel="auto", faces=None, keys=None, tend=None):
    """A shipped INI cut to ``mesh`` (nx, ny, nz), with the dtype, the
    kernel choice and, where given, the face types, the values of other
    keys ("[section]": a line added to that section) and tend."""
    text = (REPO / path).read_text()
    subs = dict(zip(("nx", "ny", "nz"), mesh), **(keys or {}))
    if faces is not None:
        subs.update({f"boundary_{f}": b for f, b in zip(FACES, faces)})
    if tend is not None:
        subs["tend"] = tend
    for key, value in subs.items():
        if key.startswith("["):
            n = text.count(key + "\n")
            text = text.replace(key + "\n", f"{key}\n{value}\n")
        else:
            text, n = re.subn(rf"^{key}=.*$", f"{key}={value}", text, flags=re.M)
        assert n == 1, key
    return text + f"\n[implementation]\ndtype={dtype}\nkernel={kernel}\n"


def one_step_ini(case, dtype, kernel="auto"):
    path, faces, keys = ONE_STEP[case]
    return ini(path, MHD_MESH, dtype, kernel, faces, keys)


def slice_ini(name, dtype, kernel="auto", tend=None):
    path, mesh, keys = SLICES[name]
    return ini(path, mesh, dtype, kernel, keys=keys, tend=tend)


def perturbed(U, seed):
    """U times (1 + 0.05 N(0, 1)) on every cell, ghosts included, from a
    numpy seed."""
    rng = np.random.default_rng(seed)
    return (U * (1 + 0.05 * rng.standard_normal(U.shape))).astype(U.dtype)


def rel_l2(a, b):
    """|a - b| / |b| in L2 (|a - b| where b is 0); sums of squares, not
    np.linalg.norm, whose BLAS threads spin on the suite's shared cores."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    diff = float(np.sqrt(np.square(a - b).sum()))
    return diff / (float(np.sqrt(np.square(b).sum())) or 1.0)


def layer_mask(shape, g):
    """The CT face layer: the cube g .. n+g of every axis minus the
    interior, [nz+2g, ny+2g, nx+2g]."""
    cube = np.zeros(shape, bool)
    cube[g:shape[0] - g + 1, g:shape[1] - g + 1, g:shape[2] - g + 1] = True
    cube[g:-g, g:-g, g:-g] = False
    return cube


def jax_references():
    """Every JAX reference of this file: numpy arrays by key."""
    import jax
    import jax.numpy as jnp

    from ramsesgpu_tpu.config.configmap import ConfigMap as JConfigMap
    from ramsesgpu_tpu.config.params import params_from_config as j_params
    from ramsesgpu_tpu.problems import init_problem
    from ramsesgpu_tpu.solvers.boundary import make_boundaries
    from ramsesgpu_tpu.solvers.godunov_mhd import godunov_unsplit_mhd
    from ramsesgpu_tpu.solvers.step import make_advance_n
    from ramsesgpu_tpu.solvers.timestep import compute_dt

    out = {}

    def setup(text):
        config = JConfigMap(text=text)
        params = j_params(config)
        return params, np.asarray(init_problem(params, config))

    with jax.disable_jit():
        for case in ONE_STEP:
            for dtype in DTYPES:
                params, U0 = setup(one_step_ini(case, dtype, "jnp"))
                U0 = perturbed(U0, 17)
                Ub = make_boundaries(params, jnp.asarray(U0))
                dt = compute_dt(params, Ub)
                key = f"one_{case}_{dtype}"
                out[key + "_U0"], out[key + "_Ub"] = U0, np.asarray(Ub)
                out[key + "_dt"] = np.asarray(dt)
                out[key + "_out"] = np.asarray(godunov_unsplit_mhd(params, Ub, dt))
        # the inverse dt of a state whose ghost frame is random, not a fill
        for case in ("neumann", "jet"):
            params, U0 = setup(one_step_ini(case, "float64", "jnp"))
            U0 = perturbed(U0, 23)
            out[f"dt_{case}_U"] = U0
            out[f"dt_{case}"] = np.asarray(compute_dt(params, jnp.asarray(U0)))
        # the hydro jet's fill
        params, U0 = setup(slice_ini("hydro_jet", "float64", "jnp"))
        U0 = perturbed(U0, 29)
        out["fill_hydro_jet_U0"] = U0
        out["fill_hydro_jet_Ub"] = np.asarray(make_boundaries(params, jnp.asarray(U0)))
        # the slices, one step per call (the while_loop's body repeated),
        # keeping t after each step and the state after 3 and 5 steps; the
        # hydro jet in float64
        for name in SLICES:
            for dtype in DTYPES if name != "hydro_jet" else ("float64",):
                text = slice_ini(name, dtype, "jnp")
                params, U0 = setup(text)
                advance = make_advance_n(params, JConfigMap(text=text))
                U = make_boundaries(params, jnp.asarray(U0))
                t = jnp.asarray(0.0, U.dtype)
                ts, ks = [], 0
                for step in range(N_STEPS):
                    U, t, k = advance(U, t, jnp.array(1, jnp.int32))
                    ts.append(float(t))
                    ks += int(k)
                    if step == 2:
                        out[f"slice_{name}_{dtype}_U3"] = np.asarray(U)
                key = f"slice_{name}_{dtype}"
                out[key + "_U"], out[key + "_t"], out[key + "_k"] = np.asarray(U), ts, ks
    return out


_JAX_SCRIPT = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import numpy as np
sys.path.insert(0, sys.argv[1])
import test_torch_walls as m
np.savez(sys.argv[2], **m.jax_references())
"""


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    """Every JAX reference of this file, from one subprocess."""
    out = tmp_path_factory.mktemp("jax_walls") / "ref.npz"
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    # a quick, single-threaded backend: the suite's other workers share the cores
    flags = "--xla_backend_optimization_level=0 --xla_cpu_multi_thread_eigen=false"
    env["XLA_FLAGS"] = " ".join(f for f in (env.get("XLA_FLAGS"), flags) if f)
    res = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(REPO / "tests"), str(out)],
                         capture_output=True, text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return dict(np.load(out))


def port(text):
    """The port's params and config of INI text."""
    config = ConfigMap(text=text)
    return params_from_config(config), config


def port_initial(params, config):
    """The port's ghosted initial state, ghosts filled (as Run makes it)."""
    from ramsesgpu_tpu_torch.problems import init_problem
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries

    return make_boundaries(params, torch.from_numpy(init_problem(params, config)))


def port_advance(params, U0, n):
    from ramsesgpu_tpu_torch.solvers.step import make_advance_n

    U, t, k = make_advance_n(params, "cpu")(U0.clone(), torch.zeros((), dtype=U0.dtype), n)
    return U.numpy(), float(t), int(k)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(ONE_STEP))
def test_one_step_matches_jax(case, dtype, jax_refs):
    """The ghosted step (its CPU twin through the kernel wrapper) on the
    port's fill of a perturbed Brio-Wu / jet state, against the JAX
    whole-array step on the JAX fill: the whole ghosted array, and the CT
    face layer n+g on its own."""
    from ramsesgpu_tpu_torch.kernels.mhd_step import mhd_step
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries

    key = f"one_{case}_{dtype}"
    params, _config = port(one_step_ini(case, dtype))
    U = make_boundaries(params, torch.from_numpy(jax_refs[key + "_U0"]))
    np.testing.assert_array_equal(U.numpy(), jax_refs[key + "_Ub"])
    dt = torch.from_numpy(jax_refs[key + "_dt"])
    assert dt.dtype == U.dtype
    mhd_step.ghosted(params, U, dt, torch.tensor(True))
    want = jax_refs[key + "_out"]
    assert U.dtype == getattr(torch, dtype)
    assert rel_l2(U.numpy(), want) <= TOL_ONE[dtype]
    layer = layer_mask(want.shape[1:], params.ghost_width)
    ub = jax_refs[key + "_Ub"]
    for ch in (5, 6, 7):
        got_l, want_l = U.numpy()[ch][layer], want[ch][layer]
        assert (want_l != ub[ch][layer]).any() or not ub[ch].any()  # the layer changed
        assert rel_l2(got_l, want_l) <= TOL_ONE[dtype], (ch, rel_l2(got_l, want_l))
    np.testing.assert_array_equal(U.numpy()[:5][:, layer], ub[:5][:, layer])


@pytest.mark.parametrize("case", list(ONE_STEP) + ["hydro_jet"])
def test_make_boundaries_matches_jax_bitwise(case, jax_refs):
    """The fill, the jet's included, bitwise the JAX package's; the
    in-place fill gated by a false flag writes nothing."""
    from ramsesgpu_tpu_torch.solvers.boundary import fill_ghosts_, make_boundaries

    if case == "hydro_jet":
        params, _ = port(slice_ini(case, "float64"))
        U0, want = jax_refs["fill_hydro_jet_U0"], jax_refs["fill_hydro_jet_Ub"]
    else:
        params, _ = port(one_step_ini(case, "float64"))
        U0, want = jax_refs[f"one_{case}_float64_U0"], jax_refs[f"one_{case}_float64_Ub"]
    U0 = torch.from_numpy(U0)
    np.testing.assert_array_equal(make_boundaries(params, U0).numpy(), want)
    U = U0.clone()
    fill_ghosts_(params, U, torch.tensor(False))
    assert torch.equal(U, U0)
    fill_ghosts_(params, U, torch.tensor(True))
    np.testing.assert_array_equal(U.numpy(), want)


@pytest.mark.parametrize("case", ["neumann", "jet"])
def test_inv_dt_of_unfilled_ghosts_matches_jax(case, jax_refs):
    """The CFL's ghosted mode (its twin) reads the +1 faces from the ghost
    frame as given: on random ghosts it is JAX compute_dt's, with and
    without the jet's term."""
    from ramsesgpu_tpu_torch.kernels.cfl_mhd import cfl_mhd
    from ramsesgpu_tpu_torch.solvers.timestep import compute_dt, dt_from_inv

    params, _ = port(one_step_ini(case, "float64"))
    U = torch.from_numpy(jax_refs[f"dt_{case}_U"])
    want = float(jax_refs[f"dt_{case}"])
    dt = float(dt_from_inv(params, cfl_mhd(params, U, ghost=params.ghost_width)))
    assert abs(dt - want) <= TOL_DT * want
    assert abs(float(compute_dt(params, U)) - want) <= TOL_DT * want


def check_slice(name, dtype, jax_refs):
    key = f"slice_{name}_{dtype}"
    U_ref, t_ref, k_ref = jax_refs[key + "_U"], jax_refs[key + "_t"][-1], int(jax_refs[key + "_k"])
    params, config = port(slice_ini(name, dtype))
    U, t, k = port_advance(params, port_initial(params, config).to(getattr(torch, dtype)),
                           N_STEPS)
    assert k == k_ref == N_STEPS
    assert U.dtype == U_ref.dtype == np.dtype(dtype) and U.shape == U_ref.shape
    assert np.isfinite(U).all()
    assert abs(t - t_ref) <= TOL_T[dtype] * abs(t_ref)
    assert rel_l2(U, U_ref) <= TOL_L2[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["hlld", "mhd_jet"])
def test_slice_matches_jax(name, dtype, jax_refs):
    """testRiemannHLLD.ini at 16x16x8 and mhd_jet3d.ini at 12x12x24
    (ijet 4, offsetJet 4), 5 steps of the port's make_advance_n
    (kernel=auto: the ghosted loop) against JAX make_advance_n
    (kernel=jnp), the whole ghosted array."""
    check_slice(name, dtype, jax_refs)


def test_hydro_jet_matches_jax(jax_refs):
    """jet3d_gpu.ini at 16x16x32 (ijet 4, offsetJet 6), 5 f64 steps: the
    hydro ghosted loop (the step kernel's ghosted mode in place, the CFL
    with the jet's floor) against JAX make_advance_n (kernel=jnp)."""
    check_slice("hydro_jet", "float64", jax_refs)


def test_chunk_stopping_at_t_end_returns_the_jax_state(jax_refs):
    """t_end between the 2nd and 3rd step's end: the chunk of 5 runs 3
    steps, and the two inactive steps leave the state, ghost frame
    included, as JAX's after 3 steps."""
    ts = jax_refs["slice_hlld_float64_t"]
    params, config = port(slice_ini("hlld", "float64", tend=repr(float(ts[1] + ts[2]) / 2)))
    U, t, k = port_advance(params, port_initial(params, config), N_STEPS)
    assert k == 3 and abs(t - ts[2]) <= TOL_T["float64"] * ts[2]
    assert rel_l2(U, jax_refs["slice_hlld_float64_U3"]) <= TOL_L2["float64"]


def test_chained_chunks_and_step_fn_equal_the_loop():
    """The packed chain in two chunks, and make_step_fn step by step,
    give the loop's state bitwise; the state passed in is not changed."""
    from ramsesgpu_tpu_torch.solvers.step import make_packed_advance_chain, make_step_fn

    params, config = port(slice_ini("mhd_jet", "float64"))
    U0 = port_initial(params, config)
    U_ref, t_ref, _ = port_advance(params, U0, 3)
    pack, advance, unpack = make_packed_advance_chain(params, "cpu")
    S, t = pack(U0), torch.zeros((), dtype=U0.dtype)
    S, t, k1 = advance(S, t, 2)
    S, t, k2 = advance(S, t, 1)
    np.testing.assert_array_equal(unpack(S, t).numpy(), U_ref)
    assert float(t) == t_ref and int(k1) + int(k2) == 3
    step, U, t = make_step_fn(params, "cpu"), U0.clone(), 0.0
    for _ in range(3):
        U_in = U.clone()
        U, dt = step(U, t)
        t += float(dt)
        assert not torch.equal(U, U_in)
    np.testing.assert_array_equal(U.numpy(), U_ref)


def test_fused_mhd_update_is_the_twins_interior(jax_refs):
    """make_fused_mhd_update: TPU row 3's outside contract, update(U, dt)
    -> the new interior, equal to the twin's interior (and to JAX's)."""
    from ramsesgpu_tpu_torch.kernels.fused_mhd3d import make_fused_mhd_update
    from ramsesgpu_tpu_torch.solvers.boundary import interior
    from ramsesgpu_tpu_torch.solvers.godunov_mhd import mhd_3d_ghosted_update

    key = "one_mixed_float64"
    params, _ = port(one_step_ini("mixed", "float64"))
    U = torch.from_numpy(jax_refs[key + "_Ub"])
    dt = float(jax_refs[key + "_dt"])
    got = make_fused_mhd_update(params, "cpu")(U, dt)
    assert tuple(got.shape) == (8, params.nz, params.ny, params.nx)
    want = interior(params, mhd_3d_ghosted_update(params, U, torch.tensor(dt, dtype=U.dtype)))
    assert torch.equal(got, want)
    g = params.ghost_width
    assert rel_l2(got.numpy(), jax_refs[key + "_out"][:, g:-g, g:-g, g:-g]) <= TOL_ONE["float64"]


def test_compensated_walls_run_the_plain_update():
    """compensated=yes with walls runs the plain update (the JAX walled
    step has no compensated branch): bitwise the run with compensated=no."""
    params, config = port(slice_ini("hlld", "float32").replace(
        "[implementation]\n", "[implementation]\ncompensated=yes\n"))
    assert params.compensated
    U0 = port_initial(params, config).float()
    U_c, t_c, k_c = port_advance(params, U0, 3)
    U_p, t_p, k_p = port_advance(params.replace(compensated=False), U0, 3)
    np.testing.assert_array_equal(U_c, U_p)
    assert (t_c, k_c) == (t_p, k_p)


@pytest.mark.parametrize("dtype", DTYPES)
def test_csrc_host_build_matches_twins(dtype, jax_refs):
    """The ghosted modes of csrc/mhd_step.cu and csrc/cfl_mhd.cu, built
    with g++, against the twins on the one-step states of every face mix
    and the jet: the inverse dt bitwise (the jet's floor in the kernel),
    an inactive step changes nothing, the step within TOL_HOST."""
    from ramsesgpu_tpu_torch.kernels.build import load_library, param_block
    from ramsesgpu_tpu_torch.solvers.godunov_mhd import mhd_3d_ghosted_update
    from ramsesgpu_tpu_torch.solvers.timestep import dt_from_inv, inv_dt_mhd_ghosted, jet_inv_dt

    lib = load_library("host")
    sfx = "f32" if dtype == "float32" else "f64"
    cfl = getattr(lib, f"ramses_cfl_mhd_ghosted_{sfx}")
    step = getattr(lib, f"ramses_mhd_step_ghosted_{sfx}")
    for case in ONE_STEP:
        params, _ = port(one_step_ini(case, dtype))
        U0 = torch.from_numpy(jax_refs[f"one_{case}_{dtype}_Ub"])
        dims, g, blk = (params.nx, params.ny, params.nz), params.ghost_width, param_block(params)
        jet = jet_inv_dt(params)
        inv = torch.zeros((), dtype=U0.dtype)
        assert cfl(U0.data_ptr(), None, None, inv.data_ptr(), *dims, g,
                   float("-inf") if jet is None else jet, blk, None) == 0
        inv_ref = inv_dt_mhd_ghosted(params, U0)
        assert torch.equal(inv, inv_ref), case
        dt = dt_from_inv(params, inv_ref)
        want = mhd_3d_ghosted_update(params, U0, dt)
        scratch = torch.empty(lib.ramses_mhd_step_ghosted_scratch(*dims, g), dtype=U0.dtype)
        U = U0.clone()
        for active in (False, True):
            flag = torch.tensor(active)
            assert step(U.data_ptr(), scratch.data_ptr(), dt.data_ptr(), flag.data_ptr(),
                        *dims, g, blk, None) == 0
            if not active:
                assert torch.equal(U, U0), case
        assert rel_l2(U.numpy(), want.numpy()) <= TOL_HOST[dtype], case
