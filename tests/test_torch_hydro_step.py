"""The port's 3D hydro slice against the JAX package on the CPU: implode
(six reflecting walls, approx solver) and blast (fully periodic), 16^3
(g = 2), 5 steps; the CUDA sources compiled as plain C++ against the
twins; state conversion; the CLI; the configurations the port refuses.

The JAX reference is ``make_advance_n`` with ``[implementation]
kernel=jnp``: its whole-array path, which tests/test_pallas.py holds equal
to the Pallas hydro kernels in interpret mode. It runs op by op under
``jax.disable_jit()`` (half the CPU time of compiling the jitted loop), in
one subprocess with jax_enable_x64 (process-global); that subprocess also
runs the float64 cases of tests/test_torch_hydro_ops.py, so the JAX
package starts once. float32 arrays stay float32 under x64 (the same bits
as without it). The port runs its kernel loop, whose wrappers run their
plain twins on CPU tensors. Pass criteria, as for the MHD slice: equal
step counts; t within rtol 1e-6 (f32) / 1e-12 (f64); interior relative L2
<= 2e-6 (f32) / 1e-11 (f64).
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ramsesgpu_tpu_torch.config.configmap import ConfigMap
from ramsesgpu_tpu_torch.config.params import params_from_config

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
N_STEPS = 5
TOL_T = {"float32": 1e-6, "float64": 1e-12}
TOL_L2 = {"float32": 2e-6, "float64": 1e-11}
TOL_ZCARRY = {"float32": 2e-6, "float64": 1e-13}

# data/implode3d.ini at 16^3; blast: scripts/perf_table.py's overrides
HYDRO_INI = """
[run]
tend={tend}
noutput=100
nstepmax=400
[mesh]
nx=16
ny=16
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
iorder=2
slope_type=1.0
scheme=muscl
cfl=0.8
riemannSolver={solver}
[blast]
radius=0.2
[implementation]
dtype={dtype}
kernel={kernel}
[output]
outputDir={outdir}
outputPrefix=implode3d
outputVtk=yes
outputHdf5=no
"""
PROBLEMS = {"implode": 1, "blast": 3}  # problem -> boundary type of every face


def ini(problem="implode", dtype="float32", kernel="auto", tend=0.4, solver="approx", outdir="."):
    return HYDRO_INI.format(problem=problem, bc=PROBLEMS[problem], dtype=dtype, kernel=kernel,
                            tend=tend, solver=solver, outdir=outdir)


def setup(problem="implode", dtype="float32", **kw):
    """The port's params and ghosted initial state (ghosts filled)."""
    from ramsesgpu_tpu_torch.problems import init_problem
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries

    config = ConfigMap(text=ini(problem, dtype, **kw))
    params = params_from_config(config)
    U0 = torch.from_numpy(init_problem(params, config))
    return params, make_boundaries(params, U0)


def port_advance(params, U0, n):
    from ramsesgpu_tpu_torch.solvers.step import make_advance_n

    U, t, k = make_advance_n(params, "cpu")(U0.clone(), torch.zeros((), dtype=U0.dtype), n)
    return U.numpy(), float(t), int(k)


def rel_l2(a, b, g=2):
    a, b = a[:, g:-g, g:-g, g:-g], b[:, g:-g, g:-g, g:-g]
    return float(np.linalg.norm((a - b).ravel()) / np.linalg.norm(b.ravel()))


def jax_reference(text, n_steps):
    """The JAX package's whole-array run of the INI text for n_steps:
    (U, t, k) as numpy / floats."""
    from ramsesgpu_tpu.config.configmap import ConfigMap as JConfigMap
    from ramsesgpu_tpu.config.params import params_from_config as j_params_from_config
    from ramsesgpu_tpu.problems import init_problem
    from ramsesgpu_tpu.solvers.boundary import make_boundaries
    from ramsesgpu_tpu.solvers.step import make_advance_n

    config = JConfigMap(text=text)
    params = j_params_from_config(config)
    with jax.disable_jit():
        U = make_boundaries(params, jnp.asarray(init_problem(params, config)))
        U, t, k = make_advance_n(params, config)(
            U, jnp.asarray(0.0, U.dtype), jnp.array(n_steps, jnp.int32))
    return np.asarray(U), float(t), int(k)


_JAX_SCRIPT = r"""
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import numpy as np
sys.path.insert(0, sys.argv[1])
import test_torch_hydro_ops as ops
import test_torch_hydro_step as m
out = {}
for p in m.PROBLEMS:
    for dtype in ("float32", "float64"):
        key = f"{p}_{dtype}"
        out[key + "_U"], out[key + "_t"], out[key + "_k"] = m.jax_reference(
            m.ini(p, dtype, kernel="jnp"), m.N_STEPS)
ops_result = {"ratios": {k: ops.worst_ratio(k, "float64") for k in ops.CASES},
              "exact": ops.exact_mismatches("float64")}
np.savez(sys.argv[2], ops=json.dumps(ops_result), **out)
"""


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    """{(problem, dtype): (U, t, k)} of the JAX package, and the float64
    op-case results, from one subprocess."""
    out = tmp_path_factory.mktemp("jax_ref") / "ref.npz"
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    # a quick, single-threaded backend: the suite's other workers share the cores
    flags = ("--xla_backend_optimization_level=0 --xla_cpu_multi_thread_eigen=false "
             "--xla_cpu_use_fusion_emitters=false")
    env["XLA_FLAGS"] = " ".join(f for f in (env.get("XLA_FLAGS"), flags) if f)
    res = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(REPO / "tests"), str(out)],
                         capture_output=True, text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    ref = np.load(out)
    refs = {(p, d): (ref[f"{p}_{d}_U"], float(ref[f"{p}_{d}_t"]), int(ref[f"{p}_{d}_k"]))
            for p in PROBLEMS for d in ("float32", "float64")}
    return refs, json.loads(str(ref["ops"]))


def check_slice(problem, dtype, jax_refs, kernel, tol_l2):
    U_ref, t_ref, k_ref = jax_refs[0][problem, dtype]
    params, U0 = setup(problem, dtype, kernel=kernel)
    assert params.kernel == kernel
    U, t, k = port_advance(params, U0, N_STEPS)
    assert k == k_ref == N_STEPS
    assert U.dtype == U_ref.dtype == np.dtype(dtype)
    assert np.isfinite(U).all()
    assert abs(t - t_ref) <= TOL_T[dtype] * abs(t_ref)
    assert rel_l2(U, U_ref) <= tol_l2[dtype]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("problem", list(PROBLEMS))
def test_slice_matches_jax(problem, dtype, jax_refs):
    check_slice(problem, dtype, jax_refs, "auto", TOL_L2)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_zcarry_slice_matches_jax(dtype, jax_refs):
    """kernel=zcarry on the periodic blast (the streamed step's loop: two
    buffers that take turns, the folded inverse dt, the copy back after an
    odd step count; its twins on the CPU) against the same JAX run, at the
    zcarry tests' tolerance (tests/test_torch_zcarry.py TOL_L2)."""
    check_slice("blast", dtype, jax_refs, "zcarry", TOL_ZCARRY)


@pytest.mark.parametrize("name", ["constoprim", "constoprim_ciso", "trace_minmod",
                                  "trace_moncen", "riemann_approx", "riemann_hll",
                                  "riemann_hllc", "godunov_step"])
def test_hydro_op_parity_f64(name, jax_refs):
    """tests/test_torch_hydro_ops.py's cases in float64."""
    assert jax_refs[1]["ratios"][name] <= 1.0


def test_fill_and_cfl_bitwise_f64(jax_refs):
    assert jax_refs[1]["exact"] == []


def test_chained_chunks_equal_unchained_and_fill_ghosts():
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries
    from ramsesgpu_tpu_torch.solvers.step import make_packed_advance_chain

    params, U0 = setup("implode", kernel="pallas")
    U_ref, t_ref, k_ref = port_advance(params, U0, N_STEPS)
    pack, advance, unpack = make_packed_advance_chain(params, "cpu")
    S, t = pack(U0.clone()), torch.zeros(())
    S, t, k1 = advance(S, t, 3)
    S, t, k2 = advance(S, t, 2)
    U = unpack(S, t)
    np.testing.assert_array_equal(U.numpy(), U_ref)
    assert torch.equal(U, make_boundaries(params, U))  # the ghosts are the fill of the interior
    assert float(t) == t_ref and int(k1) + int(k2) == k_ref


def test_stops_at_t_end():
    params, U0 = setup("blast", kernel="pallas")
    _, t3, _ = port_advance(params, U0, 3)
    _, t2, _ = port_advance(params, U0, 2)
    # t_end between the 2nd and 3rd step's end: the loop runs 3 steps
    params_end, _ = setup("blast", kernel="pallas", tend=0.5 * (t2 + t3))
    U, t, k = port_advance(params_end, U0, 10)
    U_ref, _, _ = port_advance(params, U0, 3)
    assert k == 3 and t == t3
    np.testing.assert_array_equal(U, U_ref)


@pytest.mark.parametrize("problem", list(PROBLEMS))
def test_step_fn_equals_the_loop(problem):
    """The ghosted step (the TPU kernel make_fused_hydro_update's path)
    gives the loop's first step, ghosts filled."""
    from ramsesgpu_tpu_torch.solvers.step import make_step_fn

    params, U0 = setup(problem)
    U, dt = make_step_fn(params, "cpu")(U0.clone(), torch.zeros(()))
    U_loop, t, k = port_advance(params, U0, 1)
    assert k == 1 and float(dt) == t
    np.testing.assert_array_equal(U.numpy(), U_loop)


# relative-L2 bound of the C++ host build of csrc/ against the twins
# after one step (ULP-level differences only)
TOL_HOST = {"float32": 1e-6, "float64": 1e-13}
# face types: reflecting x walls, absorbing y, periodic z; then all three
# kinds alone
HOST_BCS = [(1, 1, 2, 2, 3, 3), (1, 2, 2, 1, 3, 3), (1,) * 6, (2,) * 6, (3,) * 6]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_csrc_host_build_matches_twins(dtype):
    """Both modes of csrc/hydro_step.cu and csrc/cfl_hydro.cu, built with
    g++, against the twins on a random state: every Riemann solver, mixed
    and single-kind walls, the isothermal EOS; interior mode == ghosted
    mode bitwise; the CFL bitwise on both layouts."""
    from test_torch_hydro_ops import ini_text, random_state

    from ramsesgpu_tpu_torch.kernels.build import load_library, param_block
    from ramsesgpu_tpu_torch.kernels.packed_bc import bc_codes
    from ramsesgpu_tpu_torch.solvers.boundary import interior, make_boundaries
    from ramsesgpu_tpu_torch.solvers.godunov import hydro_3d_state_update
    from ramsesgpu_tpu_torch.solvers.timestep import compute_inv_dt_hydro, dt_from_inv

    lib = load_library("host")
    sfx = "f32" if dtype == "float32" else "f64"
    cfl, step = getattr(lib, f"ramses_cfl_hydro_{sfx}"), getattr(lib, f"ramses_hydro_step_{sfx}")
    rng = np.random.default_rng(11)
    cases = [(s, bcs, 0.0) for s in ("approx", "hll", "hllc") for bcs in HOST_BCS[:2]]
    cases += [("approx", bcs, 0.0) for bcs in HOST_BCS[2:]] + [("hllc", HOST_BCS[1], 0.7)]
    for solver, bcs, ciso in cases:
        params = params_from_config(ConfigMap(text=ini_text(dtype, solver=solver, bcs=bcs,
                                                            slope=2.0, ciso=ciso)))
        U = make_boundaries(params, torch.from_numpy(random_state(params, rng, dtype)))
        S = interior(params, U).contiguous()
        dims, blk = (params.nx, params.ny, params.nz), param_block(params)
        label = (solver, bcs, ciso)

        inv_ref = compute_inv_dt_hydro(params, S, ghost=0)
        for state, off in ((S, 0), (U, 2)):
            inv = torch.zeros((), dtype=S.dtype)
            assert cfl(state.data_ptr(), None, None, inv.data_ptr(), *dims, off, -math.inf, blk,
                       None) == 0
            assert torch.equal(inv, inv_ref), label

        dt = dt_from_inv(params, inv_ref)
        want = hydro_3d_state_update(params, S, dt)
        outs = {}
        blocks = lib.ramses_hydro_step_blocks(int(dtype == "float64"))
        for ghosted, src in ((0, S.clone()), (1, U)):
            out = torch.empty_like(S)
            for active in (False, True):
                flag = torch.tensor(active)
                assert step(src.data_ptr(), out.data_ptr(), blocks, dt.data_ptr(),
                            flag.data_ptr(), *dims, ghosted, bc_codes(params), blk, None,
                            None) == 0
                if not active and not ghosted:
                    assert torch.equal(out, S), label  # an inactive step changes nothing
            outs[ghosted] = out
            err = float(torch.linalg.norm((out - want).flatten()) / torch.linalg.norm(want.flatten()))
            assert err <= TOL_HOST[dtype], (label, ghosted, err)
        assert torch.equal(outs[0], outs[1]), label


# csrc/cfl_hydro.cu's rows: 37 cells (no multiple of a warp's 32 U cells)
# and 64 (on the unit x extent: dx a power of two), 15 rows (no multiple of
# a block's 8 warps)
@pytest.mark.parametrize("dims", [(37, 5, 3), (64, 3, 5)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_csrc_host_build_cfl_hydro_edges(dtype, dims):
    """csrc/cfl_hydro.cu built with g++ on short and partial rows, both
    layouts (interior-only and ghosted): bitwise the twin; the jet's floor
    taken in the kernel below and above the max; a NaN cell propagates
    past the floor."""
    from test_torch_hydro_ops import ini_text, random_state

    from ramsesgpu_tpu_torch.kernels.build import load_library, param_block
    from ramsesgpu_tpu_torch.solvers.boundary import interior
    from ramsesgpu_tpu_torch.solvers.timestep import compute_inv_dt_hydro

    lib = load_library("host")
    cfl = getattr(lib, f"ramses_cfl_hydro_{'f32' if dtype == 'float32' else 'f64'}")
    nx, ny, nz = dims
    text = ini_text(dtype, bcs=(3,) * 6).replace("nx=16\nny=16\nnz=16",
                                                 f"nx={nx}\nny={ny}\nnz={nz}")
    params = params_from_config(ConfigMap(text=text))
    assert (params.nx, params.ny, params.nz) == dims
    U = torch.from_numpy(random_state(params, np.random.default_rng(23), dtype))
    S = interior(params, U).contiguous()
    want = compute_inv_dt_hydro(params, S, ghost=0)
    g = params.ghost_width
    for floor in (-math.inf, 0.5 * float(want), 2.0 * float(want)):
        expect = torch.maximum(want, want.new_full((), floor))
        for state, off in ((S, 0), (U, g)):
            for nan in (False, True):
                A = state.clone()
                if nan:
                    A[3, off + nz - 1, off + ny - 1, off + nx - 1] = float("nan")
                inv = torch.zeros((), dtype=S.dtype)
                assert cfl(A.data_ptr(), None, None, inv.data_ptr(), nx, ny, nz, off, floor,
                           param_block(params), None) == 0
                if nan:
                    assert torch.isnan(inv), (floor, off)
                else:
                    assert torch.equal(inv, expect), (floor, off)


def test_convert_roundtrips_match_jax_layouts():
    from ramsesgpu_tpu.pallas.packed_bc import pack_bc_state
    from ramsesgpu_tpu.pallas.packed_io import pack_state
    from ramsesgpu_tpu.solvers.boundary import make_boundaries as j_fill

    from ramsesgpu_tpu_torch.convert import (
        bc_carry_from_jax, bc_carry_to_jax, packed_from_jax, packed_to_jax)

    rng = np.random.default_rng(5)
    for problem in PROBLEMS:
        params, _ = setup(problem)
        g = params.ghost_width
        U = rng.standard_normal(params.shape).astype(np.float32)
        inner = U[:, g:-g, g:-g, g:-g]
        if problem == "blast":  # fully periodic: the x-ghost-free packed layout
            P = np.asarray(pack_state(params, jnp.asarray(inner)))
            S = packed_from_jax(params, P, "cpu")
            np.testing.assert_array_equal(packed_to_jax(params, S), P)
        else:  # walls: the padded carry, ghosts as make_boundaries fills them
            P = np.asarray(pack_bc_state(params, j_fill(params, jnp.asarray(U))))
            S = bc_carry_from_jax(params, P, "cpu")
            np.testing.assert_array_equal(bc_carry_to_jax(params, S), P)
        np.testing.assert_array_equal(S.numpy(), inner)


def test_cli_runs_implode_on_cpu_and_writes_vti(tmp_path, capsys):
    from ramsesgpu_tpu_torch.cli.main import main
    from ramsesgpu_tpu_torch.io.vtk import read_vti

    path = tmp_path / "implode3d.ini"
    path.write_text(ini(outdir=tmp_path))
    assert main(["--param", str(path), "--device", "cpu", "--max-steps", "3"]) == 0
    out = capsys.readouterr().out
    assert "number of time steps   : 3" in out and "problem        : implode" in out
    fields, _extent = read_vti(tmp_path / "implode3d_0000003.vti")
    assert set(fields) == {"density", "energy", "mx", "my", "mz"}
    for a in fields.values():
        assert a.shape == (16, 16, 16) and np.isfinite(a).all()
    assert fields["density"].min() > 0


@pytest.mark.parametrize(
    "section, key, value, kernels_cover_it",
    [
        # in the slice since the step kernel's gravity instance
        # (tests/test_torch_gravity.py)
        ("gravity", "static_field_z", "-0.1", True),
        ("hydro", "nu", "0.01", False),
        ("hydro", "problem", "jet", True),  # in the slice since the ghosted jet loop
        ("hydro", "problem", "Rayleigh-Taylor", True),  # ported with its gravity
        ("mesh", "nz", "1", False),  # 2D: no kernel, the whole-array step (test_torch_2d.py)
        ("mesh", "boundary_xmin", "5", False),
        ("implementation", "kernel", "zcarry", True),  # in the slice since the zcarry kernels
        ("implementation", "compensated", "yes", False),
    ],
)
def test_out_of_slice_configurations_raise(section, key, value, kernels_cover_it):
    from ramsesgpu_tpu_torch.kernels.hydro_step import require_hydro_scope
    from ramsesgpu_tpu_torch.solvers.run import Run
    from ramsesgpu_tpu_torch.solvers.step import require_slice

    text = ini() + f"\n[{section}]\n{key}={value}\n"
    config = ConfigMap(text=text)
    if value in ("zcarry", "jet", "Rayleigh-Taylor") or key in ("nz", "static_field_z", "nu"):
        # the z-streaming kernels (tests/test_torch_zcarry.py): a walled run
        # keeps the step kernel's wall rules under kernel=zcarry, and Run
        # takes it; the jet runs its ghosted loop (tests/test_torch_walls.py);
        # nz = 1 is a 2D run, in the slice since the 2D path; static gravity
        # and the Rayleigh-Taylor problem run the gravity instance; nu runs
        # the ghosted loop with the whole-array viscous sub-step after the
        # step kernel (tests/test_torch_sharded_dissip_forced.py)
        Run(config, "cpu").start(max_steps=1, do_output=False)
    else:
        with pytest.raises(NotImplementedError):
            Run(config, "cpu")
    require_slice(params_from_config(ConfigMap(text=ini())), "cpu")
    params = params_from_config(config).replace(kernel="auto")
    if key == "nz":
        # no kernel covers 2D, and none is asked for: require_slice admits
        # it, the hydro kernels' scope does not
        require_slice(params, "cpu")
        with pytest.raises(NotImplementedError):
            require_hydro_scope(params)
    elif key == "nu":
        # no kernel covers the viscous sub-step (the JAX package has none):
        # the step kernel takes the inviscid step and require_slice admits it
        require_slice(params, "cpu")
        require_hydro_scope(params)
    elif kernels_cover_it:
        require_slice(params, "cpu")
    else:
        with pytest.raises(NotImplementedError):
            require_slice(params, "cpu")
