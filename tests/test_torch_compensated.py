"""The port's Kahan-compensated state ([implementation] compensated) against
the JAX package on the CPU.

- Per function, inputs made with numpy from a seed: ``mhd_apply_update``
  with a carry, with the vertical gravity source and with both,
  ``mhd_dissipation_interior_update`` with a carry (adiabatic and
  isothermal, nu and eta > 0), and the shearing box's border update
  (``shear_border_update``: the remap's Kahan adds on the border columns,
  the carry reset where the density floor fires, the kept Bx face and its
  carry; with ``kept_face_resistive_ct``, the kept face's resistive CT)
  against the JAX packed step's glue (pallas/shear_packed.py:1108-1203,
  its kernels replaced by stubs that return the same inputs). f32 (rtol
  1e-5, atol 1e-6 of each output's largest magnitude, as
  tests/test_torch_dissip.py) and f64 (rtol 1e-12), both from the JAX
  subprocess (f32 there is bitwise f32 in a process without x64); each carry also on its own, per channel within ``CARRY_TOL`` of
  its own largest magnitude, which a zero or sign-flipped carry misses by
  1 or 2 (a planted zero input carry is shown to fail).
- The loop: from a zero carry, one compensated step equals the plain step
  within tests/test_compensated.py:110-119's 5e-7 atol; 3 compensated loop
  steps of Orszag-Tang at 16^3, ideal and dissipative, against a JAX
  reference built from ``mhd_3d_interior_update(..., comp=)`` (and
  ``mhd_dissipation_interior_update(..., comp=)``) with the whole-array
  backend, at test_slice_matches_jax's tolerances (t rtol 1e-6, state
  relative L2 2e-6); the compensated value u - c within half the carry's
  own relative size (a zero carry misses it). The carry itself is not held
  after whole steps: it is the rounding error of each increment, and the
  increments differ from the JAX package's in their last bits (XLA's CPU
  rsqrt rounds differently from torch's), so the carries differ by O(1)
  of themselves. The compensated MRI (data/mhd_mri_3d.ini as shipped,
  16x32x16) through the port's loop, its carry kept across 2 steps, stays
  within tests/test_compensated.py:160-195's envelope (2e-6, 1e-5 atol) of
  the JAX whole-array run. The references are the JAX package's
  whole-array functions, all in one subprocess (its packed kernel in
  interpret mode costs more than this file's budget). They run as they
  run by default, with their own jits: the same arrays bitwise as op by
  op under ``jax.disable_jit()``, at less compile time.
- The g++ host build of the compensated kernel modes against the twins:
  the update stage on its own fluxes, the border kernel and the
  dissipative sub-step bitwise.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ramsesgpu_tpu_torch.config.configmap import ConfigMap
from ramsesgpu_tpu_torch.config.params import params_from_config

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
N_STEPS = 3
TOL_T = 1e-6
TOL_L2 = 2e-6

OT_INI = """
[run]
tend=1000.0
[mesh]
nx=16
ny=16
nz=16
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
nu={nu}
[MHD]
enable=true
magRiemannSolver=hlld
eta={eta}
[implementation]
dtype={dtype}
compensated={comp}
"""
# (nu, eta) of the loop runs: ideal and tests/test_pallas_dissip.py:46's
OT_CASES = {"ideal": (0.0, 0.0), "dissipative": (2e-3, 1e-3)}


def ot_text(case="ideal", dtype="float32", comp="yes") -> str:
    nu, eta = OT_CASES[case]
    return OT_INI.format(nu=nu, eta=eta, dtype=dtype, comp=comp)


def mri_text(dtype="float32") -> str:
    """data/mhd_mri_3d.ini as shipped (16x32x16, compensated)."""
    text = (REPO / "data" / "mhd_mri_3d.ini").read_text()
    assert "compensated=yes" in text and "nx=16\nny=32\nnz=16" in text
    return text.replace("[implementation]\n", f"[implementation]\ndtype={dtype}\n", 1)


def mri_t0(params) -> float:
    """A time whose sheared-fill offset deltay/dy is 2.5 cells."""
    return 2.5 * params.dy / (1.5 * params.omega0 * params.dx * params.nx)


def random_state(params, rng, dtype, shape=None):
    """A conserved state, rho and p > 0, B of order one."""
    shape = params.shape[1:] if shape is None else shape
    rho = rng.uniform(0.5, 1.5, shape)
    vel = 0.5 * rng.standard_normal((3,) + shape)
    bf = 0.5 * rng.standard_normal((3,) + shape)
    e = rng.uniform(0.5, 1.5, shape) / (params.gamma0 - 1.0) + 0.5 * rho * (vel ** 2).sum(0) \
        + 0.5 * (bf ** 2).sum(0)
    return np.stack([rho, e, *(rho * vel), *bf]).astype(dtype)


# -------------------------------------------------------------------------
# per-function inputs (numpy) and outputs (either package)
# -------------------------------------------------------------------------
APPLY_CASES = ["comp", "gravity", "comp+gravity"]


def apply_inputs(dtype):
    """The update's inputs on an x- and z-ghosted, y-periodic frame [.., nz +
    2g, ny, nx + 2g] of the 16^3 mesh: a state, its carry, five-channel
    face fluxes, edge EMFs, g_z per row and dt."""
    params = params_from_config(ConfigMap(text=ot_text("ideal", dtype)))
    g = params.ghost_width
    rng = np.random.default_rng(31)
    frame = (params.nz + 2 * g, params.ny, params.nx + 2 * g)
    U = random_state(params, rng, dtype, frame)
    C = (np.finfo(dtype).eps * U * rng.standard_normal(U.shape)).astype(dtype)
    fluxes = [rng.standard_normal((5,) + frame).astype(dtype) for _ in range(3)]
    emfs = [rng.standard_normal(frame).astype(dtype) for _ in range(3)]
    gz = (-1e-2 * np.linspace(-1, 1, frame[0])).astype(dtype)
    return params, U, C, fluxes, emfs, gz, np.asarray(0.01, dtype)


def jax_apply(case, dtype):
    from ramsesgpu_tpu.config.params import params_from_config as j_params
    from ramsesgpu_tpu.solvers.godunov_mhd import mhd_apply_update
    from ramsesgpu_tpu.config.configmap import ConfigMap as JConfigMap

    params, U, C, fluxes, emfs, gz, dt = apply_inputs(dtype)
    jp = j_params(JConfigMap(text=ot_text("ideal", dtype)))
    g = params.ghost_width
    gravity = None
    if "gravity" in case:
        gravity = (None, None, jnp.broadcast_to(jnp.asarray(gz)[:, None, None], U.shape[1:]))
    out = mhd_apply_update(
        jp, jnp.asarray(U), tuple(map(jnp.asarray, fluxes)), tuple(map(jnp.asarray, emfs)),
        jnp.asarray(dt), margin=(g, 0, g), comp=jnp.asarray(C) if "comp" in case else None,
        gravity=gravity)
    return np.asarray(out)


def port_apply(case, dtype):
    from ramsesgpu_tpu_torch.solvers.godunov_mhd import mhd_apply_update

    params, U, C, fluxes, emfs, gz, dt = apply_inputs(dtype)
    g, nz, nx = params.ghost_width, params.nz, params.nx
    interior = (slice(None), slice(g, g + nz), slice(None), slice(g, g + nx))
    out = mhd_apply_update(
        params, torch.from_numpy(U[interior]), tuple(map(torch.from_numpy, fluxes)),
        tuple(map(torch.from_numpy, emfs)), torch.from_numpy(dt), x0=g, z0=g,
        comp=torch.from_numpy(C[interior]) if "comp" in case else None,
        gz=torch.from_numpy(gz).view(-1, 1, 1) if "gravity" in case else None)
    return out.numpy()


def dissip_inputs(ciso, dtype):
    """The 16^3 mesh with the dissipative coefficients and cIso: params, a
    ghosted state, a carry in its layout and dt."""
    params = params_from_config(ConfigMap(text=ot_text("dissipative", dtype))).replace(
        c_iso=ciso)
    rng = np.random.default_rng(37)
    U = random_state(params, rng, dtype)
    C = (np.finfo(dtype).eps * U * rng.standard_normal(U.shape)).astype(dtype)
    return params, U, C, np.asarray(0.01, dtype)


def jax_dissip(ciso, dtype):
    from ramsesgpu_tpu.config.configmap import ConfigMap as JConfigMap
    from ramsesgpu_tpu.config.params import params_from_config as j_params
    from ramsesgpu_tpu.solvers.dissipation import mhd_dissipation_interior_update

    _params, U, C, dt = dissip_inputs(ciso, dtype)
    jp = j_params(JConfigMap(text=ot_text("dissipative", dtype))).replace(c_iso=ciso)
    out = mhd_dissipation_interior_update(jp, jnp.asarray(U), jnp.asarray(dt), shear_planes=True,
                                          comp=jnp.asarray(C))
    return [np.asarray(a) for a in out]


def port_dissip(ciso, dtype):
    from ramsesgpu_tpu_torch.solvers.dissipation import mhd_dissipation_interior_update

    params, U, C, dt = dissip_inputs(ciso, dtype)
    out = mhd_dissipation_interior_update(params, torch.from_numpy(U), torch.from_numpy(dt),
                                          shear_planes=True, comp=torch.from_numpy(C))
    return [a.numpy() for a in out]


BORDER_CASES = ["ideal", "resistive"]
# a density floor that fires on part of the border columns
BORDER_SMALLR = 0.5


def border_inputs(case, dtype):
    """The shearing box's border update inputs at 16x32x16: params (the
    shipped MRI ini, eta > 0 for "resistive", smallr 0.5), the step's
    output S [16, nz, ny, nx] with a carry, the kept face and its carry
    [2, nz, ny], the five x-face planes, the CFL's 1/dt, t and the
    resistive emfY, emfZ planes at the xmax face."""
    text = mri_text(dtype)
    if case == "resistive":
        text = text.replace("[MHD]\n", "[MHD]\neta=1e-3\n", 1)
    params = params_from_config(ConfigMap(text=text)).replace(smallr=BORDER_SMALLR)
    rng = np.random.default_rng(53)
    eps = np.finfo(dtype).eps
    S = random_state(params, rng, dtype, (params.nz, params.ny, params.nx))
    S = np.concatenate([S, eps * S * rng.standard_normal(S.shape)]).astype(dtype)
    face = 0.5 * rng.standard_normal((params.nz, params.ny))
    kept = np.stack([face, eps * face * rng.standard_normal(face.shape)]).astype(dtype)
    planes = rng.standard_normal((5, params.nz, params.ny)).astype(dtype)
    resistive = rng.standard_normal((2, params.nz, params.ny)).astype(dtype)
    inv = np.asarray(params.cfl / 0.02, dtype)
    return params, S, kept, planes, inv, np.asarray(mri_t0(params), dtype), resistive, text


def jax_border(case, dtype):
    """The JAX packed MRI step's glue on the border inputs: its main,
    strip, CFL and dissipative kernels are stubs that return the inputs
    (the step's output, its border columns and planes; the resistive
    planes), the strip's ghost slabs zeros, so what runs is the remap and the deltas, Kahan adds, floor
    and kept-face updates of pallas/shear_packed.py:1108-1203. Returns
    (S_new, kept_new, dt)."""
    import ramsesgpu_tpu.pallas.shear_packed as sp
    from ramsesgpu_tpu.config.configmap import ConfigMap as JConfigMap
    from ramsesgpu_tpu.config.params import params_from_config as j_params

    params, S, kept, planes, inv, t, resistive, text = border_inputs(case, dtype)
    jp = j_params(JConfigMap(text=text)).replace(smallr=BORDER_SMALLR, strip_fused=False)
    g, nz, ny, nx, yb = params.ghost_width, params.nz, params.ny, params.nx, sp.YB
    gy, wy = sp._strip_geometry(jp)
    yi = slice(gy, gy + ny)
    P_main = np.pad(S, ((0, 0), (g, g), (yb, yb), (0, 0)), mode="wrap")

    def strip_out(plane_rows):
        # the strip kernel's layout: right columns at x rows g..2g, left at
        # 4g..5g (transposed to [.., z, x, y]), then the planes at 5g + k
        out = np.zeros((17, nz, 5 * g + 5, wy), dtype)
        out[:16, :, g:2 * g, yi] = np.swapaxes(S[..., nx - g:], -1, -2)
        out[:16, :, 4 * g:5 * g, yi] = np.swapaxes(S[..., :g], -1, -2)
        out[16, :, 5 * g:5 * g + len(plane_rows), yi] = np.swapaxes(plane_rows, 0, 1)
        return jnp.asarray(out)

    slab = jnp.zeros((8, nz, ny, g), dtype)  # the strip's sheared ghosts, unread by the stub
    stubs = {
        "_shear_slabs_from_interior": lambda *a: (slab, slab),
        "_make_main_kernel": lambda *a, **k: (lambda P, dt: jnp.asarray(P_main)),
        "_make_strip_kernel": lambda *a, mode="godunov", **k: (
            lambda St, dt: strip_out(planes if mode == "godunov" else resistive)),
        "make_shear_cfl_kernel": lambda *a, **k: (lambda P, kept_face: jnp.asarray(inv)),
        "make_packed_io_step": lambda *a, **k: (lambda P, dt: P),
    }
    saved = {name: getattr(sp, name) for name in stubs}
    try:
        for name, stub in stubs.items():
            setattr(sp, name, stub)
        step = sp.make_shear_packed_step(jp, tiles=(4, 8))
        P, kept_new, dt = step(jnp.asarray(P_main), jnp.asarray(kept), jnp.asarray(t))
    finally:
        for name, fn in saved.items():
            setattr(sp, name, fn)
    return np.asarray(P)[:, g:g + nz, yb:yb + ny, :], np.asarray(kept_new), np.asarray(dt)


def port_border(case, dtype):
    from ramsesgpu_tpu_torch.solvers.dissipation import kept_face_resistive_ct
    from ramsesgpu_tpu_torch.solvers.godunov_mhd import shear_border_update
    from ramsesgpu_tpu_torch.solvers.timestep import dt_from_inv

    params, S, kept, planes, inv, t, resistive, _text = border_inputs(case, dtype)
    dt = dt_from_inv(params, torch.from_numpy(inv))
    S_new, kept_new, _ = shear_border_update(params, torch.from_numpy(S), torch.from_numpy(kept),
                                             torch.from_numpy(planes), torch.from_numpy(t), dt)
    if case == "resistive":
        kept_new = kept_face_resistive_ct(params, kept_new, *map(torch.from_numpy, resistive), dt)
    return S_new.numpy(), kept_new.numpy(), dt.numpy()


# -------------------------------------------------------------------------
# the JAX references of the loop runs
# -------------------------------------------------------------------------
def jax_ot_run(case, n_steps=N_STEPS):
    """3 compensated steps of the JAX whole-array functions: the CFL on the
    ghosted state, ``mhd_3d_interior_update(comp=)``, the periodic fill,
    and with nu, eta the sub-step ``mhd_dissipation_interior_update(comp=)``
    (the JAX packed loop's two launches, pallas/fused_mhd3d.py:247-259,
    360-378). Returns (state, carry) interiors and t."""
    from ramsesgpu_tpu.config.configmap import ConfigMap as JConfigMap
    from ramsesgpu_tpu.config.params import params_from_config as j_params
    from ramsesgpu_tpu.problems import init_problem
    from ramsesgpu_tpu.solvers.boundary import make_boundaries
    from ramsesgpu_tpu.solvers.dissipation import mhd_dissipation_interior_update
    from ramsesgpu_tpu.solvers.godunov_mhd import mhd_3d_interior_update
    from ramsesgpu_tpu.solvers.timestep import compute_dt

    config = JConfigMap(text=ot_text(case))
    params = j_params(config)
    g = params.ghost_width
    inner = (slice(None), slice(g, -g), slice(g, -g), slice(g, -g))
    U = make_boundaries(params, jnp.asarray(init_problem(params, config), params.dtype))
    C = jnp.zeros_like(U)
    t = 0.0
    for _ in range(n_steps):
        dt = compute_dt(params, U)
        out = mhd_3d_interior_update(params, U, dt, comp=C)
        U = make_boundaries(params, U.at[inner].set(out[:8]))
        C = C.at[inner].set(out[8:])
        if params.nu > 0 or params.eta > 0:
            out = mhd_dissipation_interior_update(params, U, dt, comp=C)
            U = make_boundaries(params, U.at[inner].set(out[:8]))
            C = C.at[inner].set(out[8:])
        t = t + float(dt)
    return np.asarray(U[inner]), np.asarray(C[inner]), t


def jax_mri_run(n_steps=2):
    """The JAX whole-array MRI run (uncompensated: the whole-array path has
    no carry) from t0: the interiors and kept faces after each step. In one
    z window: the ini's zSlabNb=4 windows are bitwise the monolithic update
    (solvers/zslab.py) at four times the work."""
    from ramsesgpu_tpu.config.configmap import ConfigMap as JConfigMap
    from ramsesgpu_tpu.config.params import params_from_config as j_params
    from ramsesgpu_tpu.problems import init_problem
    from ramsesgpu_tpu.solvers.boundary import make_boundaries
    from ramsesgpu_tpu.solvers.shear import make_all_boundaries_shear
    from ramsesgpu_tpu.solvers.step import make_step_fn

    config = JConfigMap(text=mri_text())
    params = j_params(config)
    out = {}
    U = make_boundaries(params, jnp.asarray(init_problem(params, config), params.dtype))
    t = jnp.asarray(mri_t0(params), U.dtype)
    U = make_all_boundaries_shear(params, U, t)
    out["U0"] = np.asarray(U)
    step = make_step_fn(params.replace(kernel="jnp", compensated=False, z_slab_nb=0),
                        config)
    for n in range(n_steps):
        U, dt = step(U, t)
        t = t + dt
        out[f"U{n + 1}"], out[f"t{n + 1}"] = np.asarray(U), float(t)
    return out


_JAX_SCRIPT = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import numpy as np
sys.path.insert(0, sys.argv[1])
import test_torch_compensated as m
out = {}
for case in m.OT_CASES:
    out[f"ot_{case}_U"], out[f"ot_{case}_C"], out[f"ot_{case}_t"] = m.jax_ot_run(case)
for key, value in m.jax_mri_run().items():
    out[f"mri_{key}"] = value
for dtype in ("float32", "float64"):
    for case in m.APPLY_CASES:
        out[f"apply_{case}_{dtype}"] = m.jax_apply(case, dtype)
    for ciso in (0.0, 1.0):
        for j, a in enumerate(m.jax_dissip(ciso, dtype)):
            out[f"dissip_{ciso}_{dtype}_{j}"] = a
    for case in m.BORDER_CASES:
        for j, a in enumerate(m.jax_border(case, dtype)):
            out[f"border_{case}_{dtype}_{j}"] = a
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module", autouse=True)
def jax_refs(tmp_path_factory):
    """Every JAX reference of this file in one subprocess (with
    jax_enable_x64), started at the module's first test so the tests that
    need none run meanwhile; ``jax_refs()`` waits for it."""
    out = tmp_path_factory.mktemp("jax_comp") / "refs.npz"
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    flags = ("--xla_backend_optimization_level=0 --xla_cpu_multi_thread_eigen=false "
             "--xla_cpu_use_fusion_emitters=false")
    env["XLA_FLAGS"] = " ".join(f for f in (env.get("XLA_FLAGS"), flags) if f)
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_SCRIPT, str(REPO / "tests"), str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    refs: dict = {}

    def get() -> dict:
        if not refs:
            _stdout, stderr = proc.communicate(timeout=600)
            assert proc.returncode == 0, stderr[-4000:]
            refs.update(np.load(out))
        return refs

    yield get
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


RTOL, ATOL_SCALE = 1e-5, 1e-6


def assert_close(got, want, label, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, label
    atol = ATOL_SCALE * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=label)


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm((a - b).ravel()) / np.linalg.norm(b.ravel()))


# a carry on its own: per channel, max |got - want| over the channel's own
# largest magnitude (a zero carry is off by 1, a sign-flipped one by 2)
CARRY_TOL = {"float32": 1e-5, "float64": 1e-6}


def carry_err(got, want) -> float:
    """The worst channel's error of a carry [n, ...] against the reference,
    relative to that channel's largest magnitude; a channel whose reference
    is all zero must be zero."""
    got = np.asarray(got, np.float64).reshape(len(want), -1)
    want = np.asarray(want, np.float64).reshape(len(want), -1)
    err = np.abs(got - want).max(axis=1)
    scale = np.abs(want).max(axis=1)
    return float(max(e / s if s > 0 else (np.inf if e > 0 else 0.0) for e, s in zip(err, scale)))


def assert_carry_close(got, want, label, dtype):
    assert np.abs(want).max() > 0, f"{label}: the reference carry is zero"
    err = carry_err(got, want)
    assert err <= CARRY_TOL[dtype], f"{label}: carry error {err:.3e} of its own size"


# -------------------------------------------------------------------------
# per function
# -------------------------------------------------------------------------
FN_RTOL = {"float32": RTOL, "float64": 1e-12}


def check_apply(case, dtype, refs):
    want = refs[f"apply_{case}_{dtype}"]
    got = port_apply(case, dtype)
    assert got.shape[0] == (16 if "comp" in case else 8)
    assert_close(got, want, case, rtol=FN_RTOL[dtype])
    if "comp" in case:
        assert_carry_close(got[8:], want[8:], case, dtype)


@pytest.mark.parametrize("case", APPLY_CASES)
def test_apply_update_f32_matches_jax(case, jax_refs):
    check_apply(case, "float32", jax_refs())


@pytest.mark.parametrize("case", APPLY_CASES)
def test_apply_update_f64_matches_jax(case, jax_refs):
    check_apply(case, "float64", jax_refs())


def test_planted_zero_carry_fails_the_carry_check(monkeypatch, jax_refs):
    """The carry check catches an update that drops its input carry: the
    port's ``mhd_apply_update`` with the carry zeroed on the way in misses
    the JAX carry by far more than CARRY_TOL."""
    from ramsesgpu_tpu_torch.solvers import godunov_mhd

    want = jax_refs()["apply_comp+gravity_float32"]
    update = godunov_mhd.mhd_apply_update
    monkeypatch.setattr(godunov_mhd, "mhd_apply_update", lambda *a, comp=None, **k: update(
        *a, comp=torch.zeros_like(comp), **k))
    got = port_apply("comp+gravity", "float32")
    assert carry_err(got[8:], want[8:]) > 1e3 * CARRY_TOL["float32"]


def check_dissip(ciso, dtype, refs):
    got = port_dissip(ciso, dtype)
    assert got[0].shape[0] == 16
    for j, a in enumerate(got):
        assert_close(a, refs[f"dissip_{ciso}_{dtype}_{j}"], f"cIso={ciso} output {j}",
                     rtol=FN_RTOL[dtype])
    assert_carry_close(got[0][8:], refs[f"dissip_{ciso}_{dtype}_0"][8:], f"cIso={ciso}", dtype)


@pytest.mark.parametrize("ciso", [0.0, 1.0])
def test_dissipation_interior_update_f32_matches_jax(ciso, jax_refs):
    check_dissip(ciso, "float32", jax_refs())


@pytest.mark.parametrize("ciso", [0.0, 1.0])
def test_dissipation_interior_update_f64_matches_jax(ciso, jax_refs):
    check_dissip(ciso, "float64", jax_refs())


def check_border(case, got, want, dtype):
    """The border update's state and kept face, and each carry on its own;
    the floor must have fired (and reset carries) on part of the border."""
    (S, kept, dt), (S_ref, kept_ref, dt_ref) = got, want
    assert float(dt) == float(dt_ref)
    assert_close(kept[0], kept_ref[0], f"{case} kept face", rtol=FN_RTOL[dtype])
    assert_carry_close(kept[1:], kept_ref[1:], f"{case} kept carry", dtype)
    if case == "resistive":  # the JAX glue's dissipative phase has its own columns
        return
    assert_close(S[:8], S_ref[:8], f"{case} state", rtol=FN_RTOL[dtype])
    assert_carry_close(S[8:], S_ref[8:], f"{case} carry", dtype)
    floored = S_ref[0][..., [0, -1]] == BORDER_SMALLR
    assert 0 < floored.mean() < 1
    assert (S_ref[8][..., [0, -1]][floored] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", BORDER_CASES)
def test_shear_border_matches_jax_glue(case, dtype, jax_refs):
    refs = jax_refs()
    want = tuple(refs[f"border_{case}_{dtype}_{j}"] for j in range(3))
    check_border(case, port_border(case, dtype), want, dtype)


# -------------------------------------------------------------------------
# the loops
# -------------------------------------------------------------------------
def ghosted_ot(text):
    from ramsesgpu_tpu_torch.problems import init_problem
    from ramsesgpu_tpu_torch.solvers.boundary import make_boundaries

    config = ConfigMap(text=text)
    params = params_from_config(config)
    return params, config, make_boundaries(params, torch.from_numpy(init_problem(params, config)))


def test_compensated_first_step_matches_plain():
    """From a zero carry, one compensated step of the loop equals the plain
    step within tests/test_compensated.py's 5e-7 atol (y = d - 0 is exact;
    only the update's roundings differ) and at the same t."""
    from ramsesgpu_tpu_torch.solvers.step import make_advance_n

    runs = {}
    for comp in ("yes", "no"):
        params, config, U0 = ghosted_ot(ot_text("ideal", comp=comp))
        U, t, k = make_advance_n(params, "cpu", config)(U0, torch.zeros(()), 1)
        runs[comp] = (U.numpy(), float(t), int(k))
    assert runs["yes"][1:] == runs["no"][1:] == (runs["no"][1], 1)
    np.testing.assert_allclose(runs["yes"][0], runs["no"][0], rtol=0, atol=5e-7)


@pytest.mark.parametrize("case", list(OT_CASES))
def test_compensated_ot_matches_jax(case, jax_refs):
    """3 compensated loop steps of Orszag-Tang at 16^3 against the JAX
    whole-array functions with the carry: t, the state and the compensated
    value u - c."""
    from ramsesgpu_tpu_torch.solvers.step import make_packed_advance_chain

    params, config, U0 = ghosted_ot(ot_text(case))
    pack, advance, unpack = make_packed_advance_chain(params, "cpu", config)
    S, t, k = advance(pack(U0), torch.zeros(()), N_STEPS)
    assert S.shape[0] == 16 and int(k) == N_STEPS
    refs = jax_refs()
    U_ref, C_ref = refs[f"ot_{case}_U"], refs[f"ot_{case}_C"]
    np.testing.assert_allclose(float(t), float(refs[f"ot_{case}_t"]), rtol=TOL_T)
    assert rel_l2(S[:8].numpy(), U_ref) <= TOL_L2
    # the compensated value u - c: within half the carry's own relative
    # size (2.4e-8 here), which the value with a zero carry, u, misses
    ref_value = U_ref.astype(np.float64) - C_ref
    carry_size = np.linalg.norm(C_ref.astype(np.float64)) / np.linalg.norm(U_ref.astype(np.float64))
    comp_value = S[:8].double() - S[8:].double()
    assert rel_l2(comp_value.numpy(), ref_value) <= min(TOL_L2, 0.5 * carry_size)
    assert rel_l2(S[:8].numpy(), ref_value) > 0.5 * carry_size
    g = params.ghost_width
    assert torch.equal(unpack(S, t)[:, g:-g, g:-g, g:-g], S[:8])


def test_compensated_mri_matches_whole_array(jax_refs):
    """data/mhd_mri_3d.ini as shipped (compensated) through the port's
    loop, the carries kept from step to step: within
    tests/test_compensated.py:160-195's envelope of the JAX whole-array run
    (2e-6, then 1e-5 atol), with its t (rtol 1e-5)."""
    from ramsesgpu_tpu_torch.core.constants import IA
    from ramsesgpu_tpu_torch.solvers.step import make_packed_advance_chain

    config = ConfigMap(text=mri_text())
    params = params_from_config(config)
    assert params.compensated
    refs = jax_refs()
    pack, advance, unpack = make_packed_advance_chain(params, "cpu", config)
    state = pack(torch.from_numpy(refs["mri_U0"]))
    assert state[0].shape[0] == 16 and state[1].shape[0] == 2
    t = torch.tensor(mri_t0(params), dtype=torch.float32)
    g, nx = params.ghost_width, params.nx
    for n, atol in enumerate((2e-6, 1e-5)):
        state, t, k = advance(state, t, 1)
        assert int(k) == 1
        U = unpack(state, t)
        np.testing.assert_allclose(float(t), float(refs[f"mri_t{n + 1}"]), rtol=1e-5)
        want = refs[f"mri_U{n + 1}"]
        np.testing.assert_allclose(U.numpy()[:, g:-g, g:-g, g:-g], want[:, g:-g, g:-g, g:-g],
                                   rtol=0, atol=atol)
        np.testing.assert_allclose(U.numpy()[IA, g:-g, g:-g, nx + g],
                                   want[IA, g:-g, g:-g, nx + g], rtol=0, atol=atol)


# -------------------------------------------------------------------------
# the CUDA sources' arithmetic (g++ host build)
# -------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_csrc_host_build_matches_compensated_twins(dtype):
    """csrc/mhd_step.cu's compensated update stage, run on its own fluxes
    (left in the stage buffer), csrc/shear_border.cu's compensated border
    kernel and csrc/dissip_step.cu's compensated sub-step, built with g++,
    against the twins from non-zero carries: bitwise (the compensated code
    is FMA-free); the whole periodic and shear steps within 1e-6 / 1e-13."""
    from ramsesgpu_tpu_torch.kernels.build import load_library, param_block
    from ramsesgpu_tpu_torch.kernels.mhd_step import scratch_fluxes
    from ramsesgpu_tpu_torch.kernels.shear import pack
    from ramsesgpu_tpu_torch.problems import init_problem
    from ramsesgpu_tpu_torch.solvers import godunov_mhd as gm
    from ramsesgpu_tpu_torch.solvers.boundary import interior, make_boundaries
    from ramsesgpu_tpu_torch.solvers.dissipation import mhd_dissipation_periodic_update
    from ramsesgpu_tpu_torch.solvers.shear import shear_slabs
    from ramsesgpu_tpu_torch.solvers.timestep import (dt_from_inv, inv_dt_mhd_periodic,
                                                      inv_dt_mhd_shear)

    lib = load_library("host")
    sfx = "f32" if dtype == "float32" else "f64"
    tdt = torch.float32 if dtype == "float32" else torch.float64
    tol = 1e-6 if dtype == "float32" else 1e-13
    eps = torch.finfo(tdt).eps
    gen = torch.Generator().manual_seed(41)
    active = torch.tensor(True)

    def rel(a, b):
        return float(torch.linalg.norm((a - b).double().flatten())
                     / torch.linalg.norm(b.double().flatten()))

    # periodic Orszag-Tang with the dissipative coefficients
    params, config, U = ghosted_ot(ot_text("dissipative", dtype))
    U = U.to(tdt)
    S8 = interior(params, U)
    S = torch.cat([S8, eps * S8 * torch.randn(S8.shape, generator=gen, dtype=tdt)]).contiguous()
    dt = dt_from_inv(params, inv_dt_mhd_periodic(params, S8))
    dims, blk = (params.nx, params.ny, params.nz), param_block(params)
    scratch = torch.empty(lib.ramses_mhd_step_scratch_per_cell() * S8[0].numel(), dtype=tdt)
    S1 = S.clone()
    assert getattr(lib, f"ramses_mhd_step_{sfx}")(
        S1.data_ptr(), scratch.data_ptr(), dt.data_ptr(), active.data_ptr(), 1, *dims, blk,
        None) == 0
    fluxes, emfs, x0, z0 = scratch_fluxes(params, scratch)
    assert torch.equal(S1, gm.mhd_apply_update(params, S[:8], fluxes, emfs, dt, x0, z0,
                                               comp=S[8:]))
    assert rel(S1[:8], gm.mhd_3d_periodic_update(params, S, dt)[:8]) <= tol
    S2 = torch.empty_like(S1)
    assert getattr(lib, f"ramses_dissip_step_{sfx}")(
        S1.data_ptr(), S2.data_ptr(), None, None, dt.data_ptr(), active.data_ptr(), 1,
        *dims, blk, None) == 0
    assert torch.equal(S2, mhd_dissipation_periodic_update(params, S1, dt))

    # the MRI shearing box as shipped
    config = ConfigMap(text=mri_text(dtype))
    params = params_from_config(config)
    U = make_boundaries(params, torch.from_numpy(init_problem(params, config)).to(tdt))
    S, kept = pack(params, U)
    S[8:] = eps * S[:8] * torch.randn(S[:8].shape, generator=gen, dtype=tdt)
    kept[1] = eps * kept[0] * torch.randn(kept[0].shape, generator=gen, dtype=tdt)
    dims, blk = (params.nx, params.ny, params.nz), param_block(params)
    t0 = torch.tensor(mri_t0(params), dtype=tdt)
    dt = dt_from_inv(params, inv_dt_mhd_shear(params, S, kept[0]))
    slabs = shear_slabs(params, S[:8], kept[0], t0 + dt)
    planes = torch.zeros((5, params.nz, params.ny), dtype=tdt)
    scratch = torch.empty(lib.ramses_mhd_step_shear_scratch(*dims, 0), dtype=tdt)
    S1 = S.clone()
    assert getattr(lib, f"ramses_mhd_step_shear_{sfx}")(
        S1.data_ptr(), scratch.data_ptr(), slabs.data_ptr(), planes.data_ptr(), None, None,
        dt.data_ptr(), active.data_ptr(), 1, *dims, blk, None) == 0
    fluxes, emfs, x0, z0 = scratch_fluxes(params, scratch)
    assert torch.equal(S1, gm.mhd_apply_update(params, S[:8], fluxes, emfs, dt, x0, z0,
                                               comp=S[8:]))
    S1_t, planes_t = gm.mhd_3d_shear_update(params, S, slabs, dt)
    assert rel(S1[:8], S1_t[:8]) <= tol
    S2, kept2, rem = S1_t.clone(), kept.clone(), torch.zeros((4, params.nz, params.ny), dtype=tdt)
    assert getattr(lib, f"ramses_shear_border_{sfx}")(
        S2.data_ptr(), kept2.data_ptr(), planes_t.data_ptr(), rem.data_ptr(), t0.data_ptr(),
        dt.data_ptr(), active.data_ptr(), 1, *dims, blk, None) == 0
    S2_t, kept2_t, rem_t = gm.shear_border_update(params, S1_t, kept, planes_t, t0, dt)
    assert torch.equal(S2, S2_t) and torch.equal(kept2, kept2_t) and torch.equal(rem, rem_t)
