"""Two probes behind findings of the MHD solver slice of the PyTorch port.
Run from the root of a checkout.

    python3 scripts/torch_solver_probes.py llf     # CPU: both packages
    python3 scripts/torch_solver_probes.py strat   # an NVIDIA GPU: the port

``llf``: 3D Orszag-Tang at 24^3, f64, 60 steps of the JAX package's
``make_step_fn`` (kernel=jnp, under its jit) and of the port's CPU loop,
for the solver pairs (llf, llf), (hll, llf), (llf, hlla) and (hlld, hlld):
each run's t and max|B| (the LLF corner EMF's dissipation has the other
sign than the HLL family's; ROADMAP Queue 3 item 18).

``strat``: data/mhd_mri_3d_stratified.ini as shipped but for the mesh
(128x256x128 f32) and nu, eta, through the port's loop on the card for 5
chunks of 10 steps, for several (nu, eta): each chunk's t, mean dt, min
rho, finiteness and mass change (ROADMAP Queue 3 item 8).
"""
from __future__ import annotations

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PAIRS = (("llf", "llf"), ("hll", "llf"), ("llf", "hlla"), ("hlld", "hlld"))


def ot_text(face: str, corner: str) -> str:
    sys.path.insert(0, str(REPO / "tests"))
    import test_torch_mhd_solvers as m

    return m.ot3d_text(face, corner, kernel="jnp").replace("nx=16\nny=16\nnz=16",
                                                           "nx=24\nny=24\nnz=24")


def llf(steps: int = 60) -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np
    import torch
    from ramsesgpu_tpu.config.configmap import ConfigMap
    from ramsesgpu_tpu.config.params import params_from_config
    from ramsesgpu_tpu.problems import init_problem
    from ramsesgpu_tpu.solvers.boundary import make_boundaries
    from ramsesgpu_tpu.solvers.step import make_step_fn
    from ramsesgpu_tpu_torch.config.configmap import ConfigMap as TConfigMap
    from ramsesgpu_tpu_torch.config.params import params_from_config as t_params
    from ramsesgpu_tpu_torch.solvers.step import make_advance_n

    for face, corner in PAIRS:
        config = ConfigMap(text=ot_text(face, corner))
        params = params_from_config(config)
        U = make_boundaries(params, jnp.asarray(init_problem(params, config), jnp.float64))
        U0 = np.array(U)
        step = jax.jit(make_step_fn(params, config))
        t = jnp.asarray(0.0)
        for _ in range(steps):
            U, dt = step(U, t)
            t = t + dt
        tconfig = TConfigMap(text=ot_text(face, corner))
        V, tt, _k = make_advance_n(t_params(tconfig), "cpu", tconfig)(
            torch.from_numpy(U0), torch.zeros((), dtype=torch.float64), steps)
        g = params.ghost_width
        inner = (slice(5, 8), slice(g, -g), slice(g, -g), slice(g, -g))
        print(f"[llf] ({face}, {corner}) 24^3 f64, {steps} steps: JAX t {float(t):.6g}, "
              f"max|B| {float(np.abs(np.asarray(U)[inner]).max()):.4g}; port t {float(tt):.6g}, "
              f"max|B| {float(V[inner].abs().max()):.4g}", flush=True)


def strat() -> None:
    import torch
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from ramsesgpu_tpu_torch.solvers.step import make_packed_advance_chain

    card = cs.card_line()
    for nu, eta in ((4e-5, 1e-5), (4e-6, 1e-6), (4e-7, 1e-7), (4e-5, 0.0), (0.0, 1e-5),
                    (0.0, 0.0)):
        params, config, (S0, kept0) = cs.mri_setup(128, 256, 128, "float32", nu=nu, eta=eta,
                                                   compensated=None, ini=cs.STRAT_INI)
        _pack, advance, _unpack = make_packed_advance_chain(params, "cuda", config)
        state, t = (S0, kept0), torch.zeros((), dtype=torch.float32, device="cuda")
        mass0 = float(S0[0].double().sum())
        chunks = []
        for chunk in range(5):
            t_old = float(t)
            state, t, _k = advance(state, t, 10)
            S = state[0]
            chunks.append(f"chunk {chunk}: t {float(t):.4g} (dt {(float(t) - t_old) / 10:.3g}), "
                          f"min rho {float(S[0].min()):.3e}, finite "
                          f"{bool(torch.isfinite(S).all())}, mass rel "
                          f"{abs(float(S[0].double().sum()) - mass0) / mass0:.2e}")
        print(f"[strat] nu {nu} eta {eta} ({card}): " + "; ".join(chunks), flush=True)


if __name__ == "__main__":
    {"llf": llf, "strat": strat}[sys.argv[1]]()
