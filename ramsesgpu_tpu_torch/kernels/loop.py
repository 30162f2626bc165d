"""The chunk loop of the port's kernel paths (the counterpart of the
``lax.while_loop`` in ramsesgpu_tpu/pallas/fused_mhd3d.py:295 and
fused_hydro3d.py:204,302).

Each step launches a CFL kernel and a step kernel on the loop state; dt,
t, the step count and the ``t < t_end`` flag stay device tensors and the
step kernel skips its work when the flag is false, so a chunk of n steps
makes no host sync.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..config.params import RunParams
from ..solvers.timestep import dt_from_inv


def make_kernel_loop(params: RunParams, device, cfl: Callable, step, pack: Callable,
                     unpack: Callable, packed_form: bool = False):
    """``advance_n(U_ghosted, t, n) -> (U_ghosted', t', k)`` carrying the
    loop state across the chunk; or, with ``packed_form``, the triple
    ``(pack, advance_packed, unpack)``:

    - ``pack(U_ghosted) -> S`` (a new tensor);
    - ``advance_packed(S, t, n) -> (S, t', k)`` updates S in place;
    - ``unpack(S) -> U_ghosted``.

    ``cfl(params, S)`` returns the 0-d inverse dt; ``step(params, S, dt,
    active, scratch)`` advances S in place, with ``step.scratch(params, S)``
    its stage buffer. ``t`` is a 0-d tensor of the state dtype on
    ``device``; ``n`` an int. The loop stops advancing once t >= t_end
    (t_end > 0), as the JAX while_loop does, without leaving the device."""
    device = torch.device(device)
    t_end = params.t_end

    def checked_pack(U):
        if U.device.type != device.type:
            raise ValueError(f"state on {U.device}, advance built for {device}")
        return pack(U)

    def advance_packed(S, t, n_steps):
        n = int(n_steps)
        k = torch.zeros((), dtype=torch.int32, device=S.device)
        always = torch.ones((), dtype=torch.bool, device=S.device)
        scratch = step.scratch(params, S)
        for _ in range(n):
            active = (t < t_end) if t_end > 0 else always
            dt = dt_from_inv(params, cfl(params, S))
            step(params, S, dt, active, scratch)
            t = t + torch.where(active, dt, torch.zeros_like(dt))
            k = k + active.to(torch.int32)
        return S, t, k

    if packed_form:
        return checked_pack, advance_packed, unpack

    def advance_n(U, t, n_steps):
        S, t, k = advance_packed(checked_pack(U), t, n_steps)
        return unpack(S), t, k

    return advance_n
