"""The chunk loop of the port's kernel paths (the counterpart of the
``lax.while_loop`` in ramsesgpu_tpu/pallas/fused_mhd3d.py:295 and
fused_hydro3d.py:204,302).

Each step launches a CFL kernel and the step's kernels on the loop state;
dt, t, the step count and the ``t < t_end`` flag stay device tensors and
the step kernels skip their work when the flag is false, so a chunk of n
steps makes no host sync.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..config.params import RunParams
from ..solvers.timestep import dt_from_inv


def make_kernel_loop(params: RunParams, device, cfl: Callable, bind_step: Callable,
                     pack: Callable, unpack: Callable, packed_form: bool = False):
    """``advance_n(U_ghosted, t, n) -> (U_ghosted', t', k)`` carrying the
    loop state across the chunk; or, with ``packed_form``, the triple
    ``(pack, advance_packed, unpack)``:

    - ``pack(U_ghosted) -> S`` (new tensors);
    - ``advance_packed(S, t, n) -> (S, t', k)`` updates S in place;
    - ``unpack(S, t) -> U_ghosted`` (t: the state's time).

    The loop state S is a tensor, or a tuple of tensors (the shearing box
    carries (S, kept)). ``cfl(S)`` returns the 0-d inverse dt;
    ``bind_step(S)`` allocates the step's stage buffers for S's shapes once
    per chunk and returns ``step(S, dt, active, t)``, which advances S in
    place from time t. ``t`` is a 0-d tensor of the state dtype on
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
        k = torch.zeros((), dtype=torch.int32, device=t.device)
        always = torch.ones((), dtype=torch.bool, device=t.device)
        step = bind_step(S)
        for _ in range(n):
            active = (t < t_end) if t_end > 0 else always
            dt = dt_from_inv(params, cfl(S))
            step(S, dt, active, t)
            t = t + torch.where(active, dt, torch.zeros_like(dt))
            k = k + active.to(torch.int32)
        return S, t, k

    if packed_form:
        return checked_pack, advance_packed, unpack

    def advance_n(U, t, n_steps):
        S, t_new, k = advance_packed(checked_pack(U), t, n_steps)
        return unpack(S, t_new), t_new, k

    return advance_n
