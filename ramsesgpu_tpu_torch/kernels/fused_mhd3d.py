"""The periodic 3D MHD advance loop on the CUDA kernels (the port's
counterpart of ramsesgpu_tpu/pallas/fused_mhd3d.py:274-488
``pallas_packed_supported`` / ``make_pallas_advance_n``).

Loop state: the interior-only periodic state S [8, nz, ny, nx]; the
kernels find periodic neighbours by index wrap, so pack is a slice of the
ghosted state and unpack a wrap pad. Each step launches the CFL kernel
(kernels/cfl_mhd.py) and the step kernel (kernels/mhd_step.py); dt, t,
the step count and the ``t < t_end`` flag stay device tensors, so a chunk
of n steps makes no host sync.
"""
from __future__ import annotations

import torch

from ramsesgpu_tpu.config.params import RunParams

from ..solvers.boundary import interior, wrap_pad
from ..solvers.timestep import dt_from_inv
from .cfl_mhd import cfl_mhd
from .mhd_step import mhd_step, require_step_scope


def packed_supported(params: RunParams) -> bool:
    """Whether the kernel loop covers this configuration."""
    try:
        require_step_scope(params)
    except NotImplementedError:
        return False
    return params.problem not in ("jet", "Jet")


def make_advance_n(params: RunParams, device, packed_form: bool = False):
    """``advance_n(U_ghosted, t, n) -> (U_ghosted', t', k)`` carrying the
    port's loop state across the chunk; or, with ``packed_form``, the triple
    ``(pack, advance_packed, unpack)``:

    - ``pack(U_ghosted) -> S`` (a new contiguous interior);
    - ``advance_packed(S, t, n) -> (S, t', k)`` updates S in place;
    - ``unpack(S) -> U_ghosted``.

    ``t`` is a 0-d tensor of the state dtype on ``device``; ``n`` an int.
    The loop stops advancing once t >= t_end (t_end > 0), as the JAX
    while_loop does, without leaving the device."""
    require_step_scope(params)
    device = torch.device(device)
    g = params.ghost_width
    t_end = params.t_end

    def pack(U):
        if U.device.type != device.type:
            raise ValueError(f"state on {U.device}, advance built for {device}")
        return interior(params, U).contiguous()

    def unpack(S):
        return wrap_pad(S, g)

    def advance_packed(S, t, n_steps):
        n = int(n_steps)
        k = torch.zeros((), dtype=torch.int32, device=S.device)
        always = torch.ones((), dtype=torch.bool, device=S.device)
        scratch = mhd_step.scratch(params, S)
        for _ in range(n):
            active = (t < t_end) if t_end > 0 else always
            dt = dt_from_inv(params, cfl_mhd(params, S))
            mhd_step(params, S, dt, active, scratch)
            t = t + torch.where(active, dt, torch.zeros_like(dt))
            k = k + active.to(torch.int32)
        return S, t, k

    if packed_form:
        return pack, advance_packed, unpack

    def advance_n(U, t, n_steps):
        S, t, k = advance_packed(pack(U), t, n_steps)
        return unpack(S), t, k

    return advance_n
