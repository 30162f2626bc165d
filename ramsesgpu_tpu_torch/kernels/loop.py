"""The chunk loop of the port's kernel paths (the counterpart of the
``lax.while_loop`` in ramsesgpu_tpu/pallas/fused_mhd3d.py:295 and
fused_hydro3d.py:204,302).

Each step launches the step's kernels on the loop state, and a CFL kernel
unless the step before returned the next inverse dt (the streamed steps of
``kernel=zcarry`` fold the reduction into the step, as the JAX inv-carry
loops do, pallas/fused_mhd3d.py:395-415, fused_hydro3d.py:243-260); dt,
t, the step count and the ``t < t_end`` flag stay device tensors and the
step kernels skip their work when the flag is false, so a chunk of n steps
makes no host sync.

A forced run (the turbulence problems, the JAX make_forced_advance_n,
solvers/step.py:466-528 there) adds a post-step hook: the forcing kick on
the state after each step, gated by the same flag. The JAX forced step
takes its dt from the forced state, so with a hook the loop launches the
CFL kernel every step and a streamed step's folded inverse dt, reduced
before the kick, is not used.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..config.params import RunParams
from ..solvers.boundary import fill_ghosts_
from ..solvers.timestep import dt_from_inv


def make_kernel_loop(params: RunParams, device, cfl: Callable, bind_step: Callable,
                     pack: Callable, unpack: Callable, packed_form: bool = False,
                     post_step: Callable | None = None):
    """``advance_n(U_ghosted, t, n) -> (U_ghosted', t', k)`` carrying the
    loop state across the chunk; or, with ``packed_form``, the triple
    ``(pack, advance_packed, unpack)``:

    - ``pack(U_ghosted) -> S`` (new tensors);
    - ``advance_packed(S, t, n) -> (S, t', k)`` updates S in place;
    - ``unpack(S, t) -> U_ghosted`` (t: the state's time).

    The loop state S is a tensor, or a tuple of tensors (the shearing box
    carries (S, kept)). ``cfl(S)`` returns the 0-d inverse dt;
    ``bind_step(S)`` allocates the step's buffers for S's shapes once per
    chunk and returns ``step(S, dt, active, t) -> (S', inv)``: the state
    after the step from time t, which is S itself for a step in place or
    another buffer of the same shapes for a streamed one, and the next
    step's 0-d inverse dt when the step reduced it, else None. The first
    dt of a chunk comes from ``cfl``; a chunk that ends in another buffer
    copies its state into the caller's S once. ``t`` is a 0-d tensor of the
    state dtype on ``device``; ``n`` an int. The loop stops advancing once
    t >= t_end (t_end > 0), as the JAX while_loop does, without leaving the
    device. ``post_step(S', dt, active)``, when given, updates the state
    after each step in place (the forcing; see the module note)."""
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
        cur, inv = S, None
        for _ in range(n):
            active = (t < t_end) if t_end > 0 else always
            dt = dt_from_inv(params, cfl(cur) if inv is None else inv)
            cur, inv = step(cur, dt, active, t)
            if post_step is not None:
                post_step(cur, dt, active)
                inv = None  # reduced before the kick
            t = t + torch.where(active, dt, torch.zeros_like(dt))
            k = k + active.to(torch.int32)
        copy_state(S, cur)
        return S, t, k

    # the parts, for a profile of the step's phases (utils/profile.py)
    advance_packed.cfl, advance_packed.bind_step = cfl, bind_step
    if packed_form:
        return checked_pack, advance_packed, unpack

    def advance_n(U, t, n_steps):
        S, t_new, k = advance_packed(checked_pack(U), t, n_steps)
        return unpack(S, t_new), t_new, k

    return advance_n


def make_ghosted_loop(params: RunParams, device, cfl: Callable, step_: Callable,
                      scratch: Callable, packed_form: bool = False,
                      post_step: Callable | None = None):
    """The chunk loop on the ghosted state itself, for the runs whose fill
    the interior loops' load rules cannot express (MHD walls, whose
    step also writes the CT face layer; the inflow jet; hydro viscosity,
    which refills before its sub-step). Pack is a
    contiguous copy of the ghosted state, unpack hands a copy back. Each
    step runs, in this order: ``cfl(U)`` on the state as it stands (the
    JAX compute_dt before make_boundaries, so a wall's +1 face is the
    previous step's ghost); the in-place fill (solvers/boundary.py
    fill_ghosts_, the jet included), gated by the loop's ``active`` flag;
    ``step_(params, U, dt, active, buf)``, the kernel's ghosted mode in
    place, with ``buf = scratch(U)`` allocated once per chunk. ``post_step``
    (the forcing) then takes the interior, a view of U. See
    make_kernel_loop for the rest."""
    g = params.ghost_width
    inner = (slice(None),) + (slice(g, -g),) * params.dim
    hook = None if post_step is None else (
        lambda U, dt, active: post_step(U[inner], dt, active))

    def bind_step(U):
        buf = scratch(U)

        def step(U, dt, active, t):
            fill_ghosts_(params, U, active)
            step_(params, U, dt, active, buf)
            return U, None

        return step

    return make_kernel_loop(params, device, cfl, bind_step,
                            pack=lambda U: U.clone(memory_format=torch.contiguous_format),
                            unpack=lambda U, t: U.clone(), packed_form=packed_form,
                            post_step=hook)


def copy_state(dst, src) -> None:
    """Copy the loop state src into dst (tensors, or tuples of them), each
    tensor that is not already dst's own."""
    for d, s in (zip(dst, src) if isinstance(dst, tuple) else ((dst, src),)):
        if d is not s:
            d.copy_(s)


def streamed_step(S, step_into: Callable) -> Callable:
    """``step(S, dt, active, t) -> (S', inv)`` for a step that cannot work
    in place: ``step_into(S_in, S_out, dt, active, t) -> inv`` writes the
    step of the loop state S_in into the tensor S_out. The bound state's
    tensor (its first, for a tuple state, whose other members the step
    updates in place) and one more buffer of its shape take turns as
    S_out."""
    first = S[0] if isinstance(S, tuple) else S
    other = torch.empty_like(first)

    def step(cur, dt, active, t):
        head = cur[0] if isinstance(cur, tuple) else cur
        out = first if head is other else other
        inv = step_into(cur, out, dt, active, t)
        return ((out, *cur[1:]) if isinstance(cur, tuple) else out), inv

    return step
