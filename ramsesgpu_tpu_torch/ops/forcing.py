"""Turbulence driving: static-spectrum forcing and Ornstein-Uhlenbeck
forcing (the port's counterpart of ramsesgpu_tpu/ops/forcing.py; reference
turbulenceInit.cpp, HydroRunBase.cpp:1201-1428,
Forcing_OrnsteinUhlenbeck.{h,cpp}).

The tables and the fields built once at start stay numpy, bitwise the JAX
package's (``turbulence_init_field``, ``default_edot``, the OU mode signs
and projection tensor of ``init_ou_forcing``). Everything a step does is
whole-array PyTorch on the loop's device tensors, with no host sync: the
JAX package runs it in XLA, not in a Pallas kernel.

The step functions take the port's loop state S, the interior-only
[nvar, nz, ny, nx] (nvar 5 for hydro, 8 for MHD; the channels ID, IP, IU,
IV, IW are the same), where the JAX ones take the ghosted state and slice
its interior. So the static field F is kept as its interior [3, nz, ny,
nx] and the OU basis as its interior [31, nz, ny, nx].

The OU state's random numbers come from a ``torch.Generator`` on the
loop's device, seeded from ``init_random``, where JAX splits a PRNG key:
the two streams differ. ``OUState.draw`` is the function that gives each
step's [3, 31] normal draws; a caller can put another in its place (the
tests replay the JAX package's draws with it). A checkpoint's
``gaussSeed`` holds [seed, draws]: the stream is the device's generator
seeded with ``seed`` after ``draws`` blocks of [3, 31] (CPU and CUDA
generators give different streams).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from ..config.configmap import ConfigMap
from ..config.params import RunParams
from ..core.constants import ID, IP, IU, IV, IW
from .backend import xp

# --------------------------------------------------------------------------- #
# 1. static-spectrum forcing (Enzo-heritage)
# --------------------------------------------------------------------------- #

# 16 driving modes with 1 <= |k| <= 2 (turbulenceInit.cpp:56-74)
_MODES16 = np.array(
    [
        [1, 1, 1], [-1, 1, 1], [1, -1, 1], [1, 1, -1],
        [0, 0, 1], [0, 1, 0], [1, 0, 0],
        [0, 1, 1], [1, 0, 1], [1, 1, 0],
        [0, -1, 1], [-1, 0, 1], [-1, 1, 0],
        [0, 0, 2], [0, 2, 0], [2, 0, 0],
    ]
)

# published random phases for seed=12398L (turbulenceInit.cpp:81-99)
_PHAX = np.array([4.88271710, 4.55016280, 3.68972560, 5.76067300,
                  2.02647730, 0.832007770, 1.93749010, 0.0141755510,
                  5.13556960, 2.77787590, 2.02909450, 0.663769130,
                  1.80512500, 3.31305960, 1.05063310, 1.75230850])
_PHAY = np.array([1.40113130, 5.71809960, 3.82072880, 1.00265060,
                  2.26816680, 2.81446220, 0.990584490, 2.94580650,
                  3.92715640, 0.896237970, 1.85357800, 2.84606100,
                  1.63463330, 3.46619220, 5.58599570, 1.59481430])
_PHAZ = np.array([5.60595510, 4.13909050, 6.22733640, 5.92633250,
                  3.51874880, 5.42229180, 5.77061890, 4.95180180,
                  4.46144340, 5.29367540, 5.50741860, 2.39496800,
                  4.59486870, 2.23851540, 3.19591550, 4.47066500])

# solenoidalized Gaussian amplitudes for seed=12398L (turbulenceInit.cpp:102-117)
_AMP = np.array([
    [0.0755957220, -1.35724380, 0.378455820, -0.383104000,
     0.116980840, -1.16079680, 0.0, -0.0280965080,
     0.0, 0.0, -0.232798780, 0.0,
     0.0, -0.879534360, -0.604585950, 0.0],
    [1.03223790, 0.530986910, -0.242943420, -0.832715270,
     -0.607103350, 0.0, -0.278135540, 0.0,
     -1.18019080, 0.0, 0.0, 0.976678430,
     0.0, -0.694509390, 0.0, -0.608007610],
    [1.01825800, -0.966076610, 0.211956020, -0.605923650,
     0.0, 0.314906060, 0.109417880, 0.0,
     0.0, -1.53612340, 0.0, 0.0,
     0.813212160, 0.0, -0.368619380, -0.371489380],
])

_SIGN1 = np.array([1.0, -1.0, -1.0, 1.0])
_SIGN2 = np.array([-1.0, -1.0, 1.0, 1.0])


def _cos_of(k1: np.ndarray, aa: float, phase) -> np.ndarray:
    """np.cos(aa * k1 + phase) of an integer array k1, evaluated once per
    distinct value of k1 and gathered (the same doubles, bitwise)."""
    lo = int(k1.min())
    return np.cos(aa * np.arange(lo, int(k1.max()) + 1) + phase)[k1 - lo]


def turbulence_init_field(params: RunParams, mach_number: float,
                          block: tuple | None = None) -> np.ndarray:
    """The static 3-component forcing velocity field on the full ghosted
    grid (turbulenceInit.cpp:120-199), [3, nz_t, ny_t, nx_t] numpy in the
    run's dtype; bitwise the JAX package's. Each mode's phase k.x takes a
    few thousand integer values, so its cosines are formed once per value
    (_cos_of: at 256^3 ~10x faster than on every cell). ``block``: a
    rank's slices of the global interior (parallel/mesh.py block_slices);
    then that block of the interior [3, lnz, lny, lnx] alone, each value
    from its global index: bitwise the global field's block."""
    aa = 2.0 * np.pi / params.nx  # nbox = global nx
    g = params.ghost_width
    i, j, k = (np.arange(n) - g + 1 for n in (params.isize, params.jsize, params.ksize))
    if block is not None:
        sz, sy, sx = block[1:]
        i, j, k = i[g:-g][sx], j[g:-g][sy], k[g:-g][sz]
    shape = (k.size, j.size, i.size)
    i, j, k = i[None, None, :], j[None, :, None], k[:, None, None]

    u = np.zeros(shape)
    v = np.zeros(shape)
    w = np.zeros(shape)

    for imo in range(4):
        k1 = _MODES16[imo, 0] * i + _MODES16[imo, 1] * j + _MODES16[imo, 2] * k
        u += _AMP[0, imo] * _cos_of(k1, aa, _PHAX[imo])
        # solenoidal phase corrections for the diagonal modes
        # (Crockett 2005 eqs. 10.6-10.7, turbulenceInit.cpp:152-172)
        phayy = _PHAX[imo] + _SIGN1[imo] * np.arccos(
            (_AMP[2, imo] ** 2 - _AMP[0, imo] ** 2 - _AMP[1, imo] ** 2)
            / 2.0 / _AMP[0, imo] / _MODES16[imo, 0] / _MODES16[imo, 1] / _AMP[1, imo]
        )
        v += _AMP[1, imo] * _cos_of(k1, aa, phayy)
        phazz = _PHAX[imo] + _SIGN2[imo] * np.arccos(
            (_AMP[1, imo] ** 2 - _AMP[0, imo] ** 2 - _AMP[2, imo] ** 2)
            / 2.0 / _AMP[0, imo] / _MODES16[imo, 0] / _MODES16[imo, 2] / _AMP[2, imo]
        )
        w += _AMP[2, imo] * _cos_of(k1, aa, phazz)

    for imo in range(4, 16):
        k1 = _MODES16[imo, 0] * i + _MODES16[imo, 1] * j + _MODES16[imo, 2] * k
        u += _AMP[0, imo] * _cos_of(k1, aa, _PHAX[imo])
        v += _AMP[1, imo] * _cos_of(k1, aa, _PHAY[imo])
        w += _AMP[2, imo] * _cos_of(k1, aa, _PHAZ[imo])

    scale = mach_number / 2.848320  # normalize to rms 3D Mach
    dtype = np.float64 if params.dtype == "float64" else np.float32
    return np.stack([u, v, w]).astype(dtype) * scale


def default_edot(params: RunParams, config: ConfigMap) -> float:
    """MacLow (1999) energy injection rate default
    (HydroRunBase.cpp:7176-7193)."""
    edot = config.get_float("turbulence", "edot", -1.0)
    if edot < 0:
        d0 = config.get_float("turbulence", "density", 1.0)
        mach = config.get_float("turbulence", "machNumber", 0.0)
        box = params.xmax - params.xmin
        box_mass = box**3 * d0
        v_rms = mach
        edot = 0.81 / box * box_mass * v_rms**3
        edot *= 0.8
    return edot


def random_forcing_normalization(params: RunParams, S: torch.Tensor, F: torch.Tensor,
                                 dt: torch.Tensor, edot: float,
                                 reduce: Callable | None = None) -> torch.Tensor:
    """The energy-injection normalization factor, a 0-d tensor of S's
    dtype on S's device (HydroRunBase.cpp:1201-1312): norm = (sqrt(s0^2 +
    s1 dt edot 2 N) - s0) / s1 with s0 = sum rho v.F, s1 = sum rho F^2 over
    the cells of the interior-only state S and the field's interior F
    [3, nz, ny, nx]; the JAX package's op order. The sums accumulate, and
    the formula runs, in float64 (in a float64 run the JAX package's
    arithmetic): sqrt(s0^2 + X) - s0 cancels where X << s0^2, a moving
    state's case, and in float32 that scales the rounding of the sums and
    of the square root up to ~1e-4 of norm at 256^3 (PERF.md section 6). With
    edot = 0 it is 0. ``reduce``: on a rank of a sharded run, the sum of
    the float64 pair [s0, s1] over the ranks (ProcessGrid.all_sum, the JAX
    lax.psum), S and F being the rank's blocks and N the global cell count
    of ``params``; default none (one device)."""
    if edot == 0:
        return torch.zeros((), dtype=S.dtype, device=S.device)
    rho = S[ID]
    u = S[IU] / rho
    v = S[IV] / rho
    w = S[IW] / rho
    fu, fv, fw = F[0], F[1], F[2]
    s0 = torch.sum(rho * (u * fu + v * fv + w * fw), dtype=torch.float64)
    s1 = torch.sum(rho * (fu * fu + fv * fv + fw * fw), dtype=torch.float64)
    if reduce is not None:
        s0, s1 = reduce(torch.stack([s0, s1]))
    n_cells = params.nx * params.ny * params.nz
    norm = (xp.sqrt(s0 * s0 + s1 * dt.double() * edot * 2 * n_cells) - s0) / s1
    return norm.to(S.dtype)


def add_random_forcing(params: RunParams, S: torch.Tensor, F: torch.Tensor,
                       norm: torch.Tensor) -> torch.Tensor:
    """Kick the momenta of S by rho F norm, in place, and add to the
    energy density the kinetic energy per unit mass this adds (no rho
    factor, as the JAX package writes it, forcing.py:160-164; HydroRunBase.
    cpp:1397-1428); returns S. A norm of 0 leaves S as it was."""
    rho = S[ID]
    f0, f1, f2 = F[0] * norm, F[1] * norm, F[2] * norm
    dE = (
        S[IU] / rho * F[0] * norm + 0.5 * f0 ** 2
        + S[IV] / rho * F[1] * norm + 0.5 * f1 ** 2
        + S[IW] / rho * F[2] * norm + 0.5 * f2 ** 2
    )
    S[IP] += dE
    S[IU] += rho * F[0] * norm
    S[IV] += rho * F[1] * norm
    S[IW] += rho * F[2] * norm
    return S


# --------------------------------------------------------------------------- #
# 2. Ornstein-Uhlenbeck forcing
# --------------------------------------------------------------------------- #

N_MODE_OU = 31

# the 31 driving wavevectors (Forcing_OrnsteinUhlenbeck.cpp:160-191)
OU_MODES = np.array([
    [0, 0, 2], [0, 0, 3], [0, 1, 2], [0, 1, 3], [0, 2, 0], [0, 2, 1],
    [0, 2, 2], [0, 3, 0], [0, 3, 1], [1, 0, 2], [1, 0, 3], [1, 1, 2],
    [1, 1, 3], [1, 2, 0], [1, 2, 1], [1, 2, 2], [1, 3, 0], [1, 3, 1],
    [2, 0, 0], [2, 0, 1], [2, 0, 2], [2, 1, 0], [2, 1, 1], [2, 1, 2],
    [2, 2, 0], [2, 2, 1], [2, 2, 2], [3, 0, 0], [3, 0, 1], [3, 1, 0],
    [3, 1, 1],
], dtype=np.float64).T  # shape [3, 31]


@dataclasses.dataclass(frozen=True)
class OUForcingParams:
    """Static OU forcing configuration
    ([turbulence-Ornstein-Uhlenbeck] section)."""

    timescale: float = 0.1
    amplitude: float = 0.0001
    ksi: float = 0.0
    init_random: int = 600

    @classmethod
    def from_config(cls, config: ConfigMap) -> "OUForcingParams":
        sec = "turbulence-Ornstein-Uhlenbeck"
        return cls(
            timescale=config.get_float(sec, "timeScaleTurb", 0.1),
            amplitude=config.get_float(sec, "amplitudeTurb", 0.0001),
            ksi=config.get_float(sec, "ksi", 0.0),
            init_random=config.get_integer(sec, "init_random", 600),
        )


@dataclasses.dataclass
class OUState:
    """The OU forcing state on the loop's device: the mode table [3, 31]
    and projection tensor [3, 3, 31] (float64), the mode field [3, 31]
    (float32 in every run, as the JAX package keeps it), the generator
    seed, the dtype its blocks are drawn in (the run's) and the [3, 31]
    blocks drawn so far, and ``draw()``, the function that gives the next
    block in that dtype."""

    mode: torch.Tensor
    projTens: torch.Tensor
    forcingField: torch.Tensor
    seed: int
    dtype: torch.dtype = torch.float32
    draws: int = 0
    draw: Callable[[], torch.Tensor] | None = None

    def __post_init__(self) -> None:
        if self.draw is None:
            self.draw = self._generator_draw()

    def _generator_draw(self) -> Callable[[], torch.Tensor]:
        """The default draw: N(0, 1) blocks [3, 31] from a torch.Generator on
        the state's device seeded with ``seed``, the first ``draws`` blocks
        skipped; each block drawn adds one to ``draws``."""
        device = self.forcingField.device
        gen = torch.Generator(device=device)
        gen.manual_seed(self.seed)
        for _ in range(self.draws):
            torch.randn((3, N_MODE_OU), generator=gen, device=device, dtype=self.dtype)

        def draw() -> torch.Tensor:
            self.draws += 1
            return torch.randn((3, N_MODE_OU), generator=gen, device=device, dtype=self.dtype)

        return draw


def init_ou_forcing(fp: OUForcingParams, seed: int | None = None, device="cpu",
                    dtype=torch.float32) -> OUState:
    """The OU forcing state (Forcing_OrnsteinUhlenbeck.cpp:142-215):
    randomized mode signs from numpy's RandomState and the projection
    tensor (bitwise the JAX package's), a zero field, a generator seeded
    with ``seed`` (default init_random) on ``device`` drawing in ``dtype``
    (the run's: jax.random.normal draws in the run's precision)."""
    seed = fp.init_random if seed is None else seed
    rng = np.random.RandomState(seed)
    mode = OU_MODES.copy()  # [3, 31]
    signs = np.sign(rng.randn(3, N_MODE_OU))
    signs[signs == 0] = 1.0
    mode = np.copysign(mode, signs)

    ksi = fp.ksi
    ssum = (mode**2).sum(axis=0)  # [31]
    eye = np.eye(3)
    # projTens[i,j,m] = ksi*delta_ij + (1-2ksi) * k_j k_i / |k|^2
    proj = ksi * eye[:, :, None] + (1.0 - 2.0 * ksi) * (
        mode[None, :, :] * mode[:, None, :] / ssum[None, None, :]
    )
    return OUState(
        mode=torch.from_numpy(mode).to(device),
        projTens=torch.from_numpy(proj).to(device),
        forcingField=torch.zeros((3, N_MODE_OU), dtype=torch.float32, device=device),
        seed=int(seed), dtype=dtype,
    )


def update_forcing_field_mode(params: RunParams, fp: OUForcingParams, state: OUState,
                              dt: torch.Tensor, active: torch.Tensor | None = None) -> OUState:
    """The exact OU step of every mode (Forcing_OrnsteinUhlenbeck.cpp:
    470-515; Gillespie 1996 eqs. 1.1/1.9a), in dt's dtype, the field kept
    float32; in place when the 0-d bool ``active`` is true (a block is
    drawn either way). Returns the state."""
    # reference: v = sqrt(5/3)*cIso; for non-isothermal runs cIso=0 in the
    # reference too — keep the same formula
    v = np.sqrt(5.0 / 3.0) * params.c_iso
    weight = fp.amplitude

    AAA = state.draw().to(dt.dtype) * xp.sqrt(dt)  # [3, 31]
    proj = state.projTens.to(dt.dtype)
    # BBB[j,m] = sum_i projTens[i,j,m] * AAA[i,m]
    BBB = proj[0] * AAA[0] + proj[1] * AAA[1] + proj[2] * AAA[2]
    BBB = BBB * v * np.sqrt(2.0 * weight * weight / fp.timescale) / fp.timescale
    field = state.forcingField
    BBB = BBB - field.to(dt.dtype) * dt / fp.timescale
    force_rms = 3.0 / np.sqrt(1.0 - 2.0 * fp.ksi + 3.0 * fp.ksi * fp.ksi)
    new = (field.to(dt.dtype) + force_rms * BBB).to(field.dtype)
    field.copy_(new if active is None else torch.where(active, new, field))
    return state


def ou_phase_basis(params: RunParams, state: OUState, dtype, device=None,
                   block: tuple | None = None) -> torch.Tensor:
    """cos(2 pi (x kx + y ky + z kz)) of every mode on the interior cells,
    [31, nz, ny, nx]: the JAX basis (computed in float64 and rounded to
    ``dtype``) without its ghost frame, built once on ``device`` (default
    the state's) one mode at a time. 31 values a cell: 2.08 GB at 256^3 in
    float32. ``block``: a rank's slices of the global interior
    (parallel/mesh.py block_slices); then only that block [31, lnz, lny,
    lnx], from the global coordinates sliced, bitwise the global basis's
    block."""
    device = state.mode.device if device is None else torch.device(device)
    g = params.ghost_width
    x = params.xmin + params.dx / 2 + (np.arange(params.isize) - g) * params.dx
    y = params.ymin + params.dy / 2 + (np.arange(params.jsize) - g) * params.dy
    z = params.zmin + params.dz / 2 + (np.arange(params.ksize) - g) * params.dz
    sz, sy, sx = (slice(None),) * 3 if block is None else block[1:]
    X = torch.from_numpy(x[g:-g][sx]).to(device)[None, None, :]
    Y = torch.from_numpy(y[g:-g][sy]).to(device)[None, :, None]
    Z = torch.from_numpy(z[g:-g][sz]).to(device)[:, None, None]
    mode = state.mode.cpu().numpy()
    out = torch.empty((N_MODE_OU, Z.shape[0], Y.shape[1], X.shape[2]), dtype=dtype,
                      device=device)
    for m in range(N_MODE_OU):
        phase = X * float(mode[0, m]) + Y * float(mode[1, m]) + Z * float(mode[2, m])
        out[m] = torch.cos(2.0 * math.pi * phase)
    return out


def add_ou_forcing_field(params: RunParams, S: torch.Tensor, state: OUState,
                         basis: torch.Tensor, dt: torch.Tensor,
                         active: torch.Tensor | None = None) -> torch.Tensor:
    """Apply the OU force to the interior-only state S at constant internal
    energy (Forcing_OrnsteinUhlenbeck.cpp:543-610), in place when the 0-d
    bool ``active`` is true; ``basis``: ou_phase_basis in S's dtype.
    Returns S."""
    rho = S[ID]
    # A[dim] = sum_m field[dim,m] * cos(2 pi phase_m)
    A = (state.forcingField.to(S.dtype) @ basis.view(N_MODE_OU, -1)).view(3, *S.shape[1:])

    eint = S[IP] - 0.5 * (S[IU] ** 2 + S[IV] ** 2 + S[IW] ** 2) / rho
    mu = S[IU] + A[0] * dt * rho
    mv = S[IV] + A[1] * dt * rho
    mw = S[IW] + A[2] * dt * rho
    e_new = eint + 0.5 * (mu * mu + mv * mv + mw * mw) / rho
    for ch, new in ((IU, mu), (IV, mv), (IW, mw), (IP, e_new)):
        S[ch].copy_(new if active is None else torch.where(active, new, S[ch]))
    return S


# --------------------------------------------------------------------------- #
# the forcing of a run: a post-step hook of the chunk loop
# --------------------------------------------------------------------------- #
FORCED_PROBLEMS = ("turbulence", "turbulence-Ornstein-Uhlenbeck")


class StaticForcing:
    """``forcing(S, dt, active)``: the static-spectrum kick of the JAX
    forced step (solvers/step.py:477-486 there) on the loop state after
    each step: the normalization from the field's interior F and the
    kick, gated by ``active`` through a zero norm. On a rank of a sharded
    run (JAX sharded_step.py:739-755) S is the rank's interior block,
    ``block`` its slices of the global interior, F that block of the
    global field (formed from the block's global indices alone) and
    ``reduce`` the sum over the ranks of the normalization's two sums
    (random_forcing_normalization)."""

    def __init__(self, params: RunParams, config: ConfigMap, device, dtype,
                 block: tuple | None = None, reduce: Callable | None = None) -> None:
        self.params = params
        self.reduce = reduce
        mach = config.get_float("turbulence", "machNumber", 0.0)
        self.edot = default_edot(params, config)
        g = params.ghost_width
        F = (turbulence_init_field(params, mach)[:, g:-g, g:-g, g:-g] if block is None
             else turbulence_init_field(params, mach, block))
        self.F = torch.from_numpy(np.ascontiguousarray(F)).to(device=device, dtype=dtype)
        self.state = None

    def __call__(self, S: torch.Tensor, dt: torch.Tensor, active: torch.Tensor) -> None:
        norm = random_forcing_normalization(self.params, S, self.F, dt, self.edot, self.reduce)
        add_random_forcing(self.params, S, self.F, torch.where(active, norm, 0.0))


class OUForcing:
    """``forcing(S, dt, active)``: the OU step of the JAX forced step
    (solvers/step.py:490-502 there): the mode update, then the kick with
    the basis in S's dtype (the JAX float32 basis, widened in float64 runs),
    both gated by ``active``. ``state`` is the OUState, carried across
    chunks on the device. On a rank of a sharded run (JAX
    sharded_step.py:757-784) S is the rank's interior block and the basis
    that ``block`` of the global basis; the state is replicated: every
    rank seeds the same generator and draws the same blocks, as every JAX
    shard carries the same key."""

    def __init__(self, params: RunParams, config: ConfigMap, device, dtype,
                 block: tuple | None = None) -> None:
        self.params = params
        self.fp = OUForcingParams.from_config(config)
        self.state = init_ou_forcing(self.fp, device=device, dtype=dtype)
        self.basis = ou_phase_basis(params, self.state, torch.float32, block=block).to(dtype)

    def __call__(self, S: torch.Tensor, dt: torch.Tensor, active: torch.Tensor) -> None:
        update_forcing_field_mode(self.params, self.fp, self.state, dt, active)
        add_ou_forcing_field(self.params, S, self.state, self.basis, dt, active)


def make_forcing(params: RunParams, config: ConfigMap, device, dtype,
                 block: tuple | None = None, reduce: Callable | None = None):
    """The post-step forcing of a turbulence problem on ``device`` (the
    JAX make_forced_step_fn's), or None for another problem. ``block``
    and ``reduce``: a sharded rank's (StaticForcing); the OU forcing
    needs no reduction."""
    if params.problem == "turbulence":
        return StaticForcing(params, config, device, dtype, block, reduce)
    if params.problem == "turbulence-Ornstein-Uhlenbeck":
        return OUForcing(params, config, device, dtype, block)
    return None


# --------------------------------------------------------------------------- #
# forcing-state checkpointing (npz layout of Forcing_OrnsteinUhlenbeck.cpp:
# output_forcing / input_forcing)
# --------------------------------------------------------------------------- #
def save_ou_forcing(state: OUState, path, n_cpu: int = 1) -> None:
    """The JAX package's npz layout; gaussSeed holds [seed, draws]."""
    np.savez(
        path,
        nMode=np.array([N_MODE_OU], np.int32),
        nCpu=np.array([n_cpu], np.int32),
        mode=state.mode.cpu().numpy().T,          # [31, 3] as the reference
        forcingField=state.forcingField.cpu().numpy().T,
        projTens=state.projTens.cpu().numpy().T,
        gaussSeed=np.array([state.seed, state.draws], np.int64),
    )


def load_ou_forcing(path, device="cpu", dtype=torch.float32) -> OUState:
    """An OUState from save_ou_forcing's file on ``device``, drawing in
    ``dtype`` (the run's): its generator seeded with gaussSeed[0] and
    advanced by gaussSeed[1] blocks."""
    data = np.load(path)
    n_mode = int(np.atleast_1d(data["nMode"])[0])
    if n_mode != N_MODE_OU:
        raise ValueError(f"forcing file has nMode={n_mode}, expected {N_MODE_OU}")
    seed, draws = (int(s) for s in np.asarray(data["gaussSeed"]).reshape(-1)[:2])
    return OUState(
        mode=torch.from_numpy(np.ascontiguousarray(data["mode"].T)).to(device),
        projTens=torch.from_numpy(np.ascontiguousarray(data["projTens"].T)).to(device),
        forcingField=torch.from_numpy(
            np.ascontiguousarray(data["forcingField"].T.astype(np.float32))).to(device),
        seed=seed, dtype=dtype, draws=draws,
    )
