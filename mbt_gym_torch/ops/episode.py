"""Avellaneda-Stoikov whole-episode kernels K1 and K2 (counterpart of the
AS part of ``mbt_gym_tpu/ops/pallas_episode.py``), each beside its plain
PyTorch version.

- K1 :func:`as_episode` replaces ``as_episode_pallas``
  (``ops/pallas_episode.py:233``): one whole episode per env for the
  flagship AS config (BM midprice + Poisson arrivals + exponential fill +
  limit-order dynamics + PnL), returning only the terminal
  ``(cash, inventory, price)``.  The PnL return telescopes to terminal
  mark-to-market, so :func:`as_mc_episode_stats` is exact without
  trajectories.
- K2 :func:`as_episode_trajectories` replaces
  ``as_episode_trajectories_pallas`` (``ops/pallas_episode.py:1074``): the
  same episode, streaming every step's post-step state (``emit="state"``),
  plus the PnL reward and the closed-form quotes (``"full"``), or all seven
  planes in one ``(7, T, N)`` buffer (``"container"``).
  :func:`as_episode_trajectory` is K2's fourth layout, which the rollout
  alone reaches: the time-major :class:`~mbt_gym_torch.types.Trajectory`
  written by the kernel itself, the function the JAX package computes as
  ``as_trajectory_from_pallas_full`` over the ``"full"`` streams.

Both are CUDA C++ kernels (``csrc/as_episode.cu``; the source note there
gives what bounds them on the H100 and what the design does about it), on
the step pipeline of ``csrc/step_pipeline.cuh`` below the wide shape's
threshold and one thread per env from there on (:func:`kernel_geometry`,
:func:`trajectory_geometry`).
Which path a call takes depends only on the device of its tensors: CPU
tensors run the plain version, CUDA tensors launch the kernel or raise.
The plain versions (:func:`as_episode_plain`,
:func:`as_episode_trajectories_plain`, :func:`as_episode_trajectory_plain`)
run on any device; on the card they are what the kernels are held against.

Noise: ``noise`` is ``(run_steps, 5, N)`` float32 channels (arrival-bid u,
arrival-ask u, fill-bid u, fill-ask u, midprice normal), as the JAX kernel's
noise mode takes them.  Without it, native mode draws from Philox4x32-10
keyed by ``(seed, env)`` with counter ``(step, draw)``;
:func:`philox_noise` reproduces that stream bit for bit in PyTorch, so the
plain version and the kernel see the same uniforms on any device.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from mbt_gym_torch.env import EnvConfig, resolve_device
from mbt_gym_torch.ops import _build
from mbt_gym_torch.ops.step_pipeline import PipelineGeometry, pipeline_geometry
from mbt_gym_torch.types import Trajectory, TrajectoryT

CONTAINER_PLANES = 7  # cash, inventory, time, price, bid, ask, reward
_EMITS = {"state": 0, "full": 1, "container": 2}  # K2's public modes; 3 is the trajectory layout
# Container planes each emit mode returns, in its return order.
_EMIT_PLANES = {"state": (0, 1, 3), "full": (0, 1, 3, 6, 4, 5)}


class AsEpisodeParams(NamedTuple):
    """Scalars of one AS episode.  A late ``start_time`` runs the
    correspondingly shorter episode."""

    n_steps: int
    dt: float
    drift: float
    volatility: float
    initial_price: float
    intensity_bid: float
    intensity_ask: float
    fill_exponent: float
    max_inventory: float
    terminal_time: float
    risk_aversion: float  # 0 => fixed risk-neutral quotes 1/k
    initial_cash: float = 0.0
    initial_inventory: float = 0.0
    start_time: float = 0.0
    max_cash: float = math.inf  # env.step's cash clip bound (rarely binds)

    @property
    def run_steps(self) -> int:
        """Steps actually executed (a late fixed start shortens the episode,
        TradingEnvironment.py:218-220 / rollout._episode_steps)."""
        return self.n_steps - round(self.start_time / self.dt)


def params_from_config(cfg: EnvConfig, risk_aversion: float = 0.1) -> AsEpisodeParams:
    from mbt_gym_torch.dynamics import LimitOrderDynamics
    from mbt_gym_torch.processes.arrivals import PoissonArrivals
    from mbt_gym_torch.processes.fills import ExponentialFill
    from mbt_gym_torch.processes.midprice import BrownianMotionMidprice
    from mbt_gym_torch.rewards import PnL

    d = cfg.dynamics
    # exact 2-action limit-order contract: gate on action_dim too, so a
    # subclass with market orders cannot run here with them ignored
    assert isinstance(d, LimitOrderDynamics) and d.action_dim == 2, (
        "episode kernel: pure limit-order dynamics only (lam's market "
        "orders are not simulated by this kernel)"
    )
    assert isinstance(d.midprice_model, BrownianMotionMidprice), (
        "episode kernel: Brownian-motion midprice only"
    )
    assert isinstance(d.arrival_model, PoissonArrivals), "episode kernel: Poisson arrivals only"
    assert isinstance(d.fill_probability_model, ExponentialFill), (
        "episode kernel: exponential fills only"
    )
    assert isinstance(cfg.reward_function, PnL), "episode return telescopes only for PnL"
    assert not cfg.normalise_action_space and not cfg.normalise_observation_space, (
        "episode kernel: the closed-form quotes and the streamed state are "
        "raw units; normalised action/observation spaces run on the engine"
    )
    assert not isinstance(cfg.initial_inventory, tuple) and not callable(cfg.initial_inventory), (
        "episode kernel: deterministic scalar initial inventory only"
    )
    assert not isinstance(cfg.start_time, tuple) and not callable(cfg.start_time), (
        "episode kernel: fixed start time only"
    )
    assert cfg.dtype == "float32", (
        "the episode kernel computes in float32; float64 reference-parity "
        "configs must use the engine rollout"
    )
    assert cfg.reward_scaling is None, (
        "reward_scaling is an engine feature; the kernel's telescoped "
        "PnL assumes unscaled rewards"
    )
    return AsEpisodeParams(
        n_steps=cfg.n_steps,
        dt=cfg.step_size,
        drift=d.midprice_model.drift,
        volatility=d.midprice_model.volatility,
        initial_price=d.midprice_model.initial_price,
        intensity_bid=d.arrival_model.intensity[0],
        intensity_ask=d.arrival_model.intensity[1],
        fill_exponent=d.fill_probability_model.fill_exponent,
        max_inventory=float(cfg.max_inventory),
        terminal_time=cfg.terminal_time,
        risk_aversion=risk_aversion,
        initial_cash=float(cfg.initial_cash),
        initial_inventory=float(cfg.initial_inventory),
        start_time=round(float(cfg.start_time) / cfg.step_size) * cfg.step_size,
        max_cash=float(cfg.resolved_max_cash()),
    )


# ------------------------------------------------------------------ constants
class AsKernelParams(ctypes.Structure):
    """float32 step constants, shared by the plain version and the kernel
    (``struct AsKernelParams`` in ``csrc/as_episode.cu``).  Each is the
    float32 rounding of the double computed here, as the JAX kernel's
    Python-float constants are rounded where they meet float32 arrays."""

    _fields_ = [
        ("run_steps", ctypes.c_int),
        ("risk_averse", ctypes.c_int),
        ("start_time", ctypes.c_float),
        ("dt", ctypes.c_float),
        ("terminal_time", ctypes.c_float),
        ("p_arr_bid", ctypes.c_float),
        ("p_arr_ask", ctypes.c_float),
        ("neg_k", ctypes.c_float),
        ("max_inventory", ctypes.c_float),
        ("max_cash", ctypes.c_float),
        ("drift_dt", ctypes.c_float),
        ("vol_sqrt_dt", ctypes.c_float),
        ("initial_cash", ctypes.c_float),
        ("initial_inventory", ctypes.c_float),
        ("initial_price", ctypes.c_float),
        ("gss", ctypes.c_float),
        ("half_gss", ctypes.c_float),
        ("const_half", ctypes.c_float),
        ("pipe", PipelineGeometry),  # set by each wrapper (kernel_geometry, trajectory_geometry)
    ]


def kernel_params(p: AsEpisodeParams) -> AsKernelParams:
    gamma, sigma, k = p.risk_aversion, p.volatility, p.fill_exponent
    gss = gamma * sigma * sigma
    if gamma > 0:
        const_half = (1.0 / gamma) * math.log(1.0 + gamma / k)
    else:
        const_half = 1.0 / k
    return AsKernelParams(
        run_steps=p.run_steps,
        risk_averse=int(gamma > 0),
        start_time=p.start_time,
        dt=p.dt,
        terminal_time=p.terminal_time,
        p_arr_bid=p.intensity_bid * p.dt,
        p_arr_ask=p.intensity_ask * p.dt,
        neg_k=-k,
        max_inventory=p.max_inventory,
        max_cash=p.max_cash,
        drift_dt=p.drift * p.dt,
        vol_sqrt_dt=p.volatility * math.sqrt(p.dt),
        initial_cash=p.initial_cash,
        initial_inventory=p.initial_inventory,
        initial_price=p.initial_price,
        gss=gss,
        half_gss=0.5 * gss,
        const_half=const_half,
    )


# ------------------------------------------------------------- native noise
_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit halves of ``m * x`` for ``x`` in [0, 2^32), exact in
    int64 by splitting ``x`` into 16-bit halves (no product exceeds 2^50)."""
    p_lo = m * (x & 0xFFFF)
    p_hi = m * (x >> 16)
    mid = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (mid >> 32), mid & _MASK32


def philox4x32_10(counter, key):
    """Philox4x32-10 (Salmon et al., SC'11) on int64 tensors holding uint32
    values; ``counter`` is 4 and ``key`` 2 broadcastable tensors or ints."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _MASK32
            k1 = (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _uniform24(bits: torch.Tensor) -> torch.Tensor:
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _philox_draw(seed: int, run_steps: int, num_trajectories: int, draw: int, device):
    """Philox4x32-10 keyed by ``(seed, env)`` at counter ``(step, draw)``
    for every (step, env): four ``(run_steps, N)`` int64 words."""
    steps = torch.arange(run_steps, dtype=torch.int64, device=device)[:, None]
    envs = torch.arange(num_trajectories, dtype=torch.int64, device=device)[None, :]
    zero = torch.zeros_like(steps)
    return philox4x32_10((steps, zero + draw, zero, zero), (int(seed) & _MASK32, envs))


def philox_normal(seed: int, run_steps: int, num_trajectories: int, device=None) -> torch.Tensor:
    """The kernels' native midprice normal as ``(run_steps, N)`` float32:
    Box-Muller on the first two words of counter ``(step, 1)`` — channel 4
    of :func:`philox_noise`, which the speed-dynamics kernels draw alone."""
    device = resolve_device(device)
    b = _philox_draw(seed, run_steps, num_trajectories, 1, device)
    u1 = 1.0 - _uniform24(b[0])  # (0, 1] so log is finite
    u2 = _uniform24(b[1])
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)


def philox_noise(seed: int, run_steps: int, num_trajectories: int, device=None) -> torch.Tensor:
    """The kernels' native noise as ``(run_steps, 5, N)`` float32 channels:
    Philox4x32-10 keyed by ``(seed, env)``, counter ``(step, 0)`` for the
    four arrival/fill uniforms and ``(step, 1)`` for the Box-Muller pair."""
    device = resolve_device(device)
    a = _philox_draw(seed, run_steps, num_trajectories, 0, device)
    normal = philox_normal(seed, run_steps, num_trajectories, device)
    return torch.stack([_uniform24(a[0]), _uniform24(a[1]), _uniform24(a[2]), _uniform24(a[3]), normal], dim=1)


# ------------------------------------------------------------ plain versions
def _step_time(kp: AsKernelParams, i: int) -> np.float32:
    return np.float32(kp.start_time) + np.float32(i) * np.float32(kp.dt)


def _as_step(kp: AsKernelParams, t: np.float32, draws, cash, inv, price):
    """One AS step in the kernel's float32 operation order
    (pallas_episode.py:133-173).  ``t`` is a float32 scalar."""
    u_ab, u_aa, u_fb, u_fa, normal = draws
    if kp.risk_averse:
        tau = np.float32(kp.terminal_time) - t
        half_spread = float(np.float32(kp.half_gss) * tau + np.float32(kp.const_half))
        skew = inv * kp.gss * float(tau)
        bid = skew + half_spread
        ask = -skew + half_spread
    else:
        bid = torch.full_like(cash, kp.const_half)
        ask = bid
    f32 = torch.float32
    arr_bid = (u_ab < kp.p_arr_bid).to(f32)
    arr_ask = (u_aa < kp.p_arr_ask).to(f32)
    fill_bid = (u_fb < torch.exp(kp.neg_k * bid)).to(f32)
    fill_ask = (u_fa < torch.exp(kp.neg_k * ask)).to(f32)
    fill_bid = fill_bid * (inv < kp.max_inventory).to(f32)
    fill_ask = fill_ask * (inv > -kp.max_inventory).to(f32)
    hit_bid = arr_bid * fill_bid
    hit_ask = arr_ask * fill_ask
    new_inv = inv + hit_bid - hit_ask
    cash = cash - hit_bid * (price - bid) + hit_ask * (price + ask)
    cash = torch.clamp(cash, -kp.max_cash, kp.max_cash)
    price = price + kp.drift_dt + kp.vol_sqrt_dt * normal
    return cash, new_inv, price, bid, ask


def _initial_state(kp: AsKernelParams, n: int, device):
    return tuple(
        torch.full((n,), v, dtype=torch.float32, device=device)
        for v in (kp.initial_cash, kp.initial_inventory, kp.initial_price)
    )


def _noise_or_native(p: AsEpisodeParams, seed, n, noise, device):
    if noise is None:
        return philox_noise(seed, p.run_steps, n, device)
    _check_noise(p, n, noise)
    return noise


def as_episode_plain(params: AsEpisodeParams, seed: int = 0, num_trajectories: int = 16384,
                     noise: Optional[torch.Tensor] = None, device=None):
    """Plain PyTorch K1 on any device: terminal ``(cash, inventory, price)``."""
    device = noise.device if noise is not None else resolve_device(device)
    kp = kernel_params(params)
    draws = _noise_or_native(params, seed, num_trajectories, noise, device)
    cash, inv, price = _initial_state(kp, num_trajectories, device)
    for i in range(kp.run_steps):
        cash, inv, price, _, _ = _as_step(kp, _step_time(kp, i), draws[i], cash, inv, price)
    return cash, inv, price


def as_episode_trajectories_plain(params: AsEpisodeParams, seed: int = 0,
                                  num_trajectories: int = 16384, emit: str = "state",
                                  noise: Optional[torch.Tensor] = None, device=None):
    """Plain PyTorch K2 on any device; returns what
    :func:`as_episode_trajectories` returns."""
    device = noise.device if noise is not None else resolve_device(device)
    assert emit in _EMITS, emit
    kp = kernel_params(params)
    n, T = num_trajectories, kp.run_steps
    draws = _noise_or_native(params, seed, n, noise, device)
    planes = torch.empty((CONTAINER_PLANES, T, n), dtype=torch.float32, device=device)
    cash, inv, price = _initial_state(kp, n, device)
    prev_value = cash + inv * price
    for i in range(T):
        t = _step_time(kp, i)
        cash, inv, price, bid, ask = _as_step(kp, t, draws[i], cash, inv, price)
        value = cash + inv * price
        planes[0, i], planes[1, i], planes[2, i] = cash, inv, float(t + np.float32(kp.dt))
        planes[3, i], planes[4, i], planes[5, i] = price, bid, ask
        planes[6, i] = value - prev_value
        prev_value = value
    if emit == "container":
        return planes
    return tuple(planes[c] for c in _EMIT_PLANES[emit])


def as_episode_trajectory_plain(params: AsEpisodeParams, seed: int = 0, num_trajectories: int = 16384,
                                noise: Optional[torch.Tensor] = None, device=None) -> Trajectory:
    """Plain PyTorch version of K2's trajectory layout on any device: the
    layout of the ``emit="full"`` streams (:func:`as_trajectory_from_full`)."""
    streams = as_episode_trajectories_plain(params, seed, num_trajectories, "full", noise, device)
    return as_trajectory_from_full(params, streams)


# ------------------------------------------------------------ kernel wrappers
def _check_noise(p: AsEpisodeParams, n: int, noise: torch.Tensor) -> None:
    if noise.dtype != torch.float32 or tuple(noise.shape) != (p.run_steps, 5, n):
        raise ValueError(
            f"noise must be float32 of shape ({p.run_steps}, 5, {n}); got "
            f"{noise.dtype} {tuple(noise.shape)}"
        )


def _kernels() -> ctypes.CDLL:
    lib = _build.load("as_episode.cu")
    if not getattr(lib, "_mbt_declared", False):
        ptr, i32, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
        lib.mbt_as_episode.argtypes = [ptr, i32, i32, u32, ptr, ptr, ptr, ptr, ptr]
        lib.mbt_as_episode.restype = i32
        lib.mbt_as_episode_trajectories.argtypes = [
            ptr, i32, i32, u32, ptr, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
        ]
        lib.mbt_as_episode_trajectories.restype = i32
        lib.mbt_as_episode_trajectory.argtypes = [ptr, i32, i32, u32, ptr, ptr, ptr, ptr, ptr]
        lib.mbt_as_episode_trajectory.restype = i32
        lib._mbt_declared = True
    return lib


def _target(noise: Optional[torch.Tensor], device) -> torch.device:
    if noise is None:
        return resolve_device(device)
    if device is not None and torch.device(device).type != noise.device.type:
        raise ValueError(f"noise lives on {noise.device}, the call targets {device}")
    return noise.device


def _launch_args(p: AsEpisodeParams, n: int, noise, device: torch.device):
    if device.type != "cuda":
        raise ValueError(f"the episode kernels run on CUDA devices, not {device}")
    if noise is not None:
        _check_noise(p, n, noise)
        if not noise.is_contiguous():
            raise ValueError("noise must be contiguous")
    index, stream = _build.device_stream(device)
    return kernel_params(p), index, (None if noise is None else noise.data_ptr()), stream


def kernel_geometry(p: AsEpisodeParams, num_trajectories: int):
    """K1's step-pipeline geometry (:func:`pipeline_geometry`): limit
    dynamics, no table, the terminal state alone; the wide shape at wide
    calls."""
    return pipeline_geometry(num_trajectories, p.run_steps, "limit", "fixed", True)


def trajectory_geometry(p: AsEpisodeParams, num_trajectories: int):
    """K2's geometry, every output layout: limit dynamics, no table, a store
    per step, in the pipeline's "as streams" mode; the wide shape from K2's
    own threshold on (``step_pipeline.wide_min_envs("as streams")``)."""
    return pipeline_geometry(num_trajectories, p.run_steps, "limit", "fixed", False, mode="as streams")


def as_episode(params: AsEpisodeParams, seed: int = 0, num_trajectories: int = 16384,
               noise: Optional[torch.Tensor] = None, device=None):
    """K1: run one full episode for ``num_trajectories`` envs; returns the
    terminal ``(cash, inventory, price)``, each ``(N,)`` float32.

    ``noise`` (optional) injects the per-step draws; otherwise native
    Philox noise keyed by ``seed``.  On a CPU target this is
    :func:`as_episode_plain`; on CUDA it launches the kernel."""
    device = _target(noise, device)
    if device.type == "cpu":
        return as_episode_plain(params, seed, num_trajectories, noise, device)
    n = num_trajectories
    kp, index, noise_ptr, stream = _launch_args(params, n, noise, device)
    kp.pipe = kernel_geometry(params, n).ctypes()
    cash, inv, price = (torch.empty(n, dtype=torch.float32, device=device) for _ in range(3))
    rc = _kernels().mbt_as_episode(
        ctypes.byref(kp), index, n, int(seed) & _MASK32, noise_ptr,
        cash.data_ptr(), inv.data_ptr(), price.data_ptr(), stream,
    )
    if rc != 0:
        raise RuntimeError(f"as_episode kernel launch failed: CUDA error {rc}")
    _build.count_launch("as_episode")
    return cash, inv, price


def as_episode_trajectories(params: AsEpisodeParams, seed: int = 0,
                            num_trajectories: int = 16384, emit: str = "state",
                            noise: Optional[torch.Tensor] = None, device=None):
    """K2: the full AS episode with per-step streams of the post-step state.

    ``emit="state"``: ``(cash, inventory, price)``, each ``(T, N)``;
    ``"full"``: six streams ``(cash, inventory, price, reward, bid, ask)``
    (reward = PnL, bid/ask = the closed-form quotes of each step);
    ``"container"``: one ``(7, T, N)`` buffer in :data:`CONTAINER_PLANES`
    order (cash, inventory, time, price, bid, ask, reward).  Row ``t`` is
    the state AFTER step ``t``."""
    assert emit in _EMITS, emit
    device = _target(noise, device)
    if device.type == "cpu":
        return as_episode_trajectories_plain(params, seed, num_trajectories, emit, noise, device)
    n, T = num_trajectories, params.run_steps
    kp, index, noise_ptr, stream = _launch_args(params, n, noise, device)
    kp.pipe = trajectory_geometry(params, n).ctypes()
    if emit == "container":
        planes = torch.empty((CONTAINER_PLANES, T, n), dtype=torch.float32, device=device)
    else:
        planes = [
            torch.empty((T, n), dtype=torch.float32, device=device) if c in _EMIT_PLANES[emit] else None
            for c in range(CONTAINER_PLANES)
        ]
    ptrs = [None if x is None else x.data_ptr() for x in planes]
    rc = _kernels().mbt_as_episode_trajectories(
        ctypes.byref(kp), index, n, int(seed) & _MASK32, noise_ptr, _EMITS[emit], *ptrs, stream,
    )
    if rc != 0:
        raise RuntimeError(f"as_episode_trajectories kernel launch failed: CUDA error {rc}")
    _build.count_launch("as_episode_trajectories")
    if emit == "container":
        return planes
    return tuple(planes[c] for c in _EMIT_PLANES[emit])


def as_episode_trajectory(params: AsEpisodeParams, seed: int = 0, num_trajectories: int = 16384,
                          noise: Optional[torch.Tensor] = None, device=None) -> Trajectory:
    """K2's trajectory layout: the rollout's time-major
    :class:`~mbt_gym_torch.types.Trajectory` written by the kernel, with
    observations ``(T+1, N, 4)`` (cash, inventory, time, price; row 0 the
    initial state), actions ``(T, N, 2)`` (the closed-form bid and ask) and
    rewards ``(T, N)`` (PnL).  The same function as
    ``as_trajectory_from_full(params, as_episode_trajectories(..., emit="full"))``,
    bit for bit, without the layout copies.  On a CPU target this is
    :func:`as_episode_trajectory_plain`; on CUDA it launches K2."""
    device = _target(noise, device)
    if device.type == "cpu":
        return as_episode_trajectory_plain(params, seed, num_trajectories, noise, device)
    n, T = num_trajectories, params.run_steps
    kp, index, noise_ptr, stream = _launch_args(params, n, noise, device)
    kp.pipe = trajectory_geometry(params, n).ctypes()
    obs = torch.empty((T + 1, n, 4), dtype=torch.float32, device=device)
    actions = torch.empty((T, n, 2), dtype=torch.float32, device=device)
    rewards = torch.empty((T, n), dtype=torch.float32, device=device)
    rc = _kernels().mbt_as_episode_trajectory(
        ctypes.byref(kp), index, n, int(seed) & _MASK32, noise_ptr,
        obs.data_ptr(), actions.data_ptr(), rewards.data_ptr(), stream,
    )
    if rc != 0:
        raise RuntimeError(f"as_episode_trajectory kernel launch failed: CUDA error {rc}")
    _build.count_launch("as_episode_trajectories")
    return Trajectory(observations=obs, actions=actions, rewards=rewards)


# ------------------------------------------------------------ stats + views
def seed_from_key(key) -> int:
    """A 30-bit episode seed from an int seed or a ``torch.Generator``."""
    gen = key if isinstance(key, torch.Generator) else torch.Generator().manual_seed(int(key))
    return int(torch.randint(0, 2**30, (), generator=gen, device=gen.device))


def as_mc_episode_stats(cfg: EnvConfig, risk_aversion: float, key, episodes: int = 1,
                        device=None) -> dict:
    """Throughput-mode counterpart of :func:`mbt_gym_torch.rollout.mc_episode_stats`
    for the closed-form AS policy on K1: the same summary dict without
    trajectories.  mean_pnl/std_pnl come from the telescoped terminal
    mark-to-market; ``mean_spread`` is exact in closed form — the AS
    quoted spread depends on time alone (the inventory skew cancels in
    bid + ask)."""
    device = resolve_device(device)
    p = params_from_config(cfg, risk_aversion=risk_aversion)
    n = cfg.num_trajectories
    seed0 = seed_from_key(key)
    initial_value = p.initial_cash + p.initial_inventory * p.initial_price
    total = torch.zeros(4, dtype=torch.float32, device=device)
    for e in range(episodes):
        cash, inv, price = as_episode(p, seed0 + e, n, device=device)
        pnl = cash + inv * price - initial_value
        total += torch.stack([pnl.mean(), (pnl**2).mean(), inv.mean(), (inv**2).mean()])
    mean_r, mean_r2, mean_q, mean_q2 = total / episodes
    times = p.start_time + np.arange(p.run_steps) * p.dt
    if risk_aversion > 0:
        g, s2, k = risk_aversion, p.volatility**2, p.fill_exponent
        spread = g * s2 * (p.terminal_time - times) + (2.0 / g) * np.log1p(g / k)
    else:
        spread = np.full(p.run_steps, 2.0 / p.fill_exponent)
    return {
        "mean_pnl": mean_r,
        "std_pnl": torch.sqrt(torch.clamp(mean_r2 - mean_r**2, min=0.0)),
        "mean_terminal_inventory": mean_q,
        "std_terminal_inventory": torch.sqrt(torch.clamp(mean_q2 - mean_q**2, min=0.0)),
        "mean_spread": torch.tensor(float(np.mean(spread)), dtype=torch.float32, device=device),
        "episodes": episodes * n,
    }


def episode_stats_fused(params: AsEpisodeParams, seed: int = 0, num_trajectories: int = 16384,
                        noise: Optional[torch.Tensor] = None, device=None) -> dict:
    """Terminal-state summary stats from K1 (total PnL telescopes to
    terminal mark-to-market minus initial)."""
    cash, inv, price = as_episode(params, seed, num_trajectories, noise=noise, device=device)
    initial_value = params.initial_cash + params.initial_inventory * params.initial_price
    pnl = cash + inv * price - initial_value
    return {
        "mean_pnl": pnl.mean(),
        "std_pnl": pnl.std(correction=0),
        "mean_terminal_inventory": inv.mean(),
        "std_terminal_inventory": inv.std(correction=0),
    }


def _with_initial_row(x: torch.Tensor, v0: float) -> torch.Tensor:
    return torch.cat([torch.full((1, x.shape[1]), v0, dtype=x.dtype, device=x.device), x], dim=0)


def _observation_planes(params: AsEpisodeParams, cash, inv, price):
    T, n = cash.shape
    times = params.start_time + torch.arange(T + 1, dtype=cash.dtype, device=cash.device) * params.dt
    return (
        _with_initial_row(cash, params.initial_cash),
        _with_initial_row(inv, params.initial_inventory),
        times[:, None].expand(T + 1, n),
        _with_initial_row(price, params.initial_price),
    )


def as_trajectory_from_full(params: AsEpisodeParams, streams) -> Trajectory:
    """Time-major :class:`~mbt_gym_torch.types.Trajectory` from the
    ``emit="full"`` streams: rewards and actions come kernel-computed, so
    this is layout work only.  :func:`as_episode_trajectory` writes the same
    tensors from the kernel; this stays its plain version and serves the
    ``"full"`` streams' other callers."""
    cash, inv, price, reward, bid, ask = streams
    obs = torch.stack(_observation_planes(params, cash, inv, price), dim=2)
    return Trajectory(observations=obs, actions=torch.stack([bid, ask], dim=2), rewards=reward)


def as_trajectory_t_from_full(params: AsEpisodeParams, streams) -> TrajectoryT:
    """Feature-major :class:`~mbt_gym_torch.types.TrajectoryT` from the
    ``emit="full"`` streams."""
    cash, inv, price, reward, bid, ask = streams
    obs_t = torch.stack(_observation_planes(params, cash, inv, price), dim=0)  # (S, T+1, N)
    return TrajectoryT(observations_t=obs_t, actions_t=torch.stack([bid, ask], dim=0), rewards=reward)


def trajectory_planes_view(data: torch.Tensor) -> dict:
    """Named views into the ``emit="container"`` buffer ``data (7, T, N)``.
    Row t is the state AFTER step t; the t=0 observation is the config's
    known initial state."""
    return {
        "cash": data[0], "inventory": data[1], "time": data[2],
        "price": data[3], "bid": data[4], "ask": data[5], "reward": data[6],
    }
