"""Optimal-execution episode kernel K6 (counterpart of the OE part of
``mbt_gym_tpu/ops/pallas_episode.py``), beside its plain PyTorch version.

:func:`oe_episode` replaces ``oe_episode_pallas``
(``ops/pallas_episode.py:720``): one whole optimal-execution episode per
env — trading-speed dynamics against temporary and permanent impact, the
speed read from a per-step schedule — returning only the terminal
``(cash, inventory, price, permanent impact, sum q_t^2, sum speed_t*q_{t-1})``.
The CJ execution reward telescopes to those sums
(:func:`oe_rewards_from_terminal`), so :func:`oe_mc_episode_stats` needs
no trajectories.  CUDA C++ in ``csrc/oe_episode.cu`` (its source note
gives what bounds it on the H100), on the step pipeline of
``csrc/step_pipeline.cuh`` with the geometry of :func:`kernel_geometry`.

Noise: ``noise`` is ``(T, N)`` float32 midprice normals, as the JAX
kernel's noise mode takes them.  Without it, native mode draws the normal
of :func:`mbt_gym_torch.ops.episode.philox_normal` — the same stream as
channel 4 of the other episode kernels' native noise.

Which path a call takes depends only on the device of its tensors: CPU
tensors run :func:`oe_episode_plain`, CUDA tensors launch the kernel or
raise.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from mbt_gym_torch.env import EnvConfig, resolve_device
from mbt_gym_torch.ops import _build
from mbt_gym_torch.ops.episode import _MASK32, _target, philox_normal, seed_from_key
from mbt_gym_torch.ops.step_pipeline import PipelineGeometry, pipeline_geometry


class OeEpisodeParams(NamedTuple):
    """Scalars of the optimal-execution episode (TradingWithSpeed dynamics,
    ModelDynamics.py:243-275 + TemporaryAndPermanentPriceImpact,
    price_impact_models.py:64-96 + CjOeCriterion, RewardFunctions.py:39-74)."""

    n_steps: int
    dt: float
    drift: float
    volatility: float
    initial_price: float
    temporary_impact: float
    permanent_impact: float
    terminal_time: float
    phi: float  # per-step inventory aversion
    alpha: float  # terminal aversion (spread pathwise over steps)
    initial_cash: float = 0.0
    initial_inventory: float = 0.0
    start_time: float = 0.0
    max_inventory: float = math.inf  # env.step's clip bounds (rarely bind)
    max_cash: float = math.inf

    @property
    def run_steps(self) -> int:
        return self.n_steps - round(self.start_time / self.dt)


def oe_params_from_config(cfg: EnvConfig) -> OeEpisodeParams:
    """pallas_episode.py:607-646: ``AssertionError`` on any feature outside
    the kernel's contract."""
    from mbt_gym_torch.dynamics import TradingWithSpeedDynamics
    from mbt_gym_torch.processes.impact import TemporaryAndPermanentImpact
    from mbt_gym_torch.processes.midprice import BrownianMotionMidprice
    from mbt_gym_torch.rewards import CjOeCriterion

    d = cfg.dynamics
    assert isinstance(d, TradingWithSpeedDynamics), "OE kernel: speed dynamics only"
    assert isinstance(d.midprice_model, BrownianMotionMidprice), "OE kernel: Brownian-motion midprice only"
    assert isinstance(d.price_impact_model, TemporaryAndPermanentImpact), (
        "OE kernel: temporary-and-permanent impact only"
    )
    r = cfg.reward_function
    assert isinstance(r, CjOeCriterion) and r.inventory_exponent == 2.0, (
        "OE kernel: the CJ execution criterion with inventory exponent 2 only"
    )
    assert not cfg.normalise_action_space and not cfg.normalise_observation_space, (
        "OE kernel: the schedule and the terminal state are raw units; normalised "
        "spaces run on the engine"
    )
    assert not isinstance(cfg.initial_inventory, tuple) and not callable(cfg.initial_inventory), (
        "OE kernel: deterministic scalar initial inventory only"
    )
    assert not isinstance(cfg.start_time, tuple) and not callable(cfg.start_time), (
        "OE kernel: fixed start time only"
    )
    assert cfg.dtype == "float32", (
        "the OE episode kernel computes in float32; float64 reference-parity "
        "configs must use the engine rollout"
    )
    assert cfg.reward_scaling is None, (
        "reward_scaling is an engine feature; the kernel's telescoped reward "
        "assumes unscaled rewards"
    )
    return OeEpisodeParams(
        n_steps=cfg.n_steps,
        dt=cfg.step_size,
        drift=d.midprice_model.drift,
        volatility=d.midprice_model.volatility,
        initial_price=d.midprice_model.initial_price,
        temporary_impact=d.price_impact_model.temporary_impact_coefficient,
        permanent_impact=d.price_impact_model.permanent_impact_coefficient,
        terminal_time=cfg.terminal_time,
        phi=r.per_step_inventory_aversion,
        alpha=r.terminal_inventory_aversion,
        initial_cash=float(cfg.initial_cash),
        initial_inventory=float(cfg.initial_inventory),
        start_time=round(float(cfg.start_time) / cfg.step_size) * cfg.step_size,
        max_inventory=float(cfg.max_inventory),
        max_cash=float(cfg.resolved_max_cash()),
    )


class OeKernelParams(ctypes.Structure):
    """float32 step constants shared by the plain version and the kernel,
    then the kernel's step-pipeline geometry (``struct OeKernelParams`` in
    ``csrc/oe_episode.cu``)."""

    _fields_ = [
        ("run_steps", ctypes.c_int),
        ("dt", ctypes.c_float),
        ("temporary_impact", ctypes.c_float),
        ("permanent_impact", ctypes.c_float),
        ("max_inventory", ctypes.c_float),
        ("max_cash", ctypes.c_float),
        ("drift_dt", ctypes.c_float),
        ("vol_sqrt_dt", ctypes.c_float),
        ("initial_cash", ctypes.c_float),
        ("initial_inventory", ctypes.c_float),
        ("initial_price", ctypes.c_float),
        ("pipe", PipelineGeometry),
    ]


def kernel_geometry(p: OeEpisodeParams, num_trajectories: int):
    """K6's step-pipeline geometry (:func:`pipeline_geometry`): speed
    dynamics (the midprice normal alone), no table, the terminal state
    alone; the wide shape at wide calls."""
    return pipeline_geometry(num_trajectories, p.run_steps, "speed", "schedule", True)


def kernel_params(p: OeEpisodeParams) -> OeKernelParams:
    return OeKernelParams(
        run_steps=p.run_steps,
        dt=p.dt,
        temporary_impact=p.temporary_impact,
        permanent_impact=p.permanent_impact,
        max_inventory=p.max_inventory,
        max_cash=p.max_cash,
        drift_dt=p.drift * p.dt,
        vol_sqrt_dt=p.volatility * math.sqrt(p.dt),
        initial_cash=p.initial_cash,
        initial_inventory=p.initial_inventory,
        initial_price=p.initial_price,
    )


def _check_call(p: OeEpisodeParams, speed_table: torch.Tensor, n: int, noise) -> None:
    T = p.run_steps
    assert tuple(speed_table.shape) == (T,), (tuple(speed_table.shape), T)
    if noise is not None and (noise.dtype != torch.float32 or tuple(noise.shape) != (T, n)):
        raise ValueError(
            f"noise must be float32 of shape ({T}, {n}); got {noise.dtype} {tuple(noise.shape)}"
        )


def oe_episode_plain(p: OeEpisodeParams, speed_table, seed: int = 0, num_trajectories: int = 8192,
                     noise: Optional[torch.Tensor] = None, device=None):
    """Plain PyTorch K6 on any device, in the kernel's float32 operation
    order (pallas_episode.py:649-664); returns what :func:`oe_episode`
    returns."""
    device = noise.device if noise is not None else resolve_device(device)
    n = num_trajectories
    speed_table = torch.as_tensor(speed_table, dtype=torch.float32, device=device)
    _check_call(p, speed_table, n, noise)
    kp = kernel_params(p)
    normals = philox_normal(seed, kp.run_steps, n, device) if noise is None else noise
    f32 = torch.float32
    cash = torch.full((n,), kp.initial_cash, dtype=f32, device=device)
    inv = torch.full((n,), kp.initial_inventory, dtype=f32, device=device)
    price = torch.full((n,), kp.initial_price, dtype=f32, device=device)
    perm, sumq2, sum_sq = (torch.zeros((n,), dtype=f32, device=device) for _ in range(3))
    for i in range(kp.run_steps):
        speed = speed_table[i]
        exec_price = price + kp.temporary_impact * speed + perm
        cash = cash - speed * kp.dt * exec_price
        sum_sq = sum_sq + speed * inv  # speed * PRE-step inventory (the CjOe term)
        inv = inv + speed * kp.dt
        inv = torch.clamp(inv, -kp.max_inventory, kp.max_inventory)
        cash = torch.clamp(cash, -kp.max_cash, kp.max_cash)
        sumq2 = sumq2 + inv * inv  # post-update inventory
        perm = perm + kp.permanent_impact * speed * kp.dt
        price = price + kp.drift_dt + kp.vol_sqrt_dt * normals[i]
    return cash, inv, price, perm, sumq2, sum_sq


def _kernels() -> ctypes.CDLL:
    lib = _build.load("oe_episode.cu")
    if not getattr(lib, "_mbt_declared", False):
        ptr, i32, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
        lib.mbt_oe_episode.argtypes = [ptr, i32, i32, u32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr]
        lib.mbt_oe_episode.restype = i32
        lib._mbt_declared = True
    return lib


def oe_episode(p: OeEpisodeParams, speed_table, seed: int = 0, num_trajectories: int = 8192,
               noise: Optional[torch.Tensor] = None, device=None):
    """K6: one whole OE episode for ``num_trajectories`` envs; returns the
    terminal ``(cash, inventory, price, permanent_impact, sum q_t^2,
    sum speed_t*q_{t-1})``, each ``(N,)`` float32.  ``speed_table`` is
    ``(run_steps,)`` (:func:`oe_speed_table`); ``noise`` (optional) injects
    the ``(run_steps, N)`` midprice normals, otherwise native Philox noise
    keyed by ``seed``.  On a CPU target this is :func:`oe_episode_plain`; on
    CUDA it launches the kernel."""
    device = _target(noise, device)
    if device.type == "cpu":
        return oe_episode_plain(p, speed_table, seed, num_trajectories, noise, device)
    if device.type != "cuda":
        raise ValueError(f"the OE episode kernel runs on CUDA devices, not {device}")
    n = num_trajectories
    speed_table = torch.as_tensor(speed_table, dtype=torch.float32, device=device).contiguous()
    _check_call(p, speed_table, n, noise)
    if noise is not None and not noise.is_contiguous():
        raise ValueError("noise must be contiguous")
    kp = kernel_params(p)
    kp.pipe = kernel_geometry(p, n).ctypes()
    outs = tuple(torch.empty(n, dtype=torch.float32, device=device) for _ in range(6))
    index, stream = _build.device_stream(device)
    rc = _kernels().mbt_oe_episode(
        ctypes.byref(kp), index, n, int(seed) & _MASK32,
        None if noise is None else noise.data_ptr(), speed_table.data_ptr(),
        *(o.data_ptr() for o in outs), stream,
    )
    if rc != 0:
        raise RuntimeError(f"oe_episode kernel launch failed: CUDA error {rc}")
    _build.count_launch("oe_episode")
    return outs


def oe_speed_table(cfg: EnvConfig, agent) -> torch.Tensor:
    """The CJ-OE closed-form speed schedule on the step grid, ``(run_steps,)``
    rows from the (quantised) start time (pallas_episode.py:774-786): the
    schedule kind's table (:func:`~mbt_gym_torch.ops.det_rollout.schedule_table_from_policy`),
    so the two OE lanes read the same speeds."""
    from mbt_gym_torch.ops.det_rollout import schedule_table_from_policy

    p = oe_params_from_config(cfg)
    full = schedule_table_from_policy(cfg, agent.policy())  # (n_steps, 1)
    return full[p.n_steps - p.run_steps:, 0]


def oe_rewards_from_terminal(p: OeEpisodeParams, cash, inv, price, sumq2, sum_sq):
    """Total CjOe episode reward from K6's terminal state
    (pallas_episode.py:789-800): the PnL telescopes to terminal minus
    initial mark-to-market, the running penalty is ``phi*dt*sum q_t^2`` and
    the pathwise terminal term is ``alpha*dt*(2*sum speed_t*q_{t-1} +
    run_steps*q0^2*T_ep)``.  A telescoped identity: in float32 it agrees
    with the engine's per-step sum to summation-order noise, not bitwise."""
    initial_value = p.initial_cash + p.initial_inventory * p.initial_price
    pnl = cash + inv * price - initial_value
    episode_length = p.terminal_time - p.start_time
    const = p.run_steps * (p.initial_inventory**2) * episode_length
    return pnl - p.phi * p.dt * sumq2 - p.alpha * p.dt * (2.0 * sum_sq + const)


def oe_episode_rewards(cfg: EnvConfig, agent, seed: int = 0, num_trajectories: int = 8192,
                       noise: Optional[torch.Tensor] = None, device=None) -> torch.Tensor:
    """Total CjOe episode rewards ``(N,)`` of the closed-form schedule on K6
    (pallas_episode.py:803-811)."""
    p = oe_params_from_config(cfg)
    table = oe_speed_table(cfg, agent)
    return oe_rewards_from_terminal(p, *_terminal(oe_episode(p, table, seed, num_trajectories, noise, device)))


def _terminal(outs):
    cash, inv, price, _, sumq2, sum_sq = outs
    return cash, inv, price, sumq2, sum_sq


def oe_mc_episode_stats(cfg: EnvConfig, agent, key, episodes: int = 1, device=None) -> dict:
    """Throughput-mode :func:`mbt_gym_torch.rollout.mc_episode_stats` for the
    closed-form CJ-OE schedule on K6 (pallas_episode.py:522-557).
    ``mean_spread`` is NaN: speed dynamics have a 1-column action."""
    from mbt_gym_torch.ops.det_rollout import _summary

    device = resolve_device(device)
    p = oe_params_from_config(cfg)
    table = oe_speed_table(cfg, agent).to(device)
    n = cfg.num_trajectories
    seed0 = seed_from_key(key)
    total = torch.zeros(4, dtype=torch.float32, device=device)
    for e in range(episodes):
        terminal = _terminal(oe_episode(p, table, seed0 + e, n, device=device))
        r = oe_rewards_from_terminal(p, *terminal)
        inv = terminal[1]
        total += torch.stack([r.mean(), (r**2).mean(), inv.mean(), (inv**2).mean()])
    nan = torch.tensor(float("nan"), dtype=torch.float32, device=device)
    return _summary(total, episodes, n, nan)
