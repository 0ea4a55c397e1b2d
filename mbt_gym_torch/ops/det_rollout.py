"""Deterministic-policy rollout kernel K5 (counterpart of the deterministic
part of ``mbt_gym_tpu/ops/pallas_rollout.py``), beside its plain PyTorch
version.

K5 replaces ``_det_rollout_pallas`` (``ops/pallas_rollout.py:1876``),
which the JAX package reaches through ``table_rollout_pallas``,
``fixed_rollout_pallas`` and ``schedule_rollout_pallas``: one whole
episode per env with a deterministic policy fused into the env step, in one
CUDA kernel (``csrc/det_rollout.cu``; its source note gives what bounds it
on the H100 and what the design does about it).  The policy kinds:

- ``"table"``: the closed-form CJ depth table indexed by (time step,
  clipped inventory) — :class:`~mbt_gym_torch.agents.baseline.CarteaJaimungalMmAgent`;
- ``"fixed"``: a constant action — ``fixed_action_policy``;
- ``"schedule"``: one precomputed action row per step — any time-only
  policy, such as the CJ optimal-execution speed schedule.

Ported scope, the JAX kernel's whole deterministic contract: limit-order
dynamics with PnL, the pathwise CJ criterion (``CjMmCriterion``) or the
running inventory penalty, and trading-speed dynamics with PnL or the CJ
execution criterion, the exponential utility (``ExponentialUtility``,
terminal only) on both; for the fixed and schedule kinds also the
limit-and-market-order ("lam", 4 action columns, with the optional
market-order mask) and at-the-touch ("touch", 2 post columns) dynamics
with the market-making rewards; every midprice model (no fill-driven jump
on speed dynamics), linear and exact-probability Poisson and Hawkes
arrivals, exponential, triangular, power and exogenous-market-maker fills,
and the four impact models on speed dynamics — the plain processes (BM,
linear Poisson, exponential, temporary and permanent impact) on the
original instantiations, the composite stress family's fixed quotes on
lam (bench_suite config 14) on their own, any other on the general ones
(:mod:`~mbt_gym_torch.ops.proc_kinds`); any inventory exponent; a fixed
start time; a random initial inventory through the ``inv0`` plane
(streams mode).  :func:`det_rollout_params_from_config` raises
``AssertionError`` in the JAX kernel's words naming any other feature,
and the kernel wrappers refuse random start times and the table kind off
limit dynamics, as JAX's do.

Two output modes: streams — obs ``(T, S, N)``, actions ``(T, A, N)``, zero
log-probs and values and the rewards ``(T, N)``, plus the terminal
observation ``(S, N)`` with ``final_obs`` — or ``stats_only``: the
terminal cash, inventory and price and the per-env sums of rewards and
quoted spreads (bid + ask), each ``(N,)``.

Noise: ``noise`` is ``(T, p.n_channels, N)`` float32 in the JAX kernel's
deterministic channel layout (``n_noise_channels(a_dim, table=True)``):
arrival-bid u, arrival-ask u, fill-bid u, fill-ask u, midprice normal —
K1's layout, 5 channels, on the plain processes — then 2 exogenous
best-depth normals (exogenous-MM fills) and 1 second-midprice normal
(Heston, short-term alphas).  :func:`philox_noise` gives the native
stream; speed dynamics read the normals alone, touch dynamics leave the
fill uniforms unread.

Which path a call takes depends only on the device of its tensors: CPU
tensors run :func:`det_rollout_plain`, CUDA tensors launch the kernel or
raise.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from mbt_gym_torch.env import EnvConfig, resolve_device
from mbt_gym_torch.ops import _build
from mbt_gym_torch.ops import episode
from mbt_gym_torch.ops import proc_kinds as pk
from mbt_gym_torch.ops.episode import _MASK32, _step_time, _target, seed_from_key
from mbt_gym_torch.ops.step_pipeline import PipelineGeometry, pipeline_geometry
from mbt_gym_torch.utils.profiling import span

# Channel count of the deterministic layout on the plain processes: 4 env
# uniforms + the midprice normal (pallas_rollout.py:98-111 with table=True,
# no exo or second midprice state).
N_CHANNELS = 5
# action columns per dynamics kind (mbt_gym_tpu/dispatch.py:169)
ACTION_DIMS = {"limit": 2, "lam": 4, "touch": 2, "speed": 1}
_DYNAMICS = {"limit": 0, "speed": 1, "lam": 2, "touch": 3}
_POLICIES = {"table": 0, "fixed": 1, "schedule": 2}
_REWARDS = {"pnl": 0, "cjmm": 1, "running": 2, "cjoe": 3, "exp_utility": 4}
_MAX_S = 16
_MAX_A = 4

# The H100's device memory, the streams-mode limit when a decision is
# inspected from a host without the card.
H100_MEMORY_BYTES = 80 * 1000**3


class DetRolloutParams(NamedTuple):
    """Static scalars of a deterministic-policy episode: the fields of the
    JAX package's ``MlpRolloutParams`` that the ported kinds read, with the
    same names and values."""

    n_steps: int
    dt: float
    drift: float
    volatility: float
    initial_price: float
    intensity_bid: float
    intensity_ask: float
    fill_exponent: float
    max_inventory: float
    max_cash: float
    initial_cash: float
    initial_inventory: float
    start_time: float
    obs_low: tuple  # (S,) cash, inventory, time, price, then the process states
    obs_grad: tuple  # (high - low) / 2 per channel
    act_low: tuple  # (A,) bid/ask depth (limit) or speed (speed) lower bounds
    act_grad: tuple
    normalise_obs: bool
    normalise_act: bool
    reward_kind: str = "pnl"  # "pnl" | "cjmm" | "running" | "cjoe" | "exp_utility"
    phi: float = 0.0  # per-step inventory aversion
    alpha: float = 0.0  # terminal inventory aversion
    # reference semantics: inventory**exp, NaN on a negative inventory with
    # a fractional exponent, as in the engine
    inventory_exponent: float = 2.0
    terminal_time: float = 1.0
    dynamics_kind: str = "limit"  # "limit" | "speed"
    temporary_impact: float = 0.0
    permanent_impact: float = 0.0
    policy_kind: str = "fixed"  # "table" | "fixed" | "schedule"
    fixed_action: tuple = ()
    table_size: int = 0  # "table": the true inventory-grid size 2*q_max + 1
    # () = deterministic initial_inventory; (lo, hi) = per-env integer draw
    # in [lo, hi), passed to the kernel as the inv0 plane
    inventory_range: tuple = ()
    # start_time=("uniform", lo, hi): carried as JAX carries it (start_time
    # 0.0, the full horizon); dispatch sends it to the engine and the
    # kernel wrappers refuse it
    random_start: bool = False
    fixed_half_spread: float = 0.0  # lam and touch
    risk_aversion: float = 0.0  # "exp_utility" only
    mask_mo_at_max_inventory: bool = False  # lam: EnvConfig's market-order mask
    # the process kinds, with the JAX names and meanings
    # (pallas_rollout.py:155-228; mbt_gym_torch/ops/proc_kinds.py)
    impact_kind: str = "temp_perm"  # "temp_perm" | "power" | "transient" | "temp_transient"
    impact_exponent: float = 1.0
    impact_kappa: float = 0.0
    impact_rho: float = 0.0
    impact_gamma: float = 0.0
    impact_initial: float = 0.0
    midprice_kind: str = "bm"
    mid_level: float = 0.0
    mid_speed: float = 0.0
    mid_dt_scaled: bool = False
    mid_jump: float = 0.0
    mid2_initial: float = 0.0
    mid2_level: float = 0.0
    mid2_speed: float = 0.0
    mid2_vol: float = 0.0
    mid2_dt_scaled: bool = False
    mid2_corr: float = 0.0
    arrival_kind: str = "poisson"
    hawkes_jump: float = 0.0
    hawkes_mean_reversion: float = 0.0
    fill_kind: str = "exp"
    fill_param: float = 0.0
    exo_kind: tuple = ()
    exo_level: tuple = ()
    exo_speed: tuple = ()
    exo_vol: tuple = ()
    exo_initial: tuple = ()
    exo_dt_scaled: tuple = ()
    exo_base_fill: float = 1.0

    @property
    def run_steps(self) -> int:
        return self.n_steps - round(self.start_time / self.dt)

    @property
    def a_dim(self) -> int:
        return ACTION_DIMS[self.dynamics_kind]

    @property
    def has_mid2(self) -> bool:
        return pk.has_mid2(self)

    @property
    def n_channels(self) -> int:
        """Noise-mode channels per step."""
        return N_CHANNELS + pk.extra_channels(self)


def dynamics_kind_of(d) -> str:
    """The dynamics kind of the rollout kernels K3 and K5
    (pallas_rollout.py:510-574)."""
    from mbt_gym_torch.dynamics import (
        AtTheTouchDynamics,
        LimitAndMarketOrderDynamics,
        LimitOrderDynamics,
        TradingWithSpeedDynamics,
    )

    if isinstance(d, AtTheTouchDynamics):
        return "touch"
    if isinstance(d, LimitAndMarketOrderDynamics):
        return "lam"
    if isinstance(d, LimitOrderDynamics) and d.action_dim == 2:
        return "limit"
    if isinstance(d, TradingWithSpeedDynamics):
        return "speed"
    raise AssertionError(
        "fused rollout: limit-order, limit-and-market-order, "
        "at-the-touch or trading-speed dynamics only"
    )


def reward_fields(r, dynamics_kind: str) -> tuple:
    """``(reward_kind, phi, alpha, risk_aversion)`` of the reward ``r`` on
    the dynamics kind, as the JAX kernels read them
    (pallas_rollout.py:295-318 for the market-making kinds, :548-563 on
    speed); ``AssertionError`` in their words for any other reward."""
    from mbt_gym_torch.rewards import CjMmCriterion, CjOeCriterion, ExponentialUtility, PnL, RunningInventoryPenalty

    if isinstance(r, PnL):
        return "pnl", 0.0, 0.0, 0.0
    if isinstance(r, ExponentialUtility):
        return "exp_utility", 0.0, 0.0, r.risk_aversion
    if dynamics_kind == "speed":
        if isinstance(r, CjOeCriterion):
            return "cjoe", r.per_step_inventory_aversion, r.terminal_inventory_aversion, 0.0
        raise AssertionError(
            f"fused rollout (speed dynamics) supports PnL / CjOeCriterion "
            f"/ ExponentialUtility; got {r}"
        )
    if isinstance(r, (CjMmCriterion, RunningInventoryPenalty)):
        kind = "cjmm" if isinstance(r, CjMmCriterion) else "running"
        return kind, r.per_step_inventory_aversion, r.terminal_inventory_aversion, 0.0
    raise AssertionError(
        f"fused rollout ({dynamics_kind} dynamics) supports PnL / CjMmCriterion / "
        f"RunningInventoryPenalty / ExponentialUtility; got {r}"
    )


def det_rollout_params_from_config(cfg: EnvConfig) -> DetRolloutParams:
    """The episode scalars of ``cfg`` (pallas_rollout.py:277-665, the kinds
    the JAX kernel takes); ``AssertionError`` in its words naming the first
    feature outside them.  The policy kind is set by
    :func:`cj_rollout_params`, :func:`fixed_rollout_params` or
    :func:`schedule_rollout_params`."""
    d = cfg.dynamics
    dynamics_kind = dynamics_kind_of(d)
    procs = pk.process_fields(d, dynamics_kind)
    half_spread = float(d.fixed_market_half_spread) if dynamics_kind in ("lam", "touch") else 0.0
    r = cfg.reward_function
    reward_kind, phi, alpha, gamma_u = reward_fields(r, dynamics_kind)
    assert cfg.reward_scaling is None, (
        "reward_scaling is an engine feature; the kernel's rewards are unscaled"
    )
    assert not callable(cfg.initial_inventory), (
        "callable initial_inventory is host-evaluated per reset; use the engine rollout"
    )
    if isinstance(cfg.initial_inventory, tuple):
        lo, hi = cfg.initial_inventory
        inventory_range, inv0 = (int(lo), int(hi)), 0.0
    else:
        inventory_range, inv0 = (), float(cfg.initial_inventory)
    assert not callable(cfg.start_time), (
        "callable start_time is host-evaluated per reset; use the engine rollout"
    )
    random_start = isinstance(cfg.start_time, tuple)
    if random_start:
        assert cfg.start_time[0] == "uniform", f"Unknown start_time spec {cfg.start_time}"
    start_time = 0.0 if random_start else round(float(cfg.start_time) / cfg.step_size) * cfg.step_size
    assert cfg.dtype == "float32", (
        "the deterministic-policy kernel computes in float32; float64 reference-parity "
        "configs must use the engine rollout"
    )
    obs_low, obs_high = cfg.observation_bounds()
    act_low, act_high = cfg.action_bounds()
    return DetRolloutParams(
        n_steps=cfg.n_steps,
        dt=cfg.step_size,
        max_inventory=float(cfg.max_inventory),
        max_cash=float(cfg.resolved_max_cash()),
        initial_cash=float(cfg.initial_cash),
        initial_inventory=inv0,
        start_time=start_time,
        obs_low=tuple(float(x) for x in obs_low),
        obs_grad=tuple(float(h - l) / 2.0 for l, h in zip(obs_low, obs_high)),
        act_low=tuple(float(x) for x in act_low),
        act_grad=tuple(float(h - l) / 2.0 for l, h in zip(act_low, act_high)),
        normalise_obs=bool(cfg.normalise_observation_space),
        normalise_act=bool(cfg.normalise_action_space),
        reward_kind=reward_kind,
        phi=phi,
        alpha=alpha,
        inventory_exponent=float(getattr(r, "inventory_exponent", 2.0)),
        terminal_time=cfg.terminal_time,
        dynamics_kind=dynamics_kind,
        inventory_range=inventory_range,
        random_start=random_start,
        fixed_half_spread=half_spread,
        risk_aversion=gamma_u,
        mask_mo_at_max_inventory=bool(cfg.mask_market_orders_at_max_inventory),
        **procs,
    )


def cj_rollout_params(cfg: EnvConfig, agent) -> DetRolloutParams:
    """The table kind for the closed-form CJ agent (pallas_rollout.py:2099)."""
    return det_rollout_params_from_config(cfg)._replace(
        policy_kind="table", table_size=2 * agent.max_inventory + 1
    )


def fixed_rollout_params(cfg: EnvConfig, fixed_action) -> DetRolloutParams:
    """The constant-action kind (pallas_rollout.py:2106): one float per
    action column, in the units the policy returns (normalised when
    ``cfg.normalise_action_space``)."""
    action = tuple(float(x) for x in np.asarray(fixed_action).reshape(-1))
    return det_rollout_params_from_config(cfg)._replace(policy_kind="fixed", fixed_action=action)


def schedule_rollout_params(cfg: EnvConfig) -> DetRolloutParams:
    """The per-step action-schedule kind (pallas_rollout.py:1839)."""
    return det_rollout_params_from_config(cfg)._replace(policy_kind="schedule")


def cj_depth_tables(agent):
    """(bid, ask) depth tables of a CJ agent, each ``(n_steps + 1, 2Q+1)``
    float32 numpy (pallas_rollout.py:2071-2096 without the TPU's lane
    padding: the kernel takes the row stride), copied from the agent's
    shared :meth:`~mbt_gym_torch.agents.baseline.CarteaJaimungalMmAgent.depth_table_f32`.
    The inventory-neutral agent (PnL reward) quotes the constant 1/kappa
    everywhere, as its engine policy does."""
    shape = (agent.n_steps + 1, 2 * agent.max_inventory + 1)
    if agent.inventory_neutral:
        neutral = np.full(shape, 1.0 / agent.kappa, np.float32)
        return neutral, neutral.copy()
    tbl = agent.depth_table_f32()  # (T+1, 2Q+1, 2)
    assert tbl.shape[:2] == shape
    return np.ascontiguousarray(tbl[..., 0]), np.ascontiguousarray(tbl[..., 1])


def schedule_table_from_policy(cfg: EnvConfig, policy) -> torch.Tensor:
    """A time-only policy evaluated on the episode step grid: the
    ``(n_steps, A)`` float32 action table of the schedule kind
    (pallas_rollout.py:1845-1861).  The policy sees observations whose
    non-time columns are zero (and ``state=None``); times are
    ``arange(n_steps) * step_size`` in float32.  Built on the CPU."""
    assert not cfg.normalise_observation_space, (
        "schedule tables are built from raw-time observations; the "
        "closed-form schedules run on unnormalised configs"
    )
    from mbt_gym_torch.types import TIME_INDEX

    times = torch.arange(cfg.n_steps, dtype=torch.float32) * cfg.step_size
    obs = torch.zeros((cfg.n_steps, cfg.state_dim), dtype=torch.float32)
    obs[:, TIME_INDEX] = times
    return torch.as_tensor(policy(None, obs, None), dtype=torch.float32)


@span("mbt.mem_query")
def device_free_bytes(device=None) -> int:
    """Bytes a new tensor on the CUDA ``device`` (default: the current one)
    can take: the free memory ``torch.cuda.mem_get_info`` reports plus the
    blocks PyTorch's caching allocator holds reserved and unused there,
    which cudaMemGetInfo counts as taken.  The H100's 80 GB when the target is
    not a visible card."""
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return H100_MEMORY_BYTES
    free, _ = torch.cuda.mem_get_info(device)
    return free + torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)


def det_streams_feasible(p: DetRolloutParams, num_trajectories: int, tables_bytes: int = 0,
                         device=None, free_bytes: Optional[int] = None) -> bool:
    """Whether a streams-mode rollout fits device memory: the kernel's
    ``(T, S + A + 3, N)`` float32 buffers (obs, actions, zero log-probs and
    values, rewards), the ``(S, N)`` terminal observation, the assembled
    ``(T + 1, N, S)`` observation tensor and the tables, against
    ``free_bytes`` (default: :func:`device_free_bytes` of ``device``).  The
    H100 streams to device memory, so unlike the TPU's VMEM rule this holds
    long horizons fused."""
    s_dim = len(p.obs_low)
    floats = p.run_steps * (s_dim + p.a_dim + 3) * num_trajectories
    floats += s_dim * num_trajectories + (p.run_steps + 1) * num_trajectories * s_dim
    if free_bytes is None:
        free_bytes = device_free_bytes(device)
    return 4 * floats + tables_bytes <= free_bytes


def q_pow(x, exponent: float):
    """The JAX kernels' inventory power (pallas_rollout.py:1142-1149):
    ``x * x`` for exponent 2, ``x`` for 1, else ``x ** exponent`` (NaN on a
    negative base with a fractional exponent, as in the reference)."""
    if exponent == 2.0:
        return x * x
    if exponent == 1.0:
        return x
    if isinstance(x, torch.Tensor):
        return x**exponent
    return np.power(x, np.float32(exponent))


def market_making_step(kind: str, kp, d, exe, cash, inv, price):
    """The unclipped ``(inventory, cash)`` after one step of the
    market-making dynamics ``kind`` (pallas_rollout.py:992-1052), in the
    kernels' float32 operation order, shared by the plain versions of K3
    and K5: ``kp`` holds the step constants (``p_arr_bid``, ``p_arr_ask``,
    ``neg_k``, ``max_inventory``, ``half_spread``, ``mask_mo``), ``d`` the
    step's channels (arrival-bid, arrival-ask, fill-bid, fill-ask
    uniforms first) and ``exe`` the executed action columns.  "limit":
    exponential fills at the quoted depths; "lam": unit market orders
    where a trigger column exceeds 0.5, at mid -/+ the half-spread, before
    the limit bookkeeping (blocked at the inventory bounds with
    ``mask_mo``); "touch": the post columns are the fills, at mid -/+ the
    half-spread.  Fills and market orders are masked on the pre-step
    inventory."""
    f32 = torch.float32
    arr_bid = (d[0] < kp.p_arr_bid).to(f32)
    arr_ask = (d[1] < kp.p_arr_ask).to(f32)
    can_buy = (inv < kp.max_inventory).to(f32)
    can_sell = (inv > -kp.max_inventory).to(f32)
    if kind == "touch":
        hit_bid = arr_bid * (exe[0] * can_buy)
        hit_ask = arr_ask * (exe[1] * can_sell)
        return inv + hit_bid - hit_ask, cash - hit_bid * (price - kp.half_spread) + hit_ask * (price + kp.half_spread)
    bid, ask = exe[0], exe[1]
    hit_bid = arr_bid * ((d[2] < torch.exp(kp.neg_k * bid)).to(f32) * can_buy)
    hit_ask = arr_ask * ((d[3] < torch.exp(kp.neg_k * ask)).to(f32) * can_sell)
    if kind == "limit":
        return inv + hit_bid - hit_ask, cash - hit_bid * (price - bid) + hit_ask * (price + ask)
    mo_buy = (exe[2] > 0.5).to(f32)
    mo_sell = (exe[3] > 0.5).to(f32)
    if kp.mask_mo:
        mo_buy = mo_buy * can_buy
        mo_sell = mo_sell * can_sell
    new_cash = (cash + mo_sell * (price - kp.half_spread) - mo_buy * (price + kp.half_spread)
                - hit_bid * (price - bid) + hit_ask * (price + ask))
    return inv + (mo_buy - mo_sell) + hit_bid - hit_ask, new_cash


# ------------------------------------------------------------ constants
class DetKernelParams(ctypes.Structure):
    """float32 step constants shared by the plain version and the kernel
    (``struct DetKernelParams`` in ``csrc/det_rollout.cu``).  Each float is
    the float32 rounding of the double computed here, as the JAX kernel's
    Python-float constants are rounded where they meet float32 arrays."""

    _fields_ = [
        ("run_steps", ctypes.c_int),
        ("t_off", ctypes.c_int),
        ("dynamics", ctypes.c_int),
        ("policy", ctypes.c_int),
        ("reward", ctypes.c_int),
        ("normalise_obs", ctypes.c_int),
        ("normalise_act", ctypes.c_int),
        ("s_dim", ctypes.c_int),
        ("a_dim", ctypes.c_int),
        ("q_max", ctypes.c_int),
        ("table_width", ctypes.c_int),
        ("start_time", ctypes.c_float),
        ("dt", ctypes.c_float),
        ("t_term", ctypes.c_float),
        ("obs_low", ctypes.c_float * _MAX_S),
        ("obs_grad", ctypes.c_float * _MAX_S),
        ("act_low", ctypes.c_float * _MAX_A),
        ("act_grad", ctypes.c_float * _MAX_A),
        ("fixed_action", ctypes.c_float * _MAX_A),
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
        ("temporary_impact", ctypes.c_float),
        ("permanent_impact", ctypes.c_float),
        ("dt_phi", ctypes.c_float),  # -risk_aversion under the exponential utility (no inventory terms)
        ("alpha", ctypes.c_float),
        ("dt_alpha", ctypes.c_float),
        ("cjmm_const", ctypes.c_float),
        ("ep_len", ctypes.c_float),
        ("inv_exp", ctypes.c_float),
        ("half_spread", ctypes.c_float),
        ("mask_mo", ctypes.c_int),
        ("proc_mode", ctypes.c_int),  # proc_kinds.proc_mode: the plain, general or composite instantiation
        ("proc", pk.ProcParams),
        ("pipe", PipelineGeometry),  # set by the kernel wrapper
    ]


def kernel_params(p: DetRolloutParams, table_width: int = 0) -> DetKernelParams:
    """The step constants of ``p`` (the JAX kernel's ``_rollout_step``,
    pallas_rollout.py:757-1196): ``dt*phi``, ``dt*alpha`` and
    ``alpha*dt/ep_len`` are formed in double, as the JAX kernel forms them
    from Python floats.  The exponential utility runs the general
    instantiation (the plain processes' bits are the same there), its
    ``-risk_aversion`` in ``dt_phi``."""
    utility = p.reward_kind == "exp_utility"
    ep_len = p.terminal_time - p.start_time
    s_dim, a_dim = len(p.obs_low), p.a_dim
    fixed = p.fixed_action + (0.0,) * (_MAX_A - len(p.fixed_action))
    return DetKernelParams(
        run_steps=p.run_steps,
        t_off=round(p.start_time / p.dt),
        dynamics=_DYNAMICS[p.dynamics_kind],
        policy=_POLICIES[p.policy_kind],
        reward=_REWARDS[p.reward_kind],
        normalise_obs=int(p.normalise_obs),
        normalise_act=int(p.normalise_act),
        s_dim=s_dim,
        a_dim=a_dim,
        q_max=(p.table_size - 1) // 2,
        table_width=table_width,
        start_time=p.start_time,
        dt=p.dt,
        t_term=p.start_time + p.run_steps * p.dt,
        obs_low=(ctypes.c_float * _MAX_S)(*p.obs_low),
        obs_grad=(ctypes.c_float * _MAX_S)(*p.obs_grad),
        act_low=(ctypes.c_float * _MAX_A)(*p.act_low),
        act_grad=(ctypes.c_float * _MAX_A)(*p.act_grad),
        fixed_action=(ctypes.c_float * _MAX_A)(*fixed[:_MAX_A]),
        p_arr_bid=pk.arrival_probability(p)[0],
        p_arr_ask=pk.arrival_probability(p)[1],
        neg_k=-p.fill_exponent,
        max_inventory=p.max_inventory,
        max_cash=p.max_cash,
        drift_dt=p.drift * p.dt,
        vol_sqrt_dt=p.volatility * math.sqrt(p.dt),
        initial_cash=p.initial_cash,
        initial_inventory=p.initial_inventory,
        initial_price=p.initial_price,
        temporary_impact=p.temporary_impact,
        permanent_impact=p.permanent_impact,
        dt_phi=-p.risk_aversion if utility else p.dt * p.phi,
        alpha=p.alpha,
        dt_alpha=p.dt * p.alpha,
        cjmm_const=p.alpha * p.dt / ep_len,
        ep_len=ep_len,
        inv_exp=p.inventory_exponent,
        half_spread=p.fixed_half_spread,
        mask_mo=int(p.mask_mo_at_max_inventory),
        proc_mode=pk.PROC_GENERAL if utility else pk.proc_mode(
            p, composite_ok=(p.dynamics_kind, p.policy_kind) == ("lam", "fixed")),
        proc=pk.proc_params(p, 0),
    )


def philox_noise(p: DetRolloutParams, seed: int, run_steps: int, num_trajectories: int, device=None) -> torch.Tensor:
    """The kernel's native noise as ``(run_steps, p.n_channels, N)``
    float32 channels: K1's five (:func:`mbt_gym_torch.ops.episode.philox_noise`:
    counter ``(step, 0)`` for the four uniforms, the first pair of counter
    ``(step, 1)`` for the midprice normal), then the extra normals from the
    same counter-1 call (:func:`mbt_gym_torch.ops.proc_kinds.philox_extras`):
    the exogenous bid's r0 sin theta0, the exogenous ask's r1 cos theta1 and
    the second midprice column's r1 sin theta1, (r1, theta1) from its third
    and fourth words."""
    device = resolve_device(device)
    base = episode.philox_noise(seed, run_steps, num_trajectories, device)
    if not pk.extra_channels(p):
        return base
    exo_bid, exo_ask, mid2 = pk.philox_extras(seed, run_steps, num_trajectories, device, 1, "zw")
    extra = ([exo_bid, exo_ask] if p.fill_kind == "exomm" else []) + ([mid2] if p.has_mid2 else [])
    return torch.cat([base, torch.stack(extra, dim=1)], dim=1)


# ------------------------------------------------------------ plain version
def _check_call(p: DetRolloutParams, tables, n: int, noise, inv0, stats_only: bool, final_obs: bool):
    """The JAX wrappers' argument contract (pallas_rollout.py:1704-1836)."""
    assert p.policy_kind in _POLICIES, p.policy_kind
    assert not p.random_start, (
        "random start times with a deterministic policy are unsupported by the kernel (the "
        "reference's CJ replication runs fixed-horizon episodes); run the engine"
    )
    assert not (stats_only and final_obs), "final_obs is a streams-mode output"
    T, t_off = p.run_steps, round(p.start_time / p.dt)
    if p.policy_kind == "table":
        bid, ask = tables
        assert p.table_size >= 1
        assert p.dynamics_kind == "limit", (
            "the closed-form depth-table policy quotes (bid, ask) limit depths — "
            "limit-order dynamics only (ModelDynamics.py:87-131)"
        )
        assert not p.normalise_act, (
            "closed-form depths are model units; the engine path never normalises "
            "closed-form actions either"
        )
        assert bid.shape == ask.shape and bid.dim() == 2
        assert bid.shape[0] >= t_off + T, (
            "depth table must cover every executed step's time index", tuple(bid.shape), T,
        )
        assert bid.shape[1] >= p.table_size
    elif p.policy_kind == "schedule":
        (table,) = tables
        assert table.dim() == 2 and table.shape[1] == p.a_dim, (
            f"action_table must be (steps, {p.a_dim}) for {p.dynamics_kind} dynamics; "
            f"got {tuple(table.shape)}"
        )
        assert table.shape[0] >= t_off + T, (
            "action table must cover every executed step's time index", tuple(table.shape), T,
        )
    else:
        assert len(p.fixed_action) == p.a_dim, (
            f"fixed_action has {len(p.fixed_action)} columns; {p.dynamics_kind} "
            f"dynamics takes {p.a_dim}"
        )
    if noise is not None and (noise.dtype != torch.float32 or tuple(noise.shape) != (T, p.n_channels, n)):
        raise ValueError(
            f"noise must be float32 of shape ({T}, {p.n_channels}, {n}); got "
            f"{noise.dtype} {tuple(noise.shape)}"
        )
    if p.inventory_range:
        assert inv0 is not None and tuple(inv0.shape) == (n,), "inventory_range set: pass inv0 (N,) draws"
    else:
        assert inv0 is None, "inv0 only valid with inventory_range"


def _plain_policy(p: DetRolloutParams, kp: DetKernelParams, tables, row: int, inv):
    """The raw action columns of one step (what the stream records)."""
    if p.policy_kind == "table":
        idx = torch.clamp(kp.q_max + inv, 0.0, 2.0 * kp.q_max).to(torch.int64)
        return [tables[0][row][idx], tables[1][row][idx]]
    if p.policy_kind == "schedule":
        return [tables[0][row, c].expand_as(inv) for c in range(kp.a_dim)]
    return [torch.full_like(inv, kp.fixed_action[c]) for c in range(kp.a_dim)]


def obs_planes(kp, t, planes) -> torch.Tensor:
    """The (S, N) observation of the state ``planes`` (cash, inventory,
    price, then the process states) at time ``t`` (a float, or an (N,)
    plane under K3's random start), normalised per the step constants
    ``kp`` (a tensor divisor: PyTorch's CUDA division by a Python scalar
    multiplies by its reciprocal, the kernels divide)."""
    cash, inv, price = planes[:3]
    time = t if isinstance(t, torch.Tensor) else torch.full_like(cash, t)
    out = [cash, inv, time, price, *planes[3:]]
    if kp.normalise_obs:
        out = [(x - kp.obs_low[c]) / torch.full_like(x, kp.obs_grad[c]) - 1.0 for c, x in enumerate(out)]
    return torch.stack(out)


def det_rollout_plain(p: DetRolloutParams, tables=(), seed: int = 0, num_trajectories: int = 16384,
                      noise: Optional[torch.Tensor] = None, inv0: Optional[torch.Tensor] = None,
                      stats_only: bool = False, final_obs: bool = False, device=None):
    """Plain PyTorch K5 on any device, in the kernel's float32 operation
    order; returns what :func:`det_rollout` returns.  ``tables``: the
    (bid, ask) depth tables for "table", the action table for "schedule",
    () for "fixed"."""
    device = noise.device if noise is not None else resolve_device(device)
    n = num_trajectories
    tables = tuple(torch.as_tensor(t, dtype=torch.float32, device=device) for t in tables)
    _check_call(p, tables, n, noise, inv0, stats_only, final_obs)
    kp = kernel_params(p, tables[0].shape[1] if p.policy_kind == "table" else 0)
    T, S, A = kp.run_steps, kp.s_dim, kp.a_dim
    draws = philox_noise(p, seed, T, n, device) if noise is None else noise
    pp = kp.proc
    names = pk.state_planes(p, speed=p.dynamics_kind == "speed")
    f32 = torch.float32
    cash = torch.full((n,), kp.initial_cash, dtype=f32, device=device)
    inv = torch.full((n,), kp.initial_inventory, dtype=f32, device=device) if inv0 is None else inv0.to(device, f32)
    e = kp.inv_exp
    q0 = q_pow(inv, e)
    price = torch.full((n,), kp.initial_price, dtype=f32, device=device)
    imp = torch.zeros((n,), dtype=f32, device=device)
    ps = pk.initial_planes(pp, names, cash)  # the general kinds' process states past the price
    speed_dyn = p.dynamics_kind == "speed"
    if stats_only:
        rsum, ssum = torch.zeros_like(cash), torch.zeros_like(cash)
    else:
        obs_out = torch.empty((T, S, n), dtype=f32, device=device)
        act_out = torch.empty((T, A, n), dtype=f32, device=device)
        rew_out = torch.empty((T, n), dtype=f32, device=device)
    for i in range(T):
        t = float(_step_time(kp, i))
        d = draws[i]
        raw = _plain_policy(p, kp, tables, kp.t_off + i, inv)
        if kp.normalise_act:
            exe = [(raw[c] + 1.0) * kp.act_grad[c] + kp.act_low[c] for c in range(A)]
        else:
            exe = raw
        if kp.proc_mode:  # the process states' planes, before the step
            planes = (cash, inv, price, *(ps[name] for name in names))
        else:
            planes = (cash, inv, price, imp) if speed_dyn else (cash, inv, price)
        hit_bid = hit_ask = None
        if speed_dyn:
            (speed,) = exe
            if kp.proc_mode:
                impact = pk.speed_impact(pp, kp, ps, speed)
            else:
                impact = kp.temporary_impact * speed + imp
                new_imp = imp + kp.permanent_impact * speed * kp.dt
            volume = speed * kp.dt
            new_inv = inv + volume
            new_cash = cash - volume * (price + impact)
        elif kp.proc_mode:
            new_inv, new_cash, hit_bid, hit_ask = pk.market_step(p.dynamics_kind, kp, pp, ps, d, exe, cash, inv,
                                                                 price)
        else:
            new_inv, new_cash = market_making_step(p.dynamics_kind, kp, d, exe, cash, inv, price)
        new_inv = torch.clamp(new_inv, -kp.max_inventory, kp.max_inventory)
        new_cash = torch.clamp(new_cash, -kp.max_cash, kp.max_cash)
        if kp.proc_mode:
            new_price = pk.midprice_update(pp, kp, ps, price, d[4], d[pp.ch_mid2] if pp.ch_mid2 >= 0 else None,
                                           hit_bid, hit_ask)
        else:
            new_price = price + kp.drift_dt + kp.vol_sqrt_dt * d[4]
        reward = (new_cash + new_inv * new_price) - (cash + inv * price)
        if p.reward_kind not in ("pnl", "exp_utility"):  # pallas_rollout.py:1150-1185, in its op order
            q_new = q_pow(new_inv, e)
        if p.reward_kind == "cjmm":
            reward = reward - kp.dt_phi * q_new - kp.alpha * (q_new - q_pow(inv, e)) - kp.cjmm_const * q0
        elif p.reward_kind == "running":
            terminal = 1.0 if i == T - 1 else 0.0
            reward = reward - kp.dt_phi * q_new - (kp.alpha * terminal) * q_new
        elif p.reward_kind == "cjoe":
            reward = reward - kp.dt_phi * q_new - kp.dt_alpha * (e * exe[0] * q_pow(inv, e - 1.0) + q0 * kp.ep_len)
        elif p.reward_kind == "exp_utility":  # pallas_rollout.py:1173-1179
            terminal = 1.0 if i == T - 1 else 0.0
            reward = terminal * -torch.exp(kp.dt_phi * (new_cash + new_inv * new_price))  # dt_phi: -gamma
        if stats_only:
            rsum = rsum + reward
            if A >= 2:
                ssum = ssum + (raw[0] + raw[1])
        else:
            obs_out[i] = obs_planes(kp, t, planes)
            for c in range(A):
                act_out[i, c] = raw[c]
            rew_out[i] = reward
        cash, inv, price = new_cash, new_inv, new_price
        if speed_dyn and not kp.proc_mode:
            imp = new_imp
    if stats_only:
        return cash, inv, price, rsum, ssum
    zeros = torch.zeros((T, n), dtype=f32, device=device)
    outs = (obs_out, act_out, zeros, zeros.clone(), rew_out)
    if final_obs:
        if kp.proc_mode:
            planes = (cash, inv, price, *(ps[name] for name in names))
        else:
            planes = (cash, inv, price, imp) if speed_dyn else (cash, inv, price)
        outs += (obs_planes(kp, kp.t_term, planes),)
    return outs


# ------------------------------------------------------------ kernel wrapper
class _DetBuffers(ctypes.Structure):
    """``struct DetBuffers`` in ``csrc/det_rollout.cu``: NULL where unused."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "noise", "inv0", "bid", "ask", "fill_bid", "fill_ask", "schedule",
        "obs", "act", "rew", "fin", "cash", "inv", "price", "rsum", "ssum",
    )]


def _kernels() -> ctypes.CDLL:
    lib = _build.load("det_rollout.cu")
    if not getattr(lib, "_mbt_declared", False):
        ptr, i32, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
        lib.mbt_det_rollout.argtypes = [ptr, ptr, i32, i32, u32, i32, ptr]
        lib.mbt_det_rollout.restype = i32
        lib._mbt_declared = True
    return lib


def kernel_geometry(p: DetRolloutParams, num_trajectories: int, stats_only: bool, table_width: int = 0):
    """The step pipeline's geometry (:func:`pipeline_geometry`) of one K5
    call: the table kind stages each step's rows of four tables (bid, ask
    and their fill probabilities), rows of ``table_width`` floats (default
    ``p.table_size``), where they fit.  K5 has no wide shape."""
    # lam and touch draw the limit kind's five channels; the general
    # instantiation (the general process kinds, the exponential utility)
    # stages 8 (the five, two exogenous normals, the second midprice
    # normal), or 2 on speed dynamics
    dynamics = "speed" if p.dynamics_kind == "speed" else "limit"
    general = not pk.is_plain(p) or p.reward_kind == "exp_utility"
    channels = (2 if dynamics == "speed" else 8) if general else None
    return pipeline_geometry(num_trajectories, p.run_steps, dynamics, p.policy_kind, stats_only,
                             table_width or p.table_size, table_rows=4, wide=False, channels=channels)


def det_rollout(p: DetRolloutParams, tables=(), seed: int = 0, num_trajectories: int = 16384,
                noise: Optional[torch.Tensor] = None, inv0: Optional[torch.Tensor] = None,
                stats_only: bool = False, final_obs: bool = False, device=None):
    """K5: one whole episode for ``num_trajectories`` envs under the
    deterministic policy ``p.policy_kind``.

    Streams mode returns ``(obs (T, S, N), actions (T, A, N), log_probs,
    values, rewards)`` — log-probs and values are zeros — plus the terminal
    observation ``(S, N)`` with ``final_obs``; ``stats_only`` returns the
    terminal ``(cash, inventory, price)`` and the per-env reward and
    quoted-spread sums, each ``(N,)``.  ``noise`` (optional) injects
    ``(T, 5, N)`` channels; otherwise native Philox noise keyed by
    ``seed``.  ``inv0`` is the per-env initial inventory under
    ``p.inventory_range``.  On a CPU target this is
    :func:`det_rollout_plain`; on CUDA it launches the kernel."""
    device = _target(noise, device)
    if device.type == "cpu":
        return det_rollout_plain(p, tables, seed, num_trajectories, noise, inv0, stats_only, final_obs, device)
    if device.type != "cuda":
        raise ValueError(f"the deterministic-policy kernel runs on CUDA devices, not {device}")
    n = num_trajectories
    tables = tuple(torch.as_tensor(t, dtype=torch.float32, device=device).contiguous() for t in tables)
    _check_call(p, tables, n, noise, inv0, stats_only, final_obs)
    if noise is not None and not noise.is_contiguous():
        raise ValueError("noise must be contiguous")
    if inv0 is not None:
        inv0 = inv0.to(device, torch.float32).contiguous()
    kp = kernel_params(p, tables[0].shape[1] if p.policy_kind == "table" else 0)
    T, S, A = kp.run_steps, kp.s_dim, kp.a_dim
    kp.pipe = kernel_geometry(p, n, stats_only, kp.table_width).ctypes()
    f32 = torch.float32
    buf = _DetBuffers(
        noise=None if noise is None else noise.data_ptr(),
        inv0=None if inv0 is None else inv0.data_ptr(),
    )
    if p.policy_kind == "table":
        buf.bid, buf.ask = tables[0].data_ptr(), tables[1].data_ptr()
        # scratch for the kernel's fill probabilities exp(-k * depth) of the rows it reads
        fill = torch.empty((2, *tables[0].shape), dtype=f32, device=device)
        buf.fill_bid, buf.fill_ask = fill[0].data_ptr(), fill[1].data_ptr()
    elif p.policy_kind == "schedule":
        buf.schedule = tables[0].data_ptr()
    if stats_only:
        outs = tuple(torch.empty(n, dtype=f32, device=device) for _ in range(5))
        buf.cash, buf.inv, buf.price, buf.rsum, buf.ssum = (o.data_ptr() for o in outs)
    else:
        obs = torch.empty((T, S, n), dtype=f32, device=device)
        act = torch.empty((T, A, n), dtype=f32, device=device)
        rew = torch.empty((T, n), dtype=f32, device=device)
        zeros = torch.zeros((T, n), dtype=f32, device=device)
        outs = (obs, act, zeros, zeros.clone(), rew)
        buf.obs, buf.act, buf.rew = obs.data_ptr(), act.data_ptr(), rew.data_ptr()
        if final_obs:
            fin = torch.empty((S, n), dtype=f32, device=device)
            buf.fin = fin.data_ptr()
            outs += (fin,)
    index, stream = _build.device_stream(device)
    rc = _kernels().mbt_det_rollout(
        ctypes.byref(kp), ctypes.byref(buf), index, n, int(seed) & _MASK32, int(stats_only), stream,
    )
    if rc != 0:
        raise RuntimeError(f"det_rollout kernel launch failed: CUDA error {rc}")
    _build.count_launch("det_rollout")
    return outs


def table_rollout(p: DetRolloutParams, bid_table, ask_table, seed: int = 0, num_trajectories: int = 16384,
                  noise=None, inv0=None, stats_only: bool = False, final_obs: bool = False, device=None):
    """K5 with the closed-form CJ depth-table policy
    (``table_rollout_pallas``, pallas_rollout.py:1652): ``bid_table`` /
    ``ask_table`` are ``(n_steps + 1, 2Q+1)`` from :func:`cj_depth_tables`,
    rows indexed by absolute step, columns by ``q_max + inventory``."""
    return det_rollout(p, (bid_table, ask_table), seed, num_trajectories, noise, inv0, stats_only,
                       final_obs, device)


def table_rollout_plain(p, bid_table, ask_table, seed=0, num_trajectories=16384, noise=None, inv0=None,
                        stats_only=False, final_obs=False, device=None):
    """Plain PyTorch :func:`table_rollout` on any device."""
    return det_rollout_plain(p, (bid_table, ask_table), seed, num_trajectories, noise, inv0, stats_only,
                             final_obs, device)


def fixed_rollout(p: DetRolloutParams, seed: int = 0, num_trajectories: int = 16384, noise=None,
                  inv0=None, stats_only: bool = False, final_obs: bool = False, device=None):
    """K5 with the constant action ``p.fixed_action``
    (``fixed_rollout_pallas``, pallas_rollout.py:1739)."""
    return det_rollout(p, (), seed, num_trajectories, noise, inv0, stats_only, final_obs, device)


def fixed_rollout_plain(p, seed=0, num_trajectories=16384, noise=None, inv0=None, stats_only=False,
                        final_obs=False, device=None):
    """Plain PyTorch :func:`fixed_rollout` on any device."""
    return det_rollout_plain(p, (), seed, num_trajectories, noise, inv0, stats_only, final_obs, device)


def schedule_rollout(p: DetRolloutParams, action_table, seed: int = 0, num_trajectories: int = 16384,
                     noise=None, inv0=None, stats_only: bool = False, final_obs: bool = False, device=None):
    """K5 with a per-step action schedule (``schedule_rollout_pallas``,
    pallas_rollout.py:1790): ``action_table`` is ``(n_steps, A)``, rows
    indexed by absolute step (a late fixed start begins deeper into it)."""
    return det_rollout(p, (action_table,), seed, num_trajectories, noise, inv0, stats_only, final_obs,
                       device)


def schedule_rollout_plain(p, action_table, seed=0, num_trajectories=16384, noise=None, inv0=None,
                           stats_only=False, final_obs=False, device=None):
    """Plain PyTorch :func:`schedule_rollout` on any device."""
    return det_rollout_plain(p, (action_table,), seed, num_trajectories, noise, inv0, stats_only,
                             final_obs, device)


# ------------------------------------------------------------ stats wrappers
def _summary(total: torch.Tensor, episodes: int, n: int, spread, post_rate=None) -> dict:
    mean_r, mean_r2, mean_q, mean_q2 = total / episodes
    out = {
        "mean_pnl": mean_r,
        "std_pnl": torch.sqrt(torch.clamp(mean_r2 - mean_r**2, min=0.0)),
        "mean_terminal_inventory": mean_q,
        "std_terminal_inventory": torch.sqrt(torch.clamp(mean_q2 - mean_q**2, min=0.0)),
        "mean_spread": spread,
    }
    if post_rate is not None:
        out["post_rate"] = post_rate
    out["episodes"] = episodes * n
    return out


def _stats_loop(run, key, episodes: int, device):
    """Sums of (reward, reward^2, q_T, q_T^2) means and of the mean quoted
    spread over ``episodes`` K5 stats-mode runs seeded seed0, seed0+1, ..."""
    seed0 = seed_from_key(key)
    total = torch.zeros(4, dtype=torch.float32, device=device)
    spread = torch.zeros((), dtype=torch.float32, device=device)
    for e in range(episodes):
        _, inv, _, rsum, ssum = run(seed0 + e)
        total += torch.stack([rsum.mean(), (rsum**2).mean(), inv.mean(), (inv**2).mean()])
        spread += ssum.mean()
    return total, spread


def cj_mc_episode_stats(cfg: EnvConfig, agent, key, episodes: int = 1, device=None) -> dict:
    """Throughput-mode :func:`mbt_gym_torch.rollout.mc_episode_stats` for the
    closed-form CJ agent on K5's table stats mode (pallas_rollout.py:2030):
    the same summary dict without trajectories; ``mean_spread`` is the mean
    quoted spread (bid + ask) over steps and envs."""
    from mbt_gym_torch.agents.baseline import _device_table, agent_device_tables

    device = resolve_device(device)
    p = cj_rollout_params(cfg, agent)
    # the tables are copied to the card once per agent and device
    bid, ask = _device_table(agent_device_tables(agent, "K5 depth"),
                             lambda: tuple(torch.as_tensor(t, device=device) for t in cj_depth_tables(agent)), device)
    n = cfg.num_trajectories
    total, spread = _stats_loop(
        lambda s: table_rollout(p, bid, ask, s, n, stats_only=True, device=device), key, episodes, device,
    )
    return _summary(total, episodes, n, spread / (episodes * p.run_steps))


def fixed_mc_episode_stats(cfg: EnvConfig, fixed_action, key, episodes: int = 1, device=None) -> dict:
    """Throughput-mode :func:`mbt_gym_torch.rollout.mc_episode_stats` for a
    constant action on K5's fixed stats mode (pallas_rollout.py:2118).  The
    spread is exact on the host: twice the mean of the first two
    (denormalised) action columns, NaN for a 1-column (speed) action; at
    the touch ``mean_spread`` is NaN and ``post_rate`` the mean of the two
    post columns (pallas_rollout.py:2154-2159)."""
    device = resolve_device(device)
    p = fixed_rollout_params(cfg, fixed_action)
    n = cfg.num_trajectories
    total, _ = _stats_loop(
        lambda s: fixed_rollout(p, s, n, stats_only=True, device=device), key, episodes, device,
    )
    action = np.asarray(p.fixed_action, np.float32)
    if p.dynamics_kind == "touch":
        nan = torch.tensor(float("nan"), dtype=torch.float32, device=device)
        post_rate = torch.tensor(float(action[:2].mean()), dtype=torch.float32, device=device)
        return _summary(total, episodes, n, nan, post_rate)
    if action.size >= 2:
        quotes = action[:2]
        if p.normalise_act:
            quotes = (quotes + 1.0) * np.asarray(p.act_grad[:2], np.float32) + np.asarray(p.act_low[:2], np.float32)
        spread = torch.tensor(float(2.0 * quotes.mean()), dtype=torch.float32, device=device)
    else:
        spread = torch.tensor(float("nan"), dtype=torch.float32, device=device)
    return _summary(total, episodes, n, spread)
