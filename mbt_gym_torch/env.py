"""Trading environment core (counterpart of ``mbt_gym_tpu/env.py``;
reference ``mbt_gym/gym/TradingEnvironment.py``).

The reference's stateful ``gym.Env`` becomes a pair of functions over a
static :class:`EnvConfig`:

    reset(cfg, key, device=None)  -> (EnvState, obs)
    step(cfg, state, action)      -> StepResult(state', obs, reward, done)

``step`` keeps the reference's operation order (TradingEnvironment.py:
103-110,198-216): arrivals -> fills -> max-inventory mask -> bookkeeping ->
clip + ``clip_events`` -> time -> processes -> done -> reward.  Native noise
is drawn from the ``torch.Generator`` in ``EnvState.key``; passing
``noise`` explicitly replays the reference's NumPy draws bit for bit (see
:mod:`mbt_gym_torch.ops.compat`).

Every entry point runs on the CUDA device unless the caller passes another
``device`` (``device=None`` means ``"cuda"``); without a GPU it raises.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from mbt_gym_torch.dynamics import (
    AtTheTouchDynamics,
    DynamicsBase,
    LimitAndMarketOrderDynamics,
    LimitOrderDynamics,
)
from mbt_gym_torch.processes.arrivals import PoissonArrivals
from mbt_gym_torch.processes.fills import ExponentialFill
from mbt_gym_torch.processes.midprice import BrownianMotionMidprice
from mbt_gym_torch.rewards import AgentStateView, PnL, RewardAux
from mbt_gym_torch.types import EnvState, SlotNoise, StepNoise, StepResult, as_values, device_constant

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def resolve_device(device=None) -> torch.device:
    """The device an entry point targets: ``None`` means ``"cuda"``.  A CUDA
    target without a visible GPU raises; nothing moves to the CPU unless the
    caller asks for it."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mbt_gym_torch targets the CUDA device by default and no GPU is "
            "visible; pass device='cpu' to run on the CPU"
        )
    return device


def make_generator(key, device: torch.device) -> torch.Generator:
    """``key`` is an int seed or a ``torch.Generator`` on ``device`` (used
    as is, and consumed by the caller)."""
    if isinstance(key, torch.Generator):
        if key.device.type != device.type:
            raise ValueError(
                f"generator lives on {key.device}, the call targets {device}"
            )
        return key
    gen = torch.Generator(device=device)
    gen.manual_seed(int(key))
    return gen


def default_dynamics() -> LimitOrderDynamics:
    """The reference's default model composition (TradingEnvironment.py:51-63):
    BM midprice + Poisson(100, 100) arrivals + exponential fill."""
    return LimitOrderDynamics(
        midprice_model=BrownianMotionMidprice(),
        arrival_model=PoissonArrivals(intensity=(100.0, 100.0)),
        fill_probability_model=ExponentialFill(),
    )


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Static environment configuration (hashable).

    ``initial_inventory`` is an int (deterministic), an ``(low, high)``
    tuple sampled uniformly at reset exclusive of ``high``, or a zero-arg
    callable (TradingEnvironment.py:270-281).  ``start_time`` is a float, a
    ``("uniform", low, high)`` spec drawn once per reset and quantised to the
    step grid, or a zero-arg callable (TradingEnvironment.py:257-268).
    Callable specs are evaluated on the host per reset and passed to
    :func:`reset` as overrides; :func:`reset` rejects them otherwise.
    """

    dynamics: DynamicsBase = None
    reward_function: object = PnL()
    terminal_time: float = 1.0
    n_steps: int = 200
    initial_cash: float = 0.0
    initial_inventory: Union[int, Tuple[float, float], Callable[[], float]] = 0
    max_inventory: float = 10_000.0
    max_cash: Optional[float] = None
    max_stock_price: Optional[float] = None
    start_time: Union[float, Tuple[str, float, float], Callable[[], float]] = 0.0
    num_trajectories: int = 1000
    normalise_action_space: bool = False
    normalise_observation_space: bool = False
    reward_scaling: Optional[float] = None  # None = no reward normalisation
    dtype: str = "float32"
    # Repo addition (NOT reference behavior): block unit market orders at
    # the +/- max_inventory boundary, with the same at-boundary convention
    # as the limit-fill mask (TradingEnvironment.py:323-327 masks only
    # limit fills; market orders pass and the independent inventory/cash
    # clips at :283-289 keep the cash — a money-pump exploit RL discovers).
    # Default False keeps the reference mechanics bit for bit.
    mask_market_orders_at_max_inventory: bool = False

    def __post_init__(self):
        if self.dynamics is None:
            object.__setattr__(self, "dynamics", default_dynamics())
        self.dynamics.validate()
        assert self.dtype in _DTYPES, f"dtype must be one of {sorted(_DTYPES)}"
        if self.mask_market_orders_at_max_inventory:
            assert isinstance(self.dynamics, LimitAndMarketOrderDynamics), (
                "mask_market_orders_at_max_inventory only applies to "
                "LimitAndMarketOrderDynamics (the only dynamics with market "
                "orders)."
            )
        if self.normalise_action_space:
            assert not isinstance(self.dynamics, AtTheTouchDynamics), (
                "AtTheTouchDynamics takes binary post decisions (MultiBinary in the "
                "reference, ModelDynamics.py:166-167); normalising them would corrupt "
                "fills — use normalise_action_space=False."
            )
            lo, hi = self.dynamics.action_bounds()
            assert all(h > l for l, h in zip(lo, hi)), "Cannot normalise a degenerate action space."
        if self.normalise_observation_space:
            lo, hi = self.observation_bounds()
            assert (hi > lo).all(), (
                "Cannot normalise a degenerate observation space (a process "
                "with equal min/max bounds, e.g. ConstantMidprice, would "
                "divide by zero; the reference silently produces inf there)."
            )

    # ------------------------------------------------------------------ misc
    @property
    def step_size(self) -> float:
        return self.terminal_time / self.n_steps

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def state_dim(self) -> int:
        return 3 + sum(p.state_dim for _, p in self.dynamics.processes())

    @property
    def action_dim(self) -> int:
        return self.dynamics.action_dim

    def resolved_max_stock_price(self) -> float:
        if self.max_stock_price is not None:
            return self.max_stock_price
        # Default: midprice model's upper bound (TradingEnvironment.py:75).
        return self.dynamics.midprice_model.bounds()[1][0]

    def resolved_max_cash(self) -> float:
        if self.max_cash is not None:
            return self.max_cash
        return self.n_steps * self.resolved_max_stock_price()  # TradingEnvironment.py:229-230

    def observation_bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        """(low, high) (S,) arrays; parity with TradingEnvironment.py:232-241."""
        low = [-self.resolved_max_cash(), -self.max_inventory, 0.0]
        high = [self.resolved_max_cash(), self.max_inventory, self.terminal_time]
        for _, proc in self.dynamics.processes():
            b_lo, b_hi = proc.bounds()
            low.extend(b_lo)
            high.extend(b_hi)
        return np.asarray(low, dtype=self.dtype), np.asarray(high, dtype=self.dtype)

    def action_bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        lo, hi = self.dynamics.action_bounds()
        return np.asarray(lo, dtype=self.dtype), np.asarray(hi, dtype=self.dtype)


# --------------------------------------------------------------------- noise
@lru_cache(maxsize=64)
def noise_specs(cfg: EnvConfig) -> Tuple[Tuple[str, Tuple[int, int]], ...]:
    """Per-slot (name, (n_normal, n_uniform)) noise requirements per step."""
    return tuple((name, proc.noise_spec()) for name, proc in cfg.dynamics.processes())


def draw_step_noise(cfg: EnvConfig, key: torch.Generator, n: int) -> StepNoise:
    """Native noise for one step: all slots' normal columns from ONE draw
    and all uniform columns from a second, cut in slot order."""
    return _draw_noise(cfg, key, (n,))


def _draw_noise(cfg: EnvConfig, key: torch.Generator, lead: Tuple[int, ...]) -> StepNoise:
    dtype = cfg.torch_dtype
    specs = noise_specs(cfg)
    total_norm = sum(s[1][0] for s in specs)
    total_unif = sum(s[1][1] for s in specs)
    kw = dict(generator=key, dtype=dtype, device=key.device)
    normals = torch.randn(lead + (total_norm,), **kw) if total_norm else None
    uniforms = torch.rand(lead + (total_unif,), **kw) if total_unif else None
    slots = []
    i_n = i_u = 0
    for _, (n_norm, n_unif) in specs:
        slots.append(
            SlotNoise(
                normal=normals[..., i_n : i_n + n_norm] if n_norm else None,
                uniform=uniforms[..., i_u : i_u + n_unif] if n_unif else None,
            )
        )
        i_n += n_norm
        i_u += n_unif
    return tuple(slots)


def _noise_as_tensors(noise: StepNoise, dtype, device) -> StepNoise:
    """Injected noise may arrive as numpy arrays (the replay harnesses')."""

    def conv(x):
        return None if x is None else torch.as_tensor(x, dtype=dtype, device=device)

    return tuple(SlotNoise(normal=conv(s.normal), uniform=conv(s.uniform)) for s in noise)


def _noise_dict(cfg: EnvConfig, noise: StepNoise):
    return {name: slot for (name, _), slot in zip(noise_specs(cfg), noise)}


# --------------------------------------------------------------------- reset
def resolve_reset_overrides(cfg: EnvConfig):
    """Host-evaluate callable ``start_time`` / ``initial_inventory`` specs
    for ONE reset (TradingEnvironment.py:257-281: ``self.start_time()``
    quantised to the grid; ``self.initial_inventory()`` rounded when the
    dynamics says so).  Returns ``(start_time, initial_inventory)``, each
    ``None`` when the spec is not callable; pass the result to
    :func:`reset`'s override arguments."""
    start = None
    inventory = None
    if callable(cfg.start_time):
        raw = float(cfg.start_time())
        assert 0.0 <= raw < cfg.terminal_time, (
            "Start time is not within (0, env.terminal_time)."  # TradingEnvironment.py:267
        )
        start = round(raw / cfg.step_size) * cfg.step_size
    if callable(cfg.initial_inventory):
        v = np.asarray(cfg.initial_inventory(), dtype=np.float64)
        if cfg.dynamics.round_initial_inventory:
            v = np.round(v)  # TradingEnvironment.py:277-279
        inventory = np.broadcast_to(v, (cfg.num_trajectories,)).astype(cfg.dtype)
    return start, inventory


def reset(
    cfg: EnvConfig,
    key,
    start_time: Optional[float] = None,
    initial_inventory=None,
    device=None,
) -> Tuple[EnvState, torch.Tensor]:
    """Build the initial :class:`EnvState` and observation
    (parity with TradingEnvironment.initial_state, :131-140, and reset, :96-101).

    ``key`` is an int seed or a ``torch.Generator`` on the target device; a
    random start time, then a random initial inventory, are drawn from it
    in that order, and it becomes the state's native noise source.
    ``start_time`` / ``initial_inventory`` override the config's specs with
    concrete values (scalar; (N,) array)."""
    device = resolve_device(device)
    dtype = cfg.torch_dtype
    n = cfg.num_trajectories
    gen = make_generator(key, device)

    # Start time: scalar, shared by all trajectories, quantised to the grid.
    if start_time is not None:
        start = torch.full((), float(start_time), dtype=dtype, device=device)
    elif callable(cfg.start_time):
        raise TypeError(
            "Callable start_time must be evaluated on the host per reset: "
            "pass the value as reset(..., start_time=...)."
        )
    elif isinstance(cfg.start_time, tuple):
        tag, lo, hi = cfg.start_time
        assert tag == "uniform", f"Unknown start_time spec {cfg.start_time}"
        raw = torch.rand((), generator=gen, dtype=dtype, device=device) * (hi - lo) + lo
        start = torch.round(raw / cfg.step_size) * cfg.step_size
    else:
        start = torch.full(
            (), round(float(cfg.start_time) / cfg.step_size) * cfg.step_size, dtype=dtype, device=device
        )

    if initial_inventory is not None:
        inventory = torch.as_tensor(initial_inventory, dtype=dtype, device=device).expand(n)
    elif callable(cfg.initial_inventory):
        raise TypeError(
            "Callable initial_inventory must be evaluated on the host per "
            "reset: pass the value as reset(..., initial_inventory=...)."
        )
    elif isinstance(cfg.initial_inventory, tuple):
        lo, hi = cfg.initial_inventory
        inventory = torch.randint(int(lo), int(hi), (n,), generator=gen, device=device).to(dtype)
    else:
        inventory = torch.full((n,), float(cfg.initial_inventory), dtype=dtype, device=device)

    state = EnvState(
        cash=torch.full((n,), cfg.initial_cash, dtype=dtype, device=device),
        inventory=inventory,
        time=start.expand(n).clone(),
        process_states=tuple(p.initial_state(n, dtype, device) for _, p in cfg.dynamics.processes()),
        step=torch.zeros((), dtype=torch.int32, device=device),
        key=gen,
        initial_inventory=inventory,
        start_time=start,
        clip_events=torch.zeros((), dtype=torch.int32, device=device),
    )
    return state, observe(cfg, state)


# ----------------------------------------------------------------------- obs
def raw_observation(cfg: EnvConfig, state: EnvState) -> torch.Tensor:
    """(N, S) state matrix in the reference's column convention."""
    cols = [state.cash[:, None], state.inventory[:, None], state.time[:, None]]
    for arr in state.process_states:
        if arr.shape[1]:
            cols.append(arr)
    return torch.cat(cols, dim=1)


def _bounds_tensors(bounds, like: torch.Tensor):
    return tuple(device_constant(as_values(b), like.dtype, like.device) for b in bounds)


def observe(cfg: EnvConfig, state: EnvState) -> torch.Tensor:
    obs = raw_observation(cfg, state)
    if cfg.normalise_observation_space:
        low, high = _bounds_tensors(cfg.observation_bounds(), obs)
        gradient = (high - low) / 2
        obs = (obs - low) / gradient - 1.0  # TradingEnvironment.py:112-118
    return obs


def denormalise_action(cfg: EnvConfig, action: torch.Tensor) -> torch.Tensor:
    if not cfg.normalise_action_space:
        return action
    low, high = _bounds_tensors(cfg.action_bounds(), action)
    gradient = (high - low) / 2
    return (action + 1.0) * gradient + low  # TradingEnvironment.py:120-126


def normalise_action(cfg: EnvConfig, action: torch.Tensor) -> torch.Tensor:
    if not cfg.normalise_action_space:
        return action
    low, high = _bounds_tensors(cfg.action_bounds(), action)
    gradient = (high - low) / 2
    return (action - low) / gradient - 1.0


# ---------------------------------------------------------------------- step
def step(
    cfg: EnvConfig,
    state: EnvState,
    action,
    noise: Optional[StepNoise] = None,
) -> StepResult:
    """One environment step for all N trajectories, on the state's device.

    ``action`` is (N, A) in the (possibly normalised) action space.  When
    ``noise`` is None, native noise is drawn from ``state.key``; an explicit
    ``noise`` (tensors or numpy arrays, (N, k) per slot) replays given draws.
    """
    dtype = cfg.torch_dtype
    dt = cfg.step_size
    dynamics = cfg.dynamics
    device = state.cash.device
    action = torch.as_tensor(action, dtype=dtype, device=device)
    n = state.cash.shape[0]
    assert tuple(action.shape) == (n, dynamics.action_dim), (
        f"Action must have shape ({n}, {dynamics.action_dim}); got {tuple(action.shape)}."
    )
    action = denormalise_action(cfg, action)

    if cfg.mask_market_orders_at_max_inventory:
        # Repo addition (see EnvConfig): zero the MO trigger columns where
        # the unit order would cross +/- max_inventory, with the strict
        # at-boundary convention of the limit-fill mask below (a buy is
        # blocked AT +max, a sell AT -max), on the pre-step inventory.
        can_buy = (state.inventory < cfg.max_inventory).to(dtype)
        can_sell = (state.inventory > -cfg.max_inventory).to(dtype)
        action = torch.cat(
            [
                action[:, :2],
                action[:, 2:3] * can_buy[:, None],
                action[:, 3:4] * can_sell[:, None],
            ],
            dim=1,
        )

    if noise is None:
        assert state.key is not None, "native noise needs state.key (a torch.Generator)"
        noise = draw_step_noise(cfg, state.key, n)
    else:
        noise = _noise_as_tensors(noise, dtype, device)
    noises = _noise_dict(cfg, noise)

    slot_names = tuple(name for name, _ in dynamics.processes())
    proc_state_map = dict(zip(slot_names, state.process_states))
    midprice = proc_state_map["midprice_model"][:, 0]

    current = AgentStateView(cash=state.cash, inventory=state.inventory, time=state.time, price=midprice)

    # 1. arrivals & fills (RNG draw order parity: arrival uniforms then fill
    #    uniforms, TradingEnvironment.py:198-204 / ModelDynamics.py:127-131).
    arrivals, fills = dynamics.get_arrivals_and_fills(proc_state_map, action, noises, dt)

    # 2. mask fills that would push inventory beyond +/- max_inventory
    #    (TradingEnvironment.py:323-327): at max blocks bid fills, at min asks.
    if fills is not None:
        at_max = (state.inventory >= cfg.max_inventory).to(dtype)
        at_min = (state.inventory <= -cfg.max_inventory).to(dtype)
        fills = fills * torch.stack([1.0 - at_max, 1.0 - at_min], dim=1)

    # 3. wealth bookkeeping at the *pre-update* midprice, then clip, then time
    #    bump (TradingEnvironment.py:213-216).
    new_cash, new_inventory = dynamics.update_agent(
        state.cash, state.inventory, midprice, proc_state_map, action, arrivals, fills, dt
    )
    max_cash = cfg.resolved_max_cash()
    clipped_inventory = torch.clamp(new_inventory, -cfg.max_inventory, cfg.max_inventory)
    clipped_cash = torch.clamp(new_cash, -max_cash, max_cash)
    clip_events = state.clip_events + torch.any(
        (clipped_inventory != new_inventory) | (clipped_cash != new_cash)
    ).to(torch.int32)
    new_time = state.time + dt

    # 4. advance the stochastic processes (midprice moves *after* bookkeeping,
    #    TradingEnvironment.py:206-211).
    new_proc_states = tuple(
        proc.update(proc_state_map[name], arrivals, fills, action, noises[name], dt)
        for name, proc in dynamics.processes()
    )

    new_state = EnvState(
        cash=clipped_cash,
        inventory=clipped_inventory,
        time=new_time,
        process_states=new_proc_states,
        step=state.step + 1,
        key=state.key,
        initial_inventory=state.initial_inventory,
        start_time=state.start_time,
        clip_events=clip_events,
    )

    # 5. all-or-nothing done on the shared clock (TradingEnvironment.py:218-220).
    done_scalar = new_time[0] >= cfg.terminal_time - dt / 2
    done = done_scalar.expand(n)

    # 6. reward on (pre, post) state views (TradingEnvironment.py:105-108).
    new_midprice = new_proc_states[0][:, 0]
    nxt = AgentStateView(cash=clipped_cash, inventory=clipped_inventory, time=new_time, price=new_midprice)
    aux = RewardAux(
        initial_inventory=state.initial_inventory,
        episode_length=device_constant(float(cfg.terminal_time), dtype, device) - state.start_time,
    )
    reward = cfg.reward_function.calculate(current, action, nxt, done_scalar, aux)
    if cfg.reward_scaling is not None:
        reward = cfg.reward_scaling * reward

    return StepResult(state=new_state, obs=observe(cfg, new_state), reward=reward, done=done)
