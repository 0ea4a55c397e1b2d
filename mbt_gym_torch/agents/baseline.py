"""Closed-form and baseline agents (counterpart of
``mbt_gym_tpu/agents/baseline.py``; reference
``mbt_gym/agents/BaselineAgents.py``) as policies
``policy(params, obs, state) -> (N, A)`` for :func:`mbt_gym_torch.rollout.rollout`.

Each kernel-eligible policy carries a ``dispatch_meta`` tag naming its
kind, which :func:`mbt_gym_torch.dispatch.dispatch_report` reads.  The port
carries the AS agent, the two Cartea-Jaimungal agents (market making and
optimal execution), the fixed-action, fixed-spread, random, human and
no-market-order policies, and the raw-observation adapter.

Agents read the *raw* (unnormalised) observation columns; when the env
normalises observations, wrap with :func:`raw_obs_policy`.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from mbt_gym_torch.dispatch import policy_meta, tag_policy
from mbt_gym_torch.env import EnvConfig, make_generator
from mbt_gym_torch.types import (
    ASK_INDEX,
    ASSET_PRICE_INDEX,
    BID_INDEX,
    CASH_INDEX,
    INVENTORY_INDEX,
    TIME_INDEX,
    as_values,
    device_constant,
)


def fixed_action_policy(fixed_action):
    """Constant action for every trajectory (BaselineAgents.py:25-31).
    Tagged ``kind="fixed"``: on eligible configs ``rollout(backend="auto")``
    runs it on the deterministic-policy kernel K5
    (:func:`mbt_gym_torch.ops.det_rollout.fixed_rollout`)."""
    fixed = np.asarray(fixed_action, dtype=np.float64).reshape(-1)

    values = as_values(fixed)

    def policy(params, obs, state):
        action = device_constant(values, obs.dtype, obs.device)
        return action.expand(obs.shape[0], fixed.shape[-1])

    return tag_policy(policy, kind="fixed", action=tuple(float(x) for x in fixed))


def raw_obs_policy(cfg: EnvConfig, policy):
    """Adapt a raw-observation policy to an env with normalised observations."""
    if not cfg.normalise_observation_space:
        return policy
    low, high = cfg.observation_bounds()
    gradient, low = as_values((high - low) / 2), as_values(low)

    def wrapped(params, obs, state):
        g = device_constant(gradient, obs.dtype, obs.device)
        lo = device_constant(low, obs.dtype, obs.device)
        return policy(params, (obs + 1.0) * g + lo, state)

    return wrapped


def fixed_spread_policy(half_spread: float = 1.0, offset: float = 0.0):
    """Symmetric quotes ``half_spread -/+ offset`` (BaselineAgents.py:34-42)."""
    return fixed_action_policy([half_spread - offset, half_spread + offset])


def random_policy(cfg: EnvConfig, key=0):
    """Uniform samples from the action space, one per step shared by all
    trajectories (BaselineAgents.py:15-22 repeats one sample over N).

    The samples come from their own generator, never from the env's noise
    stream: ``key`` is an int seed (the generator is made on the first
    call's device) or a ``torch.Generator``.  ``policy.generators()`` gives
    the generators made so far, which ``jit_rollout`` registers with its
    CUDA graph."""
    low, high = cfg.action_bounds()
    gens = {}

    def policy(params, obs, state):
        device = obs.device
        if device.type not in gens:
            gens[device.type] = make_generator(key, device)
        u = torch.rand((1, len(low)), generator=gens[device.type], dtype=obs.dtype, device=device)
        lo = device_constant(as_values(low), obs.dtype, device)
        hi = device_constant(as_values(high), obs.dtype, device)
        return (lo + u * (hi - lo)).expand(obs.shape[0], len(low))

    policy.generators = lambda: tuple(gens.values())
    return policy


def human_policy(cfg: EnvConfig):
    """stdin-driven quotes, one pair broadcast to all trajectories
    (HumanAgent, BaselineAgents.py:45-49).  Host-side by nature — for
    interactive inspection only."""

    def policy(params, obs, state):
        bid = float(input(f"Current state is {obs[0].cpu().numpy()}. Midprice-bid half spread? "))
        ask = float(input(f"Current state is {obs[0].cpu().numpy()}. Ask-midprice half spread? "))
        action = torch.tensor([bid, ask], dtype=obs.dtype, device=obs.device)
        return action.expand(obs.shape[0], 2)

    return policy


def no_market_order_policy(quote_policy):
    """Adapt a 2-column quoting policy to a limit-and-market-order env
    (action_dim=4) by forcing the market-order columns to zero — the
    natural closed-form baseline on ``get_cj_env``-style envs
    (experiments/helpers.py:21-60), since no closed form exists for the
    full limit+market problem.  A fixed inner policy stays ``kind="fixed"``
    with the zero columns appended, so it still dispatches to K5."""

    def policy(params, obs, state):
        q = quote_policy(params, obs, state)
        return torch.cat([q, torch.zeros_like(q)], dim=1)

    inner = policy_meta(quote_policy)
    if inner is not None and inner.get("kind") == "fixed":
        tag_policy(
            policy, kind="fixed",
            action=tuple(inner["action"]) + (0.0,) * len(inner["action"]),
        )
    return policy


def expected_action(policy, params, obs, state, key, n_samples: int = 1000):
    """Monte-Carlo mean action of a stochastic policy (Agent.py:11-12).

    Each sample sees the state with its ``key`` replaced by one generator
    made from ``key`` (a seed or a ``torch.Generator``) and consumed in
    turn, so policies that draw from ``state.key`` draw independently;
    deterministic policies return their action unchanged."""
    gen = make_generator(key, obs.device)
    sample_state = state._replace(key=gen) if state is not None else None
    total = None
    for _ in range(n_samples):
        a = policy(params, obs, sample_state)
        total = a.clone() if total is None else total + a
    return total / n_samples


@dataclasses.dataclass(frozen=True)
class AvellanedaStoikovAgent:
    """AS-2008 closed-form market maker (BaselineAgents.py:52-83).

    Quotes a reservation-price skew ``q * gamma * sigma^2 * (T - t)`` plus
    half the optimal spread ``gamma sigma^2 (T-t) + (2/gamma) ln(1+gamma/k)``.
    Parameters are read off the env config (volatility from the midprice
    model, fill exponent from the fill model), as the reference does.
    """

    risk_aversion: float = 0.1
    volatility: float = 2.0
    fill_exponent: float = 1.5
    terminal_time: float = 1.0

    @classmethod
    def from_config(cls, cfg: EnvConfig, risk_aversion: float = 0.1) -> "AvellanedaStoikovAgent":
        return cls(
            risk_aversion=risk_aversion,
            volatility=cfg.dynamics.midprice_model.volatility,
            fill_exponent=cfg.dynamics.fill_probability_model.fill_exponent,
            terminal_time=cfg.terminal_time,
        )

    def policy(self):
        gamma, sigma, k, T = self.risk_aversion, self.volatility, self.fill_exponent, self.terminal_time

        def policy_fn(params, obs, state):
            inventory = obs[:, INVENTORY_INDEX]
            time = obs[:, TIME_INDEX]
            skew = inventory * gamma * sigma**2 * (T - time)
            if gamma == 0:
                spread = torch.full_like(time, 2.0 / k)  # risk-neutral limit
            else:
                spread = gamma * sigma**2 * (T - time) + (2.0 / gamma) * np.log(1 + gamma / k)
            return torch.stack([skew + spread / 2, -skew + spread / 2], dim=1)

        return tag_policy(policy_fn, kind="as_closed_form", agent=self)


def _device_table(cache: dict, table, device):
    """``table`` as a tensor on ``device``, copied there once per device;
    ``table`` may also be a function that makes the value on ``device``."""
    key = str(device)
    if key not in cache:
        cache[key] = table() if callable(table) else torch.tensor(table, device=device)
    return cache[key]


@functools.lru_cache(maxsize=32)
def agent_device_tables(agent, kind: str) -> dict:
    """The cache of one ``kind`` of ``agent``'s kernel tables by device (for
    :func:`_device_table`), kept per agent value as its float32 depth table
    is: the CJ kernels' entry points copy their tables to the card once,
    not on every call."""
    return {}


@functools.lru_cache(maxsize=16)
def _cj_depth_table_f32(agent: "CarteaJaimungalMmAgent") -> np.ndarray:
    table = agent.depth_table().astype(np.float32)
    table.flags.writeable = False
    return table


# --------------------------------------------------------- Cartea-Jaimungal MM
@dataclasses.dataclass(frozen=True)
class CarteaJaimungalMmAgent:
    """CJP-2015 ch.10 closed-form market maker (BaselineAgents.py:86-170).

    The reference computes ``omega(t) = expm(A (T - t)) z`` per query with
    ``scipy.linalg.expm`` over a ``(2Q+1)^2`` tridiagonal matrix.  Here the
    whole ``h(t, q) = (1/kappa) ln omega`` surface is computed once on the
    episode's time grid through one eigendecomposition of A (the JAX
    package's numpy code, so both packages build the same tables bit for
    bit), and the policy is a gather from the depth table.
    """

    kappa: float
    phi: float
    alpha: float
    lambdas: Tuple[float, float]
    terminal_time: float
    n_steps: int
    max_inventory: int
    inventory_neutral: bool = False
    large_depth: float = 10_000.0

    @classmethod
    def from_config(cls, cfg: EnvConfig, max_inventory: Optional[int] = None) -> "CarteaJaimungalMmAgent":
        from mbt_gym_torch import rewards as rw

        reward = cfg.reward_function
        inventory_neutral = isinstance(reward, rw.PnL)
        if not inventory_neutral:
            assert reward.inventory_exponent == 2.0, "Inventory exponent must be 2."
        return cls(
            kappa=cfg.dynamics.fill_probability_model.fill_exponent,
            phi=0.0 if inventory_neutral else reward.per_step_inventory_aversion,
            alpha=0.0 if inventory_neutral else reward.terminal_inventory_aversion,
            lambdas=tuple(cfg.dynamics.arrival_model.intensity),
            terminal_time=cfg.terminal_time,
            n_steps=cfg.n_steps,
            max_inventory=int(max_inventory if max_inventory is not None else cfg.max_inventory),
            inventory_neutral=inventory_neutral,
        )

    def _a_and_z(self):
        """Tridiagonal generator A and terminal vector z over the inventory
        grid [max_inventory, ..., -max_inventory] (BaselineAgents.py:147-159)."""
        q = self.max_inventory
        size = 2 * q + 1
        inventories = q - np.arange(size)
        a = np.zeros((size, size))
        a[np.arange(size), np.arange(size)] = -self.phi * self.kappa * inventories**2
        a[np.arange(size - 1), np.arange(1, size)] = self.lambdas[BID_INDEX] * np.exp(-1)
        a[np.arange(1, size), np.arange(size - 1)] = self.lambdas[ASK_INDEX] * np.exp(-1)
        z = np.exp(-self.alpha * self.kappa * inventories**2)
        return a, z

    def h_table(self, dtype=np.float64) -> np.ndarray:
        """(n_steps + 1, 2Q+1) table of h(t_i, q) on the episode time grid,
        from ``expm(A s) = V diag(e^{w s}) V^{-1}`` with one
        eigendecomposition: O(T * Q^2) instead of T matrix exponentials."""
        a, z = self._a_and_z()
        w, v = np.linalg.eig(a)
        v_inv_z = np.linalg.solve(v, z)
        times_left = self.terminal_time - np.linspace(0.0, self.terminal_time, self.n_steps + 1)
        omega = np.real(np.exp(np.outer(times_left, w)) * v_inv_z[None, :] @ v.T)
        omega = np.maximum(omega, 1e-300)
        return (np.log(omega) / self.kappa).astype(dtype)

    def depth_table(self) -> np.ndarray:
        """(n_steps+1, 2Q+1, 2) table of [bid, ask] depths by (time, inventory
        index).  The reference's large-depth boundary override
        (BaselineAgents.py:131-137) fires exactly at the clipped inventory
        bounds, so it is index-based and precomputable."""
        h = self.h_table()  # (T+1, 2Q+1)
        inv_k = 1.0 / self.kappa
        bid = inv_k - np.roll(h, -1, axis=1) + h
        bid[:, -1] = inv_k + self.large_depth  # q >= +Q: quote huge bid depth
        ask = inv_k - np.roll(h, 1, axis=1) + h
        ask[:, 0] = inv_k + self.large_depth  # q <= -Q: quote huge ask depth
        return np.stack([bid, ask], axis=2)

    def depth_table_f32(self) -> np.ndarray:
        """:meth:`depth_table` in float32, the table every CJ path reads
        (the engine policy, K5's :func:`~mbt_gym_torch.ops.det_rollout.cj_depth_tables`
        and K8's :func:`~mbt_gym_torch.ops.cj_episode.cj_episode_rewards`).
        Built once per agent value and shared, so it is read-only."""
        return _cj_depth_table_f32(self)

    def policy(self):
        if self.inventory_neutral:
            risk_neutral = 1.0 / self.kappa

            def neutral_fn(params, obs, state):
                return torch.full((obs.shape[0], 2), risk_neutral, dtype=obs.dtype, device=obs.device)

            return tag_policy(neutral_fn, kind="cj_closed_form", agent=self)

        q_max = self.max_inventory
        dt = self.terminal_time / self.n_steps
        # float32, as the JAX policy's table: in a float64 config the quotes
        # are float32 values widened, in both packages
        depth_tab = self.depth_table_f32()
        last = depth_tab.shape[0] - 1
        tables = {}

        def policy_fn(params, obs, state):
            tab = _device_table(tables, depth_tab, obs.device)
            idx = torch.clamp(q_max + obs[:, INVENTORY_INDEX], 0, 2 * q_max).to(torch.int64)
            if state is not None:
                # Rollout: every trajectory shares the clock
                # (TradingEnvironment.py:218-220), so one time row.
                t_idx = torch.clamp(torch.round(state.time[0] / dt).to(torch.int64), 0, last)
                return tab[t_idx.reshape(1), idx].to(obs.dtype)
            # Standalone use (state=None): each row at its own time.
            t_idx = torch.clamp(torch.round(obs[:, TIME_INDEX] / dt).to(torch.int64), 0, last)
            return tab[t_idx, idx].to(obs.dtype)

        return tag_policy(policy_fn, kind="cj_closed_form", agent=self)

    def true_value_function(self, obs: torch.Tensor) -> torch.Tensor:
        """Analytic value ``h(t, q) + cash + q * S`` — the CJP replication
        oracle (BaselineAgents.py:161-170)."""
        h_tab = _device_table(agent_device_tables(self, f"h {obs.dtype}"),
                              lambda: torch.as_tensor(self.h_table(), dtype=obs.dtype, device=obs.device), obs.device)
        dt = self.terminal_time / self.n_steps
        t_idx = torch.clamp(torch.round(obs[:, TIME_INDEX] / dt).to(torch.int64), 0, h_tab.shape[0] - 1)
        idx = torch.clamp(
            self.max_inventory + obs[:, INVENTORY_INDEX], 0, 2 * self.max_inventory
        ).to(torch.int64)
        h_0 = h_tab[t_idx, idx]
        return h_0 + obs[:, CASH_INDEX] + obs[:, INVENTORY_INDEX] * obs[:, ASSET_PRICE_INDEX]


# --------------------------------------------------------- Cartea-Jaimungal OE
@dataclasses.dataclass(frozen=True)
class CarteaJaimungalOeAgent:
    """CJP-2015 p.147 closed-form optimal-execution schedule
    (BaselineAgents.py:173-210)."""

    phi: float = 2e-4
    alpha: float = 1e-4
    temporary_impact: float = 0.01
    permanent_impact: float = 0.01
    terminal_time: float = 1.0
    initial_inventory: float = 0.0

    @classmethod
    def from_config(cls, cfg: EnvConfig, phi: float = 2e-4, alpha: float = 1e-4) -> "CarteaJaimungalOeAgent":
        impact = cfg.dynamics.price_impact_model
        # The schedule needs one scalar q0: a (low, high) tuple uses the
        # expectation of the uniform-integer draw, (low + high - 1) / 2
        # (high exclusive, TradingEnvironment.py:271-272); a callable is
        # evaluated once.
        spec = cfg.initial_inventory
        if callable(spec):
            q0 = float(spec())
        elif isinstance(spec, tuple):
            q0 = (float(spec[0]) + float(spec[1]) - 1.0) / 2.0
        else:
            q0 = float(spec)
        return cls(
            phi=phi,
            alpha=alpha,
            temporary_impact=impact.temporary_impact_coefficient,
            permanent_impact=impact.permanent_impact_coefficient,
            terminal_time=cfg.terminal_time,
            initial_inventory=q0,
        )

    def policy(self):
        gamma = float(np.sqrt(self.phi / self.temporary_impact))
        root = float(np.sqrt(self.temporary_impact * self.phi))
        zeta = (self.alpha - 0.5 * self.permanent_impact + root) / (
            self.alpha - 0.5 * self.permanent_impact - root
        )
        q0, T = self.initial_inventory, self.terminal_time
        denom = float(zeta * np.exp(gamma * T) - np.exp(-gamma * T))
        sign = -float(np.sign(q0))

        def policy_fn(params, obs, state):
            time_left = T - obs[:, TIME_INDEX]
            speed = gamma * q0 * (zeta * torch.exp(gamma * time_left) + torch.exp(-gamma * time_left)) / denom
            return (sign * speed)[:, None]

        return tag_policy(policy_fn, kind="oe_schedule", agent=self)
