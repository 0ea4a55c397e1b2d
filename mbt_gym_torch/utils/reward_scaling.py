"""Offline reward normalisation (counterpart of
``mbt_gym_tpu/utils/reward_scaling.py``).

The reference computes a reward scaling inside
``TradingEnvironment.__init__`` by simulating 100k inventory-neutral
trajectories with the fixed risk-neutral action ``1/fill_exponent``
(TradingEnvironment.py:90-94, 329-343).  Here it is an explicit utility:
compute it once, then pass the result as ``EnvConfig.reward_scaling``.

The simulation is ``jit_rollout(backend="auto")`` of
``fixed_action_policy``, as the JAX package's is ``jit_rollout``: at a
trajectory count that is a multiple of 128 the dispatch sends it to K5's
fixed kind on the card, and at the default 100,000 to the engine, whose
episode is captured at the first call per config and replayed at every
later one (the fixed policy is built anew each call; ``jit_rollout`` keys
it by its action, so the graph is found again).
"""
from __future__ import annotations

import dataclasses

from mbt_gym_torch.agents.baseline import fixed_action_policy
from mbt_gym_torch.dynamics import LimitOrderDynamics
from mbt_gym_torch.env import EnvConfig
from mbt_gym_torch.processes.arrivals import PoissonArrivals
from mbt_gym_torch.processes.fills import ExponentialFill
from mbt_gym_torch.rollout import jit_rollout


def inventory_neutral_simulation(cfg: EnvConfig, num_total_trajectories: int = 100_000):
    """``(config, policy)`` of the inventory-neutral simulation: the full
    horizon from time 0, ``num_total_trajectories`` envs, unscaled rewards,
    raw actions, the fixed quote ``1/fill_exponent`` on both sides."""
    dynamics = cfg.dynamics
    assert isinstance(dynamics, LimitOrderDynamics) and isinstance(
        dynamics.arrival_model, PoissonArrivals
    ) and isinstance(dynamics.fill_probability_model, ExponentialFill), (
        "Arrival model must be Poisson and fill probability model must be "
        "exponential to scale rewards"  # TradingEnvironment.py:91-94
    )
    fixed_action = 1.0 / dynamics.fill_probability_model.fill_exponent
    sim_cfg = dataclasses.replace(
        cfg,
        start_time=0.0,
        num_trajectories=num_total_trajectories,
        reward_scaling=None,
        normalise_action_space=False,
    )
    return sim_cfg, fixed_action_policy([fixed_action, fixed_action])


def compute_inventory_neutral_reward_scaling(
    cfg: EnvConfig, key, num_total_trajectories: int = 100_000, device=None
) -> float:
    """scaling = 1 / (mean per-step reward * n_steps) under the fixed
    risk-neutral quote, from a fresh full-horizon simulation.  ``key`` is
    an int seed; ``device`` ``None`` means the card."""
    sim_cfg, policy = inventory_neutral_simulation(cfg, num_total_trajectories)
    res = jit_rollout(sim_cfg, policy, None, key, device=device)
    mean_episode_reward = float(res.trajectory.rewards.mean()) * cfg.n_steps
    return 1.0 / mean_episode_reward


def with_normalised_rewards(
    cfg: EnvConfig, key, num_total_trajectories: int = 100_000, device=None
) -> EnvConfig:
    """One-call counterpart of the reference's ``normalise_rewards=True``
    constructor flag (TradingEnvironment.py:90-94): a config whose
    ``reward_scaling`` was computed from a fresh inventory-neutral
    simulation."""
    scaling = compute_inventory_neutral_reward_scaling(cfg, key, num_total_trajectories, device=device)
    return dataclasses.replace(cfg, reward_scaling=scaling)
