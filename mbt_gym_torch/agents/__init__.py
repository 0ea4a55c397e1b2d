"""Agents: the closed-form baselines and the PPO learner."""
from mbt_gym_torch.agents.networks import ActorCritic, init_actor_critic
from mbt_gym_torch.agents.ppo import (
    PPOConfig,
    PPOTrainState,
    deterministic_policy,
    evaluate_policy,
    init_train_state,
    train_chunk,
    train_iteration,
)

__all__ = [
    "ActorCritic",
    "PPOConfig",
    "PPOTrainState",
    "deterministic_policy",
    "evaluate_policy",
    "init_actor_critic",
    "init_train_state",
    "train_chunk",
    "train_iteration",
]
