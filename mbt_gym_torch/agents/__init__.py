"""Agents: the closed-form baselines, the PPO learner and REINFORCE."""
from mbt_gym_torch.agents import reinforce
from mbt_gym_torch.agents.networks import ActorCritic, init_actor_critic, init_mlp
from mbt_gym_torch.agents.ppo import (
    PPOConfig,
    PPOTrainState,
    deterministic_policy,
    evaluate_policy,
    init_train_state,
    train_chunk,
    train_iteration,
)
from mbt_gym_torch.agents.reinforce import ReinforceConfig, ReinforceTrainState

__all__ = [
    "ActorCritic",
    "PPOConfig",
    "PPOTrainState",
    "ReinforceConfig",
    "ReinforceTrainState",
    "deterministic_policy",
    "evaluate_policy",
    "init_actor_critic",
    "init_mlp",
    "init_train_state",
    "reinforce",
    "train_chunk",
    "train_iteration",
]
