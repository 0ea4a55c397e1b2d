"""mbt_gym_torch — the PyTorch/CUDA port of ``mbt_gym_tpu`` for NVIDIA
Hopper (H100): model-based limit-order-book trading environments stepping
many Monte-Carlo trajectories in lockstep.

The port keeps the JAX package's module layout, names and tensor layouts;
the JAX package in this repository is its reference.  Entry points run on
the CUDA device unless the caller passes ``device="cpu"``.  The port covers
the Avellaneda-Stoikov main path (the engine, the AS agent, ``rollout`` /
``mc_episode_stats`` and the CUDA episode kernels K1/K2 behind
``backend="auto"``) and PPO training on that env (``agents.ppo``: the
engine path, and the fused path on the CUDA kernels K3, the MLP rollout,
and K4, the PPO update).
"""

from mbt_gym_torch.types import (
    ASK_INDEX,
    ASSET_PRICE_INDEX,
    BID_INDEX,
    CASH_INDEX,
    EnvState,
    INVENTORY_INDEX,
    SlotNoise,
    StepNoise,
    StepResult,
    TIME_INDEX,
    Trajectory,
    TrajectoryT,
)
from mbt_gym_torch.dispatch import DispatchDecision, dispatch_report
from mbt_gym_torch.env import EnvConfig, default_dynamics, reset, step, observe
from mbt_gym_torch.rollout import RolloutResult, episode_stats, mc_episode_stats, rollout
from mbt_gym_torch.agents.ppo import PPOConfig, init_train_state, train_chunk, train_iteration

__version__ = "0.1.0"

__all__ = [
    "ASK_INDEX",
    "ASSET_PRICE_INDEX",
    "BID_INDEX",
    "CASH_INDEX",
    "DispatchDecision",
    "dispatch_report",
    "EnvConfig",
    "EnvState",
    "INVENTORY_INDEX",
    "PPOConfig",
    "RolloutResult",
    "SlotNoise",
    "StepNoise",
    "StepResult",
    "TIME_INDEX",
    "Trajectory",
    "TrajectoryT",
    "default_dynamics",
    "episode_stats",
    "init_train_state",
    "mc_episode_stats",
    "observe",
    "reset",
    "rollout",
    "step",
    "train_chunk",
    "train_iteration",
]
