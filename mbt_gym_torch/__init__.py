"""mbt_gym_torch — the PyTorch/CUDA port of ``mbt_gym_tpu`` for NVIDIA
Hopper (H100): model-based limit-order-book trading environments stepping
many Monte-Carlo trajectories in lockstep.

The port keeps the JAX package's module layout, names and tensor layouts;
the JAX package in this repository is its reference.  Entry points run on
the CUDA device unless the caller passes ``device="cpu"``.  The port covers
the Avellaneda-Stoikov main path (the engine, the AS agent, ``rollout`` /
``mc_episode_stats`` and the CUDA episode kernels K1/K2 behind
``backend="auto"``), PPO training on that env with either actor-critic
layout (``agents.ppo``: the engine path, the CUDA kernels K3, the MLP
rollout, K4, the feature-major PPO update, and K7, the row-major one),
and the closed-form Cartea-Jaimungal paths: the
CJP market maker, the optimal-execution schedule and fixed actions on the
deterministic-policy kernel K5, the OE episode kernel K6, and the CJP
value-function lane :func:`cj_episode_rewards` on K8.  PPO also trains on
the CJ market-making env with the CjMm or running-penalty reward through
K3; ``agents.reinforce`` is the REINFORCE learner; :mod:`wrappers` holds
the observation and reward transforms, and
:func:`with_normalised_rewards` the reference's reward normalisation.  The
at-the-touch and limit-and-market-order dynamics run on the engine, K3
(PPO, including the reference's canonical learning env with its random
initial inventory) and K5's fixed kind.  Every stochastic-process model
of the JAX package (ten midprice, three arrival, four fill and four
impact models) runs on the engine, K3 and K5, and so does the composite
stress config :func:`composite_env_config` (Hawkes arrivals, exogenous
competing-market-maker fills, limit and market orders).

The training and interop surfaces: :mod:`checkpoint` saves and resumes a
bundle (env state, PPO train state, generator) bit for bit;
:mod:`gym_compat` wraps the engine as a gymnasium ``Env``, an SB3
``VecEnv`` and a gymnasium ``VectorEnv``; :mod:`agents.external` turns a
host model (an SB3 ``predict``, any numpy function) into a policy;
:mod:`analytics` holds the backtest statistics, diagnostics, info dicts
and plots; :mod:`utils.profiling` the profiler trace and throughput
harness, :mod:`utils.tblog` TensorBoard logging; :mod:`parallel.mesh`
trains data-parallel over a ``torch.distributed`` process group (NCCL on
cards, Gloo on the CPU) through ``train_iteration(..., mesh=)``; and
:mod:`entry` holds the flagship forward step, the PPO metric bands and
``dryrun_multichip``.  The compiled entry points :func:`jit_rollout`,
``agents.ppo.jit_train_iteration`` / ``jit_train_chunk`` and
``agents.reinforce.jit_train_epoch`` replay CUDA graphs of the engine and
of the learners' iterations on the card (:mod:`compiled`); on the CPU they
run the eager functions.  gymnasium, tensorboard and matplotlib are optional:
the surface that needs one raises ``ImportError`` without it.
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
from mbt_gym_torch.rollout import RolloutResult, episode_stats, jit_rollout, mc_episode_stats, rollout
from mbt_gym_torch.agents.ppo import PPOConfig, init_train_state, train_chunk, train_iteration
from mbt_gym_torch.agents.baseline import (
    AvellanedaStoikovAgent,
    CarteaJaimungalMmAgent,
    CarteaJaimungalOeAgent,
    fixed_action_policy,
)
from mbt_gym_torch.ops.cj_episode import cj_episode_rewards
from mbt_gym_torch.ops.oe_episode import oe_episode_rewards
from mbt_gym_torch.utils.config import (
    as_env_config,
    cj_env_config,
    composite_env_config,
    lam_env_config,
    learning_env_config,
    oe_env_config,
    touch_env_config,
)
from mbt_gym_torch.utils.reward_scaling import compute_inventory_neutral_reward_scaling, with_normalised_rewards
from mbt_gym_torch import wrappers

__version__ = "0.1.0"

__all__ = [
    "ASK_INDEX",
    "ASSET_PRICE_INDEX",
    "AvellanedaStoikovAgent",
    "BID_INDEX",
    "CASH_INDEX",
    "CarteaJaimungalMmAgent",
    "CarteaJaimungalOeAgent",
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
    "as_env_config",
    "cj_env_config",
    "composite_env_config",
    "cj_episode_rewards",
    "compute_inventory_neutral_reward_scaling",
    "default_dynamics",
    "episode_stats",
    "fixed_action_policy",
    "init_train_state",
    "jit_rollout",
    "lam_env_config",
    "learning_env_config",
    "mc_episode_stats",
    "observe",
    "oe_env_config",
    "oe_episode_rewards",
    "reset",
    "rollout",
    "step",
    "touch_env_config",
    "train_chunk",
    "train_iteration",
    "with_normalised_rewards",
    "wrappers",
]
