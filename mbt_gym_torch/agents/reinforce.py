"""Vanilla REINFORCE (counterpart of ``mbt_gym_tpu/agents/reinforce.py``;
reference ``mbt_gym/agents/PolicyGradientAgent.py``): a Gaussian policy
around an MLP mean with a fixed or scheduled exploration std, trained on
``-mean(log_probs * reward-to-go)`` with SGD and an exponentially decaying
rate (PolicyGradientAgent.py:49-73).

One :func:`train_epoch` is a rollout on the engine (the policy carries no
dispatch tag, so ``rollout``'s ``backend="auto"`` takes the engine, as in
the JAX package) and one gradient step.  The rate follows optax's
``sgd(exponential_decay(lr, 1, decay))``: ``torch.optim.SGD`` with an
``ExponentialLR(gamma=lr_decay)`` stepped after every update, so update
``k`` runs at ``lr * decay**k``.  :func:`train_epoch` returns a new state
and leaves the one it was given untouched, as the JAX function does (it
updates a copy of the parameters, with a new optimizer and schedule
loaded from the old ones' state).  Randomness comes from an int seed or a
``torch.Generator``: it drives the reset, the env noise and the policy's
exploration noise.  Everything runs on the device of the parameters.
"""
from __future__ import annotations

import copy
import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from mbt_gym_torch import env as env_lib
from mbt_gym_torch.agents import networks
from mbt_gym_torch.env import EnvConfig

_LOG_2PI = math.log(2.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class ReinforceConfig:
    """The JAX package's ``ReinforceConfig``, field for field."""

    learning_rate: float = 1e-1
    lr_decay: float = 0.995  # StepLR(step_size=1, gamma=0.995) equivalent
    action_std: float = 0.01
    # Linear std schedule: std(t) = action_std * (1 - t) + final_std * t over
    # training progress, mirroring the reference's callable-std option.
    final_action_std: Optional[float] = None
    hidden: Tuple[int, ...] = (64, 64)


class ReinforceTrainState(NamedTuple):
    params: nn.ModuleList  # the policy mean, networks.init_mlp's MLP
    opt_state: torch.optim.SGD  # over params.parameters()
    schedule: torch.optim.lr_scheduler.ExponentialLR  # steps opt_state's rate
    epoch: int


def make_optimizer(cfg: ReinforceConfig, params: nn.ModuleList):
    """``(SGD at cfg.learning_rate, its ExponentialLR(gamma=cfg.lr_decay))``:
    optax's ``sgd(exponential_decay(lr, transition_steps=1, decay_rate))``
    when the schedule steps once after every update."""
    optimizer = torch.optim.SGD(params.parameters(), lr=cfg.learning_rate)
    return optimizer, torch.optim.lr_scheduler.ExponentialLR(optimizer, gamma=cfg.lr_decay)


def init_train_state(env_cfg: EnvConfig, rf_cfg: ReinforceConfig, key, device=None) -> ReinforceTrainState:
    params = networks.init_mlp(key, [env_cfg.state_dim, *rf_cfg.hidden, env_cfg.action_dim], device=device,
                               dtype=env_cfg.torch_dtype)
    optimizer, schedule = make_optimizer(rf_cfg, params)
    return ReinforceTrainState(params=params, opt_state=optimizer, schedule=schedule, epoch=0)


def _current_std(rf_cfg: ReinforceConfig, progress: float) -> float:
    if rf_cfg.final_action_std is None:
        return rf_cfg.action_std
    return rf_cfg.action_std * (1.0 - progress) + rf_cfg.final_action_std * progress


def reward_to_go(rewards: torch.Tensor) -> torch.Tensor:
    """Flipped-cumsum reward-to-go over the time axis
    (PolicyGradientAgent.py:69-73)."""
    return torch.flip(torch.cumsum(torch.flip(rewards, dims=(0,)), dim=0), dims=(0,))


def trajectory_loss(params: nn.ModuleList, trajectory, std) -> torch.Tensor:
    """``-mean(log_probs * reward-to-go)`` of a trajectory held as data: the
    log-probs are recomputed, differentiably in ``params``, from the stored
    observations and actions (reinforce.py:86-92)."""
    means = networks.mlp_apply(params, trajectory.observations[:-1])  # (T, N, A)
    std = torch.as_tensor(std, dtype=means.dtype, device=means.device)
    z = (trajectory.actions - means) / std
    log_probs = torch.sum(-0.5 * z**2 - torch.log(std) - 0.5 * _LOG_2PI, dim=-1)
    return -torch.mean(log_probs * reward_to_go(trajectory.rewards))


def _epoch_loss(params: nn.ModuleList, env_cfg: EnvConfig, std: float, key):
    """``(loss, mean episode reward)`` of one fresh episode.  The rollout
    runs without autograd: the trajectory is data, as the reference's
    sampled actions are detached constants (PolicyGradientAgent.py:55-67).
    Traced differentiably instead, the score term would cancel (z equals
    the exploration noise, independent of the parameters), the trap the
    JAX package documents at reinforce.py:77-86."""
    from mbt_gym_torch.rollout import rollout

    device = next(params.parameters()).device
    gen = env_lib.make_generator(key, device)

    def policy(p, obs, state):
        mean = networks.mlp_apply(p, obs)
        eps = torch.randn(mean.shape, generator=gen, dtype=mean.dtype, device=device)
        return mean + std * eps

    with torch.no_grad():
        trajectory = rollout(env_cfg, policy, params, gen, device=device).trajectory
    return trajectory_loss(params, trajectory, std), trajectory.rewards.sum(dim=0).mean()


def train_epoch(env_cfg: EnvConfig, rf_cfg: ReinforceConfig, state: ReinforceTrainState, key,
                num_epochs: int = 1) -> Tuple[ReinforceTrainState, Dict[str, torch.Tensor]]:
    """One rollout and one SGD step; returns the new state and
    ``{"loss", "mean_episode_reward"}``.  ``num_epochs`` sets the progress
    of the std schedule (``epoch / (num_epochs - 1)``).  ``key`` is an int
    seed or a ``torch.Generator`` on the parameters' device."""
    params = copy.deepcopy(state.params)
    optimizer, schedule = make_optimizer(rf_cfg, params)
    optimizer.load_state_dict(state.opt_state.state_dict())
    schedule.load_state_dict(state.schedule.state_dict())
    std = _current_std(rf_cfg, state.epoch / max(num_epochs - 1, 1))
    loss, mean_reward = _epoch_loss(params, env_cfg, std, key)
    loss.backward()
    optimizer.step()
    schedule.step()
    new_state = ReinforceTrainState(params=params, opt_state=optimizer, schedule=schedule, epoch=state.epoch + 1)
    return new_state, {"loss": loss.detach(), "mean_episode_reward": mean_reward}
