"""Vanilla REINFORCE (counterpart of ``mbt_gym_tpu/agents/reinforce.py``;
reference ``mbt_gym/agents/PolicyGradientAgent.py``): a Gaussian policy
around an MLP mean with a fixed or scheduled exploration std, trained on
``-mean(log_probs * reward-to-go)`` with SGD and an exponentially decaying
rate (PolicyGradientAgent.py:49-73).

One :func:`train_epoch` is a rollout on the engine (the policy carries no
dispatch tag, so ``rollout``'s ``backend="auto"`` takes the engine, as in
the JAX package) and one gradient step.  The rate follows optax's
``sgd(exponential_decay(lr, 1, decay))``: update ``k`` runs at
``lr * decay**k``, computed from the state's epoch as JAX computes it from
its step count, and :func:`sgd_step` applies it as optax does,
``p - lr * grad``, with the rate and the exploration std 0-d tensors on
the parameters' device, so that :func:`jit_train_epoch`'s captured epoch
reads each epoch's values from its inputs.  The state's
``torch.optim.SGD`` and ``ExponentialLR`` are set to the epoch's rate
(:func:`make_optimizer`'s pair, for a caller that steps them itself);
no update goes through them.  :func:`train_epoch` returns a new state and
leaves the one it was given untouched, as the JAX function does.
Randomness comes from an int seed or a ``torch.Generator``: it drives the
reset, the env noise and the policy's exploration noise.  Everything runs
on the device of the parameters.
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
    return _state_at(rf_cfg, params, 0)


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


def _epoch_loss(params: nn.ModuleList, env_cfg: EnvConfig, std: torch.Tensor, key):
    """``(loss, mean episode reward)`` of one fresh episode, ``std`` a 0-d
    tensor.  The rollout runs without autograd: the trajectory is data, as
    the reference's sampled actions are detached constants
    (PolicyGradientAgent.py:55-67).  Traced differentiably instead, the
    score term would cancel (z equals the exploration noise, independent of
    the parameters), the trap the JAX package documents at
    reinforce.py:77-86."""
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


def sgd_step(params: nn.ModuleList, lr: torch.Tensor) -> None:
    """One SGD update of every parameter in place, ``p - lr * grad``, as
    optax's ``sgd`` computes it; ``lr`` is a 0-d tensor on the parameters'
    device."""
    with torch.no_grad():
        for p in params.parameters():
            p.sub_(lr * p.grad)


def _epoch_update(params: nn.ModuleList, env_cfg: EnvConfig, std: torch.Tensor, lr: torch.Tensor, key):
    """One epoch's rollout and SGD step on ``params``, in place; returns
    ``(loss, mean episode reward)``."""
    loss, mean_reward = _epoch_loss(params, env_cfg, std, key)
    loss.backward()
    sgd_step(params, lr)
    return loss.detach(), mean_reward


def learning_rate(rf_cfg: ReinforceConfig, epoch: int) -> float:
    """The rate of update ``epoch``: optax's ``exponential_decay(lr, 1,
    decay)`` at step ``epoch``, ``lr * decay**epoch``."""
    return rf_cfg.learning_rate * rf_cfg.lr_decay**epoch


def _epoch_rates(rf_cfg: ReinforceConfig, state: ReinforceTrainState, num_epochs: int) -> Tuple[float, float]:
    """``(exploration std, learning rate)`` of the epoch ``state`` is at."""
    return _current_std(rf_cfg, state.epoch / max(num_epochs - 1, 1)), learning_rate(rf_cfg, state.epoch)


def _state_at(rf_cfg: ReinforceConfig, params: nn.ModuleList, epoch: int) -> ReinforceTrainState:
    """The train state at ``epoch`` over ``params``: its SGD at the epoch's
    rate, its schedule ``epoch`` steps on."""
    optimizer, schedule = make_optimizer(rf_cfg, params)
    rate = learning_rate(rf_cfg, epoch)
    optimizer.param_groups[0]["lr"] = rate
    schedule.load_state_dict({**schedule.state_dict(), "last_epoch": epoch, "_last_lr": [rate]})
    return ReinforceTrainState(params=params, opt_state=optimizer, schedule=schedule, epoch=epoch)


def train_epoch(env_cfg: EnvConfig, rf_cfg: ReinforceConfig, state: ReinforceTrainState, key,
                num_epochs: int = 1) -> Tuple[ReinforceTrainState, Dict[str, torch.Tensor]]:
    """One rollout and one SGD step; returns the new state and
    ``{"loss", "mean_episode_reward"}``.  ``num_epochs`` sets the progress
    of the std schedule (``epoch / (num_epochs - 1)``).  ``key`` is an int
    seed or a ``torch.Generator`` on the parameters' device."""
    params = copy.deepcopy(state.params)
    first = next(params.parameters())
    std, lr = (torch.full((), v, dtype=first.dtype, device=first.device)
               for v in _epoch_rates(rf_cfg, state, num_epochs))
    loss, mean_reward = _epoch_update(params, env_cfg, std, lr, key)
    return _state_at(rf_cfg, params, state.epoch + 1), {"loss": loss, "mean_episode_reward": mean_reward}


def jit_train_epoch(env_cfg: EnvConfig, rf_cfg: ReinforceConfig, state: ReinforceTrainState, key,
                    num_epochs: int = 1) -> Tuple[ReinforceTrainState, Dict[str, torch.Tensor]]:
    """:func:`train_epoch` compiled (reinforce.py:116-118): on the card, one
    replay of a CUDA graph of the epoch (:mod:`mbt_gym_torch.compiled`),
    the epoch's std and rate its inputs; bit for bit :func:`train_epoch`
    for the same int ``key``.  On the CPU it is :func:`train_epoch`."""
    from mbt_gym_torch import compiled

    return compiled.train_epoch(env_cfg, rf_cfg, state, key, num_epochs)
