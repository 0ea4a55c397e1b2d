"""Functional wrappers (counterpart of ``mbt_gym_tpu/wrappers.py``;
reference ``mbt_gym/gym/wrappers.py``), as config and function transforms:

- :func:`reduce_observation` / :func:`reduced_obs_policy` — train and act on
  a column subset (ReduceStateSizeWrapper, wrappers.py:10-43);
- the config's ``normalise_observation_space`` covers
  ``NormaliseASObservation`` (wrappers.py:46-76); :func:`normalise_obs` is
  the standalone map, both directions;
- :class:`TerminalRewardScaling` — rescale the terminal step's reward
  (RemoveTerminalRewards, wrappers.py:79-105).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from mbt_gym_torch.env import EnvConfig
from mbt_gym_torch.types import INVENTORY_INDEX, TIME_INDEX

DEFAULT_REDUCED_INDICES = (INVENTORY_INDEX, TIME_INDEX)


def reduce_observation(obs: torch.Tensor, indices: Sequence[int] = DEFAULT_REDUCED_INDICES) -> torch.Tensor:
    """The ``indices`` columns of ``(N, S)`` observations, in that order."""
    return obs[:, list(indices)]


def reduced_obs_policy(policy, indices: Sequence[int] = DEFAULT_REDUCED_INDICES):
    """Adapt a policy trained on reduced observations to the full obs."""

    def wrapped(params, obs, state):
        return policy(params, reduce_observation(obs, indices), state)

    return wrapped


def reduced_observation_bounds(
    cfg: EnvConfig, indices: Sequence[int] = DEFAULT_REDUCED_INDICES
) -> Tuple[np.ndarray, np.ndarray]:
    low, high = cfg.observation_bounds()
    idx = list(indices)
    return low[idx], high[idx]


def normalise_obs(cfg: EnvConfig, obs: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Standalone linear map of the observation space to [-1, 1]
    (NormaliseASObservation, wrappers.py:46-76), or back with ``inverse``;
    the bounds in ``obs``'s dtype on its device."""
    low, high = (torch.as_tensor(b, dtype=obs.dtype, device=obs.device) for b in cfg.observation_bounds())
    gradient = (high - low) / 2
    if inverse:
        return (obs + 1.0) * gradient + low
    return (obs - low) / gradient - 1.0


@dataclasses.dataclass(frozen=True)
class TerminalRewardScaling:
    """Rescale the reward at the terminal step by ``scale`` — the
    generalisation of RemoveTerminalRewards' ``phi/alpha`` rescaling
    (wrappers.py:96-105).  A reward function: ``base`` is the wrapped one."""

    base: object
    scale: float

    def calculate(self, current, action, next, is_terminal, aux):
        reward = self.base.calculate(current, action, next, is_terminal, aux)
        terminal = torch.as_tensor(is_terminal, dtype=reward.dtype, device=reward.device)
        return reward * (1.0 + terminal * (self.scale - 1.0))
