"""Host-model policy adapter (counterpart of ``mbt_gym_tpu/agents/external.py``
and of the reference's ``SbAgent``, mbt_gym/agents/SbAgent.py): drive
rollouts with any host-side model — a Stable-Baselines3 ``predict``, a
PyTorch module run on the CPU, any NumPy function.

Every step crosses the host: the observations are copied from their
device to host NumPy, ``predict`` runs there, and its actions are copied
back to the observations' device and dtype.  This is for evaluating
externally trained models, not for training throughput (the on-device
learners live in :mod:`mbt_gym_torch.agents.ppo` and
:mod:`mbt_gym_torch.agents.reinforce`).  The policy carries no dispatch
metadata, so ``rollout(..., backend="auto")`` runs it on the engine and
says so (:func:`mbt_gym_torch.dispatch.dispatch_report`).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch


def host_model_policy(
    predict: Callable[[np.ndarray], np.ndarray],
    action_dim: int,
    reduced_obs_indices: Optional[Sequence[int]] = None,
):
    """A rollout policy ``(params, obs (N, S), state) -> (N, A)`` from a
    host-side ``predict(obs (N, S')) -> (N, A)``.

    ``reduced_obs_indices`` mirrors SbAgent's ``reduced_training_indices``
    (SbAgent.py:9-17): the host model sees only those observation columns."""
    index = None if reduced_obs_indices is None else list(reduced_obs_indices)

    def policy(params, obs, state):
        sliced = obs if index is None else obs[:, index]
        host = sliced.detach().cpu().numpy()
        out = np.asarray(predict(host), dtype=host.dtype).reshape(host.shape[0], action_dim)
        return torch.from_numpy(out).to(device=obs.device, dtype=obs.dtype)

    return policy


def sb3_policy(model, action_dim: Optional[int] = None, reduced_obs_indices=None):
    """Wrap a Stable-Baselines3 ``BaseAlgorithm`` (or anything with its
    ``predict``), deterministic, as SbAgent.get_action does (SbAgent.py:19-23)."""
    if action_dim is None:
        action_dim = int(model.action_space.shape[0])

    def predict(obs):
        return model.predict(obs, deterministic=True)[0]

    return host_model_policy(predict, action_dim, reduced_obs_indices)
