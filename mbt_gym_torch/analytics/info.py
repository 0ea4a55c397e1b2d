"""Info dicts (counterpart of ``mbt_gym_tpu/analytics/info.py``; reference
``mbt_gym/gym/info_calculators.py``).

The reference's ``ActionInfoCalculator`` accumulates actions in a host
buffer and emits per-trajectory mean actions at episode end (SB3
VecMonitor convention; its ``ndarray.nanmean`` call at
info_calculators.py:52 is a latent AttributeError — the intent is
implemented here).  Here the infos are computed after a rollout from the
stacked trajectory, with one copy to the host.
"""
from __future__ import annotations

from typing import Dict, List

from mbt_gym_torch.analytics import time_major


def mean_action_infos(traj) -> List[Dict[str, float]]:
    """Per-trajectory mean actions over the episode, as the list of dicts
    the reference emits at the terminal step (info_calculators.py:36-44)."""
    mean_actions = time_major(traj).actions.mean(dim=0).cpu().numpy()  # (N, A)
    return [
        {f"action_{j}": float(mean_actions[i, j]) for j in range(mean_actions.shape[1])}
        for i in range(mean_actions.shape[0])
    ]


def episode_return_infos(traj) -> List[Dict[str, float]]:
    """Per-trajectory episodic return (VecMonitor-style 'episode' infos)."""
    rewards = time_major(traj).rewards
    totals = rewards.sum(dim=0).cpu().numpy()
    length = rewards.shape[0]
    return [{"episode": {"r": float(r), "l": length}} for r in totals]
