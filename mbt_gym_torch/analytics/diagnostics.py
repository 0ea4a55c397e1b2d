"""Post-hoc diagnostics (counterpart of ``mbt_gym_tpu/analytics/diagnostics.py``):
trajectory checks in place of the reference's host-side warnings (the
negative-spread warning, BaselineAgents.py:66-67; the clip prints,
TradingEnvironment.py:283-297)."""
from __future__ import annotations

import torch

from mbt_gym_torch.analytics import time_major
from mbt_gym_torch.types import EnvState


def negative_spread_fraction(traj) -> torch.Tensor:
    """Fraction of (step, env) quotes with a negative depth on either side —
    the reference's AS agent warns when ``action.min() < 0``
    (BaselineAgents.py:66-67).  The inventory skew cancels in the total
    bid + ask spread, so the per-side check is the meaningful one."""
    actions = time_major(traj).actions
    if actions.shape[-1] < 2:
        return torch.zeros((), dtype=actions.dtype, device=actions.device)
    return (actions[..., 0:2].min(dim=-1).values < 0).to(actions.dtype).mean()


def clip_event_count(state: EnvState) -> torch.Tensor:
    """Number of steps on which any cash/inventory clip occurred (the
    engine's replacement for the reference's printed warnings; the episode
    kernels read 0)."""
    return state.clip_events


def max_abs_inventory(traj) -> torch.Tensor:
    return torch.abs(time_major(traj).observations[:, :, 1]).max()
