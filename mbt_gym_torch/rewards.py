"""Reward functions (counterpart of ``mbt_gym_tpu/rewards.py``; reference
``mbt_gym/rewards/RewardFunctions.py``).

Pure functions of (current, action, next, is_terminal, aux) where
``current``/``next`` are :class:`AgentStateView` snapshots and ``aux``
carries the reset-time quantities (initial inventory and episode length,
RewardFunctions.py:72-74,111-113).  All return ``(N,)`` rewards.  The port
carries the PnL reward only.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


class AgentStateView(NamedTuple):
    """The slice of env state that rewards read (index_names.py:1-4)."""

    cash: torch.Tensor  # (N,)
    inventory: torch.Tensor  # (N,)
    time: torch.Tensor  # (N,)
    price: torch.Tensor  # (N,) — midprice (ASSET_PRICE_INDEX column)


class RewardAux(NamedTuple):
    initial_inventory: torch.Tensor  # (N,)
    episode_length: torch.Tensor  # () — terminal_time - start_time


def mark_to_market(view: AgentStateView) -> torch.Tensor:
    return view.cash + view.inventory * view.price


@dataclasses.dataclass(frozen=True)
class PnL:
    """Change in mark-to-market portfolio value (RewardFunctions.py:20-36)."""

    def calculate(self, current, action, next, is_terminal, aux):
        return mark_to_market(next) - mark_to_market(current)
