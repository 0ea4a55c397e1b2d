"""Reward functions (counterpart of ``mbt_gym_tpu/rewards.py``; reference
``mbt_gym/rewards/RewardFunctions.py``).

Pure functions of (current, action, next, is_terminal, aux) where
``current``/``next`` are :class:`AgentStateView` snapshots and ``aux``
carries the reset-time quantities (initial inventory and episode length,
RewardFunctions.py:72-74,111-113).  All return ``(N,)`` rewards: PnL, the
three Cartea-Jaimungal inventory criteria and the exponential utility.
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


@dataclasses.dataclass(frozen=True)
class RunningInventoryPenalty:
    """PnL - dt*phi*q'^exp - alpha*1[terminal]*q'^exp
    (RewardFunctions.py:116-141).  Alias: ``CjCriterion``."""

    per_step_inventory_aversion: float = 0.01
    terminal_inventory_aversion: float = 0.0
    inventory_exponent: float = 2.0

    def calculate(self, current, action, next, is_terminal, aux):
        dt = next.time - current.time
        q_pow = next.inventory**self.inventory_exponent
        pnl = mark_to_market(next) - mark_to_market(current)
        terminal = torch.as_tensor(is_terminal, dtype=pnl.dtype, device=pnl.device)
        return (
            pnl
            - dt * self.per_step_inventory_aversion * q_pow
            - self.terminal_inventory_aversion * terminal * q_pow
        )


CjCriterion = RunningInventoryPenalty


@dataclasses.dataclass(frozen=True)
class CjMmCriterion:
    """Cartea-Jaimungal market-making criterion with the terminal inventory
    penalty decomposed pathwise via Ito's lemma for Poisson processes
    (RewardFunctions.py:77-113).  Telescopes to the same episode total as
    :class:`RunningInventoryPenalty`."""

    per_step_inventory_aversion: float = 0.01
    terminal_inventory_aversion: float = 0.0
    inventory_exponent: float = 2.0
    terminal_time: float = 1.0

    def calculate(self, current, action, next, is_terminal, aux):
        dt = next.time - current.time
        exp = self.inventory_exponent
        pnl = mark_to_market(next) - mark_to_market(current)
        return (
            pnl
            - dt * self.per_step_inventory_aversion * next.inventory**exp
            - self.terminal_inventory_aversion
            * (
                next.inventory**exp
                - current.inventory**exp
                + dt / aux.episode_length * aux.initial_inventory**exp
            )
        )


@dataclasses.dataclass(frozen=True)
class CjOeCriterion:
    """Cartea-Jaimungal optimal-execution criterion with the terminal
    aversion spread over steps using the action and the initial inventory
    (RewardFunctions.py:39-74)."""

    per_step_inventory_aversion: float = 0.01
    terminal_inventory_aversion: float = 0.0
    inventory_exponent: float = 2.0
    terminal_time: float = 1.0

    def calculate(self, current, action, next, is_terminal, aux):
        dt = next.time - current.time
        exp = self.inventory_exponent
        pnl = mark_to_market(next) - mark_to_market(current)
        speed = action.squeeze(-1) if action.ndim > 1 else action
        return (
            pnl
            - dt * self.per_step_inventory_aversion * next.inventory**exp
            - dt
            * self.terminal_inventory_aversion
            * (
                exp * speed * current.inventory ** (exp - 1)
                + aux.initial_inventory**exp * aux.episode_length
            )
        )


@dataclasses.dataclass(frozen=True)
class ExponentialUtility:
    """``-exp(-gamma * terminal wealth)`` at the terminal step, else 0
    (RewardFunctions.py:149-166)."""

    risk_aversion: float = 0.1

    def calculate(self, current, action, next, is_terminal, aux):
        utility = -torch.exp(-self.risk_aversion * mark_to_market(next))
        terminal = torch.as_tensor(is_terminal, dtype=utility.dtype, device=utility.device)
        return terminal * utility
