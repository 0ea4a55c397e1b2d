"""Closed-form and baseline agents (counterpart of
``mbt_gym_tpu/agents/baseline.py``; reference
``mbt_gym/agents/BaselineAgents.py``) as policies
``policy(params, obs, state) -> (N, A)`` for :func:`mbt_gym_torch.rollout.rollout`.

Each policy carries a ``dispatch_meta`` tag naming its kind, which
:func:`mbt_gym_torch.dispatch.dispatch_report` reads.  The port carries the
AS agent and the fixed-action policy.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mbt_gym_torch.dispatch import tag_policy
from mbt_gym_torch.env import EnvConfig
from mbt_gym_torch.types import INVENTORY_INDEX, TIME_INDEX


def fixed_action_policy(fixed_action):
    """Constant action for every trajectory (BaselineAgents.py:25-31).
    Tagged ``kind="fixed"``; its kernel family is not ported yet, so it
    runs on the engine."""
    fixed = np.asarray(fixed_action, dtype=np.float64).reshape(-1)

    def policy(params, obs, state):
        action = torch.as_tensor(fixed, dtype=obs.dtype, device=obs.device)
        return action.expand(obs.shape[0], fixed.shape[-1])

    return tag_policy(policy, kind="fixed", action=tuple(float(x) for x in fixed))


@dataclasses.dataclass(frozen=True)
class AvellanedaStoikovAgent:
    """AS-2008 closed-form market maker (BaselineAgents.py:52-83).

    Quotes a reservation-price skew ``q * gamma * sigma^2 * (T - t)`` plus
    half the optimal spread ``gamma sigma^2 (T-t) + (2/gamma) ln(1+gamma/k)``.
    Parameters are read off the env config (volatility from the midprice
    model, fill exponent from the fill model), as the reference does.
    """

    risk_aversion: float = 0.1
    volatility: float = 2.0
    fill_exponent: float = 1.5
    terminal_time: float = 1.0

    @classmethod
    def from_config(cls, cfg: EnvConfig, risk_aversion: float = 0.1) -> "AvellanedaStoikovAgent":
        return cls(
            risk_aversion=risk_aversion,
            volatility=cfg.dynamics.midprice_model.volatility,
            fill_exponent=cfg.dynamics.fill_probability_model.fill_exponent,
            terminal_time=cfg.terminal_time,
        )

    def policy(self):
        gamma, sigma, k, T = self.risk_aversion, self.volatility, self.fill_exponent, self.terminal_time

        def policy_fn(params, obs, state):
            inventory = obs[:, INVENTORY_INDEX]
            time = obs[:, TIME_INDEX]
            skew = inventory * gamma * sigma**2 * (T - time)
            if gamma == 0:
                spread = torch.full_like(time, 2.0 / k)  # risk-neutral limit
            else:
                spread = gamma * sigma**2 * (T - time) + (2.0 / gamma) * np.log(1 + gamma / k)
            return torch.stack([skew + spread / 2, -skew + spread / 2], dim=1)

        return tag_policy(policy_fn, kind="as_closed_form", agent=self)
