"""Price-impact models (counterpart of ``mbt_gym_tpu/processes/impact.py``;
reference ``mbt_gym/stochastic_processes/price_impact_models.py``).

An impact model exposes ``get_impact(state, action) -> (N, 1)`` price
displacement and a ``max_speed`` bound for the trading-speed action space.
The env calls ``get_impact`` with the *pre-update* state during agent
bookkeeping and only afterwards advances the impact state
(TradingEnvironment.py:198-216).  The four reference models: temporary
power impact (stateless), temporary and permanent impact (the
optimal-execution config's), and the two transient models with
exponential resilience.
"""
from __future__ import annotations

import torch

from mbt_gym_torch.processes.base import ProcessBase, process_dataclass


@process_dataclass
class TemporaryPowerImpact(ProcessBase):
    """Stateless: ``impact = c * speed^exponent`` (price_impact_models.py:34-61)."""

    temporary_impact_coefficient: float = 0.01
    temporary_impact_exponent: float = 1.0

    def get_impact(self, state, action):
        return self.temporary_impact_coefficient * action[:, 0:1] ** self.temporary_impact_exponent

    @property
    def max_speed(self) -> float:
        return 100.0


@process_dataclass
class TemporaryAndPermanentImpact(ProcessBase):
    """State = accumulated permanent impact; ``state += perm*speed*dt``;
    ``impact = temp*speed + state`` (price_impact_models.py:64-96).
    Used by the Cartea-Jaimungal optimal-execution configuration."""

    temporary_impact_coefficient: float = 0.01
    permanent_impact_coefficient: float = 0.01
    terminal_time: float = 1.0
    state_dim = 1

    def bounds(self):
        bound = self.max_speed * self.terminal_time * self.permanent_impact_coefficient
        return ((-bound,), (bound,))

    def update(self, state, arrivals, fills, action, noise, dt):
        return state + self.permanent_impact_coefficient * action[:, 0:1] * dt

    def get_impact(self, state, action):
        return self.temporary_impact_coefficient * action[:, 0:1] + state

    @property
    def max_speed(self) -> float:
        return 10.0


class _Transient(ProcessBase):
    """The resilience recursion ``state += -rho*state*dt + gamma*speed*dt``
    from ``initial_transient_impact``."""

    state_dim = 1

    def initial_state(self, n, dtype=torch.float32, device=None):
        return torch.full((n, 1), self.initial_transient_impact, dtype=dtype, device=device)

    def bounds(self):
        bound = self.max_speed * self.terminal_time * self.transient_impact_coefficient
        return ((-bound,), (bound,))

    def update(self, state, arrivals, fills, action, noise, dt):
        return (
            state
            - self.resilience_coefficient * state * dt
            + self.linear_kernel_coefficient * action[:, 0:1] * dt
        )

    @property
    def max_speed(self) -> float:
        return 10.0


@process_dataclass
class TemporaryAndTransientImpact(_Transient):
    """Neuman-Voss (2022) transient impact with exponential resilience;
    ``impact = temp*speed + kappa*state`` (price_impact_models.py:99-138)."""

    temporary_impact_coefficient: float = 0.01
    transient_impact_coefficient: float = 0.01  # kappa
    resilience_coefficient: float = 0.01  # rho
    initial_transient_impact: float = 0.01  # y
    linear_kernel_coefficient: float = 0.01  # gamma
    terminal_time: float = 1.0

    def get_impact(self, state, action):
        return self.temporary_impact_coefficient * action[:, 0:1] + self.transient_impact_coefficient * state


@process_dataclass
class TransientImpact(_Transient):
    """Same resilience recursion, ``impact = kappa*state`` only
    (price_impact_models.py:142-179)."""

    transient_impact_coefficient: float = 0.01  # kappa
    resilience_coefficient: float = 0.01  # rho
    initial_transient_impact: float = 0.01  # y
    linear_kernel_coefficient: float = 0.01  # gamma
    terminal_time: float = 1.0

    def get_impact(self, state, action):
        return self.transient_impact_coefficient * state
