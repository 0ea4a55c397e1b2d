"""Price-impact models (counterpart of ``mbt_gym_tpu/processes/impact.py``;
reference ``mbt_gym/stochastic_processes/price_impact_models.py``).

An impact model exposes ``get_impact(state, action) -> (N, 1)`` price
displacement and a ``max_speed`` bound for the trading-speed action space.
The env calls ``get_impact`` with the *pre-update* state during agent
bookkeeping and only afterwards advances the impact state
(TradingEnvironment.py:198-216).  The port carries the temporary-and-
permanent model of the optimal-execution config; the other three are not
ported yet (ROADMAP.md Queue 1 item 7).
"""
from __future__ import annotations

from mbt_gym_torch.processes.base import ProcessBase, process_dataclass


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
