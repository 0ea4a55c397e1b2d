"""Order-arrival models (counterpart of ``mbt_gym_tpu/processes/arrivals.py``).

``get_arrivals(state, uniform, dt) -> (N, 2)``: column 0 is an exogenous
SELL order arriving on the buy side, column 1 an exogenous BUY order on the
sell side (arrival_models.py:9-13), as 0.0/1.0 in the state dtype.  The
three reference models: linear and exact-probability Poisson thinning, and
Hawkes self-exciting arrivals with a 2-dim intensity state."""
from __future__ import annotations

from typing import Tuple

import torch

from mbt_gym_torch.processes.base import ProcessBase, process_dataclass
from mbt_gym_torch.types import device_constant


def _rates(rates, like: torch.Tensor) -> torch.Tensor:
    return device_constant(tuple(float(r) for r in rates), like.dtype, like.device)


@process_dataclass
class PoissonArrivals(ProcessBase):
    """Stateless Bernoulli thinning: ``uniform < intensity*dt``
    (arrival_models.py:32-56).  Default arrival model."""

    intensity: Tuple[float, float] = (140.0, 140.0)

    def noise_spec(self):
        return (0, 2)

    def get_arrivals(self, state, uniform, dt):
        probs = _rates(self.intensity, uniform) * dt
        return (uniform < probs).to(uniform.dtype)


@process_dataclass
class PoissonArrivalsNonLinear(ProcessBase):
    """Exact per-step arrival probability ``1 - exp(-intensity*dt)``
    (arrival_models.py:59-83)."""

    intensity: Tuple[float, float] = (140.0, 140.0)

    def noise_spec(self):
        return (0, 2)

    def get_arrivals(self, state, uniform, dt):
        probs = 1.0 - torch.exp(-_rates(self.intensity, uniform) * dt)
        return (uniform < probs).to(uniform.dtype)


@process_dataclass
class HawkesArrivals(ProcessBase):
    """Self-exciting arrivals; state = 2-dim intensity (arrival_models.py:86-129).

    ``get_arrivals`` thins against the *current* intensity; ``update`` then
    mean-reverts towards the baseline and adds ``jump_size * arrivals``,
    the reference's operation order."""

    baseline_arrival_rate: Tuple[float, float] = (10.0, 10.0)
    jump_size: float = 40.0
    mean_reversion_speed: float = 60.0
    state_dim = 2

    def noise_spec(self):
        return (0, 2)

    def initial_state(self, n, dtype=torch.float32, device=None):
        rates = device_constant(tuple(float(r) for r in self.baseline_arrival_rate), dtype, device)
        return rates.expand(n, 2).clone()

    def bounds(self):
        # Obs bound = 10x baseline (arrival_models.py:125-126).
        return ((0.0, 0.0), tuple(10.0 * b for b in self.baseline_arrival_rate))

    def get_arrivals(self, state, uniform, dt):
        return (uniform < state * dt).to(uniform.dtype)

    def update(self, state, arrivals, fills, action, noise, dt):
        baseline = _rates(self.baseline_arrival_rate, state)
        return state + self.mean_reversion_speed * (baseline - state) * dt + self.jump_size * arrivals
