"""Midprice models (counterpart of ``mbt_gym_tpu/processes/midprice.py``).

The port carries the AS main path's model only; the other nine midprice
models are not ported yet (ROADMAP.md Queue 1 item 7)."""
from __future__ import annotations

import math

import torch

from mbt_gym_torch.processes.base import ProcessBase, process_dataclass


@process_dataclass
class BrownianMotionMidprice(ProcessBase):
    """Arithmetic BM: ``S += drift*dt + vol*sqrt(dt)*N(0,1)``
    (midprice_models.py:36-68).  Default midprice of the AS/CJ configs."""

    drift: float = 0.0
    volatility: float = 2.0
    initial_price: float = 100.0
    terminal_time: float = 1.0
    state_dim = 1

    def noise_spec(self):
        return (1, 0)

    def initial_state(self, n, dtype=torch.float32, device=None):
        return torch.full((n, 1), self.initial_price, dtype=dtype, device=device)

    def bounds(self):
        # Obs bound S0 ± 4*vol*sqrt(T) (midprice_models.py:67-68).
        half_width = 4.0 * self.volatility * math.sqrt(self.terminal_time)
        return ((self.initial_price - half_width,), (self.initial_price + half_width,))

    def update(self, state, arrivals, fills, action, noise, dt):
        return state + (self.drift * dt) + (self.volatility * math.sqrt(dt)) * noise.normal
