"""Order-arrival models (counterpart of ``mbt_gym_tpu/processes/arrivals.py``).

``get_arrivals(state, uniform, dt) -> (N, 2)``: column 0 is an exogenous
SELL order arriving on the buy side, column 1 an exogenous BUY order on the
sell side (arrival_models.py:9-13), as 0.0/1.0 in the state dtype.  The port
carries Poisson arrivals only."""
from __future__ import annotations

from typing import Tuple

import torch

from mbt_gym_torch.processes.base import ProcessBase, process_dataclass


@process_dataclass
class PoissonArrivals(ProcessBase):
    """Stateless Bernoulli thinning: ``uniform < intensity*dt``
    (arrival_models.py:32-56).  Default arrival model."""

    intensity: Tuple[float, float] = (140.0, 140.0)

    def noise_spec(self):
        return (0, 2)

    def get_arrivals(self, state, uniform, dt):
        probs = torch.tensor(self.intensity, dtype=uniform.dtype, device=uniform.device) * dt
        return (uniform < probs).to(uniform.dtype)
