"""Fill-probability models (counterpart of ``mbt_gym_tpu/processes/fills.py``).

A fill model exposes ``fill_probability(state, depths) -> (N, 2)``,
``get_fills(state, depths, uniform) -> (N, 2)`` (Bernoulli thinning,
fill_probability_models.py:28-34) and a ``max_depth`` bounding the action
space.  The port carries the exponential model only."""
from __future__ import annotations

import math

import torch

from mbt_gym_torch.processes.base import ProcessBase, process_dataclass


class FillModelBase(ProcessBase):
    def get_fills(self, state, depths, uniform):
        return (uniform < self.fill_probability(state, depths)).to(uniform.dtype)


@process_dataclass
class ExponentialFill(FillModelBase):
    """``p = exp(-fill_exponent * depth)`` (fill_probability_models.py:42-65).
    Default fill model; ``1/fill_exponent`` is the risk-neutral optimal quote."""

    fill_exponent: float = 1.5

    def noise_spec(self):
        return (0, 2)

    def fill_probability(self, state, depths):
        return torch.exp(-self.fill_exponent * depths)

    @property
    def max_depth(self) -> float:
        return -math.log(0.01) / self.fill_exponent
