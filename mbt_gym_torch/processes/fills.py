"""Fill-probability models (counterpart of ``mbt_gym_tpu/processes/fills.py``).

A fill model exposes ``fill_probability(state, depths) -> (N, 2)``,
``get_fills(state, depths, uniform) -> (N, 2)`` (Bernoulli thinning,
fill_probability_models.py:28-34) and a ``max_depth`` bounding the action
space.  The four reference models: exponential, triangular, power and the
exogenous competing market maker.  The triangular and power models clamp
the depth elementwise, as the reference intends; ``strict_reference_bug``
reproduces its literal axis-0 ``np.max(depths, 0)``, a reduction across
all envs (fill_probability_models.py:83-84,115-116)."""
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


@process_dataclass
class TriangularFill(FillModelBase):
    """``p = max(1 - max(depth, 0)/max_fill_depth, 0)``
    (fill_probability_models.py:68-91).  ``strict_reference_bug`` takes the
    literal ``np.max(1 - np.max(depths, 0)/c, 0)``: one probability shared
    by all envs and both sides."""

    max_fill_depth: float = 1.0
    strict_reference_bug: bool = False

    def noise_spec(self):
        return (0, 2)

    def fill_probability(self, state, depths):
        if self.strict_reference_bug:
            p = torch.amax(1.0 - torch.amax(depths, dim=0) / self.max_fill_depth, dim=0)
            return p.expand(depths.shape)
        return torch.clamp(1.0 - torch.clamp(depths, min=0.0) / self.max_fill_depth, min=0.0)

    @property
    def max_depth(self) -> float:
        return 1.5 * self.max_fill_depth


@process_dataclass
class PowerFill(FillModelBase):
    """``p = 1 / (1 + (mult * depth)^k)`` (fill_probability_models.py:94-123);
    ``strict_reference_bug`` takes each side's depth as its maximum over
    all envs."""

    fill_exponent: float = 1.5
    fill_multiplier: float = 1.5
    strict_reference_bug: bool = False

    def noise_spec(self):
        return (0, 2)

    def fill_probability(self, state, depths):
        if self.strict_reference_bug:
            d = torch.amax(depths, dim=0).expand(depths.shape)
        else:
            d = torch.clamp(depths, min=0.0)
        return 1.0 / (1.0 + (self.fill_multiplier * d) ** self.fill_exponent)

    @property
    def max_depth(self) -> float:
        return 0.01 ** (-1.0 / self.fill_exponent) - 1.0


@process_dataclass
class ExogenousMmFill(FillModelBase):
    """Competing market maker (fill_probability_models.py:126-170): two
    exogenous best-depth processes (bid, ask) carried in state; quoting at
    or inside the exogenous best depth fills with probability 1, quoting
    outside decays as ``base_p * exp(-k * (depth - best))``.  Each side's
    first state column is its best depth.

    The noise columns are the inner processes' (bid then ask), then the 2
    thinning uniforms last.  ``strict_reference_bug`` reproduces the
    reference's frozen depths (its ``update`` never refreshes the parent's
    state): the depths stay at their initial values and only the 2
    thinning uniforms are drawn."""

    bid_process: ProcessBase
    ask_process: ProcessBase
    fill_exponent: float = 1.5
    base_fill_probability: float = 1.0
    strict_reference_bug: bool = False

    def __post_init__(self):
        assert self.bid_process.state_dim >= 1 and self.ask_process.state_dim >= 1, (
            "Exogenous best depth processes must have a state of at least size 1."
        )

    @property
    def state_dim(self) -> int:  # type: ignore[override]
        return self.bid_process.state_dim + self.ask_process.state_dim

    def noise_spec(self):
        if self.strict_reference_bug:
            return (0, 2)
        bn, bu = self.bid_process.noise_spec()
        an, au = self.ask_process.noise_spec()
        return (bn + an, bu + au + 2)

    def initial_state(self, n, dtype=torch.float32, device=None):
        return torch.cat(
            [self.bid_process.initial_state(n, dtype, device), self.ask_process.initial_state(n, dtype, device)],
            dim=1,
        )

    def bounds(self):
        b_lo, b_hi = self.bid_process.bounds()
        a_lo, a_hi = self.ask_process.bounds()
        return (b_lo + a_lo, b_hi + a_hi)

    def _best_depths(self, state):
        d_b = self.bid_process.state_dim
        return torch.cat([state[:, 0:1], state[:, d_b : d_b + 1]], dim=1)

    def fill_probability(self, state, depths):
        best = self._best_depths(state)
        return torch.where(
            depths > best,
            self.base_fill_probability * torch.exp(-self.fill_exponent * (depths - best)),
            torch.ones_like(depths),
        )

    def get_fills(self, state, depths, uniform):
        return (uniform[:, -2:] < self.fill_probability(state, depths)).to(uniform.dtype)

    def update(self, state, arrivals, fills, action, noise, dt):
        if self.strict_reference_bug:
            return state
        d_b = self.bid_process.state_dim
        bn, bu = self.bid_process.noise_spec()
        an, au = self.ask_process.noise_spec()

        def cut(x, lo, hi):
            return None if x is None else x[:, lo:hi]

        bid_noise = type(noise)(normal=cut(noise.normal, 0, bn), uniform=cut(noise.uniform, 0, bu))
        ask_noise = type(noise)(normal=cut(noise.normal, bn, bn + an), uniform=cut(noise.uniform, bu, bu + au))
        new_bid = self.bid_process.update(state[:, :d_b], arrivals, fills, action, bid_noise, dt)
        new_ask = self.ask_process.update(state[:, d_b:], arrivals, fills, action, ask_noise, dt)
        return torch.cat([new_bid, new_ask], dim=1)

    @property
    def max_depth(self) -> float:
        _, b_hi = self.bid_process.bounds()
        return -math.log(0.01) / self.fill_exponent + max(b_hi)
