"""Midprice models (counterpart of ``mbt_gym_tpu/processes/midprice.py``;
reference ``mbt_gym/stochastic_processes/midprice_models.py``).

All ten reference models, each a frozen dataclass of Python-float
parameters whose ``update`` consumes explicit noise columns, so the same
function runs on native and on injected noise.  The JAX package's
choices are kept:

- ``OuMidprice``/``OuJumpMidprice`` do not scale the mean-reversion drift
  by ``dt`` unless ``dt_scaled_drift=True`` (the reference's quirk,
  midprice_models.py:141-143,264-269);
- the short-term alphas and CEV are vectorised as intended (the
  reference's (N,)-vs-(N,1) broadcasting crashes for N > 1);
- GBM's observation bound is symmetric about the start price, and
  Heston's variance column has a bound of its own;
- CEV raises the state to ``gamma`` as is, so a negative price gives NaN,
  as in the JAX engine.
"""
from __future__ import annotations

import math

import torch

from mbt_gym_torch.processes.base import ProcessBase, process_dataclass
from mbt_gym_torch.types import ASK_INDEX, BID_INDEX


def _filled(arrivals, fills, side: int):
    """(N,) indicator that an order arrived and was filled on `side`."""
    return arrivals[:, side] * fills[:, side]


def _jump_term(arrivals, fills, jump_size: float, dtype):
    """(N, 1) fill-driven jump, or scalar 0 under fill-less dynamics
    (trading speed), where arrivals/fills are None."""
    if arrivals is None or fills is None:
        return 0.0
    jump = jump_size * (_filled(arrivals, fills, ASK_INDEX) - _filled(arrivals, fills, BID_INDEX))
    return jump[:, None].to(dtype)


class _PriceState(ProcessBase):
    """One state column, the price, starting at ``initial_price``."""

    state_dim = 1

    def initial_state(self, n, dtype=torch.float32, device=None):
        return torch.full((n, 1), self.initial_price, dtype=dtype, device=device)


@process_dataclass
class ConstantMidprice(_PriceState):
    """Price never moves (midprice_models.py:12-33)."""

    initial_price: float = 100.0

    def bounds(self):
        return ((self.initial_price,), (self.initial_price,))


@process_dataclass
class BrownianMotionMidprice(_PriceState):
    """Arithmetic BM: ``S += drift*dt + vol*sqrt(dt)*N(0,1)``
    (midprice_models.py:36-68).  Default midprice of the AS/CJ configs."""

    drift: float = 0.0
    volatility: float = 2.0
    initial_price: float = 100.0
    terminal_time: float = 1.0

    def noise_spec(self):
        return (1, 0)

    def bounds(self):
        # Obs bound S0 ± 4*vol*sqrt(T) (midprice_models.py:67-68).
        half_width = 4.0 * self.volatility * math.sqrt(self.terminal_time)
        return ((self.initial_price - half_width,), (self.initial_price + half_width,))

    def update(self, state, arrivals, fills, action, noise, dt):
        return state + (self.drift * dt) + (self.volatility * math.sqrt(dt)) * noise.normal


@process_dataclass
class GeometricBrownianMotionMidprice(_PriceState):
    """GBM Euler step (midprice_models.py:71-111)."""

    drift: float = 0.0
    volatility: float = 0.1
    initial_price: float = 100.0
    terminal_time: float = 1.0

    def noise_spec(self):
        return (1, 0)

    def bounds(self):
        # The lognormal 4-sigma band, symmetric about s0 so that a negative
        # drift cannot invert the box (the reference's hi falls below s0).
        stdev = math.sqrt(
            self.initial_price**2
            * math.exp(2 * self.drift * self.terminal_time)
            * (math.exp(self.volatility**2 * self.terminal_time) - 1)
        )
        drifted = self.initial_price * math.exp(self.drift * self.terminal_time)
        half_width = abs(drifted - self.initial_price) + 4 * stdev
        return ((self.initial_price - half_width,), (self.initial_price + half_width,))

    def update(self, state, arrivals, fills, action, noise, dt):
        return state + self.drift * state * dt + (self.volatility * math.sqrt(dt)) * state * noise.normal


@process_dataclass
class OuMidprice(_PriceState):
    """Ornstein-Uhlenbeck mean reversion (midprice_models.py:114-146); the
    drift is not multiplied by dt unless ``dt_scaled_drift``."""

    mean_reversion_level: float = 0.0
    mean_reversion_speed: float = 1.0
    volatility: float = 2.0
    initial_price: float = 100.0
    terminal_time: float = 1.0
    dt_scaled_drift: bool = False

    def noise_spec(self):
        return (1, 0)

    def bounds(self):
        half_width = 4.0 * self.volatility * self.terminal_time
        return ((self.initial_price - half_width,), (self.initial_price + half_width,))

    def update(self, state, arrivals, fills, action, noise, dt):
        drift_scale = dt if self.dt_scaled_drift else 1.0
        return (
            state
            + (-self.mean_reversion_speed * drift_scale) * (state - self.mean_reversion_level)
            + (self.volatility * math.sqrt(dt)) * noise.normal
        )


class _AlphaPrice(ProcessBase):
    """``[price, alpha]``: the price drifts at the rate alpha, which follows
    the inner process ``self._inner()``; the noise columns are the price's
    own, then the inner process's."""

    state_dim = 2

    def noise_spec(self):
        return (2, 0)

    def initial_state(self, n, dtype=torch.float32, device=None):
        price = torch.full((n, 1), self.initial_price, dtype=dtype, device=device)
        return torch.cat([price, self._inner().initial_state(n, dtype, device)], dim=1)

    def bounds(self):
        half_width = 4.0 * self.volatility * self.terminal_time
        (lo,), (hi,) = self._inner().bounds()
        return ((self.initial_price - half_width, lo), (self.initial_price + half_width, hi))

    def update(self, state, arrivals, fills, action, noise, dt):
        price, alpha = state[:, 0:1], state[:, 1:2]
        inner = type(noise)(normal=noise.normal[:, 1:2], uniform=None)
        new_price = price + alpha * dt + (self.volatility * math.sqrt(dt)) * noise.normal[:, 0:1]
        new_alpha = self._inner().update(alpha, arrivals, fills, action, inner, dt)
        return torch.cat([new_price, new_alpha], dim=1)


@process_dataclass
class ShortTermOuAlphaMidprice(_AlphaPrice):
    """2-dim state ``[price, alpha]`` with an OU alpha
    (midprice_models.py:149-190)."""

    volatility: float = 2.0
    ou: OuMidprice = OuMidprice(initial_price=0.0)
    initial_price: float = 100.0
    terminal_time: float = 1.0

    def _inner(self):
        return self.ou


@process_dataclass
class BrownianMotionJumpMidprice(_PriceState):
    """ABM plus a permanent ±jump on each of the agent's own fills
    (midprice_models.py:193-230): ask fill pushes price up, bid fill down."""

    drift: float = 0.0
    volatility: float = 2.0
    jump_size: float = 1.0
    initial_price: float = 100.0
    terminal_time: float = 1.0

    def noise_spec(self):
        return (1, 0)

    def bounds(self):
        half_width = 4.0 * self.volatility * self.terminal_time
        return ((self.initial_price - half_width,), (self.initial_price + half_width,))

    def update(self, state, arrivals, fills, action, noise, dt):
        return (
            state
            + (self.drift * dt)
            + (self.volatility * math.sqrt(dt)) * noise.normal
            + _jump_term(arrivals, fills, self.jump_size, state.dtype)
        )


@process_dataclass
class OuJumpMidprice(_PriceState):
    """OU plus fill-driven jumps (midprice_models.py:233-273), with
    :class:`OuMidprice`'s drift quirk."""

    mean_reversion_level: float = 0.0
    mean_reversion_speed: float = 1.0
    volatility: float = 2.0
    jump_size: float = 1.0
    initial_price: float = 100.0
    terminal_time: float = 1.0
    dt_scaled_drift: bool = False

    def noise_spec(self):
        return (1, 0)

    def bounds(self):
        half_width = 4.0 * self.volatility * self.terminal_time
        return ((self.initial_price - half_width,), (self.initial_price + half_width,))

    def update(self, state, arrivals, fills, action, noise, dt):
        drift_scale = dt if self.dt_scaled_drift else 1.0
        return (
            state
            + (-self.mean_reversion_speed * drift_scale) * (state - self.mean_reversion_level)
            + (self.volatility * math.sqrt(dt)) * noise.normal
            + _jump_term(arrivals, fills, self.jump_size, state.dtype)
        )


@process_dataclass
class ShortTermJumpAlphaMidprice(_AlphaPrice):
    """``[price, alpha]`` with alpha following an OU-with-jumps process
    (midprice_models.py:276-319)."""

    volatility: float = 2.0
    ou_jump: OuJumpMidprice = OuJumpMidprice(initial_price=0.0)
    initial_price: float = 100.0
    terminal_time: float = 1.0

    def _inner(self):
        return self.ou_jump


@process_dataclass
class HestonMidprice(ProcessBase):
    """Heston stochastic volatility, 2-dim state ``[price, variance]``
    (midprice_models.py:322-372): correlated Wieners from two iid normal
    columns through the Cholesky factor of [[1, rho], [rho, 1]], the
    variance reflected at zero."""

    drift: float = 0.05
    volatility_mean_reversion_rate: float = 3.0
    volatility_mean_reversion_level: float = 0.04
    weiner_correlation: float = -0.8
    volatility_of_volatility: float = 0.6
    initial_price: float = 100.0
    initial_variance: float = 0.04
    terminal_time: float = 1.0
    state_dim = 2

    def noise_spec(self):
        return (2, 0)

    def initial_state(self, n, dtype=torch.float32, device=None):
        price = torch.full((n, 1), self.initial_price, dtype=dtype, device=device)
        var = torch.full((n, 1), self.initial_variance, dtype=dtype, device=device)
        return torch.cat([price, var], dim=1)

    def bounds(self):
        # the variance column is bounded by 10x its level (the reference's
        # bound is 1-dim for a 2-dim state)
        hi = self.initial_price + 4 * self.volatility_mean_reversion_level * self.terminal_time
        return (
            (self.initial_price - (hi - self.initial_price), 0.0),
            (hi, 10.0 * max(self.volatility_mean_reversion_level, self.initial_variance)),
        )

    def update(self, state, arrivals, fills, action, noise, dt):
        price, var = state[:, 0:1], state[:, 1:2]
        rho = self.weiner_correlation
        w0 = noise.normal[:, 0:1]
        w1 = rho * w0 + math.sqrt(1.0 - rho**2) * noise.normal[:, 1:2]
        vol = torch.sqrt(torch.clamp(var, min=0.0) * dt)
        new_price = price + self.drift * price * dt + vol * price * w0
        new_var = torch.abs(
            var
            + self.volatility_mean_reversion_rate * (self.volatility_mean_reversion_level - var) * dt
            + self.volatility_of_volatility * vol * w1
        )
        return torch.cat([new_price, new_var], dim=1)


@process_dataclass
class CevMidprice(_PriceState):
    """Constant elasticity of variance: ``dS = S*mu*dt + vol*S^gamma*sqrt(dt)*dW``
    (midprice_models.py:375-412; gamma=1 reduces to GBM)."""

    drift: float = 0.0
    volatility: float = 0.1
    gamma: float = 1.0
    initial_price: float = 100.0
    terminal_time: float = 1.0

    def noise_spec(self):
        return (1, 0)

    def bounds(self):
        half_width = 4.0 * self.volatility * self.terminal_time
        return ((self.initial_price - half_width,), (self.initial_price + half_width,))

    def update(self, state, arrivals, fills, action, noise, dt):
        return (
            state
            + state * (self.drift * dt)
            + (self.volatility * math.sqrt(dt)) * (state**self.gamma) * noise.normal
        )
