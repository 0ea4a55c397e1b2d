"""Action semantics + wealth bookkeeping (counterpart of
``mbt_gym_tpu/dynamics.py``; reference ``mbt_gym/gym/ModelDynamics.py``).

A dynamics object is a frozen dataclass holding the stochastic-process
slots (midprice / arrival / fill / impact, in the reference's state-layout
order, TradingEnvironment.py:303-318) plus pure functions:

- ``get_arrivals_and_fills(proc_states, action, noises, dt)``
- ``update_agent(cash, inventory, midprice, proc_states, action, arrivals,
  fills, dt)`` -> (cash', inventory')
- ``action_bounds()`` -> (low, high) tuples defining the Box action space.

The bid/ask sign convention is the reference's ``fill_multiplier = [-1, +1]``
(ModelDynamics.py:71-73): a filled *bid* quote buys (inventory +1,
cash -(mid - depth)), a filled *ask* quote sells.  The port carries all
four families of the JAX package: limit orders, at-the-touch posting,
limit plus market orders, and trading speed.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from mbt_gym_torch.processes.base import ProcessBase
from mbt_gym_torch.types import ASK_INDEX, BID_INDEX, SlotNoise, device_constant

# Slot order parity with TradingEnvironment._get_stochastic_processes (:303-309).
SLOT_ORDER = ("midprice_model", "arrival_model", "fill_probability_model", "price_impact_model")


def _fill_mult(like: torch.Tensor) -> torch.Tensor:
    return device_constant((-1.0, 1.0), like.dtype, like.device)


def _limit_depths(action: torch.Tensor) -> torch.Tensor:
    return action[:, 0:2]


def _limit_order_bookkeeping(cash, inventory, midprice, depths, arrivals, fills):
    """Shared cash/inventory update for filled limit orders
    (ModelDynamics.py:108-116)."""
    mult = _fill_mult(cash)
    hits = arrivals * fills  # (N, 2)
    new_inventory = inventory + torch.sum(hits * -mult, dim=1)
    new_cash = cash + torch.sum(mult * hits * (midprice[:, None] + depths * mult), dim=1)
    return new_cash, new_inventory


class DynamicsBase:
    midprice_model: Optional[ProcessBase] = None
    arrival_model: Optional[ProcessBase] = None
    fill_probability_model: Optional[ProcessBase] = None
    price_impact_model: Optional[ProcessBase] = None
    # Callable initial-inventory specs are rounded to an int for order-book
    # dynamics (ModelDynamics.py:106 round_initial_inventory=True) but kept
    # fractional for execution-by-speed (ModelDynamics.py:260 sets False).
    round_initial_inventory = True

    def processes(self) -> Tuple[Tuple[str, ProcessBase], ...]:
        """Active slots in reference state-layout order."""
        out = []
        for name in SLOT_ORDER:
            proc = getattr(self, name, None)
            if proc is not None:
                out.append((name, proc))
        return tuple(out)

    def required_processes(self) -> Tuple[str, ...]:
        raise NotImplementedError

    def validate(self):
        for name in self.required_processes():
            assert getattr(self, name, None) is not None, (
                f"This model dynamics cannot have {name} = None."
            )
        assert self.midprice_model is not None, "All dynamics require a midprice model."

    def get_arrivals_and_fills(self, proc_states, action, noises, dt):
        return None, None

    def update_agent(self, cash, inventory, midprice, proc_states, action, arrivals, fills, dt):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class LimitOrderDynamics(DynamicsBase):
    """Pure limit-order market making (ModelDynamics.py:87-131).
    Action = (bid depth, ask depth); Box(0, max_depth, (2,))."""

    midprice_model: ProcessBase = None
    arrival_model: ProcessBase = None
    fill_probability_model: ProcessBase = None
    max_depth: Optional[float] = None
    action_dim = 2

    def required_processes(self):
        return ("arrival_model", "fill_probability_model")

    def _max_depth(self) -> float:
        return self.max_depth if self.max_depth is not None else self.fill_probability_model.max_depth

    def action_bounds(self):
        d = self._max_depth()
        return ((0.0, 0.0), (d, d))

    def get_arrivals_and_fills(self, proc_states, action, noises: Dict[str, SlotNoise], dt):
        arrivals = self.arrival_model.get_arrivals(
            proc_states.get("arrival_model"), noises["arrival_model"].uniform, dt
        )
        fills = self.fill_probability_model.get_fills(
            proc_states.get("fill_probability_model"), _limit_depths(action),
            noises["fill_probability_model"].uniform,
        )
        return arrivals, fills

    def update_agent(self, cash, inventory, midprice, proc_states, action, arrivals, fills, dt):
        return _limit_order_bookkeeping(cash, inventory, midprice, _limit_depths(action), arrivals, fills)


@dataclasses.dataclass(frozen=True)
class AtTheTouchDynamics(DynamicsBase):
    """Post-or-not at a fixed half-spread (ModelDynamics.py:134-176).
    Action = binary (post bid, post ask); fills are the action itself."""

    midprice_model: ProcessBase = None
    arrival_model: ProcessBase = None
    fixed_market_half_spread: float = 0.5
    action_dim = 2

    def required_processes(self):
        return ("arrival_model",)

    def action_bounds(self):
        # MultiBinary(2) in the reference (ModelDynamics.py:166-167); exposed
        # as a {0,1}-valued Box here. Action normalisation must stay off.
        return ((0.0, 0.0), (1.0, 1.0))

    def get_arrivals_and_fills(self, proc_states, action, noises, dt):
        arrivals = self.arrival_model.get_arrivals(
            proc_states.get("arrival_model"), noises["arrival_model"].uniform, dt
        )
        fills = action[:, 0:2]
        return arrivals, fills

    def update_agent(self, cash, inventory, midprice, proc_states, action, arrivals, fills, dt):
        mult = _fill_mult(cash)
        hits = arrivals * fills
        new_cash = cash + torch.sum(
            mult * hits * (midprice[:, None] + self.fixed_market_half_spread * mult), dim=1
        )
        new_inventory = inventory + torch.sum(hits * -mult, dim=1)
        return new_cash, new_inventory


@dataclasses.dataclass(frozen=True)
class LimitAndMarketOrderDynamics(LimitOrderDynamics):
    """Limit orders plus unit market orders (ModelDynamics.py:179-240).
    Action = (bid depth, ask depth, mo_buy, mo_sell); a market order fires
    when its column exceeds 0.5, buying at mid+half_spread / selling at
    mid-half_spread, before the limit-order bookkeeping.  Arrival/fill
    sampling and max-depth resolution are inherited from
    :class:`LimitOrderDynamics`."""

    fixed_market_half_spread: float = 0.5
    action_dim = 4

    def action_bounds(self):
        d = self._max_depth()
        return ((0.0, 0.0, 0.0, 0.0), (d, d, 1.0, 1.0))

    def update_agent(self, cash, inventory, midprice, proc_states, action, arrivals, fills, dt):
        mo_buy = (action[:, 2 + BID_INDEX] > 0.5).to(cash.dtype)
        mo_sell = (action[:, 2 + ASK_INDEX] > 0.5).to(cash.dtype)
        best_bid = midprice - self.fixed_market_half_spread
        best_ask = midprice + self.fixed_market_half_spread
        cash = cash + mo_sell * best_bid - mo_buy * best_ask
        inventory = inventory + mo_buy - mo_sell
        return _limit_order_bookkeeping(cash, inventory, midprice, _limit_depths(action), arrivals, fills)


@dataclasses.dataclass(frozen=True)
class TradingWithSpeedDynamics(DynamicsBase):
    """Optimal execution by trading speed (ModelDynamics.py:243-275; the
    reference spells it ``TradinghWithSpeedModelDynamics``).  Action = signed
    speed; executes ``speed*dt`` volume at ``mid + impact(speed)``, against
    the pre-update midprice and impact state."""

    midprice_model: ProcessBase = None
    price_impact_model: ProcessBase = None
    max_speed: Optional[float] = None
    action_dim = 1
    round_initial_inventory = False  # ModelDynamics.py:260

    def required_processes(self):
        return ("price_impact_model",)

    def _max_speed(self) -> float:
        return self.max_speed if self.max_speed is not None else self.price_impact_model.max_speed

    def action_bounds(self):
        s = self._max_speed()
        return ((-s,), (s,))

    def update_agent(self, cash, inventory, midprice, proc_states, action, arrivals, fills, dt):
        impact = self.price_impact_model.get_impact(proc_states.get("price_impact_model"), action)
        execution_price = midprice[:, None] + impact  # (N, 1)
        volume = action[:, 0:1] * dt
        new_cash = cash - (volume * execution_price).squeeze(1)
        new_inventory = inventory + volume.squeeze(1)
        return new_cash, new_inventory
