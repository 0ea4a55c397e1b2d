"""Canonical environment factories (counterpart of
``mbt_gym_tpu/utils/config.py``): the AS and CJP replication configs, the
optimal-execution config, the at-the-touch and limit-and-market-order
configs, the reference's canonical learning env and the composite stress
config (Hawkes arrivals, exogenous competing-market-maker fills,
limit-and-market-order dynamics)."""
from __future__ import annotations

from mbt_gym_torch.dynamics import (
    AtTheTouchDynamics,
    LimitAndMarketOrderDynamics,
    LimitOrderDynamics,
    TradingWithSpeedDynamics,
)
from mbt_gym_torch.env import EnvConfig
from mbt_gym_torch.processes.arrivals import HawkesArrivals, PoissonArrivals
from mbt_gym_torch.processes.fills import ExogenousMmFill, ExponentialFill
from mbt_gym_torch.processes.impact import TemporaryAndPermanentImpact
from mbt_gym_torch.processes.midprice import BrownianMotionMidprice, OuMidprice
from mbt_gym_torch.rewards import CjMmCriterion, CjOeCriterion, PnL, RunningInventoryPenalty


def as_env_config(
    num_trajectories: int = 1000,
    initial_price: float = 100.0,
    terminal_time: float = 1.0,
    sigma: float = 2.0,
    n_steps: int = 200,
    initial_inventory: int = 0,
    arrival_rate: float = 140.0,
    fill_exponent: float = 1.5,
    dtype: str = "float32",
) -> EnvConfig:
    """The Avellaneda-Stoikov replication env
    (notebooks/Test_1_-_replicate_AS_original_results.ipynb cell 4)."""
    dynamics = LimitOrderDynamics(
        midprice_model=BrownianMotionMidprice(
            initial_price=initial_price, volatility=sigma, terminal_time=terminal_time
        ),
        arrival_model=PoissonArrivals(intensity=(arrival_rate, arrival_rate)),
        fill_probability_model=ExponentialFill(fill_exponent=fill_exponent),
    )
    return EnvConfig(
        dynamics=dynamics,
        reward_function=PnL(),
        terminal_time=terminal_time,
        n_steps=n_steps,
        initial_inventory=initial_inventory,
        max_inventory=n_steps,
        num_trajectories=num_trajectories,
        normalise_action_space=False,
        normalise_observation_space=False,
        dtype=dtype,
    )


def cj_env_config(
    num_trajectories: int = 1000,
    initial_price: float = 100.0,
    terminal_time: float = 1.0,
    sigma: float = 2.0,
    n_steps: int = 1000,
    initial_inventory: int = 0,
    arrival_rate: float = 140.0,
    fill_exponent: float = 1.5,
    per_step_inventory_aversion: float = 0.01,
    terminal_inventory_aversion: float = 0.001,
    max_inventory: float = 100.0,
    dtype: str = "float32",
) -> EnvConfig:
    """The CJP-2015 value-function replication env
    (notebooks/Test_2_-_replicate_CJP_2015_... cell 3)."""
    dynamics = LimitOrderDynamics(
        midprice_model=BrownianMotionMidprice(
            initial_price=initial_price, volatility=sigma, terminal_time=terminal_time
        ),
        arrival_model=PoissonArrivals(intensity=(arrival_rate, arrival_rate)),
        fill_probability_model=ExponentialFill(fill_exponent=fill_exponent),
    )
    return EnvConfig(
        dynamics=dynamics,
        reward_function=CjMmCriterion(
            per_step_inventory_aversion=per_step_inventory_aversion,
            terminal_inventory_aversion=terminal_inventory_aversion,
            terminal_time=terminal_time,
        ),
        terminal_time=terminal_time,
        n_steps=n_steps,
        initial_inventory=initial_inventory,
        max_inventory=max_inventory,
        num_trajectories=num_trajectories,
        normalise_action_space=False,
        normalise_observation_space=False,
        dtype=dtype,
    )


def oe_env_config(
    num_trajectories: int = 8192,
    initial_price: float = 100.0,
    terminal_time: float = 1.0,
    sigma: float = 2.0,
    n_steps: int = 200,
    initial_inventory: int = 10,
    temporary_impact: float = 0.01,
    permanent_impact: float = 0.01,
    per_step_inventory_aversion: float = 2e-4,
    terminal_inventory_aversion: float = 0.01,
    dtype: str = "float32",
) -> EnvConfig:
    """Optimal-execution env: trading-speed dynamics with temporary and
    permanent impact and the CJ OE criterion (BASELINE.json config #3).

    ``terminal_inventory_aversion`` must exceed
    ``0.5*permanent_impact + sqrt(temporary_impact*phi)`` for the CJP
    closed-form schedule to liquidate (zeta > 1 regime, CJP-2015 p.147)."""
    dynamics = TradingWithSpeedDynamics(
        midprice_model=BrownianMotionMidprice(
            initial_price=initial_price, volatility=sigma, terminal_time=terminal_time
        ),
        price_impact_model=TemporaryAndPermanentImpact(
            temporary_impact_coefficient=temporary_impact,
            permanent_impact_coefficient=permanent_impact,
            terminal_time=terminal_time,
        ),
    )
    return EnvConfig(
        dynamics=dynamics,
        reward_function=CjOeCriterion(
            per_step_inventory_aversion=per_step_inventory_aversion,
            terminal_inventory_aversion=terminal_inventory_aversion,
            terminal_time=terminal_time,
        ),
        terminal_time=terminal_time,
        n_steps=n_steps,
        initial_inventory=initial_inventory,
        num_trajectories=num_trajectories,
        normalise_action_space=False,
        normalise_observation_space=False,
        dtype=dtype,
    )


def touch_env_config(
    num_trajectories: int = 1000,
    initial_price: float = 100.0,
    terminal_time: float = 1.0,
    sigma: float = 2.0,
    n_steps: int = 200,
    arrival_rate: float = 140.0,
    fixed_market_half_spread: float = 0.5,
    per_step_inventory_aversion: float = 0.01,
    terminal_inventory_aversion: float = 0.001,
    max_inventory: float = 100.0,
    dtype: str = "float32",
) -> EnvConfig:
    """At-the-touch market making: post-or-not at a fixed half-spread
    (AtTheTouchModelDynamics, ModelDynamics.py:134-176) with the running
    inventory penalty.  Action normalisation stays off — the action box is
    the reference's MultiBinary(2) exposed as {0,1} columns."""
    dynamics = AtTheTouchDynamics(
        midprice_model=BrownianMotionMidprice(
            initial_price=initial_price, volatility=sigma, terminal_time=terminal_time
        ),
        arrival_model=PoissonArrivals(intensity=(arrival_rate, arrival_rate)),
        fixed_market_half_spread=fixed_market_half_spread,
    )
    return EnvConfig(
        dynamics=dynamics,
        reward_function=RunningInventoryPenalty(
            per_step_inventory_aversion=per_step_inventory_aversion,
            terminal_inventory_aversion=terminal_inventory_aversion,
        ),
        terminal_time=terminal_time,
        n_steps=n_steps,
        max_inventory=max_inventory,
        num_trajectories=num_trajectories,
        normalise_action_space=False,
        normalise_observation_space=False,
        dtype=dtype,
    )


def lam_env_config(
    num_trajectories: int = 1000,
    initial_price: float = 100.0,
    terminal_time: float = 1.0,
    sigma: float = 2.0,
    n_steps: int = 200,
    arrival_rate: float = 140.0,
    fill_exponent: float = 1.5,
    fixed_market_half_spread: float = 0.5,
    per_step_inventory_aversion: float = 0.01,
    terminal_inventory_aversion: float = 0.001,
    max_inventory: float = 100.0,
    dtype: str = "float32",
) -> EnvConfig:
    """Limit-and-market-order market making: limit quotes plus unit market
    orders at mid +/- the fixed half-spread
    (LimitAndMarketOrderModelDynamics, ModelDynamics.py:179-240) with
    Poisson arrivals, exponential fills and the running inventory penalty —
    the canonical 4-action MM setting (bench_suite config 8)."""
    dynamics = LimitAndMarketOrderDynamics(
        midprice_model=BrownianMotionMidprice(
            initial_price=initial_price, volatility=sigma, terminal_time=terminal_time
        ),
        arrival_model=PoissonArrivals(intensity=(arrival_rate, arrival_rate)),
        fill_probability_model=ExponentialFill(fill_exponent=fill_exponent),
        fixed_market_half_spread=fixed_market_half_spread,
    )
    return EnvConfig(
        dynamics=dynamics,
        reward_function=RunningInventoryPenalty(
            per_step_inventory_aversion=per_step_inventory_aversion,
            terminal_inventory_aversion=terminal_inventory_aversion,
        ),
        terminal_time=terminal_time,
        n_steps=n_steps,
        max_inventory=max_inventory,
        num_trajectories=num_trajectories,
        normalise_action_space=False,
        normalise_observation_space=False,
        dtype=dtype,
    )


def learning_env_config(
    num_trajectories: int = 1000,
    terminal_time: float = 1.0,
    arrival_rate: float = 10.0,
    fill_exponent: float = 0.1,
    phi: float = 0.5,
    alpha: float = 0.001,
    sigma: float = 0.1,
    initial_inventory=(-5, 6),
    fixed_market_half_spread: float = 0.5,
    dtype: str = "float32",
) -> EnvConfig:
    """The reference's canonical RL-training env (experiments/helpers.py:21-60
    ``get_cj_env``, used by the Learning-to-make-a-market notebook and the
    arrival-rate sweep): limit-and-market-order dynamics, Poisson(10,10)
    arrivals, exponential fills (k=0.1), CjMm criterion, RANDOM initial
    inventory drawn per reset from [lo, hi)."""
    n_steps = int(10 * terminal_time * arrival_rate)
    dynamics = LimitAndMarketOrderDynamics(
        midprice_model=BrownianMotionMidprice(
            initial_price=100.0, volatility=sigma, terminal_time=terminal_time
        ),
        arrival_model=PoissonArrivals(intensity=(arrival_rate, arrival_rate)),
        fill_probability_model=ExponentialFill(fill_exponent=fill_exponent),
        fixed_market_half_spread=fixed_market_half_spread,
    )
    reward = (
        CjMmCriterion(
            per_step_inventory_aversion=phi,
            terminal_inventory_aversion=alpha,
            terminal_time=terminal_time,
        )
        if phi > 0 or alpha > 0
        else PnL()
    )
    return EnvConfig(
        dynamics=dynamics,
        reward_function=reward,
        terminal_time=terminal_time,
        n_steps=n_steps,
        initial_inventory=initial_inventory,
        max_inventory=n_steps,
        num_trajectories=num_trajectories,
        normalise_action_space=False,
        normalise_observation_space=False,
        dtype=dtype,
    )


def composite_env_config(
    num_trajectories: int = 65536,
    initial_price: float = 100.0,
    terminal_time: float = 1.0,
    sigma: float = 2.0,
    n_steps: int = 200,
    baseline_arrival_rate: float = 10.0,
    fill_exponent: float = 1.5,
    dtype: str = "float32",
) -> EnvConfig:
    """Composite stress config: Hawkes self-exciting arrivals + stochastic
    (exogenous competing-MM) fill probability + limit-and-market-order
    action space.  State S = 8: cash, inventory, time, price, the two
    Hawkes intensities, the two exogenous best depths; A = 4."""
    exo_bid = OuMidprice(
        initial_price=0.8, mean_reversion_level=0.8, mean_reversion_speed=1.0,
        volatility=0.1, terminal_time=terminal_time, dt_scaled_drift=True,
    )
    exo_ask = OuMidprice(
        initial_price=0.8, mean_reversion_level=0.8, mean_reversion_speed=1.0,
        volatility=0.1, terminal_time=terminal_time, dt_scaled_drift=True,
    )
    dynamics = LimitAndMarketOrderDynamics(
        midprice_model=BrownianMotionMidprice(
            initial_price=initial_price, volatility=sigma, terminal_time=terminal_time
        ),
        arrival_model=HawkesArrivals(
            baseline_arrival_rate=(baseline_arrival_rate, baseline_arrival_rate)
        ),
        fill_probability_model=ExogenousMmFill(
            bid_process=exo_bid, ask_process=exo_ask, fill_exponent=fill_exponent
        ),
    )
    return EnvConfig(
        dynamics=dynamics,
        reward_function=RunningInventoryPenalty(0.01, 0.001),
        terminal_time=terminal_time,
        n_steps=n_steps,
        max_inventory=100.0,
        num_trajectories=num_trajectories,
        normalise_action_space=False,
        normalise_observation_space=False,
        dtype=dtype,
    )
