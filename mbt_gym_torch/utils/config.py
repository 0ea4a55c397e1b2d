"""Canonical environment factories (counterpart of
``mbt_gym_tpu/utils/config.py``).  The port carries the AS replication
config only."""
from __future__ import annotations

from mbt_gym_torch.dynamics import LimitOrderDynamics
from mbt_gym_torch.env import EnvConfig
from mbt_gym_torch.processes.arrivals import PoissonArrivals
from mbt_gym_torch.processes.fills import ExponentialFill
from mbt_gym_torch.processes.midprice import BrownianMotionMidprice
from mbt_gym_torch.rewards import PnL


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
