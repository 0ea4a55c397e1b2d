"""Backtest statistics (counterpart of ``mbt_gym_tpu/analytics/backtesting.py``;
reference ``mbt_gym/gym/backtesting.py``).

Unlike the reference (which asserts num_trajectories == 1 and recomputes a
rollout per statistic, backtesting.py:11-60), these operate on an existing
trajectory and are vectorised over all N trajectories at once, returning
(N,) float64 tensors on the trajectory's device.  ``risk_free_rate`` and
the annualisation match the reference.

The value path is computed in float64 whatever the trajectory's dtype
(the JAX functions stay in the input's dtype): in float32, ``1 + r`` for a
return r ~ 1e-4 keeps about three digits of r, and on a 16,384 x 200 AS
rollout with 1,000 initial cash the float32 drawdown was 5e-4 and the
Sortino ratio 2e-2 off, relatively, the float64 ones computed from the same
float32 trajectory.  On float64 inputs the arithmetic is the JAX one.
"""
from __future__ import annotations

import torch

from mbt_gym_torch.analytics import time_major
from mbt_gym_torch.types import ASSET_PRICE_INDEX, CASH_INDEX, INVENTORY_INDEX


def portfolio_values(traj) -> torch.Tensor:
    """(T+1, N) mark-to-market value path, in float64 (or wider)."""
    obs = time_major(traj).observations
    obs = obs.to(torch.promote_types(obs.dtype, torch.float64))
    return obs[:, :, CASH_INDEX] + obs[:, :, INVENTORY_INDEX] * obs[:, :, ASSET_PRICE_INDEX]


def _return_pcts(traj) -> torch.Tensor:
    values = portfolio_values(traj)
    return torch.diff(values, dim=0) / values[1:]


def sharpe_ratio(traj, risk_free_rate: float = 0.099) -> torch.Tensor:
    """Annualised Sharpe = (mean_ret * n_steps - rf) / (std_ret * sqrt(n_steps))
    (backtesting.py:11-27), with the population std."""
    rets = _return_pcts(traj)
    n_steps = rets.shape[0]
    annualized_std = rets.std(dim=0, correction=0) * n_steps**0.5
    return (rets.mean(dim=0) * n_steps - risk_free_rate) / annualized_std


def sortino_ratio(traj, risk_free_rate: float = 0.099) -> torch.Tensor:
    """Sharpe restricted to the downside deviation (backtesting.py:30-46);
    NaN for a trajectory without a negative return."""
    rets = _return_pcts(traj)
    n_steps = rets.shape[0]
    losses = torch.where(rets < 0, rets, torch.full_like(rets, float("nan")))
    loss_std = torch.sqrt(torch.nanmean((losses - torch.nanmean(losses, dim=0)) ** 2, dim=0))
    annualized_std = loss_std * n_steps**0.5
    return (rets.mean(dim=0) * n_steps - risk_free_rate) / annualized_std


def maximum_drawdown(traj) -> torch.Tensor:
    """Largest peak-to-trough drop of the compounded return path
    (backtesting.py:49-60)."""
    rets = _return_pcts(traj)
    cum_prods = torch.cumprod(rets + 1.0, dim=0)
    peak = running_max(cum_prods)
    drawdown = cum_prods / peak - 1.0
    return drawdown.min(dim=0).values


def running_max(x: torch.Tensor) -> torch.Tensor:
    """Running maximum along the time axis (dim 0)."""
    return torch.cummax(x, dim=0).values


jax_running_max = running_max  # the JAX package's name
