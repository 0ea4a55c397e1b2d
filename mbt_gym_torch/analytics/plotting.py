"""Plotting and results-table helpers (counterpart of
``mbt_gym_tpu/analytics/plotting.py``; reference
``mbt_gym/gym/helpers/plotting.py``).  Matplotlib, pandas and seaborn are
imported inside the functions that use them, so the package imports
without them; a function raises ``ImportError`` where its library is
absent.
"""
from __future__ import annotations

import numpy as np
import torch

from mbt_gym_torch.env import EnvConfig, resolve_device
from mbt_gym_torch.rollout import episode_stats
from mbt_gym_torch.analytics import time_major
from mbt_gym_torch.types import ASSET_PRICE_INDEX, CASH_INDEX, INVENTORY_INDEX


def _host_time_major(traj):
    """(observations (T+1, N, S), actions (T, N, A), rewards (T, N)) as numpy."""
    return tuple(x.detach().cpu().numpy() for x in time_major(traj))


def get_timestamps(cfg: EnvConfig) -> np.ndarray:
    """linspace(0, T, n_steps+1) (plotting.py:113-114)."""
    return np.linspace(0.0, cfg.terminal_time, cfg.n_steps + 1)


def plot_trajectory(cfg: EnvConfig, traj, max_trajectories: int = 8):
    """2x2 panel: cumulative rewards / price / inventory+cash / actions
    (plotting.py:14-59)."""
    import matplotlib.pyplot as plt

    obs, actions, rewards = _host_time_major(traj)
    ts = get_timestamps(cfg)[-(obs.shape[0]):]
    cum_rewards = np.cumsum(rewards, axis=0)
    n = min(obs.shape[1], max_trajectories)

    fig, ((ax1, ax2), (ax3, ax4)) = plt.subplots(2, 2, figsize=(20, 10))
    ax3a = ax3.twinx()
    ax1.set_title("cum_rewards")
    ax2.set_title("asset_prices")
    ax3.set_title("inventory and cash holdings")
    ax4.set_title("Actions")
    colors = ["r", "k", "b", "g"]
    for i in range(n):
        alpha = (i + 1) / (n + 1)
        ax1.plot(ts[1:], cum_rewards[:, i])
        ax2.plot(ts, obs[:, i, ASSET_PRICE_INDEX])
        ax3.plot(ts, obs[:, i, INVENTORY_INDEX], color="r", alpha=alpha, label="inventory" if i == 0 else None)
        ax3a.plot(ts, obs[:, i, CASH_INDEX], color="b", alpha=alpha, label="cash" if i == 0 else None)
        for j in range(actions.shape[2]):
            ax4.plot(ts[:-1], actions[:, i, j], color=colors[j % 4], alpha=alpha,
                     label=f"Action {j}" if i == 0 else None)
    ax3.legend()
    ax4.legend()
    return fig


def plot_pnl(total_rewards, symmetric_rewards=None):
    """PnL histogram (plotting.py:84-91)."""
    import matplotlib.pyplot as plt
    import seaborn as sns

    fig, ax = plt.subplots(1, 1, figsize=(20, 10))
    if symmetric_rewards is not None:
        sns.histplot(np.asarray(symmetric_rewards), label="Rewards of symmetric strategy",
                     stat="density", bins=50, ax=ax)
    sns.histplot(np.asarray(total_rewards), label="Rewards", color="red", stat="density", bins=50, ax=ax)
    ax.legend()
    plt.close(fig)
    return fig


def generate_results_table_and_hist(cfg: EnvConfig, traj):
    """The AS-replication metric table (plotting.py:94-110): mean spread,
    mean/std total PnL, mean/std terminal inventory — as a pandas frame —
    the PnL histogram and the total rewards."""
    total_rewards = _host_time_major(traj)[2].sum(axis=0)
    return results_table(cfg, traj), plot_pnl(total_rewards), total_rewards


def results_table(cfg: EnvConfig, traj):
    """:func:`generate_results_table_and_hist`'s table alone (pandas
    only)."""
    import pandas as pd

    stats = {k: float(v) for k, v in episode_stats(cfg, traj).items()}
    results = pd.DataFrame(
        index=["Inventory"],
        columns=["Mean spread", "Mean PnL", "Std PnL", "Mean terminal inventory", "Std terminal inventory"],
    )
    results.loc["Inventory"] = [
        stats["mean_spread"],
        stats["mean_pnl"],
        stats["std_pnl"],
        stats["mean_terminal_inventory"],
        stats["std_terminal_inventory"],
    ]
    return results


def _policy_actions(policy, params, obs: np.ndarray, device) -> np.ndarray:
    return policy(params, torch.as_tensor(obs, device=device), None).detach().cpu().numpy()


def plot_policy_slices(cfg: EnvConfig, policy, inventories=(-3, -2, -1, 0, 1, 2, 3), device=None):
    """Policy action slices vs time for fixed inventories (counterpart of
    plot_stable_baselines_actions, plotting.py:62-81, for any
    ``policy(params, obs, state)``); observations are made on ``device``."""
    import matplotlib.pyplot as plt

    device = resolve_device(device)
    ts = get_timestamps(cfg)
    figs = []
    curves = {}
    for q in inventories:
        obs = np.zeros((len(ts), cfg.state_dim), dtype=np.float32)
        obs[:, INVENTORY_INDEX] = q
        obs[:, 2] = ts
        obs[:, ASSET_PRICE_INDEX] = 100.0
        curves[q] = _policy_actions(policy, None, obs, device)
    for j in range(next(iter(curves.values())).shape[1]):
        fig, ax = plt.subplots()
        for q, actions in curves.items():
            ax.plot(ts, actions[:, j], label=str(q))
        ax.legend()
        ax.set_title(f"action[{j}] vs time by inventory")
        figs.append(fig)
    return figs


def compare_policies(
    cfg: EnvConfig,
    learned_policy,
    closed_form_policy,
    learned_params=None,
    inventories=(-3, -2, -1, 0, 1, 2, 3),
    times=(0.0, 0.25, 0.5, 0.75, 0.95),
    device=None,
):
    """Learned-vs-closed-form quote comparison (counterpart of the policy
    plots in experiments/helpers.py:113-226): for each action dimension, one
    figure of quotes vs inventory, one line per time, solid = learned,
    dashed = closed form.  Policies are called on raw observations made on
    ``device``; pass normalisation-aware policies if cfg normalises."""
    import matplotlib.pyplot as plt

    device = resolve_device(device)
    inventories = np.asarray(inventories, dtype=np.float32)
    figs = []
    for j in range(cfg.action_dim):
        fig, ax = plt.subplots()
        for t in times:
            obs = np.zeros((len(inventories), cfg.state_dim), dtype=np.float32)
            obs[:, INVENTORY_INDEX] = inventories
            obs[:, 2] = t
            obs[:, ASSET_PRICE_INDEX] = 100.0
            learned = _policy_actions(learned_policy, learned_params, obs, device)
            closed = _policy_actions(closed_form_policy, None, obs, device)
            (line,) = ax.plot(inventories, learned[:, j], label=f"learned t={t}")
            ax.plot(inventories, closed[:, j], linestyle="--", color=line.get_color())
        ax.set_xlabel("inventory")
        ax.set_ylabel(f"action[{j}]")
        ax.set_title("solid = learned, dashed = closed form")
        ax.legend(fontsize=7)
        figs.append(fig)
    return figs
