"""Baseline agents demo — counterpart of ``notebooks/Baseline_Agents.ipynb``
on the PyTorch port (``examples/baseline_agents.py`` for the JAX package):
random / fixed-spread / Avellaneda-Stoikov / Cartea-Jaimungal agents on
the same market, including an AS risk-aversion sweep.

Usage: python examples_torch/baseline_agents.py [--trajectories 1000] [--device cuda]

``jit_rollout`` dispatches as ``rollout`` does: on the card a batch that
is a multiple of 128 runs the closed-form agents on their kernels (K2 for
Avellaneda-Stoikov, K5 for the CJ table and the fixed spreads); any
other batch, the random policy and the CPU run the engine.
"""
import argparse

from mbt_gym_torch import episode_stats, jit_rollout
from mbt_gym_torch.agents.baseline import (
    AvellanedaStoikovAgent,
    CarteaJaimungalMmAgent,
    fixed_spread_policy,
    random_policy,
)
from mbt_gym_torch.analytics.diagnostics import negative_spread_fraction
from mbt_gym_torch.utils.config import as_env_config, cj_env_config


def show(name, cfg, policy, key, device):
    res = jit_rollout(cfg, policy, None, key, device=device)
    stats = {k: float(v) for k, v in episode_stats(cfg, res.trajectory).items()}
    neg = float(negative_spread_fraction(res.trajectory))
    print(
        f"{name:28s} spread {stats['mean_spread']:7.3f}  PnL {stats['mean_pnl']:8.3f} "
        f"+/- {stats['std_pnl']:7.3f}  term-inv {stats['mean_terminal_inventory']:+6.2f} "
        f"(neg-spread {neg:.1%})"
    )


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--trajectories", type=int, default=1000)
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = parser.parse_args()
    key = 50

    cfg = as_env_config(num_trajectories=args.trajectories)
    print("== AS env (PnL reward) ==")
    show("random", cfg, random_policy(cfg), key, args.device)
    show("fixed spread 1.0", cfg, fixed_spread_policy(1.0), key, args.device)
    for gamma in (0.5, 0.1, 0.01, 0.001):
        agent = AvellanedaStoikovAgent.from_config(cfg, risk_aversion=gamma)
        show(f"Avellaneda-Stoikov g={gamma}", cfg, agent.policy(), key, args.device)

    print("== CJ env (CjMm criterion) ==")
    cj_cfg = cj_env_config(num_trajectories=args.trajectories, max_inventory=100.0)
    cj = CarteaJaimungalMmAgent.from_config(cj_cfg, max_inventory=100)
    show("Cartea-Jaimungal MM", cj_cfg, cj.policy(), 410, args.device)
    show("fixed spread 1.0", cj_cfg, fixed_spread_policy(1.0), 410, args.device)


if __name__ == "__main__":
    main()
