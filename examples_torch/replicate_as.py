"""Replicate Avellaneda-Stoikov (2008) Tables 1-2 — the reference's
``notebooks/Test_1_-_replicate_AS_original_results.ipynb`` as a script,
on the PyTorch port (``examples/replicate_as.py`` for the JAX package).

Usage: python examples_torch/replicate_as.py [--gamma 0.1] [--trajectories 1024] [--device cuda]

The default batch is a multiple of 128, so on the card the public
``rollout`` front door runs the fused whole-episode kernel (K2;
``dispatch_report`` prints the decision); any other batch, and the CPU,
take the engine with the reason shown.  Without matplotlib and seaborn
the table is printed without its histogram.
"""
import argparse

from mbt_gym_torch import dispatch_report, jit_rollout
from mbt_gym_torch.agents.baseline import AvellanedaStoikovAgent
from mbt_gym_torch.analytics.plotting import generate_results_table_and_hist, results_table
from mbt_gym_torch.utils.config import as_env_config


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--gamma", type=float, default=0.1, help="risk aversion")
    parser.add_argument("--trajectories", type=int, default=1024)
    parser.add_argument("--seed", type=int, default=50)
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = parser.parse_args()

    cfg = as_env_config(num_trajectories=args.trajectories)
    agent = AvellanedaStoikovAgent.from_config(cfg, risk_aversion=args.gamma)
    print(dispatch_report(cfg, agent.policy(), platform=args.device))
    res = jit_rollout(cfg, agent.policy(), None, args.seed, device=args.device)
    try:
        results, fig, total_rewards = generate_results_table_and_hist(cfg, res.trajectory)
    except ImportError as e:  # the histogram needs matplotlib and seaborn
        print(f"(no histogram: {e})")
        results = results_table(cfg, res.trajectory)
    print(results.to_string())
    print("\nExpected (AS 2008 / reference notebook):")
    if args.gamma == 0.1:
        print("  spread 1.49177, PnL 64.87 +/- 6.69, terminal inv 0.20 +/- 2.89")
    elif args.gamma == 0.01:
        print("  spread 1.349, PnL 68.75 +/- 8.72, terminal inv 0.23 +/- 5.10")


if __name__ == "__main__":
    main()
