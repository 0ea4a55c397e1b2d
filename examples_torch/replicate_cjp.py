"""Replicate the Cartea-Jaimungal-Penalva (2015) closed-form value function —
the reference's ``notebooks/Test_2_-_replicate_CJP_2015_...ipynb`` as a
script, on the PyTorch port (``examples/replicate_cjp.py`` for the JAX
package): roll the closed-form CJ market maker and t-test the mean
episodic reward against the analytic value function h(0, q0) + x + q S.

Usage: python examples_torch/replicate_cjp.py [--trajectories 1024] [--device cuda]
"""
import argparse

import numpy as np
import scipy.stats

from mbt_gym_torch import jit_rollout
from mbt_gym_torch.agents.baseline import CarteaJaimungalMmAgent
from mbt_gym_torch.utils.config import cj_env_config

PARAM_SETS = [
    dict(initial_price=100.0, terminal_time=1.0, sigma=2.0, n_steps=1000, arrival_rate=140.0, fill_exponent=1.5),
    dict(initial_price=150.0, terminal_time=1.0, sigma=1.0, n_steps=1000, arrival_rate=100.0, fill_exponent=1.0),
    dict(initial_price=50.0, terminal_time=1.0, sigma=1.5, n_steps=2000, arrival_rate=50.0, fill_exponent=2.0),
    dict(initial_price=50.0, terminal_time=2.0, sigma=1.5, n_steps=2000, arrival_rate=50.0, fill_exponent=2.0),
]


def main():
    parser = argparse.ArgumentParser()
    # a multiple of 128: the rollout front door runs the fused table kernel (K5) on the card
    parser.add_argument("--trajectories", type=int, default=1024)
    parser.add_argument("--seed", type=int, default=410)
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = parser.parse_args()

    for params in PARAM_SETS:
        cfg = cj_env_config(num_trajectories=args.trajectories, max_inventory=100.0, **params)
        agent = CarteaJaimungalMmAgent.from_config(cfg, max_inventory=100)
        res = jit_rollout(cfg, agent.policy(), None, args.seed, device=args.device)
        total = res.trajectory.rewards.sum(dim=0).double().cpu().numpy()
        obs0 = res.trajectory.observations[0][:1]
        true_mean = float(agent.true_value_function(obs0)[0])
        n = len(total)
        t_stat = (total.mean() - true_mean) / np.sqrt(total.var(ddof=1) / n)
        q_l, q_u = scipy.stats.t(df=n - 1).ppf((0.1, 0.9))
        verdict = "ACCEPT" if q_l < t_stat < q_u else "reject @80% (see notebook caveat)"
        print(
            f"{params}: sample {total.mean():8.4f}  analytic {true_mean:8.4f}  "
            f"t={t_stat:+.3f}  {verdict}"
        )


if __name__ == "__main__":
    main()
