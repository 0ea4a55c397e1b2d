"""Train fused PPO on the reference's CANONICAL learning environment —
the exact setting of ``experiments/helpers.py:21-60 get_cj_env`` and the
Learning-to-make-a-market notebook: limit-and-market-order dynamics,
Poisson(10,10) arrivals, exponential fills (k=0.1), CjMm(phi=0.5,
alpha=0.001), and random initial inventory drawn per reset from [-5, 6);
on the PyTorch port (``examples/train_canonical.py`` for the JAX package).

Baseline for comparison: the closed-form Cartea-Jaimungal market-making
agent (optimal for the limit-order-only sub-problem) quoting on this env
with the market-order columns forced to zero — the natural "no-MO
closed-form" benchmark, since no closed form exists for the full
limit+market problem.  A learned policy should approach (and may exceed,
by using MOs to dump inventory) this baseline.

The learner is the fully fused one on every device: the rollout kernel
(K3) and the update kernel (K4) on the card, their plain versions on the
CPU.

Usage: python examples_torch/train_canonical.py [--iterations 300] [--phases 1] [--device cuda]
"""
import argparse
import dataclasses
import time

import torch

from mbt_gym_torch.agents import ppo
from mbt_gym_torch.agents.baseline import CarteaJaimungalMmAgent, no_market_order_policy
from mbt_gym_torch.parallel.mesh import fold_in
from mbt_gym_torch.rollout import jit_rollout
from mbt_gym_torch.utils.config import learning_env_config


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--trajectories", type=int, default=4096)
    parser.add_argument("--iterations", type=int, default=300)
    parser.add_argument("--eval-every", type=int, default=25)
    parser.add_argument("--eval-episodes", type=int, default=8)
    parser.add_argument("--max-inventory", type=float, default=20.0)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument(
        "--phases", type=int, default=1,
        help="LR-decay phases: phase i runs iterations/phases steps at "
        "lr * 0.2^i with a fresh Adam state",
    )
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = parser.parse_args()

    raw_cfg = dataclasses.replace(
        learning_env_config(num_trajectories=args.trajectories),
        max_inventory=args.max_inventory,
    )
    env_cfg = dataclasses.replace(raw_cfg, normalise_observation_space=True)

    # ---- closed-form no-MO baseline (mean over eval episodes; the random
    # initial inventory makes single-episode values noisy) ----
    cj = CarteaJaimungalMmAgent.from_config(raw_cfg, max_inventory=int(args.max_inventory))
    cj_policy = no_market_order_policy(cj.policy())

    @torch.no_grad()
    def mean_reward(cfg, policy, params, key, episodes):
        total = 0.0
        for e in range(episodes):
            res = jit_rollout(cfg, policy, params, fold_in(key, e), device=args.device)
            total += float(res.trajectory.rewards.sum(dim=0).mean())
        return total / episodes

    cj_reward = mean_reward(raw_cfg, cj_policy, None, 7, args.eval_episodes)
    print(f"closed-form (no-MO) CJ baseline: {cj_reward:.4f}", flush=True)

    # ---- fully fused PPO, the production architecture ----
    ppo_cfg = ppo.PPOConfig(
        hidden=(256, 256), gamma=1.0, gae_lambda=0.95, n_epochs=1,
        n_minibatches=4, shuffle=False, compute_dtype="bfloat16",
        shared_trunk=True, learning_rate=args.lr,
        fused_update=True, fused_rollout=True,
    )
    ts = ppo.init_train_state(env_cfg, ppo_cfg, 0, device=args.device)

    det_policy = ppo.deterministic_policy(env_cfg)

    t0 = time.time()
    per_phase = args.iterations // args.phases
    i = 0
    for phase in range(args.phases):
        if phase > 0:
            ppo_cfg = dataclasses.replace(
                ppo_cfg, learning_rate=args.lr * 0.2**phase
            )
            ts = ppo.PPOTrainState(
                params=ts.params,
                opt_state=ppo.make_optimizer(ppo_cfg, ts.params),
                update_count=ts.update_count,
            )
            print(f"-- phase {phase + 1}: lr {ppo_cfg.learning_rate:.2e}", flush=True)
        for _ in range(per_phase):
            ts, metrics = ppo.jit_train_iteration(env_cfg, ppo_cfg, ts, 100 + i)
            i += 1
            if i % args.eval_every == 0 or i == 1:
                det = mean_reward(env_cfg, det_policy, ts.params, 9000 + i, 2)
                print(
                    f"iter {i:4d}  t={time.time()-t0:6.1f}s  "
                    f"stoch {float(metrics['mean_episode_reward']):8.4f}  "
                    f"det {det:8.4f}  (CJ no-MO {cj_reward:.4f})  "
                    f"kl {float(metrics['approx_kl']):+.4f}",
                    flush=True,
                )
    det = mean_reward(env_cfg, det_policy, ts.params, 31337, args.eval_episodes)
    print(
        f"final deterministic eval: {det:.4f} vs closed-form no-MO {cj_reward:.4f} "
        f"({det/cj_reward:.1%})" if cj_reward > 0 else
        f"final deterministic eval: {det:.4f} vs closed-form no-MO {cj_reward:.4f}",
        flush=True,
    )


if __name__ == "__main__":
    main()
