"""Train PPO on the Cartea-Jaimungal market-making env — the PyTorch
port's counterpart of the reference's SB3 experiment wiring
(``experiments/helpers.py:68-96`` and the "Learning to make a market"
notebook; ``examples/train_ppo.py`` for the JAX package).  Everything
(rollout, GAE, updates, evaluation) stays on the device; checkpoints of
the full train state go through ``mbt_gym_torch.checkpoint``.

Usage: python examples_torch/train_ppo.py [--production] [--iterations 200] [--device cuda]
"""
import argparse
import dataclasses

import numpy as np

from mbt_gym_torch.agents import ppo
from mbt_gym_torch.agents.baseline import CarteaJaimungalMmAgent
from mbt_gym_torch.checkpoint import save_checkpoint
from mbt_gym_torch.rollout import jit_rollout
from mbt_gym_torch.utils.config import cj_env_config
from mbt_gym_torch.utils.tblog import maybe_logger


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--trajectories", type=int, default=1024)
    parser.add_argument("--n-steps", type=int, default=200)
    parser.add_argument("--iterations", type=int, default=200)
    parser.add_argument("--arrival-rate", type=float, default=10.0)
    parser.add_argument("--phi", type=float, default=0.5)
    parser.add_argument("--alpha", type=float, default=0.001)
    parser.add_argument("--eval-every", type=int, default=20)
    parser.add_argument("--checkpoint", type=str, default=None)
    parser.add_argument(
        "--tensorboard", type=str, default=None,
        help="TensorBoard log dir (counterpart of the reference's "
        "tensorboard_log, experiments/helpers.py:73-80)",
    )
    parser.add_argument(
        "--production", action="store_true",
        help="production architecture: shared-trunk actor-critic, bf16 "
        "matmuls, the fused update kernel (K7) on every device (its plain "
        "version on the CPU)",
    )
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = parser.parse_args()

    env_cfg = cj_env_config(
        num_trajectories=args.trajectories,
        n_steps=args.n_steps,
        arrival_rate=args.arrival_rate,
        per_step_inventory_aversion=args.phi,
        terminal_inventory_aversion=args.alpha,
        max_inventory=10.0,
    )
    env_cfg = dataclasses.replace(
        env_cfg, normalise_observation_space=True, normalise_action_space=True
    )
    # SB3-parity hyperparameters (experiments/helpers.py:68-86): 256x256 nets,
    # gamma=1, gae_lambda=0.95, batch = n_steps*N/4.
    if args.production:
        ppo_cfg = ppo.PPOConfig(
            hidden=(256, 256), gamma=1.0, gae_lambda=0.95, n_minibatches=4,
            shuffle=False, compute_dtype="bfloat16", shared_trunk=True, fused_update=True,
        )
    else:
        ppo_cfg = ppo.PPOConfig(hidden=(256, 256), gamma=1.0, gae_lambda=0.95, n_minibatches=4)
    ts = ppo.init_train_state(env_cfg, ppo_cfg, 0, device=args.device)

    # Closed-form optimum for comparison (evaluated on the raw-obs env).
    raw_cfg = dataclasses.replace(
        env_cfg, normalise_observation_space=False, normalise_action_space=False
    )
    cj = CarteaJaimungalMmAgent.from_config(raw_cfg, max_inventory=10)
    cj_res = jit_rollout(raw_cfg, cj.policy(), None, 1, device=args.device)
    cj_reward = float(cj_res.trajectory.rewards.sum(dim=0).mean())
    print(f"closed-form CJ mean episode reward: {cj_reward:.3f}")

    logger = maybe_logger(args.tensorboard)
    best = -np.inf
    try:
        for i in range(args.iterations):
            prev_ts = ts  # the rollout (and its reward metric) used THESE params
            ts, metrics = ppo.jit_train_iteration(env_cfg, ppo_cfg, ts, 100 + i)
            logger.log(i, metrics)
            if (i + 1) % args.eval_every == 0 or i == 0:
                r = float(metrics["mean_episode_reward"])
                print(
                    f"iter {i+1:4d}  reward {r:8.3f}  (closed-form {cj_reward:.3f})  "
                    f"kl {float(metrics['approx_kl']):+.4f}"
                )
                if args.checkpoint and r > best:
                    best = r
                    # r was measured on the pre-update params — checkpoint those.
                    save_checkpoint(args.checkpoint, prev_ts)
    finally:
        # buffered SummaryWriter scalars survive a mid-training crash/Ctrl-C
        logger.close()


if __name__ == "__main__":
    main()
