"""Grid sweep over arrival rate x fill exponent — the reference's
``experiments/learning-pnl-with-different-arrival-rates.py`` (lambda in
{1,10,100} x k in {0.1,1,10}, 1000 trajectories, PPO per cell) rebuilt on
the PyTorch port's on-device PPO learner (``examples/arrival_rate_sweep.py``
for the JAX package).

The reference sweep builds each cell with ``get_cj_env``
(experiments/helpers.py:21-60): limit-and-market-order dynamics, CjMm
criterion, random initial inventory in [-5, 6), and an episode horizon of
``int(10 * terminal_time * arrival_rate)`` steps — reproduced here via
``utils.config.learning_env_config``.  Each cell trains fully fused PPO
(K3 and K4 on the card, their plain versions on the CPU) and reports the
final reward against the closed-form no-MO CJ baseline.

Usage: python examples_torch/arrival_rate_sweep.py [--iterations 100] [--chunk 100] [--device cuda]
"""
import argparse
import dataclasses
import time

from mbt_gym_torch.agents import ppo
from mbt_gym_torch.agents.baseline import CarteaJaimungalMmAgent, no_market_order_policy
from mbt_gym_torch.rollout import jit_rollout
from mbt_gym_torch.utils.config import learning_env_config


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--trajectories", type=int, default=1024)
    parser.add_argument("--iterations", type=int, default=100)
    parser.add_argument(
        "--budget-steps", type=float, default=0,
        help="training env-steps per grid cell (overrides --iterations); "
        "the reference budgets 300e6 SB3 steps per cell "
        "(learning-pnl-with-different-arrival-rates.py:26-43)",
    )
    parser.add_argument("--max-inventory", type=float, default=20.0)
    parser.add_argument(
        "--chunk", type=int, default=100,
        help="iterations run per call of ppo.jit_train_chunk (1 disables)",
    )
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = parser.parse_args()

    t_sweep = time.time()
    total_steps = 0
    for arrival_rate in (1.0, 10.0, 100.0):
        for fill_exponent in (0.1, 1.0, 10.0):
            raw_cfg = dataclasses.replace(
                learning_env_config(
                    num_trajectories=args.trajectories,
                    arrival_rate=arrival_rate,
                    fill_exponent=fill_exponent,
                ),
                max_inventory=args.max_inventory,
            )
            env_cfg = dataclasses.replace(raw_cfg, normalise_observation_space=True)

            # Closed-form no-MO baseline: CJ quotes + zero MO columns.
            cj = CarteaJaimungalMmAgent.from_config(
                raw_cfg, max_inventory=int(args.max_inventory)
            )
            cj_policy = no_market_order_policy(cj.policy())

            cf = float(
                jit_rollout(raw_cfg, cj_policy, None, 7, device=args.device)
                .trajectory.rewards.sum(dim=0).mean()
            )

            ppo_cfg = ppo.PPOConfig(
                hidden=(256, 256), n_epochs=1, n_minibatches=4, shuffle=False,
                compute_dtype="bfloat16", shared_trunk=True,
                fused_update=True, fused_rollout=True,
            )
            ts = ppo.init_train_state(env_cfg, ppo_cfg, 0, device=args.device)
            steps_per_iter = env_cfg.num_trajectories * env_cfg.n_steps
            iterations = (
                max(1, round(args.budget_steps / steps_per_iter))
                if args.budget_steps else args.iterations
            )
            reward = float("nan")
            t0 = time.time()
            done = 0
            while done < iterations:
                n = min(max(args.chunk, 1), iterations - done)
                if n == 1:
                    ts, metrics = ppo.jit_train_iteration(env_cfg, ppo_cfg, ts, done)
                    reward = float(metrics["mean_episode_reward"])
                else:
                    ts, metrics = ppo.jit_train_chunk(env_cfg, ppo_cfg, ts, done, n)
                    reward = float(metrics["mean_episode_reward"][-1])
                done += n
            cell_s = time.time() - t0
            total_steps += iterations * steps_per_iter
            print(
                f"lambda={arrival_rate:6.1f} k={fill_exponent:5.1f}  "
                f"T={env_cfg.n_steps:4d}  iters={iterations:5d}  "
                f"final reward {reward:9.4f}  closed-form no-MO {cf:9.4f}  "
                f"({cell_s:6.1f}s incl. capture)",
                flush=True,
            )
    print(
        f"sweep total: {total_steps/1e6:.0f}M training env-steps in "
        f"{time.time()-t_sweep:.1f}s wall (reference budget: 9 x 300M SB3 "
        f"steps)",
        flush=True,
    )


if __name__ == "__main__":
    main()
