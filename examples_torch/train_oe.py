"""Train PPO on the OPTIMAL-EXECUTION family and compare against the
closed-form Cartea-Jaimungal schedule — the execution-side counterpart of
``train_canonical.py``'s market-making demo, on the PyTorch port
(``examples/train_oe.py`` for the JAX package).

Reference setting: trading-speed dynamics + temporary&permanent impact
with the CJ-OE criterion (``TradinghWithSpeedModelDynamics``,
ModelDynamics.py:243-275; ``CjOeCriterion``, RewardFunctions.py:39-74).
The closed form (BaselineAgents.py:173-210, CJP-2015 p.147) is the exact
continuous-time optimum for this criterion, so — unlike the market-making
families, where PPO finds market-order value the quote-only closed form
cannot express — the learner can only APPROACH it: the result reported is
the fraction of the closed-form reward reached.

The learner is the fully fused one on every device: the rollout kernel's
speed kind (K3) and the update kernel (K4) on the card, their plain
versions on the CPU.

Usage: python examples_torch/train_oe.py [--iterations 600] [--phases 3] [--device cuda]
"""
import argparse
import dataclasses
import time

from mbt_gym_torch.agents import ppo
from mbt_gym_torch.agents.baseline import CarteaJaimungalOeAgent
from mbt_gym_torch.rollout import jit_rollout
from mbt_gym_torch.utils.config import oe_env_config


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--trajectories", type=int, default=16384)
    parser.add_argument("--n-steps", type=int, default=200)
    parser.add_argument("--iterations", type=int, default=600)
    parser.add_argument("--phases", type=int, default=3)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--eval-every", type=int, default=100)
    parser.add_argument("--eval-episodes", type=int, default=4)
    # alpha=0.1 makes liquidation decisively beneficial (holding all 10
    # units costs ~alpha*q0^2 = 10 vs ~1 of impact cost for the schedule);
    # the oe_env_config default 0.01 sits near indifference, a weak signal.
    parser.add_argument("--alpha", type=float, default=0.1)
    parser.add_argument("--phi", type=float, default=2e-3)
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = parser.parse_args()

    raw_cfg = oe_env_config(
        num_trajectories=args.trajectories, n_steps=args.n_steps,
        terminal_inventory_aversion=args.alpha,
        per_step_inventory_aversion=args.phi,
    )
    env_cfg = dataclasses.replace(
        raw_cfg, normalise_observation_space=True, normalise_action_space=True
    )

    oe = CarteaJaimungalOeAgent.from_config(raw_cfg, phi=args.phi, alpha=args.alpha)
    cf_res = jit_rollout(raw_cfg, oe.policy(), None, 7, device=args.device)
    cf = float(cf_res.trajectory.rewards.sum(dim=0).mean())
    print(f"closed-form CJ-OE schedule mean episode reward: {cf:.4f}", flush=True)

    ppo_cfg = ppo.PPOConfig(
        hidden=(256, 256), gamma=1.0, gae_lambda=0.95, n_epochs=1,
        n_minibatches=4, shuffle=False, compute_dtype="bfloat16",
        shared_trunk=True, learning_rate=args.lr,
        fused_update=True, fused_rollout=True,
    )
    ts = ppo.init_train_state(env_cfg, ppo_cfg, 0, device=args.device)

    t0 = time.time()
    per_phase = args.iterations // args.phases
    i = 0
    for phase in range(args.phases):
        if phase > 0:
            ppo_cfg = dataclasses.replace(ppo_cfg, learning_rate=args.lr * 0.2**phase)
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
                det = float(ppo.evaluate_policy(env_cfg, ts.params, 9000 + i, 2))
                print(
                    f"iter {i:4d}  t={time.time()-t0:6.1f}s  "
                    f"stoch {float(metrics['mean_episode_reward']):9.4f}  "
                    f"det {det:9.4f}  (closed form {cf:.4f})",
                    flush=True,
                )
    det = float(ppo.evaluate_policy(env_cfg, ts.params, 31337, args.eval_episodes))
    # rewards are negative execution costs; report the cost gap (det - cf:
    # >= 0 means PPO matched or beat the discretized closed-form schedule)
    print(
        f"final deterministic eval: {det:.4f} vs closed-form {cf:.4f} "
        f"(gap {det - cf:+.4f}; hold-everything baseline would pay "
        f"~-{args.alpha * oe.initial_inventory**2:.1f} terminal aversion)",
        flush=True,
    )


if __name__ == "__main__":
    main()
