"""Times the port's eager engine paths on the card, at the shapes of
``chip_smoke.py`` phase 27d: the AS engine rollout at 16,384 x 200, config
14's 8 engine episodes (65,536 x 200), and the engine PPO iteration (shared
256x256 trunk, 16 contiguous minibatches, bf16, autograd) at bench_suite
configs 5, 6 and 10 (262,144 x 200).  Each path is called ``--warmup``
times untimed, then ``--calls`` times on the host clock with the card
synchronised around each call; the median is reported.

    python3 eager_timing.py [--root DIR] [--calls N] [--warmup N]

``--root`` names the checkout whose ``mbt_gym_torch`` is timed (by default
the one beside this script), so that two trees can be timed one after the
other on one card, for example parent, change, change, parent.  The
output is one JSON line: the root, the card's name and power limit, and
each path's median and single calls in ms.  Nothing here needs a kernel
build: the engine paths run PyTorch's own kernels.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

N_MAIN = 16_384  # the AS serving shape
PPO_N = 262_144  # bench_suite configs 5, 6 and 10
PPO_MINIBATCHES = 16
COMPOSITE_EVAL_N = 65_536  # bench_suite config 14
COMPOSITE_EPISODES = 8
COMPOSITE_ACTION = (0.6, 0.6, 0.0, 0.0)  # config 4's fixed quotes, no market orders


def paths(device, n_main=N_MAIN, ppo_n=PPO_N, eval_n=COMPOSITE_EVAL_N, n_steps=None, hidden=(256, 256),
          minibatches=PPO_MINIBATCHES):
    """``{label: (env-steps, call)}`` of the eager paths on ``device``;
    ``n_steps`` overrides every config's episode length (the CPU test's
    small shapes)."""
    from mbt_gym_torch import init_train_state, rollout, train_iteration
    from mbt_gym_torch.agents.baseline import AvellanedaStoikovAgent, fixed_action_policy
    from mbt_gym_torch.agents.ppo import PPOConfig
    from mbt_gym_torch.utils.config import as_env_config, composite_env_config, oe_env_config

    steps = {} if n_steps is None else {"n_steps": n_steps}
    norm = dict(normalise_observation_space=True, normalise_action_space=True)
    as_cfg = as_env_config(num_trajectories=n_main, **steps)
    as_pol = AvellanedaStoikovAgent.from_config(as_cfg).policy()
    cfg14 = composite_env_config(num_trajectories=eval_n, **steps)
    pol14 = fixed_action_policy(COMPOSITE_ACTION)
    out = {
        f"AS engine rollout {n_main}x{as_cfg.n_steps}": (
            n_main * as_cfg.n_steps, lambda: rollout(as_cfg, as_pol, None, 90, backend="engine", device=device)),
        f"config 14's {COMPOSITE_EPISODES} engine episodes ({eval_n}x{cfg14.n_steps})": (
            COMPOSITE_EPISODES * eval_n * cfg14.n_steps,
            lambda: [rollout(cfg14, pol14, None, 90 + e, backend="engine", device=device)
                     for e in range(COMPOSITE_EPISODES)]),
    }
    engine = PPOConfig(hidden=hidden, n_epochs=1, n_minibatches=minibatches, compute_dtype="bfloat16",
                       shared_trunk=True, shuffle=False)
    configs = (("5", dataclasses.replace(as_env_config(num_trajectories=ppo_n, **steps), **norm)),
               ("6", dataclasses.replace(oe_env_config(num_trajectories=ppo_n, **steps), **norm)),
               ("10", dataclasses.replace(composite_env_config(num_trajectories=ppo_n, **steps),
                                          normalise_observation_space=True)))
    for name, cfg in configs:
        ts = init_train_state(cfg, engine, 93, device=device)
        out[f"engine iteration, config {name} ({ppo_n}x{cfg.n_steps})"] = (
            ppo_n * cfg.n_steps, lambda cfg=cfg, ts=ts: train_iteration(cfg, engine, ts, 94))
    return out


def time_paths(torch, device, calls, warmup, **shapes):
    """``{label: {"ms", "calls_ms", "env_steps_per_s"}}``: the median of
    ``calls`` host-clock calls of each path after ``warmup`` untimed ones."""
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    result = {}
    for label, (env_steps, fn) in paths(device, **shapes).items():
        for _ in range(warmup):
            fn()
        sync()
        times = []
        for _ in range(calls):
            t0 = time.perf_counter()
            fn()
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(times)
        result[label] = {"ms": ms, "calls_ms": times, "env_steps_per_s": env_steps / ms * 1e3}
    return result


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)),
                        help="the checkout whose mbt_gym_torch is timed")
    parser.add_argument("--calls", type=int, default=5)
    parser.add_argument("--warmup", type=int, default=2)
    args = parser.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("eager_timing: no CUDA device", file=sys.stderr)
        return 1
    import mbt_gym_torch

    if os.path.dirname(os.path.dirname(os.path.abspath(mbt_gym_torch.__file__))) != root:
        print(f"eager_timing: imported {mbt_gym_torch.__file__}, not the package under {root}", file=sys.stderr)
        return 1
    result = time_paths(torch, "cuda", args.calls, args.warmup)
    print(json.dumps({"root": root, "card": card_line(), "calls": args.calls, "warmup": args.warmup,
                      "paths": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
