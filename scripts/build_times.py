#!/usr/bin/env python3
"""Build times of the port's kernel sources, and the host cost of the
fused learners' up-front check, on the machine with the card; for
comparing two checkouts of ``mbt_gym_torch`` on one host.

    python3 scripts/build_times.py [--root DIR] [--label NAME] [--calls N]
        [--sources A.cu,B.cu] [--flags="NVCC FLAGS"]

``--root`` is the directory that holds the ``mbt_gym_torch`` to measure
(default: this checkout); its sources are built from its own ``csrc/``
into its own ``build/``.  Every source listed in its ``_build.SOURCES`` is
compiled as chip_smoke.py compiles them: one ``nvcc`` each, all started
together, with ``-Xptxas -v`` (whose report goes to standard output).
The last line of standard output is one JSON object: each source's
seconds from the common start to its end, the wall time of them all, and
each library's path.  ``--sources`` builds only those, ``--flags`` adds
flags to every ``nvcc`` (each set of flags builds its own library).
Where the checkout's ``ppo.check_fused_update`` takes the learner's
params (the checks made before any device work on every fused learner
path), it is then called ``--calls`` times at bench_suite config 5
(262,144 x 200, 16 minibatches) on a (256, 256) and a (512, 512) trunk,
shared and towers, fully fused and with ``fused_update`` alone, and its
mean host time per call is printed beside the same learner's eager
``train_iteration`` of one fully fused iteration.
"""
import argparse
import dataclasses
import inspect
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--sources", default="")
    ap.add_argument("--flags", default="")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("build_times: no CUDA device is visible", file=sys.stderr)
        return 1
    from mbt_gym_torch.ops import _build

    _build.NVCC_FLAGS = _build.NVCC_FLAGS + tuple(args.flags.split())
    sources = args.sources.split(",") if args.sources else _build.SOURCES
    t0 = time.perf_counter()
    seconds, libraries = {}, {}

    def build(src):
        libraries[src] = str(_build.build(src, ptxas_verbose=True))
        seconds[src] = round(time.perf_counter() - t0, 1)

    with ThreadPoolExecutor(len(sources)) as pool:
        for f in [pool.submit(build, src) for src in sources]:
            f.result()
    out = {"label": args.label, "flags": args.flags, "build_s": seconds,
           "build_wall_s": round(time.perf_counter() - t0, 1), "so": libraries}

    from mbt_gym_torch.agents import ppo

    if not args.sources and "params" in inspect.signature(ppo.check_fused_update).parameters:
        from mbt_gym_torch.agents.networks import init_actor_critic
        from mbt_gym_torch.utils.config import as_env_config

        env = dataclasses.replace(as_env_config(num_trajectories=262_144), normalise_observation_space=True,
                                  normalise_action_space=True)
        dev = torch.device("cuda")
        costs = {}
        for hidden in ((256, 256), (512, 512)):
            for shared in (True, False):
                model = init_actor_critic(0, env.state_dim, env.action_dim, hidden=hidden, shared_trunk=shared,
                                          device=dev)
                for rollout in (True, False):
                    pcfg = ppo.PPOConfig(hidden=hidden, n_epochs=1, n_minibatches=16, shuffle=not rollout,
                                         compute_dtype="bfloat16", shared_trunk=shared, fused_rollout=rollout,
                                         fused_update=True)
                    ppo.check_fused_update(env, pcfg, model)
                    t1 = time.perf_counter()
                    for _ in range(args.calls):
                        ppo.check_fused_update(env, pcfg, model)
                    key = f"{'x'.join(map(str, hidden))} {'shared' if shared else 'towers'} " + (
                        "fully fused" if rollout else "fused_update")
                    costs[key] = (time.perf_counter() - t1) / args.calls * 1e6
        out["check_fused_update_us"] = costs
        pcfg = ppo.PPOConfig(hidden=(256, 256), n_epochs=1, n_minibatches=16, shuffle=False,
                             compute_dtype="bfloat16", shared_trunk=True, fused_rollout=True, fused_update=True)
        ts = ppo.init_train_state(env, pcfg, 1)
        ts, _ = ppo.train_iteration(env, pcfg, ts, 2)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ts, _ = ppo.train_iteration(env, pcfg, ts, 3)
        torch.cuda.synchronize()
        out["fully_fused_iteration_ms"] = (time.perf_counter() - t1) * 1e3
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
