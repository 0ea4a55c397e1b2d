"""Times and digests a checkout's paths on the card, so that two trees can
be set beside each other in one call (for example parent, change, change,
parent):

    python3 tree_timing.py [--root DIR] [--suite engine] [--calls N] [--warmup N]
    python3 tree_timing.py [--root DIR] --suite update [--calls N]
    python3 tree_timing.py [--root DIR] --suite update --build-only

``--root`` names the checkout whose ``mbt_gym_torch`` runs (by default the
one beside this script); the timing and report parsing are this
checkout's ``chip_smoke.py``.  Each run prints one JSON line with the
root and the card's name and power limit.

- ``engine`` (the default): the port's eager engine paths at the shapes of
  ``chip_smoke.py`` phase 27d: the AS engine rollout at 16,384 x 200,
  config 14's 8 engine episodes (65,536 x 200), and the engine PPO
  iteration (shared 256x256 trunk, 16 contiguous minibatches, bf16,
  autograd) at bench_suite configs 5, 6 and 10 (262,144 x 200).  Each path
  is called ``--warmup`` times untimed, then ``--calls`` times on the host
  clock with the card synchronised around each call; the median is
  reported.  Nothing here needs a kernel build.
- ``update``: the update kernels K4 and K7 on the first 16,384-env
  minibatch (3,276,800 samples) of a K3 native rollout (seed 31) with GAE
  at bench_suite config 5 (normalised AS, S = 4, A = 2) and config 10 (the
  composite config, S = 8, A = 4), as ``chip_smoke.py`` phase 9 takes it:
  K4 at 256x256 on the shared trunk and the towers (log_std moved by 0.05)
  in bf16 and float32; K4 and K7 in bf16 on config 5's samples with the
  observation widened to S = 8 and S = 16 (its four columns repeated, A =
  2), the shared trunk, 256x256; and K4 beside K7 (config 5's samples
  row-major) in bf16 on the shared trunks (32, 32), (64,), (256, 256) and
  (256, 256, 256); and K4 at the card edge test's S = 5, A = 1 towers
  case (256x256, 5 steps x 96 envs).  Each bf16 case with its largest
  relative leaf error against the plain version.  For each case the sha256 of its inputs and of
  its grads and metrics, and the kernel's device time
  (``chip_smoke.device_ms``: the median of ``--calls`` calls after two); a
  case that the root's kernels refuse (S = 16 before they took it) reads
  ``refused`` with the reason.  ``--build-only`` builds the root's
  ``fused_ppo.cu`` and ``mlp_rollout.cu`` with ``-Xptxas -v`` and prints
  the registers, stack and spills of the update passes instead, so that
  builds of two roots can run side by side before the timed runs.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import importlib.util
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


def _chip_smoke():
    """This checkout's chip_smoke.py (its timing and report parsing), by
    path: ``--root`` may name another tree."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("tree_timing_chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def digest(tensors) -> str:
    """sha256 of the tensors' bytes, a dict's in name order."""
    h = hashlib.sha256()
    items = sorted(tensors.items()) if isinstance(tensors, dict) else enumerate(tensors)
    for _, t in items:
        h.update(t.detach().float().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def update_cases(device, ppo_n=PPO_N, n_steps=None, minibatches=PPO_MINIBATCHES):
    """``{label: (kernel, model, inputs, compute_dtype)}`` of the ``update``
    suite.  ``n_steps`` overrides the configs' episode length (the CPU
    test's small shapes)."""
    import numpy as np
    import torch

    from mbt_gym_torch.agents.networks import init_actor_critic
    from mbt_gym_torch.agents.ppo import normalise
    from mbt_gym_torch.ops import fused_ppo
    from mbt_gym_torch.ops import mlp_rollout as mr
    from mbt_gym_torch.utils.config import as_env_config, composite_env_config

    steps = {} if n_steps is None else {"n_steps": n_steps}
    cfg5 = dataclasses.replace(as_env_config(num_trajectories=ppo_n, **steps), normalise_observation_space=True,
                               normalise_action_space=True)
    cfg10 = dataclasses.replace(composite_env_config(num_trajectories=ppo_n, **steps),
                                normalise_observation_space=True)

    def model_for(s_dim, a_dim, hidden=(256, 256), shared=True):
        model = init_actor_critic(0 if shared else 1, s_dim, a_dim, hidden=hidden, shared_trunk=shared,
                                  device=device)
        with torch.no_grad():
            model.log_std.add_(0.05)
        return model

    def rows_of(mb):
        m = mb[0].shape[0] * mb[0].shape[2]
        return [x.permute(0, 2, 1).reshape(m, -1) if x.dim() == 3 else x.reshape(-1) for x in mb]

    out = {}
    for name, cfg, s_dim, a_dim in (("config 5", cfg5, 4, 2), ("config 10", cfg10, 8, 4)):
        actor = init_actor_critic(0, s_dim, a_dim, hidden=(256, 256), shared_trunk=True, device=device)
        tb = mr.collect_rollout_fused_T(cfg, actor, 31, device=device)
        nb = ppo_n // minibatches
        mb = [x[..., :nb] for x in (tb.obs_t, tb.actions_t, tb.log_probs, tb.advantages, tb.returns)]
        mb[3] = normalise(mb[3])
        for shared in (True, False):
            model = model_for(s_dim, a_dim, shared=shared)
            layout = "shared" if shared else "towers"
            for dtype in ("bfloat16", "float32"):
                out[f"{name} K4 {layout} {dtype}"] = (fused_ppo.ppo_fused_grads_T, model, mb, dtype)
        if name != "config 5":
            continue
        for s_wide in (8, 16):
            wide = [mb[0].repeat(1, s_wide // s_dim, 1)] + mb[1:]
            model = model_for(s_wide, a_dim)
            out[f"{name} S={s_wide} K4 shared bfloat16"] = (fused_ppo.ppo_fused_grads_T, model, wide, "bfloat16")
            out[f"{name} S={s_wide} K7 shared bfloat16"] = (fused_ppo.ppo_fused_grads, model, rows_of(wide),
                                                            "bfloat16")
        for hidden in ((32, 32), (64,), (256, 256), (256, 256, 256)):
            model = model_for(s_dim, a_dim, hidden)
            trunk = "x".join(map(str, hidden))
            out[f"{name} {trunk} K4 shared bfloat16"] = (fused_ppo.ppo_fused_grads_T, model, mb, "bfloat16")
            out[f"{name} {trunk} K7 shared bfloat16"] = (fused_ppo.ppo_fused_grads, model, rows_of(mb), "bfloat16")
    # the card edge test's S = 5, A = 1 towers case (256x256, 5 steps x 96
    # envs, its seeds): the 1e-3 bound's closest case
    cs = _chip_smoke()
    model = init_actor_critic(7, 5, 1, hidden=(256, 256), shared_trunk=False, device=device)
    with torch.no_grad():
        model.log_std.add_(0.05)
    rows = cs.update_samples(torch, np, model, 5, 96, 11 + 96, device)
    out["edge S=5 A=1 K4 towers bfloat16"] = (fused_ppo.ppo_fused_grads_T, model, cs.feature_major(rows, 5, 96),
                                              "bfloat16")
    return out


def _worst_rel(torch, grads, want) -> float:
    """The largest relative Frobenius error of ``grads``' leaves against ``want``'s."""
    return max(float(torch.linalg.vector_norm(grads[n].double() - w.double())
                     / torch.linalg.vector_norm(w.double()).clamp_min(1e-30)) for n, w in want.items())


def run_update(torch, device, calls, timer=None, **shapes):
    """``{label: {"inputs", "grads", "metrics", "ms"[, "rel_vs_plain"]}}``
    (or ``{"inputs", "refused"}``) of the ``update`` suite; ``timer(fn)``
    gives a call's device ms (none on the CPU).  ``rel_vs_plain`` is a bf16
    case's largest relative leaf error against the plain version (float32
    sums)."""
    from mbt_gym_torch.ops import fused_ppo

    plain = {fused_ppo.ppo_fused_grads_T: fused_ppo.ppo_fused_grads_T_plain,
             fused_ppo.ppo_fused_grads: fused_ppo.ppo_fused_grads_plain}
    result = {}
    for label, (kernel, model, inputs, dtype) in update_cases(device, **shapes).items():
        row = {"inputs": digest(inputs)}
        try:
            grads, metrics = kernel(model, *inputs, compute_dtype=dtype)
        except ValueError as e:  # outside the root's kernel limits
            result[label] = dict(row, refused=str(e))
            continue
        ms = None if timer is None else timer(lambda: kernel(model, *inputs, compute_dtype=dtype))
        row.update(grads=digest(grads), metrics=digest(metrics), ms=ms)
        if dtype == "bfloat16":
            row["rel_vs_plain"] = _worst_rel(torch, grads, plain[kernel](model, *inputs, compute_dtype=dtype)[0])
        result[label] = row
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)),
                        help="the checkout whose mbt_gym_torch runs")
    parser.add_argument("--suite", choices=("engine", "update"), default="engine")
    parser.add_argument("--calls", type=int, default=5)
    parser.add_argument("--warmup", type=int, default=2)
    parser.add_argument("--build-only", action="store_true", help="update suite: the ptxas report only")
    args = parser.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("tree_timing: no CUDA device", file=sys.stderr)
        return 1
    import mbt_gym_torch

    if os.path.dirname(os.path.dirname(os.path.abspath(mbt_gym_torch.__file__))) != root:
        print(f"tree_timing: imported {mbt_gym_torch.__file__}, not the package under {root}", file=sys.stderr)
        return 1
    out = {"root": root, "card": card_line(), "suite": args.suite, "calls": args.calls}
    if args.suite == "engine":
        out.update(warmup=args.warmup, paths=time_paths(torch, "cuda", args.calls, args.warmup))
    elif args.build_only:
        from mbt_gym_torch.ops import _build

        for src in ("fused_ppo.cu", "mlp_rollout.cu"):
            _build.build(src, ptxas_verbose=True)
        usage = _chip_smoke().kernel_registers(_build.ptxas_reports["fused_ppo.cu"],
                                               ("ppo_pass1", "ppo_pass2", "ppo_deep_pass1", "ppo_deep_pass2"))
        out["ptxas"] = dict(sorted(usage))
    else:
        cs = _chip_smoke()
        out["cases"] = run_update(torch, torch.device("cuda"), args.calls,
                                  lambda fn: cs.device_ms(torch, fn, warmup=2, reps=args.calls))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
