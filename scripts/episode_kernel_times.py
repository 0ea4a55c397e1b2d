#!/usr/bin/env python3
"""Device times and output digests of the port's episode kernels on one
NVIDIA GPU, for comparing two checkouts of ``mbt_gym_torch`` on one card.

    python3 scripts/episode_kernel_times.py [--root DIR] [--label NAME]
        [--geometry E,P,C,R[,0] | pipeline | wide] [--reps N] [--times-only]
        [--sweep [N,...]] [--kernels K6,...]

``--root`` is the directory that holds the ``mbt_gym_torch`` to measure
(default: this checkout); its kernels are built from its own ``csrc/``.
Each timing row is the median device time of ``chip_smoke.device_ms`` (the
card's time alone, host work excluded) beside the call time
(``chip_smoke.cuda_ms``), native mode, at the main paths' shapes:

- K5 ``det_rollout``: CJP table stats and streams at 16,384 x 1,000, table
  stats at 131,072 x 1,000, OE schedule streams and OE fixed-action stats
  at 8,192 x 200;
- K8 ``cj_episode`` at 16,384 x 1,000;
- K1 ``as_episode`` at 16,384 and 1,048,576 x 200, K2
  ``as_episode_trajectories`` (``emit="full"``) at 16,384 and 1,048,576 x
  200, K2's trajectory layout (``as_episode_trajectory``, the rollout's
  Trajectory) at 16,384 and 1,048,576 x 200, K6 ``oe_episode`` at 8,192
  and 1,048,576 x 200.  A checkout without the trajectory layout times
  what its rollout ran instead: the full streams and their layout
  (``as_trajectory_from_full``), every device op of both.  Beside them,
  the call time of the AS ``rollout`` entry point at 16,384 x 200
  (``backend="auto"``);
- K3 ``mlp_rollout`` with the PnL reward at bench_suite config 5 (262,144
  x 200, 256x256, normalised AS env, bf16 operands), shared trunk and
  towers; where the checkout has them, K3's lam, touch and canonical
  kinds at bench_suite configs 8, 7 and 9 (262,144 envs, shared trunk),
  and K5's fixed kind on lam and touch at 16,384 x 200 (stats), on lam
  also at 65,536 x 200; where the checkout has the composite config, K3
  at bench_suite config 10 (``composite_env_config`` at 262,144 envs,
  normalised, shared trunk) and K5's fixed kind on it (the quotes (0.6,
  0.6, 0, 0)) at 16,384 and 65,536 (config 14) x 200 (stats).

``--geometry`` fixes the step-pipeline geometry of K1, K2, K5, K6 and K8
where the checkout has one: envs per CTA, producer warps, steps per slot,
slots, and 0 to leave the table in global memory; ``pipeline`` is the
pipeline's own choice without the wide shape, ``wide`` the wide shape (K5,
which has none, keeps its own).  ``--times-only`` skips the digests,
``--sweep`` times K1, K2 (full and the trajectory layout), K6 and K8 at
the given env counts (131,072 to 1,048,576 by default) instead, to place
the wide shape's threshold, and ``--kernels`` keeps the rows whose names
start with one of its comma-separated prefixes.  The script also prints a
sha256 digest of every output of K1-K8 on fixed inputs (noise and native
mode; K3, K4 and K7 at 4,096 envs x 200 steps; K1, K6 and K8 native at
1,048,576 envs as well), of K2's trajectory layout in both draw modes, of
the Trajectory of the AS ``rollout`` on the card and, where the checkout
has it, of K5's fixed kind on the composite config, so two checkouts can
be shown to compute the same bits.  It prints one JSON object per line and
needs a CUDA device.
"""
import argparse
import dataclasses
import hashlib
import importlib.util
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def digest(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=str(REPO))
    parser.add_argument("--label", default="this checkout")
    parser.add_argument("--geometry", default=None, help="E,P,C,R[,staged], pipeline or wide")
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--times-only", action="store_true", help="times only, no digests")
    parser.add_argument("--sweep", nargs="?", const="131072,262144,524288,1048576", default=None,
                        help="time K1, K2, K6 and K8 at these env counts (default 131,072 to 1,048,576)")
    parser.add_argument("--kernels", default=None, help="time only the rows whose names start so, e.g. K6,K5 fixed")
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("episode_kernel_times: no CUDA device is visible", file=sys.stderr)
        return 1
    cs = load_chip_smoke()
    from concurrent.futures import ThreadPoolExecutor

    from mbt_gym_torch.ops import _build

    with ThreadPoolExecutor(len(_build.SOURCES)) as pool:
        list(pool.map(_build.build, _build.SOURCES))
    from mbt_gym_torch import (
        AvellanedaStoikovAgent, CarteaJaimungalMmAgent, CarteaJaimungalOeAgent, as_env_config, cj_env_config,
        oe_env_config, rollout,
    )
    from mbt_gym_torch.ops import cj_episode as cj
    from mbt_gym_torch.ops import det_rollout as det
    from mbt_gym_torch.agents.networks import init_actor_critic
    from mbt_gym_torch.ops import episode as ep
    from mbt_gym_torch.ops import mlp_rollout as mr
    from mbt_gym_torch.ops import oe_episode as oe

    label = args.label
    if args.geometry:
        for module in (det, ep, oe, cj) if args.geometry != "wide" else (ep, oe, cj):
            geometry = getattr(module, "pipeline_geometry", None)
            if geometry is None:
                continue

            def pinned(*a, _geometry=geometry, **kw):
                if args.geometry in ("pipeline", "wide"):
                    kw.pop("wide", None)
                    g = _geometry(*a, **kw, wide=False)
                    return g.with_shape(g.envs, 0, 1, 0) if args.geometry == "wide" else g
                return _geometry(*a, **kw).with_shape(*(int(x) for x in args.geometry.split(",")))

            module.pipeline_geometry = pinned
        label += f" geometry {args.geometry}"
    dev = torch.device("cuda")
    card = cs.card_line()
    print(json.dumps({"label": label, "root": args.root, "card": card, "torch": torch.__version__}))

    cj_cfg = cj_env_config(num_trajectories=16_384, max_inventory=100.0)
    agent = CarteaJaimungalMmAgent.from_config(cj_cfg, max_inventory=100)
    p_table = det.cj_rollout_params(cj_cfg, agent)
    tables = tuple(torch.as_tensor(t, device=dev) for t in det.cj_depth_tables(agent))
    oe_cfg = oe_env_config(num_trajectories=8_192)
    oe_agent = CarteaJaimungalOeAgent.from_config(oe_cfg, phi=2e-4, alpha=0.01)
    speed_table = oe.oe_speed_table(oe_cfg, oe_agent).to(dev)
    p_sched = det.schedule_rollout_params(oe_cfg)
    p_fixed_oe = det.fixed_rollout_params(oe_cfg, [-2.5])
    p_oe = oe.oe_params_from_config(oe_cfg)
    p_cj = cj.cj_params_from_config(cj_cfg)
    cj_table = torch.tensor(agent.depth_table_f32()[:-1], device=dev)
    as_cfg = as_env_config(num_trajectories=16_384)
    p_as = ep.params_from_config(as_cfg, 0.1)
    big_p = det.cj_rollout_params(dataclasses.replace(cj_cfg, num_trajectories=131_072), agent)
    # K2's trajectory layout; where the checkout has none, the rollout's
    # assembly of it from the full streams
    as_policy = AvellanedaStoikovAgent.from_config(as_cfg, risk_aversion=0.1).policy()
    trajectory = getattr(ep, "as_episode_trajectory", None) or (
        lambda p, seed, n, noise=None, device=None: ep.as_trajectory_from_full(
            p, ep.as_episode_trajectories(p, seed, n, emit="full", noise=noise, device=device)))

    k3_n = 262_144
    p_k3 = mr.rollout_params_from_config(dataclasses.replace(
        as_env_config(num_trajectories=k3_n), normalise_observation_space=True, normalise_action_space=True))
    k3_models = {layout: init_actor_critic(0, 4, 2, hidden=(256, 256), shared_trunk=layout == "shared", device=dev)
                 for layout in ("shared", "towers")}

    rows = (
        ("K3 pnl shared", k3_n, 200, lambda: mr.mlp_rollout(p_k3, k3_models["shared"], 9, k3_n, device=dev)),
        ("K3 pnl towers", k3_n, 200, lambda: mr.mlp_rollout(p_k3, k3_models["towers"], 9, k3_n, device=dev)),
        ("K5 table stats", 16_384, 1000, lambda: det.table_rollout(p_table, *tables, 9, 16_384, stats_only=True, device=dev)),
        ("K5 table stats", 131_072, 1000, lambda: det.table_rollout(big_p, *tables, 9, 131_072, stats_only=True, device=dev)),
        ("K5 table streams", 16_384, 1000, lambda: det.table_rollout(p_table, *tables, 9, 16_384, final_obs=True, device=dev)),
        ("K5 schedule streams", 8_192, 200,
         lambda: det.schedule_rollout(p_sched, speed_table[:, None], 9, 8_192, final_obs=True, device=dev)),
        ("K5 fixed OE stats", 8_192, 200, lambda: det.fixed_rollout(p_fixed_oe, 9, 8_192, stats_only=True, device=dev)),
        ("K8", 16_384, 1000, lambda: cj.cj_episode(p_cj, cj_table, 9, 100, 16_384, device=dev)),
        ("K1", 16_384, 200, lambda: ep.as_episode(p_as, 9, 16_384, device=dev)),
        ("K1", 1_048_576, 200, lambda: ep.as_episode(p_as, 9, 1_048_576, device=dev)),
        ("K2 full", 16_384, 200, lambda: ep.as_episode_trajectories(p_as, 9, 16_384, emit="full", device=dev)),
        ("K2 full", 1_048_576, 200, lambda: ep.as_episode_trajectories(p_as, 9, 1_048_576, emit="full", device=dev)),
        ("K2 trajectory", 16_384, 200, lambda: trajectory(p_as, 9, 16_384, device=dev)),
        ("K2 trajectory", 1_048_576, 200, lambda: trajectory(p_as, 9, 1_048_576, device=dev)),
        ("K6", 8_192, 200, lambda: oe.oe_episode(p_oe, speed_table, 9, 8_192, device=dev)),
        ("K6", 1_048_576, 200, lambda: oe.oe_episode(p_oe, speed_table, 9, 1_048_576, device=dev)),
    )
    if hasattr(mr, "ACTION_DIMS"):  # the lam and touch kinds
        from mbt_gym_torch.utils.config import lam_env_config, learning_env_config, touch_env_config

        kinds = {"lam": lam_env_config, "touch": touch_env_config, "canonical": learning_env_config}
        for kind, make in kinds.items():
            cfg = dataclasses.replace(make(num_trajectories=k3_n), normalise_observation_space=True)
            p = mr.rollout_params_from_config(cfg)
            model = init_actor_critic(0, 4, cfg.action_dim, hidden=(256, 256), shared_trunk=True, device=dev)
            inv0 = torch.randint(-5, 6, (k3_n,), device=dev).float() if p.inventory_range else None
            rows += ((f"K3 {kind} shared", k3_n, p.run_steps,
                      lambda p=p, model=model, inv0=inv0: mr.mlp_rollout(p, model, 9, k3_n, device=dev, inv0=inv0)),)
        for kind, make, action in (("lam", lam_env_config, [0.6, 0.6, 0.7, 0.2]),
                                   ("touch", touch_env_config, [1.0, 0.5])):
            p = det.fixed_rollout_params(make(num_trajectories=16_384), action)
            rows += ((f"K5 fixed {kind} stats", 16_384, 200,
                      lambda p=p: det.fixed_rollout(p, 9, 16_384, stats_only=True, device=dev)),)
        p = det.fixed_rollout_params(lam_env_config(num_trajectories=65_536), [0.6, 0.6, 0.0, 0.0])
        rows += (("K5 fixed lam stats", 65_536, 200,
                  lambda p=p: det.fixed_rollout(p, 9, 65_536, stats_only=True, device=dev)),)
    from mbt_gym_torch.utils import config as config_module

    composite = getattr(config_module, "composite_env_config", None)
    if composite is not None:  # the process kinds
        p10 = mr.rollout_params_from_config(dataclasses.replace(composite(num_trajectories=k3_n),
                                                                normalise_observation_space=True))
        m10 = init_actor_critic(0, 8, 4, hidden=(256, 256), shared_trunk=True, device=dev)
        rows += (("K3 composite shared", k3_n, 200, lambda: mr.mlp_rollout(p10, m10, 9, k3_n, device=dev)),)
        for n in (16_384, 65_536):
            p = det.fixed_rollout_params(composite(num_trajectories=n), [0.6, 0.6, 0.0, 0.0])
            rows += (("K5 fixed composite stats", n, 200,
                      lambda p=p, n=n: det.fixed_rollout(p, 9, n, stats_only=True, device=dev)),)
    if args.geometry == "wide":
        rows = [row for row in rows if not row[0].startswith("K5")]
    if args.sweep:
        rows = [(name, n, steps, fn) for n in (int(x) for x in args.sweep.split(",")) for name, steps, fn in (
            ("K1", 200, lambda n=n: ep.as_episode(p_as, 9, n, device=dev)),
            ("K2 full", 200, lambda n=n: ep.as_episode_trajectories(p_as, 9, n, emit="full", device=dev)),
            ("K2 trajectory", 200, lambda n=n: trajectory(p_as, 9, n, device=dev)),
            ("K6", 200, lambda n=n: oe.oe_episode(p_oe, speed_table, 9, n, device=dev)),
            ("K8", 1000, lambda n=n: cj.cj_episode(p_cj, cj_table, 9, 100, n, device=dev)),
        )]
    if args.kernels:
        rows = [row for row in rows if row[0].startswith(tuple(args.kernels.split(",")))]
    for name, n, steps, fn in rows:
        ms = cs.device_ms(torch, fn, warmup=2, reps=args.reps)
        call = cs.cuda_ms(torch, fn, warmup=2, reps=args.reps)
        print(json.dumps({"label": label, "kernel": name, "shape": f"{n}x{steps}", "device_ms": ms, "call_ms": call,
                          "card": card}))

    if not args.sweep and (not args.kernels or "rollout AS".startswith(tuple(args.kernels.split(",")))):
        # the entry point reads its seed back to the host, so only its call time is defined
        call = cs.cuda_ms(torch, lambda: rollout(as_cfg, as_policy, None, 9), warmup=2, reps=args.reps)
        print(json.dumps({"label": label, "kernel": "rollout AS", "shape": "16384x200", "call_ms": call, "card": card}))
    if args.times_only or args.sweep:
        return 0

    def channels(seed, steps, n):
        rng = np.random.default_rng(seed)
        c = rng.uniform(size=(steps, 5, n)).astype(np.float32)
        c[:, 4] = rng.normal(size=(steps, n)).astype(np.float32)
        return torch.from_numpy(c).to(dev)

    digests = {}
    k5_cases = (
        ("table CJP", p_table, tables, 16_384),
        ("fixed AS", det.fixed_rollout_params(as_cfg, [0.7, 0.9]), (), 16_384),
        ("fixed OE", det.fixed_rollout_params(oe_cfg, [-2.5]), (), 8_192),
        ("schedule OE", p_sched, (speed_table[:, None],), 8_192),
    )
    for case, p, tbl, n in k5_cases:
        for mode, kw in (("noise", {"noise": channels(14, p.run_steps, n)}), ("native", {"seed": 41, "device": dev})):
            for stats in (True, False):
                out = det.det_rollout(p, tbl, num_trajectories=n, stats_only=stats, final_obs=not stats, **kw)
                digests[f"K5 {case} {'stats' if stats else 'streams'} {mode}"] = digest(out)
    for mode, kw in (("noise", {"noise": channels(16, 1000, 16_384)}), ("native", {"seed": 43, "device": dev})):
        digests[f"K8 {mode}"] = digest(cj.cj_episode(p_cj, cj_table, q_cap=100, num_trajectories=16_384, **kw))
    for mode, kw in (("noise", {"noise": channels(11, 200, 16_384)}), ("native", {"seed": 50, "device": dev})):
        digests[f"K1 {mode}"] = digest(ep.as_episode(p_as, num_trajectories=16_384, **kw))
        digests[f"K2 {mode}"] = digest(ep.as_episode_trajectories(p_as, num_trajectories=16_384, emit="full", **kw))
        digests[f"K2 trajectory {mode}"] = digest(trajectory(p_as, kw.get("seed", 0), 16_384, noise=kw.get("noise"),
                                                             device=dev))
    normals = torch.from_numpy(np.random.default_rng(15).normal(size=(200, 8_192)).astype(np.float32)).to(dev)
    for mode, kw in (("noise", {"noise": normals}), ("native", {"seed": 42, "device": dev})):
        digests[f"K6 {mode}"] = digest(oe.oe_episode(p_oe, speed_table, num_trajectories=8_192, **kw))
    # the wide shape (one thread per env where the checkout has it)
    digests["K1 native 1048576"] = digest(ep.as_episode(p_as, 51, 1_048_576, device=dev))
    digests["K6 native 1048576"] = digest(oe.oe_episode(p_oe, speed_table, 52, 1_048_576, device=dev))
    digests["K8 native 1048576"] = digest(cj.cj_episode(p_cj, cj_table, 53, 100, 1_048_576, device=dev))
    digests["rollout AS native"] = digest(rollout(as_cfg, as_policy, None, 50).trajectory)
    if composite is not None:
        p = det.fixed_rollout_params(composite(num_trajectories=16_384), [0.6, 0.6, 0.0, 0.0])
        rng = np.random.default_rng(17)
        c = rng.uniform(size=(200, p.n_channels, 16_384)).astype(np.float32)
        c[:, 4:] = rng.normal(size=(200, p.n_channels - 4, 16_384)).astype(np.float32)
        for mode, kw in (("noise", {"noise": torch.from_numpy(c).to(dev)}), ("native", {"seed": 45, "device": dev})):
            for stats in (True, False):
                out = det.fixed_rollout(p, num_trajectories=16_384, stats_only=stats, final_obs=not stats, **kw)
                digests[f"K5 fixed composite {'stats' if stats else 'streams'} {mode}"] = digest(out)
    digests.update(ppo_digests(torch, dev))
    print(json.dumps({"label": label, "digests": digests}))
    return 0


def ppo_digests(torch, dev):
    """Digests of K3's rollout (native), K4's and K7's bf16 grads on it, at
    4,096 envs x 200 steps and 256x256."""
    from mbt_gym_torch.agents.networks import init_actor_critic
    from mbt_gym_torch.agents.ppo import compute_gae, normalise
    from mbt_gym_torch.ops import fused_ppo
    from mbt_gym_torch.ops import mlp_rollout as mr
    from mbt_gym_torch.utils.config import as_env_config

    n = 4_096
    cfg = dataclasses.replace(as_env_config(num_trajectories=n), normalise_observation_space=True,
                              normalise_action_space=True)
    p = mr.rollout_params_from_config(cfg)
    model = init_actor_critic(0, 4, 2, hidden=(256, 256), shared_trunk=True, device=dev)
    out = mr.mlp_rollout(p, model, 31, n, device=dev)
    obs_t, actions_t, log_probs, values, rewards = out
    adv, returns = compute_gae(rewards, values, torch.zeros_like(values[0]), 1.0, 0.95)
    mb = [obs_t, actions_t, log_probs, normalise(adv), returns]
    with torch.no_grad():
        model.log_std.add_(0.05)
    grads, metrics = fused_ppo.ppo_fused_grads_T(model, *mb, compute_dtype="bfloat16")
    rows = [x.permute(0, 2, 1).reshape(-1, x.shape[1]) if x.dim() == 3 else x.reshape(-1) for x in mb]
    grads7, metrics7 = fused_ppo.ppo_fused_grads(model, *rows, compute_dtype="bfloat16")
    return {
        "K3 native": digest(out),
        "K4 bf16": digest([grads[k] for k in sorted(grads)] + [metrics[k] for k in sorted(metrics)]),
        "K7 bf16": digest([grads7[k] for k in sorted(grads7)] + [metrics7[k] for k in sorted(metrics7)]),
    }


if __name__ == "__main__":
    sys.exit(main())
