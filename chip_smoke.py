#!/usr/bin/env python3
"""Smoke run of mbt_gym_torch on one NVIDIA GPU (H100): builds the CUDA
kernels from mbt_gym_torch/ops/csrc/ (the AS episode kernels K1/K2, the MLP
rollout K3, the fused PPO update K4), holds each against its plain PyTorch
version on the card, drives the two main paths through the public entry
points and times it all:

- the Avellaneda-Stoikov path, ``rollout`` and ``mc_episode_stats`` with
  ``backend="auto"`` (K2, K1), then ``backend="engine"`` (phases 1-6);
- PPO training on the normalised AS env at bench_suite config 5 (262,144
  envs x 200 steps, 256x256 shared trunk, 16 minibatches, bf16), through
  ``init_train_state`` / ``train_iteration`` / ``train_chunk`` on the fused
  path (K3 once and K4 16 times per iteration), then the engine path at the
  dryrun shape (phases 7-12).

Run from the repository root:

    python3 chip_smoke.py

It exits non-zero, printing no result, without a CUDA device or without the
package beside it, and on any failed phase.  Its last three lines are the
``kernels`` JSON object, the card's name and power limit from nvidia-smi,
and ``{"ok": true, "device": {...}}``.
"""
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

# H100 SXM data-sheet peaks used for bound_ms.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12  # dense tensor-core peak

N_MAIN = 16_384
N_LARGE = 1_048_576
STEPS = 200
EPISODES = 8

# Operations one AS env-step does in native mode (csrc/as_episode.cu),
# counting each integer or float op and each libm call as one: two
# Philox4x32-10 calls at 10 rounds x 8 ops + 9 key bumps x 2 (196), six
# 24-bit uniforms x 3 (18), Box-Muller (7), quotes with the step time (9),
# arrivals/fills/masks (14), bookkeeping and clip (10), price move (3).
# K2 emit="full" adds the mark-to-market value and reward (3).  Integer ops
# are held to the float32 peak too: the bound stays a lower bound.
OPS_PER_ENV_STEP_K1 = 196 + 18 + 7 + 9 + 14 + 10 + 3
OPS_PER_ENV_STEP_K2_FULL = OPS_PER_ENV_STEP_K1 + 3

AS_BANDS = {"mean_spread": (1.4918, 0.01), "mean_pnl": (64.87, 1.0), "std_terminal_inventory": (2.89, 0.3)}


class PhaseFailed(RuntimeError):
    pass


def check(ok, message):
    if not ok:
        raise PhaseFailed(message)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, warmup=2, reps=5):
    """Median milliseconds of ``fn`` between CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_bands(stats, label):
    for key, (want, tol) in AS_BANDS.items():
        got = float(stats[key])
        check(abs(got - want) < tol, f"{label}: {key}={got} outside {want} +/- {tol}")
    print(f"{label}: " + ", ".join(f"{k}={float(stats[k]):.4f}" for k in ("mean_spread", "mean_pnl", "std_pnl", "std_terminal_inventory")))


def compare_terminal(torch, got, want, n, label):
    """K1-style (cash, inv, price) against the plain version: inventory
    exact or at most 1e-4 of envs flipped (a fill decided at an exp() ULP
    boundary); cash rtol=1e-6/atol=1e-3 and price atol=1e-3 on the rest.
    Returns the max abs error over the compared values."""
    cash, inv, price = got
    same = inv == want[1]
    flips = int((~same).sum())
    check(flips <= n // 10_000, f"{label}: inventory differs on {flips} of {n} envs")
    torch.testing.assert_close(cash[same], want[0][same], rtol=1e-6, atol=1e-3, msg=lambda m: f"{label} cash: {m}")
    torch.testing.assert_close(price[same], want[2][same], rtol=0, atol=1e-3, msg=lambda m: f"{label} price: {m}")
    err = max(float((a[same] - b[same]).abs().max()) for a, b in zip(got, want))
    print(f"{label}: inventory flips {flips}/{n}, max abs err {err:.3g}")
    return err


def compare_streams(torch, got, want, n, label):
    """K2 planes (each (T, N)) against the plain version, envs whose
    inventory stream agrees everywhere; at most 1e-4 of envs may differ."""
    inv_got, inv_want = got[1], want[1]
    same = (inv_got == inv_want).all(dim=0)
    flips = int((~same).sum())
    check(flips <= n // 10_000, f"{label}: inventory stream differs on {flips} of {n} envs")
    err = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        torch.testing.assert_close(a[:, same], b[:, same], rtol=1e-6, atol=1e-3, msg=lambda m: f"{label} plane {i}: {m}")
        err = max(err, float((a[:, same] - b[:, same]).abs().max()))
    print(f"{label}: inventory flips {flips}/{n}, max abs err {err:.3g}")
    return err


# ------------------------------------------------------------------ PPO
PPO_N = 262_144  # bench_suite config 5
PPO_MINIBATCHES = 16
PPO_ITERATIONS = 9
DRYRUN_N, DRYRUN_T = 2048, 64


def assert_metric_bands(metrics, label):
    """__graft_entry__._assert_metric_bands (lines 42-54), copied: PPO
    sanity bands on the normalised AS env."""
    m = {k: float(v) for k, v in metrics.items()}
    check(all(v == v and abs(v) != float("inf") for v in m.values()), f"{label}: non-finite metrics {m}")
    check(abs(m["pg_loss"]) < 0.5, f"{label}: pg_loss {m}")
    check(0.0 < m["vf_loss"] < 1e4, f"{label}: vf_loss {m}")
    check(abs(m["approx_kl"]) < 0.5, f"{label}: approx_kl {m}")
    check(-200.0 < m["mean_episode_reward"] < 200.0, f"{label}: mean_episode_reward {m}")
    if "entropy" in m:
        check(0.0 < m["entropy"] < 20.0, f"{label}: entropy {m}")
    return m


def mlp_flops_per_sample(s_dim, h0, h1, a_dim):
    """Matmul FLOPs of one forward of the shared-trunk actor-critic."""
    return 2 * (s_dim * h0 + h0 * h1 + (a_dim + 1) * h1)


def ppo_grad_flops_per_sample(s_dim, h0, h1, a_dim):
    """Forward plus backward (dh2, dW_head, dW1, dh1, dW0) matmul FLOPs."""
    return mlp_flops_per_sample(s_dim, h0, h1, a_dim) + 2 * (2 * (a_dim + 1) * h1 + 2 * h0 * h1 + s_dim * h0)


def profile_iteration(torch, card, label, fn, top=6):
    """One call of ``fn`` under torch.profiler: device time by kernel
    (self time, summed over launches) and the device's busy share of the
    call's wall time (kernel time / wall; overlapping kernels would count
    twice, and this program runs one stream)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us / 1e3, e.count, e.key))
    busy_ms = sum(r[0] for r in rows)
    if not rows:
        print(f"phase 12 profile [{card}] {label}: the profiler saw no device time (wall {wall_ms} ms)")
        return
    print(f"phase 12 profile [{card}] {label}: wall {wall_ms} ms under the profiler, device busy {busy_ms} ms "
          f"({busy_ms / wall_ms:.1%}), idle share {1 - busy_ms / wall_ms:.1%}")
    for ms, count, key in sorted(rows, reverse=True)[:top]:
        print(f"    {ms:10.3f} ms  {count:6d} x  {key[:90]}")


def ppo_phases(torch, np, card, dev):
    """Phases 8-12: K3 and K4 against their plain versions, the fused PPO
    main path, the engine path, timings.  Returns the kernels-line entries
    of K3 and K4."""
    import dataclasses

    from mbt_gym_torch import init_train_state, train_chunk, train_iteration
    from mbt_gym_torch.agents.networks import init_actor_critic
    from mbt_gym_torch.agents.ppo import PPOConfig, compute_gae, normalise
    from mbt_gym_torch.ops import _build
    from mbt_gym_torch.ops import fused_ppo
    from mbt_gym_torch.ops import mlp_rollout as mr
    from mbt_gym_torch.utils.config import as_env_config

    env_cfg = dataclasses.replace(
        as_env_config(num_trajectories=PPO_N),
        normalise_observation_space=True, normalise_action_space=True,
    )
    ppo_cfg = PPOConfig(
        hidden=(256, 256), n_epochs=1, n_minibatches=PPO_MINIBATCHES, shuffle=False,
        compute_dtype="bfloat16", shared_trunk=True, fused_rollout=True, fused_update=True,
    )
    steps = env_cfg.n_steps
    p = mr.rollout_params_from_config(env_cfg)
    model = init_actor_critic(0, 4, 2, hidden=(256, 256), shared_trunk=True, device=dev)

    # ---- phase 8: K3 against its plain version at config 5, noise and
    # native mode.  A fill decided on the other side of u < exp(-k d) by a
    # summation-order difference changes that env's later path: at most
    # 0.1% of envs may differ in their inventory stream (0 of 262,144 seen
    # in both modes on the H100), the rest agree to rtol=1e-4/atol=1e-3
    # (max abs err 2.4e-4 seen, on ~100-scale cash and rewards).
    rng = np.random.default_rng(21)
    channels = rng.uniform(size=(steps, mr.N_CHANNELS, PPO_N)).astype(np.float32)
    channels[:, 4:] = rng.normal(size=(steps, 3, PPO_N)).astype(np.float32)
    noise = torch.from_numpy(channels).to(dev)
    del channels
    k3_err = 0.0
    for mode, kw in (("noise", {"noise": noise}), ("native", {"seed": 31, "device": dev})):
        got = mr.mlp_rollout(p, model, num_trajectories=PPO_N, **kw)
        want = mr.mlp_rollout_plain(p, model, num_trajectories=PPO_N, **kw)
        torch.cuda.synchronize()
        same = (got[0][:, 1] == want[0][:, 1]).all(dim=0)
        flips = int((~same).sum())
        check(flips <= PPO_N // 1000, f"phase 8 K3 {mode}: inventory stream differs on {flips} of {PPO_N} envs")
        for name, a, b in zip(("obs", "actions", "log_probs", "values", "rewards"), got, want):
            torch.testing.assert_close(a[..., same], b[..., same], rtol=1e-4, atol=1e-3,
                                       msg=lambda m: f"phase 8 K3 {mode} {name}: {m}")
            k3_err = max(k3_err, float((a[..., same] - b[..., same]).abs().max()))
        print(f"phase 8 K3 {mode} at {PPO_N}x{steps}: inventory flips {flips}/{PPO_N}, max abs err {k3_err:.3g}")
    del noise, want

    # ---- phase 9: K4 against its plain version on the first minibatch
    # (a 16,384-env slice, as views) of phase 8's native rollout, log_std
    # moved by 0.05 so that ratios leave 1 and both clip branches occur.
    # float32: every grad to rtol=1e-4, atol 1e-4 of the leaf's largest
    # value; bf16: relative Frobenius error per leaf at most 1e-3 (the same
    # roundings in both, so only summation order differs: 3.9e-6 seen on
    # the H100); metrics to rtol=1e-4.
    obs_t, actions_t, log_probs, values, rewards = got
    adv, returns = compute_gae(rewards, values, torch.zeros_like(values[0]), 1.0, 0.95)
    nb = PPO_N // PPO_MINIBATCHES
    mb = [x[..., :nb] for x in (obs_t, actions_t, log_probs, adv, returns)]
    mb[3] = normalise(mb[3])
    moved = init_actor_critic(0, 4, 2, hidden=(256, 256), shared_trunk=True, device=dev)
    with torch.no_grad():
        moved.log_std.add_(0.05)
    k4_err = 0.0
    for dtype in ("float32", "bfloat16"):
        grads, metrics = fused_ppo.ppo_fused_grads_T(moved, *mb, compute_dtype=dtype)
        want_g, want_m = fused_ppo.ppo_fused_grads_T_plain(moved, *mb, compute_dtype=dtype)
        torch.cuda.synchronize()
        worst = 0.0
        for name, want in want_g.items():
            got_leaf = grads[name]
            rel = float(torch.linalg.vector_norm(got_leaf - want) / torch.linalg.vector_norm(want).clamp_min(1e-30))
            worst = max(worst, rel)
            if dtype == "float32":
                torch.testing.assert_close(got_leaf, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()),
                                           msg=lambda m: f"phase 9 K4 float32 {name}: {m}")
            else:
                check(rel <= 1e-3, f"phase 9 K4 bf16 {name}: relative Frobenius error {rel}")
                k4_err = max(k4_err, float((got_leaf - want).abs().max()))
        for name, want in want_m.items():
            torch.testing.assert_close(metrics[name], want, rtol=1e-4, atol=1e-7,
                                       msg=lambda m: f"phase 9 K4 {dtype} {name}: {m}")
        print(f"phase 9 K4 {dtype} at {steps}x{nb}: worst relative Frobenius error {worst:.3g}, "
              f"metrics {[round(float(v), 6) for v in metrics.values()]}")
    del got, obs_t, actions_t, log_probs, values, rewards, adv, returns, mb

    # ---- phase 10: the fused main path through the public entry points
    ts = init_train_state(env_cfg, ppo_cfg, 0)
    check(next(ts.params.parameters()).device.type == "cuda", "phase 10: params not on the card")
    _build.reset_launch_counts()
    history = []
    for i in range(PPO_ITERATIONS):
        ts, metrics = train_iteration(env_cfg, ppo_cfg, ts, 100 + i)
        history.append(assert_metric_bands(metrics, f"phase 10 iteration {i + 1}"))
    ts, chunk = train_chunk(env_cfg, ppo_cfg, ts, 7, 2)
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
    n_it = PPO_ITERATIONS + 2
    print(f"phase 10 launches on the PPO main path ({n_it} iterations): {launches}")
    check(launches["mlp_rollout"] == n_it, f"phase 10: K3 launched {launches['mlp_rollout']} times, not {n_it}")
    check(launches["ppo_fused_grads_T"] == PPO_MINIBATCHES * n_it,
          f"phase 10: K4 launched {launches['ppo_fused_grads_T']} times, not {PPO_MINIBATCHES * n_it}")
    check(launches["as_episode"] == launches["as_episode_trajectories"] == 0, "phase 10: an AS kernel ran")
    for i in range(2):
        assert_metric_bands({k: v[i] for k, v in chunk.items()}, f"phase 10 train_chunk {i + 1}")
    rewards = [m["mean_episode_reward"] for m in history]
    early, late = statistics.mean(rewards[1:4]), statistics.mean(rewards[-3:])
    print(f"phase 10 mean_episode_reward by iteration: {rewards}; iterations 2-4 {early}, last 3 {late}")
    print(f"phase 10 last metrics: {history[-1]}")
    check(late >= early - 1.0, f"phase 10: PPO degraded, mean reward {early} -> {late}")

    # ---- phase 11: the engine path on the card at the dryrun shape
    dry_cfg = dataclasses.replace(env_cfg, num_trajectories=DRYRUN_N, n_steps=DRYRUN_T)
    dry_ppo = PPOConfig(hidden=(256, 256), n_epochs=1, n_minibatches=4)
    dts = init_train_state(dry_cfg, dry_ppo, 2)
    _build.reset_launch_counts()
    dts, dry_metrics = train_iteration(dry_cfg, dry_ppo, dts, 3)
    torch.cuda.synchronize()
    check(sum(_build.launch_counts.values()) == 0, "phase 11: the engine path launched a kernel")
    print(f"phase 11 engine train_iteration at {DRYRUN_N}x{DRYRUN_T}: {assert_metric_bands(dry_metrics, 'phase 11')}")

    # ---- phase 12: timings (CUDA events, medians after warm-up)
    env_steps = PPO_N * steps
    state = {"ts": ts}

    def fused_iteration():
        state["ts"], _ = train_iteration(env_cfg, ppo_cfg, state["ts"], 5)

    it_ms = cuda_ms(torch, fused_iteration, warmup=1, reps=3)
    engine_cfg = dataclasses.replace(ppo_cfg, fused_rollout=False, fused_update=False)
    engine_ms = cuda_ms(torch, lambda: train_iteration(env_cfg, engine_cfg, ts, 5), warmup=1, reps=2)
    for name, ms in (("fused train_iteration (K3 + 16 x K4)", it_ms), ("engine train_iteration", engine_ms)):
        print(f"phase 12 [{card}] {name} at config 5 ({PPO_N}x{steps}, 16 minibatches): "
              f"{ms} ms = {env_steps / ms * 1e3} env-steps/s")
    for name, fn in (("fused", fused_iteration), ("engine", lambda: train_iteration(env_cfg, engine_cfg, ts, 5))):
        profile_iteration(torch, card, f"{name} train_iteration at config 5", fn)
    params = ts.params
    k3_ms = cuda_ms(torch, lambda: mr.mlp_rollout(p, params, 9, PPO_N, device=dev), warmup=1, reps=5)
    k3_plain_ms = cuda_ms(torch, lambda: mr.mlp_rollout_plain(p, params, 9, PPO_N, device=dev), warmup=1, reps=2)
    tb = mr.collect_rollout_fused_T(env_cfg, params, 9, device=dev)
    mb = [x[..., :nb] for x in (tb.obs_t, tb.actions_t, tb.log_probs, tb.advantages, tb.returns)]
    mb[3] = normalise(mb[3])
    k4_ms = cuda_ms(torch, lambda: fused_ppo.ppo_fused_grads_T(params, *mb), warmup=2, reps=10)
    k4_plain_ms = cuda_ms(torch, lambda: fused_ppo.ppo_fused_grads_T_plain(params, *mb), warmup=1, reps=3)

    def bound(bytes_moved, ops, peak):
        t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    s_dim, a_dim, (h0, h1) = 4, 2, ppo_cfg.hidden
    # K3 native mode reads nothing per step and writes obs, actions,
    # log-prob, value and reward: (S + A + 3) floats per env-step
    k3_bound = bound((s_dim + a_dim + 3) * 4 * env_steps, mlp_flops_per_sample(s_dim, h0, h1, a_dim) * env_steps,
                     BF16_OPS_PER_S)
    # K4 reads obs, actions, old log-prob, advantage and return once per
    # sample; its outputs are the grads (~0.3 MB)
    samples = steps * nb
    k4_bound = bound((s_dim + a_dim + 3) * 4 * samples, ppo_grad_flops_per_sample(s_dim, h0, h1, a_dim) * samples,
                     BF16_OPS_PER_S)
    for name, ms, plain_ms, (b_ms, b_by), shape in (
        ("K3 mlp_rollout native", k3_ms, k3_plain_ms, k3_bound, f"{PPO_N}x{steps}"),
        ("K4 ppo_fused_grads_T bf16 (one minibatch)", k4_ms, k4_plain_ms, k4_bound, f"{steps}x{nb}"),
    ):
        print(f"phase 12 [{card}] {name} at {shape}: {ms} ms, plain {plain_ms} ms, "
              f"bound {b_ms} ms ({b_by}), {b_ms / ms:.1%} of bound")
    return [
        {
            "name": "K3 mlp_rollout", "route": "cuda", "source": "mbt_gym_torch/ops/csrc/mlp_rollout.cu",
            "replaces": "mbt_gym_tpu/ops/pallas_rollout.py:1514", "launches": launches["mlp_rollout"],
            "max_abs_err": k3_err, "ms": k3_ms, "plain_ms": k3_plain_ms,
            "bound_ms": k3_bound[0], "bound_by": k3_bound[1], "library_ms": None,
        },
        {
            "name": "K4 ppo_fused_grads_T", "route": "cuda", "source": "mbt_gym_torch/ops/csrc/fused_ppo.cu",
            "replaces": "mbt_gym_tpu/ops/fused_ppo.py:392", "launches": launches["ppo_fused_grads_T"],
            "max_abs_err": k4_err, "ms": k4_ms, "plain_ms": k4_plain_ms,
            "bound_ms": k4_bound[0], "bound_by": k4_bound[1], "library_ms": None,
        },
    ]


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    import dataclasses

    import numpy as np

    from mbt_gym_torch import dispatch_report, episode_stats, mc_episode_stats, rollout
    from mbt_gym_torch.agents.baseline import AvellanedaStoikovAgent
    from mbt_gym_torch.ops import _build
    from mbt_gym_torch.ops import episode as ep
    from mbt_gym_torch.utils.config import as_env_config

    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch {torch.__version__} CUDA {torch.version.cuda} | {kind}")

    # ---- phase 1 (K1/K2) and phase 7 (K3/K4): build every kernel source,
    # one nvcc each, all started together, with -Xptxas -v
    t0 = time.perf_counter()
    sources = ("as_episode.cu", "mlp_rollout.cu", "fused_ppo.cu")
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(lambda src: _build.build(src, ptxas_verbose=True), sources))
    ep._kernels()
    print(f"phase 1/7 build: {', '.join(sources)} in {time.perf_counter() - t0:.1f} s")

    # ---- phase 2/3: K1 and K2 against their plain versions, noise mode on
    # two configs and native mode, at the main path's 16,384 x 200
    default_cfg = as_env_config(num_trajectories=N_MAIN)
    late_cfg = dataclasses.replace(default_cfg, initial_cash=5.0, initial_inventory=3, start_time=0.2)
    err = {"K1": 0.0, "K2": 0.0}
    for label, cfg in (("late-start", late_cfg), ("default", default_cfg)):
        p = ep.params_from_config(cfg, 0.1)
        rng = np.random.default_rng(11)
        channels = rng.uniform(size=(p.run_steps, 5, N_MAIN)).astype(np.float32)
        channels[:, 4] = rng.normal(size=(p.run_steps, N_MAIN)).astype(np.float32)
        noise = torch.from_numpy(channels).to(dev)
        for mode, kw in (("noise", {"noise": noise}), ("native", {"seed": 50, "device": dev})):
            k1 = ep.as_episode(p, num_trajectories=N_MAIN, **kw)
            k1_plain = ep.as_episode_plain(p, num_trajectories=N_MAIN, **kw)
            torch.cuda.synchronize()
            err["K1"] = max(err["K1"], compare_terminal(torch, k1, k1_plain, N_MAIN, f"phase 2 K1 {label} {mode}"))
            for emit in ("full", "container"):
                k2 = ep.as_episode_trajectories(p, num_trajectories=N_MAIN, emit=emit, **kw)
                k2_plain = ep.as_episode_trajectories_plain(p, num_trajectories=N_MAIN, emit=emit, **kw)
                torch.cuda.synchronize()
                err["K2"] = max(err["K2"], compare_streams(torch, k2, k2_plain, N_MAIN, f"phase 3 K2 {emit} {label} {mode}"))
                last = (k2[0][-1], k2[1][-1], k2[3 if emit == "container" else 2][-1])
                check(all(torch.equal(a, b) for a, b in zip(last, k1)),
                      f"phase 3 K2 {emit} {label} {mode}: last row differs from K1's terminal state")
    print("phase 2/3 ok: K1 and K2 agree with their plain versions; K2's last row is K1's terminal state")

    # ---- phase 4: the main path through the public entry points (native)
    cfg = default_cfg
    policy = AvellanedaStoikovAgent.from_config(cfg, risk_aversion=0.1).policy()
    for mode in ("rollout", "stats"):
        decision = dispatch_report(cfg, policy, mode=mode)
        check((decision.backend, decision.family) == ("fused", "as_episode"), f"phase 4 dispatch ({mode}): {decision}")
    _build.reset_launch_counts()
    res = rollout(cfg, policy, None, 50)
    mc = mc_episode_stats(cfg, policy, None, 51, episodes=EPISODES)
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
    print(f"phase 4 launches on the main path: {launches}")
    check(launches["as_episode_trajectories"] > 0, "phase 4: rollout did not launch K2")
    check(launches["as_episode"] > 0, "phase 4: mc_episode_stats did not launch K1")
    traj = res.trajectory
    check(tuple(traj.observations.shape) == (STEPS + 1, N_MAIN, 4), f"phase 4 obs shape {tuple(traj.observations.shape)}")
    check(tuple(traj.actions.shape) == (STEPS, N_MAIN, 2) and tuple(traj.rewards.shape) == (STEPS, N_MAIN), "phase 4 shapes")
    check(all(bool(torch.isfinite(x).all()) for x in traj), "phase 4: non-finite trajectory values")
    check(traj.observations.device.type == "cuda", "phase 4: trajectory not on the card")
    check(mc["episodes"] == EPISODES * N_MAIN, f"phase 4: {mc['episodes']} episodes")
    check_bands(episode_stats(cfg, traj), "phase 4 rollout (fused K2)")
    check_bands(mc, "phase 4 mc_episode_stats (fused K1)")

    # ---- phase 5: the same through the engine on the card
    _build.reset_launch_counts()
    eng = rollout(cfg, policy, None, 52, backend="engine")
    eng_mc = mc_episode_stats(cfg, policy, None, 53, episodes=2, backend="engine")
    torch.cuda.synchronize()
    check(sum(_build.launch_counts.values()) == 0, "phase 5: the engine launched a kernel")
    check(eng.trajectory.observations.device.type == "cuda", "phase 5: engine trajectory not on the card")
    check_bands(episode_stats(cfg, eng.trajectory), "phase 5 rollout (engine)")
    check_bands(eng_mc, "phase 5 mc_episode_stats (engine)")

    # ---- phase 6: timings (CUDA events, medians after warm-up)
    env_steps = N_MAIN * STEPS
    p = ep.params_from_config(cfg, 0.1)
    t_stats = cuda_ms(torch, lambda: mc_episode_stats(cfg, policy, None, 7, episodes=EPISODES))
    t_roll = cuda_ms(torch, lambda: rollout(cfg, policy, None, 7))
    t_eng = cuda_ms(torch, lambda: rollout(cfg, policy, None, 7, backend="engine"), warmup=1, reps=3)
    for name, ms, steps in (
        ("mc_episode_stats fused K1 (8 episodes)", t_stats, EPISODES * env_steps),
        ("rollout fused K2 full", t_roll, env_steps),
        ("rollout engine", t_eng, env_steps),
    ):
        print(f"phase 6 [{card}] {name} at {N_MAIN}x{STEPS}: {ms} ms per call = {steps / ms * 1e3} env-steps/s")
    k1_ms = cuda_ms(torch, lambda: ep.as_episode(p, 9, N_MAIN, device=dev), warmup=3, reps=20)
    k2_ms = cuda_ms(torch, lambda: ep.as_episode_trajectories(p, 9, N_MAIN, emit="full", device=dev), warmup=3, reps=20)
    k1_plain_ms = cuda_ms(torch, lambda: ep.as_episode_plain(p, 9, N_MAIN, device=dev), warmup=1, reps=3)
    k2_plain_ms = cuda_ms(torch, lambda: ep.as_episode_trajectories_plain(p, 9, N_MAIN, emit="full", device=dev), warmup=1, reps=3)
    large = ep.params_from_config(dataclasses.replace(cfg, num_trajectories=N_LARGE), 0.1)
    k1_large = cuda_ms(torch, lambda: ep.as_episode(large, 9, N_LARGE, device=dev), warmup=2, reps=10)
    k2_large = cuda_ms(torch, lambda: ep.as_episode_trajectories(large, 9, N_LARGE, emit="full", device=dev), warmup=2, reps=10)
    def bound(bytes_moved, ops):
        t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    def k1_bound_at(n):  # terminal (cash, inv, price) out; native mode reads nothing
        return bound(3 * 4 * n, OPS_PER_ENV_STEP_K1 * n * STEPS)

    def k2_bound_at(n):  # six (T, N) float32 streams out
        return bound(6 * 4 * n * STEPS, OPS_PER_ENV_STEP_K2_FULL * n * STEPS)

    for name, ms, plain_ms, n, (b_ms, b_by) in (
        ("K1 as_episode native", k1_ms, k1_plain_ms, N_MAIN, k1_bound_at(N_MAIN)),
        ("K2 as_episode_trajectories full native", k2_ms, k2_plain_ms, N_MAIN, k2_bound_at(N_MAIN)),
        ("K1 as_episode native", k1_large, None, N_LARGE, k1_bound_at(N_LARGE)),
        ("K2 as_episode_trajectories full native", k2_large, None, N_LARGE, k2_bound_at(N_LARGE)),
    ):
        plain = f", plain {plain_ms} ms" if plain_ms is not None else ""
        print(
            f"phase 6 [{card}] {name} at {n}x{STEPS}: {ms} ms = {n * STEPS / ms * 1e3} env-steps/s, "
            f"bound {b_ms} ms ({b_by}), {b_ms / ms:.1%} of bound{plain}"
        )

    k1_bound = k1_bound_at(N_MAIN)
    k2_bound = k2_bound_at(N_MAIN)
    kernels = [
        {
            "name": "K1 as_episode", "route": "cuda", "source": "mbt_gym_torch/ops/csrc/as_episode.cu",
            "replaces": "mbt_gym_tpu/ops/pallas_episode.py:233", "launches": launches["as_episode"],
            "max_abs_err": err["K1"], "ms": k1_ms, "plain_ms": k1_plain_ms,
            "bound_ms": k1_bound[0], "bound_by": k1_bound[1], "library_ms": None,
        },
        {
            "name": "K2 as_episode_trajectories", "route": "cuda", "source": "mbt_gym_torch/ops/csrc/as_episode.cu",
            "replaces": "mbt_gym_tpu/ops/pallas_episode.py:1074", "launches": launches["as_episode_trajectories"],
            "max_abs_err": err["K2"], "ms": k2_ms, "plain_ms": k2_plain_ms,
            "bound_ms": k2_bound[0], "bound_by": k2_bound[1], "library_ms": None,
        },
    ]
    kernels += ppo_phases(torch, np, card, dev)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
