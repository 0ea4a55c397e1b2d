#!/usr/bin/env python3
"""Smoke run of mbt_gym_torch on one NVIDIA GPU (H100): builds the CUDA
episode kernels K1/K2 from mbt_gym_torch/ops/csrc/, holds each against its
plain PyTorch version on the card, drives the Avellaneda-Stoikov main path
through the public entry points (``rollout`` and ``mc_episode_stats`` with
``backend="auto"``, then ``backend="engine"``), and times it all.

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

# H100 SXM data-sheet peaks used for bound_ms.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

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

    # ---- phase 1: build
    t0 = time.perf_counter()
    _build.build("as_episode.cu", ptxas_verbose=True)
    ep._kernels()
    print(f"phase 1 build: as_episode.cu in {time.perf_counter() - t0:.1f} s")

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
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
