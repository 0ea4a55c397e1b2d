#!/usr/bin/env python3
"""Smoke run of mbt_gym_torch on one NVIDIA GPU (H100): builds the CUDA
kernels from mbt_gym_torch/ops/csrc/ (the AS episode kernels K1/K2, the MLP
rollout K3, the fused PPO updates K4 and K7, the deterministic-policy
rollout K5, the OE episode K6 and the CJ episode K8), holds each against
its plain PyTorch version on the card, drives the main paths through the
public entry points and times it all:

- the Avellaneda-Stoikov path, ``rollout`` and ``mc_episode_stats`` with
  ``backend="auto"`` (K2 writing the rollout's Trajectory, once; K1), then
  ``backend="engine"`` (phases 1-6);
- PPO training on the normalised AS env at bench_suite config 5 (262,144
  envs x 200 steps, 256x256 shared trunk, 16 minibatches, bf16), through
  ``init_train_state`` / ``train_iteration`` / ``train_chunk`` on the fused
  path (K3 once and K4 16 times per iteration), then the engine path at the
  dryrun shape (phases 7-12);
- the closed-form Cartea-Jaimungal paths: the CJP market maker at 16,384
  envs x 1,000 steps (K5 table kind, and the value-function lane
  ``cj_episode_rewards`` on K8), the optimal-execution schedule at 8,192 x
  200 (K5 schedule kind for ``rollout``, K6 for ``mc_episode_stats``) and
  fixed actions on the AS and OE configs (K5 fixed kind), each with
  ``backend="auto"`` and then ``"engine"``, with the CJP value-function
  t-test (phases 13-17);
- the fused PPO update on the engine rollout and the separate pi/vf towers
  at config 5, through ``init_train_state`` / ``train_iteration``: (a) the
  shared trunk with ``fused_update`` (K7 16 times per iteration), (b) the
  towers with ``fused_update`` (K4's stacked-trunk mode 16 times), (c) the
  towers fully fused (K3's towers mode once, K4's 16 times), and
  ``evaluate_policy(backend="fused")`` on the towers (phases 18-21);
- PPO learning on the CJ market-making env (phase 22): K3's CjMm and
  running-penalty rewards at exponents 2 and 3 and K5 at exponent 3
  against their plain versions (22a); 250 fully fused iterations (K3 with
  the CjMm reward once and K4 16 times each) of the JAX slow gate's
  setting, which must reach 0.6 x the closed-form CJ agent's reward, beside
  the engine path's first 25 iterations, whose first three
  ``jit_train_iteration`` repeats bit for bit, then
  ``evaluate_policy(backend="auto")`` on K3 (22b);
  one fused iteration at config 5's widths on the CJ env, both layouts,
  K3's CjMm time beside its PnL time (22c); REINFORCE on the card (22d);
  and ``with_normalised_rewards`` on K5's fixed kind against the engine
  (22e);
- the limit-and-market-order and at-the-touch families and the
  reference's canonical learning env (phase 23): K3's lam, touch and
  canonical kinds (4 actions, the per-env initial inventory) at full
  width, K4 at A = 4 and K5's fixed kind on lam and touch against their
  plain versions (23a); 200 fully fused iterations on the canonical env
  (K3 once and K4 4 times each), which must reach a best mean episode
  reward above 40, beside the closed-form no-market-order CJ baseline
  (23b); one fused iteration on bench_suite configs 7, 8 and 9 at full
  width, both layouts, the engine's on config 8, each new K3 kind's time
  beside K3 PnL's (23c); fixed actions on lam and touch through
  ``mc_episode_stats``/``rollout`` on K5 against the engine (23d); the new
  instantiations' registers, spills and tensor-core instructions (23e);
- the process zoo and the composite stress family (phase 24);
- the training and interop surfaces (phase 25): checkpoint and resume at
  config 5, bitwise (K3 x1 and K4 x16 per iteration) (25a); one config-5
  iteration through the data-parallel mesh at world size 1 over NCCL
  against the meshless one, and ``entry.dryrun_multichip(1)`` (25b); the
  SB3-style ``VecTradingEnv`` and ``host_model_policy`` on the AS config
  at 16,384 envs against the engine (25c); the backtest statistics on
  K2's trajectory against float64 on the CPU (25d); a profiler trace
  naming K3's and K4's kernels, engine throughput, ``scaling_report``
  and the TensorBoard logger (25e);
- PPO on optimal execution (phase 26): K3's speed kind at bench_suite
  config 6, its impact kinds, the exponential utility, the t0 plane of a
  random start and the terminal observation, K5's exponential utility and
  schedule kind on lam and touch, and K4 at S = 5, A = 1 against their
  plain versions (26a); the JAX OE learning gate, 200 fully fused
  iterations that must capture 90% of the closed-form schedule's saving
  (26b); config 6 at full width, both layouts, beside the engine (26c);
  random-start ``evaluate_policy``, the exponential utility through
  ``rollout(auto)`` and K5's lam schedule against the engine (26d); the
  new instantiations' registers, spills and tensor-core instructions
  (26e);
- the compiled entry points, CUDA-graph captures (phase 27):
  ``jit_rollout(backend="engine")`` bit for bit ``rollout(backend=
  "engine")`` on the AS, CJ, OE, config-14 and deterministic-policy
  episodes (27a); two ``jit_train_iteration``s at config 5 bit for bit the
  eager iterations on the engine, ``fused_update`` (K7; K4 on the towers)
  and the fully fused learner (K3 x1 + K4 x16 per replay, two traced
  replays naming K3's and K4's kernels) (27b); ``jit_train_chunk(4)`` bit
  for bit four ``jit_train_iteration``s and ``jit_train_epoch`` bit for bit
  eager REINFORCE (27c); eager against captured ms, env-steps/s and idle
  share, capture seconds and graph pool bytes (27d); the captured
  iteration over an NCCL group of world size 1 bit for bit the eager one
  (27e); a capture holding a host read raises, leaves the caller's stream
  current and the allocator releasing what is freed after it (27f).
- K4 and K7 at every trunk shape K3 takes (phase 28): 1-8 layers, widths
  a multiple of 4 up to 256 (padded to 64 with exact zeros), against their
  plain versions on both layouts at S = 4, 8, 9 and 16 (28a; bf16 beyond
  two layers against the plain version's float64-summed evaluation at
  fixed limits, ``DEEP_BF16_LIMITS``); the fully fused iteration at
  config 5's shape on a three-layer and a one-layer trunk through
  ``train_iteration`` and ``jit_train_iteration``, bitwise, timed, and the
  kernels against their plain versions on its minibatch, which they run
  in chunks (28b); a float32 fused iteration against autograd at (32, 32)
  and (64,) (28c);
- the all-axes composite config (S = 9) at config 10's shape (phase 29):
  K4 and K7 at S = 9 against their plain versions on its first minibatch,
  K7 also against the distance K4's rounding points put between the plain
  versions (29a); fully fused training on both layouts, K3 x1 + K4 x16 per
  iteration, no RuntimeWarning, the metric bands, ``jit_train_iteration``
  bit for bit, the iteration's time and idle share beside config 10's
  (29b); ``fused_update`` on the engine rollout, K7 x16 (29c); K4 and K7 at
  S = 8, 9 and 16 timed against their bounds and plain versions (29d).

Phase 18 also checks in the SASS that the bf16 instantiations of the
update passes and of K3 run tensor-core instructions and the float32 ones
none, and that the update passes and K1, K2, K5, K6 and K8, the
step-pipeline kernels, spill nothing in any instantiation (the wide
shape's included); phases 2, 3, 8, 9, 14 and 19 launch K1-K8 twice on the same inputs and require
bitwise-equal results, and phases 2, 3 and 14 hold K1, K2, K6 and K8 to
their plain versions at their wide shape too.  Phase 3 holds K2's
trajectory layout bit for bit to the layout of its own full streams, and
phase 4 the rollout's Trajectory to that layout for the same seed.  Kernel
times are the card's own (``device_ms``: a sleep ahead of the start event
keeps the wrapper's host work out of the window), with the caller's time
(``call_ms``) beside them; the kernels are ranked by launches x (device
time - bound).

Run from the repository root:

    python3 chip_smoke.py

It exits non-zero, printing no result, without a CUDA device or without the
package beside it, and on any failed phase.  Its last three lines are the
``kernels`` JSON object, the card's name and power limit from nvidia-smi,
and ``{"ok": true, "device": {...}}``.
"""
import copy
import json
import statistics
import subprocess
import sys
import time
import warnings
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
# K2 emit="full" adds the mark-to-market value and reward (3); its
# trajectory layout the next row's time as well (3).  Integer ops are held
# to the float32 peak too: the bound stays a lower bound.
OPS_PER_ENV_STEP_K1 = 196 + 18 + 7 + 9 + 14 + 10 + 3
OPS_PER_ENV_STEP_K2_FULL = OPS_PER_ENV_STEP_K1 + 3
OPS_PER_ENV_STEP_K2_TRAJECTORY = OPS_PER_ENV_STEP_K2_FULL + 3

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


def event_times(torch, fn, warmup=2, reps=5):
    """Milliseconds of each of ``reps`` calls of ``fn`` between CUDA
    events, after warm-up.  The start event is recorded on an idle stream,
    so the window holds the call's host work too (its allocations, argument
    packing, the launch): the time a caller waits for one call."""
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
    return times


def cuda_ms(torch, fn, warmup=2, reps=5):
    """Median of :func:`event_times`: a call's time, host work included."""
    return statistics.median(event_times(torch, fn, warmup, reps))


def sleep_ms_per_mcycle(torch):
    """Milliseconds one ``torch.cuda._sleep`` of a million cycles keeps the
    card busy (one warm sleep, then one timed)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1_000_000)
    start.record()
    torch.cuda._sleep(1_000_000)
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def device_times(torch, fn, warmup=2, reps=5):
    """Milliseconds of the device work that each of ``reps`` calls of ``fn``
    enqueues, without its host work.  Before each timed call the stream is
    filled with a ``torch.cuda._sleep`` that outlasts the call's host side,
    so the start event fires on the card only after ``fn`` has enqueued
    everything: the events bracket the kernel and any device op the wrapper
    enqueues itself (the streams mode's zero planes), and nothing of the
    host.  Where the start event had already fired when ``fn`` returned,
    the sleep was too short: that repetition is dropped and the sleep
    doubled."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    lead_ms = max(1.0, 4.0 * host_ms)
    ms_per_mcycle = sleep_ms_per_mcycle(torch)
    times = []
    while len(times) < reps:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(lead_ms / ms_per_mcycle * 1e6) + 1)
        start.record()
        fn()
        covered = not start.query()
        end.record()
        end.synchronize()
        if covered:
            times.append(start.elapsed_time(end))
        else:
            lead_ms *= 2.0
            check(lead_ms < 1e3, "device_times: the host side of a call outlasts a one-second sleep")
    return times


def device_ms(torch, fn, warmup=2, reps=5):
    """Median of :func:`device_times`: the card's time for one call."""
    return statistics.median(device_times(torch, fn, warmup, reps))


def kernel_ms(torch, fn, warmup=2, reps=5, label=None):
    """(device_ms, call_ms) of one kernel wrapper: its device time alone and
    the time a caller waits for it, host work included.  With ``label``
    it prints whether the two agree within their spread (the larger range
    of either's repetitions, at least 1% of the device time), as they
    should where the kernel is long enough that the host's share of a call
    is lost in its noise; where they do not, the wrapper's host work
    (launches of small device ops, each faster than the host enqueues it)
    leaves the card idle for the difference."""
    dev = device_times(torch, fn, warmup, reps)
    call = event_times(torch, fn, warmup, reps)
    dev_ms, call_ms = statistics.median(dev), statistics.median(call)
    if label is not None:
        spread = max(max(dev) - min(dev), max(call) - min(call), 0.01 * dev_ms)
        verdict = "agree" if abs(call_ms - dev_ms) <= spread else "differ"
        print(f"{label}: device {dev_ms} ms, call {call_ms} ms: {verdict} within their spread {spread} ms")
    return dev_ms, call_ms


def rank_by_gap(entries):
    """Kernel entries of the kernels line, ordered by launches x (ms -
    bound_ms), largest first: the device time the main paths lose in each
    kernel above its bound."""
    return sorted(entries, key=lambda e: e["launches"] * (e["ms"] - e["bound_ms"]), reverse=True)


def pipeline_entry(geometry):
    """The kernels line's view of a step-pipeline geometry
    (mbt_gym_torch/ops/step_pipeline.py): which shape ("pipeline", or
    "wide": one thread per env, no ring) and its sizes."""
    return {"shape": geometry.shape,
            **{k: geometry._asdict()[k] for k in ("envs", "producers", "chunk", "slots", "smem_bytes")}}


def kernel_row(phase, card, name, shape, env_steps, ms, call, b_ms, b_by, plain_ms=None):
    """One phase's line for a kernel timing: device time, call time, rate,
    bound and share of bound (of the device time)."""
    plain = f", plain {plain_ms} ms" if plain_ms is not None else ""
    return (f"phase {phase} [{card}] {name} at {shape}: {ms} ms on the device (call {call} ms) = "
            f"{env_steps / ms * 1e3} env-steps/s, bound {b_ms} ms ({b_by}), {b_ms / ms:.1%} of bound{plain}")


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


def check_k2(torch, ep, p, n, kw, terminal, label):
    """Phase 3 for one config and draw mode: K2's full and container
    layouts against the plain version, each launched twice to the same
    bits, their last row K1's terminal state ``terminal``; the trajectory
    layout launched twice to the same bits and bitwise the layout
    (``as_trajectory_from_full``) of the kernel's own full streams, time
    column and initial row included.  Returns the max abs error."""
    err = 0.0
    for emit in ("full", "container"):
        k2 = ep.as_episode_trajectories(p, num_trajectories=n, emit=emit, **kw)
        again = ep.as_episode_trajectories(p, num_trajectories=n, emit=emit, **kw)
        plain = ep.as_episode_trajectories_plain(p, num_trajectories=n, emit=emit, **kw)
        torch.cuda.synchronize()
        err = max(err, compare_streams(torch, k2, plain, n, f"phase 3 K2 {emit} {label}"))
        check_repeat(torch, (dict(enumerate(k2)),), (dict(enumerate(again)),), f"phase 3 K2 {emit} {label}")
        last = (k2[0][-1], k2[1][-1], k2[3 if emit == "container" else 2][-1])
        check(all(torch.equal(a, b) for a, b in zip(last, terminal)),
              f"phase 3 K2 {emit} {label}: last row differs from K1's terminal state")
        del again, plain
        if emit == "full":
            traj = ep.as_episode_trajectory(p, num_trajectories=n, **kw)
            again = ep.as_episode_trajectory(p, num_trajectories=n, **kw)
            want = ep.as_trajectory_from_full(p, k2)
            torch.cuda.synchronize()
            differ = [name for name, a, b in zip(traj._fields, traj, want) if not torch.equal(a, b)]
            check(not differ, f"phase 3 K2 trajectory {label}: {differ} differ from the layout of the full streams")
            check_repeat(torch, (traj._asdict(),), (again._asdict(),), f"phase 3 K2 trajectory {label}")
            del traj, again, want
        del k2
    return err


# ------------------------------------------------------------------ PPO
PPO_N = 262_144  # bench_suite config 5
PPO_MINIBATCHES = 16
PPO_ITERATIONS = 9
DRYRUN_N, DRYRUN_T = 2048, 64


def assert_metric_bands(metrics, label):
    """The PPO sanity bands on the normalised AS env,
    :func:`mbt_gym_torch.entry.assert_metric_bands` (those of
    __graft_entry__.py:42-54); a metric outside them fails the phase."""
    from mbt_gym_torch.entry import assert_metric_bands as bands

    try:
        return bands(metrics, label)
    except AssertionError as e:
        check(False, f"{label}: metrics outside the bands: {e}")
        return {k: float(v) for k, v in metrics.items()}


def mlp_flops_per_sample(s_dim, h0, h1, a_dim, towers=1):
    """Matmul FLOPs of one forward of the actor-critic: the shared trunk
    (towers=1) or separate pi/vf towers of these widths (towers=2), whose
    heads read only their own tower."""
    return mlp_flops_at(s_dim, (h0, h1), a_dim, towers)


def ppo_grad_flops_per_sample(s_dim, h0, h1, a_dim, towers=1):
    """Forward plus backward (dh2, dW_head, dW1, dh1, dW0) matmul FLOPs."""
    return ppo_grad_flops_at(s_dim, (h0, h1), a_dim, towers)


def mlp_flops_at(s_dim, widths, a_dim, towers=1):
    """The forward's FLOPs at any depth: 2 (T S h_0 + T sum_{l>=1}
    h_{l-1} h_l + (A+1) h_last), the heads reading only their own tower."""
    inner = sum(a * b for a, b in zip(widths, widths[1:]))
    return 2 * (towers * s_dim * widths[0] + towers * inner + (a_dim + 1) * widths[-1])


def ppo_grad_flops_at(s_dim, widths, a_dim, towers=1):
    """Forward plus backward FLOPs at any depth: the forward, and the
    backward's 2 (2 (A+1) h_last + 2 T sum_{l>=1} h_{l-1} h_l + T S h_0)
    (dh and dW of the head, of each hidden-to-hidden layer, dW0)."""
    inner = sum(a * b for a, b in zip(widths, widths[1:]))
    backward = 2 * (2 * (a_dim + 1) * widths[-1] + 2 * towers * inner + towers * s_dim * widths[0])
    return mlp_flops_at(s_dim, widths, a_dim, towers) + backward


def bound_ms(bytes_moved, ops, peak):
    """(least time in ms, "bytes" or "operations") at HBM_BYTES_PER_S and
    ``peak`` operations/s."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def as_bound(layout, n, steps=STEPS):
    """bound_ms of one native AS episode call of ``n`` envs x ``steps``
    (native mode reads nothing): K1's terminal state (``"terminal"``:
    cash, inventory, price), K2's full streams (``"full"``: six (T, N)
    planes) or its trajectory layout (``"trajectory"``: observations
    (T+1, N, 4), actions (T, N, 2), rewards (T, N)), float32."""
    floats, ops = {
        "terminal": (3, OPS_PER_ENV_STEP_K1 * steps),
        "full": (6 * steps, OPS_PER_ENV_STEP_K2_FULL * steps),
        "trajectory": (4 * (steps + 1) + 3 * steps, OPS_PER_ENV_STEP_K2_TRAJECTORY * steps),
    }[layout]
    return bound_ms(4 * floats * n, ops * n, FP32_OPS_PER_S)


def busy_ms(intervals):
    """Length in ms of the union of ``(start_us, end_us)`` intervals: time
    in which at least one of them runs, none counted twice."""
    busy_us, end_us = 0.0, float("-inf")
    for start, end in sorted(intervals):
        busy_us += max(0.0, end - max(start, end_us))
        end_us = max(end_us, end)
    return busy_us / 1e3


def profile_iteration(torch, card, label, fn, top=6, phase=12, expect=(), warm=False):
    """One call of ``fn`` under torch.profiler: device time by kernel
    (summed over launches) and the device's busy share of the call's wall
    time.  Busy time is the union of the intervals of the device-side
    events (kernels, copies, sets), so it counts no time twice and is at
    most the span from the first to the last of them.  ``expect`` names
    kernels the call must launch: each is reported with the launch
    counters' view of the call, found or missing among the profiler's
    device events.  With ``warm`` the profiler first traces one call that
    it discards (a warm-up step of its schedule), then the call it keeps.
    Returns the device events' ``{name: (ms, count)}`` (``by_name``), the
    busy time and the wall time, or ``{}`` where it saw no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from mbt_gym_torch.ops import _build

    torch.cuda.synchronize()
    plan = schedule(wait=0, warmup=1, active=1) if warm else None
    kept = []  # a schedule clears the events at the end of its cycle
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], schedule=plan,
                 on_trace_ready=(lambda p: kept.extend(p.events())) if warm else None) as prof:
        for step in range(2 if warm else 1):
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            if warm:
                prof.step()
    launched = {name: c for name, c in _build.launch_counts.items() if c}
    events = kept if warm else prof.events()
    # device work only: not the profiler's own step annotations, which it
    # mirrors onto the device's timeline
    device = [e for e in events if e.device_type == DeviceType.CUDA and not e.is_user_annotation
              and not e.name.startswith("ProfilerStep")]
    tag = " (after a discarded warm-up call)" if warm else ""
    if not device:
        print(f"phase {phase} profile{tag} [{card}] {label}: the profiler saw no device time (wall {wall_ms} ms)")
        return {}
    by_name = {}
    for e in device:
        ms, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3, count + 1)
    busy = busy_ms([(e.time_range.start, e.time_range.end) for e in device])
    span_ms = (max(e.time_range.end for e in device) - min(e.time_range.start for e in device)) / 1e3
    print(f"phase {phase} profile{tag} [{card}] {label}: wall {wall_ms} ms under the profiler, device events span "
          f"{span_ms} ms, device busy {busy} ms ({busy / wall_ms:.1%}), idle share {1 - busy / wall_ms:.1%}; "
          f"launch counters {launched}")
    for ms, count, name in sorted(((ms, count, name) for name, (ms, count) in by_name.items()), reverse=True)[:top]:
        print(f"    {ms:10.3f} ms  {count:6d} x  {name[:90]}")
    for kernel in expect:
        found = [(ms, count) for name, (ms, count) in by_name.items() if kernel in name]
        print(f"phase {phase} profile{tag} {label}: {kernel} "
              + (f"found, {sum(c for _, c in found)} x, {sum(m for m, _ in found)} ms" if found else
                 f"missing among {len(device)} device events ({len(by_name)} names)"))
    return {"by_name": by_name, "busy_ms": busy, "wall_ms": wall_ms}


def compare_rollouts(torch, got, want, n, label, continuous=False):
    """K3's five outputs against its plain version: at most 0.1% of envs may
    differ in their inventory stream (a fill or market order decided on the
    other side of its threshold by a summation-order difference changes
    that env's later path); the rest agree to rtol=1e-4/atol=1e-3.  The
    streams hold each step's pre-step inventory, so a decision that flips
    at the last step shows only in the last reward: an env whose last
    reward disagrees counts as flipped too, and its last actions are
    printed.  With ``continuous`` (the at-the-touch fills are the post
    columns themselves, so every inventory carries the action's rounding)
    an env's stream counts as the same where it agrees to that tolerance.
    Returns the max abs error over the compared values."""
    if continuous:
        inv_a, inv_b = got[0][:, 1], want[0][:, 1]
        same = ((inv_a - inv_b).abs() <= 1e-3 + 1e-4 * inv_b.abs()).all(dim=0)
    else:
        same = (got[0][:, 1] == want[0][:, 1]).all(dim=0)
    last = (got[4][-1] - want[4][-1]).abs() <= 1e-3 + 1e-4 * want[4][-1].abs()
    for env in (same & ~last).nonzero().flatten()[:4].tolist():
        print(f"{label}: env {env} flips at the last step: actions {got[1][-1, :, env].tolist()} vs "
              f"{want[1][-1, :, env].tolist()}, reward {float(got[4][-1, env])} vs {float(want[4][-1, env])}")
    same = same & last
    flips = int((~same).sum())
    check(flips <= n // 1000, f"{label}: inventory stream differs on {flips} of {n} envs")
    err = 0.0
    for name, a, b in zip(("obs", "actions", "log_probs", "values", "rewards"), got, want):
        torch.testing.assert_close(a[..., same], b[..., same], rtol=1e-4, atol=1e-3, msg=lambda m: f"{label} {name}: {m}")
        err = max(err, float((a[..., same] - b[..., same]).abs().max()))
    print(f"{label}: inventory flips {flips}/{n}, max abs err {err:.3g}")
    return err


def compare_grads(torch, grads, metrics, want_g, want_m, dtype, label):
    """An update kernel's grads and metrics against its plain version.
    float32: every grad to rtol=1e-4, atol 1e-4 of the leaf's largest value;
    bf16: relative Frobenius error per leaf at most 1e-3 (the same roundings
    in both, so only summation order differs); metrics to rtol=1e-4.
    Returns the max abs error of the bf16 grads (0 for float32)."""
    check(set(grads) == set(want_g), f"{label}: grads {sorted(grads)} vs {sorted(want_g)}")
    worst, worst_leaf, err = 0.0, None, 0.0
    for name, want in want_g.items():
        got = grads[name]
        rel = float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want).clamp_min(1e-30))
        if rel >= worst:
            worst, worst_leaf = rel, name
        if dtype == "float32":
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()),
                                       msg=lambda m: f"{label} {name}: {m}")
        else:
            check(rel <= 1e-3, f"{label} {name}: relative Frobenius error {rel}")
            err = max(err, float((got - want).abs().max()))
    for name, want in want_m.items():
        torch.testing.assert_close(metrics[name], want, rtol=1e-4, atol=1e-7, msg=lambda m: f"{label} {name}: {m}")
    print(f"{label}: worst relative Frobenius error {worst:.3g} ({worst_leaf}), "
          f"metrics {[round(float(v), 6) for v in metrics.values()]}")
    return err


def check_repeat(torch, first, second, label):
    """Two launches of a kernel on the same inputs give bitwise equal
    results (fixed tiles, fixed-order reductions): each of ``first`` and
    ``second`` is a sequence of ``{name: tensor}`` dicts (an update's grads
    and metrics, a rollout's outputs)."""
    for got, again in zip(first, second):
        differ = [name for name in got if not torch.equal(got[name], again[name])]
        check(not differ, f"{label}: a repeated launch differs in {differ}")
    print(f"{label}: a repeated launch is bitwise equal")


ROLLOUT_OUTPUTS = ("obs", "actions", "log_probs", "values", "rewards")


def rollout_outputs(outputs):
    """K3's five outputs as the one dict ``check_repeat`` compares."""
    return (dict(zip(ROLLOUT_OUTPUTS, outputs)),)


def engine_rollout_ms(torch, env_cfg, params, label, card):
    """K3's yardstick: milliseconds of the port's engine collection episode
    (``collect_rollout``, no kernel, bf16 operands) of the same params and
    seed as the kernel's timing."""
    from mbt_gym_torch.agents.ppo import collect_rollout

    ms = cuda_ms(torch, lambda: collect_rollout(env_cfg, params, 9, compute_dtype="bfloat16"), warmup=1, reps=2)
    print(f"{label} [{card}]: engine collect_rollout of the same params and seed {ms} ms")
    return ms


def engine_grad_ms(torch, model, rows, label, card):
    """The update kernels' yardstick: milliseconds of the port's autograd
    gradient of the same row-major minibatch in bf16, as ``_engine_update``
    computes it (``_ppo_loss`` then ``backward()``, agents/ppo.py:321-324)."""
    from mbt_gym_torch.agents.ppo import PPOConfig, UpdateBatch, _ppo_loss

    cfg = PPOConfig(hidden=(256, 256), compute_dtype="bfloat16")
    batch = UpdateBatch(*rows)

    def grad():
        model.zero_grad(set_to_none=True)
        _ppo_loss(model, cfg, batch)[0].backward()

    ms = cuda_ms(torch, grad, warmup=1, reps=3)
    model.zero_grad(set_to_none=True)
    print(f"{label} [{card}]: engine (autograd) gradient of the same minibatch {ms} ms")
    return ms


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
        again = mr.mlp_rollout(p, model, num_trajectories=PPO_N, **kw)
        want = mr.mlp_rollout_plain(p, model, num_trajectories=PPO_N, **kw)
        torch.cuda.synchronize()
        k3_err = max(k3_err, compare_rollouts(torch, got, want, PPO_N, f"phase 8 K3 {mode} at {PPO_N}x{steps}"))
        check_repeat(torch, rollout_outputs(got), rollout_outputs(again), f"phase 8 K3 {mode}")
        del again
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
        again = fused_ppo.ppo_fused_grads_T(moved, *mb, compute_dtype=dtype)
        want_g, want_m = fused_ppo.ppo_fused_grads_T_plain(moved, *mb, compute_dtype=dtype)
        torch.cuda.synchronize()
        k4_err = max(k4_err, compare_grads(torch, grads, metrics, want_g, want_m, dtype,
                                           f"phase 9 K4 {dtype} at {steps}x{nb}"))
        check_repeat(torch, (grads, metrics), again, f"phase 9 K4 {dtype}")
    del got, obs_t, actions_t, log_probs, values, rewards, adv, returns, mb, again

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
    k3_ms, k3_call_ms = kernel_ms(torch, lambda: mr.mlp_rollout(p, params, 9, PPO_N, device=dev), warmup=1, reps=5,
                                  label=f"phase 12 K3 at {PPO_N}x{steps}")
    k3_plain_ms = cuda_ms(torch, lambda: mr.mlp_rollout_plain(p, params, 9, PPO_N, device=dev), warmup=1, reps=2)
    k3_engine_ms = engine_rollout_ms(torch, env_cfg, params, f"phase 12 K3 at {PPO_N}x{steps}", card)
    tb = mr.collect_rollout_fused_T(env_cfg, params, 9, device=dev)
    mb = [x[..., :nb] for x in (tb.obs_t, tb.actions_t, tb.log_probs, tb.advantages, tb.returns)]
    mb[3] = normalise(mb[3])
    k4_ms, k4_call_ms = kernel_ms(torch, lambda: fused_ppo.ppo_fused_grads_T(params, *mb), warmup=2, reps=10,
                                  label=f"phase 12 K4 at {steps}x{nb}")
    k4_plain_ms = cuda_ms(torch, lambda: fused_ppo.ppo_fused_grads_T_plain(params, *mb), warmup=1, reps=3)
    rows = [x.permute(0, 2, 1).reshape(steps * nb, -1) if x.dim() == 3 else x.reshape(-1) for x in mb]
    k4_engine_ms = engine_grad_ms(torch, params, rows, f"phase 12 K4 at {steps}x{nb}", card)
    del rows

    s_dim, a_dim, (h0, h1) = 4, 2, ppo_cfg.hidden
    # K3 native mode reads nothing per step and writes obs, actions,
    # log-prob, value and reward: (S + A + 3) floats per env-step
    k3_bound = bound_ms((s_dim + a_dim + 3) * 4 * env_steps, mlp_flops_per_sample(s_dim, h0, h1, a_dim) * env_steps,
                        BF16_OPS_PER_S)
    # K4 reads obs, actions, old log-prob, advantage and return once per
    # sample; its outputs are the grads (~0.3 MB)
    samples = steps * nb
    k4_bound = bound_ms((s_dim + a_dim + 3) * 4 * samples, ppo_grad_flops_per_sample(s_dim, h0, h1, a_dim) * samples,
                        BF16_OPS_PER_S)
    for name, ms, call, plain_ms, (b_ms, b_by), shape, engine in (
        ("K3 mlp_rollout native", k3_ms, k3_call_ms, k3_plain_ms, k3_bound, f"{PPO_N}x{steps}",
         f", engine {k3_engine_ms} ms"),
        ("K4 ppo_fused_grads_T bf16 (one minibatch)", k4_ms, k4_call_ms, k4_plain_ms, k4_bound, f"{steps}x{nb}",
         f", engine {k4_engine_ms} ms"),
    ):
        print(f"phase 12 [{card}] {name} at {shape}: {ms} ms on the device (call {call} ms), plain {plain_ms} ms"
              f"{engine}, bound {b_ms} ms ({b_by}), {b_ms / ms:.1%} of bound")
    return [
        {
            "name": "K3 mlp_rollout", "route": "cuda", "source": "mbt_gym_torch/ops/csrc/mlp_rollout.cu",
            "replaces": "mbt_gym_tpu/ops/pallas_rollout.py:1514", "launches": launches["mlp_rollout"],
            "max_abs_err": k3_err, "ms": k3_ms, "call_ms": k3_call_ms, "plain_ms": k3_plain_ms,
            "engine_ms": k3_engine_ms,
            "bound_ms": k3_bound[0], "bound_by": k3_bound[1], "library_ms": None,
        },
        {
            "name": "K4 ppo_fused_grads_T", "route": "cuda", "source": "mbt_gym_torch/ops/csrc/fused_ppo.cu",
            "replaces": "mbt_gym_tpu/ops/fused_ppo.py:392", "launches": launches["ppo_fused_grads_T"],
            "max_abs_err": k4_err, "ms": k4_ms, "call_ms": k4_call_ms, "plain_ms": k4_plain_ms,
            "engine_ms": k4_engine_ms,
            "bound_ms": k4_bound[0], "bound_by": k4_bound[1], "library_ms": None,
        },
    ]


# ------------------------------------------------------------------ CJ
CJ_N = 16_384  # cj_env_config at its published widths, 1,000 steps (bench.py:209-210)
CJ_STATS_N = 131_072  # the stats lane's size (bench.py:216-237)
OE_N = 8_192  # oe_env_config's default, 200 steps
OE_LARGE_N = 1_048_576
T_BAND = 3.29  # |t| < 3.29: the 99.9% band of tests/test_replication.py:52-80

# Operations per env-step, counted as OPS_PER_ENV_STEP_K1 is.
# K5, table kind on limit dynamics, stats mode: two Philox calls (196), six
# 24-bit uniforms (18), Box-Muller (7), step time (3), inventory index and
# two table loads (6), arrivals/fills/masks (14), bookkeeping with the
# inventory and cash clips (12), price move (3), PnL and the pathwise CJ
# reward (14), the reward and spread sums (3).
OPS_PER_ENV_STEP_K5_TABLE = 196 + 18 + 7 + 3 + 6 + 14 + 12 + 3 + 14 + 3
# K6: one Philox call (98), two uniforms (6), Box-Muller (7), the schedule
# load (1), execution, inventory, impact and the two sums with the clips
# (19), price move (3).
OPS_PER_ENV_STEP_K6 = 98 + 6 + 7 + 1 + 19 + 3
# K5, schedule kind on speed dynamics: one Philox call (98), two uniforms
# (6), Box-Muller (7), step time (3), the schedule load (1), impact,
# volume and bookkeeping (10), the clips (4), price move (3), PnL and the
# CJ execution reward (14).
OPS_PER_ENV_STEP_K5_SPEED = 98 + 6 + 7 + 3 + 1 + 10 + 4 + 3 + 14
# K8: K5's table step without the clips (bookkeeping 8), with the sum of
# q^2 (2) in place of the reward (14) and the sums (3), and no step time.
OPS_PER_ENV_STEP_K8 = 196 + 18 + 7 + 6 + 14 + 8 + 3 + 2


def compare_outputs(torch, got, want, n, label, streams=False):
    """K5/K6/K8 outputs against the plain version at K1's limits: the
    inventory (in streams: at some step) may differ on at most 1e-4 of
    envs, a fill decided at an exp() ULP boundary; every output agrees to
    rtol=1e-6/atol=1e-3 on the other envs.  Returns the max abs error."""
    if streams:
        same = (got[0][:, 1] == want[0][:, 1]).all(dim=0)
    else:
        same = got[1] == want[1]
    flips = int((~same).sum())
    check(flips <= n // 10_000, f"{label}: inventory differs on {flips} of {n} envs")
    err = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        torch.testing.assert_close(a[..., same], b[..., same], rtol=1e-6, atol=1e-3,
                                   msg=lambda m: f"{label} output {i}: {m}")
        err = max(err, float((a[..., same] - b[..., same]).abs().max()))
    print(f"{label}: inventory flips {flips}/{n}, max abs err {err:.3g}")
    return err


def t_stat(mean, std, n, truth):
    return (float(mean) - truth) / (float(std) / n**0.5)


def check_agree(a, b, key, n_a, n_b, label, std_key=None):
    """Two runs' means of ``key`` within 4 standard errors (at least
    1e-4 relative, for the deterministic OE inventories)."""
    std_key = std_key or {"mean_pnl": "std_pnl", "mean_terminal_inventory": "std_terminal_inventory"}[key]
    se = (float(a[std_key]) ** 2 / n_a + float(b[std_key]) ** 2 / n_b) ** 0.5
    diff = abs(float(a[key]) - float(b[key]))
    check(diff <= max(4 * se, 1e-4 * abs(float(b[key]))), f"{label}: {key} {float(a[key])} vs {float(b[key])}, se {se}")
    print(f"{label}: {key} {float(a[key]):.4f} vs {float(b[key]):.4f} ({diff / se if se else 0.0:.2f} se)")


def rollout_summary(torch, res):
    """mean/std of the episode rewards and terminal inventories of a rollout."""
    total = res.trajectory.rewards.sum(0)
    inv = res.trajectory.observations[-1, :, 1]
    return {"mean_pnl": total.mean(), "std_pnl": total.std(correction=0),
            "mean_terminal_inventory": inv.mean(), "std_terminal_inventory": inv.std(correction=0)}


def cj_phases(torch, np, card, dev, as_kernel_ms=None):
    """Phases 14-17: K5, K6 and K8 against their plain versions, the
    closed-form CJ paths through the public entry points (auto, then
    engine), timings, and the profiles of the fused entry points, the AS
    ones too (``as_kernel_ms``: the device ms of the AS kernels by name,
    phase 6's, added where the profile loses one).  Returns the
    kernels-line entries of K5, K6 and K8."""
    import dataclasses

    from mbt_gym_torch import (
        AvellanedaStoikovAgent, CarteaJaimungalMmAgent, CarteaJaimungalOeAgent, as_env_config, cj_env_config,
        cj_episode_rewards, dispatch_report, episode_stats, fixed_action_policy, mc_episode_stats, oe_env_config,
        rollout,
    )
    from mbt_gym_torch.ops import _build
    from mbt_gym_torch.ops import cj_episode as cj
    from mbt_gym_torch.ops import det_rollout as det
    from mbt_gym_torch.ops import oe_episode as oe

    cj_cfg = cj_env_config(num_trajectories=CJ_N, max_inventory=100.0)
    cj_agent = CarteaJaimungalMmAgent.from_config(cj_cfg, max_inventory=100)
    oe_cfg = oe_env_config(num_trajectories=OE_N)
    oe_agent = CarteaJaimungalOeAgent.from_config(oe_cfg, phi=2e-4, alpha=0.01)
    as_cfg = as_env_config(num_trajectories=CJ_N)
    fixed_as, fixed_oe = [0.7, 0.9], [-2.5]
    cj_steps, oe_steps, as_steps = cj_cfg.n_steps, oe_cfg.n_steps, as_cfg.n_steps

    def channels(seed, steps, n):
        rng = np.random.default_rng(seed)
        c = rng.uniform(size=(steps, 5, n)).astype(np.float32)
        c[:, 4] = rng.normal(size=(steps, n)).astype(np.float32)
        return torch.from_numpy(c).to(dev)

    # ---- phase 14: each kernel against its plain version, noise and
    # native mode, at the main paths' shapes
    t0 = time.perf_counter()
    p_table = det.cj_rollout_params(cj_cfg, cj_agent)
    tables = tuple(torch.as_tensor(t, device=dev) for t in det.cj_depth_tables(cj_agent))
    p_oe = oe.oe_params_from_config(oe_cfg)
    speed_table = oe.oe_speed_table(oe_cfg, oe_agent).to(dev)
    k5_cases = [
        ("table CJP", p_table, tables, CJ_N),
        ("fixed AS", det.fixed_rollout_params(as_cfg, fixed_as), (), CJ_N),
        ("fixed OE", det.fixed_rollout_params(oe_cfg, fixed_oe), (), OE_N),
        ("schedule OE", det.schedule_rollout_params(oe_cfg), (speed_table[:, None],), OE_N),
    ]
    err = {"K5": 0.0, "K6": 0.0, "K8": 0.0}
    for label, p, tbl, n in k5_cases:
        for mode, kw in (("noise", {"noise": channels(14, p.run_steps, n)}), ("native", {"seed": 41, "device": dev})):
            for stats in (True, False):
                extra = {"stats_only": stats, "final_obs": not stats}
                got = det.det_rollout(p, tbl, num_trajectories=n, **kw, **extra)
                again = det.det_rollout(p, tbl, num_trajectories=n, **kw, **extra)
                want = det.det_rollout_plain(p, tbl, num_trajectories=n, **kw, **extra)
                torch.cuda.synchronize()
                kind = "stats" if stats else "streams"
                at = f"{label} {kind} {mode} at {n}x{p.run_steps}"
                err["K5"] = max(err["K5"], compare_outputs(torch, got, want, n, f"phase 14 K5 {at}", streams=not stats))
                check_repeat(torch, (dict(enumerate(got)),), (dict(enumerate(again)),), f"phase 14 K5 {at}")
            del got, again, want
    # K6 at its main shape (the step pipeline) and its wide shape, both
    # draw modes, a repeated launch bitwise
    gen = torch.Generator(dev).manual_seed(15)
    for n in (OE_N, OE_LARGE_N):
        shape = oe.kernel_geometry(p_oe, n).shape
        check(shape == ("pipeline" if n == OE_N else "wide"), f"phase 14 K6 at {n} envs takes the {shape} shape")
        normals = torch.randn((oe_steps, n), generator=gen, device=dev)
        for mode, kw in (("noise", {"noise": normals}), ("native", {"seed": 42, "device": dev})):
            got = oe.oe_episode(p_oe, speed_table, num_trajectories=n, **kw)
            again = oe.oe_episode(p_oe, speed_table, num_trajectories=n, **kw)
            want = oe.oe_episode_plain(p_oe, speed_table, num_trajectories=n, **kw)
            torch.cuda.synchronize()
            at = f"{mode} at {n}x{oe_steps} ({shape})"
            err["K6"] = max(err["K6"], compare_outputs(torch, got, want, n, f"phase 14 K6 {at}"))
            check_repeat(torch, (dict(enumerate(got)),), (dict(enumerate(again)),), f"phase 14 K6 {at}")
        del normals, got, again, want
    # K8 at its main shape, bitwise K5's table stats mode on the same noise;
    # at its wide shape (1,048,576 envs, the episode cut to 200 steps)
    p_cj = cj.cj_params_from_config(cj_cfg)
    cj_table = torch.tensor(cj_agent.depth_table_f32()[:-1], device=dev)
    check(cj.kernel_geometry(p_cj, 100, CJ_N).shape == "pipeline", "phase 14 K8 at its main shape is not a pipeline")
    for mode, kw in (("noise", {"noise": channels(16, cj_steps, CJ_N)}), ("native", {"seed": 43, "device": dev})):
        got = cj.cj_episode(p_cj, cj_table, q_cap=100, num_trajectories=CJ_N, **kw)
        again = cj.cj_episode(p_cj, cj_table, q_cap=100, num_trajectories=CJ_N, **kw)
        want = cj.cj_episode_plain(p_cj, cj_table, q_cap=100, num_trajectories=CJ_N, **kw)
        torch.cuda.synchronize()
        err["K8"] = max(err["K8"], compare_outputs(torch, got, want, CJ_N, f"phase 14 K8 {mode} at {CJ_N}x{cj_steps}"))
        check_repeat(torch, (dict(enumerate(got)),), (dict(enumerate(again)),), f"phase 14 K8 {mode}")
        k5 = det.table_rollout(p_table, *tables, num_trajectories=CJ_N, stats_only=True, **kw)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got[:3], k5[:3])),
              f"phase 14 K8 {mode}: terminal state differs from K5's table stats mode on the same noise")
    wide_steps = 200
    p_wide, wide_table = p_cj._replace(n_steps=wide_steps), cj_table[:wide_steps]
    check(cj.kernel_geometry(p_wide, 100, OE_LARGE_N).shape == "wide", "phase 14 K8 at its wide shape is not wide")
    wide_noise = torch.rand((wide_steps, 5, OE_LARGE_N), generator=gen, device=dev)
    wide_noise[:, 4] = torch.randn((wide_steps, OE_LARGE_N), generator=gen, device=dev)
    for mode, kw in (("noise", {"noise": wide_noise}), ("native", {"seed": 44, "device": dev})):
        got = cj.cj_episode(p_wide, wide_table, q_cap=100, num_trajectories=OE_LARGE_N, **kw)
        again = cj.cj_episode(p_wide, wide_table, q_cap=100, num_trajectories=OE_LARGE_N, **kw)
        want = cj.cj_episode_plain(p_wide, wide_table, q_cap=100, num_trajectories=OE_LARGE_N, **kw)
        torch.cuda.synchronize()
        at = f"{mode} at {OE_LARGE_N}x{wide_steps} (wide)"
        err["K8"] = max(err["K8"], compare_outputs(torch, got, want, OE_LARGE_N, f"phase 14 K8 {at}"))
        check_repeat(torch, (dict(enumerate(got)),), (dict(enumerate(again)),), f"phase 14 K8 {at}")
    del wide_noise, got, again, want
    print(f"phase 14 ok in {time.perf_counter() - t0:.1f} s: K5, K6 and K8 agree with their plain versions "
          "(K6 and K8 at their wide shape too); K8's terminal state equals K5's table stats mode on the same noise")

    # ---- phase 15: the CJ paths through the public entry points, auto
    t0 = time.perf_counter()
    cj_pol, oe_pol = cj_agent.policy(), oe_agent.policy()
    as_pol = AvellanedaStoikovAgent.from_config(as_cfg, risk_aversion=0.1).policy()
    fx_as, fx_oe = fixed_action_policy(fixed_as), fixed_action_policy(fixed_oe)
    cj_big = dataclasses.replace(cj_cfg, num_trajectories=CJ_STATS_N)
    for cfg, pol, family in ((cj_cfg, cj_pol, "cj_table"), (oe_cfg, oe_pol, "oe_episode"),
                             (as_cfg, fx_as, "fixed"), (oe_cfg, fx_oe, "fixed")):
        for mode in ("rollout", "stats"):
            d = dispatch_report(cfg, pol, mode=mode)
            check((d.backend, d.family) == ("fused", family), f"phase 15 dispatch ({family}, {mode}): {d}")
    _build.reset_launch_counts()
    cj_mc = mc_episode_stats(cj_cfg, cj_pol, None, 61, episodes=1)
    cj_roll = rollout(cj_cfg, cj_pol, None, 62)
    cj_rewards = cj_episode_rewards(cj_cfg, cj_agent, 63, CJ_N)
    cj_big_mc = mc_episode_stats(cj_big, CarteaJaimungalMmAgent.from_config(cj_big, max_inventory=100).policy(), None, 64)
    oe_mc = mc_episode_stats(oe_cfg, oe_pol, None, 65, episodes=2)
    oe_roll = rollout(oe_cfg, oe_pol, None, 66)
    fx_as_mc = mc_episode_stats(as_cfg, fx_as, None, 67)
    fx_as_roll = rollout(as_cfg, fx_as, None, 68)
    fx_oe_mc = mc_episode_stats(oe_cfg, fx_oe, None, 69)
    fx_oe_roll = rollout(oe_cfg, fx_oe, None, 70)
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
    print(f"phase 15 launches on the CJ paths: {launches}")
    check(launches["det_rollout"] == 8, f"phase 15: K5 launched {launches['det_rollout']} times, not 8")
    check(launches["oe_episode"] == 2, f"phase 15: K6 launched {launches['oe_episode']} times, not 2")
    check(launches["cj_episode"] == 1, f"phase 15: K8 launched {launches['cj_episode']} times, not 1")
    for res, steps, n, s_dim, a_dim, label in (
        (cj_roll, cj_steps, CJ_N, 4, 2, "CJ"), (oe_roll, oe_steps, OE_N, 5, 1, "OE"),
        (fx_as_roll, as_steps, CJ_N, 4, 2, "fixed AS"), (fx_oe_roll, oe_steps, OE_N, 5, 1, "fixed OE"),
    ):
        traj = res.trajectory
        check(tuple(traj.observations.shape) == (steps + 1, n, s_dim), f"phase 15 {label} obs {tuple(traj.observations.shape)}")
        check(tuple(traj.actions.shape) == (steps, n, a_dim) and tuple(traj.rewards.shape) == (steps, n), f"phase 15 {label} shapes")
        check(all(bool(torch.isfinite(x).all()) for x in traj), f"phase 15 {label}: non-finite trajectory values")
        check(traj.observations.device.type == "cuda", f"phase 15 {label}: trajectory not on the card")
    obs0 = torch.tensor([[0.0, 0.0, 0.0, 100.0]], device=dev)
    h0 = float(cj_agent.true_value_function(obs0)[0])
    roll_stats = rollout_summary(torch, cj_roll)
    for label, mean, std, n in (
        ("mc_episode_stats (K5 table stats)", cj_mc["mean_pnl"], cj_mc["std_pnl"], CJ_N),
        ("rollout (K5 table streams)", roll_stats["mean_pnl"], roll_stats["std_pnl"], CJ_N),
        ("cj_episode_rewards (K8)", cj_rewards.mean(), cj_rewards.std(correction=0), CJ_N),
    ):
        t = t_stat(mean, std, n, h0)
        print(f"phase 15 CJP value function, {label} at {n}x{cj_steps}: mean {float(mean):.4f} "
              f"+/- {float(std):.4f} vs h(0,0) {h0:.4f}, t={t:.3f}")
        check(abs(t) < T_BAND, f"phase 15 CJP t-test failed for {label}: t={t}")
    big = float(cj_big_mc["mean_pnl"])
    print(f"phase 15 CJP mc_episode_stats at {CJ_STATS_N}x{cj_steps}: mean {big:.4f} +/- {float(cj_big_mc['std_pnl']):.4f}, "
          f"t={t_stat(big, cj_big_mc['std_pnl'], CJ_STATS_N, h0):.3f}")
    check(abs(big - h0) < 0.3, f"phase 15: CJP mean {big} outside h(0,0) {h0} +/- 0.3 at {CJ_STATS_N} envs")
    check_agree(oe_mc, rollout_summary(torch, oe_roll), "mean_pnl", 2 * OE_N, OE_N, "phase 15 OE K6 stats vs K5 schedule rollout")
    check_agree(oe_mc, rollout_summary(torch, oe_roll), "mean_terminal_inventory", 2 * OE_N, OE_N,
                "phase 15 OE K6 stats vs K5 schedule rollout")
    check(abs(float(fx_as_mc["mean_spread"]) - 1.6) < 1e-6, f"phase 15 fixed AS mean_spread {fx_as_mc['mean_spread']}")
    check(abs(float(episode_stats(as_cfg, fx_as_roll.trajectory)["mean_spread"]) - 1.6) < 1e-5, "phase 15 fixed AS rollout spread")
    check(bool(torch.isnan(fx_oe_mc["mean_spread"])) and bool(torch.isnan(oe_mc["mean_spread"])), "phase 15 OE spread not NaN")
    check_agree(fx_as_mc, rollout_summary(torch, fx_as_roll), "mean_pnl", CJ_N, CJ_N, "phase 15 fixed AS stats vs rollout")
    check_agree(fx_oe_mc, rollout_summary(torch, fx_oe_roll), "mean_pnl", OE_N, OE_N, "phase 15 fixed OE stats vs rollout")
    print(f"phase 15 ok in {time.perf_counter() - t0:.1f} s")

    # ---- phase 16: the same configs through the engine on the card
    t0 = time.perf_counter()
    _build.reset_launch_counts()
    e_cj = mc_episode_stats(cj_cfg, cj_pol, None, 71, backend="engine")
    e_cj_roll = rollout(cj_cfg, cj_pol, None, 72, backend="engine")
    e_oe = mc_episode_stats(oe_cfg, oe_pol, None, 73, episodes=2, backend="engine")
    e_fx_as = mc_episode_stats(as_cfg, fx_as, None, 74, backend="engine")
    e_fx_oe = mc_episode_stats(oe_cfg, fx_oe, None, 75, backend="engine")
    torch.cuda.synchronize()
    check(sum(_build.launch_counts.values()) == 0, "phase 16: the engine launched a kernel")
    check(e_cj_roll.trajectory.observations.device.type == "cuda", "phase 16: engine trajectory not on the card")
    t = t_stat(e_cj["mean_pnl"], e_cj["std_pnl"], CJ_N, h0)
    print(f"phase 16 CJP value function, mc_episode_stats (engine): mean {float(e_cj['mean_pnl']):.4f}, t={t:.3f}")
    for fused, eng, n_f, n_e, label in (
        (cj_mc, e_cj, CJ_N, CJ_N, "CJ stats"), (roll_stats, rollout_summary(torch, e_cj_roll), CJ_N, CJ_N, "CJ rollout"),
        (oe_mc, e_oe, 2 * OE_N, 2 * OE_N, "OE stats"), (fx_as_mc, e_fx_as, CJ_N, CJ_N, "fixed AS stats"),
        (fx_oe_mc, e_fx_oe, OE_N, OE_N, "fixed OE stats"),
    ):
        for key in ("mean_pnl", "mean_terminal_inventory"):
            check_agree(fused, eng, key, n_f, n_e, f"phase 16 {label} fused vs engine")
    print(f"phase 16 ok in {time.perf_counter() - t0:.1f} s: the engine agrees with the fused paths within 4 se")
    del cj_roll, e_cj_roll, oe_roll, fx_as_roll, fx_oe_roll

    # ---- phase 17: timings (CUDA events, medians after warm-up)
    t0 = time.perf_counter()
    for name, fn, steps, reps in (
        ("mc_episode_stats CJ fused K5 table stats", lambda: mc_episode_stats(cj_cfg, cj_pol, None, 7), CJ_N * cj_steps, 5),
        ("rollout CJ fused K5 table streams", lambda: rollout(cj_cfg, cj_pol, None, 7), CJ_N * cj_steps, 3),
        ("cj_episode_rewards CJ fused K8", lambda: cj_episode_rewards(cj_cfg, cj_agent, 7, CJ_N), CJ_N * cj_steps, 5),
        ("mc_episode_stats OE fused K6", lambda: mc_episode_stats(oe_cfg, oe_pol, None, 7), OE_N * oe_steps, 5),
        ("rollout OE fused K5 schedule", lambda: rollout(oe_cfg, oe_pol, None, 7), OE_N * oe_steps, 5),
        ("mc_episode_stats fixed AS fused K5", lambda: mc_episode_stats(as_cfg, fx_as, None, 7), CJ_N * as_steps, 5),
        ("mc_episode_stats CJ engine", lambda: mc_episode_stats(cj_cfg, cj_pol, None, 7, backend="engine"), CJ_N * cj_steps, 1),
        ("rollout CJ engine", lambda: rollout(cj_cfg, cj_pol, None, 7, backend="engine"), CJ_N * cj_steps, 1),
        ("mc_episode_stats OE engine", lambda: mc_episode_stats(oe_cfg, oe_pol, None, 7, backend="engine"), OE_N * oe_steps, 2),
        ("rollout OE engine", lambda: rollout(oe_cfg, oe_pol, None, 7, backend="engine"), OE_N * oe_steps, 2),
    ):
        ms = cuda_ms(torch, fn, warmup=1, reps=reps)
        print(f"phase 17 [{card}] {name}: {ms} ms per call = {steps / ms * 1e3} env-steps/s")
    # the host set-up of the entry points: the CJ depth table is built once
    # per agent (the eigendecomposition) and copied from then on
    for name, fn in (
        ("CarteaJaimungalMmAgent.depth_table (the build, once per agent)", cj_agent.depth_table),
        ("cj_depth_tables (K5's CJ tables from the built table)", lambda: det.cj_depth_tables(cj_agent)),
        ("oe_speed_table (K6's and K5's OE schedule)", lambda: oe.oe_speed_table(oe_cfg, oe_agent)),
    ):
        host = []
        for _ in range(3):
            t1 = time.perf_counter()
            fn()
            host.append((time.perf_counter() - t1) * 1e3)
        print(f"phase 17 host [{card}] {name}: {statistics.median(host)} ms per call (median of 3)")

    def bound(bytes_moved, ops):
        return bound_ms(bytes_moved, ops, FP32_OPS_PER_S)

    table_bytes = sum(t.numel() * 4 for t in tables)
    # native mode reads only the tables; stats writes 5 floats per env,
    # streams (S + A + 3) floats per env-step (obs, actions, the zero
    # log-prob and value planes, rewards) plus the terminal obs
    k5_bound = bound(table_bytes + 5 * 4 * CJ_N, OPS_PER_ENV_STEP_K5_TABLE * CJ_N * cj_steps)
    k6_bound = bound(oe_steps * 4 + 6 * 4 * OE_N, OPS_PER_ENV_STEP_K6 * OE_N * oe_steps)
    k8_bound = bound(cj_table.numel() * 4 + 4 * 4 * CJ_N, OPS_PER_ENV_STEP_K8 * CJ_N * cj_steps)
    k5 = lambda n, **kw: det.table_rollout(p_table, *tables, 9, n, device=dev, **kw)  # noqa: E731
    k5_ms, k5_call_ms = kernel_ms(torch, lambda: k5(CJ_N, stats_only=True), warmup=2, reps=10)
    k5_plain_ms = cuda_ms(torch, lambda: det.table_rollout_plain(p_table, *tables, 9, CJ_N, stats_only=True, device=dev),
                          warmup=1, reps=1)
    k5_streams = kernel_ms(torch, lambda: k5(CJ_N, final_obs=True), warmup=1, reps=5)
    big_p, big_tables = det.cj_rollout_params(cj_big, cj_agent), tables
    k5_big = kernel_ms(torch, lambda: det.table_rollout(big_p, *big_tables, 9, CJ_STATS_N, stats_only=True, device=dev),
                       warmup=1, reps=5)
    p_sched = k5_cases[3][1]
    k5_sched = kernel_ms(torch, lambda: det.schedule_rollout(p_sched, speed_table[:, None], 9, OE_N, final_obs=True,
                                                              device=dev), warmup=2, reps=10)
    k6_ms, k6_call_ms = kernel_ms(torch, lambda: oe.oe_episode(p_oe, speed_table, 9, OE_N, device=dev), warmup=2, reps=10)
    k6_plain_ms = cuda_ms(torch, lambda: oe.oe_episode_plain(p_oe, speed_table, 9, OE_N, device=dev), warmup=1, reps=2)
    k6_big = kernel_ms(torch, lambda: oe.oe_episode(p_oe, speed_table, 9, OE_LARGE_N, device=dev), warmup=2, reps=10)
    k8_ms, k8_call_ms = kernel_ms(torch, lambda: cj.cj_episode(p_cj, cj_table, 9, 100, CJ_N, device=dev), warmup=2, reps=10)
    k8_plain_ms = cuda_ms(torch, lambda: cj.cj_episode_plain(p_cj, cj_table, 9, 100, CJ_N, device=dev), warmup=1, reps=1)
    s_oe = len(p_sched.obs_low)
    rows = (
        ("K5 det_rollout table stats native", (k5_ms, k5_call_ms), k5_plain_ms, CJ_N, cj_steps, k5_bound),
        ("K5 det_rollout table streams native", k5_streams, None, CJ_N, cj_steps,
         bound(table_bytes + (cj_steps * 9 + 4) * 4 * CJ_N, OPS_PER_ENV_STEP_K5_TABLE * CJ_N * cj_steps)),
        ("K5 det_rollout table stats native", k5_big, None, CJ_STATS_N, cj_steps,
         bound(table_bytes + 5 * 4 * CJ_STATS_N, OPS_PER_ENV_STEP_K5_TABLE * CJ_STATS_N * cj_steps)),
        ("K5 det_rollout schedule streams native", k5_sched, None, OE_N, oe_steps,
         bound(oe_steps * 4 + (oe_steps * (s_oe + 4) + s_oe) * 4 * OE_N, OPS_PER_ENV_STEP_K5_SPEED * OE_N * oe_steps)),
        ("K6 oe_episode native", (k6_ms, k6_call_ms), k6_plain_ms, OE_N, oe_steps, k6_bound),
        (f"K6 oe_episode native ({oe.kernel_geometry(p_oe, OE_LARGE_N).shape} shape)", k6_big, None, OE_LARGE_N, oe_steps,
         bound(oe_steps * 4 + 6 * 4 * OE_LARGE_N, OPS_PER_ENV_STEP_K6 * OE_LARGE_N * oe_steps)),
        ("K8 cj_episode native", (k8_ms, k8_call_ms), k8_plain_ms, CJ_N, cj_steps, k8_bound),
    )
    for name, (ms, call), plain_ms, n, steps, (b_ms, b_by) in rows:
        print(kernel_row(17, card, name, f"{n}x{steps}", n * steps, ms, call, b_ms, b_by, plain_ms))
    # the device's share of each fused entry point's call under the
    # profiler, after a warm-up step.  The profiler can lose a kernel
    # launched through ctypes from its records (seen for K5, K6 and K8, in
    # some calls and not others); where it lost the call's kernel, the
    # kernel's device time at the same shape, measured above, is added to
    # the busy time and the line says so.
    for name, fn, kernel, kernel_dev_ms in (
        ("mc_episode_stats CJ fused", lambda: mc_episode_stats(cj_cfg, cj_pol, None, 7), "det_rollout_kernel", k5_ms),
        ("rollout CJ fused", lambda: rollout(cj_cfg, cj_pol, None, 7), "det_rollout_kernel", k5_streams[0]),
        ("cj_episode_rewards CJ fused", lambda: cj_episode_rewards(cj_cfg, cj_agent, 7, CJ_N), "cj_episode_kernel", k8_ms),
        ("mc_episode_stats OE fused", lambda: mc_episode_stats(oe_cfg, oe_pol, None, 7), "oe_episode_kernel", k6_ms),
        ("rollout OE fused", lambda: rollout(oe_cfg, oe_pol, None, 7), "det_rollout_kernel", k5_sched[0]),
        ("rollout AS fused", lambda: rollout(as_cfg, as_pol, None, 7), "as_traj_kernel",
         (as_kernel_ms or {}).get("as_traj_kernel", 0.0)),
        ("mc_episode_stats AS fused", lambda: mc_episode_stats(as_cfg, as_pol, None, 7, episodes=EPISODES),
         "as_episode_kernel", EPISODES * (as_kernel_ms or {}).get("as_episode_kernel", 0.0)),
    ):
        seen = profile_iteration(torch, card, name, fn, phase=17, expect=(kernel,), warm=True)
        if seen and not any(kernel in k for k in seen["by_name"]):
            busy = seen["busy_ms"] + kernel_dev_ms
            print(f"phase 17 profile {name}: with {kernel}'s device time {kernel_dev_ms} ms added, device busy "
                  f"{busy} ms of {seen['wall_ms']} ms, idle share {1 - busy / seen['wall_ms']:.1%}")
    print(f"phase 17 ok in {time.perf_counter() - t0:.1f} s")
    entries = []
    for name, key, src, replaces, ms, call, plain_ms, (b_ms, b_by) in (
        ("K5 det_rollout", "det_rollout", "det_rollout.cu", "mbt_gym_tpu/ops/pallas_rollout.py:1876", k5_ms, k5_call_ms,
         k5_plain_ms, k5_bound),
        ("K6 oe_episode", "oe_episode", "oe_episode.cu", "mbt_gym_tpu/ops/pallas_episode.py:720", k6_ms, k6_call_ms,
         k6_plain_ms, k6_bound),
        ("K8 cj_episode", "cj_episode", "cj_episode.cu", "mbt_gym_tpu/ops/pallas_episode.py:409", k8_ms, k8_call_ms,
         k8_plain_ms, k8_bound),
    ):
        entries.append({
            "name": name, "route": "cuda", "source": f"mbt_gym_torch/ops/csrc/{src}", "replaces": replaces,
            "launches": launches[key], "max_abs_err": err[name[:2]], "ms": ms, "call_ms": call, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })
    # the step-pipeline geometry of K5, K6 and K8 at the main paths' shape,
    # and which way K5 and K8 read the depth table there: staged in the
    # ring, or from global memory for a table too wide for it
    for entry, geometry in zip(entries, (det.kernel_geometry(p_table, CJ_N, True), oe.kernel_geometry(p_oe, OE_N),
                                         cj.kernel_geometry(p_cj, 100, CJ_N))):
        entry["table_path"] = geometry.table_path
        entry["pipeline"] = pipeline_entry(geometry)
        print(f"phase 17 {entry['name']} on its main path: table {geometry.table_path}, pipeline {entry['pipeline']}")
    return entries


# ------------------------------------------------------------------ fused update and towers
TOWERS_ITERATIONS = {"a": 4, "b": 4, "c": 6}
EVAL_N = 16_384
# K4's and K7's kernels: pass 1 <kBf16, kRowMajor> (4) and pass 2 <kBf16,
# staged plane type> (3: K7's bf16 planes are float32)
UPDATE_PASSES = ("ppo_deep_pass1", "ppo_deep_pass2")
UPDATE_INSTANTIATIONS = 7


def kernel_registers(report, names):
    """(kernel entry, its ptxas usage line with the spill line before it)
    for every entry of a ptxas -v report whose mangled name contains one of
    ``names``."""
    rows, entry, spills = [], None, ""
    for line in report.splitlines():
        if "Compiling entry function" in line:
            entry, spills = line.split("'")[1], ""
        elif entry and "spill stores" in line:
            spills = line.strip()
        elif entry and "Used" in line and any(n in entry for n in names):
            usage = line.split(":", 1)[1].strip()
            rows.append((entry, f"{usage}; {spills}" if spills else usage))
            entry = None
    return rows


def spill_bytes(usage):
    """Bytes of spill stores plus spill loads in one of
    :func:`kernel_registers`' usage strings (0 where ptxas printed none)."""
    import re

    return sum(int(b) for b in re.findall(r"(\d+) bytes spill (?:stores|loads)", usage))


def sass_counts(sass, opcode, names=None):
    """{kernel entry: number of SASS lines holding ``opcode``} from
    ``cuobjdump -sass`` output, for every entry or, with ``names``, the
    entries whose mangled name contains one of them."""
    counts, entry = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            entry = name if names is None or any(n in name for n in names) else None
            if entry is not None:
                counts[entry] = 0
        elif entry is not None and opcode in line:
            counts[entry] += 1
    return counts


def bf16_instantiation(entry):
    """Whether a mangled kernel entry is the bf16 instantiation: its first
    template argument (``kBf16``, ``ILb1E``) is true.  The parameter types
    may name ``__nv_bfloat16`` in either instantiation (K3's float32 one
    mangles ``std::conditional<kBf16, __nv_bfloat16, float>``)."""
    import re

    match = re.search(r"ILb([01])E", entry)
    return match is not None and match.group(1) == "1"


def check_tensor_cores(library, label, names, instantiations):
    """Phase 18: the bf16 instantiations of the kernels ``names`` in
    ``library`` run tensor-core instructions (HMMA in the SASS) and the
    float32 ones none; ``instantiations`` of them must be there.  Returns
    the SASS."""
    import shutil
    from pathlib import Path

    from mbt_gym_torch.ops import _build

    cuobjdump = shutil.which("cuobjdump") or str(Path(_build.nvcc()).parent / "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(library)], capture_output=True, text=True, timeout=300,
                          check=True).stdout
    kernels = sass_counts(sass, "HMMA", names)
    check(len(kernels) == instantiations,
          f"phase 18: {len(kernels)} {names} kernels in the SASS of {library}, not {instantiations}")
    for entry, n in sorted(kernels.items()):
        bf16 = bf16_instantiation(entry)
        print(f"phase 18 {label} {entry[:90]}: {n} HMMA ({'bf16' if bf16 else 'float32'})")
        check(n > 0 if bf16 else n == 0, f"phase 18: {n} HMMA in {entry}")
    return sass


def update_phases(torch, np, card, dev):
    """Phases 18-21: the register counts and tensor-core instructions of the
    update passes and K3; K7, K4's stacked-trunk mode and K3's towers mode
    against their plain versions at config 5; the three train_iteration
    paths and the fused towers evaluation through the public entry points,
    with per-iteration launch counts; timings and profiles.  Returns the K7
    kernels-line entry and the towers figures of K3 and K4."""
    import dataclasses

    from mbt_gym_torch import dispatch_report, init_train_state, train_iteration
    from mbt_gym_torch.agents.networks import init_actor_critic
    from mbt_gym_torch.agents.ppo import PPOConfig, collect_rollout, deterministic_policy, evaluate_policy, normalise
    from mbt_gym_torch.ops import _build
    from mbt_gym_torch.ops import fused_ppo
    from mbt_gym_torch.ops import mlp_rollout as mr
    from mbt_gym_torch.utils.config import as_env_config

    # ---- phase 18: registers and spills of the update passes and of K3
    # (the full report is printed with the builds above): K4 and K7 are
    # ppo_deep_pass1<kBf16, kRowMajor> (K7: "Lb?ELb1E") and
    # ppo_deep_pass2<kBf16, staged type> (K7 in bf16 stages float32
    # planes), 7 instantiations, the bf16 ones "ILb1E"; K3 (both layouts) is
    # mlp_rollout_kernel, one instantiation per operand type and dynamics
    # kind (limit, lam, touch).  Then the tensor-core instructions of each.
    # The update passes and the step-pipeline kernels K1, K2, K5, K6 and
    # K8 spill nothing: K5's 72 instantiations of the plain processes
    # (limit and speed: 20 at inventory exponent 2, 20 at any other; lam
    # and touch, the fixed and schedule kinds: 16 and 16), 36 general ones,
    # 4 of the composite family and 36 of the exponential utility (phases
    # 24e, 26e), K1's, K6's and K8's 4 (two draw modes, the pipeline and
    # the wide shape) and K2's 16 (the same, by its four output layouts).
    no_spills = {"det_rollout.cu": 72 + 36 + 4 + 36, "as_episode.cu": 4 + 16, "oe_episode.cu": 4,
                 "cj_episode.cu": 4, "fused_ppo.cu": UPDATE_INSTANTIATIONS}
    for src, names in (("fused_ppo.cu", UPDATE_PASSES), ("mlp_rollout.cu", ("mlp_rollout_kernel",)),
                       ("det_rollout.cu", ("det_rollout_kernel",)),
                       ("as_episode.cu", ("as_episode_kernel", "as_traj_kernel")),
                       ("oe_episode.cu", ("oe_episode_kernel",)), ("cj_episode.cu", ("cj_episode_kernel",))):
        rows = kernel_registers(_build.ptxas_reports.get(src, ""), names)
        check(rows, f"phase 18: no ptxas report for {names} in {src}")
        for entry, usage in rows:
            print(f"phase 18 registers {src} {entry[:90]}: {usage}")
            if src in no_spills:
                check(spill_bytes(usage) == 0, f"phase 18: {entry} spills: {usage}")
        if src in no_spills:
            check(len(rows) == no_spills[src],
                  f"phase 18: {src} holds {len(rows)} instantiations of {names}, not {no_spills[src]}")
    check_tensor_cores(_build.build("fused_ppo.cu"), "fused_ppo.cu", UPDATE_PASSES, UPDATE_INSTANTIATIONS)
    # K3: mlp_rollout_kernel<true, kind, proc, extras> (bf16, tensor cores)
    # and <false, kind, proc, extras> for the four dynamics kinds on the
    # plain and the general processes, and the general ones' extras
    # variants; MUFU counts the special-function instructions behind its
    # tanhf/expf/logf
    k3_sass = check_tensor_cores(_build.build("mlp_rollout.cu"), "mlp_rollout.cu", ("mlp_rollout_kernel",), 24)
    kinds = {kind: sass_counts(k3_sass, f"MUFU.{kind}", ("mlp_rollout_kernel",))
             for kind in ("EX2", "RCP", "LG2", "SQRT", "RSQ", "SIN", "COS", "TANH")}
    for entry, n in sorted(sass_counts(k3_sass, "MUFU", ("mlp_rollout_kernel",)).items()):
        by_kind = {kind: c[entry] for kind, c in kinds.items() if c[entry]}
        print(f"phase 18 mlp_rollout.cu {entry[:90]}: {n} MUFU in the SASS {by_kind}")

    env_cfg = dataclasses.replace(
        as_env_config(num_trajectories=PPO_N),
        normalise_observation_space=True, normalise_action_space=True,
    )
    steps = env_cfg.n_steps
    s_dim, a_dim, (h0, h1) = 4, 2, (256, 256)
    shared = init_actor_critic(0, s_dim, a_dim, hidden=(h0, h1), shared_trunk=True, device=dev)
    towers = init_actor_critic(1, s_dim, a_dim, hidden=(h0, h1), shared_trunk=False, device=dev)

    # ---- phase 19: K7 on one shuffled 3,276,800-sample minibatch of an
    # engine rollout at config 5, K4's stacked-trunk mode on the same
    # samples in feature-major form, both with log_std moved by 0.05 (so
    # ratios leave 1 and both clip branches occur); K3's towers mode at
    # 262,144 x 200 in noise and native mode (phase 8's limits)
    t0 = time.perf_counter()
    batch = collect_rollout(env_cfg, shared, 23, compute_dtype="bfloat16")
    total = PPO_N * steps
    m = total // PPO_MINIBATCHES
    perm = torch.randperm(total, generator=torch.Generator(device=dev).manual_seed(5), device=dev)[:m]
    mb = [batch.obs.reshape(total, s_dim)[perm], batch.actions.reshape(total, a_dim)[perm],
          batch.log_probs.reshape(-1)[perm], batch.advantages.reshape(-1)[perm], batch.returns.reshape(-1)[perm]]
    mb[3] = normalise(mb[3])
    del batch, perm
    lanes = 1024  # the re-blocking of agents/ppo.py: the largest power of two up to 1024 dividing m
    while m % lanes:
        lanes //= 2
    rows = m // lanes
    mb_t = [x.reshape(rows, lanes, -1).transpose(1, 2).contiguous() if x.dim() == 2 else x.reshape(rows, lanes)
            for x in mb]
    with torch.no_grad():
        for model in (shared, towers):
            model.log_std.add_(0.05)
    err = {"K7": 0.0, "K4 towers": 0.0, "K3 towers": 0.0}
    for dtype in ("float32", "bfloat16"):
        grads, metrics = fused_ppo.ppo_fused_grads(shared, *mb, compute_dtype=dtype)
        again = fused_ppo.ppo_fused_grads(shared, *mb, compute_dtype=dtype)
        want_g, want_m = fused_ppo.ppo_fused_grads_plain(shared, *mb, compute_dtype=dtype)
        torch.cuda.synchronize()
        err["K7"] = max(err["K7"], compare_grads(torch, grads, metrics, want_g, want_m, dtype,
                                                 f"phase 19 K7 {dtype} at {m} samples"))
        check_repeat(torch, (grads, metrics), again, f"phase 19 K7 {dtype}")
        grads, metrics = fused_ppo.ppo_fused_grads_T(towers, *mb_t, compute_dtype=dtype)
        again = fused_ppo.ppo_fused_grads_T(towers, *mb_t, compute_dtype=dtype)
        want_g, want_m = fused_ppo.ppo_fused_grads_T_plain(towers, *mb_t, compute_dtype=dtype)
        torch.cuda.synchronize()
        err["K4 towers"] = max(err["K4 towers"], compare_grads(
            torch, grads, metrics, want_g, want_m, dtype, f"phase 19 K4 towers {dtype} at {rows}x{lanes}"))
        check_repeat(torch, (grads, metrics), again, f"phase 19 K4 towers {dtype}")
    del grads, want_g, again
    with torch.no_grad():
        for model in (shared, towers):
            model.log_std.sub_(0.05)
    p = mr.rollout_params_from_config(env_cfg)
    rng = np.random.default_rng(22)
    channels = rng.uniform(size=(steps, mr.N_CHANNELS, PPO_N)).astype(np.float32)
    channels[:, 4:] = rng.normal(size=(steps, 3, PPO_N)).astype(np.float32)
    noise = torch.from_numpy(channels).to(dev)
    del channels
    for mode, kw in (("noise", {"noise": noise}), ("native", {"seed": 32, "device": dev})):
        got = mr.mlp_rollout(p, towers, num_trajectories=PPO_N, **kw)
        again = mr.mlp_rollout(p, towers, num_trajectories=PPO_N, **kw)
        want = mr.mlp_rollout_plain(p, towers, num_trajectories=PPO_N, **kw)
        torch.cuda.synchronize()
        err["K3 towers"] = max(err["K3 towers"], compare_rollouts(
            torch, got, want, PPO_N, f"phase 19 K3 towers {mode} at {PPO_N}x{steps}"))
        check_repeat(torch, rollout_outputs(got), rollout_outputs(again), f"phase 19 K3 towers {mode}")
        del again
    del noise, got, want
    print(f"phase 19 ok in {time.perf_counter() - t0:.1f} s")

    # ---- phase 20: the three paths through the public entry points at
    # config 5, launch counts read per iteration, metric bands on every one
    t0 = time.perf_counter()
    base = dict(hidden=(h0, h1), n_epochs=1, n_minibatches=PPO_MINIBATCHES, compute_dtype="bfloat16")
    paths = {
        "a": ("shared trunk, fused_update, shuffle", PPOConfig(**base, shared_trunk=True, fused_update=True),
              {"ppo_fused_grads": PPO_MINIBATCHES}),
        "b": ("towers, fused_update, shuffle", PPOConfig(**base, shared_trunk=False, fused_update=True),
              {"ppo_fused_grads_T": PPO_MINIBATCHES}),
        "c": ("towers, fused_rollout + fused_update", PPOConfig(**base, shared_trunk=False, fused_update=True,
                                                               fused_rollout=True, shuffle=False),
              {"mlp_rollout": 1, "ppo_fused_grads_T": PPO_MINIBATCHES}),
    }
    states, launches, rewards = {}, {}, {}
    for key, (label, cfg, per_iteration) in paths.items():
        ts = init_train_state(env_cfg, cfg, 30)
        check(next(ts.params.parameters()).device.type == "cuda", f"phase 20 ({key}): params not on the card")
        launches[key] = {name: 0 for name in _build.launch_counts}
        rewards[key] = []
        for i in range(TOWERS_ITERATIONS[key]):
            _build.reset_launch_counts()
            ts, metrics = train_iteration(env_cfg, cfg, ts, 300 + i)
            torch.cuda.synchronize()
            counts = dict(_build.launch_counts)
            want = {name: per_iteration.get(name, 0) for name in counts}
            check(counts == want, f"phase 20 ({key}) iteration {i + 1}: launches {counts}, want {want}")
            for name, c in counts.items():
                launches[key][name] += c
            rewards[key].append(assert_metric_bands(metrics, f"phase 20 ({key}) iteration {i + 1}")["mean_episode_reward"])
        states[key] = ts
        print(f"phase 20 ({key}) {label}: {TOWERS_ITERATIONS[key]} iterations, launches {per_iteration} each, "
              f"mean_episode_reward {rewards[key]}")
    early, late = statistics.mean(rewards["c"][1:3]), statistics.mean(rewards["c"][-2:])
    print(f"phase 20 (c) mean_episode_reward iterations 2-3 {early}, last 2 {late}")
    check(late >= early - 1.0, f"phase 20 (c): PPO degraded, mean reward {early} -> {late}")
    trained = states["c"].params
    decision = dispatch_report(env_cfg, deterministic_policy(env_cfg), mode="evaluate", platform=dev,
                               policy_params=trained)
    print(f"phase 20 dispatch (evaluate, towers): {decision}")
    _build.reset_launch_counts()
    reward = float(evaluate_policy(env_cfg, trained, 40, backend="fused"))
    torch.cuda.synchronize()
    check(_build.launch_counts["mlp_rollout"] == 1, f"phase 20: fused evaluation launches {dict(_build.launch_counts)}")
    check(-200.0 < reward < 200.0, f"phase 20: fused evaluation reward {reward}")
    print(f"phase 20 evaluate_policy(backend='fused') on the trained towers at {PPO_N}x{steps}: {reward} (K3 x1)")
    print(f"phase 20 ok in {time.perf_counter() - t0:.1f} s")

    # ---- phase 21: timings (CUDA events, medians after warm-up) and
    # profiles with the idle share
    t0 = time.perf_counter()
    env_steps = PPO_N * steps
    engine_towers = PPOConfig(**base, shared_trunk=False)
    timed = [(f"({key}) {label}", cfg, states[key]) for key, (label, cfg, _) in paths.items()]
    timed.append(("engine path on the towers (autograd update, shuffle)", engine_towers, states["b"]))
    for label, cfg, ts in timed:
        ms = cuda_ms(torch, lambda: train_iteration(env_cfg, cfg, ts, 5), warmup=1, reps=2)
        print(f"phase 21 [{card}] train_iteration {label} at config 5 ({PPO_N}x{steps}, 16 minibatches): "
              f"{ms} ms = {env_steps / ms * 1e3} env-steps/s")
    for key in ("a", "c"):
        label, cfg, _ = paths[key]
        profile_iteration(torch, card, f"train_iteration ({key}) {label} at config 5",
                          lambda: train_iteration(env_cfg, cfg, states[key], 6), phase=21)
    k7_ms, k7_call_ms = kernel_ms(torch, lambda: fused_ppo.ppo_fused_grads(shared, *mb), warmup=2, reps=5,
                                  label=f"phase 21 K7 at {m} samples")
    k7_plain_ms = cuda_ms(torch, lambda: fused_ppo.ppo_fused_grads_plain(shared, *mb), warmup=1, reps=2)
    k4_ms, k4_call_ms = kernel_ms(torch, lambda: fused_ppo.ppo_fused_grads_T(towers, *mb_t), warmup=1, reps=3,
                                  label=f"phase 21 K4 towers at {rows}x{lanes}")
    k4_plain_ms = cuda_ms(torch, lambda: fused_ppo.ppo_fused_grads_T_plain(towers, *mb_t), warmup=1, reps=2)
    k7_engine_ms = engine_grad_ms(torch, shared, mb, f"phase 21 K7 at {m} samples", card)
    k4_engine_ms = engine_grad_ms(torch, towers, mb, f"phase 21 K4 towers at {m} samples", card)
    k3_ms, k3_call_ms = kernel_ms(torch, lambda: mr.mlp_rollout(p, towers, 9, PPO_N, device=dev), warmup=1, reps=3,
                                  label=f"phase 21 K3 towers at {PPO_N}x{steps}")
    k3_plain_ms = cuda_ms(torch, lambda: mr.mlp_rollout_plain(p, towers, 9, PPO_N, device=dev), warmup=1, reps=1)
    k3_engine_ms = engine_rollout_ms(torch, env_cfg, towers, f"phase 21 K3 towers at {PPO_N}x{steps}", card)
    # K7 and K4 read obs, actions, old log-prob, advantage and return once
    # per sample and write the grads (~0.3 MB, ~0.6 MB with towers); K3
    # native mode writes (S + A + 3) floats per env-step
    per_sample = (s_dim + a_dim + 3) * 4
    k7_bound = bound_ms(per_sample * m, ppo_grad_flops_per_sample(s_dim, h0, h1, a_dim) * m, BF16_OPS_PER_S)
    k4_bound = bound_ms(per_sample * m, ppo_grad_flops_per_sample(s_dim, h0, h1, a_dim, towers=2) * m, BF16_OPS_PER_S)
    k3_bound = bound_ms(per_sample * env_steps, mlp_flops_per_sample(s_dim, h0, h1, a_dim, towers=2) * env_steps,
                        BF16_OPS_PER_S)
    for name, ms, call, plain_ms, (b_ms, b_by), shape, engine in (
        ("K7 ppo_fused_grads bf16 (one shuffled minibatch)", k7_ms, k7_call_ms, k7_plain_ms, k7_bound,
         f"{m} samples", f", engine {k7_engine_ms} ms"),
        ("K4 ppo_fused_grads_T towers bf16 (one minibatch)", k4_ms, k4_call_ms, k4_plain_ms, k4_bound,
         f"{rows}x{lanes}", f", engine {k4_engine_ms} ms"),
        ("K3 mlp_rollout towers native", k3_ms, k3_call_ms, k3_plain_ms, k3_bound, f"{PPO_N}x{steps}",
         f", engine {k3_engine_ms} ms"),
    ):
        print(f"phase 21 [{card}] {name} at {shape}: {ms} ms on the device (call {call} ms), plain {plain_ms} ms"
              f"{engine}, bound {b_ms} ms ({b_by}), {b_ms / ms:.1%} of bound")
    eval_cfg = dataclasses.replace(env_cfg, num_trajectories=EVAL_N)
    for label, model in (("shared trunk", shared), ("separate towers", towers)):
        rates = {}
        for backend in ("fused", "engine"):
            ms = cuda_ms(torch, lambda: evaluate_policy(eval_cfg, model, 3, backend=backend), warmup=1, reps=3)
            rates[backend] = EVAL_N * steps / ms * 1e3
            print(f"phase 21 [{card}] evaluate_policy {backend} {label} at {EVAL_N}x{steps}: {ms} ms = "
                  f"{rates[backend]} env-steps/s")
        decision = dispatch_report(eval_cfg, deterministic_policy(eval_cfg), mode="evaluate", platform=dev,
                                   policy_params=model)
        print(f"phase 21 evaluate {label}: measured {'K3' if rates['fused'] > rates['engine'] else 'the engine'} "
              f"faster; dispatch (evaluate) decides {decision.backend}: {decision.reason}")
    print(f"phase 21 ok in {time.perf_counter() - t0:.1f} s")
    k7 = {
        "name": "K7 ppo_fused_grads", "route": "cuda", "source": "mbt_gym_torch/ops/csrc/fused_ppo.cu",
        "replaces": "mbt_gym_tpu/ops/fused_ppo.py:634", "launches": launches["a"]["ppo_fused_grads"],
        "max_abs_err": err["K7"], "ms": k7_ms, "call_ms": k7_call_ms, "plain_ms": k7_plain_ms,
        "engine_ms": k7_engine_ms,
        "bound_ms": k7_bound[0], "bound_by": k7_bound[1], "library_ms": None,
    }
    towers_figures = {
        "K3": {"towers_launches": launches["c"]["mlp_rollout"], "towers_max_abs_err": err["K3 towers"],
               "towers_ms": k3_ms, "towers_call_ms": k3_call_ms, "towers_plain_ms": k3_plain_ms,
               "towers_engine_ms": k3_engine_ms,
               "towers_bound_ms": k3_bound[0]},
        "K4": {"towers_launches": launches["b"]["ppo_fused_grads_T"] + launches["c"]["ppo_fused_grads_T"],
               "towers_max_abs_err": err["K4 towers"], "towers_ms": k4_ms, "towers_call_ms": k4_call_ms,
               "towers_plain_ms": k4_plain_ms,
               "towers_engine_ms": k4_engine_ms, "towers_bound_ms": k4_bound[0]},
    }
    return k7, towers_figures


# ------------------------------------------------------------------ CJ learning
# The JAX slow gate's setting (tests/test_convergence.py:214-237): the CJ
# env at 1,024 envs x 100 steps, arrival rate 10, phi 0.5, alpha 0.001,
# q_max 10; 250 iterations of 4 epochs x 4 minibatches, 128x128 towers; the
# best mean episode reward above 0.6 x the closed-form CJ agent's.
CJ_GATE_N, CJ_GATE_T, CJ_GATE_ITERATIONS, CJ_GATE_BAR = 1024, 100, 250, 0.6
CJ_GATE_ENGINE_ITERATIONS = 25  # the eager engine learner beside the gate: host-bound, so cut to keep the run short
CJ_GATE_CAPTURED = 3  # phase 22b's engine iterations run again captured
CJ_SMALL_N = 4096
SCALING_N = 131_072  # a lane multiple: the reward-scaling simulation on K5


def cj_learning_phases(torch, np, card, dev, k3_pnl_ms=None):
    """Phase 22: PPO learning on the CJ market-making env through K3's CjMm
    reward.  (a) K3's CjMm and running-penalty rewards at exponents 2 and 3
    and K5 at exponent 3 against their plain versions; (b) the fully fused
    PPO path learns on the card to the JAX slow gate's bar, beside the
    engine path's first :data:`CJ_GATE_ENGINE_ITERATIONS` iterations, then
    evaluate_policy(backend="auto") goes to K3; (c) one
    fused iteration at config 5's widths on the CJ env, with K3's CjMm
    time beside its PnL time (``k3_pnl_ms``: phase 12's); (d) REINFORCE on
    the card; (e) the reward-scaling simulation on K5's fixed kind.
    Returns the kernels-line figures of K3, K4 and K5 by kernel."""
    import dataclasses

    from mbt_gym_torch import (
        CarteaJaimungalMmAgent, as_env_config, cj_env_config, dispatch_report, rollout, with_normalised_rewards,
    )
    from mbt_gym_torch.agents import reinforce
    from mbt_gym_torch.agents.networks import init_actor_critic
    from mbt_gym_torch import compiled
    from mbt_gym_torch.agents.ppo import (
        PPOConfig, deterministic_policy, evaluate_policy, init_train_state, jit_train_iteration, train_iteration,
    )
    from mbt_gym_torch.ops import _build
    from mbt_gym_torch.ops import det_rollout as det
    from mbt_gym_torch.ops import mlp_rollout as mr
    from mbt_gym_torch.rewards import CjMmCriterion, RunningInventoryPenalty
    from mbt_gym_torch.utils import reward_scaling

    t_start = time.perf_counter()
    norm = dict(normalise_observation_space=True, normalise_action_space=True)
    steps = STEPS
    cj5 = dataclasses.replace(cj_env_config(num_trajectories=PPO_N, n_steps=steps), **norm)  # CjMm, phi 0.01
    shared = init_actor_critic(3, 4, 2, hidden=(256, 256), shared_trunk=True, device=dev)
    towers = init_actor_critic(4, 4, 2, hidden=(256, 256), shared_trunk=False, device=dev)
    layouts = (("shared trunk", shared), ("towers", towers))

    def mlp_channels(seed, n):
        rng = np.random.default_rng(seed)
        c = rng.uniform(size=(steps, mr.N_CHANNELS, n)).astype(np.float32)
        c[:, 4:] = rng.normal(size=(steps, mr.N_CHANNELS - 4, n)).astype(np.float32)
        return torch.from_numpy(c).to(dev)

    # ---- phase 22a: K3's new reward kinds at config 5's widths (CjMm,
    # injected noise, both layouts), then the running penalty and exponent
    # 3 at 4,096 envs in both draw modes, at phase 8's limits, each
    # launched twice bitwise; K5's table and fixed kinds at exponent 3 at
    # phase 14's limits
    t0 = time.perf_counter()
    err = {"K3": 0.0, "K5": 0.0}
    p5 = mr.rollout_params_from_config(cj5)
    check((p5.reward_kind, p5.phi, p5.alpha) == ("cjmm", 0.01, 0.001), f"phase 22a: config 5 CJ params {p5}")
    noise = mlp_channels(25, PPO_N)
    for layout, model in layouts:
        got = mr.mlp_rollout(p5, model, num_trajectories=PPO_N, noise=noise)
        again = mr.mlp_rollout(p5, model, num_trajectories=PPO_N, noise=noise)
        want = mr.mlp_rollout_plain(p5, model, num_trajectories=PPO_N, noise=noise)
        torch.cuda.synchronize()
        at = f"phase 22a K3 cjmm {layout} noise at {PPO_N}x{steps}"
        err["K3"] = max(err["K3"], compare_rollouts(torch, got, want, PPO_N, at))
        check_repeat(torch, rollout_outputs(got), rollout_outputs(again), at)
        del got, again, want
    del noise
    for name, reward in (("running", RunningInventoryPenalty(0.01, 0.001)),
                         ("cjmm e3", CjMmCriterion(0.01, 0.001, inventory_exponent=3.0)),
                         ("running e3", RunningInventoryPenalty(0.01, 0.001, inventory_exponent=3.0))):
        p = mr.rollout_params_from_config(dataclasses.replace(cj5, num_trajectories=CJ_SMALL_N, reward_function=reward))
        for layout, model in layouts:
            for mode, kw in (("noise", {"noise": mlp_channels(26, CJ_SMALL_N)}), ("native", {"seed": 34, "device": dev})):
                got = mr.mlp_rollout(p, model, num_trajectories=CJ_SMALL_N, **kw)
                again = mr.mlp_rollout(p, model, num_trajectories=CJ_SMALL_N, **kw)
                want = mr.mlp_rollout_plain(p, model, num_trajectories=CJ_SMALL_N, **kw)
                torch.cuda.synchronize()
                at = f"phase 22a K3 {name} {layout} {mode} at {CJ_SMALL_N}x{steps}"
                err["K3"] = max(err["K3"], compare_rollouts(torch, got, want, CJ_SMALL_N, at))
                check_repeat(torch, rollout_outputs(got), rollout_outputs(again), at)
    cjp = cj_env_config(num_trajectories=CJ_N, max_inventory=100.0)
    cjp_agent = CarteaJaimungalMmAgent.from_config(cjp, max_inventory=100)  # its closed form takes exponent 2
    cjp3 = dataclasses.replace(cjp, reward_function=CjMmCriterion(0.01, 0.001, inventory_exponent=3.0))
    as3 = dataclasses.replace(as_env_config(num_trajectories=CJ_N),
                              reward_function=RunningInventoryPenalty(0.01, 0.001, inventory_exponent=3.0))
    k5_cases = (
        ("table CJP cjmm e3", det.cj_rollout_params(cjp3, cjp_agent),
         tuple(torch.as_tensor(t, device=dev) for t in det.cj_depth_tables(cjp_agent))),
        ("fixed AS running e3", det.fixed_rollout_params(as3, [0.7, 0.9]), ()),
    )
    for label, p, tbl in k5_cases:
        check(p.inventory_exponent == 3.0, f"phase 22a K5 {label}: exponent {p.inventory_exponent}")
        rng = np.random.default_rng(27)
        c = rng.uniform(size=(p.run_steps, 5, CJ_N)).astype(np.float32)
        c[:, 4] = rng.normal(size=(p.run_steps, CJ_N)).astype(np.float32)
        for mode, kw in (("noise", {"noise": torch.from_numpy(c).to(dev)}), ("native", {"seed": 43, "device": dev})):
            for stats in (True, False):
                extra = {"stats_only": stats, "final_obs": not stats}
                got = det.det_rollout(p, tbl, num_trajectories=CJ_N, **kw, **extra)
                again = det.det_rollout(p, tbl, num_trajectories=CJ_N, **kw, **extra)
                want = det.det_rollout_plain(p, tbl, num_trajectories=CJ_N, **kw, **extra)
                torch.cuda.synchronize()
                at = f"phase 22a K5 {label} {'stats' if stats else 'streams'} {mode} at {CJ_N}x{p.run_steps}"
                err["K5"] = max(err["K5"], compare_outputs(torch, got, want, CJ_N, at, streams=not stats))
                check_repeat(torch, (dict(enumerate(got)),), (dict(enumerate(again)),), at)
        del got, again, want
    print(f"phase 22a ok in {time.perf_counter() - t0:.1f} s")

    # ---- phase 22b: the fused PPO path learns on the card.  Launch counts
    # are read per iteration (K3 x1, K4 x16, nothing else) and summed over
    # the slice's main path (22b and 22e); metric bands on every iteration
    t0 = time.perf_counter()
    path = {name: 0 for name in _build.launch_counts}

    def add_launches():
        for name, c in _build.launch_counts.items():
            path[name] += c

    raw = cj_env_config(num_trajectories=CJ_GATE_N, n_steps=CJ_GATE_T, arrival_rate=10.0,
                        per_step_inventory_aversion=0.5, terminal_inventory_aversion=0.001, max_inventory=10.0)
    gate_cfg = dataclasses.replace(raw, **norm)
    _build.reset_launch_counts()
    cf = float(rollout(raw, CarteaJaimungalMmAgent.from_config(raw, max_inventory=10).policy(), None, 1)
               .trajectory.rewards.sum(dim=0).mean())
    torch.cuda.synchronize()
    add_launches()
    fused_cfg = PPOConfig(hidden=(128, 128), n_epochs=4, n_minibatches=4, shuffle=False, fused_rollout=True,
                          fused_update=True)
    per_iteration = {"mlp_rollout": 1, "ppo_fused_grads_T": fused_cfg.n_epochs * fused_cfg.n_minibatches}
    bests, engine_states = {}, []
    for label, cfg in (("fused", fused_cfg), ("engine", dataclasses.replace(fused_cfg, fused_rollout=False,
                                                                            fused_update=False))):
        t1 = time.perf_counter()
        ts = init_train_state(gate_cfg, cfg, 0)
        check(next(ts.params.parameters()).device.type == "cuda", f"phase 22b {label}: params not on the card")
        history = []
        for i in range(CJ_GATE_ITERATIONS if label == "fused" else CJ_GATE_ENGINE_ITERATIONS):
            _build.reset_launch_counts()
            ts, metrics = train_iteration(gate_cfg, cfg, ts, i)
            counts = dict(_build.launch_counts)
            want = {name: per_iteration.get(name, 0) if label == "fused" else 0 for name in counts}
            check(counts == want, f"phase 22b {label} iteration {i + 1}: launches {counts}, want {want}")
            if label == "fused":
                add_launches()
            elif i < CJ_GATE_CAPTURED:
                engine_states.append((ts, metrics))
            history.append(assert_metric_bands(metrics, f"phase 22b {label} iteration {i + 1}")["mean_episode_reward"])
        bests[label] = max(history)
        print(f"phase 22b {label} path: {len(history)} iterations in {time.perf_counter() - t1:.1f} s, "
              f"mean_episode_reward first 5 {history[:5]}, last 5 {history[-5:]}, best {bests[label]} "
              f"= {bests[label] / cf:.3f} x the closed-form CJ agent's {cf}")
        if label == "fused":
            trained = ts.params
    # the engine learner's first iterations again through its compiled
    # entry point (slice 17): bit for bit the eager ones above
    ts = init_train_state(gate_cfg, cfg, 0)
    for i, (ets, em) in enumerate(engine_states):
        ts, metrics = jit_train_iteration(gate_cfg, cfg, ts, i)
        check(same_bits(torch, ts.params, ets.params) and same_bits(torch, ts.opt_state, ets.opt_state)
              and same_bits(torch, metrics, em),
              f"phase 22b engine iteration {i + 1}: jit_train_iteration is not train_iteration bit for bit")
    compiled.clear_cache()
    print(f"phase 22b engine path: {CJ_GATE_CAPTURED} jit_train_iterations bitwise the eager ones")
    decision = dispatch_report(gate_cfg, deterministic_policy(gate_cfg), mode="evaluate", platform=dev,
                               policy_params=trained)
    check((decision.backend, decision.family) == ("fused", "mlp_rollout"), f"phase 22b evaluate dispatch: {decision}")
    _build.reset_launch_counts()
    auto = float(evaluate_policy(gate_cfg, trained, 50))
    torch.cuda.synchronize()
    counts = {name: c for name, c in _build.launch_counts.items() if c}
    check(counts == {"mlp_rollout": 1}, f"phase 22b evaluate_policy(auto) launches {counts}")
    add_launches()
    engine = float(evaluate_policy(gate_cfg, trained, 50, backend="engine"))
    with torch.no_grad():
        spread = rollout(gate_cfg, deterministic_policy(gate_cfg), trained, 51, backend="engine").trajectory.rewards.sum(0)
    se = float(spread.std()) * (2.0 / CJ_GATE_N) ** 0.5
    print(f"phase 22b evaluate_policy of the trained towers at {CJ_GATE_N}x{CJ_GATE_T}: auto (K3 x1) {auto}, "
          f"engine {engine}, {abs(auto - engine) / se:.2f} se")
    check(abs(auto - engine) <= 4 * se, f"phase 22b: evaluate_policy auto {auto} vs engine {engine}, se {se}")
    check(bests["fused"] > CJ_GATE_BAR * cf,
          f"phase 22b: fused PPO best {bests['fused']} not above {CJ_GATE_BAR} x the closed form {cf}")
    print(f"phase 22b ok in {time.perf_counter() - t0:.1f} s: fused best {bests['fused']} and engine best "
          f"{bests['engine']} against the bar {CJ_GATE_BAR * cf}")

    # ---- phase 22c: config 5's widths on the CJ env: one fused iteration
    # per layout (launches checked, metric bands), one timed, one profiled;
    # K3's device time with the CjMm reward beside the PnL kind on the same
    # params in this call, and phase 12's PnL figure
    t0 = time.perf_counter()
    env_steps = PPO_N * steps
    k3 = {}
    for layout, shared_trunk in (("shared trunk", True), ("towers", False)):
        cfg = PPOConfig(hidden=(256, 256), n_epochs=1, n_minibatches=PPO_MINIBATCHES, shuffle=False,
                        compute_dtype="bfloat16", shared_trunk=shared_trunk, fused_rollout=True, fused_update=True)
        ts = init_train_state(cj5, cfg, 60)
        _build.reset_launch_counts()
        ts, metrics = train_iteration(cj5, cfg, ts, 61)
        torch.cuda.synchronize()
        counts = {name: c for name, c in _build.launch_counts.items() if c}
        check(counts == {"mlp_rollout": 1, "ppo_fused_grads_T": PPO_MINIBATCHES},
              f"phase 22c {layout}: launches {counts}")
        assert_metric_bands(metrics, f"phase 22c {layout}")
        ms = cuda_ms(torch, lambda: train_iteration(cj5, cfg, ts, 62), warmup=0, reps=1)
        print(f"phase 22c [{card}] fused train_iteration on the CJ env, {layout}, at config 5 ({PPO_N}x{steps}, "
              f"16 minibatches): {ms} ms = {env_steps / ms * 1e3} env-steps/s")
        profile_iteration(torch, card, f"fused train_iteration on the CJ env, {layout}, at config 5",
                          lambda: train_iteration(cj5, cfg, ts, 63), phase=22)
        params = ts.params
        cjmm = kernel_ms(torch, lambda: mr.mlp_rollout(p5, params, 9, PPO_N, device=dev), warmup=1, reps=5,
                         label=f"phase 22c K3 cjmm {layout} at {PPO_N}x{steps}")
        p_pnl = p5._replace(reward_kind="pnl")
        pnl = kernel_ms(torch, lambda: mr.mlp_rollout(p_pnl, params, 9, PPO_N, device=dev), warmup=1, reps=5,
                        label=f"phase 22c K3 pnl {layout} at {PPO_N}x{steps}")
        plain_ms = cuda_ms(torch, lambda: mr.mlp_rollout_plain(p5, params, 9, PPO_N, device=dev), warmup=1, reps=1)
        k3[layout] = (cjmm, pnl, plain_ms)
        print(f"phase 22c [{card}] K3 {layout} at {PPO_N}x{steps}: CjMm {cjmm[0]} ms on the device (call {cjmm[1]} ms), "
              f"plain {plain_ms} ms, PnL on the same params {pnl[0]} ms (call {pnl[1]} ms)"
              + (f"; phase 12's PnL K3 {k3_pnl_ms} ms" if shared_trunk and k3_pnl_ms is not None else ""))
        del ts, params
    print(f"phase 22c ok in {time.perf_counter() - t0:.1f} s")

    # ---- phase 22d: REINFORCE on the card (tests/test_convergence.py:135-176)
    t0 = time.perf_counter()
    rf_env = dataclasses.replace(as_env_config(num_trajectories=256, n_steps=20), **norm)
    gen = torch.Generator(dev).manual_seed(123)

    def random_policy(p, obs, state):
        return torch.rand((obs.shape[0], rf_env.action_dim), generator=gen, dtype=obs.dtype, device=obs.device) * 2 - 1

    _build.reset_launch_counts()
    rand = float(rollout(rf_env, random_policy, None, 5).trajectory.rewards.sum(dim=0).mean())
    rf_cfg = reinforce.ReinforceConfig(hidden=(32, 32), action_std=0.3, learning_rate=1e-2, lr_decay=0.999)
    rts = reinforce.init_train_state(rf_env, rf_cfg, 0)
    check(next(rts.params.parameters()).device.type == "cuda", "phase 22d: REINFORCE params not on the card")
    hist = []
    for i in range(100):
        rts, m = reinforce.train_epoch(rf_env, rf_cfg, rts, i, 100)
        hist.append(float(m["mean_episode_reward"]))
    check(sum(_build.launch_counts.values()) == 0, f"phase 22d: REINFORCE launched {dict(_build.launch_counts)}")
    first10, last10 = statistics.mean(hist[:10]), statistics.mean(hist[-10:])
    print(f"phase 22d REINFORCE on the card: first 10 epochs {first10}, last 10 {last10}, random policy {rand}, "
          f"{time.perf_counter() - t0:.1f} s")
    check(last10 > first10 + 0.3, f"phase 22d: REINFORCE did not improve: {first10} -> {last10}")
    check(last10 > rand + 1.0, f"phase 22d: REINFORCE {last10} does not beat the random policy {rand} by 1.0")

    # ---- phase 22e: the reward-scaling simulation on K5's fixed kind, held
    # to the engine's within 4 standard errors; at 100,000 trajectories the
    # dispatch takes the engine for the lane rule
    t0 = time.perf_counter()
    sc_cfg = as_env_config(num_trajectories=64)
    sim, pol = reward_scaling.inventory_neutral_simulation(sc_cfg, SCALING_N)
    decision = dispatch_report(sim, pol, mode="rollout", platform=dev)
    check((decision.backend, decision.family) == ("fused", "fixed"), f"phase 22e dispatch: {decision}")
    _build.reset_launch_counts()
    scaled = with_normalised_rewards(sc_cfg, 7, SCALING_N)
    torch.cuda.synchronize()
    counts = {name: c for name, c in _build.launch_counts.items() if c}
    check(counts == {"det_rollout": 1}, f"phase 22e: with_normalised_rewards launches {counts}")
    add_launches()
    episodes = rollout(sim, pol, None, 8, backend="engine").trajectory.rewards.sum(dim=0)
    e_mean, se = float(episodes.mean()), float(episodes.std()) * (2.0 / SCALING_N) ** 0.5
    k5_mean = 1.0 / scaled.reward_scaling
    print(f"phase 22e reward scaling at {SCALING_N}x{sc_cfg.n_steps}: {scaled.reward_scaling} (K5 x1); mean "
          f"inventory-neutral episode reward {k5_mean} vs engine {e_mean}, {abs(k5_mean - e_mean) / se:.2f} se")
    check(abs(k5_mean - e_mean) <= 4 * se, f"phase 22e: K5 {k5_mean} vs engine {e_mean}, se {se}")
    big = dispatch_report(*reward_scaling.inventory_neutral_simulation(sc_cfg, 100_000), mode="rollout", platform=dev)
    check(big.backend == "engine" and "multiple of 128" in big.reason, f"phase 22e at 100,000: {big}")
    print(f"phase 22e at 100,000 trajectories: {big.backend} ({big.reason}); ok in {time.perf_counter() - t0:.1f} s")

    print(f"phase 22 launches on the CJ learning path (22b, 22e): { {k: c for k, c in path.items() if c} }")
    for name in ("mlp_rollout", "ppo_fused_grads_T", "det_rollout"):
        check(path[name] > 0, f"phase 22: {name} was not launched on the CJ learning path")
    print(f"phase 22 ok in {time.perf_counter() - t_start:.1f} s")
    (cj_ms, cj_call), (pnl_ms, _), cj_plain_ms = k3["shared trunk"]
    return {
        "K3": {"cjmm_launches": path["mlp_rollout"], "cjmm_max_abs_err": err["K3"], "cjmm_ms": cj_ms,
               "cjmm_call_ms": cj_call, "cjmm_plain_ms": cj_plain_ms, "cjmm_pnl_same_call_ms": pnl_ms,
               "cjmm_towers_ms": k3["towers"][0][0], "cjmm_towers_plain_ms": k3["towers"][2],
               "cjmm_towers_pnl_same_call_ms": k3["towers"][1][0]},
        "K4": {"cjmm_launches": path["ppo_fused_grads_T"]},
        "K5": {"cjmm_launches": path["det_rollout"], "e3_max_abs_err": err["K5"]},
    }


# ------------------------------------------------------------------ lam / touch
CANON_N, CANON_ITERATIONS, CANON_BAR = 4096, 200, 40.0  # tests/test_convergence.py:249
# Operations per env-step of K5's fixed kind, counted as OPS_PER_ENV_STEP_K1
# is: two Philox calls (196), six 24-bit uniforms (18), Box-Muller (7),
# step time (3), then on lam dynamics two fill probabilities (2),
# arrivals/fills/masks (14), the market orders with their mask (6),
# bookkeeping with them and the clips (16), the price move (3), PnL and
# the running reward (14), the reward and spread sums (3); at the touch
# arrivals and the post masks (8), bookkeeping and the clips (12) in place
# of the fills, market orders and lam's bookkeeping.
OPS_PER_ENV_STEP_K5_LAM = 196 + 18 + 7 + 3 + 2 + 14 + 6 + 16 + 3 + 14 + 3
OPS_PER_ENV_STEP_K5_TOUCH = 196 + 18 + 7 + 3 + 8 + 12 + 3 + 14 + 3


def two_action_copy(torch, params, dev):
    """A copy of the actor-critic ``params`` with its action head cut to
    the first two pi rows (and their log_std): the same trunk for a K3
    limit-kind run beside a lam-kind one."""
    from mbt_gym_torch.agents.networks import init_actor_critic

    model = init_actor_critic(0, params.obs_dim, 2, hidden=params.hidden, shared_trunk=params.shared_trunk,
                              device=dev)
    source = dict(params.named_parameters())
    with torch.no_grad():
        for name, t in model.named_parameters():
            t.copy_(source[name][:t.shape[0]])
    return model


def lam_touch_phases(torch, np, card, dev, k3_pnl_ms=None):
    """Phase 23: the limit-and-market-order ("lam") and at-the-touch
    ("touch") families and the reference's canonical learning env.  (a)
    K3's lam, touch and canonical kinds (A = 4 with the inv0 plane and the
    CjMm reward) at full width, K4 at A = 4 and K5's fixed kind on lam and
    touch against their plain versions, each launched twice bitwise; (b)
    the fully fused PPO path learns the canonical env to the JAX TPU gate's
    bar (tests/test_convergence.py:249) beside the closed-form no-MO CJ
    baseline; (c) one fused iteration at full width on bench_suite configs
    7, 8 and 9, both layouts, the engine iteration on config 8, and each
    new K3 kind's device time beside K3 PnL on the same params; (d)
    ``mc_episode_stats``/``rollout`` of fixed actions on lam and touch
    through ``backend="auto"`` (K5) against the engine; (e) the new
    instantiations' registers, spills and tensor-core instructions.
    Returns the kernels-line figures of K3, K4 and K5 by kernel."""
    import dataclasses
    import re

    from mbt_gym_torch import (
        CarteaJaimungalMmAgent, as_env_config, dispatch_report, mc_episode_stats, rollout,
    )
    from mbt_gym_torch.agents.baseline import fixed_action_policy, no_market_order_policy
    from mbt_gym_torch.agents.networks import init_actor_critic
    from mbt_gym_torch.agents.ppo import (
        PPOConfig, compute_gae, deterministic_policy, evaluate_policy, init_train_state, normalise, train_iteration,
    )
    from mbt_gym_torch.ops import _build
    from mbt_gym_torch.ops import det_rollout as det
    from mbt_gym_torch.ops import fused_ppo
    from mbt_gym_torch.ops import mlp_rollout as mr
    from mbt_gym_torch.utils.config import lam_env_config, learning_env_config, touch_env_config

    t_start = time.perf_counter()
    obs_norm = dict(normalise_observation_space=True)
    # bench_suite configs 7, 8 and 9 (scripts/bench_suite.py:203-252)
    configs = {
        "touch": dataclasses.replace(touch_env_config(num_trajectories=PPO_N), **obs_norm),
        "lam": dataclasses.replace(lam_env_config(num_trajectories=PPO_N), **obs_norm),
        "canonical": dataclasses.replace(learning_env_config(num_trajectories=PPO_N), **obs_norm),
    }
    models = {(kind, layout): init_actor_critic(5, 4, cfg.action_dim, hidden=(256, 256),
                                                shared_trunk=layout == "shared trunk", device=dev)
              for kind, cfg in configs.items() for layout in ("shared trunk", "towers")}

    def inv0_for(p, n, seed):
        if not p.inventory_range:
            return None
        gen = torch.Generator(dev).manual_seed(seed)
        return torch.randint(*p.inventory_range, (n,), generator=gen, device=dev).to(torch.float32)

    # ---- phase 23a: K3's new kinds at full width in native mode (the lam
    # kind's third Philox call) and at 4,096 envs on injected channels,
    # both layouts, at phase 8's limits (touch: its continuous fills
    # compared to the same tolerance); K4 at A = 4 on the lam rollout's
    # first minibatch at phase 9's limits; K5's fixed kind on lam (with and
    # without the market-order mask) and touch at 16,384 x 200 at phase
    # 14's limits.  Each launched twice, bitwise.
    t0 = time.perf_counter()
    err = {"K3": 0.0, "K4": 0.0, "K5": 0.0}
    plain_k3_ms = {}  # the plain version's time at full width (CUDA events around its one call)
    lam_rollout = None
    for kind, cfg in configs.items():
        p = mr.rollout_params_from_config(cfg)
        check((p.dynamics_kind, p.a_dim) == ({"touch": "touch"}.get(kind, "lam"), cfg.action_dim),
              f"phase 23a: {kind} params {p}")
        for layout in ("shared trunk", "towers"):
            model = models[(kind, layout)]
            for n, mode in ((PPO_N, "native"), (CJ_SMALL_N, "noise")):
                kw = ({"seed": 35, "device": dev} if mode == "native" else
                      {"noise": mr.philox_noise(36, p.run_steps, n, dev, p.a_dim) * 1.0})
                inv0 = inv0_for(p, n, 37)
                got = mr.mlp_rollout(p, model, num_trajectories=n, inv0=inv0, **kw)
                again = mr.mlp_rollout(p, model, num_trajectories=n, inv0=inv0, **kw)
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                want = mr.mlp_rollout_plain(p, model, num_trajectories=n, inv0=inv0, **kw)
                end.record()
                end.synchronize()
                if n == PPO_N:
                    plain_k3_ms[(kind, layout)] = start.elapsed_time(end)
                at = f"phase 23a K3 {kind} {layout} {mode} at {n}x{p.run_steps}"
                err["K3"] = max(err["K3"], compare_rollouts(torch, got, want, n, at, continuous=kind == "touch"))
                check_repeat(torch, rollout_outputs(got), rollout_outputs(again), at)
                if kind == "lam" and layout == "shared trunk" and mode == "native":
                    check(bool((got[1][:, 2:] > 0.5).any()), "phase 23a: no market order fired on lam")
                    lam_rollout = got
                del got, again, want
    obs_t, actions_t, log_probs, values, rewards = lam_rollout
    adv, returns = compute_gae(rewards, values, torch.zeros_like(values[0]), 1.0, 0.95)
    nb = PPO_N // PPO_MINIBATCHES
    mb_a4 = [x[..., :nb] for x in (obs_t, actions_t, log_probs, adv, returns)]
    mb_a4[3] = normalise(mb_a4[3])
    moved = init_actor_critic(5, 4, 4, hidden=(256, 256), shared_trunk=True, device=dev)
    with torch.no_grad():
        moved.log_std.add_(0.05)
    for dtype in ("float32", "bfloat16"):
        grads, metrics = fused_ppo.ppo_fused_grads_T(moved, *mb_a4, compute_dtype=dtype)
        again = fused_ppo.ppo_fused_grads_T(moved, *mb_a4, compute_dtype=dtype)
        want_g, want_m = fused_ppo.ppo_fused_grads_T_plain(moved, *mb_a4, compute_dtype=dtype)
        torch.cuda.synchronize()
        at = f"phase 23a K4 A=4 {dtype} at {STEPS}x{nb}"
        err["K4"] = max(err["K4"], compare_grads(torch, grads, metrics, want_g, want_m, dtype, at))
        check_repeat(torch, (grads, metrics), again, at)
    del lam_rollout, obs_t, actions_t, log_probs, values, rewards, adv, returns, again
    k5_cases = {
        "lam": det.fixed_rollout_params(lam_env_config(num_trajectories=N_MAIN), [0.6, 0.6, 0.7, 0.2]),
        "lam mask": det.fixed_rollout_params(dataclasses.replace(
            lam_env_config(num_trajectories=N_MAIN, max_inventory=3.0), mask_market_orders_at_max_inventory=True),
            [0.6, 0.6, 0.7, 0.0]),
        "touch": det.fixed_rollout_params(touch_env_config(num_trajectories=N_MAIN), [1.0, 0.5]),
    }
    for label, p in k5_cases.items():
        rng = np.random.default_rng(38)
        c = rng.uniform(size=(p.run_steps, 5, N_MAIN)).astype(np.float32)
        c[:, 4] = rng.normal(size=(p.run_steps, N_MAIN)).astype(np.float32)
        for mode, kw in (("noise", {"noise": torch.from_numpy(c).to(dev)}), ("native", {"seed": 44, "device": dev})):
            for stats in (True, False):
                extra = {"stats_only": stats, "final_obs": not stats}
                got = det.fixed_rollout(p, num_trajectories=N_MAIN, **kw, **extra)
                again = det.fixed_rollout(p, num_trajectories=N_MAIN, **kw, **extra)
                want = det.fixed_rollout_plain(p, num_trajectories=N_MAIN, **kw, **extra)
                torch.cuda.synchronize()
                at = f"phase 23a K5 fixed {label} {'stats' if stats else 'streams'} {mode} at {N_MAIN}x{p.run_steps}"
                err["K5"] = max(err["K5"], compare_outputs(torch, got, want, N_MAIN, at, streams=not stats))
                check_repeat(torch, (dict(enumerate(got)),), (dict(enumerate(again)),), at)
        del got, again, want
    print(f"phase 23a ok in {time.perf_counter() - t0:.1f} s")

    # ---- phase 23b: the canonical learning gate (tests/test_convergence.py:
    # 249, JAX's TPU-only gate): 4,096 envs, max_inventory 20, normalised
    # observations, 256x256 shared trunk, 1 epoch of 4 minibatches, lr
    # 1e-3, 200 fully fused iterations; the best mean episode reward must
    # exceed 40.  Launch counts per iteration (K3 x1, K4 x4, nothing else),
    # metric bands on each; the closed-form no-MO CJ agent on the engine
    # beside it (examples/train_canonical.py's baseline).  Then
    # evaluate_policy(backend="auto") goes to K3, inv0 drawn per episode.
    t0 = time.perf_counter()
    path = {name: 0 for name in _build.launch_counts}

    def add_launches():
        for name, c in _build.launch_counts.items():
            path[name] += c

    raw = dataclasses.replace(learning_env_config(num_trajectories=CANON_N), max_inventory=20.0)
    canon = dataclasses.replace(raw, **obs_norm)
    cj = CarteaJaimungalMmAgent.from_config(raw, max_inventory=20)
    cj_policy = no_market_order_policy(cj.policy())
    check(dispatch_report(raw, cj_policy).backend == "engine", "phase 23b: the no-MO CJ policy left the engine")
    baseline = statistics.mean(float(rollout(raw, cj_policy, None, 700 + e).trajectory.rewards.sum(dim=0).mean())
                               for e in range(8))
    canon_cfg = PPOConfig(hidden=(256, 256), n_epochs=1, n_minibatches=4, shuffle=False, shared_trunk=True,
                          fused_rollout=True, fused_update=True, learning_rate=1e-3)
    ts = init_train_state(canon, canon_cfg, 0)
    check(next(ts.params.parameters()).device.type == "cuda", "phase 23b: params not on the card")
    per_iteration = {"mlp_rollout": 1, "ppo_fused_grads_T": canon_cfg.n_minibatches}
    history = []
    t1 = time.perf_counter()
    for i in range(CANON_ITERATIONS):
        _build.reset_launch_counts()
        ts, metrics = train_iteration(canon, canon_cfg, ts, i)
        counts = dict(_build.launch_counts)
        want = {name: per_iteration.get(name, 0) for name in counts}
        check(counts == want, f"phase 23b iteration {i + 1}: launches {counts}, want {want}")
        add_launches()
        history.append(assert_metric_bands(metrics, f"phase 23b iteration {i + 1}")["mean_episode_reward"])
    best = max(history)
    print(f"phase 23b [{card}] fused PPO on the canonical env at {CANON_N}x{canon.n_steps}: {CANON_ITERATIONS} "
          f"iterations in {time.perf_counter() - t1:.1f} s, mean_episode_reward first 5 {history[:5]}, last 5 "
          f"{history[-5:]}, best {best} (bar {CANON_BAR}); closed-form no-MO CJ baseline on the engine {baseline} "
          f"(mean of 8 episodes), best / baseline {best / baseline:.3f}")
    decision = dispatch_report(canon, deterministic_policy(canon), mode="evaluate", platform=dev,
                               policy_params=ts.params)
    check((decision.backend, decision.family) == ("fused", "mlp_rollout"), f"phase 23b evaluate dispatch: {decision}")
    _build.reset_launch_counts()
    auto = float(evaluate_policy(canon, ts.params, 50, n_episodes=4))
    torch.cuda.synchronize()
    counts = {name: c for name, c in _build.launch_counts.items() if c}
    check(counts == {"mlp_rollout": 4}, f"phase 23b evaluate_policy(auto) launches {counts}")
    add_launches()
    engine = float(evaluate_policy(canon, ts.params, 51, n_episodes=4, backend="engine"))
    with torch.no_grad():
        spread = rollout(canon, deterministic_policy(canon), ts.params, 52, backend="engine").trajectory.rewards.sum(0)
    se = float(spread.std()) * (2.0 / (4 * CANON_N)) ** 0.5
    print(f"phase 23b evaluate_policy of the trained policy, 4 episodes each: auto (K3 x4) {auto}, engine {engine}, "
          f"{abs(auto - engine) / se:.2f} se")
    check(abs(auto - engine) <= 4 * se, f"phase 23b: evaluate_policy auto {auto} vs engine {engine}, se {se}")
    check(best > CANON_BAR, f"phase 23b: fused PPO best {best} not above {CANON_BAR}")
    del ts
    print(f"phase 23b ok in {time.perf_counter() - t0:.1f} s")

    # ---- phase 23c: bench_suite configs 7, 8 and 9 at full width (262,144
    # envs, 256x256, 16 minibatches, bf16): one fused iteration per config
    # and layout (launches checked, metric bands), one timed, one profiled;
    # the engine iteration on config 8 (shared trunk); each new K3 kind's
    # device time beside K3 PnL on the same params in this call (the plain
    # version's time is 23a's)
    t0 = time.perf_counter()
    k3 = {}
    for kind, cfg in configs.items():
        env_steps = PPO_N * cfg.n_steps
        p = mr.rollout_params_from_config(cfg)
        for layout in ("shared trunk", "towers"):
            pcfg = PPOConfig(hidden=(256, 256), n_epochs=1, n_minibatches=PPO_MINIBATCHES, shuffle=False,
                             compute_dtype="bfloat16", shared_trunk=layout == "shared trunk", fused_rollout=True,
                             fused_update=True)
            ts = init_train_state(cfg, pcfg, 70)
            _build.reset_launch_counts()
            ts, metrics = train_iteration(cfg, pcfg, ts, 71)
            torch.cuda.synchronize()
            counts = {name: c for name, c in _build.launch_counts.items() if c}
            check(counts == {"mlp_rollout": 1, "ppo_fused_grads_T": PPO_MINIBATCHES},
                  f"phase 23c {kind} {layout}: launches {counts}")
            assert_metric_bands(metrics, f"phase 23c {kind} {layout}")
            ms = cuda_ms(torch, lambda: train_iteration(cfg, pcfg, ts, 72), warmup=0, reps=1)
            print(f"phase 23c [{card}] fused train_iteration on {kind} ({PPO_N}x{cfg.n_steps}, 16 minibatches), "
                  f"{layout}: {ms} ms = {env_steps / ms * 1e3} env-steps/s")
            profile_iteration(torch, card, f"fused train_iteration on {kind}, {layout}, at {PPO_N}x{cfg.n_steps}",
                              lambda: train_iteration(cfg, pcfg, ts, 73), phase=23)
            if kind == "lam" and layout == "shared trunk":
                engine_cfg = dataclasses.replace(pcfg, fused_rollout=False, fused_update=False)
                e_ms = cuda_ms(torch, lambda: train_iteration(cfg, engine_cfg, ts, 74), warmup=1, reps=1)
                print(f"phase 23c [{card}] engine train_iteration on lam ({PPO_N}x{cfg.n_steps}), {layout}: {e_ms} "
                      f"ms = {env_steps / e_ms * 1e3} env-steps/s")
                profile_iteration(torch, card, f"engine train_iteration on lam, {layout}, at {PPO_N}x{cfg.n_steps}",
                                  lambda: train_iteration(cfg, engine_cfg, ts, 75), phase=23)
            params = ts.params
            inv0 = inv0_for(p, PPO_N, 76)
            kind_ms = kernel_ms(torch, lambda: mr.mlp_rollout(p, params, 9, PPO_N, device=dev, inv0=inv0),
                                warmup=1, reps=5, label=f"phase 23c K3 {kind} {layout} at {PPO_N}x{cfg.n_steps}")
            # K3 PnL (limit dynamics, the normalised AS env of phase 12 at
            # this horizon) on the same trunk; lam's head cut to its first
            # two pi rows
            pnl_p = mr.rollout_params_from_config(dataclasses.replace(
                as_env_config(num_trajectories=PPO_N, n_steps=cfg.n_steps), **obs_norm))
            pnl_model = two_action_copy(torch, params, dev)
            pnl = kernel_ms(torch, lambda: mr.mlp_rollout(pnl_p, pnl_model, 9, PPO_N, device=dev), warmup=1, reps=5,
                            label=f"phase 23c K3 pnl {layout} at {PPO_N}x{pnl_p.run_steps}")
            plain_ms = plain_k3_ms[(kind, layout)]
            k3[(kind, layout)] = (kind_ms, pnl, plain_ms, cfg.n_steps)
            print(f"phase 23c [{card}] K3 {kind} {layout} at {PPO_N}x{cfg.n_steps}: {kind_ms[0]} ms on the device "
                  f"(call {kind_ms[1]} ms), plain {plain_ms} ms; PnL (limit, A = 2) on the same trunk at "
                  f"{PPO_N}x{pnl_p.run_steps} {pnl[0]} ms (call {pnl[1]} ms)"
                  + (f"; phase 12's PnL K3 {k3_pnl_ms} ms" if layout == "shared trunk" and k3_pnl_ms else ""))
            del ts, params
    # K4 at A = 4: one bf16 minibatch of the lam rollout
    k4_ms = kernel_ms(torch, lambda: fused_ppo.ppo_fused_grads_T(moved, *mb_a4), warmup=2, reps=10,
                      label=f"phase 23c K4 A=4 at {STEPS}x{nb}")
    k4_plain_ms = cuda_ms(torch, lambda: fused_ppo.ppo_fused_grads_T_plain(moved, *mb_a4), warmup=1, reps=3)
    k4_bound = bound_ms((4 + 4 + 3) * 4 * STEPS * nb, ppo_grad_flops_per_sample(4, 256, 256, 4) * STEPS * nb,
                        BF16_OPS_PER_S)
    print(kernel_row("23c", card, "K4 ppo_fused_grads_T A=4 bf16 (one minibatch)", f"{STEPS}x{nb}", STEPS * nb,
                     *k4_ms, *k4_bound, k4_plain_ms))
    del mb_a4
    print(f"phase 23c ok in {time.perf_counter() - t0:.1f} s")

    # ---- phase 23d: serving fixed actions on lam and touch through the
    # public entry points: backend="auto" takes K5 (stats mode and
    # streams), within 4 standard errors of the engine on independent
    # streams; touch reports post_rate.  Then each K5 kind timed.
    t0 = time.perf_counter()
    k5 = {}
    for label, cfg, action in (("lam", lam_env_config(num_trajectories=N_MAIN), [0.6, 0.6, 0.7, 0.2]),
                               ("touch", touch_env_config(num_trajectories=N_MAIN), [1.0, 0.5])):
        pol = fixed_action_policy(action)
        for mode in ("rollout", "stats"):
            d = dispatch_report(cfg, pol, mode=mode, platform=dev)
            check((d.backend, d.family) == ("fused", "fixed"), f"phase 23d {label} dispatch ({mode}): {d}")
        _build.reset_launch_counts()
        fused = mc_episode_stats(cfg, pol, None, 80, episodes=2)
        traj = rollout(cfg, pol, None, 81).trajectory
        torch.cuda.synchronize()
        counts = {name: c for name, c in _build.launch_counts.items() if c}
        check(counts == {"det_rollout": 3}, f"phase 23d {label}: launches {counts}")
        add_launches()
        engine = mc_episode_stats(cfg, pol, None, 82, episodes=2, backend="engine")
        n = 2 * N_MAIN
        streams = traj.rewards.sum(dim=0)
        for key, a, b, n_a in (("mean_pnl", fused["mean_pnl"], engine["mean_pnl"], n),
                               ("rollout mean_pnl", streams.mean(), engine["mean_pnl"], N_MAIN)):
            se = float(engine["std_pnl"]) * (1.0 / n + 1.0 / n_a) ** 0.5
            print(f"phase 23d {label} {key}: auto (K5) {float(a)} vs engine {float(b)}, {abs(float(a - b)) / se:.2f} se")
            check(abs(float(a - b)) <= 4 * se, f"phase 23d {label} {key}: {float(a)} vs {float(b)}, se {se}")
        if label == "touch":
            check(np.isnan(float(fused["mean_spread"])) and float(fused["post_rate"]) == 0.75
                  and float(engine["post_rate"]) == 0.75, f"phase 23d touch stats {fused}, engine {engine}")
            print(f"phase 23d touch post_rate: auto {float(fused['post_rate'])}, engine {float(engine['post_rate'])}")
        p = det.fixed_rollout_params(cfg, action)
        for stats in (True, False):
            ms = kernel_ms(torch, lambda: det.fixed_rollout(p, 9, N_MAIN, stats_only=stats, final_obs=not stats,
                                                            device=dev), warmup=2, reps=10)
            plain_ms = cuda_ms(torch, lambda: det.fixed_rollout_plain(p, 9, N_MAIN, stats_only=stats,
                                                                     final_obs=not stats, device=dev),
                               warmup=1, reps=1)
            ops = (OPS_PER_ENV_STEP_K5_LAM if label == "lam" else OPS_PER_ENV_STEP_K5_TOUCH) * N_MAIN * STEPS
            s_dim, a_dim = 4, len(action)
            floats = 5 if stats else STEPS * (s_dim + a_dim + 3) + s_dim
            b = bound_ms(4 * floats * N_MAIN, ops, FP32_OPS_PER_S)
            k5[(label, stats)] = (ms, plain_ms, b)
            print(kernel_row("23d", card, f"K5 fixed {label} {'stats' if stats else 'streams'}", f"{N_MAIN}x{STEPS}",
                             N_MAIN * STEPS, *ms, *b, plain_ms))
    print(f"phase 23d ok in {time.perf_counter() - t0:.1f} s")

    # ---- phase 23e: the new instantiations' registers and spills (ptxas
    # -v of the builds above): K3's lam and touch kinds (template argument
    # kDyn 1 and 2), K5's lam and touch fixed kinds (kDyn 2 and 3), on the
    # plain processes (kProc 0); none spills.  HMMA > 0 in K3's bf16 lam instantiation.
    k3_rows = kernel_registers(_build.ptxas_reports.get("mlp_rollout.cu", ""), ("mlp_rollout_kernel",))
    k5_rows = kernel_registers(_build.ptxas_reports.get("det_rollout.cu", ""), ("det_rollout_kernel",))
    new_k3 = [(e, u) for e, u in k3_rows if re.search(r"ILb[01]ELi[12]ELi0E", e)]
    new_k5 = [(e, u) for e, u in k5_rows if re.search(r"ILb[01]ELi[23]ELi1ELb[01]ELb[01]ELi0E", e)]
    check(len(new_k3) == 4 and len(new_k5) == 16,
          f"phase 23e: {len(new_k3)} new K3 and {len(new_k5)} new K5 instantiations, not 4 and 16")
    for entry, usage in new_k3 + new_k5:
        print(f"phase 23e registers {entry[:100]}: {usage}")
        check(spill_bytes(usage) == 0, f"phase 23e: {entry} spills: {usage}")
    import shutil
    from pathlib import Path

    cuobjdump = shutil.which("cuobjdump") or str(Path(_build.nvcc()).parent / "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(_build.build("mlp_rollout.cu"))], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    hmma = {e: n for e, n in sass_counts(sass, "HMMA", ("mlp_rollout_kernel",)).items() if "ILb1ELi1ELi0E" in e}
    check(len(hmma) == 1 and all(n > 0 for n in hmma.values()), f"phase 23e: HMMA in K3's bf16 lam kind {hmma}")
    print(f"phase 23e K3 bf16 lam instantiation: {list(hmma.values())[0]} HMMA")

    print(f"phase 23 launches on the slice's main path (23b, 23d): { {k: c for k, c in path.items() if c} }")
    for name in ("mlp_rollout", "ppo_fused_grads_T", "det_rollout"):
        check(path[name] > 0, f"phase 23: {name} was not launched on the slice's main path")
    print(f"phase 23 ok in {time.perf_counter() - t_start:.1f} s")
    figures = {"K3": {"lam_touch_canonical_launches": path["mlp_rollout"], "lam_touch_canonical_max_abs_err": err["K3"]},
               "K4": {"a4_launches": path["ppo_fused_grads_T"], "a4_max_abs_err": err["K4"], "a4_ms": k4_ms[0],
                      "a4_call_ms": k4_ms[1], "a4_plain_ms": k4_plain_ms, "a4_bound_ms": k4_bound[0]},
               "K5": {"lam_touch_launches": path["det_rollout"], "lam_touch_max_abs_err": err["K5"]}}
    for (kind, layout), (kind_ms, pnl, plain_ms, steps) in k3.items():
        tag = f"{kind}_{'towers' if layout == 'towers' else 'shared'}"
        a_dim = configs[kind].action_dim
        b = bound_ms((4 + a_dim + 3) * 4 * PPO_N * steps,
                     mlp_flops_per_sample(4, 256, 256, a_dim, towers=1 if layout == "shared trunk" else 2)
                     * PPO_N * steps, BF16_OPS_PER_S)
        figures["K3"].update({f"{tag}_ms": kind_ms[0], f"{tag}_call_ms": kind_ms[1], f"{tag}_plain_ms": plain_ms,
                              f"{tag}_pnl_same_call_ms": pnl[0], f"{tag}_bound_ms": b[0]})
    for (label, stats), ((ms, call), plain_ms, b) in k5.items():
        tag = f"fixed_{label}_{'stats' if stats else 'streams'}"
        figures["K5"].update({f"{tag}_ms": ms, f"{tag}_call_ms": call, f"{tag}_plain_ms": plain_ms,
                              f"{tag}_bound_ms": b[0]})
    return figures


# ------------------------------------------------------------------ process zoo
COMPOSITE_N = 262_144  # bench_suite config 10 (scripts/bench_suite.py:252-264)
COMPOSITE_EVAL_N = 65_536  # bench_suite configs 4 and 14 (:161-169, :349-380)
KIND_N = 16_384
COMPOSITE_ITERATIONS = 6
COMPOSITE_EPISODES = 8
COMPOSITE_ACTION = (0.6, 0.6, 0.0, 0.0)  # config 4's fixed quotes, no market orders
# Operations per env-step of K5's fixed kind on the composite config,
# counted as OPS_PER_ENV_STEP_K1 is: two Philox calls (196), eight 24-bit
# uniforms (24), two Box-Muller pairs with both sines (18), step time (3),
# Hawkes thinning (4) and its step (12), the exogenous fill probabilities
# (10) and the exogenous depths' OU step (10), fills and masks (10), the
# market orders with their mask (6), bookkeeping and the clips (16), the
# price move (3), PnL and the running reward (14), the reward and spread
# sums (3).
OPS_PER_ENV_STEP_K5_COMPOSITE = 196 + 24 + 18 + 3 + 4 + 12 + 10 + 10 + 10 + 6 + 16 + 3 + 14 + 3


class general_instantiation:
    """Within it, the composite stress family runs K5's general
    instantiation (its kinds read at run time) instead of its own (its
    kinds fixed at compile time), for holding the two to each other."""

    def __enter__(self):
        from mbt_gym_torch.ops import proc_kinds as pk

        self.pk, self.mode = pk, pk.proc_mode
        pk.proc_mode = lambda p, composite_ok: self.mode(p, False)

    def __exit__(self, *exc):
        self.pk.proc_mode = self.mode


def hawkes_fixed_point(p):
    """The Hawkes intensity's stationary mean under per-step thinning at
    the current intensity: E[l'] = l + m (b - l) dt + j l dt, so
    l* = b m / (m - j) (tests/test_pallas_rollout.py:1389-1395)."""
    return p.intensity_bid * p.hawkes_mean_reversion / (p.hawkes_mean_reversion - p.hawkes_jump)


def narrow_copy(torch, params, s_dim, a_dim, dev):
    """A copy of the actor-critic ``params`` for ``s_dim`` observation
    columns and ``a_dim`` actions: the block of each parameter that both
    shapes hold is copied (the first observation columns, the first action
    rows), any row past ``params``' keeps a seeded init.  The same inner
    trunk for a K3 run on another config beside the first one."""
    from mbt_gym_torch.agents.networks import init_actor_critic

    model = init_actor_critic(0, s_dim, a_dim, hidden=params.hidden, shared_trunk=params.shared_trunk, device=dev)
    source = dict(params.named_parameters())
    with torch.no_grad():
        for name, t in model.named_parameters():
            src = source[name]
            block = tuple(slice(0, min(a, b)) for a, b in zip(t.shape, src.shape))
            t[block] = src[block]
    return model


def kind_configs(n=None, steps=STEPS):
    """{name: EnvConfig} of every process kind beyond the plain ones, at
    ``n`` envs (KIND_N) x ``steps``: the nine other midprice models, the
    exact-probability Poisson arrivals and the triangular and power fills
    on the AS config, the exogenous-MM fills with BM and GBM sides on the
    composite config, and the all-axes config (Heston + Hawkes +
    exogenous MM + lam, S = 9)."""
    import dataclasses

    from mbt_gym_torch import processes as pc
    from mbt_gym_torch.utils.config import as_env_config, composite_env_config

    n = n or KIND_N

    def with_(cfg, **dyn):
        return dataclasses.replace(cfg, dynamics=dataclasses.replace(cfg.dynamics, **dyn))

    base = as_env_config(num_trajectories=n, n_steps=steps)
    alpha = pc.OuMidprice(initial_price=0.5, mean_reversion_level=0.0, mean_reversion_speed=2.0, volatility=1.0,
                          dt_scaled_drift=True)
    mids = {
        "constant": pc.ConstantMidprice(),
        "gbm": pc.GeometricBrownianMotionMidprice(drift=0.5, volatility=0.02),
        "ou": pc.OuMidprice(mean_reversion_level=100.0, mean_reversion_speed=2.0, volatility=2.0),
        "cev": pc.CevMidprice(drift=0.2, volatility=0.05, gamma=0.7),
        "bmjump": pc.BrownianMotionJumpMidprice(jump_size=0.5),
        "oujump": pc.OuJumpMidprice(mean_reversion_level=100.0, mean_reversion_speed=2.0, jump_size=0.5,
                                    dt_scaled_drift=True),
        "heston": pc.HestonMidprice(),
        "st_ou_alpha": pc.ShortTermOuAlphaMidprice(ou=alpha),
        "st_jump_alpha": pc.ShortTermJumpAlphaMidprice(ou_jump=pc.OuJumpMidprice(
            initial_price=0.5, mean_reversion_speed=2.0, volatility=1.0, jump_size=0.3, dt_scaled_drift=True)),
    }
    out = {f"mid {k}": with_(base, midprice_model=m) for k, m in mids.items()}
    out["poisson_nl"] = with_(base, arrival_model=pc.PoissonArrivalsNonLinear((140.0, 140.0)))
    out["triangular"] = with_(base, fill_probability_model=pc.TriangularFill(max_fill_depth=1.5))
    out["power"] = with_(base, fill_probability_model=pc.PowerFill(fill_exponent=1.5, fill_multiplier=1.2))
    comp = composite_env_config(num_trajectories=n, n_steps=steps)
    out["exomm bm/gbm"] = with_(comp, fill_probability_model=pc.ExogenousMmFill(
        bid_process=pc.BrownianMotionMidprice(initial_price=0.8, drift=0.05, volatility=0.1),
        ask_process=pc.GeometricBrownianMotionMidprice(initial_price=0.8, drift=-0.1, volatility=0.2)))
    out["all axes"] = with_(comp, midprice_model=pc.HestonMidprice())
    return out


def proc_phases(torch, np, card, dev, k3_pnl_ms=None):
    """Phase 24: the rest of the process zoo and the composite stress
    family.  (a) K3 on bench_suite config 10 (``composite_env_config``
    at 262,144 envs, normalised observations, 256x256, bf16), both
    layouts, K5's fixed kind on config 14 (65,536 envs, the fixed quotes
    (0.6, 0.6, 0, 0)) in stats and streams mode, and both kernels on every
    other process kind at 16,384 x 200 (K5 also the table kind on the
    triangular and power fills and the four impact kinds on speed
    dynamics) against their plain versions, in noise and native mode, each
    launched twice bitwise, and K3 on the composite and all-axes configs
    with raw observations (the float32 products); K4 at S = 8 on one
    16,384-env minibatch of each config-10 rollout (float32 and bf16,
    both layouts) against its plain version, launched twice bitwise, and
    timed; (b) the native draws' statistics on the
    composite config under a zero policy (the Hawkes fixed point, the
    exogenous depths' level, standard-normal actions); (c) config 10
    through ``train_iteration``, fully fused, 6 iterations per layout,
    beside the engine iteration, and K3's composite device time beside K3
    lam on the same trunk (the all-axes config trains in phase 29); (d)
    config 14 through ``mc_episode_stats``
    (``backend="auto"``, 8 episodes) against the engine; (e) the new
    instantiations' registers, spills and tensor-core instructions.
    Returns the kernels-line figures of K3, K4 and K5."""
    import dataclasses
    import re

    from mbt_gym_torch import dispatch_report, mc_episode_stats
    from mbt_gym_torch import processes as pc
    from mbt_gym_torch.agents.baseline import CarteaJaimungalMmAgent, CarteaJaimungalOeAgent, fixed_action_policy
    from mbt_gym_torch.agents.networks import init_actor_critic
    from mbt_gym_torch.agents.ppo import (
        PPOConfig, compute_gae, init_train_state, normalise, train_iteration,
    )
    from mbt_gym_torch.ops import _build
    from mbt_gym_torch.ops import det_rollout as det
    from mbt_gym_torch.ops import fused_ppo
    from mbt_gym_torch.ops import mlp_rollout as mr
    from mbt_gym_torch.utils.config import cj_env_config, composite_env_config, lam_env_config, oe_env_config

    t_start = time.perf_counter()
    obs_norm = dict(normalise_observation_space=True)
    config10 = dataclasses.replace(composite_env_config(num_trajectories=COMPOSITE_N), **obs_norm)
    p10 = mr.rollout_params_from_config(config10)
    check((p10.dynamics_kind, p10.arrival_kind, p10.fill_kind, len(p10.obs_low), p10.a_dim, p10.n_channels)
          == ("lam", "hawkes", "exomm", 8, 4, 11), f"phase 24: config 10 params {p10}")
    layouts = ("shared trunk", "towers")
    models = {layout: init_actor_critic(6, 8, 4, hidden=(256, 256), shared_trunk=layout == "shared trunk",
                                        device=dev) for layout in layouts}
    small_models = {}

    def model_for(s_dim, a_dim):
        if (s_dim, a_dim) not in small_models:
            small_models[(s_dim, a_dim)] = init_actor_critic(7, s_dim, a_dim, hidden=(256, 256), shared_trunk=True,
                                                             device=dev)
        return small_models[(s_dim, a_dim)]

    def k3_check(p, model, n, label):
        """K3 native and on injected channels against its plain version,
        launched twice; returns the plain version's native time and the
        max abs error."""
        inv0 = None
        if p.inventory_range:
            gen = torch.Generator(dev).manual_seed(37)
            inv0 = torch.randint(*p.inventory_range, (n,), generator=gen, device=dev).to(torch.float32)
        err, plain_ms = 0.0, None
        for mode in ("native", "noise"):
            kw = ({"seed": 35, "device": dev} if mode == "native" else
                  {"noise": mr.philox_noise(36, p.run_steps, n, dev, p.a_dim, p.fill_kind == "exomm", p.has_mid2)})
            got = mr.mlp_rollout(p, model, num_trajectories=n, inv0=inv0, **kw)
            again = mr.mlp_rollout(p, model, num_trajectories=n, inv0=inv0, **kw)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            want = mr.mlp_rollout_plain(p, model, num_trajectories=n, inv0=inv0, **kw)
            end.record()
            end.synchronize()
            if mode == "native":
                plain_ms = start.elapsed_time(end)
            at = f"phase 24a K3 {label} {mode} at {n}x{p.run_steps}"
            err = max(err, compare_rollouts(torch, got, want, n, at))
            check_repeat(torch, rollout_outputs(got), rollout_outputs(again), at)
            del got, again, want
        return plain_ms, err

    def k5_check(p, tables, n, label):
        """K5 in stats and streams mode, native and on injected channels,
        against its plain version, launched twice; returns the plain
        version's native stats time and the max abs error."""
        err, plain_ms = 0.0, None
        rng = np.random.default_rng(38)
        c = rng.uniform(size=(p.run_steps, p.n_channels, n)).astype(np.float32)
        c[:, 4:] = rng.normal(size=(p.run_steps, p.n_channels - 4, n)).astype(np.float32)
        for mode, kw in (("noise", {"noise": torch.from_numpy(c).to(dev)}), ("native", {"seed": 44, "device": dev})):
            for stats in (True, False):
                extra = {"stats_only": stats, "final_obs": not stats}
                got = det.det_rollout(p, tables, num_trajectories=n, **kw, **extra)
                again = det.det_rollout(p, tables, num_trajectories=n, **kw, **extra)
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                want = det.det_rollout_plain(p, tables, num_trajectories=n, **kw, **extra)
                end.record()
                end.synchronize()
                if mode == "native" and stats:
                    plain_ms = start.elapsed_time(end)
                at = f"phase 24a K5 {label} {'stats' if stats else 'streams'} {mode} at {n}x{p.run_steps}"
                err = max(err, compare_outputs(torch, got, want, n, at, streams=not stats))
                check_repeat(torch, (dict(enumerate(got)),), (dict(enumerate(again)),), at)
                del got, again, want
        return plain_ms, err

    # ---- phase 24a: K3 and K5 against their plain versions on every
    # process kind (phases 14 and 23a's limits); K4 at S = 8 on config
    # 10's minibatches (phase 23a's limits)
    t0 = time.perf_counter()
    err = {"K3": 0.0, "K4": 0.0, "K5": 0.0}
    plain = {}
    k4 = {}
    nb = COMPOSITE_N // PPO_MINIBATCHES
    for layout in layouts:
        plain[("K3", layout)], e = k3_check(p10, models[layout], COMPOSITE_N, f"config 10 {layout}")
        err["K3"] = max(err["K3"], e)
        e = k3_check(p10, models[layout], CJ_SMALL_N, f"config 10 {layout}")[1]
        err["K3"] = max(err["K3"], e)
        # the first of config 10's 16 minibatches, as train_iteration cuts
        # them from this layout's K3 rollout
        obs_t, actions_t, log_probs, values, rewards = mr.mlp_rollout(p10, models[layout], 35, COMPOSITE_N,
                                                                      device=dev)
        adv, returns = compute_gae(rewards, values, torch.zeros_like(values[0]), 1.0, 0.95)
        mb = [x[..., :nb] for x in (obs_t, actions_t, log_probs, adv, returns)]
        mb[3] = normalise(mb[3])
        del obs_t, actions_t, log_probs, values, rewards, adv, returns
        moved = copy.deepcopy(models[layout])
        with torch.no_grad():
            moved.log_std.add_(0.05)  # ratios away from 1, so both clip branches occur
        for dtype in ("float32", "bfloat16"):
            grads, metrics = fused_ppo.ppo_fused_grads_T(moved, *mb, compute_dtype=dtype)
            again = fused_ppo.ppo_fused_grads_T(moved, *mb, compute_dtype=dtype)
            want_g, want_m = fused_ppo.ppo_fused_grads_T_plain(moved, *mb, compute_dtype=dtype)
            torch.cuda.synchronize()
            at = f"phase 24a K4 S=8 A=4 {layout} {dtype} at {STEPS}x{nb}"
            err["K4"] = max(err["K4"], compare_grads(torch, grads, metrics, want_g, want_m, dtype, at))
            check_repeat(torch, (grads, metrics), again, at)
            del grads, metrics, again, want_g, want_m
        ms = kernel_ms(torch, lambda: fused_ppo.ppo_fused_grads_T(moved, *mb, compute_dtype="bfloat16"), warmup=2,
                       reps=10, label=f"phase 24a K4 S=8 {layout} at {STEPS}x{nb}")
        plain_ms = cuda_ms(torch, lambda: fused_ppo.ppo_fused_grads_T_plain(moved, *mb, compute_dtype="bfloat16"),
                           warmup=1, reps=3)
        b = bound_ms((8 + 4 + 3) * 4 * STEPS * nb, ppo_grad_flops_per_sample(
            8, 256, 256, 4, towers=1 if layout == "shared trunk" else 2) * STEPS * nb, BF16_OPS_PER_S)
        k4[layout] = (ms, plain_ms, b)
        print(kernel_row("24a", card, f"K4 ppo_fused_grads_T S=8 A=4 bf16 {layout} (one minibatch)", f"{STEPS}x{nb}",
                         STEPS * nb, *ms, *b, plain_ms))
        del mb, moved
    config14 = composite_env_config(num_trajectories=COMPOSITE_EVAL_N)
    p14 = det.fixed_rollout_params(config14, COMPOSITE_ACTION)
    check((p14.n_channels, len(p14.obs_low)) == (7, 8), f"phase 24a: config 14 params {p14}")
    plain["K5"], e = k5_check(p14, (), COMPOSITE_EVAL_N, "fixed config 14")
    err["K5"] = max(err["K5"], e)
    # K5's composite instantiation computes the general one's bits
    for label, run in (("K5 config 14 streams", lambda: det.fixed_rollout(p14, 44, COMPOSITE_EVAL_N, final_obs=True,
                                                                          device=dev)),
                       ("K5 config 14 stats", lambda: det.fixed_rollout(p14, 44, COMPOSITE_EVAL_N, stats_only=True,
                                                                        device=dev))):
        own = run()
        with general_instantiation():
            general = run()
        check_repeat(torch, (dict(enumerate(own)),), (dict(enumerate(general)),),
                     f"phase 24a {label}: the composite instantiation against the general one")
    kinds = kind_configs()
    for name, cfg in kinds.items():
        normalised = dataclasses.replace(cfg, **obs_norm) if name != "mid constant" else cfg
        p = mr.rollout_params_from_config(normalised)
        check(p.n_channels == mr.n_noise_channels(p.a_dim, p.fill_kind == "exomm", p.has_mid2),
              f"phase 24a {name}: {p.n_channels} channels")
        err["K3"] = max(err["K3"], k3_check(p, model_for(cfg.state_dim, cfg.action_dim), KIND_N, name)[1])
        action = COMPOSITE_ACTION if cfg.action_dim == 4 else (0.6, 0.6)
        err["K5"] = max(err["K5"], k5_check(det.fixed_rollout_params(cfg, action), (), KIND_N, f"fixed {name}")[1])
    # raw observations: K3's float32 general instantiation at S = 8 and 9
    for name in ("composite", "all axes"):
        cfg = kinds["all axes"] if name == "all axes" else composite_env_config(num_trajectories=KIND_N)
        err["K3"] = max(err["K3"], k3_check(mr.rollout_params_from_config(cfg), model_for(cfg.state_dim, 4), KIND_N,
                                            f"{name}, raw observations")[1])
    cj_base = cj_env_config(num_trajectories=KIND_N, n_steps=STEPS, max_inventory=10.0)
    agent = CarteaJaimungalMmAgent.from_config(cj_base, max_inventory=10)
    tables = tuple(torch.as_tensor(t, device=dev) for t in det.cj_depth_tables(agent))
    for name, fill in (("triangular", pc.TriangularFill(max_fill_depth=1.5)),
                       ("power", pc.PowerFill(fill_exponent=1.5, fill_multiplier=1.2))):
        cfg = dataclasses.replace(cj_base, dynamics=dataclasses.replace(cj_base.dynamics, fill_probability_model=fill))
        err["K5"] = max(err["K5"], k5_check(det.cj_rollout_params(cfg, agent), tables, KIND_N, f"table {name}")[1])
    oe_base = oe_env_config(num_trajectories=KIND_N)
    oe_agent = CarteaJaimungalOeAgent.from_config(oe_base, alpha=0.01)
    schedule = (det.schedule_table_from_policy(oe_base, oe_agent.policy()).to(dev),)
    for name, dyn in (("power impact", dict(price_impact_model=pc.TemporaryPowerImpact(temporary_impact_exponent=2.0))),
                      ("transient", dict(price_impact_model=pc.TransientImpact(resilience_coefficient=0.5))),
                      ("temp+transient", dict(price_impact_model=pc.TemporaryAndTransientImpact())),
                      ("temp+perm, heston", dict(midprice_model=pc.HestonMidprice()))):
        cfg = dataclasses.replace(oe_base, dynamics=dataclasses.replace(oe_base.dynamics, **dyn))
        err["K5"] = max(err["K5"], k5_check(det.schedule_rollout_params(cfg), schedule, KIND_N,
                                            f"schedule speed {name}")[1])
        err["K5"] = max(err["K5"], k5_check(det.fixed_rollout_params(cfg, (-2.5,)), (), KIND_N,
                                            f"fixed speed {name}")[1])
    print(f"phase 24a ok in {time.perf_counter() - t0:.1f} s: max abs err K3 {err['K3']}, K5 {err['K5']}")

    # ---- phase 24b: native-draw statistics (tests/test_pallas_rollout.py:
    # 1366-1404) on the composite config at 16,384 x 200, raw observations,
    # a zero policy on K3: the Hawkes intensity's tail at its fixed point,
    # the exogenous depths at their OU level, the action channels standard
    # normal
    t0 = time.perf_counter()
    comp = composite_env_config(num_trajectories=KIND_N)
    p = mr.rollout_params_from_config(comp)
    zero = init_actor_critic(0, 8, 4, hidden=(16, 16), shared_trunk=True, device=dev)
    with torch.no_grad():
        for t in zero.parameters():
            t.zero_()
    obs, actions = (x.double() for x in mr.mlp_rollout(p, zero, 4321, KIND_N, device=dev)[:2])
    tail = STEPS // 2
    lam, exo = obs[tail:, 4:6], obs[tail:, 6:8]
    lstar = hawkes_fixed_point(p)
    stats = {"lam_mean": float(lam.mean()), "lam_std": float(lam.std()), "lstar": lstar,
             "exo_mean": float(exo.mean()), "exo_std": float(exo.std()),
             "action_means": actions.mean(dim=(0, 2)).tolist(), "action_stds": actions.std(dim=(0, 2)).tolist()}
    print(f"phase 24b [{card}] native draws on the composite config at {KIND_N}x{STEPS}, zero policy: {stats}")
    check(abs(stats["lam_mean"] / lstar - 1.0) < 0.05 and stats["lam_std"] > 0.5, f"phase 24b Hawkes: {stats}")
    check(abs(stats["exo_mean"] - p.exo_level[0]) < 0.02 and stats["exo_std"] > 0.005, f"phase 24b exo: {stats}")
    check(all(abs(m) < 0.01 for m in stats["action_means"]) and all(abs(s - 1.0) < 0.01 for s in stats["action_stds"]),
          f"phase 24b actions: {stats}")
    print(f"phase 24b ok in {time.perf_counter() - t0:.1f} s")

    # ---- phase 24c: config 10 through train_iteration, fully fused (K3
    # x1, K4 x16 a iteration, nothing else), 6 iterations per layout,
    # metric bands on each, no degradation; one more timed and one
    # profiled; the engine iteration on the shared trunk; K3 composite
    # beside K3 lam on the same trunk (the lam kind's general instantiation
    # and its plain one).  The main path's launches are
    # counted over 24c's iterations and 24d's call.
    t0 = time.perf_counter()
    path = {name: 0 for name in _build.launch_counts}

    def add_launches():
        for name, c in _build.launch_counts.items():
            path[name] += c

    env_steps = COMPOSITE_N * config10.n_steps
    k3 = {}
    iteration_ms = {}
    for layout in layouts:
        pcfg = PPOConfig(hidden=(256, 256), n_epochs=1, n_minibatches=PPO_MINIBATCHES, shuffle=False,
                         compute_dtype="bfloat16", shared_trunk=layout == "shared trunk", fused_rollout=True,
                         fused_update=True)
        ts = init_train_state(config10, pcfg, 90)
        history = []
        for i in range(COMPOSITE_ITERATIONS):
            _build.reset_launch_counts()
            ts, metrics = train_iteration(config10, pcfg, ts, 91 + i)
            torch.cuda.synchronize()
            counts = {name: c for name, c in _build.launch_counts.items() if c}
            check(counts == {"mlp_rollout": 1, "ppo_fused_grads_T": PPO_MINIBATCHES},
                  f"phase 24c {layout} iteration {i + 1}: launches {counts}")
            add_launches()
            history.append(assert_metric_bands(metrics, f"phase 24c {layout} iteration {i + 1}")["mean_episode_reward"])
        early, late = statistics.mean(history[1:3]), statistics.mean(history[-2:])
        print(f"phase 24c {layout}: mean_episode_reward {history}; iterations 2-3 {early}, last 2 {late}")
        check(late >= early - 1.0, f"phase 24c {layout}: PPO degraded, mean reward {early} -> {late}")
        ms = cuda_ms(torch, lambda: train_iteration(config10, pcfg, ts, 97), warmup=0, reps=1)
        iteration_ms[layout] = ms
        print(f"phase 24c [{card}] fused train_iteration on config 10 ({COMPOSITE_N}x{config10.n_steps}, 16 "
              f"minibatches), {layout}: {ms} ms = {env_steps / ms * 1e3} env-steps/s")
        profile_iteration(torch, card, f"fused train_iteration on config 10, {layout}, at {COMPOSITE_N}x"
                          f"{config10.n_steps}", lambda: train_iteration(config10, pcfg, ts, 98), phase=24)
        if layout == "shared trunk":
            engine_cfg = dataclasses.replace(pcfg, fused_rollout=False, fused_update=False)
            e_ms = cuda_ms(torch, lambda: train_iteration(config10, engine_cfg, ts, 99), warmup=1, reps=1)
            iteration_ms["engine"] = e_ms
            print(f"phase 24c [{card}] engine train_iteration on config 10, {layout}: {e_ms} ms = "
                  f"{env_steps / e_ms * 1e3} env-steps/s")
            profile_iteration(torch, card, f"engine train_iteration on config 10, {layout}",
                              lambda: train_iteration(config10, engine_cfg, ts, 100), phase=24)
        params = ts.params
        comp_ms = kernel_ms(torch, lambda: mr.mlp_rollout(p10, params, 9, COMPOSITE_N, device=dev), warmup=1, reps=5,
                            label=f"phase 24c K3 composite {layout} at {COMPOSITE_N}x{p10.run_steps}")
        lam_p = mr.rollout_params_from_config(dataclasses.replace(lam_env_config(num_trajectories=COMPOSITE_N),
                                                                  **obs_norm))
        lam_model = narrow_copy(torch, params, 4, 4, dev)
        lam_ms = kernel_ms(torch, lambda: mr.mlp_rollout(lam_p, lam_model, 9, COMPOSITE_N, device=dev), warmup=1,
                           reps=5, label=f"phase 24c K3 lam {layout} at {COMPOSITE_N}x{lam_p.run_steps}")
        k3[layout] = (comp_ms, lam_ms)
        print(f"phase 24c [{card}] K3 composite {layout} at {COMPOSITE_N}x{p10.run_steps}: {comp_ms[0]} ms on the "
              f"device (call {comp_ms[1]} ms), plain {plain[('K3', layout)]} ms; K3 lam on the same trunk "
              f"{lam_ms[0]} ms (call {lam_ms[1]} ms), composite / lam {comp_ms[0] / lam_ms[0]:.4f}"
              + (f"; phase 12's PnL K3 {k3_pnl_ms} ms" if layout == "shared trunk" and k3_pnl_ms else ""))
        del ts, params
    print(f"phase 24c ok in {time.perf_counter() - t0:.1f} s")

    # ---- phase 24d: config 14 through mc_episode_stats(backend="auto"):
    # K5's fixed kind in stats mode, 8 episodes, within 4 standard errors
    # of the engine; timed and profiled
    t0 = time.perf_counter()
    pol = fixed_action_policy(list(COMPOSITE_ACTION))
    for mode in ("rollout", "stats"):
        d = dispatch_report(config14, pol, mode=mode, platform=dev)
        check((d.backend, d.family) == ("fused", "fixed"), f"phase 24d dispatch ({mode}): {d}")
    _build.reset_launch_counts()
    fused = mc_episode_stats(config14, pol, None, 110, episodes=COMPOSITE_EPISODES)
    torch.cuda.synchronize()
    counts = {name: c for name, c in _build.launch_counts.items() if c}
    check(counts == {"det_rollout": COMPOSITE_EPISODES}, f"phase 24d: launches {counts}")
    add_launches()
    engine = mc_episode_stats(config14, pol, None, 111, episodes=COMPOSITE_EPISODES, backend="engine")
    n = COMPOSITE_EPISODES * COMPOSITE_EVAL_N
    for key, std_key in (("mean_pnl", "std_pnl"), ("mean_terminal_inventory", "std_terminal_inventory")):
        a, b = float(fused[key]), float(engine[key])
        se = float(engine[std_key]) * (2.0 / n) ** 0.5
        print(f"phase 24d config 14 {key}: auto (K5) {a} vs engine {b}, {abs(a - b) / se:.2f} se")
        check(abs(a - b) <= 4 * se, f"phase 24d {key}: {a} vs {b}, se {se}")
    call = cuda_ms(torch, lambda: mc_episode_stats(config14, pol, None, 112, episodes=COMPOSITE_EPISODES),
                   warmup=1, reps=3)
    e_call = cuda_ms(torch, lambda: mc_episode_stats(config14, pol, None, 113, episodes=COMPOSITE_EPISODES,
                                                     backend="engine"), warmup=0, reps=1)
    steps14 = COMPOSITE_EPISODES * COMPOSITE_EVAL_N * config14.n_steps
    iteration_ms["config 14"] = call
    iteration_ms["config 14 engine"] = e_call
    print(f"phase 24d [{card}] mc_episode_stats on config 14 ({COMPOSITE_EPISODES} x {COMPOSITE_EVAL_N}x"
          f"{config14.n_steps}): auto {call} ms = {steps14 / call * 1e3} env-steps/s; engine {e_call} ms = "
          f"{steps14 / e_call * 1e3} env-steps/s")
    profile_iteration(torch, card, f"mc_episode_stats on config 14, auto, {COMPOSITE_EPISODES} episodes",
                      lambda: mc_episode_stats(config14, pol, None, 114, episodes=COMPOSITE_EPISODES), phase=24,
                      expect=("det_rollout_kernel",), warm=True)
    k5 = {}
    for stats in (True, False):
        ms = kernel_ms(torch, lambda: det.fixed_rollout(p14, 9, COMPOSITE_EVAL_N, stats_only=stats,
                                                        final_obs=not stats, device=dev), warmup=2, reps=10)
        lam14 = det.fixed_rollout_params(lam_env_config(num_trajectories=COMPOSITE_EVAL_N), COMPOSITE_ACTION)
        lam_ms = kernel_ms(torch, lambda: det.fixed_rollout(lam14, 9, COMPOSITE_EVAL_N, stats_only=stats,
                                                            final_obs=not stats, device=dev), warmup=2, reps=10)
        with general_instantiation():
            gen_ms = kernel_ms(torch, lambda: det.fixed_rollout(p14, 9, COMPOSITE_EVAL_N, stats_only=stats,
                                                                final_obs=not stats, device=dev), warmup=2, reps=10)
        floats = 5 if stats else STEPS * (8 + 4 + 3) + 8
        b = bound_ms(4 * floats * COMPOSITE_EVAL_N, OPS_PER_ENV_STEP_K5_COMPOSITE * COMPOSITE_EVAL_N * STEPS,
                     FP32_OPS_PER_S)
        k5[stats] = (ms, lam_ms, b, gen_ms)
        print(kernel_row("24d", card, f"K5 fixed composite {'stats' if stats else 'streams'}",
                         f"{COMPOSITE_EVAL_N}x{STEPS}", COMPOSITE_EVAL_N * STEPS, *ms, *b,
                         plain["K5"] if stats else None)
              + f"; the general instantiation {gen_ms[0]} ms; K5 fixed lam at the same shape {lam_ms[0]} ms, "
              f"composite / lam {ms[0] / lam_ms[0]:.4f}, general / lam {gen_ms[0] / lam_ms[0]:.4f}")
    print(f"phase 24d ok in {time.perf_counter() - t0:.1f} s")

    # ---- phase 24e: the new instantiations' registers and spills (ptxas
    # -v of the builds above): K3's six general ones (kProc, the third
    # template argument, 1), K5's 28 general ones (kProc, the sixth, 1) and
    # its four composite ones (2, lam, fixed); none spills.  HMMA > 0 in
    # K3's bf16 lam general instantiation, which runs config 10.
    k3_rows = kernel_registers(_build.ptxas_reports.get("mlp_rollout.cu", ""), ("mlp_rollout_kernel",))
    k5_rows = kernel_registers(_build.ptxas_reports.get("det_rollout.cu", ""), ("det_rollout_kernel",))
    # (the market-making kinds' general ones without the extras, kDyn 0-2;
    # K5's without the schedule kind on lam and touch: phase 26e's)
    gen_k3 = [(e, u) for e, u in k3_rows if re.search(r"ILb[01]ELi[012]ELi1ELb0E", e)]
    comp_k3 = [(e, u) for e, u in k3_rows if re.search(r"ILb[01]ELi\dELi2E", e)]
    gen_k5 = [(e, u) for e, u in k5_rows
              if re.search(r"kernelILb[01]E(?:Li[01]ELi\d|Li[23]ELi[01])ELb[01]ELb[01]ELi1E", e)]
    comp_k5 = [(e, u) for e, u in k5_rows if re.search(r"ILb[01]ELi2ELi1ELb[01]ELb1ELi2E", e)]
    check((len(gen_k3), len(comp_k3), len(gen_k5), len(comp_k5)) == (6, 0, 28, 4),
          f"phase 24e: {len(gen_k3)} general and {len(comp_k3)} composite K3, {len(gen_k5)} general and "
          f"{len(comp_k5)} composite K5 instantiations, not 6, 0, 28 and 4")
    for entry, usage in gen_k3 + gen_k5 + comp_k5:
        print(f"phase 24e registers {entry[:110]}: {usage}")
        check(spill_bytes(usage) == 0, f"phase 24e: {entry} spills: {usage}")
    import shutil
    from pathlib import Path

    cuobjdump = shutil.which("cuobjdump") or str(Path(_build.nvcc()).parent / "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(_build.build("mlp_rollout.cu"))], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    hmma = {e: n for e, n in sass_counts(sass, "HMMA", ("mlp_rollout_kernel",)).items() if "ILb1ELi1ELi1ELb0E" in e}
    check(len(hmma) == 1 and all(n > 0 for n in hmma.values()), f"phase 24e: HMMA in K3's bf16 lam general kind {hmma}")
    print(f"phase 24e K3 bf16 lam general instantiation: {list(hmma.values())[0]} HMMA")

    print(f"phase 24 launches on the slice's main path (24c, 24d): { {k: c for k, c in path.items() if c} }")
    for name in ("mlp_rollout", "ppo_fused_grads_T", "det_rollout"):
        check(path[name] > 0, f"phase 24: {name} was not launched on the slice's main path")
    print(f"phase 24 ok in {time.perf_counter() - t_start:.1f} s")
    comp_b = bound_ms((8 + 4 + 3) * 4 * COMPOSITE_N * STEPS, mlp_flops_per_sample(8, 256, 256, 4) * COMPOSITE_N * STEPS,
                      BF16_OPS_PER_S)
    towers_b = bound_ms((8 + 4 + 3) * 4 * COMPOSITE_N * STEPS,
                        mlp_flops_per_sample(8, 256, 256, 4, towers=2) * COMPOSITE_N * STEPS, BF16_OPS_PER_S)
    (cs, ls), (ct, lt) = k3["shared trunk"], k3["towers"]
    (s_ms, s_lam, s_b, s_gen), (st_ms, st_lam, st_b, st_gen) = k5[True], k5[False]
    return {
        "K3": {"composite_launches": path["mlp_rollout"], "composite_max_abs_err": err["K3"],
               "composite_ms": cs[0], "composite_call_ms": cs[1], "composite_plain_ms": plain[("K3", "shared trunk")],
               "composite_bound_ms": comp_b[0], "composite_lam_same_call_ms": ls[0],
               "composite_towers_ms": ct[0], "composite_towers_plain_ms": plain[("K3", "towers")],
               "composite_towers_bound_ms": towers_b[0], "composite_towers_lam_same_call_ms": lt[0],
               "composite_iteration_ms": iteration_ms["shared trunk"],
               "composite_towers_iteration_ms": iteration_ms["towers"],
               "composite_engine_iteration_ms": iteration_ms["engine"]},
        "K4": {"composite_launches": path["ppo_fused_grads_T"], "s8_max_abs_err": err["K4"],
               **{f"s8_{'towers_' if layout == 'towers' else ''}{key}": value
                  for layout, (ms, plain_ms, b) in k4.items()
                  for key, value in (("ms", ms[0]), ("call_ms", ms[1]), ("plain_ms", plain_ms), ("bound_ms", b[0]))}},
        "K5": {"composite_launches": path["det_rollout"], "composite_max_abs_err": err["K5"],
               "fixed_composite_stats_ms": s_ms[0], "fixed_composite_stats_call_ms": s_ms[1],
               "fixed_composite_stats_plain_ms": plain["K5"], "fixed_composite_stats_bound_ms": s_b[0],
               "fixed_composite_stats_lam_same_call_ms": s_lam[0],
               "fixed_composite_stats_general_instantiation_ms": s_gen[0],
               "fixed_composite_streams_general_instantiation_ms": st_gen[0],
               "fixed_composite_streams_ms": st_ms[0], "fixed_composite_streams_call_ms": st_ms[1],
               "fixed_composite_streams_bound_ms": st_b[0], "fixed_composite_streams_lam_same_call_ms": st_lam[0],
               "config14_call_ms": iteration_ms["config 14"], "config14_engine_ms": iteration_ms["config 14 engine"]},
    }


# ------------------------------------------------------------------ training and interop surfaces
SURFACE_N = 16_384  # the AS serving width (phases 4-6): the adapters, analytics and engine throughput
SURFACE_TOL = 1e-5  # analytics on the card against float64 on the CPU


def state_digest(torch, ts):
    """sha256 of a PPO train state: the model's state_dict (sorted names),
    then per parameter Adam's step and moments (step 0 and zeros where Adam
    has not stepped yet, the state it starts from), then the update count."""
    import hashlib

    h = hashlib.sha256()
    for name, value in sorted(ts.params.state_dict().items()):
        h.update(name.encode())
        h.update(value.detach().cpu().contiguous().numpy().tobytes())
    for group in ts.opt_state.param_groups:
        for p in group["params"]:
            state = ts.opt_state.state.get(p, {})
            for key in ("step", "exp_avg", "exp_avg_sq"):
                value = state.get(key)
                if value is None:  # Adam starts from step 0 and zero moments
                    value = torch.zeros(()) if key == "step" else torch.zeros_like(p)
                h.update(value.detach().cpu().reshape(-1).numpy().tobytes())
    h.update(str(ts.update_count).encode())
    return h.hexdigest()


def step_split(wall_ms, busy_ms, steps):
    """One adapter step's time split: ``wall_ms`` (host clock, per step,
    median), the device's busy time ``busy_ms`` over ``steps`` profiled
    steps; the host's share is the rest."""
    step_ms = statistics.median(wall_ms)
    device = busy_ms / steps
    host = max(step_ms - device, 0.0)
    return {"step_ms": step_ms, "device_ms": device, "host_ms": host, "host_share": host / step_ms}


def device_busy(torch, fn):
    """(device busy ms, wall ms) of one call of ``fn`` under
    torch.profiler: the union of the device events' intervals, as
    :func:`profile_iteration` counts it, without touching the launch
    counters."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    return busy_ms([(e.time_range.start, e.time_range.end) for e in device]), wall


def as_numpy_predict(agent):
    """The AS closed form (BaselineAgents.py:52-83) as a host numpy
    ``predict(obs (N, 4) float32) -> (N, 2)``: what an external model hands
    the adapters."""
    import numpy as np

    gamma, sigma, k, big_t = agent.risk_aversion, agent.volatility, agent.fill_exponent, agent.terminal_time
    half_log = float((2.0 / gamma) * np.log(1 + gamma / k))

    def predict(obs):
        q, t = obs[:, 1], obs[:, 2]
        skew = q * gamma * sigma**2 * (big_t - t)
        spread = gamma * sigma**2 * (big_t - t) + half_log
        return np.stack([skew + spread / 2, -skew + spread / 2], axis=1)

    return predict


def counts_since(before, now):
    return {k: now[k] - before.get(k, 0) for k in now if now[k] - before.get(k, 0)}


def surface_phases(torch, np, card, dev):
    """Phase 25: the training and interop surfaces on the card.  (a)
    checkpoint and resume at config 5: 4 iterations straight against 2,
    ``save_checkpoint`` of the train state and the card generator that
    seeds the iterations, ``restore_checkpoint`` into a template built
    from another seed, 2 more, bitwise equal (params, Adam state, metrics);
    a CPU file restored onto the card and back; the mismatch error on a
    128x128 template.  (b) the data-parallel mesh at world size 1 through
    NCCL: one config-5 iteration through ``train_iteration(mesh=)``
    against the meshless one (tests/test_sharding.py:181-187's
    tolerances), its time beside the meshless time, and
    ``entry.dryrun_multichip(1)``.  (c) ``VecTradingEnv`` over one AS
    episode at 16,384 envs with the closed form as a numpy ``predict``
    (device and host time per step), ``rollout`` of
    ``host_model_policy`` on the engine, both within 4 standard errors of
    the AS agent's engine rollout; ``GymTradingEnv`` where gymnasium
    imports.  (d) the backtest statistics and diagnostics on K2's
    trajectory (``rollout(backend="auto")``, one launch) against float64 on
    the CPU; plotting where matplotlib imports.  (e) ``profiling.trace``
    around two config-5 iterations, naming K3's and K4's kernels;
    ``throughput`` and ``scaling_report`` on the AS engine; the
    TensorBoard logger on ``train_chunk``'s metrics.  Returns the
    kernels-line figures of K2, K3 and K4."""
    import dataclasses
    import glob
    import json
    import os
    import tempfile

    import torch.distributed as dist

    from mbt_gym_torch import dispatch_report, entry, rollout
    from mbt_gym_torch.agents.baseline import AvellanedaStoikovAgent
    from mbt_gym_torch.agents.external import host_model_policy
    from mbt_gym_torch.agents.ppo import PPOConfig, init_train_state, train_chunk, train_iteration
    from mbt_gym_torch.analytics import backtesting, diagnostics
    from mbt_gym_torch.checkpoint import CheckpointMismatchError, restore_checkpoint, save_checkpoint
    from mbt_gym_torch.gym_compat import GymTradingEnv, VecTradingEnv
    from mbt_gym_torch.ops import _build
    from mbt_gym_torch.parallel import mesh as mesh_lib
    from mbt_gym_torch.types import Trajectory
    from mbt_gym_torch.utils import profiling, tblog
    from mbt_gym_torch.utils.config import as_env_config

    t_start = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    env_cfg = dataclasses.replace(as_env_config(num_trajectories=PPO_N),
                                  normalise_observation_space=True, normalise_action_space=True)
    ppo_cfg = PPOConfig(hidden=(256, 256), n_epochs=1, n_minibatches=PPO_MINIBATCHES, shuffle=False,
                        compute_dtype="bfloat16", shared_trunk=True, fused_rollout=True, fused_update=True)
    figures = {}
    _build.reset_launch_counts()  # the slice's main path: everything phase 25 runs

    # ---- phase 25a: checkpoint and resume at config 5
    def run(ts, gen, n):
        out = []
        for _ in range(n):
            before = dict(_build.launch_counts)
            ts, metrics = train_iteration(env_cfg, ppo_cfg, ts, gen)
            torch.cuda.synchronize()
            got = counts_since(before, _build.launch_counts)
            check(got == {"mlp_rollout": 1, "ppo_fused_grads_T": PPO_MINIBATCHES},
                  f"phase 25a: an iteration launched {got}, not K3 x1 and K4 x{PPO_MINIBATCHES}")
            out.append(assert_metric_bands(metrics, "phase 25a"))
        return ts, out

    ts0 = init_train_state(env_cfg, ppo_cfg, 0, device=dev)
    straight, m_straight = run(ts0, torch.Generator(dev).manual_seed(77), 4)
    gen = torch.Generator(dev).manual_seed(77)
    half, _ = run(ts0, gen, 2)
    path = os.path.join(tmp.name, "config5.ckpt")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_checkpoint(path, {"train_state": half, "key": gen})
    save_ms = (time.perf_counter() - t0) * 1e3
    template = {"train_state": init_train_state(env_cfg, ppo_cfg, 5, device=dev),
                "key": torch.Generator(dev).manual_seed(0)}
    check(state_digest(torch, template["train_state"]) != state_digest(torch, half), "phase 25a: template = state")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored = restore_checkpoint(path, template)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    check(next(restored["train_state"].params.parameters()).device.type == dev.type, "phase 25a: restored off the card")
    check(state_digest(torch, restored["train_state"]) == state_digest(torch, half), "phase 25a: restore is not exact")
    resumed, m_resumed = run(restored["train_state"], restored["key"], 2)
    check(state_digest(torch, resumed) == state_digest(torch, straight),
          "phase 25a: 2 + save + restore + 2 iterations differ from 4 straight (params or Adam state)")
    check(m_resumed == m_straight[2:], f"phase 25a: resumed metrics {m_resumed} != {m_straight[2:]}")
    size = os.path.getsize(path)
    print(f"phase 25a [{card}] config 5 checkpoint: {size} bytes, save {save_ms} ms, restore {restore_ms} ms; "
          "4 straight iterations = 2 + save + restore + 2, bitwise (params, Adam state, metrics)")
    # a CPU file onto the card and back; a 128x128 template refused
    cpu_ts = init_train_state(env_cfg, ppo_cfg, 3, device="cpu")
    cpu_path = os.path.join(tmp.name, "cpu.ckpt")
    save_checkpoint(cpu_path, {"train_state": cpu_ts})
    on_card = restore_checkpoint(cpu_path, {"train_state": init_train_state(env_cfg, ppo_cfg, 4, device=dev)})
    check(state_digest(torch, on_card["train_state"]) == state_digest(torch, cpu_ts), "phase 25a: CPU -> card")
    save_checkpoint(cpu_path, on_card)
    back = restore_checkpoint(cpu_path, {"train_state": init_train_state(env_cfg, ppo_cfg, 4, device="cpu")})
    check(state_digest(torch, back["train_state"]) == state_digest(torch, cpu_ts), "phase 25a: card -> CPU")
    narrow = init_train_state(env_cfg, dataclasses.replace(ppo_cfg, hidden=(128, 128)), 0, device=dev)
    try:
        restore_checkpoint(path, {"train_state": narrow, "key": torch.Generator(dev)})
        check(False, "phase 25a: a 128x128 template restored a 256x256 checkpoint")
    except CheckpointMismatchError as e:
        check("train_state/params/shared/0/weight" in str(e), f"phase 25a: mismatch message {e}")
        print(f"phase 25a: a 128x128 template is refused: {str(e)[:160]}...")
    figures["checkpoint"] = {"bytes": size, "save_ms": save_ms, "restore_ms": restore_ms}
    del straight, half, resumed, restored, template, narrow

    # ---- phase 25b: the data-parallel mesh at world size 1 through NCCL
    mesh_lib.init_distributed(device=dev)
    mesh = mesh_lib.make_mesh()
    backend = dist.get_backend()
    check(backend == ("nccl" if dev.type == "cuda" else "gloo") and mesh.world == 1,
          f"phase 25b: backend {backend}, world {mesh.world}")
    ts = init_train_state(env_cfg, ppo_cfg, 6, device=dev)
    before = dict(_build.launch_counts)
    mesh_ts, mesh_m = train_iteration(env_cfg, ppo_cfg, ts, 300, mesh=mesh)
    torch.cuda.synchronize()
    got = counts_since(before, _build.launch_counts)
    check(got == {"mlp_rollout": 1, "ppo_fused_grads_T": PPO_MINIBATCHES}, f"phase 25b: the mesh iteration launched {got}")
    plain_ts, plain_m = train_iteration(env_cfg, ppo_cfg, ts, 300)
    worst = 0.0
    for (name, a), b in zip(plain_ts.params.state_dict().items(), mesh_ts.params.state_dict().values()):
        err = float(((a - b).abs() - 1e-6 * a.abs()).max())
        worst = max(worst, float((a - b).abs().max()))
        check(err <= 1e-6, f"phase 25b: {name} differs from the meshless iteration beyond rtol/atol 1e-6 "
                           f"(max abs {float((a - b).abs().max())})")
    for k in plain_m:
        a, b = float(plain_m[k]), float(mesh_m[k])
        check(abs(a - b) <= 1e-6 + 1e-5 * abs(a), f"phase 25b: metric {k} {b} vs meshless {a}")
    assert_metric_bands(mesh_m, "phase 25b")
    state = {"ts": ts}

    def mesh_iteration():
        state["ts"], _ = train_iteration(env_cfg, ppo_cfg, state["ts"], 301, mesh=mesh)

    def plain_iteration():
        state["ts"], _ = train_iteration(env_cfg, ppo_cfg, state["ts"], 301)

    plain_ms = cuda_ms(torch, plain_iteration, warmup=1, reps=3)
    mesh_ms = cuda_ms(torch, mesh_iteration, warmup=1, reps=3)
    plain_ms2 = cuda_ms(torch, plain_iteration, warmup=0, reps=3)
    print(f"phase 25b [{card}] config 5 iteration through the {backend} mesh (world 1, 16 coalesced grad "
          f"all-reduces): {mesh_ms} ms, meshless {plain_ms} ms then {plain_ms2} ms; params within {worst} "
          f"(max abs) of the meshless iteration")
    figures["mesh"] = {"ms": mesh_ms, "meshless_ms": (plain_ms + plain_ms2) / 2, "max_abs_param_diff": worst}
    del mesh_ts, plain_ts, state
    t0 = time.perf_counter()
    entry.dryrun_multichip(1, device=dev)
    torch.cuda.synchronize()
    figures["dryrun_s"] = time.perf_counter() - t0
    print(f"phase 25b [{card}] dryrun_multichip(1) at its defaults (2,048 x 64, 256x256): {figures['dryrun_s']} s")

    # ---- phase 25c: the adapters and host policies on the AS config
    as_cfg = as_env_config(num_trajectories=SURFACE_N)
    agent = AvellanedaStoikovAgent.from_config(as_cfg, risk_aversion=0.1)
    predict = as_numpy_predict(agent)
    venv = VecTradingEnv(as_cfg, seed=41, device=dev)
    obs = venv.reset()
    totals = np.zeros(SURFACE_N, dtype=np.float64)
    walls = []
    for t in range(as_cfg.n_steps):
        t0 = time.perf_counter()
        obs, rewards, dones, infos = venv.step(predict(obs))
        walls.append((time.perf_counter() - t0) * 1e3)
        totals += rewards
        check(bool(dones.all()) == (t == as_cfg.n_steps - 1) and bool(dones.any()) == bool(dones.all()),
              f"phase 25c: dones at step {t}")
    check(len(infos) == SURFACE_N and abs(float(infos[0]["terminal_observation"][2]) - as_cfg.terminal_time) < 1e-5,
          "phase 25c: terminal_observation infos")
    check(np.all(obs[:, 2] == 0.0) and np.all(obs[:, 1] == 0.0), "phase 25c: the autoreset's observations")
    obs = venv.reset()

    def twenty_steps():
        nonlocal obs
        for _ in range(20):
            obs = venv.step(predict(obs))[0]

    busy, _ = device_busy(torch, twenty_steps)
    split = step_split(walls, busy, 20)
    engine = rollout_summary(torch, rollout(as_cfg, agent.policy(), None, 42, backend="engine", device=dev))
    venv_pnl = {"mean_pnl": totals.mean(), "std_pnl": totals.std()}
    check_agree(venv_pnl, engine, "mean_pnl", SURFACE_N, SURFACE_N, "phase 25c VecTradingEnv vs the engine")
    hp = host_model_policy(predict, 2)
    decision = dispatch_report(as_cfg, hp, mode="rollout", platform=dev)
    check(decision.backend == "engine" and decision.reason.startswith("policy carries no dispatch metadata"),
          f"phase 25c: host policy dispatch {decision}")
    before = dict(_build.launch_counts)
    host_res = rollout_summary(torch, rollout(as_cfg, hp, None, 43, device=dev))
    check(counts_since(before, _build.launch_counts) == {}, "phase 25c: the host policy launched a kernel")
    check_agree(host_res, engine, "mean_pnl", SURFACE_N, SURFACE_N, "phase 25c host_model_policy vs the engine")
    host_ms = cuda_ms(torch, lambda: rollout(as_cfg, hp, None, 44, device=dev), warmup=0, reps=2)
    eng_ms = cuda_ms(torch, lambda: rollout(as_cfg, agent.policy(), None, 44, backend="engine", device=dev),
                     warmup=0, reps=2)
    print(f"phase 25c [{card}] VecTradingEnv at {SURFACE_N} envs: {split['step_ms']} ms per step (median), device "
          f"{split['device_ms']} ms, host {split['host_ms']} ms ({split['host_share']:.1%}); "
          f"host_model_policy rollout {host_ms} ms per episode, the AS agent's engine rollout {eng_ms} ms")
    try:
        import gymnasium  # noqa: F401
    except ImportError:
        try:
            GymTradingEnv(as_cfg, device=dev)
            check(False, "phase 25c: GymTradingEnv built without gymnasium")
        except ImportError as e:
            print(f"phase 25c: gymnasium is absent; GymTradingEnv raises ImportError: {e}")
    else:
        genv = GymTradingEnv(as_cfg, seed=1, device=dev)
        g_obs, _ = genv.reset()
        g_obs, g_rew, term, trunc, info = genv.step(predict(g_obs))
        check(g_obs.shape == (SURFACE_N, 4) and not term.any() and len(info) == SURFACE_N, "phase 25c: GymTradingEnv")
        print("phase 25c: gymnasium imports; GymTradingEnv reset and stepped")
    figures["adapters"] = {**split, "host_policy_rollout_ms": host_ms, "engine_rollout_ms": eng_ms}

    # ---- phase 25d: analytics on K2's trajectory
    a_cfg = dataclasses.replace(as_cfg, initial_cash=1000.0)
    policy = agent.policy()
    decision = dispatch_report(a_cfg, policy, mode="rollout", platform=dev)
    check((decision.backend, decision.family) == ("fused", "as_episode"), f"phase 25d dispatch: {decision}")
    before = dict(_build.launch_counts)
    traj = rollout(a_cfg, policy, None, 45, device=dev).trajectory
    torch.cuda.synchronize()
    got = counts_since(before, _build.launch_counts)
    check(got == {"as_episode_trajectories": 1}, f"phase 25d: rollout launched {got}, not K2 once")
    cpu64 = Trajectory(*(x.detach().cpu().double() for x in traj))
    analytics_ms = {}
    for name, fn in (("sharpe_ratio", backtesting.sharpe_ratio), ("sortino_ratio", backtesting.sortino_ratio),
                     ("maximum_drawdown", backtesting.maximum_drawdown),
                     ("negative_spread_fraction", diagnostics.negative_spread_fraction),
                     ("max_abs_inventory", diagnostics.max_abs_inventory)):
        got_v, want_v = fn(traj).cpu().double(), fn(cpu64)
        finite = torch.isfinite(want_v)
        check(bool((torch.isfinite(got_v) == finite).all()), f"phase 25d {name}: NaN pattern differs")
        err = float(((got_v - want_v).abs() / want_v.abs().clamp_min(1e-300))[finite].max()) if finite.any() else 0.0
        check(err <= SURFACE_TOL, f"phase 25d {name}: relative error {err} against float64 on the CPU")
        analytics_ms[name] = cuda_ms(torch, lambda: fn(traj), warmup=1, reps=5)
        print(f"phase 25d [{card}] {name} on K2's {SURFACE_N}x{a_cfg.n_steps} trajectory: {analytics_ms[name]} ms, "
              f"max relative error {err} against float64 on the CPU ({int(finite.sum())} finite of {finite.numel()})")
    try:
        import matplotlib
    except ImportError:
        print("phase 25d: plotting skipped: matplotlib is absent")
    else:
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        from mbt_gym_torch.analytics import plotting

        plt.close(plotting.plot_trajectory(a_cfg, traj, max_trajectories=4))
        print("phase 25d: plot_trajectory drew K2's trajectory")
    figures["analytics_ms"] = analytics_ms
    del traj, cpu64

    # ---- phase 25e: profiling and logging
    # Two iterations: CUPTI now and then drops the record of a single
    # launch from the kernels' libraries (phase 17 has seen it), and K3
    # launches once per iteration; each kernel's records are printed
    # beside its launches.
    trace_dir = os.path.join(tmp.name, "trace")
    ts = init_train_state(env_cfg, ppo_cfg, 8, device=dev)
    before = dict(_build.launch_counts)
    with profiling.trace(trace_dir):
        for seed in (302, 303):
            ts, _ = train_iteration(env_cfg, ppo_cfg, ts, seed)
    launched = counts_since(before, _build.launch_counts)
    files = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    check(len(files) == 1, f"phase 25e: trace files {files}")
    with open(files[0]) as f:
        kernel_events = [str(e.get("name", "")) for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
    names = set(kernel_events)
    for kernel, counter in (("mlp_rollout_kernel", "mlp_rollout"), ("ppo_deep_pass1", "ppo_fused_grads_T"),
                            ("ppo_deep_pass2", "ppo_fused_grads_T")):
        traced = sum(kernel in n for n in kernel_events)
        print(f"phase 25e: {kernel}: {traced} records in the trace, {launched.get(counter, 0)} launches")
        check(traced > 0 or dev.type != "cuda",
              f"phase 25e: the trace names no {kernel} kernel ({sorted(names)[:12]})")
    trace_bytes = os.path.getsize(files[0])
    print(f"phase 25e [{card}] profiling.trace of two config-5 iterations: {trace_bytes} bytes, {len(names)} kernel "
          f"names, K3's and K4's among them")
    tp = profiling.throughput(as_cfg, policy, episodes_per_call=2, iters=2, device=dev)
    check(all(np.isfinite(v) for v in tp.values()), f"phase 25e: throughput {tp}")
    rows = profiling.scaling_report(as_cfg, policy, episodes_per_call=1, iters=2)
    check(len(rows) == 1 and rows[0]["devices"] == 1, f"phase 25e: scaling_report {rows}")
    print(f"phase 25e [{card}] throughput of AS {SURFACE_N}x{as_cfg.n_steps} engine episodes: "
          f"{tp['env_steps_per_s']} env-steps/s ({tp['seconds_per_call']} s per 2 episodes); scaling_report {rows}")
    check(isinstance(tblog.maybe_logger(None), tblog._NoopLogger), "phase 25e: maybe_logger(None)")
    ts, chunk = train_chunk(env_cfg, ppo_cfg, ts, 9, 2)
    values = tblog.host_values(chunk)
    check(all(v.shape == (2,) for v in values.values()), f"phase 25e: train_chunk metrics {values}")
    try:
        logger = tblog.TensorboardLogger(os.path.join(tmp.name, "tb"))
    except ImportError as e:
        print(f"phase 25e: tensorboard is absent; TensorboardLogger raises ImportError: {e}")
    else:
        logger.log(0, chunk)
        logger.close()
        events = glob.glob(os.path.join(tmp.name, "tb", "events.out.tfevents.*"))
        check(events and os.path.getsize(events[0]) > 0, "phase 25e: no TensorBoard event file")
        print(f"phase 25e: TensorboardLogger wrote {os.path.getsize(events[0])} bytes from train_chunk's metrics")
    figures["trace_bytes"] = trace_bytes
    figures["throughput_env_steps_per_s"] = tp["env_steps_per_s"]
    figures["scaling"] = rows
    dist.destroy_process_group()
    tmp.cleanup()

    torch.cuda.synchronize()
    path_counts = {k: c for k, c in _build.launch_counts.items() if c}
    print(f"phase 25 launches on the slice's path: {path_counts}")
    for name in ("as_episode_trajectories", "mlp_rollout", "ppo_fused_grads_T"):
        check(path_counts.get(name, 0) > 0, f"phase 25: {name} was not launched on the slice's path")
    print(f"phase 25 ok in {time.perf_counter() - t_start:.1f} s: {json.dumps(figures, default=float)}")
    return {
        "K2": {"slice14_launches": path_counts.get("as_episode_trajectories", 0),
               "slice14_analytics_ms": analytics_ms},
        "K3": {"slice14_launches": path_counts.get("mlp_rollout", 0)},
        "K4": {"slice14_launches": path_counts.get("ppo_fused_grads_T", 0),
               "slice14_mesh_iteration_ms": figures["mesh"]["ms"],
               "slice14_meshless_iteration_ms": figures["mesh"]["meshless_ms"]},
    }


# ------------------------------------------------------------------ optimal execution
SPEED_N = 262_144  # bench_suite config 6 (scripts/bench_suite.py:184-200)
SPEED_ITERATIONS = 3  # timed config-6 iterations per layout
OE_GATE_N, OE_GATE_ITERATIONS, OE_GATE_BAR = 8192, 200, 0.9  # tests/test_convergence.py:317-350
OE_GATE_PHI, OE_GATE_ALPHA = 2e-3, 0.1
EU_GAMMA = 0.01  # ExponentialUtility's risk aversion in phase 26 (cash and value in the hundreds)
# The instantiations phase 26 adds, by mangled name: K3's speed kind (kDyn
# 3, plain or general processes, no extras) and the extras variants (the
# fourth template argument, kExtra, 1) of every kind; K5's schedule kind on
# lam and touch (kDyn 2 and 3, kPol 2) and its exponential-utility kernels.
K3_NEW_INSTANTIATIONS = r"mlp_rollout_kernelI(?:Lb[01]ELi3ELi[01]ELb0E|Lb[01]ELi\dELi1ELb1E)"
K5_NEW_INSTANTIATIONS = r"kernelILb[01]ELi[23]ELi2E|kernel_utilityI"
# Operations per env-step of phase 26's K5 cases, counted as
# OPS_PER_ENV_STEP_K1 is: the lam, table, speed and touch steps, the
# exponential utility adding its value, product, exp and the terminal
# product (4) in place of the PnL reward's difference.
K5_SLICE15_OPS = {"eu_fixed_lam": OPS_PER_ENV_STEP_K5_LAM + 4, "eu_table": OPS_PER_ENV_STEP_K5_TABLE + 4,
                  "eu_schedule_oe": OPS_PER_ENV_STEP_K5_SPEED + 4, "schedule_lam": OPS_PER_ENV_STEP_K5_LAM,
                  "schedule_touch": OPS_PER_ENV_STEP_K5_TOUCH}


def oe_saving(det, cf, hold):
    """The share of the closed-form schedule's saving over holding the
    inventory that a policy captures, (det - hold) / (cf - hold)
    (tests/test_convergence.py:357)."""
    return (det - hold) / (cf - hold)


def k3_bound(n, steps, s_dim, a_dim, towers=1, peak=BF16_OPS_PER_S):
    """bound_ms of one K3 call: the (T, S + A + 3, N) float32 outputs
    written once against the trunk's and head's matmul FLOPs per
    env-step at ``peak``."""
    return bound_ms((s_dim + a_dim + 3) * 4 * n * steps, mlp_flops_per_sample(s_dim, 256, 256, a_dim, towers) * n * steps,
                    peak)


def speed_figures(err, launches, k3, k4, k5, k3_extra=None):
    """The kernels-line fields of phase 26 by kernel: ``err`` the max abs
    errors against the plain versions, ``launches`` the main path's counts,
    ``k3`` {layout: (device_ms, call_ms, plain_ms, bound_ms, pnl_ms)} of K3
    speed at config 6, ``k4`` (device_ms, call_ms, plain_ms, bound_ms) of K4
    at S = 5, A = 1, ``k5`` and ``k3_extra`` {tag: (device_ms, call_ms,
    plain_ms, bound_ms)} of K5's new kinds and of K3's exponential utility
    and t0 plane."""
    figures = {"K3": {"speed_launches": launches.get("mlp_rollout", 0), "speed_max_abs_err": err["K3"]},
               "K4": {"s5a1_launches": launches.get("ppo_fused_grads_T", 0), "s5a1_max_abs_err": err["K4"],
                      "s5a1_ms": k4[0], "s5a1_call_ms": k4[1], "s5a1_plain_ms": k4[2], "s5a1_bound_ms": k4[3]},
               "K5": {"slice15_launches": launches.get("det_rollout", 0), "slice15_max_abs_err": err["K5"]}}
    for layout, (ms, call, plain, bound, pnl) in k3.items():
        tag = f"speed_{'towers' if layout == 'towers' else 'shared'}"
        figures["K3"].update({f"{tag}_ms": ms, f"{tag}_call_ms": call, f"{tag}_plain_ms": plain,
                              f"{tag}_bound_ms": bound, f"{tag}_pnl_same_call_ms": pnl})
    for kernel, kinds in (("K5", k5), ("K3", k3_extra or {})):
        for tag, (ms, call, plain, bound) in kinds.items():
            figures[kernel].update({f"{tag}_ms": ms, f"{tag}_call_ms": call, f"{tag}_plain_ms": plain,
                                    f"{tag}_bound_ms": bound})
    return figures


def speed_phases(torch, np, card, dev, k3_pnl_ms=None):
    """Phase 26: PPO on optimal execution through K3's speed kind, K3's
    t0 plane and terminal observation, the exponential utility in K3 and
    K5, K5's schedule kind on lam and touch.  (a) each new kind against
    its plain version in native and noise modes, launched twice bitwise,
    and K4 at S = 5, A = 1; (b) the JAX OE learning gate
    (tests/test_convergence.py:317-350, not cut): 200 fully fused
    iterations must capture 90% of the closed-form schedule's saving; (c)
    bench_suite config 6 at full width, both layouts, beside the engine and
    K3 PnL; (d) two implementations of one contract: random-start
    evaluate_policy, the exponential utility's fixed quotes through
    rollout(auto), the schedule kind on lam, each fused against the engine;
    (e) the new instantiations' registers, spills and HMMA.  Returns the
    kernels-line figures of K3, K4 and K5."""
    import dataclasses
    import re

    from mbt_gym_torch import (
        CarteaJaimungalMmAgent, CarteaJaimungalOeAgent, as_env_config, dispatch_report, rollout,
    )
    from mbt_gym_torch.agents.baseline import fixed_action_policy
    from mbt_gym_torch.agents.networks import init_actor_critic
    from mbt_gym_torch.agents.ppo import (
        PPOConfig, compute_gae, deterministic_policy, evaluate_policy, init_train_state, normalise, train_iteration,
    )
    from mbt_gym_torch.env import make_generator
    from mbt_gym_torch.ops import _build
    from mbt_gym_torch.ops import det_rollout as det
    from mbt_gym_torch.ops import fused_ppo
    from mbt_gym_torch.ops import mlp_rollout as mr
    from mbt_gym_torch.processes import impact as ip
    from mbt_gym_torch.processes import midprice as mp
    from mbt_gym_torch.rewards import CjOeCriterion, ExponentialUtility
    from mbt_gym_torch.types import TIME_INDEX
    from mbt_gym_torch.utils.config import cj_env_config, lam_env_config, oe_env_config, touch_env_config

    t_start = time.perf_counter()
    norm = dict(normalise_observation_space=True, normalise_action_space=True)
    cfg6 = dataclasses.replace(oe_env_config(num_trajectories=SPEED_N), **norm)
    path = {name: 0 for name in _build.launch_counts}

    def add_launches():
        for name, c in _build.launch_counts.items():
            path[name] += c

    def model_for(cfg, seed, shared=True):
        return init_actor_critic(seed, cfg.state_dim, cfg.action_dim, hidden=(256, 256), shared_trunk=shared,
                                 device=dev)

    def k3_noise(p, n, seed):
        return mr.philox_noise(seed, p.run_steps, n, dev, p.a_dim, p.fill_kind == "exomm", p.has_mid2) * 1.0

    # ---- phase 26a: each new kind against its plain version, native and
    # noise, at phase 8's limits (K3; the speed kind's inventory is
    # continuous, compared to the tolerance) and phase 14's (K5), each
    # launched twice bitwise; K4 at S = 5, A = 1 at phase 9's
    t0 = time.perf_counter()
    err = {"K3": 0.0, "K4": 0.0, "K5": 0.0}
    plain_k3_ms = {}

    def k3_case(label, cfg, model, n, modes=("native", "noise"), t0_plane=None, final_obs=False, time_plain=False):
        p = mr.rollout_params_from_config(cfg)
        kept = None
        for mode in modes:
            kw = {"seed": 61, "device": dev} if mode == "native" else {"noise": k3_noise(p, n, 62)}
            extra = {"t0": t0_plane, "final_obs": final_obs}
            got = mr.mlp_rollout(p, model, num_trajectories=n, **kw, **extra)
            again = mr.mlp_rollout(p, model, num_trajectories=n, **kw, **extra)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            want = mr.mlp_rollout_plain(p, model, num_trajectories=n, **kw, **extra)
            end.record()
            end.synchronize()
            if time_plain and mode == "native":
                plain_k3_ms[label] = start.elapsed_time(end)
            at = f"phase 26a K3 {label} {mode} at {n}x{p.run_steps}"
            err["K3"] = max(err["K3"], compare_rollouts(torch, got[:5], want[:5], n, at, continuous=p.speed))
            outs = dict(zip(ROLLOUT_OUTPUTS + ("final_obs",), got))
            check_repeat(torch, (outs,), (dict(zip(outs, again)),), at)
            if final_obs:
                torch.testing.assert_close(got[5], want[5], rtol=1e-4, atol=1e-3, msg=lambda m: f"{at} final_obs: {m}")
                err["K3"] = max(err["K3"], float((got[5] - want[5]).abs().max()))
            if mode == "native":
                kept = got
            del got, again, want
        return p, kept

    # K3 speed at config 6's shape: both layouts, bf16 (normalised, config
    # 6) and float32 (the raw OE spaces)
    raw6 = oe_env_config(num_trajectories=SPEED_N)
    speed_rollout = None
    for precision, cfg in (("bf16", cfg6), ("float32", raw6)):
        for layout in ("shared trunk", "towers"):
            model = model_for(cfg, 63, layout == "shared trunk")
            for n, mode in ((SPEED_N, "native"), (CJ_SMALL_N, "noise")):
                p, got = k3_case(f"speed {precision} {layout}", cfg, model, n, modes=(mode,),
                                 time_plain=n == SPEED_N)
                check((p.dynamics_kind, p.a_dim, len(p.obs_low)) == ("speed", 1, 5), f"phase 26a: params {p}")
                if precision == "bf16" and layout == "shared trunk" and n == SPEED_N:
                    speed_rollout, speed_model = got, model
                del got
    # the four impact kinds, CjOe at exponents 2 and 3, a Heston midprice
    # on speed, and the exponential utility on limit and speed, at
    # 16,384 x 200 on the bf16 shared trunk.  The power impact (0.01
    # speed^2, tests/test_pallas_rollout.py:441's exponent) runs on the raw
    # spaces' float32 path: at the speed bound of 100 a step's reward moves
    # 1.3 per unit of speed, so the bf16 path's summation-order difference
    # in the action (~1e-4 of a normalised unit) moves a reward by ~0.01,
    # past phase 8's tolerance, while the float32 path's is ~1e-6.
    base = dataclasses.replace(oe_env_config(num_trajectories=KIND_N), **norm)

    def impact(m, cfg=base):
        return dataclasses.replace(cfg, dynamics=dataclasses.replace(cfg.dynamics, price_impact_model=m))

    kinds = {
        "temp_perm cjoe e2": base,
        "cjoe e3": dataclasses.replace(base, reward_function=CjOeCriterion(2e-4, 0.01, inventory_exponent=3.0)),
        "power float32": impact(ip.TemporaryPowerImpact(temporary_impact_coefficient=0.01, temporary_impact_exponent=2.0),
                                oe_env_config(num_trajectories=KIND_N)),
        "transient": impact(ip.TransientImpact()),
        "temp_transient": impact(ip.TemporaryAndTransientImpact()),
        "heston": dataclasses.replace(base, dynamics=dataclasses.replace(base.dynamics, midprice_model=mp.HestonMidprice(
            initial_price=100.0))),
        "speed exp_utility": dataclasses.replace(base, reward_function=ExponentialUtility(EU_GAMMA)),
        "limit exp_utility": dataclasses.replace(as_env_config(num_trajectories=KIND_N), reward_function=ExponentialUtility(
            EU_GAMMA), **norm),
    }
    for label, cfg in kinds.items():
        k3_case(label, cfg, model_for(cfg, 64), KIND_N)
    # the t0 plane on the normalised AS env (start_time ("uniform", 0,
    # 0.5)), per-env starts on the step grid, both layouts: the steps past
    # each env's horizon give exact zeros
    late = dataclasses.replace(as_env_config(num_trajectories=KIND_N), start_time=("uniform", 0.0, 0.5), **norm)
    gen = torch.Generator(dev).manual_seed(65)
    steps_in = torch.randint(0, 101, (KIND_N,), generator=gen, device=dev)
    t0_plane = steps_in.to(torch.float32) * late.step_size
    for layout in ("shared trunk", "towers"):
        p, got = k3_case(f"t0 {layout}", late, model_for(late, 66, layout == "shared trunk"), KIND_N,
                         t0_plane=t0_plane)
        check(p.random_start and p.run_steps == late.n_steps, f"phase 26a: t0 params {p}")
        done = torch.arange(late.n_steps, device=dev)[:, None] >= late.n_steps - steps_in[None, :]
        check(bool((got[4][done] == 0.0).all()) and bool((got[4][~done] != 0.0).any()),
              "phase 26a: K3's post-done rewards under t0 are not zero")
        del got
    # the terminal observation: against the plain version (normalised AS,
    # bf16; config 6's OE, bf16), and equal to the last observation row of
    # a run one step longer on the same channels (raw AS, float32)
    for label, cfg in (("final_obs limit", dataclasses.replace(as_env_config(num_trajectories=KIND_N), **norm)),
                       ("final_obs speed", base)):
        k3_case(label, cfg, model_for(cfg, 67), KIND_N, final_obs=True)
    raw = as_env_config(num_trajectories=KIND_N)
    longer = as_env_config(num_trajectories=KIND_N, n_steps=STEPS + 1, terminal_time=(STEPS + 1) / STEPS)
    model = model_for(raw, 68)
    p, p1 = mr.rollout_params_from_config(raw), mr.rollout_params_from_config(longer)
    check(np.float32(p.dt) == np.float32(p1.dt), f"phase 26a: step sizes {p.dt} and {p1.dt}")
    noise = k3_noise(p1, KIND_N, 69)
    fin = mr.mlp_rollout(p, model, num_trajectories=KIND_N, noise=noise[:STEPS].contiguous(), final_obs=True)[5]
    row = mr.mlp_rollout(p1, model, num_trajectories=KIND_N, noise=noise)[0][STEPS]
    torch.testing.assert_close(fin, row, rtol=1e-6, atol=1e-6, msg=lambda m: f"phase 26a final_obs vs one more step: {m}")
    print(f"phase 26a K3 final_obs equals the last observation row stepped once more (max abs "
          f"{float((fin - row).abs().max()):.3g})")
    del fin, row, noise

    # K5: the exponential utility on the fixed (lam), table (CJ) and
    # schedule (OE) kinds; the schedule kind on lam (with market orders)
    # and touch, at 16,384 x 200 (the CJ table at its 1,000 steps)
    cj_base = cj_env_config(num_trajectories=N_MAIN, max_inventory=10.0)
    cj_agent = CarteaJaimungalMmAgent.from_config(cj_base, max_inventory=10)
    oe_base = oe_env_config(num_trajectories=N_MAIN)
    oe_table = det.schedule_table_from_policy(oe_base, CarteaJaimungalOeAgent.from_config(oe_base).policy()).to(dev)
    rng = np.random.default_rng(70)
    lam_table = torch.from_numpy(rng.uniform(0.0, 1.0, size=(STEPS, 4)).astype(np.float32)).to(dev)
    touch_table = torch.from_numpy(rng.uniform(0.0, 1.0, size=(STEPS, 2)).astype(np.float32)).to(dev)
    eu = ExponentialUtility(EU_GAMMA)
    k5_cases = {
        # market buys each step, masked at the inventory bound: unmasked, the
        # money pump takes the value below -8,800 and exp overflows (the
        # reward then 0 x -inf = NaN, as in JAX)
        "eu_fixed_lam": (det.fixed_rollout_params(dataclasses.replace(
            lam_env_config(num_trajectories=N_MAIN), reward_function=eu, mask_market_orders_at_max_inventory=True),
            [0.6, 0.6, 0.7, 0.2]), ()),
        "eu_table": (det.cj_rollout_params(dataclasses.replace(cj_base, reward_function=eu), cj_agent),
                     tuple(torch.as_tensor(t, device=dev) for t in det.cj_depth_tables(cj_agent))),
        "eu_schedule_oe": (det.schedule_rollout_params(dataclasses.replace(oe_base, reward_function=eu)), (oe_table,)),
        "schedule_lam": (det.schedule_rollout_params(lam_env_config(num_trajectories=N_MAIN)), (lam_table,)),
        "schedule_touch": (det.schedule_rollout_params(touch_env_config(num_trajectories=N_MAIN)), (touch_table,)),
    }
    for label, (p, tables) in k5_cases.items():
        check((p.reward_kind == "exp_utility") == label.startswith("eu"), f"phase 26a: {label} {p}")
        c = rng.uniform(size=(p.run_steps, p.n_channels, N_MAIN)).astype(np.float32)
        c[:, 4:] = rng.normal(size=(p.run_steps, p.n_channels - 4, N_MAIN)).astype(np.float32)
        for mode, kw in (("noise", {"noise": torch.from_numpy(c).to(dev)}), ("native", {"seed": 71, "device": dev})):
            for stats in (True, False):
                extra = {"stats_only": stats, "final_obs": not stats}
                got = det.det_rollout(p, tables, num_trajectories=N_MAIN, **kw, **extra)
                again = det.det_rollout(p, tables, num_trajectories=N_MAIN, **kw, **extra)
                want = det.det_rollout_plain(p, tables, num_trajectories=N_MAIN, **kw, **extra)
                torch.cuda.synchronize()
                at = f"phase 26a K5 {label} {'stats' if stats else 'streams'} {mode} at {N_MAIN}x{p.run_steps}"
                err["K5"] = max(err["K5"], compare_outputs(torch, got, want, N_MAIN, at, streams=not stats))
                check_repeat(torch, (dict(enumerate(got)),), (dict(enumerate(again)),), at)
                if label == "schedule_lam" and not stats and mode == "native":
                    check(bool((got[1][:, 2:] > 0.5).any()), "phase 26a: no market order on the lam schedule")
                del got, again, want
    # K4 at S = 5, A = 1 on the first minibatch of config 6's native rollout
    obs_t, actions_t, log_probs, values, rewards = speed_rollout
    adv, returns = compute_gae(rewards, values, torch.zeros_like(values[0]), 1.0, 0.95)
    nb = SPEED_N // PPO_MINIBATCHES
    mb = [x[..., :nb] for x in (obs_t, actions_t, log_probs, adv, returns)]
    mb[3] = normalise(mb[3])
    moved = copy.deepcopy(speed_model)
    with torch.no_grad():
        moved.log_std.add_(0.05)
    for dtype in ("float32", "bfloat16"):
        grads, metrics = fused_ppo.ppo_fused_grads_T(moved, *mb, compute_dtype=dtype)
        again = fused_ppo.ppo_fused_grads_T(moved, *mb, compute_dtype=dtype)
        want_g, want_m = fused_ppo.ppo_fused_grads_T_plain(moved, *mb, compute_dtype=dtype)
        torch.cuda.synchronize()
        at = f"phase 26a K4 S=5 A=1 {dtype} at {STEPS}x{nb}"
        err["K4"] = max(err["K4"], compare_grads(torch, grads, metrics, want_g, want_m, dtype, at))
        check_repeat(torch, (grads, metrics), again, at)
    del speed_rollout, obs_t, actions_t, log_probs, values, rewards, adv, returns, again
    print(f"phase 26a ok in {time.perf_counter() - t0:.1f} s")

    # ---- phase 26b: the OE learning gate (tests/test_convergence.py:317-
    # 350, JAX's TPU-only gate), not cut: 8,192 x 200, phi 2e-3, alpha 0.1,
    # normalised spaces, 256x256 shared trunk, 1 epoch of 4 minibatches,
    # lr 1e-3, bf16, 200 fully fused iterations; the deterministic policy
    # must capture 90% of the closed-form schedule's saving over holding.
    # K3 x1 and K4 x4 per iteration, nothing else; the metric bands on
    # each; evaluate_policy(auto) on K3 within 4 standard errors of the
    # engine.
    t0 = time.perf_counter()
    raw_gate = oe_env_config(num_trajectories=OE_GATE_N, per_step_inventory_aversion=OE_GATE_PHI,
                             terminal_inventory_aversion=OE_GATE_ALPHA)
    gate = dataclasses.replace(raw_gate, **norm)
    oe_agent = CarteaJaimungalOeAgent.from_config(raw_gate, phi=OE_GATE_PHI, alpha=OE_GATE_ALPHA)
    cf = float(rollout(raw_gate, oe_agent.policy(), None, 7, backend="engine").trajectory.rewards.sum(dim=0).mean())
    hold = -OE_GATE_ALPHA * float(raw_gate.initial_inventory) ** 2
    gate_cfg = PPOConfig(hidden=(256, 256), gamma=1.0, gae_lambda=0.95, n_epochs=1, n_minibatches=4, shuffle=False,
                         compute_dtype="bfloat16", shared_trunk=True, learning_rate=1e-3, fused_rollout=True,
                         fused_update=True)
    ts = init_train_state(gate, gate_cfg, 0)
    per_iteration = {"mlp_rollout": 1, "ppo_fused_grads_T": gate_cfg.n_minibatches}
    history = []
    t1 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        for i in range(OE_GATE_ITERATIONS):
            _build.reset_launch_counts()
            ts, metrics = train_iteration(gate, gate_cfg, ts, 1 + i)
            counts = dict(_build.launch_counts)
            want = {name: per_iteration.get(name, 0) for name in counts}
            check(counts == want, f"phase 26b iteration {i + 1}: launches {counts}, want {want}")
            add_launches()
            history.append(assert_metric_bands(metrics, f"phase 26b iteration {i + 1}")["mean_episode_reward"])
    train_s = time.perf_counter() - t1
    decision = dispatch_report(gate, deterministic_policy(gate), mode="evaluate", platform=dev, policy_params=ts.params)
    check((decision.backend, decision.family) == ("fused", "mlp_rollout"), f"phase 26b evaluate dispatch: {decision}")
    _build.reset_launch_counts()
    det_reward = float(evaluate_policy(gate, ts.params, 9, n_episodes=2))
    torch.cuda.synchronize()
    counts = {name: c for name, c in _build.launch_counts.items() if c}
    check(counts == {"mlp_rollout": 2}, f"phase 26b evaluate_policy(auto) launches {counts}")
    add_launches()
    saving = oe_saving(det_reward, cf, hold)
    engine = float(evaluate_policy(gate, ts.params, 10, n_episodes=2, backend="engine"))
    with torch.no_grad():
        spread = rollout(gate, deterministic_policy(gate), ts.params, 11, backend="engine").trajectory.rewards.sum(0)
    se = float(spread.std()) * (2.0 / (2 * OE_GATE_N)) ** 0.5
    print(f"phase 26b [{card}] fused PPO on optimal execution at {OE_GATE_N}x{gate.n_steps}: {OE_GATE_ITERATIONS} "
          f"iterations in {train_s:.1f} s, mean_episode_reward first 5 {history[:5]}, last 5 {history[-5:]}; "
          f"evaluate_policy(auto) (K3 x2) {det_reward}, closed-form schedule on the engine {cf}, holding {hold}: "
          f"saving {saving} (bar {OE_GATE_BAR})")
    print(f"phase 26b evaluate_policy of the trained policy, 2 episodes each: auto (K3) {det_reward}, engine {engine}, "
          f"{abs(det_reward - engine) / se:.2f} se")
    check(abs(det_reward - engine) <= 4 * se, f"phase 26b: evaluate_policy auto {det_reward} vs engine {engine}, se {se}")
    check(saving > OE_GATE_BAR, f"phase 26b: saving {saving} not above {OE_GATE_BAR}")
    del ts
    print(f"phase 26b ok in {time.perf_counter() - t0:.1f} s")

    # ---- phase 26c: bench_suite config 6 at full width (262,144 envs,
    # 256x256, 16 minibatches, bf16), both layouts: fully fused iterations
    # (K3 x1 + K4 x16 each, no RuntimeWarning, the bands), timed and
    # profiled; the engine iteration on the shared trunk; K3 speed's device
    # time beside K3 PnL's on the same trunk in this call; K4 at S = 5,
    # A = 1 timed
    t0 = time.perf_counter()
    env_steps = SPEED_N * cfg6.n_steps
    k3 = {}
    pnl_cfg = dataclasses.replace(as_env_config(num_trajectories=SPEED_N), **norm)
    pnl_p = mr.rollout_params_from_config(pnl_cfg)
    p6 = mr.rollout_params_from_config(cfg6)
    for layout in ("shared trunk", "towers"):
        pcfg = PPOConfig(hidden=(256, 256), n_epochs=1, n_minibatches=PPO_MINIBATCHES, shuffle=False,
                         compute_dtype="bfloat16", shared_trunk=layout == "shared trunk", fused_rollout=True,
                         fused_update=True)
        ts = init_train_state(cfg6, pcfg, 80)
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            for i in range(SPEED_ITERATIONS):
                _build.reset_launch_counts()
                ts, metrics = train_iteration(cfg6, pcfg, ts, 81 + i)
                torch.cuda.synchronize()
                counts = {name: c for name, c in _build.launch_counts.items() if c}
                check(counts == {"mlp_rollout": 1, "ppo_fused_grads_T": PPO_MINIBATCHES},
                      f"phase 26c {layout} iteration {i + 1}: launches {counts}")
                add_launches()
                assert_metric_bands(metrics, f"phase 26c {layout} iteration {i + 1}")
            ms = cuda_ms(torch, lambda: train_iteration(cfg6, pcfg, ts, 90), warmup=0, reps=1)
        print(f"phase 26c [{card}] fused train_iteration on config 6 ({SPEED_N}x{cfg6.n_steps}, 16 minibatches), "
              f"{layout}: {ms} ms = {env_steps / ms * 1e3} env-steps/s; launches per iteration K3 x1 + K4 x16")
        profile_iteration(torch, card, f"fused train_iteration on config 6, {layout}, at {SPEED_N}x{cfg6.n_steps}",
                          lambda: train_iteration(cfg6, pcfg, ts, 91), phase=26)
        if layout == "shared trunk":
            engine_cfg = dataclasses.replace(pcfg, fused_rollout=False, fused_update=False)
            e_ms = cuda_ms(torch, lambda: train_iteration(cfg6, engine_cfg, ts, 92), warmup=1, reps=1)
            print(f"phase 26c [{card}] engine train_iteration on config 6 ({SPEED_N}x{cfg6.n_steps}), {layout}: "
                  f"{e_ms} ms = {env_steps / e_ms * 1e3} env-steps/s")
            profile_iteration(torch, card, f"engine train_iteration on config 6, {layout}, at {SPEED_N}x{cfg6.n_steps}",
                              lambda: train_iteration(cfg6, engine_cfg, ts, 93), phase=26)
        params = ts.params
        speed_ms = kernel_ms(torch, lambda: mr.mlp_rollout(p6, params, 9, SPEED_N, device=dev), warmup=1, reps=5,
                             label=f"phase 26c K3 speed {layout} at {SPEED_N}x{cfg6.n_steps}")
        pnl_model = narrow_copy(torch, params, 4, 2, dev)
        pnl = kernel_ms(torch, lambda: mr.mlp_rollout(pnl_p, pnl_model, 9, SPEED_N, device=dev), warmup=1, reps=5,
                        label=f"phase 26c K3 pnl {layout} at {SPEED_N}x{pnl_p.run_steps}")
        towers = 1 if layout == "shared trunk" else 2
        b = k3_bound(SPEED_N, STEPS, 5, 1, towers)
        plain_ms = plain_k3_ms[f"speed bf16 {layout}"]
        k3[layout] = (speed_ms[0], speed_ms[1], plain_ms, b[0], pnl[0])
        print(kernel_row("26c", card, f"K3 speed {layout}", f"{SPEED_N}x{STEPS}", env_steps, *speed_ms, *b, plain_ms)
              + f"; PnL (limit, S = 4, A = 2) on the same trunk {pnl[0]} ms (call {pnl[1]} ms)"
              + (f"; phase 12's PnL K3 {k3_pnl_ms} ms" if layout == "shared trunk" and k3_pnl_ms else ""))
        del ts, params
    # K3 speed on the float32 path (the raw OE spaces) at config 6's shape
    raw_model = model_for(raw6, 63)
    raw_p = mr.rollout_params_from_config(raw6)
    f32_ms = kernel_ms(torch, lambda: mr.mlp_rollout(raw_p, raw_model, 9, SPEED_N, device=dev), warmup=1, reps=3,
                       label=f"phase 26c K3 speed float32 shared trunk at {SPEED_N}x{STEPS}")
    f32_b = k3_bound(SPEED_N, STEPS, 5, 1, peak=FP32_OPS_PER_S)
    print(kernel_row("26c", card, "K3 speed float32 shared trunk", f"{SPEED_N}x{STEPS}", env_steps, *f32_ms, *f32_b,
                     plain_k3_ms["speed float32 shared trunk"]))
    # K3's exponential utility and t0 plane at config 5's shape (limit
    # dynamics, normalised, shared trunk): the reward branch, and the
    # general instantiation's extras variant with per-env starts on the grid
    extra_ms = {}
    eu5 = dataclasses.replace(pnl_cfg, reward_function=ExponentialUtility(EU_GAMMA))
    late5 = dataclasses.replace(pnl_cfg, start_time=("uniform", 0.0, 0.5))
    steps5 = torch.randint(0, 101, (SPEED_N,), generator=torch.Generator(dev).manual_seed(96), device=dev)
    t0_5 = steps5.to(torch.float32) * late5.step_size
    model5 = model_for(pnl_cfg, 97)
    for tag, cfg, t0_arg in (("exp_utility", eu5, None), ("t0", late5, t0_5)):
        p5 = mr.rollout_params_from_config(cfg)
        ms = kernel_ms(torch, lambda: mr.mlp_rollout(p5, model5, 9, SPEED_N, device=dev, t0=t0_arg), warmup=1, reps=5,
                       label=f"phase 26c K3 {tag} shared trunk at {SPEED_N}x{STEPS}")
        plain_ms = cuda_ms(torch, lambda: mr.mlp_rollout_plain(p5, model5, 9, SPEED_N, device=dev, t0=t0_arg),
                           warmup=0, reps=1)
        b = k3_bound(SPEED_N, STEPS, 4, 2)
        extra_ms[tag] = (ms[0], ms[1], plain_ms, b[0])
        print(kernel_row("26c", card, f"K3 {tag} shared trunk", f"{SPEED_N}x{STEPS}", env_steps, *ms, *b, plain_ms))
    extra_ms["speed_float32"] = (f32_ms[0], f32_ms[1], plain_k3_ms["speed float32 shared trunk"], f32_b[0])
    k4_ms = kernel_ms(torch, lambda: fused_ppo.ppo_fused_grads_T(moved, *mb), warmup=2, reps=10,
                      label=f"phase 26c K4 S=5 A=1 at {STEPS}x{nb}")
    k4_plain_ms = cuda_ms(torch, lambda: fused_ppo.ppo_fused_grads_T_plain(moved, *mb), warmup=1, reps=3)
    k4_bound = bound_ms((5 + 1 + 3) * 4 * STEPS * nb, ppo_grad_flops_per_sample(5, 256, 256, 1) * STEPS * nb,
                        BF16_OPS_PER_S)
    print(kernel_row("26c", card, "K4 ppo_fused_grads_T S=5 A=1 bf16 (one minibatch)", f"{STEPS}x{nb}", STEPS * nb,
                     *k4_ms, *k4_bound, k4_plain_ms))
    del mb, moved
    print(f"phase 26c ok in {time.perf_counter() - t0:.1f} s")

    # ---- phase 26d: two implementations of one contract, each pair within
    # 4 standard errors.  Random starts: evaluate_policy fused (K3, t0
    # plane) against the engine, one episode a key, the key's first draw the
    # shared start of both; the exponential utility's fixed quotes through
    # rollout(auto) (K5) against the engine; the schedule kind on lam (K5)
    # against the engine with the same table as a time-indexed policy
    t0 = time.perf_counter()
    late_model = model_for(late, 95)
    fused_r, engine_r, var = [], [], 0.0
    for key in range(4):
        with torch.no_grad():
            tb = mr.collect_rollout_fused_T(late, late_model, make_generator(100 + key, dev), device=dev)
            res = rollout(late, deterministic_policy(late), late_model, 100 + key, backend="engine")
        t_fused, t_engine = float(tb.obs_t[0, TIME_INDEX, 0]), float(res.trajectory.observations[0, 0, TIME_INDEX])
        check(t_fused == t_engine, f"phase 26d: key {100 + key} starts at {t_fused} fused, {t_engine} engine")
        _build.reset_launch_counts()
        fused_r.append(float(evaluate_policy(late, late_model, 100 + key, backend="fused")))
        check(_build.launch_counts["mlp_rollout"] == 1, "phase 26d: evaluate_policy(fused) did not launch K3 once")
        add_launches()
        total = res.trajectory.rewards.sum(dim=0)
        engine_r.append(float(total.mean()))
        var += 2.0 * float(total.var()) / KIND_N
        del tb, res
    se = var ** 0.5 / 4
    diff = abs(statistics.mean(fused_r) - statistics.mean(engine_r))
    print(f"phase 26d random-start evaluate_policy at {KIND_N}x{late.n_steps}, 4 episodes: fused (K3 t0) {fused_r}, "
          f"engine {engine_r}, {diff / se:.2f} se")
    check(diff <= 4 * se, f"phase 26d random starts: fused {fused_r} vs engine {engine_r}, se {se}")
    eu_cfg = dataclasses.replace(as_env_config(num_trajectories=N_MAIN), reward_function=ExponentialUtility(EU_GAMMA))
    pol = fixed_action_policy([0.7, 0.9])
    d = dispatch_report(eu_cfg, pol, platform=dev)
    check((d.backend, d.family) == ("fused", "fixed"), f"phase 26d exponential utility dispatch: {d}")

    def agree(label, fused_total, engine_total):
        se = (float(fused_total.var()) / fused_total.numel() + float(engine_total.var()) / engine_total.numel()) ** 0.5
        a, b = float(fused_total.mean()), float(engine_total.mean())
        print(f"phase 26d {label}: fused (K5) {a} vs engine {b}, {abs(a - b) / se:.2f} se")
        check(abs(a - b) <= 4 * se, f"phase 26d {label}: {a} vs {b}, se {se}")

    _build.reset_launch_counts()
    fused_eu = rollout(eu_cfg, pol, None, 110).trajectory.rewards.sum(dim=0)
    check({k: c for k, c in _build.launch_counts.items() if c} == {"det_rollout": 1},
          f"phase 26d: rollout(auto) launches {dict(_build.launch_counts)}")
    add_launches()
    agree("exponential utility, fixed quotes (0.7, 0.9), rollout(auto)", fused_eu,
          rollout(eu_cfg, pol, None, 111, backend="engine").trajectory.rewards.sum(dim=0))
    lam_cfg = lam_env_config(num_trajectories=N_MAIN)
    p = det.schedule_rollout_params(lam_cfg)
    _build.reset_launch_counts()
    fused_lam = det.schedule_rollout(p, lam_table, 112, N_MAIN, device=dev)[4].sum(dim=0)
    add_launches()
    dt = lam_cfg.step_size

    def table_policy(params, obs, state):
        row = torch.clamp(torch.round(obs[:, TIME_INDEX] / dt).long(), max=STEPS - 1)
        return lam_table[row]

    agree("schedule on lam", fused_lam, rollout(lam_cfg, table_policy, None, 113, backend="engine")
          .trajectory.rewards.sum(dim=0))
    sched_ms = {}
    for tag, (p, tables) in k5_cases.items():
        ms = kernel_ms(torch, lambda: det.det_rollout(p, tables, 9, N_MAIN, final_obs=True, device=dev), warmup=2,
                       reps=10)
        plain_ms = cuda_ms(torch, lambda: det.det_rollout_plain(p, tables, 9, N_MAIN, final_obs=True, device=dev),
                           warmup=1, reps=1)
        s_dim, a_dim = len(p.obs_low), p.a_dim
        floats = p.run_steps * (s_dim + a_dim + 3) + s_dim
        b = bound_ms(4 * floats * N_MAIN, K5_SLICE15_OPS[tag] * N_MAIN * p.run_steps, FP32_OPS_PER_S)
        sched_ms[tag] = (ms[0], ms[1], plain_ms, b[0])
        print(kernel_row("26d", card, f"K5 {tag} streams", f"{N_MAIN}x{p.run_steps}", N_MAIN * p.run_steps, *ms, *b,
                         plain_ms))
    print(f"phase 26d ok in {time.perf_counter() - t0:.1f} s")

    # ---- phase 26e: the new instantiations' registers and spills (ptxas
    # -v of the builds above): K3's speed kind (kDyn 3) on the plain and
    # general processes and the extras variants (the fourth template
    # argument, kExtra, 1) of every kind; K5's schedule kind on lam and
    # touch (kDyn 2 and 3, kPol 2) and its exponential-utility kernels
    # (det_rollout_kernel_utility, on the general processes); none spills.  HMMA
    # > 0 in K3's bf16 speed and extras instantiations, 0 in the float32
    # ones.
    k3_rows = kernel_registers(_build.ptxas_reports.get("mlp_rollout.cu", ""), ("mlp_rollout_kernel",))
    k5_rows = kernel_registers(_build.ptxas_reports.get("det_rollout.cu", ""), ("det_rollout_kernel",))
    new_k3 = [(e, u) for e, u in k3_rows if re.search(K3_NEW_INSTANTIATIONS, e)]
    new_k5 = [(e, u) for e, u in k5_rows if re.search(K5_NEW_INSTANTIATIONS, e)]
    check(len(new_k3) == 12 and len(new_k5) == 24 + 36,
          f"phase 26e: {len(new_k3)} new K3 and {len(new_k5)} new K5 instantiations, not 12 and 60")
    for entry, usage in new_k3 + new_k5:
        print(f"phase 26e registers {entry[:110]}: {usage}")
        check(spill_bytes(usage) == 0, f"phase 26e: {entry} spills: {usage}")
    import shutil
    from pathlib import Path

    cuobjdump = shutil.which("cuobjdump") or str(Path(_build.nvcc()).parent / "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(_build.build("mlp_rollout.cu"))], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    hmma = {e: n for e, n in sass_counts(sass, "HMMA", ("mlp_rollout_kernel",)).items()
            if re.search(K3_NEW_INSTANTIATIONS, e)}
    check(len(hmma) == 12, f"phase 26e: {len(hmma)} new K3 instantiations in the SASS, not 12")
    for entry, n in sorted(hmma.items()):
        bf16 = bf16_instantiation(entry)
        print(f"phase 26e K3 {entry[:100]}: {n} HMMA ({'bf16' if bf16 else 'float32'})")
        check(n > 0 if bf16 else n == 0, f"phase 26e: {n} HMMA in {entry}")

    print(f"phase 26 launches on the slice's main path (26b-26d): { {k: c for k, c in path.items() if c} }")
    for name in ("mlp_rollout", "ppo_fused_grads_T", "det_rollout"):
        check(path[name] > 0, f"phase 26: {name} was not launched on the slice's main path")
    print(f"phase 26 ok in {time.perf_counter() - t_start:.1f} s")
    return speed_figures(err, path, k3, (k4_ms[0], k4_ms[1], k4_plain_ms, k4_bound[0]), sched_ms, extra_ms)


# ------------------------------------------------------------------ the compiled entry points
COMPILED_CHUNK = 4  # phase 27c's jit_train_chunk
REINFORCE_N, REINFORCE_T, REINFORCE_EPOCHS = 256, 20, 3  # phase 22d's REINFORCE setting, 3 epochs
TIMED_CALLS = 3  # phase 27d's timed calls of each path and mode, after one untimed (median)


def same_bits(torch, a, b):
    """Whether ``a`` and ``b`` (tensors, generators, modules, optimizers and
    nested tuples, lists and dicts of them) hold the same bits: tensors
    equal in dtype, shape and value (NaN where the other is NaN),
    generators in the same state, an Adam's per-parameter state in order."""
    if isinstance(a, torch.Tensor):
        return (a.dtype == b.dtype and a.shape == b.shape
                and bool(torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(), b.nan_to_num())))
    if isinstance(a, torch.Generator):
        return bool(torch.equal(a.get_state(), b.get_state()))
    if isinstance(a, torch.nn.Module):
        return same_bits(torch, a.state_dict(), b.state_dict())
    if isinstance(a, torch.optim.Optimizer):
        states = [[s.get(p, {}) for p in g["params"]] for opt, s in ((a, a.state), (b, b.state))
                  for g in opt.param_groups]
        return same_bits(torch, states[0], states[1])
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_bits(torch, a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same_bits(torch, x, y) for x, y in zip(a, b))
    return a == b


def wall_ms(torch, fn, calls=TIMED_CALLS, warmup=1):
    """Host-clock milliseconds of each of ``calls`` calls of ``fn``, the card
    synchronised around each, after ``warmup`` untimed calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def compiled_phases(torch, np, card, dev):
    """Phase 27: the compiled entry points (``mbt_gym_torch.compiled``).
    (a) ``jit_rollout(backend="engine")`` bit for bit ``rollout(backend=
    "engine")`` for the same int key, at the first (capturing) call and at
    a replay: AS 16,384 x 200, CJ 16,384 x 1,000, OE 8,192 x 200, config
    14's processes at 16,384 x 200 and the deterministic policy of a
    256x256 trunk on the normalised AS env at 16,384 x 200; (b) two
    ``jit_train_iteration``s at config 5 bit for bit two eager
    ``train_iteration``s (params, Adam state, metrics) on the engine, on
    ``fused_update`` (shared trunk, K7 x16; towers, K4 x16) and fully fused
    (K3 x1 + K4 x16), each replay's launches counted, two traced replays
    naming K3's and K4's kernels; (c) ``jit_train_chunk(4)`` bit for bit
    four ``jit_train_iteration``s, and ``jit_train_epoch`` bit for bit eager
    REINFORCE at 256 x 20; (d) eager against captured ms, env-steps/s and
    idle share, the first call's capture seconds and the graph pool's
    bytes: the AS engine rollout at 16,384 x 200, config 14's 8 engine
    episodes, the engine iteration (contiguous minibatches, as phases 12,
    24c and 26c run it) at configs 5, 6 and 10, and config 5 fully fused;
    (e) ``jit_train_iteration(mesh=)`` over an NCCL group of world size 1
    bit for bit ``train_iteration(mesh=)``, engine and fully fused; (f) a
    capture that holds a host read raises, nothing falls back, the caller's
    stream is current again and 8 GiB made, used across streams and freed
    after it leave no more reserved than before.
    Returns the kernels-line figures."""
    import dataclasses

    from mbt_gym_torch import compiled, init_train_state, jit_rollout, rollout, train_chunk, train_iteration
    from mbt_gym_torch.agents import reinforce
    from mbt_gym_torch.agents.baseline import (
        AvellanedaStoikovAgent, CarteaJaimungalMmAgent, CarteaJaimungalOeAgent, fixed_action_policy,
    )
    from mbt_gym_torch.agents.networks import init_actor_critic
    from mbt_gym_torch.agents.ppo import PPOConfig, deterministic_policy, jit_train_chunk, jit_train_iteration
    from mbt_gym_torch.ops import _build
    from mbt_gym_torch.ops import mlp_rollout as mr
    from mbt_gym_torch.utils.config import as_env_config, cj_env_config, composite_env_config, oe_env_config

    t_start = time.perf_counter()
    norm = dict(normalise_observation_space=True, normalise_action_space=True)
    _build.reset_launch_counts()
    path = {name: 0 for name in _build.launch_counts}

    def add_launches():
        for name, c in _build.launch_counts.items():
            path[name] += c
        _build.reset_launch_counts()

    def entry_line():
        info = compiled.cache_info()
        if not info:
            return "no capture (the eager function ran)"
        return (f"capture {info[-1]['capture_seconds']:.2f} s, pool {info[-1]['pool_bytes']} bytes, replay launches "
                f"{info[-1]['launches']}")

    figures = {}

    def compare_modes(label, env_steps, eager_fn, jit_fn, first_call_s, profiled=None, k3_ms=None):
        """27d's row: eager and captured ms (host clock, the median of
        :data:`TIMED_CALLS` calls after one untimed), env-steps/s and
        idle share (one profiled call each, or of ``profiled``'s eager and
        captured calls, a part of the work that repeats), the first call's
        seconds, its warm-up and capture seconds and the graph pool's
        bytes.  Where a profile lost the record of the call's one K3 launch
        (CUPTI drops one now and then), ``k3_ms``, K3's device time at the
        shape, is added to the busy time and the line says so."""
        info = compiled.cache_info()
        row = {"first_call_s": first_call_s, "capture_s": sum(e["capture_seconds"] for e in info),
               "pool_bytes": sum(e["pool_bytes"] for e in info)}
        for mode, fn, part in zip(("eager", "captured"), (eager_fn, jit_fn), profiled or (eager_fn, jit_fn)):
            times = wall_ms(torch, fn)
            prof = profile_iteration(torch, card, f"{mode} {label}" + (", one episode" if profiled else ""), part,
                                     phase=27, top=3)
            add_launches()
            busy = prof.get("busy_ms")
            if k3_ms is not None and busy is not None and not any("mlp_rollout_kernel" in n for n in prof["by_name"]):
                busy += k3_ms
                print(f"phase 27d {mode} {label}: the profile lost K3's record; its device time {k3_ms} ms added")
            ms = statistics.median(times)
            if profiled and busy is not None:  # the profiled part is one of COMPOSITE_EPISODES
                busy *= COMPOSITE_EPISODES
            # the profiler lengthens a short call's wall time: the idle share
            # of an unprofiled call (its busy time taken from the profile) too
            row[mode] = {"ms": ms, "calls_ms": times, "env_steps_per_s": env_steps / ms * 1e3, "busy_ms": busy,
                         "idle_share": None if busy is None else 1 - busy / (prof["wall_ms"] * (
                             COMPOSITE_EPISODES if profiled else 1)),
                         "idle_share_unprofiled": None if busy is None else max(0.0, 1 - busy / ms)}
            print(f"phase 27d [{card}] {mode} {label}: {ms} ms (calls {times}) = "
                  f"{row[mode]['env_steps_per_s']} env-steps/s, "
                  f"device busy {busy} ms, idle share {row[mode]['idle_share']} under the profiler, "
                  f"{row[mode]['idle_share_unprofiled']} of the unprofiled call")
        print(f"phase 27d [{card}] captured {label}: first call {row['first_call_s']:.2f} s (warm-up and capture "
              f"{row['capture_s']:.2f} s), graph pool {row['pool_bytes']} bytes; captured / eager = "
              f"{row['captured']['ms'] / row['eager']['ms']:.3f}")
        figures[label] = row

    # ---- 27a: the engine episode, captured, against rollout(engine)
    t0 = time.perf_counter()
    as_cfg = as_env_config(num_trajectories=N_MAIN)
    cj_cfg = cj_env_config(num_trajectories=CJ_N, max_inventory=100.0)
    oe_cfg = oe_env_config(num_trajectories=OE_N)
    c14 = composite_env_config(num_trajectories=KIND_N)
    eval_cfg = dataclasses.replace(as_env_config(num_trajectories=EVAL_N), **norm)
    model = init_actor_critic(5, 4, 2, hidden=(256, 256), shared_trunk=True, device=dev)
    cases = {
        f"AS {N_MAIN}x{as_cfg.n_steps}": (as_cfg, AvellanedaStoikovAgent.from_config(as_cfg).policy(), None),
        f"CJ {CJ_N}x{cj_cfg.n_steps}": (cj_cfg, CarteaJaimungalMmAgent.from_config(cj_cfg, max_inventory=100).policy(),
                                        None),
        f"OE {OE_N}x{oe_cfg.n_steps}": (oe_cfg, CarteaJaimungalOeAgent.from_config(oe_cfg, phi=2e-4, alpha=0.01)
                                        .policy(), None),
        f"config 14's processes {KIND_N}x{c14.n_steps}": (c14, fixed_action_policy(COMPOSITE_ACTION), None),
        f"deterministic policy, 256x256, {EVAL_N}x{eval_cfg.n_steps}": (eval_cfg, deterministic_policy(eval_cfg),
                                                                       model),
    }
    for label, (cfg, policy, params) in cases.items():
        want = rollout(cfg, policy, params, 41, backend="engine")
        first = jit_rollout(cfg, policy, params, 41, backend="engine")
        replayed = jit_rollout(cfg, policy, params, 41, backend="engine")
        other = jit_rollout(cfg, policy, params, 42, backend="engine")
        torch.cuda.synchronize()
        check(same_bits(torch, first, want) and same_bits(torch, replayed, want),
              f"phase 27a {label}: jit_rollout is not rollout(engine) bit for bit")
        check(not torch.equal(other.trajectory.rewards, want.trajectory.rewards),
              f"phase 27a {label}: another key replayed the same episode")
        print(f"phase 27a [{card}] jit_rollout(engine) {label}: bitwise rollout(engine) at the capture and at a "
              f"replay, the final generator state too; {entry_line()}")
        compiled.clear_cache()
        del want, first, replayed, other
    print(f"phase 27a ok in {time.perf_counter() - t0:.1f} s")

    # ---- 27b: jit_train_iteration at config 5, bitwise the eager iterations
    t0 = time.perf_counter()
    env5 = dataclasses.replace(as_env_config(num_trajectories=PPO_N), **norm)
    base = dict(hidden=(256, 256), n_epochs=1, n_minibatches=PPO_MINIBATCHES, compute_dtype="bfloat16")
    learners = {
        # the engine iteration of phases 12, 24c and 26c: contiguous minibatches
        "engine (shared trunk, autograd)": (PPOConfig(**base, shared_trunk=True, shuffle=False), {}),
        "fused_update, shared trunk (K7)": (PPOConfig(**base, shared_trunk=True, fused_update=True),
                                            {"ppo_fused_grads": PPO_MINIBATCHES}),
        "fused_update, towers (K4)": (PPOConfig(**base, shared_trunk=False, fused_update=True),
                                      {"ppo_fused_grads_T": PPO_MINIBATCHES}),
        "fully fused, shared trunk (K3 + K4)": (PPOConfig(**base, shared_trunk=True, fused_update=True,
                                                          fused_rollout=True, shuffle=False),
                                                {"mlp_rollout": 1, "ppo_fused_grads_T": PPO_MINIBATCHES}),
    }
    fused_cfg = None
    for label, (pcfg, per_iteration) in learners.items():
        ts0 = init_train_state(env5, pcfg, 60)
        check(all(g["capturable"] for g in ts0.opt_state.param_groups),
              f"phase 27b {label}: the card's Adam is not capturable")
        eager, ts = [], ts0
        for k in (61, 62):
            ts, m = train_iteration(env5, pcfg, ts, k)
            eager.append((ts, m))
        add_launches()
        captured, ts = [], ts0
        for i, k in enumerate((61, 62)):
            t_first = time.perf_counter()
            ts, m = jit_train_iteration(env5, pcfg, ts, k)
            torch.cuda.synchronize()
            if i == 0:
                first_call_s = time.perf_counter() - t_first
            if i == 1:  # a replay of the cached graph: its launches alone
                counts = {n: c for n, c in _build.launch_counts.items() if c}
                check(counts == per_iteration, f"phase 27b {label}: a replay launches {counts}, want {per_iteration}")
            add_launches()
            captured.append((ts, m))
        for i, ((ets, em), (cts, cm)) in enumerate(zip(eager, captured)):
            check(same_bits(torch, cts.params, ets.params) and same_bits(torch, cts.opt_state, ets.opt_state)
                  and same_bits(torch, cm, em) and cts.update_count == ets.update_count,
                  f"phase 27b {label}: iteration {i + 1} captured is not eager bit for bit")
            assert_metric_bands(cm, f"phase 27b {label} iteration {i + 1}")
        check(same_bits(torch, ts0.params, init_train_state(env5, pcfg, 60).params),
              f"phase 27b {label}: the state given was changed")
        print(f"phase 27b [{card}] jit_train_iteration {label} at config 5: two iterations bitwise the eager "
              f"ones (params, Adam state, metrics), launches per replay {per_iteration}; {entry_line()}")
        if label.startswith(("engine", "fully fused")):  # 27d's config-5 rows, on this capture
            kind = "engine" if label.startswith("engine") else "fully fused"
            k3_ms = None
            if pcfg.fused_rollout:  # timed apart from the main path's launches
                add_launches()
                k3_ms = device_ms(torch, lambda: mr.rollout_fused_T(env5, ts0.params, 66, device=dev))
                _build.reset_launch_counts()
            compare_modes(f"{kind} iteration, config 5 ({PPO_N}x{env5.n_steps})", PPO_N * env5.n_steps,
                          lambda: train_iteration(env5, pcfg, ts0, 65),
                          lambda: jit_train_iteration(env5, pcfg, ts0, 65), first_call_s, k3_ms=k3_ms)
        if pcfg.fused_rollout:
            fused_cfg = (pcfg, ts)
            prof = profile_iteration(torch, card, f"two jit_train_iteration replays, {label}, config 5",
                                     lambda: [jit_train_iteration(env5, pcfg, ts, k) for k in (63, 64)], phase=27,
                                     expect=("mlp_rollout_kernel",) + UPDATE_PASSES)
            names = prof.get("by_name", {})
            for kernel in ("mlp_rollout_kernel",) + UPDATE_PASSES:
                check(any(kernel in name for name in names), f"phase 27b: the trace of two replays names no {kernel}")
            _build.reset_launch_counts()
        else:
            compiled.clear_cache()
        del eager, captured
    print(f"phase 27b ok in {time.perf_counter() - t0:.1f} s")

    # ---- 27c: jit_train_chunk against jit_train_iteration; REINFORCE
    t0 = time.perf_counter()
    pcfg, ts0 = fused_cfg
    from mbt_gym_torch.agents.ppo import iteration_keys

    ts, singles = ts0, []
    for k in iteration_keys(70, COMPILED_CHUNK):
        ts, m = jit_train_iteration(env5, pcfg, ts, k)
        singles.append(m)
    chunk_ts, chunk = jit_train_chunk(env5, pcfg, ts0, 70, COMPILED_CHUNK)
    torch.cuda.synchronize()
    stacked = {k: torch.stack([m[k] for m in singles]) for k in singles[0]}
    check(same_bits(torch, chunk_ts.params, ts.params) and same_bits(torch, chunk_ts.opt_state, ts.opt_state)
          and same_bits(torch, chunk, stacked) and chunk_ts.update_count == ts.update_count,
          "phase 27c: jit_train_chunk(4) is not four jit_train_iterations bit for bit")
    check(chunk["pg_loss"].device.type == "cuda" and tuple(chunk["pg_loss"].shape) == (COMPILED_CHUNK,),
          f"phase 27c: chunk metrics {chunk['pg_loss']}")
    add_launches()
    print(f"phase 27c [{card}] jit_train_chunk({COMPILED_CHUNK}) fully fused at config 5: bitwise "
          f"{COMPILED_CHUNK} jit_train_iterations")
    compiled.clear_cache()
    rf_env = as_env_config(num_trajectories=REINFORCE_N, n_steps=REINFORCE_T)
    rf_cfg = reinforce.ReinforceConfig(hidden=(32, 32), action_std=0.3, learning_rate=1e-2, lr_decay=0.999,
                                       final_action_std=0.1)
    eager = captured = reinforce.init_train_state(rf_env, rf_cfg, 0)
    for e in range(REINFORCE_EPOCHS):
        eager, em = reinforce.train_epoch(rf_env, rf_cfg, eager, 80 + e, REINFORCE_EPOCHS)
        captured, cm = reinforce.jit_train_epoch(rf_env, rf_cfg, captured, 80 + e, REINFORCE_EPOCHS)
        torch.cuda.synchronize()
        check(same_bits(torch, captured.params, eager.params) and same_bits(torch, cm, em)
              and captured.epoch == eager.epoch
              and captured.opt_state.param_groups[0]["lr"] == eager.opt_state.param_groups[0]["lr"],
              f"phase 27c: jit_train_epoch epoch {e + 1} is not train_epoch bit for bit")
    print(f"phase 27c [{card}] jit_train_epoch: {REINFORCE_EPOCHS} REINFORCE epochs at {REINFORCE_N}x{REINFORCE_T} "
          f"bitwise train_epoch (the std schedule and the rate device inputs); {entry_line()}")
    compiled.clear_cache()
    print(f"phase 27c ok in {time.perf_counter() - t0:.1f} s")

    # ---- 27d: eager against captured (config 5's rows come from 27b's
    # captures)
    t0 = time.perf_counter()
    engine_cfg = PPOConfig(**base, shared_trunk=True, shuffle=False)
    cfg6 = dataclasses.replace(oe_env_config(num_trajectories=SPEED_N), **norm)
    cfg10 = dataclasses.replace(composite_env_config(num_trajectories=COMPOSITE_N), normalise_observation_space=True)
    cfg14 = composite_env_config(num_trajectories=COMPOSITE_EVAL_N)
    pol14 = fixed_action_policy(COMPOSITE_ACTION)
    as_pol = cases[f"AS {N_MAIN}x{as_cfg.n_steps}"][1]

    def episodes(run, cfg, policy, count):
        return lambda: [run(cfg, policy, None, 90 + e, backend="engine") for e in range(count)]

    # (label, env-steps, the call given the entry point, the profiled part:
    # one of config 14's episodes, whose eager profile holds ~10^5 events)
    rows = [(f"AS engine rollout {N_MAIN}x{as_cfg.n_steps}", N_MAIN * as_cfg.n_steps,
             lambda run: episodes(run, as_cfg, as_pol, 1), None),
            (f"config 14's {COMPOSITE_EPISODES} engine episodes ({COMPOSITE_EVAL_N}x{cfg14.n_steps})",
             COMPOSITE_EPISODES * COMPOSITE_EVAL_N * cfg14.n_steps,
             lambda run: episodes(run, cfg14, pol14, COMPOSITE_EPISODES), lambda run: episodes(run, cfg14, pol14, 1))]
    for name, cfg, n in (("6", cfg6, SPEED_N), ("10", cfg10, COMPOSITE_N)):
        ts = init_train_state(cfg, engine_cfg, 93)
        rows.append((f"engine iteration, config {name} ({n}x{cfg.n_steps})", n * cfg.n_steps,
                     lambda run, cfg=cfg, ts=ts: (lambda: run(cfg, engine_cfg, ts, 94)), None))
    for label, env_steps, make, part in rows:
        eager, jit = (train_iteration, jit_train_iteration) if "iteration" in label else (rollout, jit_rollout)
        jit_fn = make(jit)
        t_first = time.perf_counter()
        jit_fn()
        torch.cuda.synchronize()
        compare_modes(label, env_steps, make(eager), jit_fn, time.perf_counter() - t_first,
                      profiled=None if part is None else (part(eager), part(jit)))
        compiled.clear_cache()
    print(f"phase 27d ok in {time.perf_counter() - t0:.1f} s")

    # ---- 27e: jit_train_iteration over an NCCL mesh of world size 1 (the
    # all-reduces captured), bitwise train_iteration over the same mesh
    import torch.distributed as dist

    from mbt_gym_torch.parallel import mesh as mesh_lib

    t0 = time.perf_counter()
    mesh_lib.init_distributed(device=dev)
    mesh = mesh_lib.make_mesh()
    small = dataclasses.replace(as_env_config(num_trajectories=4096, n_steps=32), **norm)
    for label, pcfg in (("engine", PPOConfig(hidden=(64, 64), n_epochs=2, n_minibatches=4, shared_trunk=True)),
                        ("fully fused", PPOConfig(hidden=(64, 64), n_epochs=2, n_minibatches=4, shared_trunk=True,
                                                  fused_rollout=True, fused_update=True, shuffle=False))):
        eager = captured = init_train_state(small, pcfg, 7)
        for k in (8, 9):
            eager, em = train_iteration(small, pcfg, eager, k, mesh=mesh)
            captured, cm = jit_train_iteration(small, pcfg, captured, k, mesh=mesh)
            torch.cuda.synchronize()
            check(same_bits(torch, captured.params, eager.params)
                  and same_bits(torch, captured.opt_state, eager.opt_state) and same_bits(torch, cm, em),
                  f"phase 27e {label}: the captured mesh iteration is not eager bit for bit")
        add_launches()
        print(f"phase 27e [{card}] jit_train_iteration(mesh=) {label} over NCCL at world 1, 4096x32: two iterations "
              f"bitwise train_iteration(mesh=); {entry_line()}")
        compiled.clear_cache()
    dist.destroy_process_group()
    print(f"phase 27e ok in {time.perf_counter() - t0:.1f} s")

    # ---- 27f: a capture that holds a host read raises, with no fallback
    def syncing(params, obs, state):
        return obs[:, :2] * float(obs[0, 0] > -1e30)

    small = as_env_config(num_trajectories=1024, n_steps=4)
    before = dict(_build.launch_counts)
    stream = torch.cuda.current_stream()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(dev)
    try:
        jit_rollout(small, syncing, None, 1, backend="engine")
    except RuntimeError as e:
        print(f"phase 27f: a capture holding a host read raised: {str(e).splitlines()[0][:160]}")
    else:
        check(False, "phase 27f: a capture holding a host read did not raise")
    check(compiled.cache_info() == [] and dict(_build.launch_counts) == before,
          "phase 27f: the failed capture left an entry or launches behind")
    check(torch.cuda.current_stream() == stream, "phase 27f: the failed capture left its stream current")
    # the allocator releases what is freed after it (8 GiB made on a side
    # stream and used on this one, as the phases after this one make theirs)
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        x = torch.empty(2 << 30, device=dev)
    x.record_stream(stream)
    x.fill_(1.0)
    del x
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_reserved(dev)
    print(f"phase 27f: {reserved / 2**30:.2f} GiB reserved before the failed capture, {after / 2**30:.2f} GiB after "
          f"it and 8 GiB made, used and freed")
    check(after <= reserved + (64 << 20), "phase 27f: the failed capture left the allocator holding freed memory")

    print(f"phase 27 launches on the slice's main path: { {k: c for k, c in path.items() if c} }")
    for name in ("mlp_rollout", "ppo_fused_grads_T", "ppo_fused_grads"):
        check(path[name] > 0, f"phase 27: {name} was not launched on the slice's main path")
    print(f"phase 27 ok in {time.perf_counter() - t_start:.1f} s: {json.dumps(figures, default=float)}")
    return {
        "K3": {"slice17_launches": path["mlp_rollout"]},
        "K4": {"slice17_launches": path["ppo_fused_grads_T"]},
        "K7": {"slice17_launches": path["ppo_fused_grads"]},
    }


# ------------------------------------------------------------ deep trunks
# phase 28's trunks: JAX's own test trunks (tests/test_fused_ppo.py:30),
# unequal widths the wrappers pad, and the depths K3 takes; each on both
# layouts, and (256,) * 8 on the towers alone (stacked 512 wide)
DEEP_TRUNKS = (((32, 32), (True, False)), ((64,), (True, False)), ((36, 100), (True, False)),
               ((256, 256, 256), (True, False)), ((128,) * 8, (True, False)), ((256,) * 8, (False,)))
DEEP_EDGE = (5, 96)  # 28a's minibatch: 5 steps x 96 envs (1 full and 2 more tiles a step), the card test's edge
DEEP_FULL = (((256, 256, 256), True), ((256, 256, 256), False), ((256,), True))  # 28b's trunks at config 5
DEEP_ITERATIONS = 2  # 28b's eager iterations per trunk, replayed captured
DRIFT_N, DRIFT_T = 64, 8  # 28c: tests/test_fused_ppo.py:82-84's shape
# bf16 limits of the update kernels beyond two layers.  Up to two layers a
# kernel is held to its plain version (float32 sums) as compare_grads holds
# it: 1e-3 per leaf, metrics to rtol 1e-4.  Deeper, a float32 summation-order
# difference flips bf16 roundings of saved activations, which every later
# layer carries on, so two float32 orders drift apart (the plain version
# from its own float64-summed evaluation by up to 2.4e-3 per leaf at eight
# 256-wide layers on the towers, PERF.md section 7).  There a kernel is held
# to the plain version's float64-summed evaluation, at fixed limits by depth
# (three, eight layers) set from the readings of phase 28a and the card
# tests: per leaf a relative Frobenius error, per metric rtol 1e-4 plus a
# share of the metric's terms' mean magnitude (approx_kl averages terms ~100
# times larger than itself, and at eight layers over 160 samples the kernel
# read 3.0e-4 of them)
DEEP_BF16_LIMITS = {3: (1e-3, 1e-4), 8: (5e-3, 1e-3)}  # depth: (leaf bound, metric terms' share)
# 28a's observation and action widths: JAX's test shape, config 10's, the
# all-axes config's and K3's limit (two dW0 sweeps)
DEEP_DIMS = ((4, 2), (8, 4), (9, 4), (16, 4))


def print_memory(torch, dev, label):
    """Release the caching allocator's free blocks and print what it still
    holds."""
    torch.cuda.empty_cache()
    print(f"{label}: {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB allocated, "
          f"{torch.cuda.memory_reserved(dev) / 2**30:.2f} GiB reserved")


def update_samples(torch, np, model, t_steps, nb, seed, dev):
    """Row-major samples of ``model``, ordered (t, env), made with numpy:
    obs uniform on [-1, 1], actions drawn from the policy, old log-probs
    the policy's own with noise of 0.1, normalised advantages, returns."""
    from mbt_gym_torch.agents import networks
    from mbt_gym_torch.agents.ppo import normalise

    rng = np.random.default_rng(seed)
    m = t_steps * nb
    host = lambda x: torch.from_numpy(x.astype(np.float32)).to(dev)  # noqa: E731
    obs = host(rng.uniform(-1.0, 1.0, (m, model.obs_dim)))
    with torch.no_grad():
        mean, _ = networks.policy_value(model, obs, "float32")
        actions = mean + torch.exp(model.log_std) * host(rng.normal(size=(m, model.action_dim)))
        logp = networks.gaussian_log_prob(model, mean, actions)
    return [obs, actions, logp + host(rng.normal(0.0, 0.1, m)), normalise(host(rng.normal(size=m))),
            host(rng.normal(size=m))]


def feature_major(rows, t_steps, nb):
    """Row-major samples ordered (t, env) as K4's (T, C, nb) and (T, nb)."""
    return [x.reshape(t_steps, nb, -1).transpose(1, 2).contiguous() if x.dim() == 2 else x.reshape(t_steps, nb)
            for x in rows]


def leaf_errors(torch, grads, want):
    """{leaf: relative Frobenius error of ``grads`` against ``want``}."""
    return {n: float(torch.linalg.vector_norm(grads[n].double() - w.double())
                     / torch.linalg.vector_norm(w.double()).clamp_min(1e-30)) for n, w in want.items()}


def metric_scales(torch, model, rows, clip_eps=0.2):
    """{metric: the mean absolute per-sample term} of ``model`` on the
    row-major samples ``rows`` (float32, the policy's own forward): the
    scale of what ``pg_loss``, ``vf_loss`` and ``approx_kl`` average, which
    the averages themselves cancel (``approx_kl`` is ~1e-3 of its terms)."""
    from mbt_gym_torch.agents import networks

    obs, actions, old, adv, ret = rows
    with torch.no_grad():
        mean, value = networks.policy_value(model, obs, "float32")
        logp = networks.gaussian_log_prob(model, mean, actions)
        ratio = torch.exp(logp - old)
        pg = -torch.minimum(ratio * adv, torch.clamp(ratio, 1.0 - clip_eps, 1.0 + clip_eps) * adv)
        terms = {"pg_loss": pg, "vf_loss": 0.5 * (value - ret) ** 2, "approx_kl": old - logp}
    return {name: float(t.abs().mean()) for name, t in terms.items()}


def compare_bf16(torch, grads, metrics, want, scales, leaf_bound, terms, label, plain=None):
    """A bf16 update kernel's grads and metrics against ``want`` (grads,
    metrics): each leaf's relative Frobenius error at most ``leaf_bound``;
    each metric within rtol 1e-4 plus ``terms`` of its terms' mean magnitude
    (:func:`metric_scales`, in ``scales``) plus atol 1e-7.  Prints every
    leaf's error and every metric's, each beside the plain version's
    ``plain`` where that is given (``want`` is then the plain version's
    float64-summed evaluation).  Returns the worst leaf error."""
    want_g, want_m = want
    check(set(grads) == set(want_g), f"{label}: grads {sorted(grads)} vs {sorted(want_g)}")
    errs = leaf_errors(torch, grads, want_g)
    line = f"{label}: leaf errors (bound {leaf_bound:.3g}) " + ", ".join(f"{n} {e:.2g}" for n, e in sorted(errs.items()))
    if plain is not None:
        line += "; the plain version's: " + ", ".join(
            f"{n} {e:.2g}" for n, e in sorted(leaf_errors(torch, plain[0], want_g).items()))
    diffs = {name: (abs(float(metrics[name]) - float(w)), 1e-4 * abs(float(w)) + terms * scales[name] + 1e-7)
             for name, w in want_m.items()}
    line += "; metrics off by " + ", ".join(f"{n} {d:.3g} (tolerance {t:.3g})" for n, (d, t) in diffs.items())
    if plain is not None:
        line += "; the plain version's by " + ", ".join(
            f"{n} {abs(float(plain[1][n]) - float(w)):.3g}" for n, w in want_m.items())
    print(line)
    for name, e in errs.items():
        check(e <= leaf_bound, f"{label} {name}: relative Frobenius error {e} above {leaf_bound}")
    for name, (d, t) in diffs.items():
        check(d <= t, f"{label} {name}: {float(metrics[name])} vs {float(want_m[name])}, tolerance {t}")
    return max(errs.values())


def compare_update(torch, grads, metrics, model, args, plain_fn, rows, dtype, label):
    """An update kernel's output on ``args`` against its plain version
    ``plain_fn`` at the limits :func:`deep_bf16_limits` gives ``model``'s
    depth: up to two layers (and in float32 at any depth) as
    :func:`compare_grads` holds it; deeper, bf16, against the plain
    version's float64-summed evaluation by :func:`compare_bf16`.  ``rows``
    are the row-major samples (for the metric scales).  Returns the worst
    bf16 leaf error (0 for float32)."""
    want = plain_fn(model, *args, compute_dtype=dtype)
    depth = len(model.hidden)
    if dtype == "float32" or depth <= 2:
        compare_grads(torch, grads, metrics, *want, dtype, label)
        return 0.0 if dtype == "float32" else max(leaf_errors(torch, grads, want[0]).values())
    ref = plain_fn(model, *args, compute_dtype=dtype, sum_dtype=torch.float64)
    leaf_bound, terms = deep_bf16_limits(depth)
    return compare_bf16(torch, grads, metrics, ref, metric_scales(torch, model, rows), leaf_bound, terms, label,
                        plain=want)


def deep_bf16_limits(depth):
    """(leaf bound, metric terms' share) of a bf16 update kernel on a trunk
    of ``depth`` > 2 layers: :data:`DEEP_BF16_LIMITS`'s three-layer figures
    up to three layers, its eight-layer ones beyond."""
    return DEEP_BF16_LIMITS[3 if depth <= 3 else 8]


def full_minibatch_close(torch, got, want, hidden, scales, label):
    """Phase 28b: a bf16 update kernel's (grads, metrics) ``got`` on config
    5's minibatch of 3,276,800 samples against its plain version's ``want``
    (float32 sums): up to two layers as :func:`compare_grads` holds it,
    deeper at :func:`deep_bf16_limits` (the float64-summed evaluation does
    not fit on the card beside the kernel at this size; the drift between
    two float32 orders shrinks as the sample count grows).  Returns the
    worst leaf error."""
    if len(hidden) <= 2:
        compare_grads(torch, *got, *want, "bfloat16", label)
        return max(leaf_errors(torch, got[0], want[0]).values())
    return compare_bf16(torch, *got, want, scales, *deep_bf16_limits(len(hidden)), label)


def deep_trunk_phases(torch, np, card, dev):
    """Phase 28: K4 and K7 at every trunk shape K3 takes (1-8 layers,
    widths a multiple of 4 up to 256, padded to 64 with exact zeros).
    (a) K4 on both layouts and K7 on the shared trunk against their plain
    versions at :data:`DEEP_TRUNKS` and :data:`DEEP_DIMS`, in bf16 and
    float32 (:func:`compare_update`), each launched twice bitwise;
    (b) the fully fused PPO iteration at config 5's shape through
    ``train_iteration`` and ``jit_train_iteration`` at :data:`DEEP_FULL`,
    the captured iterations bitwise the eager ones, K3 x1 + K4 x16 an
    iteration, with the iteration's ms, K3's and K4's (and K7's) device ms
    against their bounds and the deep instantiation's scratch, and K4 (and
    K7) on the iteration's first minibatch against the plain version
    (:func:`full_minibatch_close`); (c) one float32 iteration with
    ``fused_update`` against the engine's autograd update from the same
    state and key (tests/test_fused_ppo.py:74-113) at (32, 32) and (64,),
    both layouts (K7 on the shared trunk, K4 on the towers).  (Phase 18
    reads the passes' registers, spills and HMMA.)  Returns the
    kernels-line figures of K4 and K7."""
    import dataclasses

    from mbt_gym_torch import compiled, init_train_state, train_iteration
    from mbt_gym_torch.agents.networks import init_actor_critic
    from mbt_gym_torch.agents.ppo import PPOConfig, jit_train_iteration, normalise
    from mbt_gym_torch.ops import _build
    from mbt_gym_torch.ops import fused_ppo
    from mbt_gym_torch.ops import mlp_rollout as mr
    from mbt_gym_torch.utils.config import as_env_config

    t_start = time.perf_counter()
    figures = {"K4": {}, "K7": {}}
    err = {"K4": 0.0, "K7": 0.0}

    # ---- 28a: every trunk against the plain versions
    t0 = time.perf_counter()
    t_steps, nb = DEEP_EDGE
    for hidden, layouts in DEEP_TRUNKS:
        for shared in layouts:
            for s_dim, a_dim in DEEP_DIMS:
                model = init_actor_critic(28, s_dim, a_dim, hidden=hidden, shared_trunk=shared, device=dev)
                with torch.no_grad():
                    model.log_std.add_(0.05)
                rows = update_samples(torch, np, model, t_steps, nb, 280 + s_dim, dev)
                calls = [("K4", fused_ppo.ppo_fused_grads_T, fused_ppo.ppo_fused_grads_T_plain,
                          feature_major(rows, t_steps, nb))]
                if shared:
                    calls.append(("K7", fused_ppo.ppo_fused_grads, fused_ppo.ppo_fused_grads_plain, rows))
                for kernel, fn, plain, args in calls:
                    for dtype in ("bfloat16", "float32"):
                        label = (f"phase 28a {kernel} {'x'.join(map(str, hidden))} "
                                 f"{'shared' if shared else 'towers'} S={s_dim} A={a_dim} {dtype}")
                        grads, metrics = fn(model, *args, compute_dtype=dtype)
                        again = fn(model, *args, compute_dtype=dtype)
                        torch.cuda.synchronize()
                        worst = compare_update(torch, grads, metrics, model, args, plain, rows, dtype, label)
                        err[kernel] = max(err[kernel], worst)
                        check_repeat(torch, (grads, metrics), again, label)
    _build.reset_launch_counts()  # 28a's launches compare; they are not the main path's
    print(f"phase 28a ok in {time.perf_counter() - t0:.1f} s")

    # ---- 28b: the fully fused iteration at config 5's shape, eager and captured
    t0 = time.perf_counter()
    env5 = dataclasses.replace(as_env_config(num_trajectories=PPO_N), normalise_observation_space=True,
                               normalise_action_space=True)
    steps = env5.n_steps
    nb5 = PPO_N // PPO_MINIBATCHES
    m5 = steps * nb5
    per_iteration = {"mlp_rollout": 1, "ppo_fused_grads_T": PPO_MINIBATCHES}
    path = {name: 0 for name in _build.launch_counts}
    for hidden, shared in DEEP_FULL:
        tag = f"{'x'.join(map(str, hidden))} {'shared' if shared else 'towers'}"
        pcfg = PPOConfig(hidden=hidden, n_epochs=1, n_minibatches=PPO_MINIBATCHES, shuffle=False,
                         compute_dtype="bfloat16", shared_trunk=shared, fused_rollout=True, fused_update=True)
        ts0 = init_train_state(env5, pcfg, 281)
        _build.reset_launch_counts()
        eager, ts = [], ts0
        for i in range(DEEP_ITERATIONS):
            with warnings.catch_warnings():
                warnings.simplefilter("error", RuntimeWarning)  # no autograd fallback
                ts, m = train_iteration(env5, pcfg, ts, 282 + i)
            torch.cuda.synchronize()
            counts = {n: c for n, c in _build.launch_counts.items() if c}
            check(counts == per_iteration, f"phase 28b {tag} iteration {i + 1}: launches {counts}")
            for name, c in _build.launch_counts.items():
                path[name] += c
            _build.reset_launch_counts()
            assert_metric_bands(m, f"phase 28b {tag} iteration {i + 1}")
            eager.append((ts, m))
        captured, ts = [], ts0
        for i in range(DEEP_ITERATIONS):
            t_first = time.perf_counter()
            ts, m = jit_train_iteration(env5, pcfg, ts, 282 + i)
            torch.cuda.synchronize()
            if i == 0:
                first_s = time.perf_counter() - t_first
            else:  # a replay: its launches alone
                counts = {n: c for n, c in _build.launch_counts.items() if c}
                check(counts == per_iteration, f"phase 28b {tag}: a replay launches {counts}")
            for name, c in _build.launch_counts.items():
                path[name] += c
            _build.reset_launch_counts()
            captured.append((ts, m))
        for i, ((ets, em), (cts, cm)) in enumerate(zip(eager, captured)):
            check(same_bits(torch, cts.params, ets.params) and same_bits(torch, cts.opt_state, ets.opt_state)
                  and same_bits(torch, cm, em),
                  f"phase 28b {tag}: iteration {i + 1} captured is not eager bit for bit")
        eager_ms = statistics.median(wall_ms(torch, lambda: train_iteration(env5, pcfg, ts0, 290)))
        jit_ms = statistics.median(wall_ms(torch, lambda: jit_train_iteration(env5, pcfg, ts0, 290)))
        compiled.clear_cache()
        # the kernels at this trunk, timed apart from the main path's launches
        model = ts0.params
        tb = mr.collect_rollout_fused_T(env5, model, 291, device=dev)
        mb = [x[..., :nb5] for x in (tb.obs_t, tb.actions_t, tb.log_probs, tb.advantages, tb.returns)]
        mb[3] = normalise(mb[3])
        p = mr.rollout_params_from_config(env5)
        k3_ms, _ = kernel_ms(torch, lambda: mr.mlp_rollout(p, model, 9, PPO_N, device=dev), warmup=1, reps=3)
        k4_ms, k4_call = kernel_ms(torch, lambda: fused_ppo.ppo_fused_grads_T(model, *mb), warmup=1, reps=5,
                                   label=f"phase 28b K4 {tag} at {steps}x{nb5}")
        k4_plain = cuda_ms(torch, lambda: fused_ppo.ppo_fused_grads_T_plain(model, *mb), warmup=1, reps=2)
        # the kernels against the plain version on this minibatch, which the
        # deep instantiations run in chunks
        rows = [x.permute(0, 2, 1).reshape(m5, -1) if x.dim() == 3 else x.reshape(-1) for x in mb]
        scales = metric_scales(torch, model, rows)
        rel = {"K4": full_minibatch_close(torch, fused_ppo.ppo_fused_grads_T(model, *mb),
                                          fused_ppo.ppo_fused_grads_T_plain(model, *mb), hidden, scales,
                                          f"phase 28b K4 {tag} at {steps}x{nb5}")}
        towers = 1 if shared else 2
        per_sample = (4 + 2 + 3) * 4
        k4_bound = bound_ms(per_sample * m5, ppo_grad_flops_at(4, hidden, 2, towers) * m5, BF16_OPS_PER_S)
        k3_bound = bound_ms((4 + 2 + 3) * 4 * PPO_N * steps, mlp_flops_at(4, hidden, 2, towers) * PPO_N * steps,
                            BF16_OPS_PER_S)
        shape = fused_ppo.check_kernel_limits(model, nb5, 4, 2, "K4")
        scratch = fused_ppo.deep_layout(shape, m5 // 32, 4, 2, True)["stage_bytes"]
        key = "x".join(map(str, hidden)) + ("" if shared else "_towers")
        figures["K4"].update({f"deep_{key}_ms": k4_ms, f"deep_{key}_call_ms": k4_call,
                              f"deep_{key}_plain_ms": k4_plain, f"deep_{key}_bound_ms": k4_bound[0],
                              f"deep_{key}_scratch_bytes": scratch, f"deep_{key}_rel_err": rel["K4"]})
        print(f"phase 28b [{card}] fully fused train_iteration {tag} at config 5 ({PPO_N}x{steps}, 16 minibatches): "
              f"eager {eager_ms} ms, captured {jit_ms} ms = {PPO_N * steps / jit_ms * 1e3} env-steps/s; first "
              f"captured call {first_s:.2f} s; {DEEP_ITERATIONS} captured iterations bitwise the eager ones; "
              f"launches {per_iteration} an iteration; K3 {k3_ms} ms on the device; K4 {k4_ms} ms on the device "
              f"(call {k4_call} ms, plain {k4_plain} ms), bound {k4_bound[0]} ms ({k4_bound[1]}), "
              f"{k4_bound[0] / k4_ms:.1%} of bound; K3 bound {k3_bound[0]} ms ({k3_bound[1]}); deep scratch {scratch} bytes")
        if shared:  # K7 on the same samples, row-major
            k7_ms, k7_call = kernel_ms(torch, lambda: fused_ppo.ppo_fused_grads(model, *rows), warmup=1, reps=5,
                                       label=f"phase 28b K7 {tag} at {m5} samples")
            k7_plain = cuda_ms(torch, lambda: fused_ppo.ppo_fused_grads_plain(model, *rows), warmup=1, reps=2)
            rel["K7"] = full_minibatch_close(torch, fused_ppo.ppo_fused_grads(model, *rows),
                                             fused_ppo.ppo_fused_grads_plain(model, *rows), hidden, scales,
                                             f"phase 28b K7 {tag} at {m5} samples")
            figures["K7"].update({f"deep_{key}_ms": k7_ms, f"deep_{key}_call_ms": k7_call,
                                  f"deep_{key}_plain_ms": k7_plain, f"deep_{key}_bound_ms": k4_bound[0],
                                  f"deep_{key}_rel_err": rel["K7"]})
            print(f"phase 28b [{card}] K7 {tag} at {m5} samples: {k7_ms} ms on the device (call {k7_call} ms, "
                  f"plain {k7_plain} ms), bound {k4_bound[0]} ms, {k4_bound[0] / k7_ms:.1%} of bound")
        _build.reset_launch_counts()
        del tb, mb, rows, eager, captured
    print(f"phase 28b launches on the slice's main path: { {k: c for k, c in path.items() if c} }")
    check(path["ppo_fused_grads_T"] > 0 and path["mlp_rollout"] > 0, "phase 28b: K3 or K4 was not launched")
    print(f"phase 28b ok in {time.perf_counter() - t0:.1f} s")

    # ---- 28c: JAX's drift check, float32 fused update against autograd
    t0 = time.perf_counter()
    env_small = dataclasses.replace(as_env_config(num_trajectories=DRIFT_N, n_steps=DRIFT_T),
                                    normalise_observation_space=True, normalise_action_space=True)
    for hidden in ((32, 32), (64,)):
        for shared in (True, False):
            base = PPOConfig(hidden=hidden, n_epochs=2, n_minibatches=2, shuffle=False, shared_trunk=shared,
                             ent_coef=0.01)
            fused = dataclasses.replace(base, fused_update=True, fused_compute_dtype="float32")
            ts0 = init_train_state(env_small, base, 0)
            ts_ref, m_ref = train_iteration(env_small, base, ts0, 7)
            _build.reset_launch_counts()
            ts_fused, m_fused = train_iteration(env_small, fused, ts0, 7)
            torch.cuda.synchronize()
            kernel = "ppo_fused_grads" if shared else "ppo_fused_grads_T"
            check(_build.launch_counts[kernel] == 4, f"phase 28c: {dict(_build.launch_counts)}")
            path[kernel] += 4
            label = f"phase 28c {'x'.join(map(str, hidden))} {'shared (K7)' if shared else 'towers (K4)'}"
            drift = 0.0
            for (name, want), got in zip(ts_ref.params.named_parameters(), ts_fused.params.parameters()):
                torch.testing.assert_close(got, want, rtol=5e-4, atol=5e-6, msg=lambda m: f"{label} {name}: {m}")
                drift = max(drift, float((got - want).detach().abs().max()))
            for name in ("pg_loss", "vf_loss", "approx_kl", "entropy"):
                torch.testing.assert_close(m_fused[name], m_ref[name], rtol=1e-3, atol=1e-5,
                                           msg=lambda m: f"{label} {name}: {m}")
            print(f"{label}: one float32 fused iteration against autograd, params max abs drift {drift:.3g}, "
                  f"metrics {[round(float(m_fused[k]), 6) for k in ('pg_loss', 'vf_loss', 'approx_kl')]} vs "
                  f"{[round(float(m_ref[k]), 6) for k in ('pg_loss', 'vf_loss', 'approx_kl')]}")
    _build.reset_launch_counts()
    print(f"phase 28c ok in {time.perf_counter() - t0:.1f} s")

    print(f"phase 28 launches on the slice's main path (28b, 28c): { {k: c for k, c in path.items() if c} }")
    check(path["ppo_fused_grads"] > 0, "phase 28: K7 was not launched on the slice's main path")
    figures["K4"].update({"deep_max_rel_err": err["K4"], "deep_launches": path["ppo_fused_grads_T"]})
    figures["K7"].update({"deep_max_rel_err": err["K7"], "deep_launches": path["ppo_fused_grads"]})
    print(f"phase 28 ok in {time.perf_counter() - t_start:.1f} s")
    return figures


# ------------------------------------------------------------ all axes
AXES_ITERATIONS = 2  # phase 29b's eager iterations per layout, replayed captured
WIDE_DIMS = ((8, 4), (9, 4), (16, 4))  # 29d's observation widths: config 10's, the all-axes config's, K3's limit


def all_axes_phases(torch, np, card, dev):
    """Phase 29: the all-axes composite config (Heston midprice with config
    10's processes, S = 9, A = 4) at bench_suite config 10's shape
    (262,144 x 200, normalised observations, 256x256, 16 minibatches,
    bf16) trains fully fused.  (a) K4 on both layouts and K7 on the first
    minibatch of a K3 rollout against their plain versions, bf16 and
    float32 (:func:`compare_grads`), each launched twice bitwise, K7 in bf16
    also under a quarter of the distance between its plain version and the
    plain arithmetic at K4's rounding points on the same samples; (b)
    :data:`AXES_ITERATIONS` fully fused ``train_iteration``s per layout,
    K3 x1 + K4 x16 each, no RuntimeWarning, the metric bands on every
    iteration, then ``jit_train_iteration`` bit for bit the eager ones;
    the iteration's ms and idle share beside config 10's (S = 8) on the
    same trunk; (c) one shared-trunk ``fused_update`` iteration on the
    engine rollout, K7 x16; (d) K4 (both layouts) and K7 at S = 8, 9 and
    16, A = 4, on a 3,276,800-sample minibatch: device ms, call ms, the
    bound and the plain version's ms.  Returns the kernels-line figures of
    K3, K4 and K7."""
    import dataclasses

    from mbt_gym_torch import compiled, init_train_state, train_iteration
    from mbt_gym_torch import processes as pc
    from mbt_gym_torch.agents.networks import init_actor_critic
    from mbt_gym_torch.agents.ppo import PPOConfig, fused_update_refusal, jit_train_iteration, normalise
    from mbt_gym_torch.ops import _build
    from mbt_gym_torch.ops import fused_ppo
    from mbt_gym_torch.ops import mlp_rollout as mr
    from mbt_gym_torch.utils.config import composite_env_config

    t_start = time.perf_counter()
    figures = {"K3": {}, "K4": {}, "K7": {}}
    config10 = dataclasses.replace(composite_env_config(num_trajectories=COMPOSITE_N),
                                   normalise_observation_space=True)
    axes = dataclasses.replace(config10, dynamics=dataclasses.replace(config10.dynamics,
                                                                      midprice_model=pc.HestonMidprice()))
    p = mr.rollout_params_from_config(axes)
    check((axes.state_dim, axes.action_dim, p.n_channels) == (9, 4, 12), f"phase 29: all-axes params {p}")
    check(fused_update_refusal(axes) is None, f"phase 29: {fused_update_refusal(axes)}")
    steps = axes.n_steps
    nb = COMPOSITE_N // PPO_MINIBATCHES
    m = steps * nb
    layouts = ("shared trunk", "towers")
    path = {name: 0 for name in _build.launch_counts}

    def add_launches():
        for name, c in _build.launch_counts.items():
            path[name] += c
        _build.reset_launch_counts()

    # ---- 29a: the kernels on the first minibatch of a K3 rollout
    def first_minibatch(layout):
        """K4 (and K7 on the shared trunk) against their plain versions on
        the first minibatch; the worst bf16 leaf of each.  Its tensors die
        on return, so that none of them holds a part of a plain version's
        cached block into 29b's captures."""
        model = init_actor_critic(29, 9, 4, hidden=(256, 256), shared_trunk=layout == "shared trunk", device=dev)
        tb = mr.collect_rollout_fused_T(axes, model, 291, device=dev)
        mb = [x[..., :nb] for x in (tb.obs_t, tb.actions_t, tb.log_probs, tb.advantages, tb.returns)]
        mb[3] = normalise(mb[3])
        with torch.no_grad():
            model.log_std.add_(0.05)  # ratios away from 1, so both clip branches occur
        calls = [("K4", fused_ppo.ppo_fused_grads_T, fused_ppo.ppo_fused_grads_T_plain, mb)]
        if layout == "shared trunk":
            rows = [x.permute(0, 2, 1).reshape(m, -1) if x.dim() == 3 else x.reshape(-1) for x in mb]
            calls.append(("K7", fused_ppo.ppo_fused_grads, fused_ppo.ppo_fused_grads_plain, rows))
        worst = {}
        for kernel, fn, plain, args in calls:
            for dtype in ("bfloat16", "float32"):
                at = f"phase 29a {kernel} S=9 A=4 {layout} {dtype} at {m} samples"
                grads, metrics = fn(model, *args, compute_dtype=dtype)
                again = fn(model, *args, compute_dtype=dtype)
                want_g, want_m = plain(model, *args, compute_dtype=dtype)
                torch.cuda.synchronize()
                compare_grads(torch, grads, metrics, want_g, want_m, dtype, at)
                if dtype == "bfloat16":
                    worst[kernel] = max(leaf_errors(torch, grads, want_g).values())
                check_repeat(torch, (grads, metrics), again, at)
                del grads, metrics, again
                if kernel == "K7" and dtype == "bfloat16":
                    # how far K4's rounding points put the plain arithmetic from K7's on these samples
                    k4_points, _ = fused_ppo._plain_grads(model, args[0].T, args[1].T, *args[2:], 0.2, 0.5,
                                                          dtype, torch.float32)
                    worst["K4 points"] = max(leaf_errors(torch, k4_points, want_g).values())
                    del k4_points
                del want_g, want_m
        return worst

    t0 = time.perf_counter()
    err = {"K4": 0.0, "K7": 0.0, "K4 points": 0.0}
    for layout in layouts:
        for kernel, worst in first_minibatch(layout).items():
            err[kernel] = max(err[kernel], worst)
    _build.reset_launch_counts()  # 29a's launches compare; they are not the main path's
    # at this sample count K4's rounding points read below the 1e-3 leaf
    # bound from K7's (6.5e-4 on the H100), so K7 is also held to a quarter
    # of that distance: a K7 rounding at K4's points fails here too
    check(4 * err["K7"] < err["K4 points"],
          f"phase 29a: K7 reads {err['K7']:.3g} from its plain version, not under a quarter of the "
          f"{err['K4 points']:.3g} that K4's rounding points read")
    print(f"phase 29a ok in {time.perf_counter() - t0:.1f} s: worst bf16 leaf K4 {err['K4']:.3g}, K7 {err['K7']:.3g}; "
          f"K7's plain arithmetic at K4's rounding points reads {err['K4 points']:.3g} from K7's plain version "
          f"(the leaf bound 1e-3; K7 held under a quarter of that reading)")

    # ---- 29b: fully fused training, eager then captured, beside config 10
    t0 = time.perf_counter()
    per_iteration = {"mlp_rollout": 1, "ppo_fused_grads_T": PPO_MINIBATCHES}
    for layout in layouts:
        # the cached blocks of the plain versions above released first: the
        # long-lived states and K3 buffers allocated here would otherwise
        # take a part of each and keep it from the capture's pool
        print_memory(torch, dev, f"phase 29b {layout}, before the iterations")
        pcfg = PPOConfig(hidden=(256, 256), n_epochs=1, n_minibatches=PPO_MINIBATCHES, shuffle=False,
                         compute_dtype="bfloat16", shared_trunk=layout == "shared trunk", fused_rollout=True,
                         fused_update=True)
        ts0 = init_train_state(axes, pcfg, 292)
        eager, ts = [], ts0
        _build.reset_launch_counts()
        for i in range(AXES_ITERATIONS):
            with warnings.catch_warnings():
                warnings.simplefilter("error", RuntimeWarning)  # no autograd fallback
                ts, metrics = train_iteration(axes, pcfg, ts, 293 + i)
            torch.cuda.synchronize()
            counts = {n: c for n, c in _build.launch_counts.items() if c}
            check(counts == per_iteration, f"phase 29b {layout} iteration {i + 1}: launches {counts}")
            add_launches()
            bands = assert_metric_bands(metrics, f"phase 29b all axes {layout} iteration {i + 1}")
            eager.append((ts, metrics))
            print(f"phase 29b all axes {layout} iteration {i + 1}: {bands}")
        ts = ts0
        for i in range(AXES_ITERATIONS):
            ts, metrics = jit_train_iteration(axes, pcfg, ts, 293 + i)
            torch.cuda.synchronize()
            if i > 0:  # a replay: its launches alone
                counts = {n: c for n, c in _build.launch_counts.items() if c}
                check(counts == per_iteration, f"phase 29b {layout}: a replay launches {counts}")
            add_launches()
            ets, em = eager[i]
            check(same_bits(torch, ts.params, ets.params) and same_bits(torch, ts.opt_state, ets.opt_state)
                  and same_bits(torch, metrics, em),
                  f"phase 29b {layout}: captured iteration {i + 1} is not the eager one bit for bit")
        compiled.clear_cache()
        ms = {}
        for name, cfg in (("all axes", axes), ("config 10", config10)):
            its = init_train_state(cfg, pcfg, 294)
            ms[name] = statistics.median(wall_ms(torch, lambda: train_iteration(cfg, pcfg, its, 295), calls=2))
            prof = profile_iteration(torch, card, f"fused train_iteration, {name}, {layout}, at {COMPOSITE_N}x{steps}",
                                     lambda: train_iteration(cfg, pcfg, its, 296), phase=29)
            idle = 1.0 - prof["busy_ms"] / prof["wall_ms"] if prof else None
            key = ("axes" if name == "all axes" else "config10") + ("" if layout == "shared trunk" else "_towers")
            figures["K4"].update({f"{key}_iteration_ms": ms[name], f"{key}_idle_share": idle})
            _build.reset_launch_counts()
        print(f"phase 29b [{card}] fully fused train_iteration, {layout}, at {COMPOSITE_N}x{steps}: all axes (S = 9) "
              f"{ms['all axes']} ms = {COMPOSITE_N * steps / ms['all axes'] * 1e3} env-steps/s, config 10 (S = 8) "
              f"{ms['config 10']} ms; {AXES_ITERATIONS} captured iterations bitwise the eager ones")
        del eager, ts, ts0
    print(f"phase 29b ok in {time.perf_counter() - t0:.1f} s")

    # ---- 29c: fused_update on the engine rollout, K7 x16
    t0 = time.perf_counter()
    pcfg = PPOConfig(hidden=(256, 256), n_epochs=1, n_minibatches=PPO_MINIBATCHES, shuffle=False,
                     compute_dtype="bfloat16", shared_trunk=True, fused_update=True)
    ts = init_train_state(axes, pcfg, 297)
    _build.reset_launch_counts()
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        ts, metrics = train_iteration(axes, pcfg, ts, 298)
    torch.cuda.synchronize()
    counts = {n: c for n, c in _build.launch_counts.items() if c}
    check(counts == {"ppo_fused_grads": PPO_MINIBATCHES}, f"phase 29c: launches {counts}")
    add_launches()
    print(f"phase 29c all axes fused_update on the engine rollout: {assert_metric_bands(metrics, 'phase 29c')}; "
          f"ok in {time.perf_counter() - t0:.1f} s")
    del ts

    # ---- 29d: K4 and K7 at S = 8, 9 and 16 on a 3,276,800-sample minibatch
    t0 = time.perf_counter()
    for s_dim, a_dim in WIDE_DIMS:
        torch.cuda.empty_cache()  # as in 29b: the samples below must not split the plain versions' blocks
        rows = None
        for layout in layouts:
            shared = layout == "shared trunk"
            model = init_actor_critic(30, s_dim, a_dim, hidden=(256, 256), shared_trunk=shared, device=dev)
            if rows is None:  # the shared trunk's samples, for both layouts
                rows = update_samples(torch, np, model, steps, nb, 300 + s_dim, dev)
            calls = [("K4", fused_ppo.ppo_fused_grads_T, fused_ppo.ppo_fused_grads_T_plain,
                      feature_major(rows, steps, nb))]
            if shared:
                calls.append(("K7", fused_ppo.ppo_fused_grads, fused_ppo.ppo_fused_grads_plain, rows))
            towers = 1 if shared else 2
            b = bound_ms((s_dim + a_dim + 3) * 4 * m, ppo_grad_flops_at(s_dim, (256, 256), a_dim, towers) * m,
                         BF16_OPS_PER_S)
            for kernel, fn, plain, args in calls:
                name = f"{kernel} S={s_dim} A={a_dim} bf16 {layout}"
                dev_ms, call_ms = kernel_ms(torch, lambda: fn(model, *args), warmup=1, reps=5,
                                            label=f"phase 29d {name} at {m} samples")
                plain_ms = cuda_ms(torch, lambda: plain(model, *args), warmup=1, reps=1)
                print(kernel_row("29d", card, name, f"{m} samples", m, dev_ms, call_ms, *b, plain_ms))
                key = f"s{s_dim}" + ("" if shared else "_towers")
                figures[kernel].update({f"{key}_ms": dev_ms, f"{key}_call_ms": call_ms, f"{key}_plain_ms": plain_ms,
                                        f"{key}_bound_ms": b[0]})
            del calls, args
        del rows
    _build.reset_launch_counts()
    print(f"phase 29d ok in {time.perf_counter() - t0:.1f} s")

    print(f"phase 29 launches on the slice's main path: { {k: c for k, c in path.items() if c} }")
    for name in ("mlp_rollout", "ppo_fused_grads_T", "ppo_fused_grads"):
        check(path[name] > 0, f"phase 29: {name} was not launched on the slice's main path")
    figures["K3"]["axes_launches"] = path["mlp_rollout"]
    figures["K4"].update({"axes_launches": path["ppo_fused_grads_T"], "axes_max_rel_err": err["K4"]})
    figures["K7"].update({"axes_launches": path["ppo_fused_grads"], "axes_max_rel_err": err["K7"]})
    print(f"phase 29 ok in {time.perf_counter() - t_start:.1f} s")
    return figures


def as_phases(torch, np, card, dev):
    """Phases 2-6: K1 and K2 against their plain versions at the pipeline
    and the wide shape, the AS main path through the public entry points
    (auto, then engine), timings.  Returns the kernels-line entries of K1
    and K2 and their device ms by kernel name (phase 17's profiles add them
    where the profiler loses a kernel)."""
    import dataclasses

    from mbt_gym_torch import dispatch_report, episode_stats, mc_episode_stats, rollout
    from mbt_gym_torch.agents.baseline import AvellanedaStoikovAgent
    from mbt_gym_torch.env import make_generator
    from mbt_gym_torch.ops import _build
    from mbt_gym_torch.ops import episode as ep
    from mbt_gym_torch.utils.config import as_env_config

    # ---- phase 2/3: K1 and K2 against their plain versions, noise mode on
    # two configs and native mode, at the main path's 16,384 x 200 (the
    # step pipeline) and at 1,048,576 x 200 (the wide shape)
    default_cfg = as_env_config(num_trajectories=N_MAIN)
    late_cfg = dataclasses.replace(default_cfg, initial_cash=5.0, initial_inventory=3, start_time=0.2)
    err = {"K1": 0.0, "K2": 0.0}
    for label, cfg in (("late-start", late_cfg), ("default", default_cfg)):
        p = ep.params_from_config(cfg, 0.1)
        check(ep.kernel_geometry(p, N_MAIN).shape == ep.trajectory_geometry(p, N_MAIN).shape == "pipeline",
              "phase 2: K1 or K2 at the main shape is not a pipeline")
        rng = np.random.default_rng(11)
        channels = rng.uniform(size=(p.run_steps, 5, N_MAIN)).astype(np.float32)
        channels[:, 4] = rng.normal(size=(p.run_steps, N_MAIN)).astype(np.float32)
        noise = torch.from_numpy(channels).to(dev)
        for mode, kw in (("noise", {"noise": noise}), ("native", {"seed": 50, "device": dev})):
            k1 = ep.as_episode(p, num_trajectories=N_MAIN, **kw)
            k1_again = ep.as_episode(p, num_trajectories=N_MAIN, **kw)
            k1_plain = ep.as_episode_plain(p, num_trajectories=N_MAIN, **kw)
            torch.cuda.synchronize()
            err["K1"] = max(err["K1"], compare_terminal(torch, k1, k1_plain, N_MAIN, f"phase 2 K1 {label} {mode}"))
            check_repeat(torch, (dict(enumerate(k1)),), (dict(enumerate(k1_again)),), f"phase 2 K1 {label} {mode}")
            err["K2"] = max(err["K2"], check_k2(torch, ep, p, N_MAIN, kw, k1, f"{label} {mode} at {N_MAIN}"))
    # K1 and K2 at 1,048,576 envs take the wide shape: against their plain
    # versions (K2 on both configs, noise made on the card), repeated
    # launches bitwise
    gen = torch.Generator(dev).manual_seed(12)
    for label, cfg in (("late-start", late_cfg), ("default", default_cfg)):
        p_large = ep.params_from_config(dataclasses.replace(cfg, num_trajectories=N_LARGE), 0.1)
        check(ep.kernel_geometry(p_large, N_LARGE).shape == ep.trajectory_geometry(p_large, N_LARGE).shape == "wide",
              "phase 2: K1 or K2 at the wide shape is not wide")
        noise = torch.rand((p_large.run_steps, 5, N_LARGE), generator=gen, device=dev)
        noise[:, 4] = torch.randn((p_large.run_steps, N_LARGE), generator=gen, device=dev)
        for mode, kw in (("noise", {"noise": noise}), ("native", {"seed": 50, "device": dev})):
            at = f"{label} {mode} at {N_LARGE} (wide shape)"
            k1 = ep.as_episode(p_large, num_trajectories=N_LARGE, **kw)
            k1_again = ep.as_episode(p_large, num_trajectories=N_LARGE, **kw)
            k1_plain = ep.as_episode_plain(p_large, num_trajectories=N_LARGE, **kw)
            torch.cuda.synchronize()
            err["K1"] = max(err["K1"], compare_terminal(torch, k1, k1_plain, N_LARGE, f"phase 2 K1 {at}"))
            check_repeat(torch, (dict(enumerate(k1)),), (dict(enumerate(k1_again)),), f"phase 2 K1 {at}")
            del k1_again, k1_plain
            err["K2"] = max(err["K2"], check_k2(torch, ep, p_large, N_LARGE, kw, k1, at))
            del k1
        del noise
    torch.cuda.empty_cache()
    print("phase 2/3 ok: K1 and K2 agree with their plain versions at the pipeline and the wide shape; "
          "K2's last row is K1's terminal state; its trajectory layout is its full streams' layout bit for bit")

    # ---- phase 4: the main path through the public entry points (native)
    cfg = default_cfg
    policy = AvellanedaStoikovAgent.from_config(cfg, risk_aversion=0.1).policy()
    for mode in ("rollout", "stats"):
        decision = dispatch_report(cfg, policy, mode=mode)
        check((decision.backend, decision.family) == ("fused", "as_episode"), f"phase 4 dispatch ({mode}): {decision}")
    p = ep.params_from_config(cfg, 0.1)
    check(ep.trajectory_geometry(p, N_MAIN).shape == "pipeline", "phase 4: K2 on the main path is not a pipeline")
    _build.reset_launch_counts()
    res = rollout(cfg, policy, None, 50)
    torch.cuda.synchronize()
    rollout_launches = {k: c for k, c in _build.launch_counts.items() if c}
    mc = mc_episode_stats(cfg, policy, None, 51, episodes=EPISODES)
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
    print(f"phase 4 launches on the main path: {launches}; rollout alone {rollout_launches}")
    check(rollout_launches == {"as_episode_trajectories": 1}, f"phase 4: rollout launched {rollout_launches}, not K2 once")
    check(launches["as_episode"] == EPISODES, f"phase 4: mc_episode_stats launched K1 {launches['as_episode']} times")
    # the rollout's Trajectory is what the full streams' layout gives for
    # the same seed (the assembly the rollout ran before K2 wrote it)
    seed = ep.seed_from_key(make_generator(50, dev))
    want = ep.as_trajectory_from_full(p, ep.as_episode_trajectories(p, seed, N_MAIN, emit="full", device=dev))
    torch.cuda.synchronize()
    differ = [name for name, a, b in zip(res.trajectory._fields, res.trajectory, want) if not torch.equal(a, b)]
    check(not differ, f"phase 4: rollout's {differ} differ from the full streams' layout for the same seed")
    del want
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
    t_stats = cuda_ms(torch, lambda: mc_episode_stats(cfg, policy, None, 7, episodes=EPISODES))
    t_roll = cuda_ms(torch, lambda: rollout(cfg, policy, None, 7))
    t_eng = cuda_ms(torch, lambda: rollout(cfg, policy, None, 7, backend="engine"), warmup=1, reps=3)
    for name, ms, steps in (
        ("mc_episode_stats fused K1 (8 episodes)", t_stats, EPISODES * env_steps),
        ("rollout fused K2 trajectory layout", t_roll, env_steps),
        ("rollout engine", t_eng, env_steps),
    ):
        print(f"phase 6 [{card}] {name} at {N_MAIN}x{STEPS}: {ms} ms per call = {steps / ms * 1e3} env-steps/s")
    k1_ms, k1_call_ms = kernel_ms(torch, lambda: ep.as_episode(p, 9, N_MAIN, device=dev), warmup=3, reps=20)
    k2_ms, k2_call_ms = kernel_ms(torch, lambda: ep.as_episode_trajectory(p, 9, N_MAIN, device=dev), warmup=3, reps=20)
    k2_full_ms, k2_full_call_ms = kernel_ms(
        torch, lambda: ep.as_episode_trajectories(p, 9, N_MAIN, emit="full", device=dev), warmup=3, reps=20)
    k1_plain_ms = cuda_ms(torch, lambda: ep.as_episode_plain(p, 9, N_MAIN, device=dev), warmup=1, reps=3)
    k2_plain_ms = cuda_ms(torch, lambda: ep.as_episode_trajectory_plain(p, 9, N_MAIN, device=dev), warmup=1, reps=3)
    k2_full_plain_ms = cuda_ms(torch, lambda: ep.as_episode_trajectories_plain(p, 9, N_MAIN, emit="full", device=dev),
                               warmup=1, reps=3)
    large = ep.params_from_config(dataclasses.replace(cfg, num_trajectories=N_LARGE), 0.1)
    k1_large, k1_large_call = kernel_ms(torch, lambda: ep.as_episode(large, 9, N_LARGE, device=dev), warmup=2, reps=10)
    k2_large, k2_large_call = kernel_ms(
        torch, lambda: ep.as_episode_trajectories(large, 9, N_LARGE, emit="full", device=dev), warmup=2, reps=10)
    k2_large_traj, k2_large_traj_call = kernel_ms(
        torch, lambda: ep.as_episode_trajectory(large, 9, N_LARGE, device=dev), warmup=2, reps=10)

    wide = ep.trajectory_geometry(large, N_LARGE).shape
    for name, ms, call, plain_ms, n, (b_ms, b_by) in (
        ("K1 as_episode native", k1_ms, k1_call_ms, k1_plain_ms, N_MAIN, as_bound("terminal", N_MAIN)),
        ("K2 as_episode_trajectory (trajectory layout) native", k2_ms, k2_call_ms, k2_plain_ms, N_MAIN,
         as_bound("trajectory", N_MAIN)),
        ("K2 as_episode_trajectories full native", k2_full_ms, k2_full_call_ms, k2_full_plain_ms, N_MAIN,
         as_bound("full", N_MAIN)),
        (f"K1 as_episode native ({ep.kernel_geometry(large, N_LARGE).shape} shape)", k1_large, k1_large_call, None,
         N_LARGE, as_bound("terminal", N_LARGE)),
        (f"K2 as_episode_trajectories full native ({wide} shape)", k2_large, k2_large_call, None, N_LARGE,
         as_bound("full", N_LARGE)),
        (f"K2 as_episode_trajectory (trajectory layout) native ({wide} shape)", k2_large_traj, k2_large_traj_call,
         None, N_LARGE, as_bound("trajectory", N_LARGE)),
    ):
        print(kernel_row(6, card, name, f"{n}x{STEPS}", n * STEPS, ms, call, b_ms, b_by, plain_ms))

    k1_bound = as_bound("terminal", N_MAIN)
    k2_bound = as_bound("trajectory", N_MAIN)
    k2_full_bound = as_bound("full", N_MAIN)
    kernels = [
        {
            "name": "K1 as_episode", "route": "cuda", "source": "mbt_gym_torch/ops/csrc/as_episode.cu",
            "replaces": "mbt_gym_tpu/ops/pallas_episode.py:233", "launches": launches["as_episode"],
            "max_abs_err": err["K1"], "ms": k1_ms, "call_ms": k1_call_ms, "plain_ms": k1_plain_ms,
            "bound_ms": k1_bound[0], "bound_by": k1_bound[1], "library_ms": None,
            "table_path": "none", "pipeline": pipeline_entry(ep.kernel_geometry(p, N_MAIN)),
        },
        {
            # ms: the trajectory layout, which the main path (rollout)
            # launches; the full streams' figures beside it
            "name": "K2 as_episode_trajectories", "route": "cuda", "source": "mbt_gym_torch/ops/csrc/as_episode.cu",
            "replaces": "mbt_gym_tpu/ops/pallas_episode.py:1074", "launches": launches["as_episode_trajectories"],
            "max_abs_err": err["K2"], "ms": k2_ms, "call_ms": k2_call_ms, "plain_ms": k2_plain_ms,
            "bound_ms": k2_bound[0], "bound_by": k2_bound[1], "library_ms": None,
            "full_ms": k2_full_ms, "full_call_ms": k2_full_call_ms, "full_plain_ms": k2_full_plain_ms,
            "full_bound_ms": k2_full_bound[0], "wide_full_ms": k2_large, "wide_ms": k2_large_traj,
            "table_path": "none", "pipeline": pipeline_entry(ep.trajectory_geometry(p, N_MAIN)),
        },
    ]
    return kernels, {"as_traj_kernel": k2_ms, "as_episode_kernel": k1_ms}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    import numpy as np

    from mbt_gym_torch.ops import _build
    from mbt_gym_torch.ops import episode as ep

    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch {torch.__version__} CUDA {torch.version.cuda} | {kind}")

    # ---- phases 1 (K1/K2), 7 (K3/K4), 13 (K5/K6/K8) and 18 (K7, the
    # towers modes): build every kernel source, one nvcc each, all started
    # together, with -Xptxas -v.  Phases 2-6 start once K1/K2's source is
    # built and phases 8-12 once K3's and K4's are, beside the longer builds.
    t0 = time.perf_counter()
    sources = _build.SOURCES
    seconds = {}

    def build(src):
        _build.build(src, ptxas_verbose=True)
        seconds[src] = round(time.perf_counter() - t0, 1)

    pool = ThreadPoolExecutor(len(sources))
    builds = {src: pool.submit(build, src) for src in sources}

    def built(*names):
        for src in names or sources:
            builds[src].result()

    built("as_episode.cu")
    ep._kernels()
    kernels, as_kernel_ms = as_phases(torch, np, card, dev)
    built("mlp_rollout.cu", "fused_ppo.cu")
    kernels += ppo_phases(torch, np, card, dev)
    built()
    pool.shutdown()
    print(f"phase 1/7/13/18 build: {', '.join(sources)}, each done after {seconds} s")
    kernels += cj_phases(torch, np, card, dev, as_kernel_ms=as_kernel_ms)
    k7, towers_figures = update_phases(torch, np, card, dev)
    k3_pnl_ms = next(entry["ms"] for entry in kernels if entry["name"].startswith("K3"))
    cj_figures = cj_learning_phases(torch, np, card, dev, k3_pnl_ms)
    lam_figures = lam_touch_phases(torch, np, card, dev, k3_pnl_ms)
    proc_figures = proc_phases(torch, np, card, dev, k3_pnl_ms)
    surface_figures = surface_phases(torch, np, card, dev)
    speed_figures_ = speed_phases(torch, np, card, dev, k3_pnl_ms)
    print_memory(torch, dev, "before phase 27")
    compiled_figures = compiled_phases(torch, np, card, dev)
    print_memory(torch, dev, "before phase 28")
    deep_figures = deep_trunk_phases(torch, np, card, dev)
    print_memory(torch, dev, "before phase 29")
    axes_figures = all_axes_phases(torch, np, card, dev)
    for entry in kernels:
        entry.update(towers_figures.get(entry["name"][:2], {}))
        entry.update(cj_figures.get(entry["name"][:2], {}))
        entry.update(lam_figures.get(entry["name"][:2], {}))
        entry.update(proc_figures.get(entry["name"][:2], {}))
        entry.update(surface_figures.get(entry["name"][:2], {}))
        entry.update(speed_figures_.get(entry["name"][:2], {}))
        entry.update(compiled_figures.get(entry["name"][:2], {}))
        entry.update(deep_figures.get(entry["name"][:2], {}))
        entry.update(axes_figures.get(entry["name"][:2], {}))
    k7.update(compiled_figures["K7"])
    k7.update(deep_figures["K7"])
    k7.update(axes_figures["K7"])
    kernels = sorted(kernels + [k7], key=lambda entry: entry["name"])
    for entry in rank_by_gap(kernels):
        print(f"rank [{card}] {entry['name']}: {entry['launches']} launches x ({entry['ms']} - {entry['bound_ms']}) ms "
              f"= {entry['launches'] * (entry['ms'] - entry['bound_ms'])} ms above the bound")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
