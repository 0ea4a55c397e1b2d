"""Profiling and throughput harness (counterpart of
``mbt_gym_tpu/utils/profiling.py``; the reference has no tracing of its
own).

- :func:`trace` — a context manager around ``torch.profiler.profile`` (CPU
  and, where a GPU is visible, CUDA activity) that writes a Chrome trace
  into ``log_dir`` (``trace_<ms since epoch>.pt.trace.json``).
- :func:`throughput` — env-steps/s of whole engine episodes,
  ``episodes_per_call`` per timed call, timed with CUDA events on a card
  and the host clock on the CPU.
- :func:`scaling_report` — env-steps/s across data-parallel widths of a
  process group, envs per rank held fixed, with the efficiency against the
  first width.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, List, Optional

import torch

from mbt_gym_torch import env as env_lib
from mbt_gym_torch.env import EnvConfig


@contextlib.contextmanager
def trace(log_dir: str = "profiler-trace"):
    """Profile the block and write its Chrome trace into ``log_dir``
    (created if missing); yields ``log_dir``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield log_dir
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, f"trace_{int(time.time() * 1e3)}.pt.trace.json"))


def _episode_thunk(cfg: EnvConfig, policy, episodes_per_call: int, device) -> Callable[..., torch.Tensor]:
    """``many(key)`` (an int seed or a ``torch.Generator``) runs ``episodes_per_call`` engine episodes of ``cfg``
    (profiling.py:34-80): reset, the episode's noise drawn up front where
    :func:`mbt_gym_torch.rollout._should_predraw` says so, the steps, and
    the rewards summed so that their computation is part of the work; it
    returns the sum of the final cash and the rewards (a checksum)."""
    from mbt_gym_torch.rollout import _episode_steps, _noise_at, _should_predraw, native_noise_cube

    n_scan = _episode_steps(cfg)
    predraw = _should_predraw(cfg, n_scan)

    @torch.no_grad()
    def many(key) -> torch.Tensor:
        gen = env_lib.make_generator(key, device)
        acc = torch.zeros((), dtype=cfg.torch_dtype, device=device)
        for _ in range(episodes_per_call):
            state, obs = env_lib.reset(cfg, gen, device=device)
            cube = native_noise_cube(cfg, state.key, n_scan) if predraw else None
            reward_acc = torch.zeros((), dtype=cfg.torch_dtype, device=device)
            for t in range(n_scan):
                action = policy(None, obs, state)
                res = env_lib.step(cfg, state, action, noise=None if cube is None else _noise_at(cube, t))
                state, obs = res.state, res.obs
                reward_acc = reward_acc + res.reward.sum()
            acc = acc + state.cash.sum() + reward_acc
        return acc

    return many


def _timed(device: torch.device, fn: Callable[[], torch.Tensor]):
    """(seconds, result) of one call: CUDA events on a card, the host clock
    on the CPU."""
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3, out
    t0 = time.perf_counter()
    out = fn()
    return time.perf_counter() - t0, out


def throughput(cfg: EnvConfig, policy, episodes_per_call: int = 16, iters: int = 3, key: Optional[int] = None,
               device=None) -> Dict[str, float]:
    """Env-steps/s of whole engine episodes of ``cfg`` under ``policy`` on
    ``device`` (``None`` means ``"cuda"``): the first call is a warm-up
    (``compile_seconds``: the port compiles nothing, it is the first call's
    time), then the mean of ``iters`` calls, seeds ``key + i``."""
    from mbt_gym_torch.rollout import _episode_steps

    device = env_lib.resolve_device(device)
    key = 0 if key is None else int(key)
    thunk = _episode_thunk(cfg, policy, episodes_per_call, device)
    first_s, _ = _timed(device, lambda: thunk(key))
    total = 0.0
    for i in range(iters):
        seconds, checksum = _timed(device, lambda: thunk(key + i))
        total += seconds
    elapsed = total / iters
    steps = cfg.num_trajectories * _episode_steps(cfg) * episodes_per_call
    return {
        "env_steps_per_s": steps / elapsed,
        "seconds_per_call": elapsed,
        "compile_seconds": first_s,
        "checksum": float(checksum),
    }


def scaling_report(cfg: EnvConfig, policy, widths: Optional[List[int]] = None, episodes_per_call: int = 8,
                   iters: int = 3) -> List[Dict[str, float]]:
    """Env-steps/s and efficiency by data-parallel width, over the process
    group of :func:`mbt_gym_torch.parallel.mesh.init_distributed`, one
    rank per device.  Envs per rank are held at ``cfg.num_trajectories``
    (weak scaling).  At width d the first d ranks each run
    ``episodes_per_call`` engine episodes per call, each from its own
    generator (:func:`~mbt_gym_torch.parallel.mesh.fold_in`), and all-reduce their
    checksums; a call's time is the slowest rank's.  ``widths`` default to
    the powers of two up to the group's size; every rank must call this,
    and every rank gets the rows.  ``efficiency`` is the rate over (the
    first width's rate x d / that width)."""
    import torch.distributed as dist

    from mbt_gym_torch.parallel.mesh import fold_in, make_mesh
    from mbt_gym_torch.rollout import _episode_steps

    mesh = make_mesh()
    widths = widths or [d for d in (1, 2, 4, 8, 16, 32) if d <= mesh.world]
    rows = []
    base = None
    for d in widths:
        group = dist.new_group(list(range(d)))
        member = mesh.rank < d
        thunk = _episode_thunk(cfg, policy, episodes_per_call, mesh.device) if member else None

        def call(seed):
            out = thunk(fold_in(seed, mesh.rank)).reshape(1).to(torch.float64)
            dist.all_reduce(out, group=group)
            return out

        elapsed = torch.zeros(1, dtype=torch.float64, device=mesh.device)
        if member:
            call(0)  # warm-up
            for i in range(iters):
                seconds, _ = _timed(mesh.device, lambda: call(1 + i))
                elapsed += seconds / iters
        dist.all_reduce(elapsed, op=dist.ReduceOp.MAX)
        rate = d * cfg.num_trajectories * _episode_steps(cfg) * episodes_per_call / float(elapsed)
        if base is None:
            base = (rate, d)
        rows.append({"devices": d, "env_steps_per_s": rate, "efficiency": rate / (base[0] * d / base[1])})
        dist.destroy_process_group(group)
    return rows
