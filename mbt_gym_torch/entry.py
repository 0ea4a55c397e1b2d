"""Entry points of the port (counterpart of the repository's
``__graft_entry__.py``).

- :func:`entry`: the forward step of the flagship model — the AS
  market-making env step with the closed-form policy, 1,024 envs — with
  its example arguments.
- :func:`assert_metric_bands`: the PPO sanity bands of
  ``__graft_entry__._assert_metric_bands`` (lines 42-54), verbatim.
- :func:`dryrun_multichip`: one data-parallel PPO iteration at
  production-like ratios (>= 2,048 envs, T = 64, a 256x256 trunk) over the
  process group, on the engine path and on the fully fused path (K3 + K4)
  with injected noise, each inside the bands, with per-phase times, and at
  the default shape the weak-scaling tables over the widths the group has.
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch


def entry(device=None):
    """``(forward_step, (state0, obs0))``: ``forward_step(state, obs,
    noise=None) -> (obs, reward, done)`` on ``as_env_config(1024)`` with
    the AS agent (risk aversion 0.1), the state reset from seed 0 on
    ``device`` (``None`` means ``"cuda"``).  ``noise`` injects one step's
    draws (:class:`~mbt_gym_torch.types.StepNoise`), as ``env.step`` takes
    them."""
    from mbt_gym_torch import env as env_lib
    from mbt_gym_torch.agents.baseline import AvellanedaStoikovAgent
    from mbt_gym_torch.utils.config import as_env_config

    cfg = as_env_config(num_trajectories=1024)
    policy = AvellanedaStoikovAgent.from_config(cfg, risk_aversion=0.1).policy()

    def forward_step(state, obs, noise=None):
        action = policy(None, obs, state)
        res = env_lib.step(cfg, state, action, noise=noise)
        return res.obs, res.reward, res.done

    state0, obs0 = env_lib.reset(cfg, 0, device=device)
    return forward_step, (state0, obs0)


def assert_metric_bands(metrics, label):
    """PPO iteration sanity bands on the normalised AS env
    (``__graft_entry__.py:42-54``): tight enough to catch NaN, zero-
    degenerate or exploding runs, loose enough for any backend.  Raises
    ``AssertionError`` naming ``label``; returns the metrics as floats."""
    m = {k: float(v) for k, v in metrics.items()}

    def band(ok):
        if not ok:
            raise AssertionError((label, m))

    band(all(math.isfinite(v) for v in m.values()))
    band(abs(m["pg_loss"]) < 0.5)
    band(0.0 < m["vf_loss"] < 1e4)
    band(abs(m["approx_kl"]) < 0.5)
    band(-200.0 < m["mean_episode_reward"] < 200.0)
    if "entropy" in m:
        band(0.0 < m["entropy"] < 20.0)
    return m


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _weak_scaling(label, widths, rank, run):
    """One row per width d: ``run(mesh_d, d)`` on the first d ranks (a
    sub-group; every rank takes part in making it), timed twice on the
    host clock after a synchronise; returns the rows ``(d, envs, first_s,
    iter_ms, reward)`` of the ranks inside."""
    import torch.distributed as dist

    from mbt_gym_torch.parallel.mesh import make_mesh

    rows = []
    for d in widths:
        group = dist.new_group(list(range(d)))
        if rank < d:
            mesh_d = make_mesh(group=group)
            t0 = time.perf_counter()
            run(mesh_d, d)
            first_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            envs, metrics = run(mesh_d, d)
            it_ms = (time.perf_counter() - t0) * 1e3
            assert_metric_bands(metrics, f"{label}-weak-{d}")
            rows.append((d, envs, first_s, it_ms, float(metrics["mean_episode_reward"])))
        dist.destroy_process_group(group)
    return rows


def dryrun_multichip(n_devices: int, n_envs: int = None, t_horizon: int = 64, device=None) -> None:
    """One data-parallel PPO iteration over ``n_devices`` ranks, one per
    device, at production-like ratios, inside the metric bands.

    The process group must hold ``n_devices`` ranks; with none up and
    ``n_devices == 1``, :func:`mbt_gym_torch.parallel.mesh.init_distributed`
    starts one on ``device`` (``None`` means ``"cuda"``: NCCL).  Every rank
    calls this.  ``n_envs`` defaults to 2,048 rounded up to a multiple of
    128 x ``n_devices``; at the defaults the weak-scaling tables (256 envs
    per rank, widths 1, 2, 4, ... up to the group's size) are printed too.

    Legs (``__graft_entry__.py:57-238``): (1) the engine path —
    ``collect_rollout(mesh=)`` alone, then ``train_iteration(mesh=)``
    twice — the counterpart of the JAX GSPMD leg, whose tensor-parallel
    ``model`` axis is not ported; (2) the fully fused path (K3 + K4, float32
    products) through ``train_iteration(mesh=, noise=)`` with injected
    noise (numpy seed 11), as JAX's fused-DP leg runs it."""
    import torch.distributed as dist

    from mbt_gym_torch.agents import ppo
    from mbt_gym_torch.ops import mlp_rollout
    from mbt_gym_torch.parallel import mesh as mesh_lib
    from mbt_gym_torch.utils.config import as_env_config

    run_scaling_table = n_envs is None
    if not dist.is_initialized() and n_devices == 1:
        mesh_lib.init_distributed(world_size=1, rank=0, device=device)
    mesh = mesh_lib.make_mesh()
    if mesh.world != n_devices:
        raise ValueError(f"the process group holds {mesh.world} ranks, not {n_devices}")
    dev = mesh.device
    per_dev = 128
    if n_envs is None:
        n_envs = -(-2048 // (n_devices * per_dev)) * n_devices * per_dev
    if n_envs % (n_devices * per_dev):
        raise ValueError(f"{n_envs} envs are not a multiple of {n_devices} x {per_dev}")
    env_cfg = dataclasses.replace(
        as_env_config(num_trajectories=n_envs, n_steps=t_horizon),
        normalise_observation_space=True, normalise_action_space=True,
    )
    widths = [d for d in (1, 2, 4, 8, 16) if d <= n_devices]

    # --- (1) the engine data-parallel leg --------------------------------
    ppo_cfg = ppo.PPOConfig(hidden=(256, 256), n_epochs=1, n_minibatches=4)
    ts = ppo.init_train_state(env_cfg, ppo_cfg, 0, device=dev)
    mesh_lib.shard_params(mesh, ts.params)
    rollout_s = []
    for _ in range(2):  # the first call warms the libraries up, as JAX's compiles
        t0 = time.perf_counter()
        batch = ppo.collect_rollout(env_cfg, ts.params, 1, gamma=ppo_cfg.gamma, lam=ppo_cfg.gae_lambda,
                                    mesh=mesh)
        _sync(dev)
        rollout_s.append(time.perf_counter() - t0)
        del batch
    t_rollout = rollout_s[1]
    t0 = time.perf_counter()
    new_ts, metrics = ppo.train_iteration(env_cfg, ppo_cfg, ts, 1, mesh=mesh)
    _sync(dev)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    new_ts, metrics = ppo.train_iteration(env_cfg, ppo_cfg, new_ts, 1, mesh=mesh)
    _sync(dev)
    t_iter = time.perf_counter() - t0
    m = assert_metric_bands(metrics, "engine-dp")
    print(f"dryrun_multichip OK: mesh=({n_devices}x1), envs={n_envs}, T={t_horizon}, trunk=256x256, "
          f"device={dev}, metrics={m}")
    print(f"dryrun phases (engine DP): rollout {t_rollout * 1e3:.1f} ms (first call {rollout_s[0] * 1e3:.1f} ms), "
          f"first iteration {t_first * 1e3:.1f} ms, full iteration {t_iter * 1e3:.1f} ms, "
          f"update ~{(t_iter - t_rollout) * 1e3:.1f} ms")

    if run_scaling_table:
        def engine_run(mesh_d, d):
            cfg_d = dataclasses.replace(env_cfg, num_trajectories=256 * d)
            ts_d = ppo.init_train_state(cfg_d, ppo_cfg, 4, device=dev)
            out = ppo.train_iteration(cfg_d, ppo_cfg, ts_d, 1, mesh=mesh_d)[1]
            _sync(dev)
            return 256 * d, out

        rows = _weak_scaling("engine-dp", widths, mesh.rank, engine_run)
        if rows:
            print("dryrun engine DP weak scaling (fixed 256 envs/rank):")
            print("  devices |   envs | first_s | iter_ms | reward")
            for d, envs_d, first_s, it_ms, reward in rows:
                print(f"  {d:7d} | {envs_d:6d} | {first_s:7.2f} | {it_ms:7.1f} | {reward:.3f}")

    # --- (2) the fused data-parallel leg: K3 + K4 with injected noise ------
    fused_cfg = ppo.PPOConfig(
        hidden=(256, 256), n_epochs=1, n_minibatches=2, shuffle=False, shared_trunk=True,
        fused_rollout=True, fused_update=True, fused_compute_dtype="float32",
    )
    fts = ppo.init_train_state(env_cfg, fused_cfg, 2, device=dev)
    mesh_lib.shard_params(mesh, fts.params)
    n_ch = mlp_rollout.n_noise_channels(env_cfg.action_dim)
    rng = np.random.default_rng(11)
    channels = rng.uniform(size=(t_horizon, n_ch, n_envs)).astype(np.float32)
    channels[:, 4:] = rng.normal(size=(t_horizon, n_ch - 4, n_envs)).astype(np.float32)
    noise = torch.from_numpy(channels).to(dev)
    t0 = time.perf_counter()
    new_fts, fmetrics = ppo.train_iteration(env_cfg, fused_cfg, fts, 1, noise=noise, mesh=mesh)
    _sync(dev)
    t_fused = time.perf_counter() - t0
    fm = assert_metric_bands(fmetrics, "fused-dp")
    print(f"dryrun fused-DP OK: mesh=({n_devices}x1), envs={n_envs}, T={t_horizon}, trunk=256x256, "
          f"injected-noise metrics={fm}")
    print(f"dryrun phases (fused-DP): first iteration {t_fused * 1e3:.1f} ms")

    if run_scaling_table:
        def fused_run(mesh_d, d):
            envs_d = 256 * d
            cfg_d = dataclasses.replace(env_cfg, num_trajectories=envs_d)
            ts_d = ppo.init_train_state(cfg_d, fused_cfg, 3, device=dev)
            out = ppo.train_iteration(cfg_d, fused_cfg, ts_d, 1, noise=noise[..., :envs_d], mesh=mesh_d)[1]
            _sync(dev)
            return envs_d, out

        rows = _weak_scaling("fused-dp", widths, mesh.rank, fused_run)
        if rows:
            print("dryrun fused-DP weak scaling (fixed 256 envs/rank):")
            print("  devices |   envs | first_s | iter_ms | reward")
            for d, envs_d, first_s, it_ms, reward in rows:
                print(f"  {d:7d} | {envs_d:6d} | {first_s:7.2f} | {it_ms:7.1f} | {reward:.3f}")
