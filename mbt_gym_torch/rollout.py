"""Rollout over the env step (counterpart of ``mbt_gym_tpu/rollout.py``;
reference ``mbt_gym/gym/helpers/generate_trajectory.py``).

The engine is an eager PyTorch loop over :func:`mbt_gym_torch.env.step`
on the target device.  Eligible (config, policy) pairs go to the CUDA
episode kernels instead, through :mod:`mbt_gym_torch.dispatch`.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from mbt_gym_torch import dispatch as _dispatch
from mbt_gym_torch import env as env_lib
from mbt_gym_torch.env import EnvConfig
from mbt_gym_torch.types import EnvState, SlotNoise, StepNoise, Trajectory, TrajectoryT, as_values, device_constant

# policy(params, obs (N,S), state: EnvState) -> action (N, A)
PolicyFn = Callable[..., torch.Tensor]

_BACKENDS = ("auto", "engine", "fused")


class RolloutResult(NamedTuple):
    trajectory: Trajectory
    final_state: EnvState


def _is_touch(cfg: EnvConfig) -> bool:
    """At-the-touch dynamics: action columns are binary post/no-post flags,
    so spread-style action stats are meaningless; the stats report the
    posting rate instead."""
    from mbt_gym_torch.dynamics import AtTheTouchDynamics

    return isinstance(cfg.dynamics, AtTheTouchDynamics)


def native_noise_cube(cfg: EnvConfig, key: torch.Generator, n_steps: int) -> StepNoise:
    """Whole-episode native noise in two draws (one normal, one uniform)
    instead of two per step; leaves are ``(n_steps, N, k)``.  The stream
    differs from per-step :func:`~mbt_gym_torch.env.draw_step_noise` draws
    (both are deterministic in (key, config))."""
    return env_lib._draw_noise(cfg, key, (n_steps, cfg.num_trajectories))


# Below this cube size the episode's noise is drawn in two calls up front;
# above it, per step, so memory stays O(N).
_PREDRAW_BYTES_LIMIT = 512 * 1024 * 1024


def _should_predraw(cfg: EnvConfig, n_steps: int) -> bool:
    per_step = sum(a + b for _, (a, b) in env_lib.noise_specs(cfg))
    itemsize = torch.empty((), dtype=cfg.torch_dtype).element_size()
    return n_steps * cfg.num_trajectories * per_step * itemsize <= _PREDRAW_BYTES_LIMIT


def _episode_steps(cfg: EnvConfig) -> int:
    if callable(cfg.start_time):
        raise TypeError(
            "Callable start_time is a host-per-reset feature; evaluate it and "
            "pass rollout(..., start_time=...)."
        )
    if isinstance(cfg.start_time, tuple):
        return cfg.n_steps  # random start: run the full horizon, freeze post-done
    start_steps = round(float(cfg.start_time) / cfg.step_size)
    return cfg.n_steps - start_steps


def _noise_at(noise: StepNoise, t: int) -> StepNoise:
    return tuple(
        SlotNoise(
            normal=None if s.normal is None else s.normal[t],
            uniform=None if s.uniform is None else s.uniform[t],
        )
        for s in noise
    )


def _noise_length(noise: StepNoise) -> int:
    return next(x.shape[0] for s in noise for x in s if x is not None)


def _freeze(was_done: torch.Tensor, old: EnvState, new: EnvState) -> EnvState:
    """``old`` where ``was_done`` (a 0-d bool tensor), else ``new``, field by
    field; the generator is shared."""

    def pick(o, n):
        if isinstance(o, torch.Tensor):
            return torch.where(was_done, o, n)
        if isinstance(o, tuple):
            return tuple(pick(a, b) for a, b in zip(o, n))
        return n

    return EnvState(*(pick(o, n) for o, n in zip(old, new)))


def _check_backend(backend: str) -> None:
    assert backend in _BACKENDS, f"backend must be one of {_BACKENDS}; got {backend!r}"


def rollout(
    cfg: EnvConfig,
    policy: PolicyFn,
    policy_params,
    key,
    noise: Optional[StepNoise] = None,
    start_time: Optional[float] = None,
    initial_inventory=None,
    backend: str = "auto",
    device=None,
) -> RolloutResult:
    """Roll one full episode for all N trajectories on ``device``
    (``None`` means ``"cuda"``).

    ``backend``: "auto" (default) routes eligible (config, policy) pairs to
    the CUDA episode kernels (the AS family to K2; the CJ, fixed-action and
    CJ-OE policies to K5); "engine" forces the
    general eager engine; "fused" asserts eligibility (raises with the
    disqualifying feature otherwise).  Inspect decisions with
    :func:`mbt_gym_torch.dispatch.dispatch_report`.  Fused results are
    statistically — not bitwise — equal to engine results (different RNG
    streams); replay features (``noise``, reset overrides) always run the
    engine, and ``final_state.clip_events`` reads 0 on the fused path.

    ``key`` is an int seed or a ``torch.Generator`` on ``device``.
    ``noise``, if given, is a :class:`StepNoise` with a leading time axis on
    every leaf (``(T, N, k)``; tensors or numpy arrays) — e.g. from
    :func:`mbt_gym_torch.ops.compat.reference_noise_cube` for
    reference-exact replay.  ``start_time`` / ``initial_inventory``
    override the config's reset specs with concrete values.
    """
    _check_backend(backend)
    device = env_lib.resolve_device(device)
    if backend != "engine":
        if noise is not None or start_time is not None or initial_inventory is not None:
            decision = _dispatch.DispatchDecision(
                "engine", None,
                "injected noise / reset overrides are engine-path replay features",
            )
        else:
            decision = _dispatch.dispatch_report(
                cfg, policy, mode="rollout", platform=device, policy_params=policy_params
            )
        if decision.backend == "fused":
            return _dispatch.fused_rollout(cfg, policy, policy_params, key, decision, device=device)
        if backend == "fused":
            raise ValueError(f"backend='fused' unavailable: {decision.reason}")
    state, obs = env_lib.reset(
        cfg, key, start_time=start_time, initial_inventory=initial_inventory, device=device
    )
    if start_time is not None:
        n_scan = cfg.n_steps - round(float(start_time) / cfg.step_size)
        random_start = False
    else:
        n_scan = _episode_steps(cfg)
        random_start = isinstance(cfg.start_time, tuple)
    if noise is not None:
        noise = env_lib._noise_as_tensors(noise, cfg.torch_dtype, device)
        if not random_start:
            # A fixed late start shortens the episode; consume only the
            # first n_scan steps of the injected noise.
            noise = tuple(
                SlotNoise(*(None if x is None else x[:n_scan] for x in s)) for s in noise
            )
        n_scan = _noise_length(noise)
    elif _should_predraw(cfg, n_scan):
        noise = native_noise_cube(cfg, state.key, n_scan)

    n = cfg.num_trajectories
    dtype = cfg.torch_dtype
    observations = torch.empty((n_scan + 1,) + tuple(obs.shape), dtype=dtype, device=device)
    actions = torch.empty((n_scan, n, cfg.action_dim), dtype=dtype, device=device)
    rewards = torch.empty((n_scan, n), dtype=dtype, device=device)
    observations[0] = obs
    for t in range(n_scan):
        action = policy(policy_params, obs, state)
        res = env_lib.step(cfg, state, action, noise=None if noise is None else _noise_at(noise, t))
        new_state, new_obs, reward = res.state, res.obs, res.reward
        if random_start:
            # Freeze post-done steps so a random (late) start behaves like the
            # reference's shorter episode; rewards after done are zeroed.
            was_done = state.time[0] >= cfg.terminal_time - cfg.step_size / 2
            new_state = _freeze(was_done, state, new_state)
            reward = torch.where(was_done, torch.zeros_like(reward), reward)
            new_obs = torch.where(was_done, obs, new_obs)
        observations[t + 1] = new_obs
        actions[t] = action
        rewards[t] = reward
        state, obs = new_state, new_obs
    return RolloutResult(
        trajectory=Trajectory(observations=observations, actions=actions, rewards=rewards),
        final_state=state,
    )


def jit_rollout(cfg: EnvConfig, policy: PolicyFn, policy_params, key, *, backend: str = "auto",
                device=None) -> RolloutResult:
    """:func:`rollout` compiled (rollout.py:214-216), dispatched as
    :func:`rollout` dispatches: a kernel family runs its kernel path as it
    is (one launch and its set-up); the engine runs on the card as one
    replay of a CUDA graph of the whole episode, captured at the first call
    for this config, policy and parameter layout
    (:mod:`mbt_gym_torch.compiled`), bit for bit :func:`rollout` for the
    same int ``key``.  On the CPU it is :func:`rollout`."""
    from mbt_gym_torch import compiled

    return compiled.rollout(cfg, policy, policy_params, key, backend=backend, device=device)


def to_reference_layout(traj: Trajectory) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Transpose to the reference's trajectory-major buffers
    (observations (N, S, T+1), actions (N, A, T), rewards (N, 1, T) —
    generate_trajectory.py:11-15)."""
    return (
        traj.observations.permute(1, 2, 0),
        traj.actions.permute(1, 2, 0),
        traj.rewards.permute(1, 0)[:, None, :],
    )


def _quote_mean(cfg: EnvConfig, action: torch.Tensor) -> torch.Tensor:
    """Mean of the bid/ask quote columns in raw units (NaN without them);
    at the touch, the mean of the two post flags."""
    if _is_touch(cfg):
        return action[..., :2].mean()
    if action.shape[-1] < 2:
        return torch.full((), float("nan"), dtype=action.dtype, device=action.device)
    quotes = action[..., :2]
    if cfg.normalise_action_space:
        low, high = cfg.action_bounds()
        low = device_constant(as_values(low[:2]), quotes.dtype, quotes.device)
        high = device_constant(as_values(high[:2]), quotes.dtype, quotes.device)
        quotes = (quotes + 1.0) * (high - low) / 2 + low
    return quotes.mean()


def mc_episode_stats(
    cfg: EnvConfig,
    policy: PolicyFn,
    policy_params,
    key,
    episodes: int = 1,
    backend: str = "auto",
    device=None,
) -> dict:
    """Monte-Carlo evaluation WITHOUT materializing trajectories: only
    per-episode scalars (episode-return and terminal-inventory moments,
    mean half-spread) are kept, so memory is O(N) per episode.  Use
    :func:`rollout` when per-step data is needed.

    ``backend``: same semantics as :func:`rollout`'s; "auto" routes the AS
    family to K1, the CJ and fixed-action policies to K5's stats mode and
    the CJ-OE schedule to K6 (:mod:`mbt_gym_torch.dispatch`).  A 1-column
    (speed) action has no quotes: ``mean_spread`` is NaN.
    ``key`` is an int seed or a ``torch.Generator`` on ``device``."""
    _check_backend(backend)
    device = env_lib.resolve_device(device)
    if backend != "engine":
        decision = _dispatch.dispatch_report(
            cfg, policy, mode="stats", platform=device, policy_params=policy_params
        )
        if decision.backend == "fused":
            return _dispatch.fused_mc_episode_stats(
                cfg, policy, policy_params, key, episodes, decision, device=device
            )
        if backend == "fused":
            raise ValueError(f"backend='fused' unavailable: {decision.reason}")
    n_scan = _episode_steps(cfg)
    random_start = isinstance(cfg.start_time, tuple)
    predraw = _should_predraw(cfg, n_scan)
    dtype = cfg.torch_dtype
    gen = env_lib.make_generator(key, device)
    total = torch.zeros(5, dtype=dtype, device=device)
    for _ in range(episodes):
        state, obs = env_lib.reset(cfg, gen, device=device)
        cube = native_noise_cube(cfg, state.key, n_scan) if predraw else None
        reward_acc = torch.zeros_like(state.cash)
        action_acc = torch.zeros((), dtype=dtype, device=device)
        live_acc = torch.zeros((), dtype=dtype, device=device)
        for t in range(n_scan):
            action = policy(policy_params, obs, state)
            res = env_lib.step(cfg, state, action, noise=None if cube is None else _noise_at(cube, t))
            quote_mean = _quote_mean(cfg, torch.as_tensor(action, dtype=dtype, device=device))
            if random_start:
                # Freeze post-done steps (same convention as rollout()) and
                # exclude them from the action average.
                was_done = state.time[0] >= cfg.terminal_time - cfg.step_size / 2
                state = _freeze(was_done, state, res.state)
                obs = torch.where(was_done, obs, res.obs)
                reward_acc = reward_acc + torch.where(was_done, torch.zeros_like(res.reward), res.reward)
                alive = (~was_done).to(dtype)
                action_acc = action_acc + alive * quote_mean
                live_acc = live_acc + alive
            else:
                state, obs = res.state, res.obs
                reward_acc = reward_acc + res.reward
                action_acc = action_acc + quote_mean
                live_acc = live_acc + 1.0
        total += torch.stack(
            [
                reward_acc.mean(),
                (reward_acc**2).mean(),
                state.inventory.mean(),
                (state.inventory**2).mean(),
                action_acc / torch.clamp(live_acc, min=1.0),
            ]
        )
    mean_r, mean_r2, mean_q, mean_q2, mean_a = total / episodes
    return {
        "mean_pnl": mean_r,
        "std_pnl": torch.sqrt(torch.clamp(mean_r2 - mean_r**2, min=0.0)),
        "mean_terminal_inventory": mean_q,
        "std_terminal_inventory": torch.sqrt(torch.clamp(mean_q2 - mean_q**2, min=0.0)),
        **_spread_stats(cfg, mean_a),
        "episodes": episodes * cfg.num_trajectories,
    }


def _spread_stats(cfg: EnvConfig, mean_a: torch.Tensor) -> dict:
    """``mean_spread`` from the mean half-spread; at the touch the actions
    are post flags, so ``mean_spread`` is NaN and ``post_rate`` the mean."""
    if _is_touch(cfg):
        return {"mean_spread": torch.full_like(mean_a, float("nan")), "post_rate": mean_a}
    return {"mean_spread": 2.0 * mean_a}


def episode_stats(cfg: EnvConfig, traj) -> dict:
    """The AS-replication summary table (helpers/plotting.py:94-110):
    mean spread (2x mean half-spread over all actions), mean/std total
    reward, mean/std terminal inventory.  Accepts the time-major
    :class:`Trajectory` or the feature-major :class:`TrajectoryT`."""
    if isinstance(traj, TrajectoryT):
        # TrajectoryT producers (the episode kernels' full-emit assembly)
        # carry RAW state planes.
        assert not cfg.normalise_observation_space, (
            "TrajectoryT planes are raw-unit; this config's observations "
            "are normalised — pass the time-major Trajectory instead"
        )
        terminal_inventory = traj.observations_t[1, -1]
        actions = traj.actions_t.movedim(0, -1)  # (T, N, A) view
    else:
        terminal_inventory = traj.observations[-1, :, 1]
        actions = traj.actions
    total_rewards = traj.rewards.sum(dim=0)  # (N,)
    if cfg.normalise_observation_space:
        low, high = cfg.observation_bounds()
        terminal_inventory = (terminal_inventory + 1.0) * float(high[1] - low[1]) / 2 + float(low[1])
    # Spread uses the bid/ask depth columns only, mapped back to raw units
    # when the action space is normalised (the reference's table averages
    # ALL action columns, plotting.py:99); at the touch it is NaN and the
    # posting rate stands beside it.
    return {
        **_spread_stats(cfg, _quote_mean(cfg, actions)),
        "mean_pnl": total_rewards.mean(),
        "std_pnl": total_rewards.std(correction=0),
        "mean_terminal_inventory": terminal_inventory.mean(),
        "std_terminal_inventory": terminal_inventory.std(correction=0),
    }
