"""Auto-dispatching front door (counterpart of ``mbt_gym_tpu/dispatch.py``):
route eligible (config, policy) pairs to the CUDA kernel families, with an
inspectable fallback reason.

- policies built by ``agents.baseline`` carry a ``dispatch_meta`` attribute
  naming their kind;
- :func:`dispatch_report` checks (config, policy kind, platform) against
  each kernel family's contract and returns a :class:`DispatchDecision`
  naming the matched family — or, on fallback, the disqualifying feature;
- ``rollout()`` / ``mc_episode_stats()`` consult it under
  ``backend="auto"`` (their default) and route accordingly.

Families ported so far:

==============  =======================================  ========  =====
family          kernel                                   rollout   stats
==============  =======================================  ========  =====
as_episode      ops.episode K2 (rollout) / K1 (stats)    yes       yes
==============  =======================================  ========  =====

The JAX package's other families (``cj_table``, ``fixed``, ``oe_episode``,
``mlp_rollout``) are not ported yet: their policy kinds run the engine,
and the reason names the family.  Backend names: ``"fused"`` for a kernel
family, ``"engine"`` for the general eager engine (the JAX package's
``"xla"``).

Semantics: the fused family is validated against the engine step for step
on injected noise (tests/test_torch_*.py); native-mode RNG *streams* differ
between the backends, so ``backend="auto"`` results are statistically — not
bitwise — equal to ``backend="engine"``.  Replay features (injected noise,
reset overrides, float64) always take the engine, with the reason naming
them.  ``EnvState.clip_events`` is not tracked by the kernels (reads 0 in
the fused ``final_state``); use ``backend="engine"`` when it matters.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from mbt_gym_torch.env import EnvConfig, make_generator, resolve_device
from mbt_gym_torch.types import EnvState


class DispatchDecision(NamedTuple):
    """Outcome of :func:`dispatch_report` — which backend the front door
    will use and why."""

    backend: str  # "fused" | "engine"
    family: Optional[str]  # kernel family when backend == "fused"
    reason: str  # the matched contract, or the disqualifying feature


class _Ineligible(Exception):
    pass


def tag_policy(fn, **meta):
    """Attach dispatch metadata to a policy callable (its ``kind`` plus
    kind-specific fields).  Policies without metadata always run the engine."""
    fn.dispatch_meta = dict(meta)
    return fn


def policy_meta(policy) -> Optional[dict]:
    return getattr(policy, "dispatch_meta", None)


# ------------------------------------------------------------ family checks
def _require_lane_batch(cfg: EnvConfig):
    if cfg.num_trajectories % 128:
        raise _Ineligible(
            f"num_trajectories={cfg.num_trajectories} is not a multiple of "
            "128 (the kernels tile envs on 128 lanes)"
        )


def _check_as(cfg: EnvConfig, meta: dict, mode: str) -> None:
    from mbt_gym_torch.agents.baseline import AvellanedaStoikovAgent
    from mbt_gym_torch.ops import episode

    agent = meta["agent"]
    try:
        episode.params_from_config(cfg, risk_aversion=agent.risk_aversion)
    except AssertionError as e:
        raise _Ineligible(str(e))
    if agent != AvellanedaStoikovAgent.from_config(cfg, risk_aversion=agent.risk_aversion):
        raise _Ineligible(
            "AS agent parameters differ from the env config (build the "
            "agent with AvellanedaStoikovAgent.from_config)"
        )
    _require_lane_batch(cfg)


_FAMILIES = {
    "as_closed_form": ("as_episode", _check_as),
}

# Policy kinds whose kernel family the JAX package has and this port does
# not yet (ROADMAP.md Queue 1 item 10, Queue 2 K3-K8).
_UNPORTED = {
    "cj_closed_form": "cj_table",
    "fixed": "fixed",
    "oe_schedule": "oe_episode",
    "mlp_deterministic": "mlp_rollout",
}


def dispatch_report(
    cfg: EnvConfig, policy, mode: str = "rollout", platform: Optional[str] = None,
    policy_params=None,
) -> DispatchDecision:
    """Decide fused-vs-engine for (config, policy) and say why.

    ``mode``: "rollout" (full-trajectory contract) or "stats"
    (:func:`mc_episode_stats` contract).  ``platform`` is the device type
    the call targets; ``None`` means the entry points' default, ``"cuda"``.
    The kernels run on CUDA devices only, so a CPU target takes the
    engine.  ``policy_params`` is accepted for signature parity; no ported
    family reads it."""
    assert mode in ("rollout", "stats"), mode
    meta = policy_meta(policy)
    if meta is None:
        return DispatchDecision(
            "engine", None,
            "policy carries no dispatch metadata (closed-form agents and "
            "fixed_action_policy are tagged; custom callables run the engine)",
        )
    kind = meta.get("kind")
    if kind in _UNPORTED:
        return DispatchDecision(
            "engine", None,
            f"policy kind {kind!r} maps to the {_UNPORTED[kind]} kernel "
            "family, which is not ported to CUDA yet",
        )
    if kind not in _FAMILIES:
        return DispatchDecision("engine", None, f"policy kind {kind!r} has no fused kernel family")
    family, check = _FAMILIES[kind]
    try:
        check(cfg, meta, mode)
    except _Ineligible as e:
        return DispatchDecision("engine", None, str(e))
    platform = platform if platform is not None else "cuda"
    if platform != "cuda":
        return DispatchDecision(
            "engine", None,
            f"config and policy match the {family} kernel contract, but the "
            f"kernel requires a CUDA device (running on {platform})",
        )
    return DispatchDecision("fused", family, f"config and policy match the {family} kernel contract")


# ------------------------------------------------------------ execution
def _final_state_from_obs(
    cfg: EnvConfig, obs_final, key, run_steps: int, initial_inventory, start_time: float,
) -> EnvState:
    """:class:`EnvState` from the terminal observation (every state plane
    in slot order — env.raw_observation's column contract).
    ``clip_events`` is not tracked by the kernels and reads 0."""
    n = cfg.num_trajectories
    dtype = cfg.torch_dtype
    raw = obs_final.to(dtype)
    device = raw.device
    col = 3
    proc = []
    for _, pr in cfg.dynamics.processes():
        d = pr.state_dim
        proc.append(raw[:, col : col + d])
        col += d
    return EnvState(
        cash=raw[:, 0],
        inventory=raw[:, 1],
        time=raw[:, 2],
        process_states=tuple(proc),
        step=torch.tensor(run_steps, dtype=torch.int32, device=device),
        key=key,
        initial_inventory=torch.as_tensor(initial_inventory, dtype=dtype, device=device).expand(n),
        start_time=torch.tensor(start_time, dtype=dtype, device=device),
        clip_events=torch.zeros((), dtype=torch.int32, device=device),
    )


def fused_rollout(cfg: EnvConfig, policy, policy_params, key, decision, device=None):
    """Execute a fused-family rollout and assemble the engine-compatible
    :class:`~mbt_gym_torch.rollout.RolloutResult` (Trajectory + final
    EnvState).  The episode seed is drawn from ``key`` (an int seed or a
    ``torch.Generator``), which becomes the final state's noise source."""
    from mbt_gym_torch.ops import episode
    from mbt_gym_torch.rollout import RolloutResult

    assert decision.family == "as_episode", decision
    device = resolve_device(device)
    gen = make_generator(key, device)
    agent = policy_meta(policy)["agent"]
    p = episode.params_from_config(cfg, risk_aversion=agent.risk_aversion)
    # emit="full": rewards and closed-form actions come kernel-computed, so
    # the Trajectory assembly is layout work only.
    streams = episode.as_episode_trajectories(
        p, episode.seed_from_key(gen), cfg.num_trajectories, emit="full", device=device
    )
    traj = episode.as_trajectory_from_full(p, streams)
    final = _final_state_from_obs(
        cfg, traj.observations[-1], gen, p.run_steps, p.initial_inventory, p.start_time,
    )
    return RolloutResult(trajectory=traj, final_state=final)


def fused_mc_episode_stats(cfg: EnvConfig, policy, policy_params, key, episodes, decision,
                           device=None):
    """Execute a fused-family throughput-mode evaluation, returning the
    :func:`~mbt_gym_torch.rollout.mc_episode_stats` summary dict."""
    from mbt_gym_torch.ops.episode import as_mc_episode_stats

    assert decision.family == "as_episode", decision
    return as_mc_episode_stats(cfg, policy_meta(policy)["agent"].risk_aversion, key, episodes,
                               device=device)
