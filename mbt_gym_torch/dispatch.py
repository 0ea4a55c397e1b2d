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

Families and the entry-point modes they serve:

==============  =======================================  ========  =====  ========
family          kernel                                   rollout   stats  evaluate
==============  =======================================  ========  =====  ========
as_episode      ops.episode K2 (rollout) / K1 (stats)    yes       yes    no
cj_table        ops.det_rollout K5, table policy         yes       yes    no
fixed           ops.det_rollout K5, fixed policy         yes       yes    no
oe_episode      ops.det_rollout K5, schedule policy      yes       yes    no
                (rollout) / ops.oe_episode K6 (stats)
mlp_rollout     ops.mlp_rollout K3, ppo.deterministic_   no        no     yes
                policy
==============  =======================================  ========  =====  ========

The CJP value-function lane, :func:`mbt_gym_torch.ops.cj_episode.cj_episode_rewards`
(K8), is called directly.  Mode ``"evaluate"`` is the contract of
:func:`mbt_gym_torch.agents.ppo.evaluate_policy` (the mean episode reward
of the deterministic MLP policy), which consults it under
``backend="auto"``; K3 writes no terminal state, so ``rollout()`` and
``mc_episode_stats()`` of that policy run the engine, as in the JAX
package.  Where the kernel's contract holds, the ``mlp_rollout`` family
decides between K3 and the engine by the port's own measurement on the
card (:data:`MLP_EVALUATE_MEASURED`), once K3's streams fit the target
card's free memory (the TPU's VMEM rule ``mlp_streams_feasible`` made the
H100's own, as for K5).  Backend names: ``"fused"`` for a
kernel family, ``"engine"`` for the general eager engine (the JAX
package's ``"xla"``).

Semantics: every fused family is validated against the engine step for step
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
from mbt_gym_torch.types import EnvState, Trajectory


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


def _check_as(cfg: EnvConfig, meta: dict, mode: str, device: torch.device) -> None:
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


def _streams_fit(p, cfg: EnvConfig, device: torch.device, tables_bytes: int = 0) -> None:
    from mbt_gym_torch.ops import det_rollout as det

    if not det.det_streams_feasible(p, cfg.num_trajectories, tables_bytes, device):
        raise _Ineligible(
            f"the {cfg.n_steps}-step horizon's trajectory streams at "
            f"{cfg.num_trajectories} envs exceed free device memory for the "
            f"{p.policy_kind} kernel; full trajectories run on the engine "
            "(stats mode stays fused)"
        )


def _check_cj(cfg: EnvConfig, meta: dict, mode: str, device: torch.device) -> None:
    from mbt_gym_torch.agents.baseline import CarteaJaimungalMmAgent
    from mbt_gym_torch.ops import det_rollout as det

    agent = meta["agent"]
    try:
        p = det.cj_rollout_params(cfg, agent)
        reference = CarteaJaimungalMmAgent.from_config(cfg, max_inventory=agent.max_inventory)
    except AssertionError as e:
        raise _Ineligible(str(e))
    if agent != reference:
        raise _Ineligible(
            "CJ agent parameters differ from the env config (build the "
            "agent with CarteaJaimungalMmAgent.from_config)"
        )
    if p.dynamics_kind != "limit":
        raise _Ineligible(
            "the depth-table policy quotes (bid, ask) limit depths — "
            f"limit-order dynamics only (config has {p.dynamics_kind})"
        )
    if p.normalise_act:
        raise _Ineligible(
            "closed-form depths are model units; disable "
            "normalise_action_space for the closed-form CJ policy"
        )
    if p.random_start:
        raise _Ineligible("random start times with the table policy run on the engine")
    if p.inventory_range and mode == "stats":
        raise _Ineligible(
            "random initial inventory is unsupported by the table stats "
            "kernel wrapper; use backend='engine' or mode='rollout'"
        )
    if mode == "rollout":
        _streams_fit(p, cfg, device, tables_bytes=2 * (cfg.n_steps + 1) * p.table_size * 4)
    _require_lane_batch(cfg)


def _check_fixed(cfg: EnvConfig, meta: dict, mode: str, device: torch.device) -> None:
    from mbt_gym_torch.ops import det_rollout as det

    action = meta["action"]
    try:
        p = det.fixed_rollout_params(cfg, action)
    except AssertionError as e:
        raise _Ineligible(str(e))
    expected = {"limit": 2, "lam": 4, "touch": 2, "speed": 1}[p.dynamics_kind]
    if len(p.fixed_action) != expected:
        raise _Ineligible(
            f"fixed action has {len(p.fixed_action)} columns; "
            f"{p.dynamics_kind} dynamics takes {expected}"
        )
    if p.random_start:
        raise _Ineligible("random start times with the fixed policy run on the engine")
    if p.inventory_range and mode == "stats":
        raise _Ineligible(
            "random initial inventory is unsupported by the fixed stats "
            "kernel wrapper; use backend='engine' or mode='rollout'"
        )
    if mode == "rollout":
        _streams_fit(p, cfg, device)
    _require_lane_batch(cfg)


def _check_oe(cfg: EnvConfig, meta: dict, mode: str, device: torch.device) -> None:
    from mbt_gym_torch.agents.baseline import CarteaJaimungalOeAgent
    from mbt_gym_torch.ops import det_rollout as det
    from mbt_gym_torch.ops import oe_episode as oe

    agent = meta["agent"]
    try:
        oe.oe_params_from_config(cfg)
        reference = CarteaJaimungalOeAgent.from_config(cfg, phi=agent.phi, alpha=agent.alpha)
        # full trajectories run on K5's schedule kind, stats on K6
        p = det.schedule_rollout_params(cfg) if mode == "rollout" else None
    except AssertionError as e:
        raise _Ineligible(str(e))
    if p is not None:
        _streams_fit(p, cfg, device)
    if agent != reference:
        raise _Ineligible(
            "CJ-OE agent parameters differ from the env config (build the "
            "agent with CarteaJaimungalOeAgent.from_config)"
        )
    _require_lane_batch(cfg)


# evaluate_policy at 16,384 envs x 200 steps on the normalised AS env,
# 256x256, in env-steps/s: (K3 through backend="fused", the engine), per
# layout.  chip_smoke.py phase 21 on an NVIDIA H100 80GB HBM3 at 700 W.
MLP_EVALUATE_MEASURED = {
    "shared trunk": (149835752.3, 8587121.5),
    "separate towers": (169311055.3, 10052501.1),
}


def _check_mlp(cfg: EnvConfig, meta: dict, mode: str, device: torch.device, policy_params=None) -> str:
    from mbt_gym_torch.ops import det_rollout as det
    from mbt_gym_torch.ops import mlp_rollout as mr

    if mode != "evaluate":
        raise _Ineligible(
            "the mlp_rollout kernel family serves evaluate_policy (mode='evaluate') only: K3 "
            "writes no terminal state, so rollout() and mc_episode_stats() of the deterministic "
            "policy run the engine"
        )
    try:
        p = mr.rollout_params_from_config(cfg)
    except AssertionError as e:
        raise _Ineligible(str(e))
    # K3's (T, S + A + 3, N) streams and the (T, N) advantages and returns
    floats = p.run_steps * (len(p.obs_low) + len(p.act_low) + 5) * cfg.num_trajectories
    if 4 * floats > det.device_free_bytes(device):
        raise _Ineligible(
            f"K3's {p.run_steps}-step streams at {cfg.num_trajectories} envs exceed free device memory; "
            "evaluation runs on the engine"
        )
    layout = "shared trunk"
    if policy_params is not None:
        layout = "shared trunk" if policy_params.shared_trunk else "separate towers"
        try:
            tp = mr.transpose_params(policy_params)
            mr.check_kernel_shapes(p, tp.split_at or [w.shape[0] for w, _ in tp.trunk], cfg.num_trajectories)
        except ValueError as e:
            raise _Ineligible(str(e))
    fused, engine = MLP_EVALUATE_MEASURED[layout]
    figures = (f"K3 {fused:.4g} vs engine {engine:.4g} env-steps/s for the {layout} at 16,384 x 200 "
               "on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 21)")
    if not fused > engine:
        raise _Ineligible(f"the engine measured faster than K3 for deterministic evaluation: {figures}")
    return f"K3 measured faster than the engine for deterministic evaluation: {figures}"


_FAMILIES = {
    "as_closed_form": ("as_episode", _check_as),
    "cj_closed_form": ("cj_table", _check_cj),
    "fixed": ("fixed", _check_fixed),
    "oe_schedule": ("oe_episode", _check_oe),
    "mlp_deterministic": ("mlp_rollout", _check_mlp),
}


def dispatch_report(
    cfg: EnvConfig, policy, mode: str = "rollout", platform: Optional[str] = None,
    policy_params=None,
) -> DispatchDecision:
    """Decide fused-vs-engine for (config, policy) and say why.

    ``mode``: "rollout" (full-trajectory contract), "stats"
    (:func:`mc_episode_stats` contract) or "evaluate"
    (:func:`~mbt_gym_torch.agents.ppo.evaluate_policy` contract).
    ``platform`` is the device the call targets, or its type
    (``"cuda:1"``, ``"cuda"``, ``"cpu"``); ``None`` means the entry points'
    default, ``"cuda"``.  The kernels run on CUDA devices only, so a CPU
    target takes the engine; the streams memory rule reads the target
    card's memory.  ``policy_params`` (the trained model) lets the
    ``mlp_rollout`` family check its layout and widths against K3's
    limits; omitted, they are not checked."""
    assert mode in ("rollout", "stats", "evaluate"), mode
    meta = policy_meta(policy)
    if meta is None:
        return DispatchDecision(
            "engine", None,
            "policy carries no dispatch metadata (closed-form agents and "
            "fixed_action_policy are tagged; custom callables run the engine)",
        )
    kind = meta.get("kind")
    if kind not in _FAMILIES:
        return DispatchDecision("engine", None, f"policy kind {kind!r} has no fused kernel family")
    family, check = _FAMILIES[kind]
    if mode == "evaluate" and kind != "mlp_deterministic":
        return DispatchDecision(
            "engine", None, "mode 'evaluate' is evaluate_policy's contract, for ppo.deterministic_policy",
        )
    target = torch.device(platform if platform is not None else "cuda")
    try:
        if kind == "mlp_deterministic":
            note = check(cfg, meta, mode, target, policy_params)
        else:
            note = check(cfg, meta, mode, target)
    except _Ineligible as e:
        return DispatchDecision("engine", None, str(e))
    if target.type != "cuda":
        return DispatchDecision(
            "engine", None,
            f"config and policy match the {family} kernel contract, but the "
            f"kernel requires a CUDA device (running on {target.type})",
        )
    reason = f"config and policy match the {family} kernel contract"
    return DispatchDecision("fused", family, f"{reason}; {note}" if note else reason)


# ------------------------------------------------------------ execution
def _final_state_from_obs(
    cfg: EnvConfig, obs_final, key, run_steps: int, initial_inventory, start_time: float,
) -> EnvState:
    """:class:`EnvState` from the terminal observation (every state plane
    in slot order — env.raw_observation's column contract), mapped back to
    raw units when the config normalises observations.  ``clip_events`` is
    not tracked by the kernels and reads 0."""
    n = cfg.num_trajectories
    dtype = cfg.torch_dtype
    raw = obs_final.to(dtype)
    device = raw.device
    if cfg.normalise_observation_space:
        low, high = (torch.as_tensor(b, dtype=dtype, device=device) for b in cfg.observation_bounds())
        raw = (raw + 1.0) * (high - low) / 2 + low
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
    EnvState).  The episode seed (and, under a random initial inventory,
    the per-env draws first) comes from ``key`` (an int seed or a
    ``torch.Generator``), which becomes the final state's noise source."""
    from mbt_gym_torch.ops import det_rollout as det
    from mbt_gym_torch.ops import episode
    from mbt_gym_torch.rollout import RolloutResult

    device = resolve_device(device)
    gen = make_generator(key, device)
    meta = policy_meta(policy)
    n = cfg.num_trajectories
    if decision.family == "as_episode":
        p = episode.params_from_config(cfg, risk_aversion=meta["agent"].risk_aversion)
        # K2 writes the time-major Trajectory itself: rewards and
        # closed-form actions kernel-computed, no layout copies after it.
        traj = episode.as_episode_trajectory(p, episode.seed_from_key(gen), n, device=device)
        final = _final_state_from_obs(
            cfg, traj.observations[-1], gen, p.run_steps, p.initial_inventory, p.start_time,
        )
        return RolloutResult(trajectory=traj, final_state=final)

    if decision.family == "oe_episode":
        # full trajectories on K5's schedule kind (K6 serves the stats mode)
        p = det.schedule_rollout_params(cfg)
        tables = (det.schedule_table_from_policy(cfg, policy),)
    elif decision.family == "cj_table":
        p = det.cj_rollout_params(cfg, meta["agent"])
        tables = det.cj_depth_tables(meta["agent"])
    else:
        assert decision.family == "fixed", decision
        p = det.fixed_rollout_params(cfg, meta["action"])
        tables = ()
    if p.inventory_range:
        lo, hi = p.inventory_range
        inv0 = torch.randint(lo, hi, (n,), generator=gen, device=device).to(torch.float32)
        q0 = inv0
    else:
        inv0, q0 = None, p.initial_inventory
    obs_t, act_t, _, _, rew, fin = det.det_rollout(
        p, tables, episode.seed_from_key(gen), n, inv0=inv0, final_obs=True, device=device,
    )
    observations = torch.cat([obs_t.transpose(1, 2), fin.T[None]], dim=0)
    traj = Trajectory(observations=observations, actions=act_t.transpose(1, 2), rewards=rew)
    final = _final_state_from_obs(cfg, observations[-1], gen, p.run_steps, q0, p.start_time)
    return RolloutResult(trajectory=traj, final_state=final)


def fused_mc_episode_stats(cfg: EnvConfig, policy, policy_params, key, episodes, decision,
                           device=None):
    """Execute a fused-family throughput-mode evaluation, returning the
    :func:`~mbt_gym_torch.rollout.mc_episode_stats` summary dict."""
    from mbt_gym_torch.ops import det_rollout as det
    from mbt_gym_torch.ops.episode import as_mc_episode_stats
    from mbt_gym_torch.ops.oe_episode import oe_mc_episode_stats

    meta = policy_meta(policy)
    if decision.family == "as_episode":
        return as_mc_episode_stats(cfg, meta["agent"].risk_aversion, key, episodes, device=device)
    if decision.family == "oe_episode":
        return oe_mc_episode_stats(cfg, meta["agent"], key, episodes, device=device)
    if decision.family == "cj_table":
        return det.cj_mc_episode_stats(cfg, meta["agent"], key, episodes, device=device)
    assert decision.family == "fixed", decision
    return det.fixed_mc_episode_stats(cfg, meta["action"], key, episodes, device=device)
