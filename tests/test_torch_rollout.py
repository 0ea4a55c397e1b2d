"""mbt_gym_torch rollout, mc_episode_stats and dispatch against the JAX
package: AS table bands on the CPU, dispatch reasons for the same guards,
and the fused path's assembly run through the kernels' plain versions."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from mbt_gym_tpu import dispatch as jax_dispatch
from mbt_gym_tpu.agents.baseline import AvellanedaStoikovAgent as JaxAgent
from mbt_gym_tpu.agents.baseline import fixed_action_policy as jax_fixed_action_policy
from mbt_gym_tpu.dynamics import LimitAndMarketOrderDynamics as JaxLam
from mbt_gym_tpu.rollout import rollout as jax_rollout
from mbt_gym_tpu.rollout import to_reference_layout as jax_to_reference_layout
from mbt_gym_tpu.types import SlotNoise as JaxSlotNoise
from mbt_gym_tpu.utils.config import as_env_config as jax_as_env_config

from mbt_gym_torch import dispatch, episode_stats, mc_episode_stats, rollout
from mbt_gym_torch.agents.baseline import AvellanedaStoikovAgent, fixed_action_policy
from mbt_gym_torch.ops import episode as ep
from mbt_gym_torch.rollout import to_reference_layout
from mbt_gym_torch.types import SlotNoise
from mbt_gym_torch.utils.config import as_env_config
from tests.test_torch_env import assert_state_close, channels_noise, random_channels, torch_config


def _assert_as_bands(stats):
    """The AS table bands of tests/test_pallas_episode.py:150-152."""
    stats = {k: float(v) for k, v in stats.items()}
    assert abs(stats["mean_spread"] - 1.4918) < 0.01, stats
    assert abs(stats["mean_pnl"] - 64.87) < 1.0, stats
    assert abs(stats["std_terminal_inventory"] - 2.89) < 0.3, stats


def test_engine_rollout_and_mc_stats_in_as_bands_on_cpu():
    cfg = as_env_config(num_trajectories=1024)
    policy = AvellanedaStoikovAgent.from_config(cfg, 0.1).policy()
    res = rollout(cfg, policy, None, 50, device="cpu")
    assert res.trajectory.observations.shape == (201, 1024, 4)
    _assert_as_bands(episode_stats(cfg, res.trajectory))
    stats = mc_episode_stats(cfg, policy, None, 51, episodes=1, device="cpu")
    assert stats["episodes"] == 1024
    _assert_as_bands(stats)


def test_fused_paths_through_plain_versions_on_cpu():
    """fused_rollout / fused_mc_episode_stats assemble the engine's
    contract from K2/K1; on the CPU they run the plain versions."""
    cfg = as_env_config(num_trajectories=1024)
    policy = AvellanedaStoikovAgent.from_config(cfg, 0.1).policy()
    decision = dispatch.DispatchDecision("fused", "as_episode", "")
    res = dispatch.fused_rollout(cfg, policy, None, 3, decision, device="cpu")
    traj = res.trajectory
    assert traj.observations.shape == (201, 1024, 4)
    assert traj.actions.shape == (200, 1024, 2) and traj.rewards.shape == (200, 1024)
    _assert_as_bands(episode_stats(cfg, traj))
    final = res.final_state
    torch.testing.assert_close(final.inventory, traj.observations[-1, :, 1], rtol=0, atol=0)
    torch.testing.assert_close(final.process_states[0][:, 0], traj.observations[-1, :, 3], rtol=0, atol=0)
    assert int(final.clip_events) == 0 and int(final.step) == 200
    assert isinstance(final.key, torch.Generator)
    # rewards telescope to terminal mark-to-market
    value = traj.observations[..., 0] + traj.observations[..., 1] * traj.observations[..., 3]
    torch.testing.assert_close(traj.rewards.sum(0), value[-1] - value[0], rtol=0, atol=2e-3)
    stats = dispatch.fused_mc_episode_stats(cfg, policy, None, 4, 2, decision, device="cpu")
    assert stats["episodes"] == 2048
    _assert_as_bands(stats)


def _jax_lam(cfg):
    d = cfg.dynamics
    return dataclasses.replace(cfg, dynamics=JaxLam(
        midprice_model=d.midprice_model, arrival_model=d.arrival_model,
        fill_probability_model=d.fill_probability_model,
    ))


GUARDS = {
    "lam": None,
    "float64": {"dtype": "float64"},
    "normalised": {"normalise_action_space": True, "normalise_observation_space": True},
    "reward_scaling": {"reward_scaling": 0.5},
    "n-not-128": {"num_trajectories": 1000},
    "mismatched-agent": "agent",
}


@pytest.mark.parametrize("guard", list(GUARDS))
def test_dispatch_reasons_match_jax(guard):
    """Each guard sends both front doors to their general engine, with the
    JAX reason in the port's words (TPU and XLA names replaced)."""
    jcfg = jax_as_env_config(num_trajectories=1024)
    jagent = JaxAgent.from_config(jcfg, 0.1)
    change = GUARDS[guard]
    if guard == "lam":
        jcfg = _jax_lam(jcfg)
        cfg = torch_config(jcfg)
    elif guard == "mismatched-agent":
        cfg = torch_config(jcfg)
        jagent = dataclasses.replace(jagent, volatility=3.0)
    else:
        jcfg = dataclasses.replace(jcfg, **change)
        cfg = torch_config(jcfg)
    agent = AvellanedaStoikovAgent(**dataclasses.asdict(jagent))
    for mode in ("rollout", "stats"):
        want = jax_dispatch.dispatch_report(jcfg, jagent.policy(), mode=mode, platform="tpu")
        got = dispatch.dispatch_report(cfg, agent.policy(), mode=mode, platform="cuda")
        assert (want.backend, got.backend) == ("xla", "engine")
        assert got.family is None
        if guard == "normalised":
            assert want.reason == ""  # the JAX guard carries no message
            assert "normalised" in got.reason
        else:
            expected = (
                want.reason.replace("pallas fast path", "episode kernel")
                .replace("XLA-engine", "engine").replace("XLA rollout", "engine rollout")
            )
            assert got.reason == expected


def test_dispatch_platform_and_policy_kinds():
    cfg = as_env_config(num_trajectories=1024)
    policy = AvellanedaStoikovAgent.from_config(cfg, 0.1).policy()
    assert dispatch.dispatch_report(cfg, policy) == dispatch.DispatchDecision(
        "fused", "as_episode", "config and policy match the as_episode kernel contract"
    )
    cpu = dispatch.dispatch_report(cfg, policy, platform="cpu")
    assert cpu.backend == "engine"
    assert cpu.reason.endswith("requires a CUDA device (running on cpu)")
    fixed = dispatch.dispatch_report(cfg, fixed_action_policy([0.7, 0.7]), platform="cuda")
    assert (fixed.backend, fixed.family) == ("fused", "fixed")
    untagged = dispatch.dispatch_report(cfg, lambda params, obs, state: obs[:, :2], platform="cuda")
    assert untagged.backend == "engine" and "no dispatch metadata" in untagged.reason
    with pytest.raises(ValueError, match="requires a CUDA device"):
        rollout(cfg, policy, None, 0, backend="fused", device="cpu")
    with pytest.raises(ValueError, match="replay features"):
        rollout(cfg, policy, None, 0, backend="fused", start_time=0.5, device="cpu")
    with pytest.raises(AssertionError, match="backend must be one of"):
        rollout(cfg, policy, None, 0, backend="xla", device="cpu")


def test_fixed_policy_engine_matches_jax_and_reference_layout():
    jcfg = jax_as_env_config(num_trajectories=128, n_steps=25)
    cfg = torch_config(jcfg)
    channels = random_channels(21, 25, 128)
    jres = jax_rollout(
        jcfg, jax_fixed_action_policy([0.6, 0.9]), None, jax.random.PRNGKey(0),
        noise=channels_noise(channels, JaxSlotNoise),
    )
    res = rollout(
        cfg, fixed_action_policy([0.6, 0.9]), None, 0,
        noise=channels_noise(channels, SlotNoise), device="cpu",
    )
    assert_state_close(res.trajectory.observations.numpy(), np.asarray(jres.trajectory.observations))
    for got, want in zip(to_reference_layout(res.trajectory), jax_to_reference_layout(jres.trajectory)):
        assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(
        to_reference_layout(res.trajectory)[1].numpy(), np.asarray(jax_to_reference_layout(jres.trajectory)[1])
    )


def test_trajectory_t_views_match_time_major():
    cfg = as_env_config(num_trajectories=256, n_steps=20)
    p = ep.params_from_config(cfg, 0.1)
    streams = ep.as_episode_trajectories(p, 1, 256, emit="full", device="cpu")
    traj = ep.as_trajectory_from_full(p, streams)
    traj_t = ep.as_trajectory_t_from_full(p, streams)
    for got, want in zip(traj_t.to_reference_layout(), to_reference_layout(traj)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    # the same numbers, summed in another order through the strided view
    for key, value in episode_stats(cfg, traj_t).items():
        torch.testing.assert_close(value, episode_stats(cfg, traj)[key], rtol=1e-6, atol=0)
