"""mbt_gym_torch.ops.oe_episode (K6) and the optimal-execution engine path
against the JAX package: the plain K6 against oe_episode_pallas in
interpret mode on the same noise, the float64 engine against the plain
numpy oracle, and the float32 engine against the JAX engine.

On the CPU the wrappers take their plain PyTorch versions; the CUDA kernel
is held against its plain version on the card (tests/test_torch_cuda.py and
chip_smoke.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mbt_gym_tpu.agents.baseline import CarteaJaimungalOeAgent as JaxOeAgent
from mbt_gym_tpu.ops import pallas_episode as pe
from mbt_gym_tpu.rollout import rollout as jax_rollout
from mbt_gym_tpu.types import SlotNoise as JaxSlotNoise
from mbt_gym_tpu.utils.config import oe_env_config as jax_oe_env_config

from mbt_gym_torch import episode_stats, mc_episode_stats, rollout
from mbt_gym_torch.agents.baseline import CarteaJaimungalOeAgent, fixed_action_policy
from mbt_gym_torch.ops import oe_episode as oe
from mbt_gym_torch.ops.compat import reference_noise_cube
from mbt_gym_torch.types import SlotNoise
from mbt_gym_torch.utils.config import oe_env_config
from tests.reference_oracle import oracle_speed_rollout
from tests.test_torch_env import torch_config

N = 256


def _config(n_steps=40, **kw):
    return jax_oe_env_config(num_trajectories=N, n_steps=n_steps, initial_inventory=10, **kw)


def _agents(jcfg):
    jagent = JaxOeAgent.from_config(
        jcfg, phi=jcfg.reward_function.per_step_inventory_aversion,
        alpha=jcfg.reward_function.terminal_inventory_aversion,
    )
    agent = CarteaJaimungalOeAgent(**dataclasses.asdict(jagent))
    assert agent == CarteaJaimungalOeAgent.from_config(torch_config(jcfg), phi=jagent.phi, alpha=jagent.alpha)
    return jagent, agent


def _speed_noise(normals, slot_noise):
    """(T, N) midprice normals as the (midprice, impact) slot noise."""
    return (slot_noise(normal=normals[..., None], uniform=None), slot_noise(normal=None, uniform=None))


def test_params_and_speed_table_match_jax():
    jcfg = dataclasses.replace(_config(), initial_cash=3.0, start_time=0.25)
    jagent, agent = _agents(jcfg)
    cfg = torch_config(jcfg)
    want = pe.oe_params_from_config(jcfg)
    got = oe.oe_params_from_config(cfg)
    assert tuple(got) == tuple(want) and got.run_steps == want.run_steps == 30
    table = oe.oe_speed_table(cfg, agent)
    assert table.shape == (30,)
    # the same float32 expression of the closed form, in two frameworks
    np.testing.assert_allclose(table.numpy(), np.asarray(pe.oe_speed_table(jcfg, jagent)), rtol=1e-6, atol=0)


def test_k6_plain_matches_interpret_pallas_and_jax_engine():
    """tests/test_pallas_episode.py:207 with the port's plain K6 beside the
    JAX kernel: the terminal state against oe_episode_pallas(interpret=True)
    and the JAX engine on the same midprice noise, and the telescoped CjOe
    rewards against the engine's per-step sums, at that test's
    tolerances."""
    jcfg = _config()
    jagent, agent = _agents(jcfg)
    jp = pe.oe_params_from_config(jcfg)
    p = oe.oe_params_from_config(torch_config(jcfg))
    normals = np.random.default_rng(5).normal(size=(p.run_steps, N)).astype(np.float32)
    jtable = pe.oe_speed_table(jcfg, jagent)
    want = pe.oe_episode_pallas(jp, jtable, 0, N, rows=2, interpret=True, noise=jnp.asarray(normals))
    got = oe.oe_episode(p, np.array(jtable), 0, N, noise=torch.from_numpy(normals))
    names = ("cash", "inventory", "price", "perm", "sumq2", "sum_sq")
    for name, g, w in zip(names, got, want):
        # the same float32 ops; XLA's CPU backend may contract a multiply-add
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-3, err_msg=name)
    rewards = oe.oe_episode_rewards(torch_config(jcfg), agent, 0, N, noise=torch.from_numpy(normals))
    want_rewards = pe.oe_episode_rewards_pallas(jcfg, jagent, 0, N, rows=2, interpret=True, noise=jnp.asarray(normals))
    np.testing.assert_allclose(rewards.numpy(), np.asarray(want_rewards), rtol=1e-4, atol=2e-3)

    res = jax_rollout(jcfg, jagent.policy(), None, jax.random.PRNGKey(0), noise=_speed_noise(normals, JaxSlotNoise))
    final = np.asarray(res.trajectory.observations[-1])
    np.testing.assert_allclose(got[1].numpy(), final[:, 1], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[0].numpy(), final[:, 0], rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(got[2].numpy(), final[:, 3], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[3].numpy(), final[:, 4], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rewards.numpy(), np.asarray(res.trajectory.rewards.sum(axis=0)), rtol=1e-4, atol=2e-3)


def test_oe_rewards_identity_matches_port_engine():
    """The telescoped identity against the port's own engine (CjOe reward
    per step, summed) on the same noise: float32 summation-order noise on
    ~1000-magnitude marks, rtol=1e-4 / atol=2e-3 as above."""
    jcfg = _config(n_steps=50)
    cfg = torch_config(jcfg)
    _, agent = _agents(jcfg)
    p = oe.oe_params_from_config(cfg)
    normals = np.random.default_rng(9).normal(size=(50, N)).astype(np.float32)
    rewards = oe.oe_episode_rewards(cfg, agent, 0, N, noise=torch.from_numpy(normals))
    res = rollout(cfg, agent.policy(), None, 0, noise=_speed_noise(normals, SlotNoise), device="cpu")
    np.testing.assert_allclose(rewards.numpy(), res.trajectory.rewards.sum(0).numpy(), rtol=1e-4, atol=2e-3)
    assert p.run_steps == 50


def test_engine_matches_jax_engine_per_step_float32():
    """Speed dynamics, the impact state column (S=5) and the CjOe reward,
    step by step against the JAX engine on the same noise, with a late
    start and initial cash."""
    jcfg = dataclasses.replace(_config(), initial_cash=2.0, start_time=0.2)
    jagent, agent = _agents(jcfg)
    normals = np.random.default_rng(3).normal(size=(40, N)).astype(np.float32)
    jres = jax_rollout(jcfg, jagent.policy(), None, jax.random.PRNGKey(0), noise=_speed_noise(normals, JaxSlotNoise))
    res = rollout(torch_config(jcfg), agent.policy(), None, 0, noise=_speed_noise(normals, SlotNoise), device="cpu")
    got, want = res.trajectory.observations.numpy(), np.asarray(jres.trajectory.observations)
    assert got.shape == want.shape == (33, N, 5)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-3)
    np.testing.assert_allclose(res.trajectory.actions.numpy(), np.asarray(jres.trajectory.actions), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(res.trajectory.rewards.numpy(), np.asarray(jres.trajectory.rewards), rtol=0, atol=1e-3)


def test_float64_engine_matches_oracle():
    """tests/test_seed_exactness.py:98 for the port: speed dynamics,
    temporary and permanent impact and the CjOe reward in float64 on the
    reference's noise streams, against the plain numpy oracle."""
    cfg = oe_env_config(num_trajectories=64, n_steps=50, initial_inventory=10, dtype="float64")
    noise = reference_noise_cube(cfg, 50, dtype="float64")
    res = rollout(cfg, fixed_action_policy([-2.5]), None, 0, noise=noise, device="cpu")
    oracle = oracle_speed_rollout(
        lambda obs: np.full((obs.shape[0], 1), -2.5), 50, num_trajectories=64, n_steps=50,
        initial_inventory=10.0, phi=2e-4, alpha=0.01,
    )
    ours = res.trajectory.observations.numpy()
    np.testing.assert_allclose(ours[:, :, 0], oracle["observations"][:, :, 0], atol=1e-9)
    for col in (1, 3, 4):
        np.testing.assert_allclose(ours[:, :, col], oracle["observations"][:, :, col], atol=1e-12)
    np.testing.assert_allclose(res.trajectory.rewards.numpy(), oracle["rewards"], atol=1e-9)


def test_native_plain_k6_liquidates_on_the_closed_form_schedule():
    """The invariant of tests/test_pallas_episode.py:257: every env ends at
    q0 (zeta - 1) / (zeta e^gamma - e^-gamma), and the impact path is
    deterministic; mc stats report NaN spread for the 1-column action."""
    cfg = oe_env_config(num_trajectories=512, n_steps=200, initial_inventory=10)
    agent = CarteaJaimungalOeAgent.from_config(cfg, phi=2e-4, alpha=0.01)
    p = oe.oe_params_from_config(cfg)
    _, inv, _, perm, _, _ = oe.oe_episode(p, oe.oe_speed_table(cfg, agent), 3, 512, device="cpu")
    gamma = np.sqrt(agent.phi / agent.temporary_impact)
    root = np.sqrt(agent.temporary_impact * agent.phi)
    zeta = (agent.alpha - 0.5 * agent.permanent_impact + root) / (agent.alpha - 0.5 * agent.permanent_impact - root)
    q_t = 10.0 * (zeta - 1.0) / (zeta * np.exp(gamma) - np.exp(-gamma))
    np.testing.assert_allclose(inv.numpy(), q_t, rtol=1e-3)
    assert float(perm.std()) < 1e-6
    stats = oe.oe_mc_episode_stats(cfg, agent, 4, episodes=2, device="cpu")
    assert stats["episodes"] == 1024 and torch.isnan(stats["mean_spread"])
    assert float(stats["mean_terminal_inventory"]) == pytest.approx(q_t, rel=1e-3)


def test_one_column_actions_report_nan_spread():
    """mbt_gym_tpu/rollout.py:292,332: a 1-column (speed) action has no
    quotes, so both summaries report NaN for the spread, not twice the
    speed."""
    cfg = oe_env_config(num_trajectories=64, n_steps=10)
    policy = fixed_action_policy([-2.5])
    res = rollout(cfg, policy, None, 0, backend="engine", device="cpu")
    assert torch.isnan(episode_stats(cfg, res.trajectory)["mean_spread"])
    stats = mc_episode_stats(cfg, policy, None, 0, backend="engine", device="cpu")
    assert torch.isnan(stats["mean_spread"]) and torch.isfinite(stats["mean_pnl"])


@pytest.mark.parametrize(
    "change",
    [
        {"dtype": "float64"},
        {"normalise_observation_space": True},
        {"reward_scaling": 2.0},
        {"start_time": ("uniform", 0.0, 0.5)},
        {"initial_inventory": (5, 15)},
    ],
    ids=["float64", "normalised", "reward_scaling", "random-start", "random-inventory"],
)
def test_params_guards_match_jax(change):
    jcfg = dataclasses.replace(_config(), **change)
    with pytest.raises(AssertionError):
        pe.oe_params_from_config(jcfg)
    with pytest.raises(AssertionError):
        oe.oe_params_from_config(torch_config(jcfg))


def test_wrapper_rejects_bad_noise():
    cfg = oe_env_config(num_trajectories=128, n_steps=10)
    p = oe.oe_params_from_config(cfg)
    with pytest.raises(ValueError, match="noise must be float32"):
        oe.oe_episode(p, torch.zeros(10), 0, 128, noise=torch.zeros((10, 64)))
    with pytest.raises(AssertionError):
        oe.oe_episode(p, torch.zeros(9), 0, 128, device="cpu")


def test_k6_geometry_has_one_channel_and_no_table():
    """K6 at 8,192 x 200 runs the step pipeline with the midprice normal
    alone: one draw channel, no table, 64-env CTAs (128 CTAs for the
    card's 132 SMs), the ring within SMEM_BUDGET; the ctypes mirror ends
    with the geometry's nine ints, as struct OeKernelParams declares it."""
    import ctypes

    from mbt_gym_torch.ops import step_pipeline as sp

    p = oe.oe_params_from_config(oe_env_config(num_trajectories=8_192))
    g = oe.kernel_geometry(p, 8_192)
    assert g.shape == "pipeline" and (g.channels, g.table_rows, g.table_path, g.staged) == (1, 0, "none", 0)
    assert g.envs == 64 and -(-8_192 // g.envs) >= sp.SM_SHARE * sp.H100_SMS
    assert g.smem_bytes == sp.ring_bytes(g.envs, g.chunk, g.slots, 1) <= sp.SMEM_BUDGET
    assert oe.OeKernelParams.pipe.offset == ctypes.sizeof(oe.OeKernelParams) - 9 * 4
