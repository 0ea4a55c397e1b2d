"""The Cartea-Jaimungal agents, rewards and configs of mbt_gym_torch
against the JAX package: the agents' tables bit for bit, the policies on
the same observations, the engine on the CJ configs (float32 against the
JAX engine, float64 against the plain numpy oracle), the time index the
engine policy and the kernels use, and the CJP value-function t-test."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from mbt_gym_tpu.agents.baseline import CarteaJaimungalMmAgent as JaxCjAgent
from mbt_gym_tpu.agents.baseline import CarteaJaimungalOeAgent as JaxOeAgent
from mbt_gym_tpu.env import reset as jax_reset
from mbt_gym_tpu.rewards import PnL as JaxPnL
from mbt_gym_tpu.rewards import RunningInventoryPenalty as JaxRunning
from mbt_gym_tpu.rollout import rollout as jax_rollout
from mbt_gym_tpu.types import SlotNoise as JaxSlotNoise
from mbt_gym_tpu.utils.config import cj_env_config as jax_cj_env_config
from mbt_gym_tpu.utils.config import oe_env_config as jax_oe_env_config

from mbt_gym_torch import convert, rollout
from mbt_gym_torch.agents.baseline import CarteaJaimungalMmAgent, CarteaJaimungalOeAgent
from mbt_gym_torch.ops.compat import reference_noise_cube
from mbt_gym_torch.rewards import CjCriterion, RunningInventoryPenalty
from mbt_gym_torch.types import SlotNoise
from mbt_gym_torch.utils.config import cj_env_config, oe_env_config
from tests.reference_oracle import oracle_limit_order_rollout
from tests.test_torch_env import channels_noise, jax_spec, random_channels, torch_config


def _cj_pair(jcfg, max_inventory=None):
    jagent = JaxCjAgent.from_config(jcfg, max_inventory=max_inventory)
    agent = convert.cj_mm_agent_from_spec(jax_spec(jagent))
    assert agent == CarteaJaimungalMmAgent.from_config(torch_config(jcfg), max_inventory=max_inventory)
    return jagent, agent


def test_configs_and_agents_convert_from_jax():
    """The CJ and OE factories build the configs their JAX counterparts
    build, and the agents come across field for field."""
    for jcfg, cfg in (
        (jax_cj_env_config(num_trajectories=256), cj_env_config(num_trajectories=256)),
        (jax_oe_env_config(num_trajectories=256), oe_env_config(num_trajectories=256)),
    ):
        assert torch_config(jcfg) == cfg
        for got, want in zip(cfg.observation_bounds(), jcfg.observation_bounds()):
            np.testing.assert_array_equal(got, want)
        for got, want in zip(cfg.action_bounds(), jcfg.action_bounds()):
            np.testing.assert_array_equal(got, want)
        assert (cfg.state_dim, cfg.action_dim) == (jcfg.state_dim, jcfg.action_dim)
    assert oe_env_config().state_dim == 5 and oe_env_config().dynamics.round_initial_inventory is False
    jagent = JaxOeAgent.from_config(jax_oe_env_config(), alpha=0.01)
    assert convert.cj_oe_agent_from_spec(jax_spec(jagent)) == CarteaJaimungalOeAgent.from_config(
        oe_env_config(), alpha=0.01
    )
    assert CjCriterion is RunningInventoryPenalty
    with pytest.raises(ValueError, match="not a CarteaJaimungalMmAgent spec"):
        convert.cj_mm_agent_from_spec(jax_spec(jagent))


@pytest.mark.parametrize(
    "case", ["cjp-published", "small-grid", "inventory-neutral"],
)
def test_tables_bit_for_bit(case):
    """h_table and depth_table are numpy in both packages: the same floats
    (tests/test_pallas_rollout.py:1789 for the inventory-neutral agent)."""
    if case == "cjp-published":
        jcfg = jax_cj_env_config(num_trajectories=128, max_inventory=100.0)
        jagent, agent = _cj_pair(jcfg, max_inventory=100)
    elif case == "small-grid":
        jagent, agent = _cj_pair(jax_cj_env_config(num_trajectories=128, n_steps=50, max_inventory=3.0))
    else:
        jcfg = dataclasses.replace(jax_cj_env_config(num_trajectories=128, n_steps=50), reward_function=JaxPnL())
        jagent, agent = _cj_pair(jcfg, max_inventory=5)
        assert agent.inventory_neutral
    np.testing.assert_array_equal(agent.h_table(), jagent.h_table())
    np.testing.assert_array_equal(agent.depth_table(), jagent.depth_table())


def test_depth_table_is_built_once_per_agent(monkeypatch):
    """The engine policy, K5's tables and K8's value-function lane read one
    float32 depth table per agent value: one eigendecomposition, however
    many calls and however many equal agents."""
    from mbt_gym_torch.agents import baseline
    from mbt_gym_torch.ops import cj_episode as cj
    from mbt_gym_torch.ops import det_rollout as det

    cfg = cj_env_config(num_trajectories=128, n_steps=20, max_inventory=3.0)
    builds = []
    original = CarteaJaimungalMmAgent.depth_table
    monkeypatch.setattr(CarteaJaimungalMmAgent, "depth_table", lambda self: (builds.append(self), original(self))[1])
    baseline._cj_depth_table_f32.cache_clear()
    agent = CarteaJaimungalMmAgent.from_config(cfg)
    table = agent.depth_table_f32()
    np.testing.assert_array_equal(table, original(agent).astype(np.float32))
    assert table.dtype == np.float32 and not table.flags.writeable
    for _ in range(2):
        again = CarteaJaimungalMmAgent.from_config(cfg)
        again.policy()
        bid, ask = det.cj_depth_tables(again)
        cj.cj_episode_rewards(cfg, again, 0, 128, device="cpu")
    assert len(builds) == 1
    np.testing.assert_array_equal(bid, table[..., 0])
    np.testing.assert_array_equal(ask, table[..., 1])
    assert bid.flags.writeable  # a copy: the caller may change it, the shared table stays
    bid[:] = 0.0
    assert (agent.depth_table_f32()[..., 0] == table[..., 0]).all() and table[..., 0].any()


def test_mm_policy_matches_jax_policy():
    """The gather from the float32 depth table gives the one-hot product's
    single term: equal quotes, on the rollout path (shared clock from the
    state) and standalone (each row's own time), including clipped
    inventories past the grid."""
    jcfg = jax_cj_env_config(num_trajectories=256, n_steps=100, max_inventory=4.0)
    jagent, agent = _cj_pair(jcfg, max_inventory=3)
    rng = np.random.default_rng(2)
    obs = np.zeros((256, 4), np.float32)
    obs[:, 1] = rng.integers(-6, 7, size=256)
    obs[:, 2] = rng.integers(0, 101, size=256) * np.float32(0.01)
    obs[:, 3] = 100.0
    jstate, _ = jax_reset(jcfg, jax.random.PRNGKey(0))
    jstate = jstate._replace(time=jnp.full((256,), np.float32(0.37)))
    state = convert.env_state_from_numpy(
        cash=np.zeros(256), inventory=obs[:, 1], time=np.full(256, np.float32(0.37)),
        process_states=[np.full((256, 1), 100.0)], device="cpu",
    )
    for s_j, s_t in ((jstate, state), (None, None)):
        want = np.asarray(jagent.policy()(None, jnp.asarray(obs), s_j))
        got = agent.policy()(None, torch.from_numpy(obs), s_t).numpy()
        np.testing.assert_array_equal(got, want)
    want = np.asarray(jagent.true_value_function(jnp.asarray(obs)))
    np.testing.assert_array_equal(agent.true_value_function(torch.from_numpy(obs)).numpy(), want)


def test_oe_policy_matches_jax_policy():
    jagent = JaxOeAgent.from_config(jax_oe_env_config(initial_inventory=20), alpha=0.01)
    agent = CarteaJaimungalOeAgent(**dataclasses.asdict(jagent))
    obs = np.zeros((64, 5), np.float32)
    obs[:, 2] = np.arange(64, dtype=np.float32) / 64
    want = np.asarray(jagent.policy()(None, jnp.asarray(obs), None))
    got = agent.policy()(None, torch.from_numpy(obs), None).numpy()
    assert got.shape == want.shape == (64, 1)
    # the same float32 expression; XLA's CPU backend may contract a multiply-add
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("n_steps", [1000, 2000])
def test_time_index_of_the_shared_clock_is_the_step(n_steps):
    """The engine policy indexes the table by round(time/dt) of the clock
    the env accumulates in float32 (time + dt per step); the kernels index
    by the integer step.  Both pick the same row at every step of the CJP
    horizons, in both packages."""
    dt = 1.0 / n_steps
    t = torch.zeros((), dtype=torch.float32)
    tj = jnp.zeros((), jnp.float32)
    rows, rows_j = [], []
    for _ in range(n_steps + 1):
        rows.append(int(torch.round(t / dt)))
        rows_j.append(int(jnp.round(tj / dt)))
        t, tj = t + dt, tj + dt
    assert rows == rows_j == list(range(n_steps + 1))


@pytest.mark.parametrize("reward", ["cjmm", "running"])
def test_cj_engine_matches_jax_engine_float32(reward):
    """The CJ policy and the CjMm / running-penalty rewards step by step
    against the JAX engine on the same noise (the float32 tolerances of
    tests/test_pallas_episode.py:201-204: inventory exact)."""
    jcfg = jax_cj_env_config(num_trajectories=256, n_steps=60, max_inventory=4.0)
    if reward == "running":
        jcfg = dataclasses.replace(jcfg, reward_function=JaxRunning(0.01, 0.001))
    jagent, agent = _cj_pair(jcfg, max_inventory=6)
    channels = random_channels(5, 60, 256)
    jres = jax_rollout(jcfg, jagent.policy(), None, jax.random.PRNGKey(0), noise=channels_noise(channels, JaxSlotNoise))
    res = rollout(torch_config(jcfg), agent.policy(), None, 0, noise=channels_noise(channels, SlotNoise), device="cpu")
    got, want = res.trajectory.observations.numpy(), np.asarray(jres.trajectory.observations)
    np.testing.assert_array_equal(got[..., 1], want[..., 1])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-3)
    np.testing.assert_array_equal(res.trajectory.actions.numpy(), np.asarray(jres.trajectory.actions))
    np.testing.assert_allclose(res.trajectory.rewards.numpy(), np.asarray(jres.trajectory.rewards), rtol=0, atol=1e-3)


def test_cj_float64_engine_matches_oracle():
    """tests/test_seed_exactness.py:56 for the port: the CjMm reward in
    float64 on the reference's noise streams, against the numpy oracle."""
    cfg = cj_env_config(num_trajectories=64, n_steps=50, max_inventory=10.0, dtype="float64")
    noise = reference_noise_cube(cfg, 50, dtype="float64")

    def policy(params, obs, state):
        return torch.full((obs.shape[0], 2), 0.6, dtype=obs.dtype)

    res = rollout(cfg, policy, None, 0, noise=noise, device="cpu")
    oracle = oracle_limit_order_rollout(
        lambda obs: np.full((obs.shape[0], 2), 0.6), 50, num_trajectories=64, n_steps=50,
        terminal_time=1.0, max_inventory=10.0, reward="cjmm", phi=0.01, alpha=0.001,
    )
    np.testing.assert_allclose(res.trajectory.rewards.numpy(), oracle["rewards"], atol=1e-9)
    np.testing.assert_array_equal(res.trajectory.observations[:, :, 1].numpy(), oracle["observations"][:, :, 1])


def test_cjp_value_function_ttest():
    """tests/test_replication.py:52-80, first parameter set (notebook cells
    3-13): the engine's mean CjMm episode reward over 2,000 paths of 1,000
    steps against the analytic value h(0, 0), inside the 99.9% t band."""
    n = 2000
    cfg = cj_env_config(num_trajectories=n, max_inventory=100.0)
    agent = CarteaJaimungalMmAgent.from_config(cfg, max_inventory=100)
    res = rollout(cfg, agent.policy(), None, 410, device="cpu")
    total = res.trajectory.rewards.sum(0).double().numpy()
    true_mean = float(agent.true_value_function(res.trajectory.observations[0][:1])[0])
    t_stat = (total.mean() - true_mean) / np.sqrt(total.var() * n / (n - 1) / n)
    q_l, q_u = scipy.stats.t(df=n - 1).ppf((0.0005, 0.9995))
    assert q_l < t_stat < q_u, (total.mean(), true_mean, t_stat)
