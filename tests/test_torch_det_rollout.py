"""mbt_gym_torch.ops.det_rollout (K5) against the JAX package's
deterministic-policy Pallas kernels, run as the JAX package's own tests run
them on the CPU (interpret mode, injected noise), and the dispatch front
door's decisions for the CJ, fixed-action and CJ-OE policies.

On the CPU the wrappers take their plain PyTorch versions (the tensors lie
on the CPU); the CUDA kernel itself is held against the plain version on
the card (tests/test_torch_cuda.py and chip_smoke.py).
"""
import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mbt_gym_tpu import dispatch as jax_dispatch
from mbt_gym_tpu.agents.baseline import CarteaJaimungalMmAgent as JaxCjAgent
from mbt_gym_tpu.agents.baseline import CarteaJaimungalOeAgent as JaxOeAgent
from mbt_gym_tpu.agents.baseline import fixed_action_policy as jax_fixed_action_policy
from mbt_gym_tpu.ops import pallas_rollout as pr
from mbt_gym_tpu.rewards import PnL as JaxPnL
from mbt_gym_tpu.rewards import RunningInventoryPenalty as JaxRunning
from mbt_gym_tpu.utils.config import as_env_config as jax_as_env_config
from mbt_gym_tpu.utils.config import cj_env_config as jax_cj_env_config
from mbt_gym_tpu.utils.config import oe_env_config as jax_oe_env_config

from mbt_gym_torch import dispatch, mc_episode_stats, rollout
from mbt_gym_torch.agents.baseline import (
    AvellanedaStoikovAgent,
    CarteaJaimungalMmAgent,
    CarteaJaimungalOeAgent,
    fixed_action_policy,
)
from mbt_gym_torch.ops import det_rollout as det
from mbt_gym_torch.utils.config import cj_env_config, oe_env_config
from tests.test_torch_env import jax_spec, random_channels, torch_config

N, T = 128, 12


def torch_cj_agent(jax_agent):
    from mbt_gym_torch import convert

    return convert.cj_mm_agent_from_spec(jax_spec(jax_agent))


def _as_numpy(outs):
    return [np.asarray(o) for o in outs]


def _inventory_plane(obs, p):
    """The inventory plane in raw units, as integers.  A normalised plane
    can be one ulp apart: XLA's CPU backend divides by a constant through
    its reciprocal, the port divides."""
    inv = obs[:, 1]
    if p.normalise_obs:
        inv = (inv + 1.0) * p.obs_grad[1] + p.obs_low[1]
    return np.rint(inv).astype(np.int64)


def _assert_streams_match_jax(got, want, p, obs_atol, rew_atol):
    """The tolerances of the JAX test each case mirrors: obs rtol=1e-5,
    actions rtol=1e-6, rewards rtol=1e-4 (float32 accumulation order);
    inventory exact; deterministic log-prob and value streams are zeros."""
    got = [g.numpy() for g in got]
    want = _as_numpy(want)
    np.testing.assert_array_equal(_inventory_plane(got[0], p), _inventory_plane(want[0], p))
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=obs_atol)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=1e-6)
    assert not got[2].any() and not got[3].any()
    np.testing.assert_allclose(got[4], want[4], rtol=1e-4, atol=rew_atol)
    for g, w in zip(got[5:], want[5:]):  # the terminal observation
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=obs_atol)


def _assert_stats_match_jax(got, want):
    got = [g.numpy() for g in got]
    want = _as_numpy(want)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-3)  # cash
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6, atol=1e-4)  # price
    np.testing.assert_allclose(got[3], want[3], rtol=1e-5, atol=1e-3)  # reward sums
    np.testing.assert_allclose(got[4], want[4], rtol=1e-5, atol=1e-4)  # spread sums


# ------------------------------------------------------------ params
def test_params_match_jax_params():
    """The port's params carry the JAX fields of the ported kinds with the
    same values."""
    jcfg = jax_cj_env_config(num_trajectories=N, n_steps=T, max_inventory=3.0)
    jagent = JaxCjAgent.from_config(jcfg)
    want = pr.cj_rollout_params(jcfg, jagent)
    got = det.cj_rollout_params(torch_config(jcfg), torch_cj_agent(jagent))
    for name, value in got._asdict().items():
        assert getattr(want, name) == value, name
    assert got.run_steps == want.run_steps and got.a_dim == 2
    ocfg = jax_oe_env_config(num_trajectories=N, n_steps=T)
    want = pr.schedule_rollout_params(ocfg)
    got = det.schedule_rollout_params(torch_config(ocfg))
    for name, value in got._asdict().items():
        assert getattr(want, name) == value, name
    assert len(got.obs_low) == 5 and got.a_dim == 1


# ------------------------------------------------------------ K5 vs JAX
@pytest.mark.parametrize(
    "reward", ["cjmm", "pnl-inventory-neutral", "running"],
)
def test_table_plain_matches_interpret_pallas(reward):
    """The table kind against table_rollout_pallas(interpret=True) on the
    same noise, streams with the terminal observation and stats mode, on a
    grid small enough that the large-depth boundary rows are hit
    (tests/test_pallas_rollout.py:1485,1789 tolerances)."""
    jcfg = jax_cj_env_config(num_trajectories=N, n_steps=T, max_inventory=3.0)
    if reward == "pnl-inventory-neutral":
        jcfg = dataclasses.replace(jcfg, reward_function=JaxPnL())
    elif reward == "running":
        jcfg = dataclasses.replace(jcfg, reward_function=JaxRunning(0.01, 0.001))
    jagent = JaxCjAgent.from_config(jcfg)
    jp = pr.cj_rollout_params(jcfg, jagent)
    jtables = pr.cj_depth_tables(jagent)
    agent = torch_cj_agent(jagent)
    p = det.cj_rollout_params(torch_config(jcfg), agent)
    tables = det.cj_depth_tables(agent)
    for a, b in zip(tables, jtables):
        # the JAX tables pad the inventory grid to the TPU's 128 lanes
        assert a.shape == (T + 1, 7) and a.dtype == np.float32
        np.testing.assert_array_equal(a, b[:, :7])
    channels = random_channels(7, T, N)
    want = pr.table_rollout_pallas(jp, *jtables, 0, N, tile=128, interpret=True,
                                   noise=jnp.asarray(channels), final_obs=True)
    got = det.table_rollout(p, *tables, 0, N, noise=torch.from_numpy(channels), final_obs=True)
    if reward == "cjmm":
        assert np.abs(got[0][:, 1].numpy()).max() == 3.0  # the boundary binds
    _assert_streams_match_jax(got, want, p, obs_atol=1e-5, rew_atol=1e-4)
    want = pr.table_rollout_pallas(jp, *jtables, 0, N, tile=128, interpret=True,
                                   noise=jnp.asarray(channels), stats_only=True)
    got = det.table_rollout(p, *tables, 0, N, noise=torch.from_numpy(channels), stats_only=True)
    _assert_stats_match_jax(got, want)


def test_table_plain_random_initial_inventory_matches_interpret_pallas():
    """The inv0 plane: the per-env lookup and the CjMm reward's per-env q0^2
    constant both see it (tests/test_pallas_rollout.py:1561)."""
    jcfg = dataclasses.replace(
        jax_cj_env_config(num_trajectories=N, n_steps=8, max_inventory=3.0), initial_inventory=(-2, 3)
    )
    jagent = JaxCjAgent.from_config(jcfg)
    jp = pr.cj_rollout_params(jcfg, jagent)
    p = det.cj_rollout_params(torch_config(jcfg), torch_cj_agent(jagent))
    assert p.inventory_range == (-2, 3)
    channels = random_channels(11, 8, N)
    q0 = np.random.default_rng(11).integers(-2, 3, size=N).astype(np.float32)
    want = pr.table_rollout_pallas(jp, *pr.cj_depth_tables(jagent), 0, N, tile=128, interpret=True,
                                   noise=jnp.asarray(channels), inv0=jnp.asarray(q0))
    got = det.table_rollout(p, *det.cj_depth_tables(torch_cj_agent(jagent)), 0, N,
                            noise=torch.from_numpy(channels), inv0=torch.from_numpy(q0))
    _assert_streams_match_jax(got, want, p, obs_atol=1e-5, rew_atol=1e-4)


@pytest.mark.parametrize("case", ["table-cjmm", "table-running", "fixed-cjoe", "fixed-cjoe-e1.5"])
def test_other_exponents_plain_matches_interpret_pallas(case):
    """Inventory exponents other than 2 (pallas_rollout.py:1140-1171):
    the CjMm and running rewards on the table kind at exponent 3, the CJ
    execution criterion on the fixed kind at 3 and at 1.5 (q(inv, e - 1)
    through powf; inventories stay positive there), against the JAX
    interpret kernel in streams (with the terminal observation) and stats
    mode, at the tolerances of the exponent-2 cases.  The CJ agent's tables
    come from the exponent-2 config (its closed form assumes 2)."""
    from mbt_gym_tpu.rewards import CjMmCriterion as JaxCjMm
    from mbt_gym_tpu.rewards import CjOeCriterion as JaxCjOe

    kind, reward = case.split("-")[:2]
    e = 1.5 if case.endswith("e1.5") else 3.0
    if kind == "table":
        jcfg2 = jax_cj_env_config(num_trajectories=N, n_steps=T, max_inventory=3.0)
        jagent = JaxCjAgent.from_config(jcfg2)
        r = (JaxCjMm(0.01, 0.001, inventory_exponent=e) if reward == "cjmm"
             else JaxRunning(0.01, 0.001, inventory_exponent=e))
        jcfg = dataclasses.replace(jcfg2, reward_function=r, initial_inventory=2)
        jp = pr.cj_rollout_params(jcfg, jagent)
        jtables = pr.cj_depth_tables(jagent)
        agent = torch_cj_agent(jagent)
        p = det.cj_rollout_params(torch_config(jcfg), agent)
        tables = det.cj_depth_tables(agent)
        channels = random_channels(17, T, N)

        def run_jax(**kw):
            return pr.table_rollout_pallas(jp, *jtables, 0, N, tile=128, interpret=True,
                                           noise=jnp.asarray(channels), **kw)

        def run_port(**kw):
            return det.table_rollout(p, *tables, 0, N, noise=torch.from_numpy(channels), **kw)
        obs_atol, rew_atol = 1e-5, 1e-4
    else:
        ocfg = dataclasses.replace(jax_oe_env_config(num_trajectories=N), n_steps=6)
        jcfg = dataclasses.replace(ocfg, reward_function=JaxCjOe(
            ocfg.reward_function.per_step_inventory_aversion, ocfg.reward_function.terminal_inventory_aversion,
            inventory_exponent=e))
        jp = pr.fixed_rollout_params(jcfg, [-2.5])
        p = det.fixed_rollout_params(torch_config(jcfg), [-2.5])
        channels = random_channels(32, 6, N)

        def run_jax(**kw):
            return pr.fixed_rollout_pallas(jp, 0, N, tile=128, interpret=True, noise=jnp.asarray(channels), **kw)

        def run_port(**kw):
            return det.fixed_rollout(p, 0, N, noise=torch.from_numpy(channels), **kw)
        obs_atol, rew_atol = 1e-4, 1e-4
    assert p.inventory_exponent == jp.inventory_exponent == e
    got = run_port(final_obs=True)
    _assert_streams_match_jax(got, run_jax(final_obs=True), p, obs_atol=obs_atol, rew_atol=rew_atol)
    assert bool(torch.isfinite(got[4]).all())
    _assert_stats_match_jax(run_port(stats_only=True), run_jax(stats_only=True))


@pytest.mark.parametrize("config", ["as-limit", "as-normalised", "oe-speed"])
def test_fixed_plain_matches_interpret_pallas(config):
    """The fixed kind against fixed_rollout_pallas(interpret=True): limit
    dynamics on the AS config (raw and normalised spaces) and speed
    dynamics on the OE config (tests/test_pallas_rollout.py:1970)."""
    steps = 6 if config == "oe-speed" else T  # the horizon of the JAX test mirrored
    if config == "oe-speed":
        jcfg = dataclasses.replace(jax_oe_env_config(num_trajectories=N), n_steps=steps)
        action = [-2.5]
    else:
        jcfg = jax_as_env_config(num_trajectories=N, n_steps=steps)
        action = [0.6, 0.9]
        if config == "as-normalised":
            jcfg = dataclasses.replace(jcfg, normalise_action_space=True, normalise_observation_space=True)
            action = [-0.6, -0.4]
    jp = pr.fixed_rollout_params(jcfg, action)
    p = det.fixed_rollout_params(torch_config(jcfg), action)
    channels = random_channels(32, steps, N)
    want = pr.fixed_rollout_pallas(jp, 0, N, tile=128, interpret=True, noise=jnp.asarray(channels),
                                   final_obs=True)
    got = det.fixed_rollout(p, 0, N, noise=torch.from_numpy(channels), final_obs=True)
    _assert_streams_match_jax(got, want, p, obs_atol=1e-4, rew_atol=1e-4)
    want = pr.fixed_rollout_pallas(jp, 0, N, tile=128, interpret=True, noise=jnp.asarray(channels),
                                   stats_only=True)
    got = det.fixed_rollout(p, 0, N, noise=torch.from_numpy(channels), stats_only=True)
    _assert_stats_match_jax(got, want)
    if config == "oe-speed":
        assert not got[4].any()  # 1-column actions: no quoted spread


def test_schedule_plain_matches_interpret_pallas():
    """The schedule kind with the CJ-OE speed schedule, late start included
    (rows from the absolute step, tests/test_pallas_rollout.py:2114)."""
    jcfg = dataclasses.replace(
        jax_oe_env_config(num_trajectories=N, initial_inventory=20.0), n_steps=T, start_time=0.25,
    )
    jagent = JaxOeAgent.from_config(jcfg, alpha=0.01)
    jp = pr.schedule_rollout_params(jcfg)
    jtable = pr.schedule_table_from_policy(jcfg, jagent.policy())
    cfg = torch_config(jcfg)
    agent = CarteaJaimungalOeAgent.from_config(cfg, alpha=0.01)
    p = det.schedule_rollout_params(cfg)
    table = det.schedule_table_from_policy(cfg, agent.policy())
    assert table.shape == (T, 1) and p.run_steps == T - 3
    np.testing.assert_allclose(table.numpy(), np.asarray(jtable), rtol=1e-6, atol=0)
    channels = random_channels(41, p.run_steps, N)
    want = pr.schedule_rollout_pallas(jp, jtable, 0, N, tile=128, interpret=True,
                                      noise=jnp.asarray(channels), final_obs=True)
    got = det.schedule_rollout(p, np.array(jtable), 0, N, noise=torch.from_numpy(channels), final_obs=True)
    _assert_streams_match_jax(got, want, p, obs_atol=1e-4, rew_atol=1e-3)
    want = pr.schedule_rollout_pallas(jp, jtable, 0, N, tile=128, interpret=True,
                                      noise=jnp.asarray(channels), stats_only=True)
    got = det.schedule_rollout(p, np.array(jtable), 0, N, noise=torch.from_numpy(channels), stats_only=True)
    _assert_stats_match_jax(got, want)


def test_stats_mode_equals_stream_reductions():
    """Stats mode's terminal state and sums are the streams' last row and
    sums on the same native (Philox) noise."""
    cfg = cj_env_config(num_trajectories=256, n_steps=30, max_inventory=4.0)
    agent = CarteaJaimungalMmAgent.from_config(cfg)
    p = det.cj_rollout_params(cfg, agent)
    tables = det.cj_depth_tables(agent)
    obs, act, _, _, rew, fin = det.table_rollout(p, *tables, 5, 256, final_obs=True, device="cpu")
    cash, inv, price, rsum, ssum = det.table_rollout(p, *tables, 5, 256, stats_only=True, device="cpu")
    torch.testing.assert_close(torch.stack([cash, inv, price]), fin[[0, 1, 3]], rtol=0, atol=0)
    torch.testing.assert_close(rsum, rew.sum(0), rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(ssum, act.sum(1).sum(0), rtol=1e-5, atol=1e-3)
    assert float(fin[2, 0]) == pytest.approx(1.0)


def test_config_guards():
    """The table and fixed kinds refuse what they do not model
    (tests/test_pallas_rollout.py:1612,2006), and the config features the
    port lacks raise with a reason naming them."""
    cfg = cj_env_config(num_trajectories=N, n_steps=4, max_inventory=3.0)
    agent = CarteaJaimungalMmAgent.from_config(cfg)
    p = det.cj_rollout_params(cfg, agent)
    bid, ask = det.cj_depth_tables(agent)
    with pytest.raises(AssertionError):  # not a table params struct
        det.table_rollout(p._replace(policy_kind="mlp"), bid, ask, 0, N, device="cpu")
    with pytest.raises(AssertionError, match="limit-order dynamics only"):
        det.table_rollout(p._replace(dynamics_kind="speed"), bid, ask, 0, N, device="cpu")
    with pytest.raises(AssertionError, match="cover every executed step"):
        det.table_rollout(p, bid[:3], ask[:3], 0, N, device="cpu")
    with pytest.raises(ValueError, match="noise must be float32"):
        det.table_rollout(p, bid, ask, 0, N, noise=torch.zeros((4, 7, N)))
    oe = oe_env_config(num_trajectories=N, n_steps=4)
    with pytest.raises(AssertionError, match="speed dynamics takes 1"):
        det.fixed_rollout(det.fixed_rollout_params(oe, [0.6, 0.6]), 0, N, device="cpu")
    # random starts are carried in the params, as JAX carries them, and the
    # kernel wrappers refuse them (pallas_rollout.py:1713, :1773, :1824)
    late = det.fixed_rollout_params(dataclasses.replace(oe, start_time=("uniform", 0.0, 0.5)), [1.0])
    assert late.random_start and late.start_time == 0.0 and late.run_steps == oe.n_steps
    with pytest.raises(AssertionError, match="random start times"):
        det.fixed_rollout(late, 0, N, device="cpu")
    for change, match in (
        ({"dtype": "float64"}, "float64"),
        ({"reward_scaling": 2.0}, "reward_scaling"),
    ):
        with pytest.raises(AssertionError, match=match):
            det.fixed_rollout_params(dataclasses.replace(oe, **change), [1.0])
    # any inventory exponent now runs on K5 (pallas_rollout.py:1140); K8
    # stays at exponent 2, as the JAX K8 asserts (pallas_episode.py:324)
    from mbt_gym_torch.ops import cj_episode
    from mbt_gym_torch.rewards import CjMmCriterion, CjOeCriterion

    cj3 = dataclasses.replace(cfg, reward_function=CjMmCriterion(0.01, 0.001, inventory_exponent=3.0))
    assert det.cj_rollout_params(cj3, agent).inventory_exponent == 3.0
    assert det.fixed_rollout_params(
        dataclasses.replace(oe, reward_function=CjOeCriterion(0.01, 0.1, inventory_exponent=3.0)), [1.0]
    ).inventory_exponent == 3.0
    cj_episode.cj_params_from_config(cfg)
    with pytest.raises(AssertionError, match="inventory exponent 2 only"):
        cj_episode.cj_params_from_config(cj3)


def test_streams_feasible_is_the_device_memory_rule():
    """The H100 streams to device memory: the 2000-step CJP rollout, which
    exceeds the TPU's VMEM (tests/test_dispatch.py:247), fits; a rollout
    whose buffers exceed the free memory does not."""
    cfg = cj_env_config(num_trajectories=16384, n_steps=2000)
    p = det.cj_rollout_params(cfg, CarteaJaimungalMmAgent.from_config(cfg, max_inventory=100))
    assert det.det_streams_feasible(p, 16384, free_bytes=det.H100_MEMORY_BYTES)
    # (T, 4 + 2 + 3, N) + (T + 1, N, 4) + (4, N) floats at 16,384 envs
    need = 4 * (2000 * 9 * 16384 + 2001 * 16384 * 4 + 4 * 16384)
    assert det.det_streams_feasible(p, 16384, free_bytes=need)
    assert not det.det_streams_feasible(p, 16384, free_bytes=need - 1)


def test_streams_feasible_reads_the_target_card_with_its_cache(monkeypatch):
    """The free memory is the target card's, and blocks PyTorch's caching
    allocator holds reserved but unused count as free: a warm cache (the
    card reports them taken) does not flip a decision a cold one makes."""
    cfg = cj_env_config(num_trajectories=16384, n_steps=2000)
    p = det.cj_rollout_params(cfg, CarteaJaimungalMmAgent.from_config(cfg, max_inventory=100))
    need = 4 * (2000 * 9 * 16384 + 2001 * 16384 * 4 + 4 * 16384)
    cached = 3 * need  # freed tensors the allocator keeps reserved
    asked = []

    def card(free, reserved, allocated):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d=None: (asked.append(d), (free, 80 * 10**9))[1])
        monkeypatch.setattr(torch.cuda, "memory_reserved", lambda d=None: (asked.append(d), reserved)[1])
        monkeypatch.setattr(torch.cuda, "memory_allocated", lambda d=None: (asked.append(d), allocated)[1])

    card(free=need, reserved=0, allocated=0)  # cold
    assert det.det_streams_feasible(p, 16384, device="cuda:1")
    assert asked and all(d == torch.device("cuda:1") for d in asked)
    card(free=need - cached + 10**7, reserved=cached + 10**6, allocated=10**6)  # warm
    assert det.device_free_bytes("cuda:1") == need + 10**7  # room for the 3.2 MB tables too
    assert det.det_streams_feasible(p, 16384, device="cuda:1")
    got = dispatch.dispatch_report(cfg, CarteaJaimungalMmAgent.from_config(cfg, max_inventory=100).policy(),
                                   platform="cuda:1")
    assert (got.backend, got.family) == ("fused", "cj_table")
    card(free=need - cached, reserved=cached, allocated=1)  # one byte short
    assert not det.det_streams_feasible(p, 16384, device="cuda:1")
    got = dispatch.dispatch_report(cfg, CarteaJaimungalMmAgent.from_config(cfg, max_inventory=100).policy(),
                                   platform="cuda:1")
    assert got.backend == "engine" and "exceed free device memory" in got.reason
    # a CPU target never asks a card
    asked.clear()
    assert det.device_free_bytes("cpu") == det.H100_MEMORY_BYTES and not asked


# ------------------------------------------------------------ dispatch
def _cj(n=256):
    jcfg = jax_cj_env_config(num_trajectories=n, max_inventory=10.0)
    return jcfg, JaxCjAgent.from_config(jcfg)


def _oe(n=256):
    jcfg = jax_oe_env_config(num_trajectories=n)
    return jcfg, JaxOeAgent.from_config(jcfg, alpha=0.01)


def _port_policy(jcfg, kind, jagent=None, action=None):
    cfg = torch_config(jcfg)
    if kind == "cj":
        return cfg, torch_cj_agent(jagent).policy()
    if kind == "oe":
        return cfg, CarteaJaimungalOeAgent(**dataclasses.asdict(jagent)).policy()
    return cfg, fixed_action_policy(action)


@pytest.mark.parametrize("family", ["cj_table", "fixed-as", "fixed-oe", "oe_episode", "fixed-as-e3", "fixed-oe-e3"])
def test_eligible_families_route_fused(family):
    """tests/test_dispatch.py:50-73 for a CUDA target: each family in both
    modes (OE rollouts go to K5's schedule kind, its stats to K6); a fixed
    action with the running penalty or the CJ execution criterion at
    exponent 3 takes K5 in both packages."""
    if family == "cj_table":
        jcfg, jagent = _cj()
        jpol, (cfg, pol) = jagent.policy(), _port_policy(jcfg, "cj", jagent)
    elif family == "oe_episode":
        jcfg, jagent = _oe()
        jpol, (cfg, pol) = jagent.policy(), _port_policy(jcfg, "oe", jagent)
    else:
        on_as = family.startswith("fixed-as")
        jcfg = jax_as_env_config(num_trajectories=256) if on_as else _oe()[0]
        action = [0.7, 0.7] if on_as else [-2.5]
        if family.endswith("e3"):
            from mbt_gym_tpu.rewards import CjOeCriterion as JaxCjOe

            r = JaxRunning(0.01, 0.001, inventory_exponent=3.0) if on_as else JaxCjOe(0.01, 0.1, inventory_exponent=3.0)
            jcfg = dataclasses.replace(jcfg, reward_function=r)
        jpol, (cfg, pol) = jax_fixed_action_policy(action), _port_policy(jcfg, "fixed", action=action)
    name = family.split("-")[0]
    for mode in ("rollout", "stats"):
        want = jax_dispatch.dispatch_report(jcfg, jpol, mode=mode, platform="tpu")
        got = dispatch.dispatch_report(cfg, pol, mode=mode, platform="cuda")
        assert (want.backend, want.family) == ("fused", name)
        assert got == dispatch.DispatchDecision("fused", name, f"config and policy match the {name} kernel contract")
        cpu = dispatch.dispatch_report(cfg, pol, mode=mode, platform="cpu")
        assert cpu.backend == "engine" and cpu.reason.endswith("requires a CUDA device (running on cpu)")


def _guard_case(name):
    """(JAX config, JAX policy, port config, port policy) for one guard."""
    jcfg, jagent = _cj()
    if name == "cj-mismatched-agent":
        jagent = dataclasses.replace(jagent, kappa=2.0)
    elif name == "cj-mismatched-agent-random-start":
        jcfg = dataclasses.replace(jcfg, start_time=("uniform", 0.0, 0.5))
        jagent = dataclasses.replace(jagent, kappa=2.0)
    elif name == "cj-normalised-actions":
        jcfg = dataclasses.replace(jcfg, normalise_action_space=True)
    elif name == "cj-random-start":
        jcfg = dataclasses.replace(jcfg, start_time=("uniform", 0.0, 0.5))
    elif name == "cj-random-inventory":
        jcfg = dataclasses.replace(jcfg, initial_inventory=(-2, 3))
    elif name == "cj-n-not-128":
        jcfg = jax_cj_env_config(num_trajectories=1000, max_inventory=10.0)
        jagent = JaxCjAgent.from_config(jcfg)
    elif name == "cj-float64":
        jcfg = dataclasses.replace(jcfg, dtype="float64")
    elif name == "cj-exponent-3":
        from mbt_gym_tpu.rewards import CjMmCriterion as JaxCjMm

        jcfg = dataclasses.replace(jcfg, reward_function=JaxCjMm(0.01, 0.001, inventory_exponent=3.0))
    elif name.startswith("oe"):
        jcfg, jagent = _oe()
        if name == "oe-mismatched-agent":
            jagent = dataclasses.replace(jagent, temporary_impact=0.5)
        elif name == "oe-reward-scaling":
            jcfg = dataclasses.replace(jcfg, reward_scaling=2.0)
        return (jcfg, jagent.policy(), *_port_policy(jcfg, "oe", jagent))
    elif name.startswith("fixed"):
        action = [0.6] if name.startswith("fixed-wrong-columns") else [0.6, 0.6]
        jcfg = jax_as_env_config(num_trajectories=256)
        if name == "fixed-random-inventory":
            jcfg = dataclasses.replace(jcfg, initial_inventory=(-2, 3))
        elif name.endswith("random-start"):
            jcfg = dataclasses.replace(jcfg, start_time=("uniform", 0.0, 0.5))
        return (jcfg, jax_fixed_action_policy(action), *_port_policy(jcfg, "fixed", action=action))
    return (jcfg, jagent.policy(), *_port_policy(jcfg, "cj", jagent))


@pytest.mark.parametrize(
    "name, modes, words",
    [
        ("cj-mismatched-agent", ("rollout", "stats"), "differ from the env config"),
        ("cj-normalised-actions", ("rollout", "stats"), "disable normalise_action_space"),
        ("cj-random-start", ("rollout", "stats"), "random start times with the table policy run on the"),
        ("cj-mismatched-agent-random-start", ("rollout", "stats"), "differ from the env config"),
        ("fixed-random-start", ("rollout", "stats"), "random start times with the fixed policy run on the"),
        ("fixed-wrong-columns-random-start", ("rollout", "stats"), "fixed action has 1 columns"),
        ("cj-random-inventory", ("stats",), "random initial inventory is unsupported"),
        ("cj-n-not-128", ("rollout", "stats"), "multiple of 128"),
        ("cj-float64", ("rollout", "stats"), "float64"),
        ("cj-exponent-3", ("rollout", "stats"), "Inventory exponent must be 2"),
        ("oe-mismatched-agent", ("rollout", "stats"), "differ from the env config"),
        ("oe-reward-scaling", ("rollout", "stats"), "reward_scaling"),
        ("fixed-wrong-columns", ("rollout", "stats"), "fixed action has 1 columns; limit dynamics takes 2"),
        ("fixed-random-inventory", ("stats",), "random initial inventory is unsupported"),
    ],
)
def test_fallback_reasons_match_jax(name, modes, words):
    """tests/test_dispatch.py:89-173 for the CJ, OE and fixed families: the
    same guards send both front doors to their engine, each reason naming
    the feature, in the same order of checks (a mismatched agent or wrong
    columns with a random start give the agent's or the columns' reason)."""
    jcfg, jpol, cfg, pol = _guard_case(name)
    for mode in modes:
        want = jax_dispatch.dispatch_report(jcfg, jpol, mode=mode, platform="tpu")
        got = dispatch.dispatch_report(cfg, pol, mode=mode, platform="cuda")
        assert (want.backend, got.backend, got.family) == ("xla", "engine", None), (mode, want, got)
        assert words in got.reason and words in want.reason, (mode, want.reason, got.reason)
    if modes == ("stats",):  # random initial inventory stays fused for full trajectories
        got = dispatch.dispatch_report(cfg, pol, mode="rollout", platform="cuda")
        assert (got.backend, got.family) != ("engine", None)


def test_unported_dynamics_reason_names_the_missing_piece():
    """The limit-and-market-order family on K5 as JAX takes it: the
    schedule kind on lam dynamics runs (its (steps, 4) table checked in
    JAX's words), the table kind stays refused in JAX's words, and a fixed
    action under the exponential-utility reward routes to the fixed family
    with JAX's reason."""
    from mbt_gym_tpu.rewards import ExponentialUtility as JaxExponentialUtility
    from mbt_gym_tpu.utils.config import lam_env_config as jax_lam_env_config

    from mbt_gym_torch.utils.config import lam_env_config

    cfg = lam_env_config(num_trajectories=256, n_steps=8)
    p = det.schedule_rollout_params(cfg)
    obs, act, _, _, rew = det.schedule_rollout(p, torch.full((8, 4), 0.6), 0, 256, device="cpu")
    assert tuple(act.shape) == (8, 4, 256) and bool(torch.isfinite(rew).all())
    with pytest.raises(AssertionError, match=r"action_table must be \(steps, 4\) for lam dynamics"):
        det.schedule_rollout(p, torch.zeros((8, 2)), 0, 256, device="cpu")
    with pytest.raises(AssertionError, match="limit-order dynamics only"):
        det.table_rollout(p._replace(policy_kind="table", table_size=3), torch.zeros((9, 3)), torch.zeros((9, 3)),
                          0, 256, device="cpu")
    jutil = dataclasses.replace(jax_lam_env_config(num_trajectories=256, n_steps=8),
                                reward_function=JaxExponentialUtility())
    want = jax_dispatch.dispatch_report(jutil, jax_fixed_action_policy([0.6, 0.6, 0.0, 0.0]), platform="tpu")
    d = dispatch.dispatch_report(torch_config(jutil), fixed_action_policy([0.6, 0.6, 0.0, 0.0]), platform="cuda")
    assert tuple(d) == tuple(want) == ("fused", "fixed", "config and policy match the fixed kernel contract")


def test_long_horizon_cj_rollout_stays_fused():
    """The 2000-step CJP rollout falls back on the TPU for lack of VMEM
    (tests/test_dispatch.py:247); on the H100 the streams go to device
    memory, so it stays fused in both modes."""
    jcfg = jax_cj_env_config(num_trajectories=256, max_inventory=100.0, n_steps=2000)
    jagent = JaxCjAgent.from_config(jcfg, max_inventory=100)
    want = jax_dispatch.dispatch_report(jcfg, jagent.policy(), mode="rollout", platform="tpu")
    assert want.backend == "xla" and "exceed VMEM" in want.reason
    cfg, pol = _port_policy(jcfg, "cj", jagent)
    for mode in ("rollout", "stats"):
        got = dispatch.dispatch_report(cfg, pol, mode=mode, platform="cuda")
        assert (got.backend, got.family) == ("fused", "cj_table")


def test_huge_rollout_falls_back_with_memory_reason():
    cfg = cj_env_config(num_trajectories=1 << 24, n_steps=2000)
    pol = CarteaJaimungalMmAgent.from_config(cfg, max_inventory=100).policy()
    got = dispatch.dispatch_report(cfg, pol, mode="rollout", platform="cuda")
    assert got.backend == "engine" and "exceed free device memory" in got.reason
    assert dispatch.dispatch_report(cfg, pol, mode="stats", platform="cuda").backend == "fused"


# ------------------------------------------------------------ front door
def test_fused_families_through_plain_versions_on_cpu():
    """fused_rollout / fused_mc_episode_stats assemble the engine's contract
    from K5 (and K6 for OE stats); on the CPU they run the plain versions.
    The assembled trajectory agrees with the engine's on the same noise."""
    cfg = cj_env_config(num_trajectories=256, n_steps=40, max_inventory=5.0)
    pol = CarteaJaimungalMmAgent.from_config(cfg).policy()
    decision = dispatch.DispatchDecision("fused", "cj_table", "")
    res = dispatch.fused_rollout(cfg, pol, None, 3, decision, device="cpu")
    traj = res.trajectory
    assert traj.observations.shape == (41, 256, 4) and traj.actions.shape == (40, 256, 2)
    final = res.final_state
    torch.testing.assert_close(final.inventory, traj.observations[-1, :, 1], rtol=0, atol=0)
    assert int(final.step) == 40 and float(final.time[0]) == pytest.approx(1.0)
    stats = dispatch.fused_mc_episode_stats(cfg, pol, None, 4, 2, decision, device="cpu")
    assert stats["episodes"] == 512 and torch.isfinite(stats["mean_pnl"])

    ocfg = oe_env_config(num_trajectories=256, n_steps=40)
    opol = CarteaJaimungalOeAgent.from_config(ocfg, alpha=0.01).policy()
    decision = dispatch.DispatchDecision("fused", "oe_episode", "")
    res = dispatch.fused_rollout(ocfg, opol, None, 3, decision, device="cpu")
    assert res.trajectory.observations.shape == (41, 256, 5) and res.trajectory.actions.shape == (40, 256, 1)
    torch.testing.assert_close(res.final_state.process_states[1][:, 0], res.trajectory.observations[-1, :, 4])
    stats = dispatch.fused_mc_episode_stats(ocfg, opol, None, 4, 2, decision, device="cpu")
    assert torch.isnan(stats["mean_spread"]) and stats["episodes"] == 512

    # random initial inventory: per-env draws reach the kernel's inv0 plane
    acfg = dataclasses.replace(torch_config(jax_as_env_config(num_trajectories=256, n_steps=20)),
                               initial_inventory=(-3, 4))
    fpol = fixed_action_policy([0.8, 0.8])
    decision = dispatch.DispatchDecision("fused", "fixed", "")
    res = dispatch.fused_rollout(acfg, fpol, None, 5, decision, device="cpu")
    q0 = res.trajectory.observations[0, :, 1]
    assert len(torch.unique(q0)) > 2 and q0.min() >= -3 and q0.max() <= 3
    torch.testing.assert_close(res.final_state.initial_inventory, q0, rtol=0, atol=0)


def test_backend_fused_raises_on_cpu_with_reason():
    cfg = cj_env_config(num_trajectories=256, n_steps=10, max_inventory=5.0)
    pol = CarteaJaimungalMmAgent.from_config(cfg).policy()
    with pytest.raises(ValueError, match="requires a CUDA device"):
        rollout(cfg, pol, None, 0, backend="fused", device="cpu")
    with pytest.raises(ValueError, match="requires a CUDA device"):
        mc_episode_stats(cfg, pol, None, 0, backend="fused", device="cpu")
    as_cfg = torch_config(jax_as_env_config(num_trajectories=256))
    decision = dispatch.dispatch_report(as_cfg, AvellanedaStoikovAgent.from_config(as_cfg).policy())
    assert decision.family == "as_episode"


def test_native_plain_fixed_matches_engine_statistics():
    """Native Philox K5 (plain, on the CPU) and the engine agree on a fixed
    AS quote's episode statistics within 4 standard errors."""
    cfg = torch_config(jax_as_env_config(num_trajectories=2048, n_steps=100))
    pol = fixed_action_policy([0.7, 0.7])
    fused = det.fixed_mc_episode_stats(cfg, [0.7, 0.7], 21, episodes=1, device="cpu")
    eng = mc_episode_stats(cfg, pol, None, 22, backend="engine", device="cpu")
    se = float(torch.hypot(fused["std_pnl"], eng["std_pnl"])) / 2048**0.5
    assert abs(float(fused["mean_pnl"] - eng["mean_pnl"])) < 4 * se
    # exact on the fused side; the engine sums 100 float32 quote means
    assert float(fused["mean_spread"]) == pytest.approx(float(eng["mean_spread"]), rel=1e-4)


# ------------------------------------------------------------ step pipeline geometry
from mbt_gym_torch.ops import step_pipeline as sp  # noqa: E402


@pytest.mark.parametrize("width", [1, 3, 11, 201, 2001, 10001, 20001, 100001])
def test_pipeline_geometry_fits_a_cta(width):
    """Every table width the wrappers accept: the ring fits the H100's
    227 KB of shared memory per CTA (and the half that lets two CTAs share
    an SM), the CTA 512 threads, the consumer warps cover the envs per CTA
    and the producers divide among them; at least one step per slot.  K5's
    geometry: no wide shape."""
    for n, run_steps, stats_only in itertools.product((1, 4100, 16_384, 131_072), (1, 7, 300, 1000), (True, False)):
        g = sp.pipeline_geometry(n, run_steps, "limit", "table", stats_only, width, table_rows=4, wide=False)
        assert g.smem_bytes == sp.ring_bytes(g.envs, g.chunk, g.slots, g.channels, g.table_rows * g.staged, width)
        assert g.smem_bytes <= sp.SMEM_BUDGET <= sp.SMEM_PER_CTA == 232_448
        assert g.envs in (32, 64, 128) and g.threads <= sp.MAX_THREADS
        assert g.producers % (g.envs // 32) == 0 and g.producers >= g.envs // 32
        assert 1 <= g.chunk <= max(1, run_steps) and g.slots >= 1 and g.channels == 5
        assert (g.table_rows, g.row_floats) == (4, width)


def test_pipeline_geometry_stages_the_cjp_table_and_not_a_huge_one():
    """The CJP width (max_inventory 100: 201 entries per side) is staged at
    the main path's 16,384 x 1,000 and at 131,072; max_inventory 5,000
    (10,001 entries a row, 160 KB a step for the four tables) leaves the
    tables in global memory, the draws still staged.  Speed dynamics stage
    the normal alone."""
    cj = cj_env_config(num_trajectories=16_384, max_inventory=100.0)
    p = det.cj_rollout_params(cj, CarteaJaimungalMmAgent.from_config(cj, max_inventory=100))
    for n in (16_384, 131_072):
        for stats_only in (True, False):
            g = det.kernel_geometry(p, n, stats_only)
            assert g.table_path == "staged" and (g.table_rows, g.row_floats) == (4, 201), g
            # a slot's rows of a table land up to 3 floats into their run
            assert g.smem_bytes == sp.ring_bytes(g.envs, g.chunk, g.slots, 5, 4, 201)
            assert sp.padded(g.chunk * 201) == (g.chunk * 201 + 6) // 4 * 4
    wide = p._replace(table_size=2 * 5000 + 1)
    g = det.kernel_geometry(wide, 16_384, True)
    assert g.table_path == "global" and g.channels == 5
    assert g.smem_bytes == sp.ring_bytes(g.envs, g.chunk, g.slots, 5)  # the draws alone
    oe = oe_env_config(num_trajectories=8_192)
    g = det.kernel_geometry(det.schedule_rollout_params(oe), 8_192, False)
    assert g.table_path == "none" and g.channels == 1 and g.table_rows == 0
    # nearly every SM gets a CTA: 16,384 envs in 128-env CTAs, 8,192 in 64-env ones
    assert det.kernel_geometry(p, 16_384, True).envs == 128
    assert g.envs == 64
    assert det.kernel_geometry(p, 4_100, True).envs == 32


def test_pipeline_geometry_of_a_one_step_episode():
    g = sp.pipeline_geometry(4_100, 1, "limit", "table", True, 201, table_rows=4)
    assert g.chunk == 1 and g.table_path == "staged"
    g = sp.pipeline_geometry(5, 0, "speed", "fixed", False, 0)
    assert g.chunk == 1 and g.smem_bytes == sp.ring_bytes(32, 1, g.slots, 1)


def test_kernel_params_carry_the_geometry():
    """The ctypes mirrors end with the geometry struct: nine ints after the
    step constants, as struct DetKernelParams and struct CjKernelParams
    declare it."""
    import ctypes

    assert ctypes.sizeof(sp.PipelineGeometry) == 9 * 4
    assert det.DetKernelParams.pipe.offset == ctypes.sizeof(det.DetKernelParams) - 9 * 4
    g = sp.pipeline_geometry(16_384, 1000, "limit", "table", True, 201, table_rows=4)
    c = g.ctypes()
    assert tuple(getattr(c, name) for name, _ in c._fields_) == tuple(g)
    assert g.with_shape(128, 12, 8, 3).smem_bytes == sp.ring_bytes(128, 8, 3, 5, 4, 201)
