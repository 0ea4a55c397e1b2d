"""The limit-and-market-order ("lam") and at-the-touch ("touch") families
and the reference's canonical learning env through mbt_gym_torch's kernels'
plain versions, against the JAX package run as its own tests run it on the
CPU (Pallas in interpret mode, injected noise): K3 (tests/
test_pallas_rollout.py:544-889), K5's fixed kind, the dispatch decisions
and reasons, the baseline policies, and one whole fused PPO iteration on
the canonical env against JAX's ``_fused_iteration_body``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mbt_gym_tpu import dispatch as jax_dispatch
from mbt_gym_tpu.agents import baseline as jax_baseline
from mbt_gym_tpu.agents import networks as jnet
from mbt_gym_tpu.agents import ppo as jppo
from mbt_gym_tpu.ops import pallas_rollout as pr
from mbt_gym_tpu.rewards import CjMmCriterion as JaxCjMm
from mbt_gym_tpu.rewards import PnL as JaxPnL
from mbt_gym_tpu.rewards import RunningInventoryPenalty as JaxRunning
from mbt_gym_tpu.utils import config as jax_config

from mbt_gym_torch import convert, dispatch, mc_episode_stats, rollout
from mbt_gym_torch.agents import baseline, ppo
from mbt_gym_torch.ops import det_rollout as det
from mbt_gym_torch.ops import mlp_rollout as mr
from mbt_gym_torch.rewards import ExponentialUtility
from mbt_gym_torch.utils import config
from tests.test_torch_det_rollout import _assert_stats_match_jax, _assert_streams_match_jax
from tests.test_torch_env import random_channels, torch_config
from tests.test_torch_networks import assert_trees_close, jax_numpy_tree

N, T = 128, 6

REWARDS = {
    "pnl": JaxPnL(),
    "cjmm": JaxCjMm(per_step_inventory_aversion=0.5, terminal_inventory_aversion=0.001, terminal_time=1.0),
    "running": JaxRunning(per_step_inventory_aversion=0.5, terminal_inventory_aversion=0.001),
}


def _params(a_dim, seed, log_std_shift=0.0, hidden=(16, 16), shared_trunk=True):
    params = jnet.init_actor_critic(jax.random.PRNGKey(seed), 4, a_dim, hidden=hidden, shared_trunk=shared_trunk)
    params = dict(params, log_std=params["log_std"] + log_std_shift)
    return params, convert.actor_critic_from_numpy(jax_numpy_tree(params), device="cpu")


def _k3_channels(a_dim, seed, n=N, steps=T):
    n_ch = mr.n_noise_channels(a_dim)
    rng = np.random.default_rng(seed)
    channels = rng.uniform(size=(steps, n_ch, n)).astype(np.float32)
    channels[:, 4:] = rng.normal(size=(steps, n_ch - 4, n)).astype(np.float32)
    return channels


def _k3_both(jcfg, params, model, channels, inv0=None):
    """K3's plain version and the interpret-mode Pallas kernel on the same
    params, channels and initial inventories."""
    jp = pr.rollout_params_from_config(jcfg)
    p = mr.rollout_params_from_config(torch_config(jcfg))
    for field in mr.MlpRolloutParams._fields:
        assert getattr(p, field) == getattr(jp, field), field
    jinv0 = None if inv0 is None else jnp.asarray(inv0)
    want = pr.mlp_rollout_pallas(jp, params, 0, N, tile=128, interpret=True, noise=jnp.asarray(channels), inv0=jinv0)
    got = mr.mlp_rollout(p, model, 0, N, noise=torch.from_numpy(channels), device="cpu",
                         inv0=None if inv0 is None else torch.from_numpy(inv0))
    return p, [g.numpy() for g in got], [np.asarray(w) for w in want]


def _assert_k3_close(p, got, want, exact_inventory=True):
    """tests/test_pallas_rollout.py:851-854's tolerances: obs rtol 1e-4 /
    atol 2e-4, actions, log-probs and values atol 1e-3, rewards atol 5e-3.
    Where fills are decisions (limit orders, market orders) the inventory
    paths agree exactly; at the touch they are the continuous post columns."""
    assert [g.shape for g in got] == [w.shape for w in want]
    if exact_inventory:
        def inventory(obs):
            return np.rint((obs[:, 1] + 1.0) * p.obs_grad[1] + p.obs_low[1]) if p.normalise_obs else obs[:, 1]

        np.testing.assert_array_equal(inventory(got[0]), inventory(want[0]))
    for g, w, atol in zip(got, want, (2e-4, 1e-3, 1e-3, 1e-3, 5e-3)):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=atol)


def _touch_cfg(reward_name, **kw):
    return dataclasses.replace(
        jax_config.touch_env_config(num_trajectories=N, n_steps=T, **kw), reward_function=REWARDS[reward_name],
        normalise_observation_space=True,
    )


# ------------------------------------------------------------ K3
@pytest.mark.parametrize("reward_name", ["pnl", "running"])
def test_k3_touch_plain_matches_interpret_pallas(reward_name):
    """tests/test_pallas_rollout.py:544: post-or-not at the fixed
    half-spread, fills the clipped post columns."""
    params, model = _params(2, 11)
    p, got, want = _k3_both(_touch_cfg(reward_name), params, model, _k3_channels(2, 33))
    assert (p.dynamics_kind, p.reward_kind, p.fixed_half_spread, p.a_dim) == ("touch", reward_name, 0.5, 2)
    _assert_k3_close(p, got, want, exact_inventory=False)


@pytest.mark.parametrize("reward_name", ["pnl", "running", "cjmm"])
def test_k3_lam_plain_matches_interpret_pallas(reward_name):
    """tests/test_pallas_rollout.py:647: limit quotes plus unit market
    orders, 9 noise channels; the samples widened so market orders fire."""
    jcfg = dataclasses.replace(jax_config.lam_env_config(num_trajectories=N, n_steps=T),
                               reward_function=REWARDS[reward_name], normalise_observation_space=True)
    params, model = _params(4, 7, log_std_shift=0.5)
    p, got, want = _k3_both(jcfg, params, model, _k3_channels(4, 41))
    assert (p.dynamics_kind, p.reward_kind, p.a_dim, mr.n_noise_channels(p.a_dim)) == ("lam", reward_name, 4, 9)
    assert (got[1][:, 2:] > 0.5).any()
    _assert_k3_close(p, got, want)


def test_k3_lam_market_order_mask_matches_interpret_pallas():
    """tests/test_pallas_rollout.py:705: a tight max_inventory with the mask;
    some env sits at the boundary while its market-order column fires."""
    jcfg = dataclasses.replace(jax_config.lam_env_config(num_trajectories=N, n_steps=T), max_inventory=1.0,
                               mask_market_orders_at_max_inventory=True, normalise_observation_space=True)
    params, model = _params(4, 7, log_std_shift=0.7)
    p, got, want = _k3_both(jcfg, params, model, _k3_channels(4, 43))
    assert p.mask_mo_at_max_inventory
    inv = got[0][:, 1] * jcfg.max_inventory
    at_bound = np.abs(inv) >= jcfg.max_inventory
    assert (at_bound & (got[1][:, 2:] > 0.5).any(axis=1)).any()
    _assert_k3_close(p, got, want)


def test_k3_learning_env_injected_inventory_matches_interpret_pallas():
    """tests/test_pallas_rollout.py:815: the canonical env (lam + CjMm +
    initial inventory in [-5, 6)) with a heterogeneous injected inv0 — the
    CjMm constant per env."""
    jcfg = dataclasses.replace(jax_config.learning_env_config(num_trajectories=N), n_steps=T,
                               normalise_observation_space=True)
    params, model = _params(4, 17, log_std_shift=0.5)
    rng = np.random.default_rng(55)
    inv0 = rng.integers(-5, 6, size=N).astype(np.float32)
    assert len(np.unique(inv0)) > 3
    p, got, want = _k3_both(jcfg, params, model, _k3_channels(4, 55), inv0=inv0)
    assert (p.dynamics_kind, p.reward_kind, p.inventory_range) == ("lam", "cjmm", (-5, 6))
    _assert_k3_close(p, got, want)
    with pytest.raises(ValueError, match="pass inv0"):
        mr.mlp_rollout(p, model, 0, N, noise=torch.from_numpy(_k3_channels(4, 55)), device="cpu")


def test_k3_draws_inventory_from_the_generator():
    """tests/test_pallas_rollout.py:857: without an injected inv0 the
    collector draws per-env integers in [lo, hi) from the key, in range and
    different across seeds; the same seed draws the same."""
    cfg = dataclasses.replace(config.learning_env_config(num_trajectories=N), n_steps=T)
    _, model = _params(4, 2)
    noise = torch.from_numpy(_k3_channels(4, 3))

    def q0_of(seed):
        return mr.collect_rollout_fused_T(cfg, model, seed, noise=noise, device="cpu").obs_t[0, 1].numpy()

    a, b = q0_of(0), q0_of(1)
    for q in (a, b):
        assert set(np.unique(q)) <= set(range(-5, 6)) and len(np.unique(q)) > 3
    assert not np.array_equal(a, b)
    np.testing.assert_array_equal(a, q0_of(0))


def test_k3_native_lam_stream_extends_the_limit_stream():
    """Native draws at A = 4: the first seven channels are the A = 2
    stream's bits (a third Philox call adds eps2, eps3), and the plain
    version in native mode is its noise mode on those channels."""
    four = mr.philox_noise(21, 5, 64, device="cpu", a_dim=4)
    two = mr.philox_noise(21, 5, 64, device="cpu")
    assert four.shape == (5, 9, 64) and two.shape == (5, 7, 64)
    assert torch.equal(four[:, :6], two[:, :6]) and torch.equal(four[:, 8], two[:, 6])
    normals = four[:, 6:8]
    assert abs(float(normals.mean())) < 0.1 and abs(float(normals.std()) - 1.0) < 0.1
    cfg = dataclasses.replace(config.lam_env_config(num_trajectories=64, n_steps=5), normalise_observation_space=True)
    _, model = _params(4, 5, log_std_shift=0.5)
    p = mr.rollout_params_from_config(cfg)
    native = mr.mlp_rollout(p, model, 21, 64, device="cpu")
    injected = mr.mlp_rollout(p, model, 0, 64, noise=four)
    for a, b in zip(native, injected):
        assert torch.equal(a, b)


def test_k3_refuses_exponential_utility_by_name():
    """ExponentialUtility, which JAX's K3 takes on lam and touch, parses
    to JAX's parameters; a reward neither takes is refused in JAX's
    words."""
    from mbt_gym_tpu.rewards import CjOeCriterion as JaxCjOe
    from mbt_gym_tpu.rewards import ExponentialUtility as JaxUtility

    for make in (jax_config.lam_env_config, jax_config.touch_env_config):
        jcfg = dataclasses.replace(make(num_trajectories=N), reward_function=JaxUtility(risk_aversion=0.2))
        want = pr.rollout_params_from_config(jcfg)
        got = mr.rollout_params_from_config(torch_config(jcfg))
        assert {f: getattr(want, f) for f in got._fields} == got._asdict()
        assert (got.reward_kind, got.risk_aversion) == ("exp_utility", 0.2)
        wrong = dataclasses.replace(jcfg, reward_function=JaxCjOe())
        words = "supports PnL / CjMmCriterion / RunningInventoryPenalty / ExponentialUtility; got"
        for fn, c in ((pr.rollout_params_from_config, wrong), (mr.rollout_params_from_config, torch_config(wrong))):
            with pytest.raises(AssertionError, match=words):
                fn(c)


# ------------------------------------------------------------ K5 fixed kind
K5_CASES = {
    "lam": (lambda: jax_config.lam_env_config(num_trajectories=N, n_steps=T), [0.6, 0.9, 0.7, 0.2]),
    "lam-mask": (lambda: dataclasses.replace(jax_config.lam_env_config(num_trajectories=N, n_steps=T),
                                             max_inventory=1.0, mask_market_orders_at_max_inventory=True),
                 [0.6, 0.9, 0.8, 0.0]),
    "lam-normalised": (lambda: dataclasses.replace(jax_config.lam_env_config(num_trajectories=N, n_steps=T),
                                                   normalise_action_space=True, normalise_observation_space=True),
                       [-0.6, -0.4, 0.5, -0.5]),
    "touch": (lambda: jax_config.touch_env_config(num_trajectories=N, n_steps=T), [1.0, 0.5]),
}


@pytest.mark.parametrize("name", list(K5_CASES))
def test_k5_fixed_plain_matches_interpret_pallas(name):
    """K5's fixed kind on lam (4 columns, with and without the mask and the
    normalised spaces) and touch (2 post columns) against
    fixed_rollout_pallas(interpret=True): streams with the terminal
    observation, and the stats mode."""
    make, action = K5_CASES[name]
    jcfg = make()
    jp = pr.fixed_rollout_params(jcfg, action)
    p = det.fixed_rollout_params(torch_config(jcfg), action)
    for field, value in p._asdict().items():
        if hasattr(jp, field):
            assert getattr(jp, field) == value, field
    assert p.a_dim == len(action)
    channels = random_channels(32, T, N)
    want = pr.fixed_rollout_pallas(jp, 0, N, tile=128, interpret=True, noise=jnp.asarray(channels), final_obs=True)
    got = det.fixed_rollout(p, 0, N, noise=torch.from_numpy(channels), final_obs=True)
    _assert_streams_match_jax(got, want, p, obs_atol=1e-4, rew_atol=1e-4)
    want = pr.fixed_rollout_pallas(jp, 0, N, tile=128, interpret=True, noise=jnp.asarray(channels), stats_only=True)
    got = det.fixed_rollout(p, 0, N, noise=torch.from_numpy(channels), stats_only=True)
    _assert_stats_match_jax(got, want)
    if name == "lam-mask":
        assert float(got[1].abs().max()) == 1.0


def test_k5_refuses_the_table_kind_on_lam_and_touch():
    """The depth table quotes limit depths: on lam and touch both packages
    refuse it in the same words, while the schedule kind runs there."""
    for make in (config.lam_env_config, config.touch_env_config):
        p = det.schedule_rollout_params(make(num_trajectories=N, n_steps=T))
        out = det.schedule_rollout(p, torch.zeros((T, p.a_dim)), 0, N, device="cpu")
        assert tuple(out[1].shape) == (T, p.a_dim, N)
        table = p._replace(policy_kind="table", table_size=3)
        with pytest.raises(AssertionError, match="limit-order dynamics only"):
            det.table_rollout(table, torch.zeros((T + 1, 3)), torch.zeros((T + 1, 3)), 0, N, device="cpu")


@pytest.mark.parametrize("name", list(K5_CASES))
def test_k5_schedule_plain_matches_interpret_pallas(name):
    """K5's schedule kind on lam (4 columns, with and without the mask and
    the normalised spaces) and touch (2 post columns) against
    schedule_rollout_pallas(interpret=True) on a random per-step table:
    streams with the terminal observation, and the stats mode."""
    make, action = K5_CASES[name]
    jcfg = make()
    jp = pr.schedule_rollout_params(jcfg)
    p = det.schedule_rollout_params(torch_config(jcfg))
    for field, value in p._asdict().items():
        if hasattr(jp, field):
            assert getattr(jp, field) == value, field
    rng = np.random.default_rng(33)
    low = -1.0 if p.normalise_act else 0.0
    table = rng.uniform(low, 1.0, size=(T, len(action))).astype(np.float32)
    channels = random_channels(34, T, N)
    for kw in ({"final_obs": True}, {"stats_only": True}):
        want = pr.schedule_rollout_pallas(jp, jnp.asarray(table), 0, N, tile=128, interpret=True,
                                          noise=jnp.asarray(channels), **kw)
        got = det.schedule_rollout(p, torch.from_numpy(table), 0, N, noise=torch.from_numpy(channels), **kw)
        if "stats_only" in kw:
            _assert_stats_match_jax(got, want)
        else:
            _assert_streams_match_jax(got, want, p, obs_atol=1e-4, rew_atol=1e-4)
    if name.startswith("lam"):
        assert (table[:, 2:] > 0.5).any()


@pytest.mark.parametrize("case", ["limit-table", "lam-fixed", "touch-fixed", "speed-schedule"])
def test_k5_exp_utility_plain_matches_interpret_pallas(case):
    """The terminal exponential utility on K5 (pallas_rollout.py:1173-1179)
    on every dynamics kind: the CJ table on limit, fixed actions on lam and
    touch, the closed-form OE schedule on speed, against the
    interpret-mode kernel in streams (with the terminal observation) and
    stats modes."""
    from mbt_gym_tpu.agents.baseline import CarteaJaimungalMmAgent as JaxCj
    from mbt_gym_tpu.agents.baseline import CarteaJaimungalOeAgent as JaxOe
    from mbt_gym_tpu.rewards import ExponentialUtility as JaxUtility

    utility = JaxUtility(risk_aversion=0.01)
    kind = case.split("-")[0]
    if kind == "limit":
        base = jax_config.cj_env_config(num_trajectories=N, n_steps=T, max_inventory=3.0)
        jagent = JaxCj.from_config(base)
        jcfg = dataclasses.replace(base, reward_function=utility)
        jp = pr.cj_rollout_params(jcfg, jagent)
        agent = baseline.CarteaJaimungalMmAgent.from_config(torch_config(base))
        p = det.cj_rollout_params(torch_config(jcfg), agent)
        bid, ask = det.cj_depth_tables(agent)
        jtables = pr.cj_depth_tables(jagent)  # the inventory grid padded to the TPU's 128 lanes

        def run_jax(**kw):
            return pr.table_rollout_pallas(jp, *jtables, 0, N, tile=128, interpret=True, **kw)

        def run(**kw):
            return det.table_rollout(p, bid, ask, 0, N, **kw)
    elif kind == "speed":
        base = jax_config.oe_env_config(num_trajectories=N, n_steps=T)
        jcfg = dataclasses.replace(base, reward_function=utility)
        jp = pr.schedule_rollout_params(jcfg)
        p = det.schedule_rollout_params(torch_config(jcfg))
        table = np.array(pr.schedule_table_from_policy(base, JaxOe.from_config(base).policy()))

        def run_jax(**kw):
            return pr.schedule_rollout_pallas(jp, jnp.asarray(table), 0, N, tile=128, interpret=True, **kw)

        def run(**kw):
            return det.schedule_rollout(p, torch.from_numpy(table), 0, N, **kw)
    else:
        make, action = K5_CASES[kind]
        jcfg = dataclasses.replace(make(), reward_function=utility)
        jp = pr.fixed_rollout_params(jcfg, action)
        p = det.fixed_rollout_params(torch_config(jcfg), action)

        def run_jax(**kw):
            return pr.fixed_rollout_pallas(jp, 0, N, tile=128, interpret=True, **kw)

        def run(**kw):
            return det.fixed_rollout(p, 0, N, **kw)
    assert (p.reward_kind, p.risk_aversion, jp.reward_kind) == ("exp_utility", 0.01, "exp_utility")
    channels = random_channels(35, p.run_steps, N)
    got = run(noise=torch.from_numpy(channels), final_obs=True)
    _assert_streams_match_jax(got, run_jax(noise=jnp.asarray(channels), final_obs=True), p, obs_atol=1e-4,
                              rew_atol=1e-6)
    assert not got[4][:-1].any() and bool((got[4][-1] < 0.0).all())
    _assert_stats_match_jax(run(noise=torch.from_numpy(channels), stats_only=True),
                            run_jax(noise=jnp.asarray(channels), stats_only=True))


@pytest.mark.parametrize("name", ["lam", "touch"])
def test_fixed_stats_and_rollout_on_cpu_agree_with_the_engine(name):
    """The fused front door's fixed family on the CPU (the plain versions):
    the touch convention (mean_spread NaN, post_rate the action's mean),
    and the trajectory's statistics within 4 standard errors of the
    engine's on independent streams."""
    make, action = K5_CASES[name]
    cfg = dataclasses.replace(torch_config(make()), num_trajectories=2048, n_steps=20)
    pol = baseline.fixed_action_policy(action)
    decision = dispatch.DispatchDecision("fused", "fixed", "")
    fused = dispatch.fused_mc_episode_stats(cfg, pol, None, 3, 2, decision, device="cpu")
    engine = mc_episode_stats(cfg, pol, None, 4, episodes=2, backend="engine", device="cpu")
    if name == "touch":
        assert np.isnan(float(fused["mean_spread"])) and np.isnan(float(engine["mean_spread"]))
        assert float(fused["post_rate"]) == pytest.approx(0.75) and float(engine["post_rate"]) == pytest.approx(0.75)
    se = float(engine["std_pnl"]) / np.sqrt(4096) * np.sqrt(2)
    assert abs(float(fused["mean_pnl"]) - float(engine["mean_pnl"])) < 4 * se
    res = dispatch.fused_rollout(cfg, pol, None, 5, decision, device="cpu")
    assert res.trajectory.actions.shape == (20, 2048, len(action))
    torch.testing.assert_close(res.final_state.inventory, res.trajectory.observations[-1, :, 1], rtol=0, atol=0)


# ------------------------------------------------------------ dispatch
def _jax_and_port_fixed(jcfg, action):
    return (jcfg, jax_baseline.fixed_action_policy(action), torch_config(jcfg),
            baseline.fixed_action_policy(action))


def test_dispatch_decisions_match_jax():
    """tests/test_dispatch.py:77 and :260 and the fixed family on lam and
    touch: the same backend and family in both front doors, and the same
    reason where they fall back."""
    lam = jax_config.lam_env_config(num_trajectories=256)
    touch = jax_config.touch_env_config(num_trajectories=256)
    cases = [
        _jax_and_port_fixed(lam, [0.6, 0.6, 0.0, 0.0]),
        _jax_and_port_fixed(touch, [1.0, 0.0]),
        _jax_and_port_fixed(lam, [0.6, 0.6]),  # wrong columns
        _jax_and_port_fixed(touch, [1.0, 0.0, 0.0, 0.0]),
        _jax_and_port_fixed(jax_config.learning_env_config(num_trajectories=256), [0.6, 0.6, 0.0, 0.0]),
        _jax_and_port_fixed(dataclasses.replace(lam, num_trajectories=1000), [0.6, 0.6, 0.0, 0.0]),
    ]
    # a fixed quote policy wrapped for limit+market envs keeps its fused lane (test_dispatch.py:77)
    cases.append((lam, jax_baseline.no_market_order_policy(jax_baseline.fixed_spread_policy(1.0)), torch_config(lam),
                  baseline.no_market_order_policy(baseline.fixed_spread_policy(1.0))))
    # the AS agent on a lam config must not take the AS kernel (test_dispatch.py:260)
    lam_pnl = dataclasses.replace(lam, reward_function=JaxPnL())
    jas = jax_baseline.AvellanedaStoikovAgent.from_config(lam_pnl, risk_aversion=0.1)
    cases.append((lam_pnl, jas.policy(), torch_config(lam_pnl),
                  baseline.AvellanedaStoikovAgent(**dataclasses.asdict(jas)).policy()))
    # the CJ table policy is limit-order dynamics only (mbt_gym_tpu/dispatch.py:136-140)
    lam_cj = dataclasses.replace(lam, reward_function=JaxCjMm(0.01, 0.001))
    jcj = jax_baseline.CarteaJaimungalMmAgent.from_config(lam_cj, max_inventory=10)
    cases.append((lam_cj, jcj.policy(), torch_config(lam_cj),
                  convert.cj_mm_agent_from_spec(
                      {"type": "CarteaJaimungalMmAgent", **dataclasses.asdict(jcj)}).policy()))
    fused = 0
    for jcfg, jpol, cfg, pol in cases:
        for mode in ("rollout", "stats"):
            want = jax_dispatch.dispatch_report(jcfg, jpol, mode=mode, platform="tpu")
            got = dispatch.dispatch_report(cfg, pol, mode=mode, platform="cuda")
            assert (want.backend == "fused") == (got.backend == "fused"), (mode, want, got)
            assert want.family == got.family, (mode, want, got)
            if got.backend == "fused":
                fused += 1
            else:
                expected = want.reason.replace("backend='xla'", "backend='engine'").replace(
                    "pallas fast path", "episode kernel")
                assert got.reason == expected, (mode, want, got)
    assert fused == 7
    assert dispatch.policy_meta(cases[6][3])["action"] == (1.0, 1.0, 0.0, 0.0)


# ------------------------------------------------------------ policies
def test_baseline_policies_match_jax():
    """Each policy returns what its JAX counterpart returns on the same
    observations and carries the same dispatch tag."""
    jcfg = dataclasses.replace(jax_config.lam_env_config(num_trajectories=32), normalise_observation_space=True)
    cfg = torch_config(jcfg)
    obs = np.random.default_rng(3).uniform(-1, 1, size=(32, 4)).astype(np.float32)
    raw_seen = {}

    def jrec(params, o, state):
        raw_seen["jax"] = np.asarray(o)
        return o[:, :2]

    def rec(params, o, state):
        raw_seen["port"] = o.numpy()
        return o[:, :2]

    jax_baseline.raw_obs_policy(jcfg, jrec)(None, jnp.asarray(obs), None)
    baseline.raw_obs_policy(cfg, rec)(None, torch.from_numpy(obs), None)
    np.testing.assert_allclose(raw_seen["port"], raw_seen["jax"], rtol=1e-6, atol=1e-3)
    plain = dataclasses.replace(cfg, normalise_observation_space=False)
    assert baseline.raw_obs_policy(plain, rec) is rec
    for jpol, pol in (
        (jax_baseline.fixed_spread_policy(1.2, 0.3), baseline.fixed_spread_policy(1.2, 0.3)),
        (jax_baseline.no_market_order_policy(jax_baseline.fixed_spread_policy(0.8)),
         baseline.no_market_order_policy(baseline.fixed_spread_policy(0.8))),
    ):
        np.testing.assert_array_equal(pol(None, torch.from_numpy(obs), None).numpy(),
                                      np.asarray(jpol(None, jnp.asarray(obs), None)))
        assert pol.dispatch_meta == jax_dispatch.policy_meta(jpol)
    # a non-fixed quote policy gains zero market-order columns and no tag
    jwrapped = jax_baseline.no_market_order_policy(lambda p, o, s: o[:, :2] * 2)
    wrapped = baseline.no_market_order_policy(lambda p, o, s: o[:, :2] * 2)
    np.testing.assert_array_equal(wrapped(None, torch.from_numpy(obs), None).numpy(),
                                  np.asarray(jwrapped(None, jnp.asarray(obs), None)))
    assert dispatch.policy_meta(wrapped) is None and jax_dispatch.policy_meta(jwrapped) is None


def test_random_policy_bounds_and_one_sample_per_step():
    """BaselineAgents.py:15-22: one uniform sample of the action box per
    step, shared by all envs, from the policy's own generator (the env's
    noise stream is untouched); the same seed repeats it."""
    cfg = config.lam_env_config(num_trajectories=16)
    low, high = cfg.action_bounds()
    pol = baseline.random_policy(cfg, key=7)
    obs = torch.zeros((16, 4))
    samples = torch.stack([pol(None, obs, None) for _ in range(200)])
    assert samples.shape == (200, 16, 4)
    assert torch.equal(samples, samples[:, :1].expand_as(samples))
    flat = samples[:, 0].numpy()
    assert (flat >= low).all() and (flat <= high).all()
    np.testing.assert_allclose(flat.mean(axis=0), (low + high) / 2, rtol=0.15)
    again = baseline.random_policy(cfg, key=7)
    assert torch.equal(again(None, obs, None), samples[0])
    # the engine runs it; the env's noise stream is its own
    res = rollout(cfg, baseline.random_policy(cfg, key=1), None, 0, backend="engine", device="cpu")
    assert res.trajectory.actions.shape == (cfg.n_steps, 16, 4)


def test_human_and_expected_action(monkeypatch):
    """human_policy broadcasts the two typed half-spreads; expected_action
    returns a deterministic policy's action unchanged and the mean of a
    random one."""
    cfg = config.as_env_config(num_trajectories=4)
    answers = iter(["0.7", "1.1"])
    monkeypatch.setattr("builtins.input", lambda prompt: next(answers))
    obs = torch.zeros((4, 4))
    np.testing.assert_allclose(baseline.human_policy(cfg)(None, obs, None).numpy(), [[0.7, 1.1]] * 4, rtol=1e-6)
    fixed = baseline.fixed_action_policy([0.3, 0.4])
    assert torch.equal(baseline.expected_action(fixed, None, obs, None, 0, n_samples=3), fixed(None, obs, None))
    lam = config.lam_env_config(num_trajectories=4)
    mean = baseline.expected_action(baseline.random_policy(lam, key=2), None, obs, None, 0, n_samples=400)
    low, high = lam.action_bounds()
    np.testing.assert_allclose(mean[0].numpy(), (low + high) / 2, rtol=0.1)


# ------------------------------------------------------------ fused PPO
def test_fused_iteration_on_the_canonical_env_matches_jax():
    """One whole fused iteration on the canonical learning env (N = 128,
    T = 8; lam, CjMm, an injected heterogeneous inv0, 9 channels): K3 ->
    GAE -> K4 at A = 4 -> Adam, against JAX's _fused_iteration_body in
    interpret mode, at tests/test_torch_fused_ppo.py's tolerances."""
    n, t_steps = 128, 8
    jcfg = dataclasses.replace(jax_config.learning_env_config(num_trajectories=n), n_steps=t_steps,
                               normalise_observation_space=True)
    kw = dict(hidden=(16, 16), n_epochs=1, n_minibatches=2, shuffle=False, shared_trunk=True, ent_coef=0.01,
              fused_rollout=True, fused_update=True, fused_compute_dtype="float32")
    jcfg_ppo = jppo.PPOConfig(fused_interpret_ok=True, fused_rollout_tile=128, **kw)
    channels = _k3_channels(4, 12, n=n, steps=t_steps)
    inv0 = np.random.default_rng(12).integers(-5, 6, size=n).astype(np.float32)
    params, model = _params(4, 6, log_std_shift=0.3)
    opt_state = jppo.make_optimizer(jcfg_ppo).init(params)
    want_params, _, want_m = jppo._fused_iteration_body(
        jcfg, jcfg_ppo, params, opt_state, jax.random.PRNGKey(0), noise=jnp.asarray(channels), inv0=jnp.asarray(inv0))
    cfg = ppo.PPOConfig(**kw)
    optimizer = ppo.make_optimizer(cfg, model)
    metrics = ppo._fused_iteration_body(torch_config(jcfg), cfg, model, optimizer, 0,
                                        noise=torch.from_numpy(channels), inv0=torch.from_numpy(inv0))
    assert_trees_close(convert.actor_critic_to_numpy(model), jax_numpy_tree(want_params), rtol=5e-4, atol=5e-6)
    for name in ("pg_loss", "vf_loss", "approx_kl", "entropy", "mean_episode_reward"):
        np.testing.assert_allclose(float(metrics[name]), float(want_m[name]), rtol=1e-3, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("name", ["touch", "learning"])
def test_train_iteration_on_cpu_both_paths(name):
    """train_iteration on the touch and canonical configs: the fused path
    (plain K3, K4) and the engine path both give finite metrics and move
    the params; evaluate_policy's fused and engine backends run."""
    cfg = (dataclasses.replace(config.touch_env_config(num_trajectories=128, n_steps=8),
                               normalise_observation_space=True) if name == "touch"
           else dataclasses.replace(config.learning_env_config(num_trajectories=128), n_steps=8,
                                    normalise_observation_space=True))
    for fused in (True, False):
        pcfg = ppo.PPOConfig(hidden=(16, 16), n_epochs=1, n_minibatches=2, shuffle=False, fused_rollout=fused,
                             fused_update=fused, fused_compute_dtype="float32")
        ts = ppo.init_train_state(cfg, pcfg, 0, device="cpu")
        before = [p.detach().clone() for p in ts.params.parameters()]
        new_ts, metrics = ppo.train_iteration(cfg, pcfg, ts, 1)
        assert all(np.isfinite(float(v)) for v in metrics.values()), metrics
        assert any(not torch.equal(a, b) for a, b in zip(before, new_ts.params.parameters()))
    for backend in ("fused", "engine"):
        assert np.isfinite(float(ppo.evaluate_policy(cfg, new_ts.params, 3, backend=backend)))
