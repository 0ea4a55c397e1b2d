"""The optimal-execution (trading-speed) family, random start times, the
terminal observation and the exponential utility through mbt_gym_torch's
K3 and K4 plain versions, against the JAX package run as its own tests
run it on the CPU (Pallas in interpret mode, injected noise): K3's speed
kind with every impact model and reward (tests/test_pallas_rollout.py:
380-467), its t0 plane (:137-175), its ``final_obs`` output
(tests/test_dispatch.py:325-350) and the exponential utility on the
market-making kinds; K4's plain version at S = 5, A = 1 against
``ppo_fused_grads_T``; one whole fused PPO iteration on the OE config
against JAX's ``_fused_iteration_body``; the parameters, the refusals and
the dispatch decisions beside JAX's; the A = 1 conversions."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mbt_gym_tpu import dispatch as jax_dispatch
from mbt_gym_tpu.agents import networks as jnet
from mbt_gym_tpu.agents import ppo as jppo
from mbt_gym_tpu.ops import fused_ppo as jfused
from mbt_gym_tpu.ops import pallas_rollout as pr
from mbt_gym_tpu.processes import impact as jimpact
from mbt_gym_tpu.processes import midprice as jmid
from mbt_gym_tpu.rewards import CjOeCriterion as JaxCjOe
from mbt_gym_tpu.rewards import ExponentialUtility as JaxUtility
from mbt_gym_tpu.rewards import PnL as JaxPnL
from mbt_gym_tpu.utils import config as jax_config

from mbt_gym_torch import convert, dispatch
from mbt_gym_torch.agents import ppo
from mbt_gym_torch.ops import fused_ppo
from mbt_gym_torch.ops import mlp_rollout as mr
from mbt_gym_torch.utils import config
from tests.test_torch_env import torch_config
from tests.test_torch_networks import assert_trees_close, jax_numpy_tree, tree_items

N, T = 128, 6

REWARDS = {
    "pnl": JaxPnL(),
    "cjoe": JaxCjOe(),
    "cjoe_e3": JaxCjOe(inventory_exponent=3.0),
    "exp_utility": JaxUtility(risk_aversion=0.01),
}
IMPACTS = {
    "power": jimpact.TemporaryPowerImpact(temporary_impact_exponent=2.0),
    "transient": jimpact.TransientImpact(),
    "temp_transient": jimpact.TemporaryAndTransientImpact(),
}


def _oe(normalised=False, **kw):
    cfg = jax_config.oe_env_config(num_trajectories=N, n_steps=T, **kw)
    return dataclasses.replace(cfg, normalise_observation_space=normalised, normalise_action_space=normalised)


def _params(jcfg, seed, shared_trunk=True, hidden=(16, 16)):
    params = jnet.init_actor_critic(jax.random.PRNGKey(seed), jcfg.state_dim, jcfg.action_dim, hidden=hidden,
                                    shared_trunk=shared_trunk)
    return params, convert.actor_critic_from_numpy(jax_numpy_tree(params), device="cpu")


def _channels(p, seed, n=N):
    n_ch = mr.n_noise_channels(p.a_dim, p.fill_kind == "exomm", p.has_mid2)
    rng = np.random.default_rng(seed)
    channels = rng.uniform(size=(p.run_steps, n_ch, n)).astype(np.float32)
    channels[:, 4:] = rng.normal(size=(p.run_steps, n_ch - 4, n)).astype(np.float32)
    return channels


def _same_params(jcfg):
    """The port's K3 parameters of ``jcfg``, field for field JAX's."""
    jp = pr.rollout_params_from_config(jcfg)
    p = mr.rollout_params_from_config(torch_config(jcfg))
    for field in mr.MlpRolloutParams._fields:
        assert getattr(p, field) == getattr(jp, field), field
    return jp, p


def _k3_both(jcfg, seed=5, shared_trunk=True, t0=None, final_obs=False):
    """K3's plain version and the interpret-mode Pallas kernel on the same
    params and channels."""
    jp, p = _same_params(jcfg)
    params, model = _params(jcfg, seed, shared_trunk)
    channels = _channels(p, 21)
    want = pr.mlp_rollout_pallas(jp, params, 0, N, tile=128, interpret=True, noise=jnp.asarray(channels),
                                 t0=None if t0 is None else jnp.asarray(t0), final_obs=final_obs)
    got = mr.mlp_rollout(p, model, 0, N, noise=torch.from_numpy(channels), device="cpu",
                         t0=None if t0 is None else torch.from_numpy(t0), final_obs=final_obs)
    return p, [g.numpy() for g in got], [np.asarray(w) for w in want]


def _assert_k3_close(got, want):
    """tests/test_pallas_rollout.py:420-427's tolerances: obs rtol 1e-4 /
    atol 2e-4, actions, log-probs and values atol 1e-3, rewards atol 5e-3
    (and the terminal observation as the observations)."""
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w, atol in zip(got, want, (2e-4, 1e-3, 1e-3, 1e-3, 5e-3, 2e-4)):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=atol)


# ------------------------------------------------------------ K3 speed
@pytest.mark.parametrize("shared_trunk", [True, False], ids=["shared-trunk", "towers"])
@pytest.mark.parametrize("reward_name", list(REWARDS))
def test_k3_speed_plain_matches_interpret_pallas(reward_name, shared_trunk):
    """tests/test_pallas_rollout.py:380-427: trading-speed dynamics with
    temporary-and-permanent impact, S = 5 (the impact state after the
    price), A = 1, 7 channels; raw spaces on the float32 path with the
    shared trunk, normalised spaces on the bf16 operands with the towers."""
    jcfg = dataclasses.replace(_oe(normalised=not shared_trunk), reward_function=REWARDS[reward_name])
    p, got, want = _k3_both(jcfg, shared_trunk=shared_trunk)
    assert (p.dynamics_kind, p.a_dim, len(p.obs_low), p.n_channels) == ("speed", 1, 5, 7)
    assert p.reward_kind == reward_name.split("_e")[0]
    _assert_k3_close(got, want)
    if reward_name == "exp_utility":  # the terminal utility alone
        assert np.all(got[4][:-1] == 0.0) and np.all(got[4][-1] < 0.0)


@pytest.mark.parametrize("name", [*IMPACTS, "heston"])
def test_k3_speed_process_kinds_plain_match_interpret_pallas(name):
    """The power, transient and temporary-and-transient impacts (the first
    stateless: S = 4), and a Heston midprice on speed (the variance
    observed before the impact state, 8 channels), on the general
    instantiation's arithmetic, with the CjOe reward."""
    jcfg = _oe()
    if name == "heston":
        jcfg = dataclasses.replace(jcfg, dynamics=dataclasses.replace(jcfg.dynamics, midprice_model=jmid.HestonMidprice(
            initial_price=100.0)))
    else:
        jcfg = dataclasses.replace(jcfg, dynamics=dataclasses.replace(jcfg.dynamics, price_impact_model=IMPACTS[name]))
    p, got, want = _k3_both(jcfg)
    assert (p.impact_kind, len(p.obs_low)) == ({"heston": "temp_perm"}.get(name, name),
                                               {"power": 4, "heston": 6}.get(name, 5))
    _assert_k3_close(got, want)


def test_k3_speed_refuses_fill_driven_jumps_in_jax_words():
    """A jump midprice on speed dynamics has no fills to react to: both
    packages refuse it with the same words (pallas_rollout.py:517-522)."""
    jcfg = _oe()
    jcfg = dataclasses.replace(jcfg, dynamics=dataclasses.replace(jcfg.dynamics, midprice_model=jmid.OuJumpMidprice()))
    words = "fill-driven midprice jumps have no fills to react to"
    with pytest.raises(AssertionError, match=words):
        pr.rollout_params_from_config(jcfg)
    with pytest.raises(AssertionError, match=words):
        mr.rollout_params_from_config(torch_config(jcfg))


# ------------------------------------------------------------ t0, final_obs, exp_utility
@pytest.mark.parametrize("plane", ["shared", "per-env"])
def test_k3_random_start_matches_collect_rollout_fused(plane):
    """tests/test_pallas_rollout.py:137-175: start_time=("uniform", 0, 0.5)
    runs the full horizon with the t0 plane, post-done steps frozen (time
    clamped at terminal) with zero rewards; a shared t0 of 2 steps, or
    half the envs at 0 and half at 2 steps.  collect_rollout_fused of both
    packages on the same injected t0 and channels, the CjMm reward's
    per-env episode length too."""
    from mbt_gym_tpu.rewards import CjMmCriterion

    jcfg = dataclasses.replace(jax_config.as_env_config(num_trajectories=N, n_steps=T), start_time=(
        "uniform", 0.0, 0.5), normalise_observation_space=True, normalise_action_space=True)
    if plane == "per-env":
        jcfg = dataclasses.replace(jcfg, reward_function=CjMmCriterion(0.5, 0.001, terminal_time=1.0))
    jp, p = _same_params(jcfg)
    assert p.random_start and p.start_time == 0.0 and p.run_steps == T
    params, model = _params(jcfg, 3)
    channels = _channels(p, 9)
    step = 2 * jcfg.step_size
    t0 = np.full((N,), step, np.float32)
    if plane == "per-env":
        t0[: N // 2] = 0.0
    want = pr.collect_rollout_fused(jcfg, params, jax.random.PRNGKey(0), tile=128, interpret=True,
                                    noise=jnp.asarray(channels), t0=jnp.asarray(t0))
    got = mr.collect_rollout_fused(torch_config(jcfg), model, 0, noise=torch.from_numpy(channels), device="cpu",
                                   t0=torch.from_numpy(t0))
    fields = ("obs", "actions", "log_probs", "values", "rewards")
    _assert_k3_close([getattr(got, f).numpy() for f in fields], [np.asarray(getattr(want, f)) for f in fields])
    late = got.rewards[:, N // 2:]
    assert torch.all(late[-2:] == 0.0) and torch.equal(got.obs[-1, N // 2:], got.obs[-2, N // 2:])


def test_k3_random_start_draws_one_shared_start_on_the_grid():
    """collect_rollout_fused_T draws one start per episode from the key,
    quantised to the step grid as env.reset draws it, and refuses the
    terminal observation with it, as JAX does (pallas_rollout.py:1623)."""
    cfg = dataclasses.replace(config.as_env_config(num_trajectories=N, n_steps=20), start_time=("uniform", 0.0, 0.5))
    model = _params(jax_config.as_env_config(num_trajectories=N), 3)[1]
    starts = set()
    for key in range(6):
        tb = mr.collect_rollout_fused_T(cfg, model, key, device="cpu")
        times = tb.obs_t[0, 2]
        assert torch.all(times == times[0])
        t0 = float(times[0])
        assert 0.0 <= t0 <= 0.5 and abs(t0 / cfg.step_size - round(t0 / cfg.step_size)) < 1e-4
        done = round(t0 / cfg.step_size)
        assert torch.all(tb.rewards[cfg.n_steps - done:] == 0.0)
        starts.add(round(t0 / cfg.step_size))
    assert len(starts) > 1
    p = mr.rollout_params_from_config(cfg)
    with pytest.raises(ValueError, match="final_obs with random starts"):
        mr.mlp_rollout(p, model, 0, N, device="cpu", t0=torch.zeros(N), final_obs=True)
    with pytest.raises(ValueError, match="pass t0"):
        mr.mlp_rollout(p, model, 0, N, device="cpu")


@pytest.mark.parametrize("kind", ["limit", "speed"])
def test_k3_final_obs_matches_interpret_pallas(kind):
    """tests/test_dispatch.py:325-350: the terminal observation (the final
    state at start + T dt) beside the five streams, on the normalised AS
    env and the OE env."""
    jcfg = (dataclasses.replace(jax_config.as_env_config(num_trajectories=N, n_steps=T),
                                normalise_observation_space=True, normalise_action_space=True)
            if kind == "limit" else _oe())
    p, got, want = _k3_both(jcfg, final_obs=True)
    assert len(got) == 6 and got[5].shape == (len(p.obs_low), N)
    _assert_k3_close(got, want)
    # the time column reads the terminal time
    t_col = got[5][2]
    want_t = 1.0 if not p.normalise_obs else (1.0 - p.obs_low[2]) / p.obs_grad[2] - 1.0
    np.testing.assert_allclose(t_col, want_t, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", ["limit", "lam", "touch"])
def test_k3_exp_utility_plain_matches_interpret_pallas(kind):
    """The terminal exponential utility (pallas_rollout.py:1173-1179) on
    the market-making kinds: zero before the last step, then
    -exp(-gamma * (cash + inventory * price))."""
    make = {"limit": jax_config.as_env_config, "lam": jax_config.lam_env_config,
            "touch": jax_config.touch_env_config}[kind]
    jcfg = dataclasses.replace(make(num_trajectories=N, n_steps=T), reward_function=JaxUtility(risk_aversion=0.1),
                               normalise_observation_space=True)
    p, got, want = _k3_both(jcfg, seed=7)
    assert (p.dynamics_kind, p.reward_kind, p.risk_aversion) == (kind, "exp_utility", 0.1)
    _assert_k3_close(got, want)
    assert np.all(got[4][:-1] == 0.0)


# ------------------------------------------------------------ parameters and refusals
def test_speed_params_match_jax():
    """The counterpart of tests/test_pallas_rollout.py:430-467: every field
    of the OE config's parameters, each impact model's, the CjOe exponent
    and the utility's risk aversion, and a random start, equal JAX's; an
    unknown reward is refused in JAX's words."""
    cfg = _oe()
    for jcfg in (cfg, _oe(normalised=True), dataclasses.replace(cfg, reward_function=REWARDS["cjoe_e3"]),
                 dataclasses.replace(cfg, reward_function=REWARDS["exp_utility"]),
                 dataclasses.replace(cfg, start_time=("uniform", 0.0, 0.5)),
                 *(dataclasses.replace(cfg, dynamics=dataclasses.replace(cfg.dynamics, price_impact_model=m))
                   for m in IMPACTS.values())):
        _same_params(jcfg)
    p = mr.rollout_params_from_config(torch_config(dataclasses.replace(cfg, reward_function=REWARDS["exp_utility"])))
    assert (p.reward_kind, p.risk_aversion) == ("exp_utility", 0.01)
    utility_lam = dataclasses.replace(jax_config.lam_env_config(num_trajectories=N), reward_function=JaxUtility())
    assert _same_params(utility_lam)[1].reward_kind == "exp_utility"
    from mbt_gym_tpu.rewards import CjMmCriterion

    wrong = dataclasses.replace(cfg, reward_function=CjMmCriterion(0.01, 0.001))
    with pytest.raises(AssertionError, match=r"speed dynamics\) supports PnL / CjOeCriterion / ExponentialUtility"):
        pr.rollout_params_from_config(wrong)
    with pytest.raises(AssertionError, match=r"speed dynamics\) supports PnL / CjOeCriterion / ExponentialUtility"):
        mr.rollout_params_from_config(torch_config(wrong))


def test_dispatch_matches_jax_on_utility_and_speed():
    """The fixed family takes the exponential utility with JAX's reason
    word for word; the mlp_rollout evaluate family takes the OE config and
    random starts on the card (JAX's own decides by its measurement), and
    still serves no rollout or stats."""
    from mbt_gym_tpu.agents import baseline as jbase

    from mbt_gym_torch.agents import baseline

    jcfg = dataclasses.replace(jax_config.composite_env_config(num_trajectories=N), reward_function=JaxUtility())
    for mode in ("rollout", "stats"):
        want = jax_dispatch.dispatch_report(jcfg, jbase.fixed_action_policy([0.6, 0.6, 0.0, 0.0]), mode=mode,
                                            platform="tpu")
        got = dispatch.dispatch_report(torch_config(jcfg), baseline.fixed_action_policy([0.6, 0.6, 0.0, 0.0]),
                                       mode=mode, platform="cuda")
        assert tuple(got) == tuple(want) == ("fused", "fixed", "config and policy match the fixed kernel contract")
    oe = config.oe_env_config(num_trajectories=N)
    late = dataclasses.replace(config.as_env_config(num_trajectories=N), start_time=("uniform", 0.0, 0.5))
    for cfg in (oe, late):
        got = dispatch.dispatch_report(cfg, ppo.deterministic_policy(cfg), mode="evaluate", platform="cuda")
        assert (got.backend, got.family) == ("fused", "mlp_rollout"), got
        got = dispatch.dispatch_report(cfg, ppo.deterministic_policy(cfg), mode="rollout", platform="cuda")
        assert got.backend == "engine" and "serves evaluate_policy" in got.reason


# ------------------------------------------------------------ K4 and the fused iteration
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_k4_plain_at_s5_a1_matches_jax_interpret_kernel(compute_dtype):
    """K4 at the OE shapes, S = 5 and A = 1, against
    ppo_fused_grads_T(..., interpret=True) on the same inputs, at
    tests/test_torch_fused_ppo.py's tolerances (float32 rtol 2e-4 / atol
    2e-6; bf16 a leaf's relative error 1e-2; metrics rtol 1e-4)."""
    steps, lanes = 8, 64
    params, model = _params(_oe(), 2, hidden=(32, 32))
    rng = np.random.default_rng(7)
    m = steps * lanes
    obs = rng.normal(size=(m, 5)).astype(np.float32)
    mean, values = jnet.policy_value(params, jnp.asarray(obs))
    actions = np.array(mean + jnp.exp(params["log_std"]) * rng.normal(size=(m, 1)).astype(np.float32))
    log_probs = np.asarray(jnet.gaussian_log_prob(params, mean, jnp.asarray(actions)))
    log_probs = (log_probs + 0.3 * rng.normal(size=m)).astype(np.float32)
    adv = rng.normal(size=m).astype(np.float32)
    returns = (np.asarray(values) + rng.normal(size=m)).astype(np.float32)
    to_t = lambda x: np.ascontiguousarray(x.reshape(steps, lanes, -1).swapaxes(1, 2))  # noqa: E731
    flat = lambda x: np.ascontiguousarray(x.reshape(steps, lanes))  # noqa: E731
    inputs = (to_t(obs), to_t(actions), flat(log_probs), flat(adv), flat(returns))
    want_g, want_m = jfused.ppo_fused_grads_T(params, *(jnp.asarray(x) for x in inputs), clip_eps=0.2, vf_coef=0.5,
                                             tile=lanes, interpret=True, compute_dtype=compute_dtype)
    grads, metrics = fused_ppo.ppo_fused_grads_T(model, *(torch.from_numpy(x) for x in inputs), clip_eps=0.2,
                                                 vf_coef=0.5, compute_dtype=compute_dtype)
    got = convert.actor_critic_to_numpy(model, grads)
    if compute_dtype == "float32":
        assert_trees_close(got, jax_numpy_tree(want_g), rtol=2e-4, atol=2e-6)
    else:
        want_items = dict(tree_items(jax_numpy_tree(want_g)))
        for path, g in tree_items(got):
            w = want_items[path]
            assert np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30) <= 1e-2, path
    for name in ("pg_loss", "vf_loss", "approx_kl"):
        np.testing.assert_allclose(float(metrics[name]), float(want_m[name]), rtol=1e-4, atol=1e-6, err_msg=name)


def test_fused_iteration_on_the_oe_env_matches_jax():
    """One whole fused iteration on oe_env_config(256, n_steps=8) with
    normalised spaces (bench_suite config 6 cut to size): K3's speed kind
    -> GAE -> K4 at S = 5, A = 1 -> Adam, against JAX's
    _fused_iteration_body in interpret mode on the same channels, at
    tests/test_torch_fused_ppo.py's tolerances."""
    n, t_steps = 256, 8
    jcfg = dataclasses.replace(jax_config.oe_env_config(num_trajectories=n, n_steps=t_steps),
                               normalise_observation_space=True, normalise_action_space=True)
    kw = dict(hidden=(16, 16), n_epochs=1, n_minibatches=2, shuffle=False, shared_trunk=True, ent_coef=0.01,
              fused_rollout=True, fused_update=True, fused_compute_dtype="float32")
    jcfg_ppo = jppo.PPOConfig(fused_interpret_ok=True, fused_rollout_tile=128, **kw)
    _, p = _same_params(jcfg)
    channels = _channels(p, 12, n=n)
    params, model = _params(jcfg, 6)
    opt_state = jppo.make_optimizer(jcfg_ppo).init(params)
    want_params, _, want_m = jppo._fused_iteration_body(jcfg, jcfg_ppo, params, opt_state, jax.random.PRNGKey(0),
                                                        noise=jnp.asarray(channels))
    cfg = ppo.PPOConfig(**kw)
    optimizer = ppo.make_optimizer(cfg, model)
    metrics = ppo._fused_iteration_body(torch_config(jcfg), cfg, model, optimizer, 0, noise=torch.from_numpy(channels))
    assert_trees_close(convert.actor_critic_to_numpy(model), jax_numpy_tree(want_params), rtol=5e-4, atol=5e-6)
    for name in ("pg_loss", "vf_loss", "approx_kl", "entropy", "mean_episode_reward"):
        np.testing.assert_allclose(float(metrics[name]), float(want_m[name]), rtol=1e-3, atol=1e-5, err_msg=name)


def test_train_iteration_and_evaluate_on_the_oe_env_on_cpu():
    """train_iteration on the OE config through the fused path (plain K3
    and K4) issues no RuntimeWarning and moves the params;
    evaluate_policy's fused backend runs on speed and on a random start,
    and agrees with the engine's in a deterministic OE episode's mean to
    the noise of its draws."""
    import warnings

    cfg = dataclasses.replace(config.oe_env_config(num_trajectories=N, n_steps=8), normalise_observation_space=True,
                              normalise_action_space=True)
    pcfg = ppo.PPOConfig(hidden=(16, 16), n_epochs=1, n_minibatches=2, shuffle=False, fused_rollout=True,
                         fused_update=True, fused_compute_dtype="float32")
    ts = ppo.init_train_state(cfg, pcfg, 0, device="cpu")
    before = [p.detach().clone() for p in ts.params.parameters()]
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        new_ts, metrics = ppo.train_iteration(cfg, pcfg, ts, 1)
    assert all(np.isfinite(float(v)) for v in metrics.values()), metrics
    assert any(not torch.equal(a, b) for a, b in zip(before, new_ts.params.parameters()))
    late = dataclasses.replace(config.as_env_config(num_trajectories=N, n_steps=8), start_time=("uniform", 0.0, 0.5),
                               normalise_observation_space=True, normalise_action_space=True)
    late_ts = ppo.init_train_state(late, pcfg, 0, device="cpu")
    for env_cfg, params in ((cfg, new_ts.params), (late, late_ts.params)):
        fused = float(ppo.evaluate_policy(env_cfg, params, 3, n_episodes=2, backend="fused"))
        engine = float(ppo.evaluate_policy(env_cfg, params, 3, n_episodes=2, backend="engine"))
        assert np.isfinite(fused) and np.isfinite(engine)


def test_convert_round_trips_at_one_action():
    """An A = 1 actor-critic (the OE family's) crosses between the
    packages both ways, exactly, in both layouts."""
    for shared in (True, False):
        params, model = _params(_oe(), 4, shared_trunk=shared)
        tree = convert.actor_critic_to_numpy(model)
        assert_trees_close(tree, jax_numpy_tree(params), rtol=0, atol=0)
        back = convert.actor_critic_from_numpy(tree, device="cpu")
        assert (back.obs_dim, back.action_dim, back.shared_trunk) == (5, 1, shared)
        for (name, a), (_, b) in zip(model.named_parameters(), back.named_parameters()):
            assert torch.equal(a, b), name
