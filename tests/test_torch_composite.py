"""The composite stress family and every process kind of the rollout
kernels through mbt_gym_torch, against the JAX package run as its own
tests run it on the CPU (Pallas in interpret mode, injected noise from a
numpy seed): ``composite_env_config`` on the engine in float64; K3's plain
version on the composite config, the all-axes config and each kind of
tests/test_pallas_rollout.py:1079-1484; K5's plain version on the fixed,
table and schedule kinds (tests/test_pallas_rollout.py:1834-1968) and the
impact kinds; the native draws' extra channels; the dispatch routing and
the fallback reasons against ``mbt_gym_tpu.dispatch``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import enable_x64

import mbt_gym_tpu.processes as jp
from mbt_gym_tpu import dispatch as jax_dispatch
from mbt_gym_tpu.agents import baseline as jax_baseline
from mbt_gym_tpu.ops import pallas_rollout as pr
from mbt_gym_tpu.rewards import CjMmCriterion as JaxCjMm
from mbt_gym_tpu.rewards import CjOeCriterion as JaxCjOe
from mbt_gym_tpu.rewards import ExponentialUtility as JaxExponentialUtility
from mbt_gym_tpu.rollout import rollout as jax_rollout
from mbt_gym_tpu.types import SlotNoise as JaxSlotNoise
from mbt_gym_tpu.utils import config as jax_config

from mbt_gym_torch import dispatch
from mbt_gym_torch.agents import baseline
from mbt_gym_torch.ops import det_rollout as det
from mbt_gym_torch.ops import mlp_rollout as mr
from mbt_gym_torch.ops import proc_kinds as pk
from mbt_gym_torch.rollout import rollout
from mbt_gym_torch.types import SlotNoise
from mbt_gym_torch.utils import config
from tests.test_torch_det_rollout import _assert_stats_match_jax, _assert_streams_match_jax
from tests.test_torch_env import torch_config
from tests.test_torch_lam_touch import _assert_k3_close, _k3_both

N, T = 128, 12


def _with(cfg, **dyn):
    return dataclasses.replace(cfg, dynamics=dataclasses.replace(cfg.dynamics, **dyn))


# ------------------------------------------------------------ the engine
def test_composite_config_matches_jax():
    jcfg = jax_config.composite_env_config(num_trajectories=N)
    cfg = config.composite_env_config(num_trajectories=N)
    assert cfg == torch_config(jcfg)
    assert (cfg.state_dim, cfg.action_dim, cfg.num_trajectories) == (8, 4, N)
    assert config.composite_env_config().num_trajectories == 65536
    for got, want in zip(cfg.observation_bounds(), jcfg.observation_bounds()):
        np.testing.assert_array_equal(got, want)


def test_composite_engine_matches_jax_engine_float64():
    """The engine on the composite config in float64, the same fixed
    action and injected noise (every slot's columns from one numpy seed):
    inventory exact, the rest to the golden tolerances; the Hawkes
    intensities and the exogenous depths move and market orders fire.  20
    steps over a tenth of the horizon keep the config's dt (at dt = 0.05
    the Hawkes recursion is unstable)."""
    jcfg = jax_config.composite_env_config(num_trajectories=N, terminal_time=0.1, n_steps=20, dtype="float64")
    cfg = torch_config(jcfg)
    action = [0.6, 0.6, 0.0, 0.7]
    rng = np.random.default_rng(8)
    cols = []
    for _, proc in jcfg.dynamics.processes():
        n_norm, n_unif = proc.noise_spec()
        cols.append((rng.normal(size=(20, N, n_norm)) if n_norm else None,
                     rng.uniform(size=(20, N, n_unif)) if n_unif else None))
    with enable_x64():
        jres = jax_rollout(jcfg, jax_baseline.fixed_action_policy(action), None, jax.random.PRNGKey(0),
                           noise=tuple(JaxSlotNoise(*c) for c in cols))
        want = {k: np.asarray(v) for k, v in jres.trajectory._asdict().items()}
    res = rollout(cfg, baseline.fixed_action_policy(action), None, 0, noise=tuple(SlotNoise(*c) for c in cols),
                  backend="engine", device="cpu")
    got = {k: v.numpy() for k, v in res.trajectory._asdict().items()}
    obs = got["observations"]
    assert obs.shape == (21, N, 8) and obs.dtype == np.float64
    assert obs[..., 4:6].std() > 1.0 and obs[..., 6:8].std() > 0.001
    np.testing.assert_array_equal(obs[..., 1], want["observations"][..., 1])
    np.testing.assert_allclose(obs[..., 3:], want["observations"][..., 3:], rtol=0, atol=1e-12)
    np.testing.assert_allclose(obs[..., 0], want["observations"][..., 0], rtol=0, atol=1e-9)
    np.testing.assert_allclose(got["rewards"], want["rewards"], rtol=0, atol=1e-9)


# ------------------------------------------------------------ K3
def _composite(**kw):
    return dataclasses.replace(jax_config.composite_env_config(num_trajectories=N), n_steps=T,
                               normalise_observation_space=True, **kw)


def _as(mid=None, **dyn):
    """The AS config with other processes, normalised (raw observations
    for the constant midprice, whose bounds are degenerate: K3's float32
    path)."""
    base = jax_config.as_env_config(num_trajectories=N, n_steps=T)
    if mid is not None:
        dyn["midprice_model"] = mid
    return dataclasses.replace(_with(base, **dyn), normalise_observation_space=not isinstance(mid, jp.ConstantMidprice),
                               normalise_action_space=True)


_OU_ALPHA = jp.OuMidprice(initial_price=0.5, mean_reversion_level=0.0, mean_reversion_speed=2.0, volatility=1.0,
                          dt_scaled_drift=True)
MIDPRICES = {
    "constant": jp.ConstantMidprice(initial_price=100.0),
    "gbm": jp.GeometricBrownianMotionMidprice(drift=0.5, volatility=0.02, initial_price=100.0),
    "ou": jp.OuMidprice(mean_reversion_level=100.0, mean_reversion_speed=2.0, volatility=2.0, initial_price=100.0),
    "cev": jp.CevMidprice(drift=0.2, volatility=0.05, gamma=0.7, initial_price=100.0),
    "bmjump": jp.BrownianMotionJumpMidprice(volatility=2.0, jump_size=0.5, initial_price=100.0),
    "oujump": jp.OuJumpMidprice(mean_reversion_level=100.0, mean_reversion_speed=2.0, volatility=2.0,
                                jump_size=0.5, initial_price=100.0, dt_scaled_drift=True),
    "heston": jp.HestonMidprice(),
    "st_ou_alpha": jp.ShortTermOuAlphaMidprice(volatility=2.0, ou=_OU_ALPHA),
    "st_jump_alpha": jp.ShortTermJumpAlphaMidprice(
        volatility=2.0, ou_jump=jp.OuJumpMidprice(initial_price=0.5, mean_reversion_level=0.0,
                                                  mean_reversion_speed=2.0, volatility=1.0, jump_size=0.3,
                                                  dt_scaled_drift=True)),
}
_EXO_BM_GBM = jp.ExogenousMmFill(
    bid_process=jp.BrownianMotionMidprice(initial_price=0.8, drift=0.05, volatility=0.1),
    ask_process=jp.GeometricBrownianMotionMidprice(initial_price=0.8, drift=-0.1, volatility=0.2), fill_exponent=1.5)
K3_CASES = {
    "composite": (lambda: _composite(), 4),
    "all-axes": (lambda: _with(_composite(initial_inventory=(-3, 4), reward_function=JaxCjMm(
        per_step_inventory_aversion=0.01, terminal_inventory_aversion=0.001)), midprice_model=jp.HestonMidprice()), 4),
    "exomm-bm-gbm": (lambda: _with(_composite(), fill_probability_model=_EXO_BM_GBM), 4),
    **{f"mid-{k}": (lambda m=m: _as(m), 2) for k, m in MIDPRICES.items()},
    "poisson-nl": (lambda: _as(arrival_model=jp.PoissonArrivalsNonLinear((140.0, 120.0))), 2),
    "hawkes-limit": (lambda: _as(arrival_model=jp.HawkesArrivals(baseline_arrival_rate=(60.0, 50.0))), 2),
    "triangular": (lambda: _as(fill_probability_model=jp.TriangularFill(max_fill_depth=1.5)), 2),
    "power": (lambda: _as(fill_probability_model=jp.PowerFill(fill_exponent=1.5, fill_multiplier=1.2)), 2),
    "touch-hawkes-ou": (lambda: _with(dataclasses.replace(
        jax_config.touch_env_config(num_trajectories=N, n_steps=T), normalise_observation_space=True),
        arrival_model=jp.HawkesArrivals(), midprice_model=MIDPRICES["ou"]), 2),
}


def _channels(n_ch, seed, n=N, steps=T):
    rng = np.random.default_rng(seed)
    channels = rng.uniform(size=(steps, n_ch, n)).astype(np.float32)
    channels[:, 4:] = rng.normal(size=(steps, n_ch - 4, n)).astype(np.float32)
    return channels


@pytest.mark.parametrize("name", list(K3_CASES))
def test_k3_kinds_plain_match_interpret_pallas(name):
    """K3's plain version against mlp_rollout_pallas(interpret=True) on the
    same params, channels (the JAX layout, per n_noise_channels) and
    initial inventories, at tests/test_pallas_rollout.py:851-854's
    tolerances with the inventory paths exact."""
    make, a_dim = K3_CASES[name]
    jcfg = make()
    s_dim = jcfg.state_dim
    params, model = _params_s(a_dim, s_dim, 23)
    p = mr.rollout_params_from_config(torch_config(jcfg))
    assert p.n_channels == pr.n_noise_channels(a_dim, p.fill_kind == "exomm", p.has_mid2)
    inv0 = None
    if p.inventory_range:
        inv0 = np.random.default_rng(5).integers(*p.inventory_range, size=N).astype(np.float32)
    p, got, want = _k3_both(jcfg, params, model, _channels(p.n_channels, len(name)), inv0=inv0)
    assert len(p.obs_low) == s_dim and not pk.is_plain(p)
    _assert_k3_close(p, got, want, exact_inventory=p.dynamics_kind != "touch")
    if name == "composite":
        assert p.n_channels == 11 and (got[1][:, 2:] > 0.5).any()
    if name == "all-axes":
        assert (s_dim, p.n_channels) == (9, 12)
        for col in range(4, 9):
            assert got[0][:, col].std() > 0, col


def _params_s(a_dim, s_dim, seed):
    from mbt_gym_tpu.agents import networks as jnet

    from mbt_gym_torch import convert
    from tests.test_torch_networks import jax_numpy_tree

    params = jnet.init_actor_critic(jax.random.PRNGKey(seed), s_dim, a_dim, hidden=(16, 16), shared_trunk=True)
    params = dict(params, log_std=params["log_std"] + 0.5)
    return params, convert.actor_critic_from_numpy(jax_numpy_tree(params), device="cpu")


def test_k3_composite_towers_plain_matches_interpret_pallas():
    """The separate pi/vf towers (the stacked-trunk mode) on the composite
    config."""
    from mbt_gym_tpu.agents import networks as jnet

    from mbt_gym_torch import convert
    from tests.test_torch_networks import jax_numpy_tree

    params = jnet.init_actor_critic(jax.random.PRNGKey(4), 8, 4, hidden=(16, 16), shared_trunk=False)
    model = convert.actor_critic_from_numpy(jax_numpy_tree(params), device="cpu")
    p, got, want = _k3_both(_composite(), params, model, _channels(11, 9))
    _assert_k3_close(p, got, want)


def test_k3_native_draws_extend_the_channels():
    """Native mode: the composite's 11 channels are the lam kind's 9, the
    spare sine of counter 1's second pair and the first of counter 3's
    pair; the first 9 keep their bits; the all-axes config appends counter
    3's sine.  Native and injected runs of the plain version agree."""
    lam9 = mr.philox_noise(77, 5, 64, "cpu", 4)
    comp = mr.philox_noise(77, 5, 64, "cpu", 4, exomm=True)
    axes = mr.philox_noise(77, 5, 64, "cpu", 4, exomm=True, mid2=True)
    heston = mr.philox_noise(77, 5, 64, "cpu", 2, mid2=True)
    assert (comp.shape[1], axes.shape[1], heston.shape[1]) == (11, 12, 8)
    assert torch.equal(comp[:, :9], lam9) and torch.equal(axes[:, :11], comp)
    assert torch.equal(heston[:, 7], axes[:, 11])
    for ch in range(9, 12):
        x = axes[:, ch]
        assert abs(float(x.mean())) < 0.2 and abs(float(x.std()) - 1.0) < 0.2
    cfg = dataclasses.replace(config.composite_env_config(num_trajectories=64), n_steps=5,
                              normalise_observation_space=True)
    p = mr.rollout_params_from_config(cfg)
    _, model = _params_s(4, 8, 1)
    native = mr.mlp_rollout(p, model, 77, 64, device="cpu")
    injected = mr.mlp_rollout(p, model, 0, 64, noise=comp)
    for a, b in zip(native, injected):
        assert torch.equal(a, b)


def test_k3_refuses_what_it_does_not_take_by_name():
    """The strict_reference_bug fills and multi-state exogenous sides, as
    in JAX; speed dynamics and the exponential utility, which JAX's K3
    takes, parse to JAX's parameters."""
    comp = jax_config.composite_env_config(num_trajectories=N)
    cases = [
        (_with(comp, fill_probability_model=jp.PowerFill(strict_reference_bug=True)), "strict_reference_bug"),
        (_with(comp, fill_probability_model=jp.TriangularFill(strict_reference_bug=True)), "strict_reference_bug"),
        (_with(comp, fill_probability_model=jp.ExogenousMmFill(
            bid_process=jp.HestonMidprice(), ask_process=jp.OuMidprice())), "multi-state inner processes"),
    ]
    for jcfg, words in cases:
        with pytest.raises(AssertionError, match=words):
            pr.rollout_params_from_config(jcfg)
        with pytest.raises(AssertionError, match=words):
            mr.rollout_params_from_config(torch_config(jcfg))
    jutil = dataclasses.replace(comp, reward_function=JaxExponentialUtility())
    for jcfg in (jax_config.oe_env_config(num_trajectories=N), jutil):
        want = pr.rollout_params_from_config(jcfg)
        got = mr.rollout_params_from_config(torch_config(jcfg))
        assert {f: getattr(want, f) for f in got._fields} == got._asdict()
    assert mr.rollout_params_from_config(torch_config(jutil)).reward_kind == "exp_utility"


# ------------------------------------------------------------ K5
def _det_channels(p, seed, n=N, steps=None):
    rng = np.random.default_rng(seed)
    steps = p.run_steps if steps is None else steps
    channels = rng.uniform(size=(steps, p.n_channels, n)).astype(np.float32)
    channels[:, 4:] = rng.normal(size=(steps, p.n_channels - 4, n)).astype(np.float32)
    return channels


def _check_fields(p, jp_):
    for field, value in p._asdict().items():
        if hasattr(jp_, field):
            assert getattr(jp_, field) == value, field
    assert p.n_channels == pr.n_noise_channels(p.a_dim, p.fill_kind == "exomm", p.has_mid2, table=True)


def _k5_both(run_jax, run_port, p, channels, **kw):
    want = run_jax(noise=jnp.asarray(channels), **kw)
    got = run_port(noise=torch.from_numpy(channels), **kw)
    return got, want


_FIXED_ACTION = {2: [1.0, 0.5], 4: [0.6, 0.6, 0.0, 1.0]}
_NORMALISED_ACTION = {2: [-0.6, -0.4], 4: [-0.6, -0.4, 0.5, -0.5]}


@pytest.mark.parametrize("name", list(K3_CASES))
def test_k5_fixed_kinds_plain_match_interpret_pallas(name):
    """K5's fixed kind on every K3 case's config (the normalised ones with
    a normalised action) against fixed_rollout_pallas(interpret=True):
    streams with the terminal observation, and the stats mode."""
    make, a_dim = K3_CASES[name]
    jcfg = make()
    # raw actions on the composite config (tests/test_pallas_rollout.py:1913)
    # and at the touch (binary post columns); normalised ones elsewhere
    jcfg = dataclasses.replace(jcfg, normalise_action_space=name not in ("composite", "touch-hawkes-ou"))
    action = _NORMALISED_ACTION[a_dim] if jcfg.normalise_action_space else _FIXED_ACTION[a_dim]
    jp_ = pr.fixed_rollout_params(jcfg, action)
    p = det.fixed_rollout_params(torch_config(jcfg), action)
    _check_fields(p, jp_)
    assert not pk.is_plain(p)
    channels = _det_channels(p, 50 + len(name))
    kw = dict(inv0=None)
    if p.inventory_range:
        kw["inv0"] = np.random.default_rng(3).integers(*p.inventory_range, size=N).astype(np.float32)

    def run_jax(**k):
        inv0 = k.pop("inv0")
        return pr.fixed_rollout_pallas(jp_, 0, N, tile=128, interpret=True,
                                       inv0=None if inv0 is None else jnp.asarray(inv0), **k)

    def run_port(**k):
        inv0 = k.pop("inv0")
        return det.fixed_rollout(p, 0, N, inv0=None if inv0 is None else torch.from_numpy(inv0), **k)

    got, want = _k5_both(run_jax, run_port, p, channels, final_obs=True, **kw)
    _assert_streams_match_jax(got, want, p, obs_atol=1e-4, rew_atol=1e-3)
    if not p.inventory_range:
        got, want = _k5_both(run_jax, run_port, p, channels, stats_only=True, **kw)
        _assert_stats_match_jax(got, want)


@pytest.mark.parametrize("fill_name", ["triangular", "power", "hawkes-exp"])
def test_k5_table_other_kinds_plain_match_interpret_pallas(fill_name):
    """tests/test_pallas_rollout.py:1834: the CJ depth table on the
    triangular and power fills (the agent from the exponential-fill base
    config), and on Hawkes arrivals with exponential fills; streams and
    stats."""
    base = jax_config.cj_env_config(num_trajectories=N, n_steps=T, max_inventory=3.0)
    change = {
        "triangular": dict(fill_probability_model=jp.TriangularFill(max_fill_depth=1.5)),
        "power": dict(fill_probability_model=jp.PowerFill(fill_exponent=1.5, fill_multiplier=1.2)),
        "hawkes-exp": dict(arrival_model=jp.HawkesArrivals(baseline_arrival_rate=(80.0, 60.0))),
    }[fill_name]
    jcfg = _with(base, **change)
    jagent = jax_baseline.CarteaJaimungalMmAgent.from_config(base)
    jp_ = pr.cj_rollout_params(jcfg, jagent)
    from tests.test_torch_det_rollout import torch_cj_agent

    agent = torch_cj_agent(jagent)
    p = det.cj_rollout_params(torch_config(jcfg), agent)
    _check_fields(p, jp_)
    jtables = pr.cj_depth_tables(jagent)
    tables = det.cj_depth_tables(agent)
    channels = _det_channels(p, 13)
    got, want = _k5_both(lambda **k: pr.table_rollout_pallas(jp_, *jtables, 0, N, tile=128, interpret=True, **k),
                         lambda **k: det.table_rollout(p, *tables, 0, N, **k), p, channels, final_obs=True)
    _assert_streams_match_jax(got, want, p, obs_atol=1e-5, rew_atol=1e-4)
    got, want = _k5_both(lambda **k: pr.table_rollout_pallas(jp_, *jtables, 0, N, tile=128, interpret=True, **k),
                         lambda **k: det.table_rollout(p, *tables, 0, N, **k), p, channels, stats_only=True)
    _assert_stats_match_jax(got, want)


SPEED_CASES = {
    "power-impact": dict(price_impact_model=jp.TemporaryPowerImpact(temporary_impact_exponent=0.5)),
    "transient": dict(price_impact_model=jp.TransientImpact(resilience_coefficient=0.5,
                                                            linear_kernel_coefficient=0.3)),
    "temp-transient": dict(price_impact_model=jp.TemporaryAndTransientImpact(resilience_coefficient=0.5)),
    "heston": dict(midprice_model=jp.HestonMidprice()),
    "ou": dict(midprice_model=MIDPRICES["ou"]),
    "st-ou-alpha-transient": dict(midprice_model=MIDPRICES["st_ou_alpha"],
                                  price_impact_model=jp.TransientImpact()),
}


@pytest.mark.parametrize("name", list(SPEED_CASES))
def test_k5_speed_kinds_plain_match_interpret_pallas(name):
    """Speed dynamics with the four impact kinds (impact at the pre-update
    state, pallas_rollout.py:1057-1076) and other midprice kinds: the
    CJ-OE schedule and a fixed speed, streams and stats."""
    base = dataclasses.replace(jax_config.oe_env_config(num_trajectories=N), n_steps=T)
    if name != "temp-transient":
        base = dataclasses.replace(base, reward_function=JaxCjOe(per_step_inventory_aversion=0.01,
                                                                   terminal_inventory_aversion=0.01))
    jcfg = _with(base, **SPEED_CASES[name])
    jagent = jax_baseline.CarteaJaimungalOeAgent.from_config(base, alpha=0.01)
    jp_ = pr.schedule_rollout_params(jcfg)
    jtable = pr.schedule_table_from_policy(jcfg, jagent.policy())
    p = det.schedule_rollout_params(torch_config(jcfg))
    _check_fields(p, jp_)
    assert p.dynamics_kind == "speed" and not pk.is_plain(p)
    channels = _det_channels(p, 61)
    for kw in (dict(final_obs=True), dict(stats_only=True)):
        got, want = _k5_both(
            lambda **k: pr.schedule_rollout_pallas(jp_, jtable, 0, N, tile=128, interpret=True, **k),
            lambda **k: det.schedule_rollout(p, np.array(jtable), 0, N, **k), p, channels, **kw)
        if "final_obs" in kw:
            _assert_streams_match_jax(got, want, p, obs_atol=1e-4, rew_atol=1e-3)
        else:
            _assert_stats_match_jax(got, want)
    jfp = pr.fixed_rollout_params(jcfg, [-2.5])
    fp = det.fixed_rollout_params(torch_config(jcfg), [-2.5])
    got, want = _k5_both(lambda **k: pr.fixed_rollout_pallas(jfp, 0, N, tile=128, interpret=True, **k),
                         lambda **k: det.fixed_rollout(fp, 0, N, **k), fp, channels, final_obs=True)
    _assert_streams_match_jax(got, want, fp, obs_atol=1e-4, rew_atol=1e-3)


def test_k5_native_draws_extend_the_channels():
    """Native mode: the extra normals come from counter 1's third and
    fourth words and its spare sine; K1's five channels keep their bits,
    and the plain version's native and injected runs agree."""
    from mbt_gym_torch.ops import episode

    cfg = dataclasses.replace(config.composite_env_config(num_trajectories=64), n_steps=6)
    p = det.fixed_rollout_params(cfg, [0.6, 0.6, 0.0, 0.0])
    noise = det.philox_noise(p, 9, 6, 64, "cpu")
    assert noise.shape == (6, 7, 64)
    assert torch.equal(noise[:, :5], episode.philox_noise(9, 6, 64, "cpu"))
    heston = det.fixed_rollout_params(_torch_with(cfg, midprice_model=torch_config(
        _with(jax_config.composite_env_config(num_trajectories=64), midprice_model=jp.HestonMidprice()))
        .dynamics.midprice_model), [0.6, 0.6, 0.0, 0.0])
    axes = det.philox_noise(heston, 9, 6, 64, "cpu")
    assert axes.shape == (6, 8, 64) and torch.equal(axes[:, :7], noise)
    native = det.fixed_rollout(p, 9, 64, final_obs=True, device="cpu")
    injected = det.fixed_rollout(p, 0, 64, noise=noise, final_obs=True)
    for a, b in zip(native, injected):
        assert torch.equal(a, b)


def _torch_with(cfg, **dyn):
    return dataclasses.replace(cfg, dynamics=dataclasses.replace(cfg.dynamics, **dyn))


def test_k5_refuses_what_it_does_not_take_by_name():
    comp = config.composite_env_config(num_trajectories=N)
    jcomp = jax_config.composite_env_config(num_trajectories=N)
    strict = torch_config(_with(jcomp, fill_probability_model=jp.PowerFill(strict_reference_bug=True)))
    with pytest.raises(AssertionError, match="strict_reference_bug fills"):
        det.fixed_rollout_params(strict, [0.6, 0.6, 0.0, 0.0])
    # the exponential utility, which JAX's K5 takes, runs: the same stats
    # as the interpret-mode kernel
    jutil = dataclasses.replace(jcomp, reward_function=JaxExponentialUtility(risk_aversion=0.01))
    util = det.fixed_rollout_params(torch_config(jutil), [0.6, 0.6, 0.0, 0.0])
    assert util.reward_kind == "exp_utility" and util.risk_aversion == 0.01
    channels = _det_channels(util, 5)
    want = pr.fixed_rollout_pallas(pr.fixed_rollout_params(jutil, [0.6, 0.6, 0.0, 0.0]), 0, N, tile=128,
                                   interpret=True, noise=jnp.asarray(channels), stats_only=True)
    _assert_stats_match_jax(det.fixed_rollout(util, 0, N, noise=torch.from_numpy(channels), stats_only=True), want)
    jump = torch_config(_with(jax_config.oe_env_config(num_trajectories=N), midprice_model=jp.OuJumpMidprice()))
    with pytest.raises(AssertionError, match="fill-driven midprice jumps have no fills"):
        det.schedule_rollout_params(jump)
    # the schedule kind on the composite lam config runs, as in JAX: a
    # constant schedule is the fixed kind's episode
    p = det.schedule_rollout_params(comp)
    channels = torch.from_numpy(_det_channels(p, 6))
    table = torch.tensor([[0.6, 0.6, 0.0, 0.0]]).expand(comp.n_steps, 4).contiguous()
    got = det.schedule_rollout(p, table, 0, N, noise=channels, stats_only=True)
    want = det.fixed_rollout(det.fixed_rollout_params(comp, [0.6, 0.6, 0.0, 0.0]), 0, N, noise=channels,
                             stats_only=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ------------------------------------------------------------ dispatch
def test_composite_fixed_routes_to_k5_as_in_jax():
    """tests/test_dispatch.py:45-63: composite_env_config with the fixed
    quotes (0.6, 0.6, 0, 0) goes to the fixed family in both modes, with
    the JAX reason word for word; the CJ table on exact-probability
    Poisson arrivals too."""
    jcfg = jax_config.composite_env_config(num_trajectories=N)
    cfg = torch_config(jcfg)
    for mode in ("rollout", "stats"):
        want = jax_dispatch.dispatch_report(jcfg, jax_baseline.fixed_action_policy([0.6, 0.6, 0.0, 0.0]), mode=mode,
                                            platform="tpu")
        got = dispatch.dispatch_report(cfg, baseline.fixed_action_policy([0.6, 0.6, 0.0, 0.0]), mode=mode,
                                       platform="cuda")
        assert got == dispatch.DispatchDecision("fused", "fixed", "config and policy match the fixed kernel contract")
        assert (want.backend, want.family, want.reason) == ("fused", got.family, got.reason)
    exact = torch_config(_with(jax_config.cj_env_config(num_trajectories=N, max_inventory=10.0),
                               arrival_model=jp.PoissonArrivalsNonLinear((140.0, 140.0))))
    agent = baseline.CarteaJaimungalMmAgent.from_config(exact, max_inventory=10)
    got = dispatch.dispatch_report(exact, agent.policy(), mode="stats", platform="cuda")
    assert (got.backend, got.family) == ("fused", "cj_table")


def test_unported_features_fall_back_with_their_names():
    """What the kernels still refuse runs on the engine, the reason naming
    it: the strict_reference_bug fills (as in JAX) and K4 beyond S = 8 in
    the PPO update.  The exponential utility on K5 takes JAX's fused
    decision and reason, and K3's evaluate family takes speed dynamics."""
    from mbt_gym_torch.agents import ppo
    from mbt_gym_torch.agents.networks import init_actor_critic

    jcomp = jax_config.composite_env_config(num_trajectories=N)
    strict = _with(jcomp, fill_probability_model=jp.TriangularFill(strict_reference_bug=True))
    for mode in ("rollout", "stats"):
        want = jax_dispatch.dispatch_report(strict, jax_baseline.fixed_action_policy([0.6, 0.6, 0.0, 0.0]),
                                            mode=mode, platform="tpu")
        got = dispatch.dispatch_report(torch_config(strict), baseline.fixed_action_policy([0.6, 0.6, 0.0, 0.0]),
                                       mode=mode, platform="cuda")
        assert (want.backend, got.backend) == ("xla", "engine")
        for reason in (want.reason, got.reason):
            assert "strict_reference_bug fills are an" in reason
    jutil = dataclasses.replace(jcomp, reward_function=JaxExponentialUtility())
    want = jax_dispatch.dispatch_report(jutil, jax_baseline.fixed_action_policy([0.6, 0.6, 0.0, 0.0]),
                                        platform="tpu")
    got = dispatch.dispatch_report(torch_config(jutil), baseline.fixed_action_policy([0.6, 0.6, 0.0, 0.0]),
                                   platform="cuda")
    assert tuple(got) == tuple(want) == ("fused", "fixed", "config and policy match the fixed kernel contract")
    oe = config.oe_env_config(num_trajectories=N)
    got = dispatch.dispatch_report(oe, ppo.deterministic_policy(oe), mode="evaluate", platform="cuda")
    assert (got.backend, got.family) == ("fused", "mlp_rollout")
    axes = torch_config(_with(jcomp, midprice_model=jp.HestonMidprice()))
    assert axes.state_dim == 9
    assert ppo.fused_update_refusal(axes) is None
    assert ppo.fused_update_refusal(config.composite_env_config(num_trajectories=N)) is None
    from mbt_gym_torch.ops import fused_ppo

    model = init_actor_critic(0, 9, 4, hidden=(64, 64), shared_trunk=True, device="cpu")
    assert fused_ppo.check_kernel_limits(model, 32, 9, 4, "K4").padded == (64, 64)
    wide = init_actor_critic(0, 17, 4, hidden=(64, 64), shared_trunk=True, device="cpu")
    with pytest.raises(ValueError, match="K4 kernel takes a multiple of 32 samples per step, S <= 16"):
        fused_ppo.check_kernel_limits(wide, 32, 17, 4, "K4")


def _all_axes_learner(n=64):
    from mbt_gym_torch.agents import ppo

    jcfg = dataclasses.replace(_with(jax_config.composite_env_config(num_trajectories=n),
                                     midprice_model=jp.HestonMidprice()), n_steps=8, normalise_observation_space=True)
    fused = ppo.PPOConfig(hidden=(32, 32), n_minibatches=4, n_epochs=1, shuffle=False, shared_trunk=True,
                          fused_rollout=True, fused_update=True)
    return jcfg, fused


def test_fused_update_refuses_a_config_past_the_kernels_limit(monkeypatch):
    """``fused_update`` on a config observing more columns than the update
    kernels take raises ``ValueError`` naming the limit, before anything
    runs, on the fully fused path, on the engine rollout and through
    ``jit_train_iteration``: nothing falls back to autograd.  The kernels'
    limit is cut below the all-axes config's S = 9 here, since K3 refuses
    any config past the real one (S = 16) itself."""
    from mbt_gym_torch import compiled
    from mbt_gym_torch.agents import ppo
    from mbt_gym_torch.ops import fused_ppo

    jcfg, fused = _all_axes_learner()
    cfg = torch_config(jcfg)
    monkeypatch.setattr(fused_ppo, "MAX_S", 8)
    ts = ppo.init_train_state(cfg, fused, 0, device="cpu")
    want = ppo.fused_update_refusal(cfg)
    assert want == "the fused update (K4/K7) takes S <= 8; the config observes S = 9"

    def ran(*args, **kw):
        raise AssertionError("the iteration ran")

    monkeypatch.setattr(ppo, "collect_rollout", ran)
    monkeypatch.setattr(ppo, "_fused_update_body", ran)
    for pcfg in (fused, dataclasses.replace(fused, fused_rollout=False, shuffle=True)):
        with pytest.raises(ValueError, match=r"takes S <= 8; the config observes S = 9"):
            ppo.train_iteration(cfg, pcfg, ts, 3)
        with pytest.raises(ValueError, match=r"takes S <= 8; the config observes S = 9"):
            ppo.check_fused_update(cfg, pcfg)
    ppo.check_fused_update(cfg, dataclasses.replace(fused, fused_update=False))
    monkeypatch.setattr(compiled, "_check_train_args", lambda train_state, key: (key, torch.device("cuda", 0)))
    monkeypatch.setattr(compiled, "_cuda", ran)
    with pytest.raises(ValueError, match=r"takes S <= 8; the config observes S = 9"):
        compiled.train_iteration(cfg, fused, ts, 3)


def test_all_axes_config_trains_fully_fused(monkeypatch):
    """The all-axes config (S = 9) trains fully fused: one iteration with
    fused_rollout and fused_update issues no warning, calls K4 once per
    minibatch (4) on the rollout's env slices and nothing of autograd, and
    each call's grads and metrics are bit for bit the plain K4 on the same
    minibatch."""
    import warnings

    from mbt_gym_torch.agents import ppo
    from mbt_gym_torch.ops import fused_ppo

    jcfg, fused = _all_axes_learner()
    cfg = torch_config(jcfg)
    calls = []
    k4 = fused_ppo.ppo_fused_grads_T

    def recorded(params, *args, **kw):
        out = k4(params, *args, **kw)
        calls.append(([a.clone() for a in args], kw, out))
        return out

    def autograd(*args, **kw):
        raise AssertionError("the autograd update ran")

    monkeypatch.setattr(fused_ppo, "ppo_fused_grads_T", recorded)
    monkeypatch.setattr(ppo, "_ppo_loss", autograd)
    ts = ppo.init_train_state(cfg, fused, 0, device="cpu")
    model = ts.params
    snapshot = [p.detach().clone() for p in model.parameters()]
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        new_ts, metrics = ppo.train_iteration(cfg, fused, ts, 3)
    assert len(calls) == fused.n_minibatches
    obs_t = calls[0][0][0]
    assert obs_t.shape == (cfg.n_steps, 9, cfg.num_trajectories // fused.n_minibatches)
    with torch.no_grad():
        for p, v in zip(model.parameters(), snapshot):
            p.copy_(v)
    for args, kw, (grads, mb_metrics) in calls[:1]:  # the first minibatch sees the initial params
        want_g, want_m = fused_ppo.ppo_fused_grads_T_plain(model, *args, **kw)
        for name in want_g:
            assert torch.equal(grads[name], want_g[name]), name
        for name in want_m:
            assert torch.equal(mb_metrics[name], want_m[name]), name
    assert all(torch.isfinite(v).all() for v in metrics.values())
