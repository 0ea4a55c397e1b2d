"""The at-the-touch and limit-and-market-order dynamics of mbt_gym_torch
against the JAX package: the bookkeeping of tests/test_dynamics.py, the
engine step on the touch, lam and learning configs with injected noise
(float32, and float64 at the golden tolerances), the market-order money
pump and its mask (tests/test_env_features.py:199-271), the config
guards, the reset helpers and the exponential-utility reward."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax import enable_x64

from mbt_gym_tpu import env as jax_env
from mbt_gym_tpu.agents.baseline import fixed_action_policy as jax_fixed_action_policy
from mbt_gym_tpu.rewards import AgentStateView as JaxView
from mbt_gym_tpu.rewards import ExponentialUtility as JaxExponentialUtility
from mbt_gym_tpu.rewards import RewardAux as JaxAux
from mbt_gym_tpu.rollout import rollout as jax_rollout
from mbt_gym_tpu.types import SlotNoise as JaxSlotNoise
from mbt_gym_tpu.utils import config as jax_config

from mbt_gym_torch import env as env_lib
from mbt_gym_torch.agents.baseline import fixed_action_policy
from mbt_gym_torch.dynamics import AtTheTouchDynamics, LimitAndMarketOrderDynamics
from mbt_gym_torch.ops.compat import reference_initial_inventory, reference_noise_cube
from mbt_gym_torch.processes.arrivals import PoissonArrivals
from mbt_gym_torch.processes.fills import ExponentialFill
from mbt_gym_torch.processes.midprice import BrownianMotionMidprice
from mbt_gym_torch.rewards import AgentStateView, ExponentialUtility, RewardAux
from mbt_gym_torch.rollout import rollout
from mbt_gym_torch.types import SlotNoise
from mbt_gym_torch.utils import config
from tests.test_torch_env import jax_spec, random_channels, torch_config

MID = 100.0
N3 = 3
CASH = torch.zeros(N3, dtype=torch.float64)
INV = torch.zeros(N3, dtype=torch.float64)
MIDPRICE = torch.full((N3,), MID, dtype=torch.float64)


def _t(rows):
    return torch.tensor(rows, dtype=torch.float64)


# ------------------------------------------------------------ bookkeeping
def test_at_the_touch_bookkeeping():
    """tests/test_dynamics.py:47: the fills ARE the action; both sides
    filled buy at 99.5 and sell at 100.5."""
    dyn = AtTheTouchDynamics(
        midprice_model=BrownianMotionMidprice(), arrival_model=PoissonArrivals(), fixed_market_half_spread=0.5,
    )
    action = _t([[1.0, 1.0], [0.0, 0.0], [1.0, 0.0]])
    _, fills = dyn.get_arrivals_and_fills(
        {}, action, {"arrival_model": SlotNoise(normal=None, uniform=torch.zeros((N3, 2), dtype=torch.float64))},
        0.01,
    )
    assert torch.equal(fills, action)
    cash, inv = dyn.update_agent(CASH, INV, MIDPRICE, {}, action, torch.ones((N3, 2), dtype=torch.float64),
                                 action, 0.01)
    np.testing.assert_allclose(cash.numpy(), [1.0, 0.0, -99.5], atol=1e-12)
    np.testing.assert_allclose(inv.numpy(), [0.0, 0.0, 1.0])
    assert dyn.required_processes() == ("arrival_model",)
    assert dyn.action_bounds() == ((0.0, 0.0), (1.0, 1.0)) and dyn.action_dim == 2


def test_limit_and_market_order_bookkeeping():
    """tests/test_dynamics.py:66: a market order fires above 0.5, buying at
    mid + half-spread and selling at mid - half-spread."""
    dyn = LimitAndMarketOrderDynamics(
        midprice_model=BrownianMotionMidprice(), arrival_model=PoissonArrivals(),
        fill_probability_model=ExponentialFill(), fixed_market_half_spread=0.5,
    )
    zeros = torch.zeros((N3, 2), dtype=torch.float64)
    action = _t([[0.5, 0.5, 1.0, 0.0], [0.5, 0.5, 0.0, 1.0], [0.5, 0.5, 0.4, 0.4]])
    cash, inv = dyn.update_agent(CASH, INV, MIDPRICE, {}, action, zeros, zeros, 0.01)
    np.testing.assert_allclose(inv.numpy(), [1.0, -1.0, 0.0])
    np.testing.assert_allclose(cash.numpy(), [-(MID + 0.5), MID - 0.5, 0.0], atol=1e-12)
    # the market orders first, then the limit bookkeeping of the same step
    arrivals = torch.ones((N3, 2), dtype=torch.float64)
    cash, inv = dyn.update_agent(CASH, INV, MIDPRICE, {}, action, arrivals, arrivals, 0.01)
    np.testing.assert_allclose(inv.numpy(), [1.0, -1.0, 0.0])
    np.testing.assert_allclose(cash.numpy(), [-(MID + 0.5) + 1.0, MID - 0.5 + 1.0, 1.0], atol=1e-12)
    lo, hi = dyn.action_bounds()
    assert lo == (0.0,) * 4 and hi == (dyn.fill_probability_model.max_depth,) * 2 + (1.0, 1.0)
    assert dyn.required_processes() == ("arrival_model", "fill_probability_model")


@pytest.mark.parametrize("name", ["touch", "lam"])
def test_bookkeeping_matches_jax_on_random_inputs(name):
    """tests/test_dynamics.py:101's families on random float64 inputs: the
    port's update_agent equals the JAX package's bit for bit."""
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    n = 64
    jcfg = {"touch": jax_config.touch_env_config, "lam": jax_config.lam_env_config}[name](num_trajectories=n)
    cfg = torch_config(jcfg)
    a_dim = cfg.action_dim
    cash, inv = rng.normal(size=n) * 10, rng.integers(-5, 6, size=n).astype(np.float64)
    mid = 100 + rng.normal(size=n)
    action = rng.uniform(0, 1.2, size=(n, a_dim))
    arrivals = (rng.uniform(size=(n, 2)) < 0.5).astype(np.float64)
    fills = (rng.uniform(size=(n, 2)) < 0.5).astype(np.float64) if name == "lam" else action[:, :2]
    with enable_x64():
        want = jcfg.dynamics.update_agent(*(jnp.asarray(x) for x in (cash, inv, mid)), {}, jnp.asarray(action),
                                          jnp.asarray(arrivals), jnp.asarray(fills), 0.01)
        want = [np.asarray(w) for w in want]
    got = cfg.dynamics.update_agent(*(torch.from_numpy(x) for x in (cash, inv, mid)), {}, torch.from_numpy(action),
                                    torch.from_numpy(arrivals), torch.from_numpy(fills), 0.01)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


# ------------------------------------------------------------ engine step
def slot_noise(cfg, channels, cls):
    """(T, 5, N) channels as the config's StepNoise of ``cls`` in slot order:
    the midprice normal, the arrival uniforms, the fill uniforms (touch
    dynamics have no fill slot)."""
    slots = [cls(normal=channels[:, 4][..., None], uniform=None),
             cls(normal=None, uniform=np.ascontiguousarray(channels[:, 0:2].transpose(0, 2, 1)))]
    if cfg.dynamics.fill_probability_model is not None:
        slots.append(cls(normal=None, uniform=np.ascontiguousarray(channels[:, 2:4].transpose(0, 2, 1))))
    return tuple(slots)


CONFIGS = {
    "touch": (lambda **kw: jax_config.touch_env_config(**kw), [1.0, 0.6]),
    "lam": (lambda **kw: jax_config.lam_env_config(**kw), [0.4, 0.9, 0.7, 0.2]),
    "lam-mask": (lambda **kw: dataclasses.replace(jax_config.lam_env_config(**kw), max_inventory=2.0,
                                                  mask_market_orders_at_max_inventory=True), [0.4, 0.9, 0.9, 0.0]),
    "learning": (lambda **kw: dataclasses.replace(jax_config.learning_env_config(num_trajectories=kw["num_trajectories"]),
                                                  n_steps=kw["n_steps"], initial_inventory=2), [0.3, 0.8, 0.0, 0.6]),
}


def _rollouts(name, n, steps, dtype="float32", seed=11):
    make, action = CONFIGS[name]
    jcfg = dataclasses.replace(make(num_trajectories=n, n_steps=steps), dtype=dtype)
    cfg = torch_config(jcfg)
    channels = random_channels(seed, steps, n).astype(dtype)
    with enable_x64(dtype == "float64"):
        jres = jax_rollout(jcfg, jax_fixed_action_policy(action), None, jax.random.PRNGKey(0),
                           noise=slot_noise(jcfg, channels, JaxSlotNoise))
        want = {k: np.asarray(v) for k, v in jres.trajectory._asdict().items()}
        want_final = np.asarray(jres.final_state.inventory), np.asarray(jres.final_state.cash)
    res = rollout(cfg, fixed_action_policy(action), None, 0, noise=slot_noise(cfg, channels, SlotNoise),
                  backend="engine", device="cpu")
    got = {k: v.numpy() for k, v in res.trajectory._asdict().items()}
    return jcfg, got, want, (res.final_state.inventory.numpy(), res.final_state.cash.numpy()), want_final


@pytest.mark.parametrize("name", list(CONFIGS))
def test_engine_matches_jax_engine_float32(name):
    """Same injected noise and fixed action -> both engines agree at every
    step (tests/test_pallas_episode.py:201-204's float32 tolerances): the
    inventory exactly, cash and price to accumulation-order noise; on
    lam-mask the market orders hit the boundary and are blocked."""
    _, got, want, final, want_final = _rollouts(name, 256, 30)
    assert got["observations"].shape == want["observations"].shape
    np.testing.assert_array_equal(got["observations"][..., 1], want["observations"][..., 1])
    np.testing.assert_allclose(got["observations"], want["observations"], rtol=1e-6, atol=1e-3)
    np.testing.assert_array_equal(got["actions"], want["actions"])
    np.testing.assert_allclose(got["rewards"], want["rewards"], rtol=0, atol=1e-3)
    np.testing.assert_array_equal(final[0], want_final[0])
    if name == "lam-mask":
        assert np.abs(want["observations"][..., 1]).max() == 2.0


def test_engine_float64_golden_tolerances_on_lam():
    """Float64 on lam with the reference's per-process noise streams: the
    port's engine reaches the North star's golden tolerances against the
    JAX engine — inventory exact, price 1e-12, cash and rewards 1e-9."""
    jcfg = jax_config.lam_env_config(num_trajectories=128, n_steps=50, dtype="float64")
    cfg = torch_config(jcfg)
    from mbt_gym_tpu.ops.compat import reference_noise_cube as jax_cube

    action = [0.4, 0.9, 0.7, 0.2]
    with enable_x64():
        jnoise = jax_cube(jcfg, 50, dtype="float64")
        jres = jax_rollout(jcfg, jax_fixed_action_policy(action), None, jax.random.PRNGKey(0), noise=jnoise)
        want_obs, want_rew = np.asarray(jres.trajectory.observations), np.asarray(jres.trajectory.rewards)
    noise = reference_noise_cube(cfg, 50, dtype="float64")
    res = rollout(cfg, fixed_action_policy(action), None, 0, noise=noise, backend="engine", device="cpu")
    obs, rew = res.trajectory.observations.numpy(), res.trajectory.rewards.numpy()
    assert obs.dtype == np.float64
    np.testing.assert_array_equal(obs[..., 1], want_obs[..., 1])
    np.testing.assert_allclose(obs[..., 3], want_obs[..., 3], rtol=0, atol=1e-12)
    np.testing.assert_allclose(obs[..., 0], want_obs[..., 0], rtol=0, atol=1e-9)
    np.testing.assert_allclose(rew, want_rew, rtol=0, atol=1e-9)


# ------------------------------------------------------------ market orders
def _sell_mo_every_step(params, obs, state):
    n = obs.shape[0]
    cols = [torch.full((n,), 30.0)] * 2 + [torch.zeros(n), torch.ones(n)]
    return torch.stack(cols, dim=1).to(obs.dtype)


def test_market_order_money_pump_is_reference_faithful():
    """tests/test_env_features.py:199: market orders pass at max inventory
    and the independent clips keep their cash, so selling every step pumps
    ~best_bid of PnL per pinned step."""
    cfg = dataclasses.replace(config.learning_env_config(num_trajectories=4), max_inventory=3.0)
    res = rollout(cfg, _sell_mo_every_step, None, 0, backend="engine", device="cpu")
    np.testing.assert_allclose(res.final_state.inventory.numpy(), -3.0, atol=1e-5)
    total = float(res.trajectory.rewards.sum(dim=0).mean())
    assert total > 0.8 * 99.0 * (cfg.n_steps - 3), total


def test_market_order_mask_closes_money_pump():
    """tests/test_env_features.py:238: with the mask the agent sells only
    the 3 units it can deliver."""
    cfg = dataclasses.replace(config.learning_env_config(num_trajectories=4, initial_inventory=0), max_inventory=3.0,
                              mask_market_orders_at_max_inventory=True)
    res = rollout(cfg, _sell_mo_every_step, None, 0, backend="engine", device="cpu")
    np.testing.assert_allclose(res.final_state.inventory.numpy(), -3.0, atol=1e-5)
    assert abs(float(res.trajectory.rewards.sum(dim=0).mean())) < 400.0
    assert float(res.final_state.cash.max()) < 3.5 * 100.0


def test_config_guards_match_jax():
    """EnvConfig.__post_init__ (mbt_gym_tpu/env.py:96-111): the mask takes
    lam dynamics only, and touch refuses a normalised action space, with
    JAX's messages."""
    for make, change, match in (
        (config.as_env_config, {"mask_market_orders_at_max_inventory": True}, "mask_market_orders"),
        (config.touch_env_config, {"mask_market_orders_at_max_inventory": True}, "mask_market_orders"),
        (config.touch_env_config, {"normalise_action_space": True}, "AtTheTouchDynamics takes binary post"),
    ):
        with pytest.raises(AssertionError, match=match):
            dataclasses.replace(make(num_trajectories=4), **change)
        with pytest.raises(AssertionError, match=match):
            jmake = getattr(jax_config, make.__name__)
            dataclasses.replace(jmake(num_trajectories=4), **change)
    cfg = dataclasses.replace(config.lam_env_config(num_trajectories=4), mask_market_orders_at_max_inventory=True,
                              normalise_action_space=True)
    assert cfg.mask_market_orders_at_max_inventory


@pytest.mark.parametrize("name", ["touch_env_config", "lam_env_config", "learning_env_config"])
def test_config_factories_match_jax(name):
    """The port's factories build the JAX package's configs, default for
    default, and the spec of the JAX config rebuilds the port's."""
    jcfg = getattr(jax_config, name)(num_trajectories=256)
    cfg = getattr(config, name)(num_trajectories=256)
    assert torch_config(jcfg) == cfg
    spec = jax_spec(jcfg)
    del spec["type"]
    assert spec == {k: v for k, v in jax_spec(cfg).items() if k != "type"}


# ------------------------------------------------------------ helpers
def test_reference_initial_inventory_matches_jax():
    from mbt_gym_tpu.ops.compat import reference_initial_inventory as jax_reference_initial_inventory

    jcfg = jax_config.learning_env_config(num_trajectories=200)
    cfg = torch_config(jcfg)
    for resets in (0, 1, 3):
        want = jax_reference_initial_inventory(jcfg, 50, resets)
        got = reference_initial_inventory(cfg, 50, resets)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    with pytest.raises(AssertionError):
        reference_initial_inventory(config.lam_env_config(num_trajectories=4), 0)


def test_resolve_reset_overrides_matches_jax():
    """Callable specs evaluated once on the host: the start time quantised
    to the grid, the inventory rounded for order-book dynamics, each equal
    to JAX's; a reset with the overrides starts there."""
    def spec(cfg):
        return dataclasses.replace(cfg, start_time=lambda: 0.3071, initial_inventory=lambda: 2.6)

    jcfg = spec(jax_config.lam_env_config(num_trajectories=8, n_steps=20))
    cfg = spec(config.lam_env_config(num_trajectories=8, n_steps=20))
    want = jax_env.resolve_reset_overrides(jcfg)
    got = env_lib.resolve_reset_overrides(cfg)
    assert got[0] == pytest.approx(want[0], abs=0) and got[0] == pytest.approx(0.3)
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].dtype == np.float32 and float(got[1][0]) == 3.0
    state, _ = env_lib.reset(cfg, 0, start_time=got[0], initial_inventory=got[1], device="cpu")
    assert float(state.time[0]) == pytest.approx(0.3) and float(state.inventory[0]) == 3.0
    assert env_lib.resolve_reset_overrides(config.lam_env_config(num_trajectories=8)) == (None, None)
    with pytest.raises(AssertionError, match="Start time is not within"):
        env_lib.resolve_reset_overrides(dataclasses.replace(cfg, start_time=lambda: 1.5))


def test_exponential_utility_matches_jax():
    """tests/test_rewards.py:106: -exp(-gamma * terminal wealth) at the
    terminal step only, equal to JAX's on the same inputs."""
    import jax.numpy as jnp

    rng = np.random.default_rng(8)
    cur, nxt = ([rng.normal(size=16) * s + o for s, o in ((5, 0), (3, 0), (0, 0.5), (1, 100))] for _ in range(2))
    aux = (np.full(16, 2.0), 1.0)
    util = ExponentialUtility(risk_aversion=0.1)
    jutil = JaxExponentialUtility(risk_aversion=0.1)
    for terminal in (False, True):
        got = util.calculate(AgentStateView(*map(torch.from_numpy, cur)), None,
                             AgentStateView(*map(torch.from_numpy, nxt)), terminal,
                             RewardAux(torch.from_numpy(aux[0]), torch.tensor(aux[1])))
        with enable_x64():
            want = jutil.calculate(JaxView(*map(jnp.asarray, cur)), None, JaxView(*map(jnp.asarray, nxt)), terminal,
                                   JaxAux(jnp.asarray(aux[0]), jnp.asarray(aux[1])))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=0)
        assert (got.abs().sum() == 0) != terminal
    np.testing.assert_allclose(got.numpy(), -np.exp(-0.1 * (nxt[0] + nxt[1] * nxt[3])), rtol=1e-12)
