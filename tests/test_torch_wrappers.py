"""mbt_gym_torch.wrappers against mbt_gym_tpu.wrappers on the same arrays,
and mbt_gym_torch.utils.reward_scaling against the JAX package's reward
normalisation: its dispatch decision, its value under each package's own
RNG, and its contract."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mbt_gym_tpu import dispatch as jax_dispatch
from mbt_gym_tpu import wrappers as jwrappers
from mbt_gym_tpu.agents.baseline import AvellanedaStoikovAgent as JaxAgent
from mbt_gym_tpu.agents.baseline import fixed_action_policy as jax_fixed_action_policy
from mbt_gym_tpu.rewards import AgentStateView as JaxView
from mbt_gym_tpu.rewards import PnL as JaxPnL
from mbt_gym_tpu.rewards import RewardAux as JaxAux
from mbt_gym_tpu.rollout import jit_rollout as jax_jit_rollout
from mbt_gym_tpu.rollout import rollout as jax_rollout
from mbt_gym_tpu.types import SlotNoise as JaxSlotNoise
from mbt_gym_tpu.utils.config import as_env_config as jax_as_env_config
from mbt_gym_tpu.utils.config import cj_env_config as jax_cj_env_config
from mbt_gym_tpu.utils.config import oe_env_config as jax_oe_env_config
from mbt_gym_tpu.utils.reward_scaling import compute_inventory_neutral_reward_scaling as jax_scaling

from mbt_gym_torch import dispatch, wrappers
from mbt_gym_torch.agents.baseline import AvellanedaStoikovAgent, fixed_action_policy
from mbt_gym_torch.rewards import AgentStateView, PnL, RewardAux
from mbt_gym_torch.rollout import rollout
from mbt_gym_torch.types import SlotNoise
from mbt_gym_torch.utils import reward_scaling
from mbt_gym_torch.utils.config import as_env_config, oe_env_config
from tests.test_torch_env import channels_noise, random_channels, torch_config

CONFIGS = {
    "as": lambda: jax_as_env_config(num_trajectories=64, n_steps=10),
    "cj": lambda: jax_cj_env_config(num_trajectories=64, n_steps=10),
    "oe": lambda: jax_oe_env_config(num_trajectories=64, n_steps=10),
}


def _obs(jcfg, seed=0):
    low, high = jcfg.observation_bounds()
    rng = np.random.default_rng(seed)
    return rng.uniform(np.maximum(low, -1e3), np.minimum(high, 1e3), size=(64, len(low))).astype(np.float32)


# ------------------------------------------------------------ wrappers
@pytest.mark.parametrize("indices", [wrappers.DEFAULT_REDUCED_INDICES, (3, 0, 1)], ids=["default", "3-0-1"])
def test_reduce_observation_and_policy_match_jax(indices):
    assert wrappers.DEFAULT_REDUCED_INDICES == jwrappers.DEFAULT_REDUCED_INDICES
    obs = _obs(CONFIGS["as"]())
    want = np.asarray(jwrappers.reduce_observation(jnp.asarray(obs), indices))
    got = wrappers.reduce_observation(torch.from_numpy(obs), indices).numpy()
    np.testing.assert_array_equal(got, want)
    jpol = jwrappers.reduced_obs_policy(lambda p, o, s: o * 2.0, indices)
    pol = wrappers.reduced_obs_policy(lambda p, o, s: o * 2.0, indices)
    np.testing.assert_array_equal(pol(None, torch.from_numpy(obs), None).numpy(),
                                  np.asarray(jpol(None, jnp.asarray(obs), None)))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reduced_bounds_and_normalise_obs_match_jax(name):
    jcfg = CONFIGS[name]()
    cfg = torch_config(jcfg)
    for indices in (wrappers.DEFAULT_REDUCED_INDICES, (0, 3)):
        for got, want in zip(wrappers.reduced_observation_bounds(cfg, indices),
                             jwrappers.reduced_observation_bounds(jcfg, indices)):
            np.testing.assert_array_equal(got, want)
    obs = _obs(jcfg, seed=1)
    for inverse in (False, True):
        want = np.asarray(jwrappers.normalise_obs(jcfg, jnp.asarray(obs), inverse=inverse))
        got = wrappers.normalise_obs(cfg, torch.from_numpy(obs), inverse=inverse).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_terminal_reward_scaling_matches_jax():
    """tests/test_components.py:91-102's values, then random states at a
    mid and a terminal step against the JAX reward, rtol 1e-6."""
    cur = AgentStateView(*[torch.tensor([v]) for v in (0.0, 0.0, 0.0, 100.0)])
    nxt = AgentStateView(*[torch.tensor([v]) for v in (10.0, 0.0, 0.5, 100.0)])
    aux = RewardAux(torch.zeros(1), torch.tensor(1.0))
    wrapped = wrappers.TerminalRewardScaling(base=PnL(), scale=0.1)
    assert float(wrapped.calculate(cur, None, nxt, False, aux)[0]) == pytest.approx(10.0)
    assert float(wrapped.calculate(cur, None, nxt, True, aux)[0]) == pytest.approx(1.0)
    rng = np.random.default_rng(2)
    views = [(rng.normal(size=(4, 32)) * [[10], [3], [0.1], [5]] + [[0], [0], [0.5], [100]]).astype(np.float32)
             for _ in range(2)]
    jwrapped = jwrappers.TerminalRewardScaling(base=JaxPnL(), scale=0.25)
    wrapped = wrappers.TerminalRewardScaling(base=PnL(), scale=0.25)
    for terminal in (False, True):
        want = jwrapped.calculate(JaxView(*map(jnp.asarray, views[0])), None, JaxView(*map(jnp.asarray, views[1])),
                                  terminal, JaxAux(jnp.zeros(32), jnp.asarray(1.0)))
        got = wrapped.calculate(AgentStateView(*map(torch.from_numpy, views[0])), None,
                                AgentStateView(*map(torch.from_numpy, views[1])), terminal,
                                RewardAux(torch.zeros(32), torch.tensor(1.0)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_terminal_reward_scaling_in_the_engine_matches_jax():
    """As a config's reward function, on the same injected noise: only the
    last step's reward is scaled, as in the JAX engine (the engine
    tolerances of tests/test_torch_env.py)."""
    base = jax_as_env_config(num_trajectories=128, n_steps=12)
    jcfg = dataclasses.replace(base, reward_function=jwrappers.TerminalRewardScaling(base=JaxPnL(), scale=0.1))
    cfg = dataclasses.replace(torch_config(base), reward_function=wrappers.TerminalRewardScaling(base=PnL(), scale=0.1))
    channels = random_channels(21, 12, 128)
    jres = jax_rollout(jcfg, JaxAgent.from_config(base, 0.1).policy(), None, jax.random.PRNGKey(0),
                       noise=channels_noise(channels, JaxSlotNoise))
    res = rollout(cfg, AvellanedaStoikovAgent.from_config(cfg, 0.1).policy(), None, 0,
                  noise=channels_noise(channels, SlotNoise), device="cpu")
    np.testing.assert_allclose(res.trajectory.rewards.numpy(), np.asarray(jres.trajectory.rewards), rtol=0, atol=1e-3)
    plain = rollout(torch_config(base), AvellanedaStoikovAgent.from_config(cfg, 0.1).policy(), None, 0,
                    noise=channels_noise(channels, SlotNoise), device="cpu").trajectory.rewards
    torch.testing.assert_close(res.trajectory.rewards[:-1], plain[:-1], rtol=0, atol=0)
    torch.testing.assert_close(res.trajectory.rewards[-1], plain[-1] * 0.1, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------ reward scaling
def _jax_simulation(jcfg, n):
    """The JAX utility's simulation config and policy
    (mbt_gym_tpu/utils/reward_scaling.py:36-45)."""
    k = jcfg.dynamics.fill_probability_model.fill_exponent
    sim = dataclasses.replace(jcfg, start_time=0.0, num_trajectories=n, reward_scaling=None,
                              normalise_action_space=False)
    return sim, jax_fixed_action_policy([1.0 / k, 1.0 / k])


@pytest.mark.parametrize("n", [2048, 131072, 100_000, 1000])
@pytest.mark.parametrize("name", ["as", "cj", "cj-normalised"])
def test_reward_scaling_dispatch_matches_jax(name, n):
    """The simulation goes to K5's fixed kind at a multiple of 128 envs and
    to the engine otherwise (the lane reason), in both packages."""
    jcfg = CONFIGS[name.split("-")[0]]()
    if name.endswith("normalised"):
        jcfg = dataclasses.replace(jcfg, normalise_action_space=True, normalise_observation_space=True)
    jsim, jpol = _jax_simulation(jcfg, n)
    sim, pol = reward_scaling.inventory_neutral_simulation(torch_config(jcfg), n)
    assert sim == torch_config(jsim) and pol.dispatch_meta["action"] == jpol.dispatch_meta["action"]
    want = jax_dispatch.dispatch_report(jsim, jpol, mode="rollout", platform="tpu")
    got = dispatch.dispatch_report(sim, pol, mode="rollout", platform="cuda")
    assert (want.backend == "fused") == (got.backend == "fused") == (n % 128 == 0), (want, got)
    assert want.family == got.family
    if n % 128:
        assert "multiple of 128" in got.reason and "multiple of 128" in want.reason


def _episode_mean_and_se(rewards):
    episodes = rewards.sum(0)
    return float(episodes.mean()), float(episodes.std()) / np.sqrt(episodes.shape[0])


def test_reward_scaling_matches_jax_within_4_standard_errors():
    """Each package under its own RNG at 2,048 trajectories: the inverse
    scalings (the mean inventory-neutral episode reward) agree within 4
    standard errors; the port's K5 fixed kind (its plain version here,
    reached through the fused front door) agrees with its engine the same
    way; and each utility returns 1 / (mean per-step reward * n_steps) of
    its own simulation."""
    jcfg = jax_cj_env_config(num_trajectories=64, n_steps=50)
    cfg = torch_config(jcfg)
    n = 2048
    want = jax_scaling(jcfg, jax.random.PRNGKey(0), n)
    jsim, jpol = _jax_simulation(jcfg, n)
    j_mean, j_se = _episode_mean_and_se(np.asarray(jax_jit_rollout(jsim, jpol, None, jax.random.PRNGKey(0))
                                                   .trajectory.rewards))
    assert 1.0 / want == pytest.approx(j_mean, rel=1e-5)
    got = reward_scaling.compute_inventory_neutral_reward_scaling(cfg, 3, n, device="cpu")
    sim, pol = reward_scaling.inventory_neutral_simulation(cfg, n)
    engine = rollout(sim, pol, None, 3, device="cpu").trajectory.rewards.numpy()
    e_mean, e_se = _episode_mean_and_se(engine)
    assert 1.0 / got == pytest.approx(e_mean, rel=1e-5)
    assert abs(e_mean - j_mean) < 4 * np.hypot(e_se, j_se), (e_mean, e_se, j_mean, j_se)
    decision = dispatch.DispatchDecision("fused", "fixed", "")
    k5 = dispatch.fused_rollout(sim, pol, None, 4, decision, device="cpu").trajectory.rewards.numpy()
    k_mean, k_se = _episode_mean_and_se(k5)
    assert abs(k_mean - e_mean) < 4 * np.hypot(k_se, e_se), (k_mean, k_se, e_mean, e_se)


def test_with_normalised_rewards_scales_episodes_to_about_one():
    """tests/test_components.py:218-232: the returned config scales the
    inventory-neutral episode reward to ~1; the input config is unchanged."""
    cfg = as_env_config(num_trajectories=64, n_steps=50)
    scaled = reward_scaling.with_normalised_rewards(cfg, 0, 4096, device="cpu")
    assert cfg.reward_scaling is None and scaled.reward_scaling is not None and scaled.reward_scaling > 0
    assert dataclasses.replace(scaled, reward_scaling=None) == cfg
    k = cfg.dynamics.fill_probability_model.fill_exponent
    res = rollout(scaled, fixed_action_policy([1 / k, 1 / k]), None, 5, device="cpu")
    assert 0.7 < float(res.trajectory.rewards.sum(dim=0).mean()) < 1.3


def test_reward_scaling_refuses_what_the_reference_refuses():
    with pytest.raises(AssertionError, match="Arrival model must be Poisson and fill probability model must be "
                                             "exponential to scale rewards"):
        reward_scaling.compute_inventory_neutral_reward_scaling(oe_env_config(num_trajectories=64), 0, 128,
                                                                device="cpu")
