"""mbt_gym_torch.gym_compat against the JAX package's adapters: the spaces
of `_build_spaces` (limit, touch and lam configs, normalised and reduced),
ActionInfoCalculator bit for bit, the SB3 VecEnv surface and its learn
loop (the port's counterparts of tests/test_sb3_contract.py,
tests/test_gymnasium_vector.py and tests/test_components.py:104-134), the
autoreset conventions, and one adapter step against the port's own
env.step on the same state.  Everything runs on the CPU."""
import dataclasses

import numpy as np
import pytest
import torch

from mbt_gym_tpu import gym_compat as jgc
from mbt_gym_tpu.utils import config as jconfig

from mbt_gym_torch import env as env_lib
from mbt_gym_torch import gym_compat as gc
from mbt_gym_torch.types import INVENTORY_INDEX, TIME_INDEX
from mbt_gym_torch.utils import config

gymnasium = pytest.importorskip("gymnasium")

CPU = "cpu"


def _configs(name, **kw):
    return getattr(jconfig, name)(**kw), getattr(config, name)(**kw)


SPACE_CASES = [
    ("as_env_config", {}, None),
    ("as_env_config", {}, (INVENTORY_INDEX, TIME_INDEX)),
    ("touch_env_config", {}, None),
    ("lam_env_config", {}, None),
    ("lam_env_config", {}, (1, 2, 3)),
    ("learning_env_config", {}, None),
]


@pytest.mark.parametrize("normalise", [False, True])
@pytest.mark.parametrize("name,kw,indices", SPACE_CASES)
def test_spaces_equal_jax(name, kw, indices, normalise):
    jcfg, cfg = _configs(name, num_trajectories=8, **kw)
    if normalise and name != "touch_env_config":
        jcfg = dataclasses.replace(jcfg, normalise_observation_space=True, normalise_action_space=True)
        cfg = dataclasses.replace(cfg, normalise_observation_space=True, normalise_action_space=True)
    want = jgc._build_spaces(jcfg, indices)
    got = gc._build_spaces(cfg, indices)
    for w, g in zip(want, got):
        assert type(w) is type(g)
        if isinstance(w, gymnasium.spaces.Box):
            assert w.dtype == g.dtype and w.shape == g.shape
            np.testing.assert_array_equal(w.low, g.low)
            np.testing.assert_array_equal(w.high, g.high)
        else:
            assert w == g


def test_action_info_calculator_bitwise_equal_jax():
    rng = np.random.default_rng(4)
    n, a, steps = 16, 2, 7
    calcs = (jgc.ActionInfoCalculator(n, a), gc.ActionInfoCalculator(n, a))
    for t in range(steps):
        action = rng.normal(size=(n, a)).astype(np.float32)
        done = t == steps - 1
        want, got = (c.calculate(None, action, None, done) for c in calcs)
        assert want == got  # float values compared exactly
    assert calcs[0]._count == calcs[1]._count == steps - 1


REQUIRED_API = [
    "reset", "step_async", "step_wait", "close", "get_attr", "set_attr",
    "env_method", "env_is_wrapped", "seed", "step", "get_images", "render",
    "getattr_depth_check",
]


@pytest.fixture()
def venv():
    return gc.VecTradingEnv(config.as_env_config(num_trajectories=8, n_steps=5), seed=3, device=CPU)


def test_vecenv_api_surface(venv):
    for name in REQUIRED_API:
        assert callable(getattr(venv, name)), f"VecEnv API missing: {name}"
    for attr in ["num_envs", "observation_space", "action_space", "render_mode", "unwrapped"]:
        assert hasattr(venv, attr)
    assert venv.env_is_wrapped(object) == [False] * 8
    assert venv.env_is_wrapped(object, indices=[1, 3]) == [False, False]
    assert venv.get_attr("num_envs") == [8] * 8
    assert venv.get_attr("n_steps", indices=2) == [5]
    venv.set_attr("render_mode", "human")
    assert venv.get_attr("render_mode", indices=[0, 5]) == ["human", "human"]
    assert len(venv.env_method("seed", 11)) == 8
    assert venv.getattr_depth_check("step_wait", already_found=True) == "mbt_gym_torch.gym_compat.VecTradingEnv"
    assert venv.getattr_depth_check("step_wait", already_found=False) is None
    assert venv.get_images() == [None] * 8 and venv.render() is None and venv.unwrapped is venv


def test_vecenv_episode_autoreset_and_terminal_observation():
    """Two episodes through step_async/step_wait (the SB3 learn loop):
    dones only on the last step, terminal observations stored per env,
    the returned observations already reset."""
    cfg = config.as_env_config(num_trajectories=8, n_steps=5)
    env = gc.VecTradingEnv(cfg, seed=0, device=CPU)
    obs = env.reset()
    assert obs.shape == (8, cfg.state_dim) and obs.dtype == np.float32
    for t in range(2 * cfg.n_steps):
        obs, rewards, dones, infos = env.step(np.full((8, 2), 0.5, dtype=np.float32))
        assert obs.shape == (8, cfg.state_dim) and rewards.shape == (8,) and len(infos) == 8
        terminal = (t % cfg.n_steps) == cfg.n_steps - 1
        assert bool(dones.min()) == terminal == bool(dones.max())
        if terminal:
            term_obs = infos[0]["terminal_observation"]
            assert term_obs.shape == (cfg.state_dim,)
            assert term_obs[TIME_INDEX] == pytest.approx(cfg.terminal_time)
            assert obs[0, TIME_INDEX] == pytest.approx(0.0)
        else:
            assert all("terminal_observation" not in info for info in infos)


def test_vecenv_step_equals_engine_step():
    """One reset and two steps of the adapter equal env.reset/env.step on
    a generator seeded alike: the adapter's generator is the state's noise
    source, consumed in the documented order."""
    cfg = config.as_env_config(num_trajectories=16, n_steps=5)
    env = gc.VecTradingEnv(cfg, seed=9, device=CPU)
    obs = env.reset()
    state, want_obs = env_lib.reset(cfg, torch.Generator().manual_seed(9), device=CPU)
    np.testing.assert_array_equal(obs, want_obs.numpy())
    rng = np.random.default_rng(1)
    for _ in range(2):
        action = rng.uniform(0.2, 2.0, size=(16, 2)).astype(np.float32)
        obs, rewards, dones, _ = env.step(action)
        res = env_lib.step(cfg, state, torch.from_numpy(action))
        state = res.state
        np.testing.assert_array_equal(obs, res.obs.numpy())
        np.testing.assert_array_equal(rewards, res.reward.numpy())
        np.testing.assert_array_equal(dones, res.done.numpy())


def test_vecenv_info_calculator_and_reduced_observations():
    """tests/test_sb3_contract.py's per-step infos and reduced
    observations: empty infos mid-episode, action means over the recorded
    (non-terminal) actions at the end, every emitted array reduced."""
    cfg = config.as_env_config(num_trajectories=4, n_steps=3)
    calc = gc.ActionInfoCalculator(num_trajectories=4, action_dim=2)
    env = gc.VecTradingEnv(cfg, seed=1, info_calculator=calc, observation_indices=(INVENTORY_INDEX, TIME_INDEX),
                           device=CPU)
    assert env.observation_space.shape == (2,)
    assert env.reset().shape == (4, 2)
    seen = []
    for t in range(cfg.n_steps):
        obs, _, _, infos = env.step(np.full((4, 2), float(t + 1), dtype=np.float32))
        assert obs.shape == (4, 2)
        seen.append(infos)
    assert seen[0][0] == {} and seen[1][0] == {}
    assert seen[-1][2]["action_0"] == pytest.approx(1.5) and seen[-1][2]["action_1"] == pytest.approx(1.5)
    assert seen[-1][2]["terminal_observation"].shape == (2,)
    assert calc._count == 0


def test_vecenv_callable_reset_specs_are_evaluated_each_reset():
    """Callable start-time and inventory specs are evaluated on the host at
    every reset (TradingEnvironment.py:257-281) and draw nothing."""
    calls = []

    def inventory():
        calls.append(1)
        return 3.0

    cfg = dataclasses.replace(config.as_env_config(num_trajectories=4, n_steps=4), initial_inventory=inventory,
                              start_time=lambda: 0.5)
    env = gc.VecTradingEnv(cfg, seed=0, device=CPU)
    obs = env.reset()
    np.testing.assert_array_equal(obs[:, INVENTORY_INDEX], 3.0)
    np.testing.assert_allclose(obs[:, TIME_INDEX], 0.5)
    for _ in range(2):
        obs, _, dones, infos = env.step(np.ones((4, 2), np.float32))
    assert dones.all() and len(calls) == 2  # the autoreset evaluated the spec again


def test_gym_adapter_episode_and_info_calculator():
    cfg = config.as_env_config(num_trajectories=4, n_steps=3)
    calc = gc.ActionInfoCalculator(num_trajectories=4, action_dim=2)
    env = gc.GymTradingEnv(cfg, seed=1, info_calculator=calc, device=CPU)
    assert isinstance(env, gymnasium.Env)
    obs, info = env.reset()
    assert obs.shape == (4, 4) and info == {}
    action = np.full((4, 2), 2.0, dtype=np.float32)
    _, _, term, trunc, info = env.step(action)
    assert not term.any() and not trunc.any() and info == [{}] * 4
    env.step(action)
    _, _, term, _, info = env.step(action)
    assert term.all() and info[0]["action_0"] == pytest.approx(2.0)
    reduced = gc.GymTradingEnv(cfg, seed=1, observation_indices=(INVENTORY_INDEX, TIME_INDEX), device=CPU)
    assert reduced.observation_space.shape == (2,) and reduced.reset()[0].shape == (4, 2)


def test_adapters_without_gymnasium(monkeypatch):
    """Where gymnasium does not import: VecTradingEnv works without spaces,
    GymTradingEnv and VectorTradingEnv raise ImportError."""
    monkeypatch.setattr(gc, "gymnasium", None)
    gc._make_vector_trading_env_class.cache_clear()
    try:
        cfg = config.as_env_config(num_trajectories=4, n_steps=2)
        env = gc.VecTradingEnv(cfg, seed=0, device=CPU)
        assert not hasattr(env, "observation_space")
        env.reset()
        env.step(np.ones((4, 2), np.float32))
        with pytest.raises(ImportError, match="gymnasium"):
            gc.GymTradingEnv(cfg, device=CPU)
        with pytest.raises(ImportError, match="gymnasium"):
            gc.VectorTradingEnv
    finally:
        gc._make_vector_trading_env_class.cache_clear()


def _vector_cfg(n_envs=8, n_steps=5):
    return dataclasses.replace(config.as_env_config(num_trajectories=n_envs, n_steps=n_steps),
                               normalise_observation_space=True, normalise_action_space=True)


def test_vector_env_contract_and_next_step_autoreset():
    from gymnasium.vector import AutoresetMode, VectorEnv

    cfg = _vector_cfg()
    env = gc.VectorTradingEnv(cfg, seed=0, device=CPU)
    assert isinstance(env, VectorEnv) and env.metadata["autoreset_mode"] == AutoresetMode.NEXT_STEP
    assert env.observation_space.shape == (8, cfg.state_dim) and env.action_space.shape == (8, cfg.action_dim)
    obs, info = env.reset(seed=3)
    assert obs.shape == (8, cfg.state_dim) and info == {}
    action = np.zeros((8, cfg.action_dim), np.float32)
    for _ in range(cfg.n_steps):
        obs, rew, term, trunc, _ = env.step(action)
        assert rew.shape == (8,) and not trunc.any()
    assert term.all()
    final_time = obs[:, TIME_INDEX].copy()
    obs2, rew2, term2, trunc2, _ = env.step(action)
    assert not term2.any() and not trunc2.any() and (rew2 == 0).all() and rew2.dtype == np.float32
    assert (obs2[:, TIME_INDEX] < final_time).all()
    assert not env.step(action)[2].any()
    env.close()


def test_vector_env_with_gymnasium_wrapper():
    """A real gymnasium consumer accumulates the episode returns through
    the adapter (tests/test_gymnasium_vector.py)."""
    from gymnasium.wrappers.vector import RecordEpisodeStatistics

    cfg = _vector_cfg(n_envs=4, n_steps=6)
    env = RecordEpisodeStatistics(gc.VectorTradingEnv(cfg, seed=0, device=CPU))
    env.reset(seed=5)
    total = np.zeros(4)
    for _ in range(cfg.n_steps):
        _, rew, term, _, infos = env.step(np.zeros((4, cfg.action_dim), np.float32))
        total += rew
    assert term.all() and "episode" in infos
    np.testing.assert_allclose(infos["episode"]["r"], total, rtol=1e-5)
    env.close()
