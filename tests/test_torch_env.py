"""mbt_gym_torch env engine against the JAX package's engine.

The same inputs, made with numpy from a seed, go through both packages.
This file also holds the one helper that turns a JAX config or state into
the plain values the port's ``convert`` module takes: the port never sees a
JAX object.
"""
import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax import enable_x64

from mbt_gym_tpu.agents.baseline import AvellanedaStoikovAgent as JaxAgent
from mbt_gym_tpu.env import reset as jax_reset
from mbt_gym_tpu.env import step as jax_step
from mbt_gym_tpu.rollout import rollout as jax_rollout
from mbt_gym_tpu.types import SlotNoise as JaxSlotNoise
from mbt_gym_tpu.utils.config import as_env_config as jax_as_env_config

from mbt_gym_torch import convert
from mbt_gym_torch.agents.baseline import AvellanedaStoikovAgent
from mbt_gym_torch.env import reset, step
from mbt_gym_torch.ops.compat import reference_noise_cube
from mbt_gym_torch.rollout import rollout, to_reference_layout
from mbt_gym_torch.types import SlotNoise
from mbt_gym_torch.utils.config import as_env_config

ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "data" / "golden_as_seed50.npz"


# ----------------------------------------------------------- JAX -> plain
def jax_spec(obj):
    """A JAX config, process, dynamics, reward or agent as plain values:
    ``{"type": class name, field: value, ...}``, nested."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {"type": type(obj).__name__}
        for f in dataclasses.fields(obj):
            out[f.name] = jax_spec(getattr(obj, f.name))
        return out
    if isinstance(obj, tuple):
        return [jax_spec(v) for v in obj]
    return obj


def torch_config(jax_cfg):
    spec = jax_spec(jax_cfg)
    del spec["type"]
    return convert.env_config_from_spec(spec)


def torch_agent(jax_agent):
    return convert.as_agent_from_spec(jax_spec(jax_agent))


def jax_state_numpy(state) -> dict:
    """A JAX EnvState as the keyword arguments of env_state_from_numpy."""
    return dict(
        cash=np.asarray(state.cash),
        inventory=np.asarray(state.inventory),
        time=np.asarray(state.time),
        process_states=[np.asarray(p) for p in state.process_states],
        step=int(state.step),
        initial_inventory=np.asarray(state.initial_inventory),
        start_time=float(state.start_time),
        clip_events=int(state.clip_events),
    )


def channels_noise(channels, slot_noise):
    """(T, 5, N) kernel channels -> a StepNoise of the given SlotNoise type
    for the (midprice, arrivals, fills) slot order (as
    tests/test_pallas_episode.py's _step_noise_from_channels)."""
    return (
        slot_noise(normal=channels[:, 4][..., None], uniform=None),
        slot_noise(normal=None, uniform=np.ascontiguousarray(channels[:, 0:2].transpose(0, 2, 1))),
        slot_noise(normal=None, uniform=np.ascontiguousarray(channels[:, 2:4].transpose(0, 2, 1))),
    )


def random_channels(seed: int, steps: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    channels = rng.uniform(size=(steps, 5, n)).astype(np.float32)
    channels[:, 4] = rng.normal(size=(steps, n)).astype(np.float32)
    return channels


def assert_state_close(got_obs, want_obs):
    """The float32 tolerances of tests/test_pallas_episode.py:201-204:
    inventory exact (a fill flips only at an exp() ULP boundary), cash and
    price to float32 accumulation-order noise over the episode."""
    np.testing.assert_array_equal(got_obs[..., 1], want_obs[..., 1])
    np.testing.assert_allclose(got_obs[..., 0], want_obs[..., 0], rtol=1e-6, atol=1e-3)
    np.testing.assert_allclose(got_obs[..., 3], want_obs[..., 3], rtol=0, atol=1e-3)


# ------------------------------------------------------------------ tests
def test_spec_roundtrip_rebuilds_the_same_config():
    jcfg = dataclasses.replace(
        jax_as_env_config(num_trajectories=256, n_steps=30),
        initial_cash=5.0, initial_inventory=(-2, 3), start_time=("uniform", 0.0, 0.5),
    )
    cfg = torch_config(jcfg)
    assert cfg == dataclasses.replace(
        as_env_config(num_trajectories=256, n_steps=30),
        initial_cash=5.0, initial_inventory=(-2, 3), start_time=("uniform", 0.0, 0.5),
    )
    for got, want in zip(cfg.observation_bounds(), jcfg.observation_bounds()):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(cfg.action_bounds(), jcfg.action_bounds()):
        np.testing.assert_array_equal(got, want)
    assert (cfg.state_dim, cfg.action_dim, cfg.step_size) == (
        jcfg.state_dim, jcfg.action_dim, jcfg.step_size
    )
    assert torch_agent(JaxAgent.from_config(jcfg, 0.2)) == AvellanedaStoikovAgent.from_config(cfg, 0.2)


def test_unported_component_raises():
    spec = jax_spec(jax_as_env_config(num_trajectories=128))
    del spec["type"]
    spec["reward_function"] = {"type": "RunningInventoryPenalty"}
    with pytest.raises(ValueError, match="RunningInventoryPenalty is not ported"):
        convert.env_config_from_spec(spec)


@pytest.mark.parametrize(
    "overrides",
    [{}, {"initial_cash": 5.0, "initial_inventory": 3, "start_time": 0.2}],
    ids=["default", "cash5-inv3-late-start"],
)
def test_engine_matches_jax_engine_per_step_float32(overrides):
    """Same injected noise -> both engines agree at every step, including
    nonzero initial cash/inventory and a late start (the episode shortens
    from 30 to 24 steps)."""
    jcfg = dataclasses.replace(jax_as_env_config(num_trajectories=256, n_steps=30), **overrides)
    cfg = torch_config(jcfg)
    channels = random_channels(11, 30, 256)
    jres = jax_rollout(
        jcfg, JaxAgent.from_config(jcfg, 0.1).policy(), None, jax.random.PRNGKey(0),
        noise=channels_noise(channels, JaxSlotNoise),
    )
    res = rollout(
        cfg, AvellanedaStoikovAgent.from_config(cfg, 0.1).policy(), None, 0,
        noise=channels_noise(channels, SlotNoise), device="cpu",
    )
    want_obs = np.asarray(jres.trajectory.observations)
    got_obs = res.trajectory.observations.numpy()
    assert got_obs.shape == want_obs.shape == (31 - 6 * bool(overrides), 256, 4)
    assert_state_close(got_obs, want_obs)
    # time and actions are the same float32 expressions on the same inputs
    np.testing.assert_array_equal(got_obs[..., 2], want_obs[..., 2])
    np.testing.assert_allclose(
        res.trajectory.actions.numpy(), np.asarray(jres.trajectory.actions), rtol=1e-6, atol=1e-6
    )
    # rewards are differences of ~100-magnitude mark-to-market values
    np.testing.assert_allclose(
        res.trajectory.rewards.numpy(), np.asarray(jres.trajectory.rewards), rtol=0, atol=1e-3
    )
    assert int(res.final_state.clip_events) == int(jres.final_state.clip_events)
    assert int(res.final_state.step) == int(jres.final_state.step)


def test_normalised_spaces_match_jax_engine():
    """Normalised observation and action spaces: a fixed action in [-1, 1]
    is denormalised and the observation normalised by the same float32
    expressions in both engines."""
    from mbt_gym_tpu.agents.baseline import fixed_action_policy as jax_fixed_action_policy

    from mbt_gym_torch.agents.baseline import fixed_action_policy

    jcfg = dataclasses.replace(
        jax_as_env_config(num_trajectories=128, n_steps=20),
        normalise_action_space=True, normalise_observation_space=True,
    )
    cfg = torch_config(jcfg)
    channels = random_channels(13, 20, 128)
    jres = jax_rollout(
        jcfg, jax_fixed_action_policy([-0.6, -0.4]), None, jax.random.PRNGKey(0),
        noise=channels_noise(channels, JaxSlotNoise),
    )
    res = rollout(
        cfg, fixed_action_policy([-0.6, -0.4]), None, 0,
        noise=channels_noise(channels, SlotNoise), device="cpu",
    )
    got, want = res.trajectory.observations.numpy(), np.asarray(jres.trajectory.observations)
    # normalised planes: inventory exact, the rest to float32 rounding
    np.testing.assert_array_equal(got[..., 1], want[..., 1])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        res.trajectory.rewards.numpy(), np.asarray(jres.trajectory.rewards), rtol=0, atol=1e-3
    )


def test_golden_as_trajectories_float64():
    """The float64 engine on the port's own reference_noise_cube reproduces
    the reference implementation's dump at tests/test_golden.py's
    tolerances."""
    golden = np.load(GOLDEN)
    n, n_steps, seed = (int(x) for x in golden["meta"])
    cfg = as_env_config(num_trajectories=n, n_steps=n_steps, dtype="float64")
    agent = AvellanedaStoikovAgent.from_config(cfg, risk_aversion=0.1)
    noise = reference_noise_cube(cfg, seed, dtype="float64")
    res = rollout(cfg, agent.policy(), None, 0, noise=noise, device="cpu")
    obs, actions, rewards = (x.numpy() for x in to_reference_layout(res.trajectory))
    np.testing.assert_array_equal(obs[:, 1, :], golden["observations"][:, 1, :])
    np.testing.assert_allclose(obs[:, 3, :], golden["observations"][:, 3, :], rtol=0, atol=1e-12)
    np.testing.assert_allclose(obs[:, 0, :], golden["observations"][:, 0, :], rtol=0, atol=1e-9)
    np.testing.assert_allclose(actions, golden["actions"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(rewards, golden["rewards"], rtol=0, atol=1e-9)


def test_reference_noise_cube_matches_jax():
    from mbt_gym_tpu.ops.compat import reference_noise_cube as jax_cube

    jcfg = jax_as_env_config(num_trajectories=64, n_steps=10, dtype="float64")
    with enable_x64():
        want = jax_cube(jcfg, 50, dtype="float64")
    got = reference_noise_cube(torch_config(jcfg), 50, dtype="float64")
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)


def test_state_from_numpy_steps_like_jax():
    """A JAX reset state carried across as numpy steps identically."""
    jcfg = dataclasses.replace(
        jax_as_env_config(num_trajectories=128, n_steps=20), initial_cash=2.0, initial_inventory=-4
    )
    cfg = torch_config(jcfg)
    jstate, _ = jax_reset(jcfg, jax.random.PRNGKey(3))
    state = convert.env_state_from_numpy(**jax_state_numpy(jstate), device="cpu")
    channels = random_channels(5, 1, 128)
    action = np.random.default_rng(2).uniform(0.2, 1.5, size=(128, 2)).astype(np.float32)
    jres = jax_step(jcfg, jstate, action, noise=tuple(
        JaxSlotNoise(*(None if x is None else x[0] for x in s))
        for s in channels_noise(channels, JaxSlotNoise)
    ))
    res = step(cfg, state, torch.from_numpy(action), noise=tuple(
        SlotNoise(*(None if x is None else x[0] for x in s))
        for s in channels_noise(channels, SlotNoise)
    ))
    assert_state_close(res.obs.numpy(), np.asarray(jres.obs))
    np.testing.assert_allclose(res.reward.numpy(), np.asarray(jres.reward), rtol=0, atol=1e-4)
    assert bool(res.done[0]) == bool(jres.done[0])


def test_random_start_freeze_matches_jax():
    """A ("uniform", 0.5, 0.5) start is a random-start spec that both
    packages resolve to 0.5: the engine runs the full horizon and freezes
    every step after done, zeroing its reward."""
    jcfg = dataclasses.replace(
        jax_as_env_config(num_trajectories=128, n_steps=20), start_time=("uniform", 0.5, 0.5)
    )
    cfg = torch_config(jcfg)
    channels = random_channels(8, 20, 128)
    jres = jax_rollout(
        jcfg, JaxAgent.from_config(jcfg, 0.1).policy(), None, jax.random.PRNGKey(0),
        noise=channels_noise(channels, JaxSlotNoise),
    )
    res = rollout(
        cfg, AvellanedaStoikovAgent.from_config(cfg, 0.1).policy(), None, 0,
        noise=channels_noise(channels, SlotNoise), device="cpu",
    )
    got, want = res.trajectory.observations.numpy(), np.asarray(jres.trajectory.observations)
    assert got.shape == (21, 128, 4)
    assert_state_close(got, want)
    rewards = res.trajectory.rewards.numpy()
    np.testing.assert_allclose(rewards, np.asarray(jres.trajectory.rewards), rtol=0, atol=1e-3)
    assert not rewards[10:].any()  # frozen after 10 live steps
    np.testing.assert_array_equal(got[11:], np.broadcast_to(got[10], got[11:].shape))


def test_tuple_initial_inventory_and_native_noise_run():
    cfg = dataclasses.replace(as_env_config(num_trajectories=128, n_steps=10), initial_inventory=(-3, 4))
    state, obs = reset(cfg, 4, device="cpu")
    inv = state.inventory.numpy()
    assert inv.min() >= -3 and inv.max() <= 3 and len(np.unique(inv)) > 1
    res = rollout(cfg, AvellanedaStoikovAgent.from_config(cfg).policy(), None, 4, device="cpu")
    assert res.trajectory.observations.shape == (11, 128, 4)
    assert torch.isfinite(res.trajectory.rewards).all()
    again = rollout(cfg, AvellanedaStoikovAgent.from_config(cfg).policy(), None, 4, device="cpu")
    torch.testing.assert_close(again.trajectory.observations, res.trajectory.observations, rtol=0, atol=0)


def test_wrong_shaped_action_raises():
    cfg = as_env_config(num_trajectories=8, n_steps=5)
    state, _ = reset(cfg, 0, device="cpu")
    with pytest.raises(AssertionError, match="Action must have shape"):
        step(cfg, state, torch.zeros((8, 3)))
    with pytest.raises(AssertionError, match="Action must have shape"):
        step(cfg, state, torch.zeros((4, 2)))


def test_default_device_is_cuda():
    """device=None targets the card: without a GPU the entry point raises
    instead of moving to the CPU."""
    cfg = as_env_config(num_trajectories=8, n_steps=5)
    if torch.cuda.is_available():
        state, _ = reset(cfg, 0)
        assert state.cash.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no GPU is visible"):
            reset(cfg, 0)


def test_port_imports_neither_jax_nor_the_jax_package():
    """Importing every module of mbt_gym_torch in a fresh interpreter leaves
    jax and mbt_gym_tpu out of sys.modules, and no file of the port (the
    PPO learner and the K3/K4 modules included) nor chip_smoke.py has an
    import statement naming them."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import mbt_gym_torch\n"
        "for m in pkgutil.walk_packages(mbt_gym_torch.__path__, prefix='mbt_gym_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'mbt_gym_tpu'))\n"
        "print(bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|mbt_gym_tpu)\b"
        r"|(import_module|__import__)\(\s*['\"](jax|jaxlib|mbt_gym_tpu)\b",
        re.M,
    )
    files = sorted((ROOT / "mbt_gym_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    names = {str(f.relative_to(ROOT)) for f in files}
    for module in ("agents/networks.py", "agents/ppo.py", "ops/mlp_rollout.py", "ops/fused_ppo.py"):
        assert f"mbt_gym_torch/{module}" in names, module
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders, offenders
