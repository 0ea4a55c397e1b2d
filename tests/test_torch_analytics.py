"""mbt_gym_torch.analytics against the JAX package's analytics: every
backtesting, diagnostics and info function on the same float64
trajectory — a JAX AS rollout with 1,000 initial cash (as
tests/test_components.py's fixture), converted — to 1e-12; the known
drawdown path of tests/test_components.py:50-63; the feature-major
TrajectoryT read like its time-major view; plotting where matplotlib
imports."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import enable_x64

from mbt_gym_tpu import jit_rollout
from mbt_gym_tpu.agents.baseline import AvellanedaStoikovAgent as JAgent
from mbt_gym_tpu.analytics import backtesting as jbt
from mbt_gym_tpu.analytics import diagnostics as jdg
from mbt_gym_tpu.analytics import info as jinfo
from mbt_gym_tpu.types import Trajectory as JTrajectory
from mbt_gym_tpu.utils.config import as_env_config as jas_env_config

from mbt_gym_torch.analytics import backtesting, diagnostics, info
from mbt_gym_torch.types import Trajectory, TrajectoryT
from mbt_gym_torch.utils.config import as_env_config

STATS = ("sharpe_ratio", "sortino_ratio", "maximum_drawdown", "portfolio_values", "_return_pcts")


@pytest.fixture(scope="module")
def trajectories():
    """A float64 JAX AS rollout (128 x 50) as numpy, the JAX trajectory
    and the port's Trajectory made from the same arrays."""
    with enable_x64():
        cfg = dataclasses.replace(jas_env_config(num_trajectories=128, n_steps=50), initial_cash=1000.0,
                                  dtype="float64")
        policy = JAgent.from_config(cfg).policy()
        traj = jit_rollout(cfg, policy, None, jax.random.PRNGKey(0)).trajectory
        arrays = tuple(np.array(x) for x in traj)
    assert arrays[0].dtype == np.float64
    return arrays


def _jax(name, module, arrays, **kw):
    with enable_x64():
        traj = JTrajectory(*(jnp.asarray(a) for a in arrays))
        return np.asarray(getattr(module, name)(traj, **kw))


@pytest.mark.parametrize("name", STATS)
def test_backtesting_matches_jax_float64(trajectories, name):
    want = _jax(name, jbt, trajectories)
    got = getattr(backtesting, name)(Trajectory(*(torch.from_numpy(a) for a in trajectories)))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12, equal_nan=True)
    if name == "sortino_ratio":
        assert np.isfinite(want).mean() > 0.9


@pytest.mark.parametrize("name", ["negative_spread_fraction", "max_abs_inventory"])
def test_diagnostics_match_jax_float64(trajectories, name):
    want = _jax(name, jdg, trajectories)
    got = getattr(diagnostics, name)(Trajectory(*(torch.from_numpy(a) for a in trajectories)))
    if name == "negative_spread_fraction":
        # JAX means the bools in float32: the same count, k / (T N) rounded
        quotes = trajectories[1].shape[0] * trajectories[1].shape[1]
        assert round(float(want) * quotes) == round(float(got) * quotes)
        want = round(float(want) * quotes) / quotes
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def test_negative_spread_fraction_counts_negative_quotes():
    actions = torch.tensor([[[0.5, -0.1]], [[0.2, 0.3]]], dtype=torch.float64)
    traj = Trajectory(torch.zeros(3, 1, 4, dtype=torch.float64), actions, torch.zeros(2, 1, dtype=torch.float64))
    assert float(diagnostics.negative_spread_fraction(traj)) == 0.5
    one = Trajectory(traj.observations, actions[..., :1], traj.rewards)
    assert float(diagnostics.negative_spread_fraction(one)) == 0.0


def test_clip_event_count_reads_the_state():
    from mbt_gym_torch import env as env_lib

    cfg = as_env_config(num_trajectories=4, n_steps=3)
    state, _ = env_lib.reset(cfg, 0, device="cpu")
    assert diagnostics.clip_event_count(state) is state.clip_events


@pytest.mark.parametrize("name", ["mean_action_infos", "episode_return_infos"])
def test_infos_match_jax_float64(trajectories, name):
    with enable_x64():
        want = getattr(jinfo, name)(JTrajectory(*(jnp.asarray(a) for a in trajectories)))
    got = getattr(info, name)(Trajectory(*(torch.from_numpy(a) for a in trajectories)))
    assert len(got) == len(want) == 128
    for w, g in zip(want, got):
        flat_w = w.get("episode", w)
        flat_g = g.get("episode", g)
        assert flat_w.keys() == flat_g.keys()
        for key in flat_w:
            assert flat_g[key] == pytest.approx(flat_w[key], rel=1e-12, abs=1e-12)


def test_maximum_drawdown_known_path():
    """100 -> 110 -> 99 -> 120 with the reference's return convention
    (diff / ending value, backtesting.py:23): one drawdown of -11/99."""
    values = np.array([100.0, 110.0, 99.0, 120.0])[:, None]
    obs = np.zeros((4, 1, 4))
    obs[:, :, 0] = values
    obs[:, :, 3] = 100.0
    traj = Trajectory(torch.from_numpy(obs), torch.zeros(3, 1, 2, dtype=torch.float64),
                      torch.zeros(3, 1, dtype=torch.float64))
    assert float(backtesting.maximum_drawdown(traj)[0]) == pytest.approx(-11.0 / 99.0, abs=1e-12)
    with enable_x64():
        jtraj = JTrajectory(jnp.asarray(obs), jnp.zeros((3, 1, 2)), jnp.zeros((3, 1)))
        assert float(jbt.maximum_drawdown(jtraj)[0]) == pytest.approx(float(backtesting.maximum_drawdown(traj)[0]),
                                                                      abs=1e-15)
    x = torch.tensor([[1.0], [3.0], [2.0], [5.0]])
    assert backtesting.jax_running_max is backtesting.running_max
    assert backtesting.running_max(x).flatten().tolist() == [1.0, 3.0, 3.0, 5.0]


def test_feature_major_trajectory_reads_as_its_time_major_view(trajectories):
    obs, actions, rewards = (torch.from_numpy(a) for a in trajectories)
    traj_t = TrajectoryT(obs.permute(2, 0, 1), actions.permute(2, 0, 1), rewards)
    time_major = Trajectory(obs, actions, rewards)
    for fn in (backtesting.sharpe_ratio, backtesting.maximum_drawdown, diagnostics.max_abs_inventory):
        torch.testing.assert_close(fn(traj_t), fn(time_major), rtol=0, atol=0, equal_nan=True)
    assert info.episode_return_infos(traj_t) == info.episode_return_infos(time_major)


def test_float32_trajectory_is_analysed_in_float64(trajectories):
    """A float32 trajectory's statistics are those of its float64 copy
    (the value path is computed in float64)."""
    t32 = Trajectory(*(torch.from_numpy(a.astype(np.float32)) for a in trajectories))
    t64 = Trajectory(*(x.double() for x in t32))
    for name in ("sharpe_ratio", "sortino_ratio", "maximum_drawdown"):
        got = getattr(backtesting, name)(t32)
        assert got.dtype == torch.float64
        torch.testing.assert_close(got, getattr(backtesting, name)(t64), rtol=0, atol=0, equal_nan=True)


def test_plotting_smoke(trajectories):
    pytest.importorskip("matplotlib")
    pytest.importorskip("pandas")
    pytest.importorskip("seaborn")
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from mbt_gym_torch.agents.baseline import AvellanedaStoikovAgent
    from mbt_gym_torch.analytics import plotting

    cfg = as_env_config(num_trajectories=128, n_steps=50)
    traj = Trajectory(*(torch.from_numpy(a.astype(np.float32)) for a in trajectories))
    fig = plotting.plot_trajectory(cfg, traj, max_trajectories=3)
    results, hist, totals = plotting.generate_results_table_and_hist(cfg, traj)
    assert results.loc["Inventory", "Mean spread"] > 0 and totals.shape == (128,)
    policy = AvellanedaStoikovAgent.from_config(cfg).policy()
    slices = plotting.plot_policy_slices(cfg, policy, inventories=(-1, 0, 1), device="cpu")
    compared = plotting.compare_policies(cfg, policy, policy, device="cpu")
    assert len(slices) == len(compared) == 2
    np.testing.assert_allclose(plotting.get_timestamps(cfg)[[0, -1]], [0.0, 1.0])
    for f in [fig, hist, *slices, *compared]:
        plt.close(f)
