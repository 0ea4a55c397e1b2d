"""mbt_gym_torch.ops.cj_episode (K8) against the JAX package: the plain K8
against cj_episode_pallas in interpret mode, the JAX engine on the same
noise, and K5's table stats mode.

The JAX kernel draws the TPU's hardware bits only, which the Mosaic
interpreter stubs to zero: every uniform is 0 and the Box-Muller normal
sqrt(-2 log 1) cos 0 is 0.  The port's plain K8 fed all-zero channels must
then reproduce the interpret-mode kernel.  Its random-noise mode is held to
the JAX engine instead.  The CUDA kernel is held against its plain version
on the card (tests/test_torch_cuda.py and chip_smoke.py).
"""
import ctypes
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mbt_gym_tpu.agents.baseline import CarteaJaimungalMmAgent as JaxCjAgent
from mbt_gym_tpu.ops import pallas_episode as pe
from mbt_gym_tpu.rollout import rollout as jax_rollout
from mbt_gym_tpu.types import SlotNoise as JaxSlotNoise
from mbt_gym_tpu.utils.config import as_env_config as jax_as_env_config
from mbt_gym_tpu.utils.config import cj_env_config as jax_cj_env_config

from mbt_gym_torch import cj_episode_rewards
from mbt_gym_torch.agents.baseline import CarteaJaimungalMmAgent
from mbt_gym_torch.ops import cj_episode as cj
from mbt_gym_torch.ops import det_rollout as det
from mbt_gym_torch.utils.config import cj_env_config
from tests.test_torch_env import channels_noise, random_channels, torch_config

N = 256


def _config(n_steps=60, max_inventory=4.0):
    return jax_cj_env_config(num_trajectories=N, n_steps=n_steps, max_inventory=max_inventory)


def test_params_and_guard_match_jax():
    """tests/test_pallas_episode.py:94 for the port."""
    jcfg = jax_cj_env_config(num_trajectories=1024, max_inventory=10.0)
    got = cj.cj_params_from_config(torch_config(jcfg))
    assert tuple(got) == tuple(pe.cj_params_from_config(jcfg))
    assert got.phi == 0.01 and got.alpha == 0.001 and got.n_steps == 1000
    for bad in (jax_as_env_config(num_trajectories=1024), dataclasses.replace(jcfg, initial_inventory=2)):
        with pytest.raises(AssertionError):
            pe.cj_params_from_config(bad)
        with pytest.raises(AssertionError):
            cj.cj_params_from_config(torch_config(bad))


def test_k8_plain_zero_bits_matches_interpret_pallas():
    """All-zero draws: every step both quotes fill, so the cash walks the
    depth table's q=0 column row by row — the time indexing and the
    accumulation, compared exactly (the same float32 ops in the same
    order; the one-hot contraction's single nonzero term is the gathered
    entry)."""
    jcfg = _config(n_steps=30)
    jagent = JaxCjAgent.from_config(jcfg, max_inventory=10)
    jp = pe.cj_params_from_config(jcfg)
    table = np.asarray(jagent.depth_table()[:-1], np.float32)
    want = pe.cj_episode_pallas(jp, table, 3, 10, N, rows=2, interpret=pltpu.InterpretParams())
    p = cj.cj_params_from_config(torch_config(jcfg))
    got = cj.cj_episode(p, table, 3, 10, N, noise=torch.zeros((30, 5, N)))
    for name, g, w in zip(("cash", "inventory", "price", "sumq2"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert float(got[0][0]) > 0  # the depths were collected


def test_k8_plain_matches_jax_engine_on_random_noise():
    """K8's noise mode (the JAX kernel has none) against the JAX engine with
    the closed-form CJ policy on the same draws, with a grid small enough
    that the inventory bound binds: the terminal state at the float32
    tolerances of tests/test_pallas_episode.py:201-204, and the telescoped
    rewards against the engine's per-step CjMm sums (rtol=1e-4 / atol=2e-3,
    as the OE identity's test at :248)."""
    jcfg = _config()
    jagent = JaxCjAgent.from_config(jcfg, max_inventory=6)
    channels = random_channels(17, 60, N)
    jres = jax_rollout(jcfg, jagent.policy(), None, jax.random.PRNGKey(0), noise=channels_noise(channels, JaxSlotNoise))
    final = np.asarray(jres.trajectory.observations[-1])
    assert np.abs(final[:, 1]).max() == 4.0  # the env's fill mask binds, not q_cap
    cfg = torch_config(jcfg)
    agent = CarteaJaimungalMmAgent.from_config(cfg, max_inventory=6)
    p = cj.cj_params_from_config(cfg)
    noise = torch.from_numpy(channels)
    cash, inv, price, sumq2 = cj.cj_episode(p, agent.depth_table()[:-1], 0, 6, N, noise=noise)
    np.testing.assert_array_equal(inv.numpy(), final[:, 1])
    np.testing.assert_allclose(cash.numpy(), final[:, 0], rtol=1e-6, atol=1e-3)
    np.testing.assert_allclose(price.numpy(), final[:, 3], rtol=0, atol=1e-3)
    np.testing.assert_allclose(
        sumq2.numpy(), (np.asarray(jres.trajectory.observations[1:, :, 1]) ** 2).sum(0), rtol=0, atol=0
    )
    rewards = cj_episode_rewards(cfg, agent, 0, N, noise=noise)
    np.testing.assert_allclose(rewards.numpy(), np.asarray(jres.trajectory.rewards.sum(axis=0)), rtol=1e-4, atol=2e-3)


def test_k8_terminal_equals_k5_table_stats():
    """On the same noise K8's terminal state equals K5's table stats mode on
    the same config (one step function, K1's draw layout), in noise and
    native mode; K5's reward sum is the per-step form of K8's identity."""
    cfg = cj_env_config(num_trajectories=N, n_steps=80, max_inventory=5.0)
    agent = CarteaJaimungalMmAgent.from_config(cfg, max_inventory=8)
    p = cj.cj_params_from_config(cfg)
    kp = det.cj_rollout_params(cfg, agent)
    tables = det.cj_depth_tables(agent)
    for kw in ({"noise": torch.from_numpy(random_channels(23, 80, N))}, {"seed": 4, "device": "cpu"}):
        k8 = cj.cj_episode(p, agent.depth_table()[:-1], q_cap=8, num_trajectories=N, **kw)
        k5 = det.table_rollout(kp, *tables, num_trajectories=N, stats_only=True, **kw)
        for a, b in zip(k8[:3], k5[:3]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        rewards = cj_episode_rewards(cfg, agent, num_trajectories=N, **kw)
        torch.testing.assert_close(rewards, k5[3], rtol=1e-4, atol=2e-3)


def test_wrapper_rejects_bad_inputs():
    cfg = cj_env_config(num_trajectories=128, n_steps=10, max_inventory=5.0)
    agent = CarteaJaimungalMmAgent.from_config(cfg)
    p = cj.cj_params_from_config(cfg)
    with pytest.raises(ValueError, match="noise must be float32"):
        cj.cj_episode(p, agent.depth_table()[:-1], 0, 5, 128, noise=torch.zeros((10, 5, 64)))
    with pytest.raises(AssertionError):  # the table must be (n_steps, 2*q_cap+1, 2)
        cj.cj_episode(p, agent.depth_table(), 0, 5, 128, device="cpu")



def test_fill_table_is_the_exp_of_the_scaled_depths():
    """K8's fill probabilities: cj_fill_table's plain version (what a CPU
    tensor gets) is torch.exp(neg_k * table), bitwise, the same shape."""
    cfg = cj_env_config(num_trajectories=N, n_steps=40, max_inventory=5.0)
    p = cj.cj_params_from_config(cfg)
    table = torch.from_numpy(CarteaJaimungalMmAgent.from_config(cfg, max_inventory=8).depth_table_f32()[:-1].copy())
    want = torch.exp(cj.kernel_params(p, 8).neg_k * table)
    for got in (cj.cj_fill_table_plain(p, table), cj.cj_fill_table(p, table)):
        assert got.shape == table.shape and torch.equal(got, want)


@pytest.mark.parametrize("mode", ["noise", "native"])
def test_k8_plain_on_the_fill_table_is_bitwise_the_exp_per_step(mode):
    """The plain K8 gathering its fill probabilities from the fill table
    (as the kernel reads them) equals the plain K8 that exponentiates each
    step's gathered depths, bitwise, on random noise and on native draws;
    so does the wrapper's CPU path given the table."""
    cfg = cj_env_config(num_trajectories=N, n_steps=80, max_inventory=5.0)
    agent = CarteaJaimungalMmAgent.from_config(cfg, max_inventory=8)
    p = cj.cj_params_from_config(cfg)
    table = torch.from_numpy(agent.depth_table_f32()[:-1].copy())
    fill = cj.cj_fill_table(p, table)
    kw = {"noise": torch.from_numpy(random_channels(29, 80, N))} if mode == "noise" else {"seed": 6, "device": "cpu"}
    want = cj.cj_episode_plain(p, table, q_cap=8, num_trajectories=N, **kw)
    for got in (cj.cj_episode_plain(p, table, q_cap=8, num_trajectories=N, fill_table=fill, **kw),
                cj.cj_episode(p, table, q_cap=8, num_trajectories=N, fill_table=fill, **kw)):
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_k8_geometry_stages_its_two_interleaved_tables():
    """K8 at the CJP's 16,384 x 1,000 stages, per step, the interleaved
    (2Q+1, 2) row of the depth table and of its fill probabilities (402
    floats each): 128-env CTAs, 8-step slots, 93,792 bytes of ring within
    SMEM_BUDGET, K5's footprint.  A table of Q = 5,000 (20,002 floats a
    row) stays in global memory, the draws still staged."""
    from mbt_gym_torch.ops import step_pipeline as sp

    p = cj.cj_params_from_config(cj_env_config(num_trajectories=16_384, max_inventory=100.0))
    g = cj.kernel_geometry(p, 100, 16_384)
    assert g.shape == "pipeline" and g.table_path == "staged"
    assert (g.envs, g.chunk, g.slots, g.channels, g.table_rows, g.row_floats) == (128, 8, 2, 5, 2, 402)
    assert g.smem_bytes == sp.ring_bytes(128, 8, 2, 5, 2, 402) == 93_792 <= sp.SMEM_BUDGET
    huge = cj.kernel_geometry(p, 5000, 16_384)
    assert huge.table_path == "global" and (huge.table_rows, huge.row_floats) == (2, 20_002)
    assert huge.smem_bytes == sp.ring_bytes(huge.envs, huge.chunk, huge.slots, 5)
    assert cj.CjKernelParams.pipe.offset == ctypes.sizeof(cj.CjKernelParams) - 9 * 4


def test_entry_points_copy_the_cj_tables_once_per_agent_and_device():
    """cj_episode_rewards (K8) and cj_mc_episode_stats (K5) take their
    device tables from the agent's cache: the second call reuses the first
    call's tensors, and the rewards do not change."""
    from mbt_gym_torch.agents.baseline import agent_device_tables

    cfg = cj_env_config(num_trajectories=N, n_steps=30, max_inventory=5.0)
    agent = CarteaJaimungalMmAgent.from_config(cfg, max_inventory=8)
    first = cj_episode_rewards(cfg, agent, 3, N, device="cpu")
    table, fill = cj.cj_episode_tables(agent, cj.cj_params_from_config(cfg), torch.device("cpu"))
    assert agent_device_tables(agent, "K8 depth")["cpu"] is table
    assert torch.equal(table, torch.from_numpy(agent.depth_table_f32()[:-1].copy()))
    assert torch.equal(fill, cj.cj_fill_table_plain(cj.cj_params_from_config(cfg), table))
    assert torch.equal(cj_episode_rewards(cfg, agent, 3, N, device="cpu"), first)
    assert cj.cj_episode_tables(agent, cj.cj_params_from_config(cfg), torch.device("cpu"))[1] is fill
    det.cj_mc_episode_stats(cfg, agent, 5, device="cpu")
    bid, ask = agent_device_tables(agent, "K5 depth")["cpu"]
    det.cj_mc_episode_stats(cfg, agent, 5, device="cpu")
    assert agent_device_tables(agent, "K5 depth")["cpu"][0] is bid
