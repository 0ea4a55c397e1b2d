"""mbt_gym_torch.ops.episode (K1, K2) against the JAX package's Pallas
episode kernels, run as the JAX package's own tests run them on the CPU.

On the CPU the wrappers take their plain PyTorch versions (the tensors lie
on the CPU); the CUDA kernels themselves are held against those plain
versions on the card (tests/test_torch_cuda.py and chip_smoke.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mbt_gym_tpu.agents.baseline import AvellanedaStoikovAgent as JaxAgent
from mbt_gym_tpu.ops import pallas_episode as pe
from mbt_gym_tpu.rollout import rollout as jax_rollout
from mbt_gym_tpu.types import SlotNoise as JaxSlotNoise
from mbt_gym_tpu.utils.config import as_env_config as jax_as_env_config

from mbt_gym_torch.ops import episode as ep
from mbt_gym_torch.utils.config import as_env_config
from tests.test_torch_env import assert_state_close, channels_noise, random_channels, torch_config


def _late_start_config(n=256, steps=30):
    return dataclasses.replace(
        jax_as_env_config(num_trajectories=n, n_steps=steps),
        initial_cash=5.0, initial_inventory=3, start_time=0.2,
    )


def test_params_match_jax_params():
    jcfg = _late_start_config()
    want = pe.params_from_config(jcfg, risk_aversion=0.1)
    got = ep.params_from_config(torch_config(jcfg), risk_aversion=0.1)
    assert tuple(got) == tuple(want)
    assert got.run_steps == want.run_steps == 24


@pytest.mark.parametrize("risk_aversion", [0.1, 0.0], ids=["as-quotes", "fixed-1/k"])
def test_k1_plain_matches_interpret_pallas_with_noise(risk_aversion):
    """K1's plain version against as_episode_pallas(interpret=True,
    noise=...) exactly as tests/test_pallas_episode.py:173-204 runs it:
    nonzero initial cash/inventory and a late start; risk aversion 0 takes
    the fixed risk-neutral quotes 1/k."""
    jcfg = _late_start_config()
    p = pe.params_from_config(jcfg, risk_aversion=risk_aversion)
    rng = np.random.default_rng(11)
    channels = rng.uniform(size=(p.run_steps, 5, 256)).astype(np.float32)
    channels[:, 4] = rng.normal(size=(p.run_steps, 256)).astype(np.float32)
    want = pe.as_episode_pallas(p, 0, 256, rows=2, interpret=True, noise=jnp.asarray(channels))

    tp = ep.params_from_config(torch_config(jcfg), risk_aversion=risk_aversion)
    got = ep.as_episode(tp, 0, 256, noise=torch.from_numpy(channels))
    got_obs = np.stack([g.numpy() for g in (got[0], got[1], got[1], got[2])], axis=-1)
    want_obs = np.stack([np.asarray(w) for w in (want[0], want[1], want[1], want[2])], axis=-1)
    assert_state_close(got_obs, want_obs)


@pytest.mark.parametrize("emit", ["full", "container"])
@pytest.mark.parametrize("n,steps", [(256, 20), (512, 900)], ids=["one-shot", "chunked"])
def test_k2_plain_zero_bits_matches_interpret_pallas(n, steps, emit):
    """The Mosaic interpreter stubs the hardware PRNG to zero bits: every
    uniform is 0 and the Box-Muller normal is sqrt(-2 log 1) cos 0 = 0.
    K2's plain version fed all-zero channels must then reproduce the
    interpret-mode kernel in both JAX tilings (one-shot grid, and the
    time-chunked grid at T=900).  Same float32 ops in the same order, so
    the state planes are compared exactly; rewards and quotes at the
    rtol=1e-6 of tests/test_pallas_episode.py:346-351, and the time plane
    at the rtol=1e-6 of :385 (XLA's CPU backend drops the ``0 +`` of a zero
    start and contracts ``i*dt + dt`` into one FMA: one ULP)."""
    jcfg = jax_as_env_config(num_trajectories=n, n_steps=steps)
    p = pe.params_from_config(jcfg, risk_aversion=0.1)
    want = pe.as_episode_trajectories_pallas(p, 3, n, interpret=pltpu.InterpretParams(), emit=emit)

    tp = ep.params_from_config(torch_config(jcfg), risk_aversion=0.1)
    zeros = torch.zeros((tp.run_steps, 5, n), dtype=torch.float32)
    got = ep.as_episode_trajectories(tp, 3, n, emit=emit, noise=zeros)
    if emit == "container":
        assert got.shape == (ep.CONTAINER_PLANES, steps, n)
        got_planes = ep.trajectory_planes_view(got)
        want_planes = pe.trajectory_planes_view(want)
    else:
        names = ("cash", "inventory", "price", "reward", "bid", "ask")
        got_planes = dict(zip(names, got))
        want_planes = dict(zip(names, want))
    for name, plane in got_planes.items():
        want_plane = np.asarray(want_planes[name])
        assert plane.shape == (steps, n)
        if name in ("cash", "inventory", "price"):
            np.testing.assert_array_equal(plane.numpy(), want_plane, err_msg=name)
        else:
            np.testing.assert_allclose(plane.numpy(), want_plane, rtol=1e-6, atol=1e-5, err_msg=name)


def test_k2_plain_random_noise_matches_jax_engine():
    """K2's noise mode (which the JAX kernel lacks) against the JAX engine's
    trajectories on the same random noise, at the float32 tolerances of
    tests/test_pallas_episode.py:201-204."""
    jcfg = _late_start_config()
    tp = ep.params_from_config(torch_config(jcfg), risk_aversion=0.1)
    channels = random_channels(11, 30, 256)
    jres = jax_rollout(
        jcfg, JaxAgent.from_config(jcfg, 0.1).policy(), None, jax.random.PRNGKey(0),
        noise=channels_noise(channels, JaxSlotNoise),
    )
    streams = ep.as_episode_trajectories(
        tp, 0, 256, emit="full", noise=torch.from_numpy(channels[: tp.run_steps])
    )
    traj = ep.as_trajectory_from_full(tp, streams)
    want_obs = np.asarray(jres.trajectory.observations)
    got_obs = traj.observations.numpy()
    assert got_obs.shape == want_obs.shape == (25, 256, 4)
    assert_state_close(got_obs, want_obs)
    # time: start + i*dt in the kernel, an accumulated sum in the engine
    np.testing.assert_allclose(got_obs[..., 2], want_obs[..., 2], rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        traj.actions.numpy(), np.asarray(jres.trajectory.actions), rtol=0, atol=1e-5
    )
    np.testing.assert_allclose(
        traj.rewards.numpy(), np.asarray(jres.trajectory.rewards), rtol=0, atol=1e-3
    )


@pytest.mark.parametrize("n,steps", [(256, 20), (512, 900)], ids=["one-shot", "chunked"])
def test_k2_trajectory_zero_bits_matches_interpret_pallas(n, steps):
    """K2's trajectory layout against the JAX package's rollout assembly,
    as_trajectory_from_pallas_full over the interpret-mode kernel's full
    streams (mbt_gym_tpu/dispatch.py:363-366), on zero-bit noise (see
    test_k2_plain_zero_bits_matches_interpret_pallas): the state columns
    exactly, the time column, actions and rewards at that test's rtol=1e-6."""
    jcfg = jax_as_env_config(num_trajectories=n, n_steps=steps)
    p = pe.params_from_config(jcfg, risk_aversion=0.1)
    want = pe.as_trajectory_from_pallas_full(
        p, pe.as_episode_trajectories_pallas(p, 3, n, interpret=pltpu.InterpretParams(), emit="full")
    )

    tp = ep.params_from_config(torch_config(jcfg), risk_aversion=0.1)
    zeros = torch.zeros((tp.run_steps, 5, n), dtype=torch.float32)
    got = ep.as_episode_trajectory(tp, 3, n, noise=zeros)
    want_obs = np.asarray(want.observations)
    assert got.observations.shape == want_obs.shape == (steps + 1, n, 4)
    assert got.actions.shape == (steps, n, 2) and got.rewards.shape == (steps, n)
    for col in (0, 1, 3):
        np.testing.assert_array_equal(got.observations[..., col].numpy(), want_obs[..., col], err_msg=str(col))
    np.testing.assert_allclose(got.observations[..., 2].numpy(), want_obs[..., 2], rtol=1e-6, atol=0)
    np.testing.assert_allclose(got.actions.numpy(), np.asarray(want.actions), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(got.rewards.numpy(), np.asarray(want.rewards), rtol=1e-6, atol=1e-5)


def test_k2_trajectory_random_noise_matches_jax_engine():
    """K2's trajectory layout against the JAX engine's trajectory on the
    same random noise, at the tolerances of
    test_k2_plain_random_noise_matches_jax_engine."""
    jcfg = _late_start_config()
    tp = ep.params_from_config(torch_config(jcfg), risk_aversion=0.1)
    channels = random_channels(11, 30, 256)
    jres = jax_rollout(
        jcfg, JaxAgent.from_config(jcfg, 0.1).policy(), None, jax.random.PRNGKey(0),
        noise=channels_noise(channels, JaxSlotNoise),
    )
    traj = ep.as_episode_trajectory(tp, 0, 256, noise=torch.from_numpy(channels[: tp.run_steps]))
    want_obs = np.asarray(jres.trajectory.observations)
    got_obs = traj.observations.numpy()
    assert got_obs.shape == want_obs.shape == (25, 256, 4)
    assert_state_close(got_obs, want_obs)
    np.testing.assert_allclose(got_obs[..., 2], want_obs[..., 2], rtol=0, atol=1e-6)
    np.testing.assert_allclose(traj.actions.numpy(), np.asarray(jres.trajectory.actions), rtol=0, atol=1e-5)
    np.testing.assert_allclose(traj.rewards.numpy(), np.asarray(jres.trajectory.rewards), rtol=0, atol=1e-3)


@pytest.mark.parametrize("mode", ["noise", "native"])
@pytest.mark.parametrize("late", [False, True], ids=["default", "late-start"])
def test_k2_trajectory_is_the_layout_of_the_full_streams(mode, late):
    """On the CPU the trajectory layout is, bit for bit, what
    as_trajectory_from_full makes of the emit="full" streams of the same
    draws, time column and initial row included."""
    cfg = as_env_config(num_trajectories=256, n_steps=40)
    if late:
        cfg = dataclasses.replace(cfg, initial_cash=5.0, initial_inventory=3, start_time=0.2)
    p = ep.params_from_config(cfg, 0.1)
    kw = {"noise": torch.from_numpy(random_channels(5, p.run_steps, 256))} if mode == "noise" else {"device": "cpu"}
    got = ep.as_episode_trajectory(p, 7, 256, **kw)
    want = ep.as_trajectory_from_full(p, ep.as_episode_trajectories(p, 7, 256, emit="full", **kw))
    for name in ("observations", "actions", "rewards"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert got.observations.shape == (p.run_steps + 1, 256, 4)
    initial = torch.tensor([p.initial_cash, p.initial_inventory, p.start_time, p.initial_price], dtype=torch.float32)
    assert torch.equal(got.observations[0], initial.expand(256, 4))


def test_k2_emits_agree_and_end_at_k1():
    """state == the first three full streams; the container holds the full
    streams plus the post-step time plane; K2's last row is K1's terminal
    state on the same noise (bitwise: one step function)."""
    cfg = dataclasses.replace(as_env_config(num_trajectories=256, n_steps=40), initial_inventory=2)
    p = ep.params_from_config(cfg, 0.1)
    noise = torch.from_numpy(random_channels(3, 40, 256))
    state = ep.as_episode_trajectories(p, 0, 256, emit="state", noise=noise)
    full = ep.as_episode_trajectories(p, 0, 256, emit="full", noise=noise)
    data = ep.as_episode_trajectories(p, 0, 256, emit="container", noise=noise)
    for a, b in zip(state, full[:3]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    view = ep.trajectory_planes_view(data)
    for name, plane in zip(("cash", "inventory", "price", "reward", "bid", "ask"), full):
        torch.testing.assert_close(view[name], plane, rtol=0, atol=0)
    want_time = (p.start_time + (np.arange(40) + 1) * p.dt).astype(np.float32)
    np.testing.assert_allclose(view["time"].numpy(), np.broadcast_to(want_time[:, None], (40, 256)), rtol=1e-6)
    terminal = ep.as_episode(p, 0, 256, noise=noise)
    for got, want in zip(terminal, state):
        torch.testing.assert_close(got, want[-1], rtol=0, atol=0)
    tt = ep.as_trajectory_t_from_full(p, full)
    torch.testing.assert_close(tt.to_time_major().observations, ep.as_trajectory_from_full(p, full).observations)


def test_philox_known_answers():
    """Philox4x32-10 against the Random123 known-answer vectors."""
    def run(ctr, key):
        out = ep.philox4x32_10(tuple(torch.tensor([c]) for c in ctr), (key[0], torch.tensor([key[1]])))
        return [int(x) for x in out]

    m = 0xFFFFFFFF
    assert run([0, 0, 0, 0], [0, 0]) == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    assert run([m] * 4, [m, m]) == [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]
    assert run([0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344], [0xA4093822, 0x299F31D0]) == [
        0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1,
    ]


def test_philox_noise_distribution():
    noise = ep.philox_noise(seed=9, run_steps=64, num_trajectories=1024, device="cpu").numpy()
    assert noise.shape == (64, 5, 1024)
    u = noise[:, :4]
    assert u.min() >= 0.0 and u.max() < 1.0
    assert abs(u.mean() - 0.5) < 0.005 and abs(u.var() - 1 / 12) < 0.003
    z = noise[:, 4]
    assert abs(z.mean()) < 0.02 and abs(z.std() - 1.0) < 0.02
    # keyed by (seed, env): another seed or env gives another stream
    other = ep.philox_noise(seed=10, run_steps=64, num_trajectories=1024, device="cpu").numpy()
    assert not np.array_equal(noise, other)
    assert not np.array_equal(noise[:, :, 0], noise[:, :, 1])


def test_native_plain_episode_stats_in_as_bands():
    """The native (Philox) plain versions of K1 and K2 on the CPU fall in
    the AS table bands of tests/test_pallas_episode.py:150-152."""
    cfg = as_env_config(num_trajectories=1024)
    stats = {k: float(v) for k, v in ep.as_mc_episode_stats(cfg, 0.1, 7, episodes=2, device="cpu").items()}
    assert abs(stats["mean_spread"] - 1.4918) < 0.01
    assert abs(stats["mean_pnl"] - 64.87) < 1.0
    assert abs(stats["std_terminal_inventory"] - 2.89) < 0.3
    p = ep.params_from_config(cfg, 0.1)
    terminal = ep.episode_stats_fused(p, 7, 1024, device="cpu")
    assert abs(float(terminal["mean_pnl"]) - 64.87) < 1.0
    assert abs(float(terminal["std_terminal_inventory"]) - 2.89) < 0.3


@pytest.mark.parametrize(
    "change",
    [
        {"dtype": "float64"},
        {"normalise_observation_space": True},
        {"reward_scaling": 2.0},
        {"start_time": ("uniform", 0.0, 0.5)},
        {"initial_inventory": (-2, 3)},
    ],
    ids=["float64", "normalised", "reward_scaling", "random-start", "random-inventory"],
)
def test_params_guards_match_jax(change):
    jcfg = dataclasses.replace(jax_as_env_config(num_trajectories=256), **change)
    with pytest.raises(AssertionError):
        pe.params_from_config(jcfg)
    with pytest.raises(AssertionError):
        ep.params_from_config(torch_config(jcfg))


def test_wrapper_rejects_bad_noise():
    p = ep.params_from_config(as_env_config(num_trajectories=128, n_steps=10), 0.1)
    with pytest.raises(ValueError, match="noise must be float32"):
        ep.as_episode(p, 0, 128, noise=torch.zeros((10, 5, 64)))
    with pytest.raises(ValueError, match="noise must be float32"):
        ep.as_episode_trajectories(p, 0, 128, noise=torch.zeros((10, 5, 128), dtype=torch.float64))



def test_k1_pipeline_geometry():
    """K1's step pipeline stages the draws alone (five channels, no table):
    at the main path's 16,384 x 200 four consumer warps per CTA and 128 of
    the 132 SMs a CTA; a 1-step episode still gets a slot of one step; the ring fits a
    CTA's shared memory at every shape; the ctypes mirror ends with the
    geometry's nine ints, as struct AsKernelParams declares it."""
    import ctypes

    from mbt_gym_torch.ops import step_pipeline as sp

    p = ep.params_from_config(as_env_config(num_trajectories=16_384), 0.1)
    g = ep.kernel_geometry(p, 16_384)
    assert (g.channels, g.table_path, g.staged) == (5, "none", 0)
    assert g.envs == 128 and -(-16_384 // g.envs) >= sp.SM_SHARE * sp.H100_SMS
    for n in (1, 4_099, 16_384, 1_048_576):
        for steps in (1, 7, 200):
            g = ep.kernel_geometry(p._replace(n_steps=steps), n)
            assert 1 <= g.chunk <= steps and g.smem_bytes == sp.ring_bytes(g.envs, g.chunk, g.slots, 5)
            assert g.smem_bytes <= sp.SMEM_BUDGET and g.threads <= sp.MAX_THREADS
    assert ep.AsKernelParams.pipe.offset == ctypes.sizeof(ep.AsKernelParams) - 9 * 4


def test_k2_pipeline_geometry():
    """K2 (every layout) takes the pipeline's "as streams" mode: at the main
    path's 16,384 x 200 128-env CTAs with the streams mode's two producer
    warps a consumer warp, its own slot length, five draw channels and no
    table; from its own threshold on, and at 1,048,576 envs, the wide
    shape."""
    from mbt_gym_torch.ops import step_pipeline as sp

    p = ep.params_from_config(as_env_config(num_trajectories=16_384), 0.1)
    g = ep.trajectory_geometry(p, 16_384)
    assert g.shape == "pipeline" and (g.envs, g.slots, g.channels, g.table_path) == (128, sp.SLOTS, 5, "none")
    assert g.producers == sp.PRODUCERS_PER_CONSUMER["as streams"] * g.envs // 32 == 8
    assert g.chunk == sp.MAX_CHUNK["as streams"]
    assert sp.PRODUCERS_PER_CONSUMER["as streams"] == sp.PRODUCERS_PER_CONSUMER["streams"]
    assert g.smem_bytes == sp.ring_bytes(128, g.chunk, sp.SLOTS, 5) <= sp.SMEM_BUDGET
    threshold = sp.wide_min_envs("as streams")
    assert ep.trajectory_geometry(p, threshold - 1).shape == "pipeline"
    assert ep.trajectory_geometry(p, threshold).shape == ep.trajectory_geometry(p, 1_048_576).shape == "wide"
