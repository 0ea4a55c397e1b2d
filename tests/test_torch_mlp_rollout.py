"""K3's plain version (mbt_gym_torch.ops.mlp_rollout) against the JAX
package's Pallas rollout kernel, run in interpret mode on injected noise
as tests/test_pallas_rollout.py:58-79 runs it, plus the native-noise
stream, the config guard and the fused collection functions."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mbt_gym_tpu.ops import pallas_rollout
from mbt_gym_tpu.utils.config import as_env_config as jax_as_env_config

from mbt_gym_torch.agents.networks import init_actor_critic
from mbt_gym_torch.agents.ppo import compute_gae
from mbt_gym_torch.ops import mlp_rollout as mr
from mbt_gym_torch.utils.config import as_env_config
from tests.test_torch_env import torch_config
from tests.test_torch_networks import jax_and_port_params

N, T = 128, 6


def _channels(seed=9, steps=T, n=N):
    rng = np.random.default_rng(seed)
    channels = rng.uniform(size=(steps, mr.N_CHANNELS, n)).astype(np.float32)
    channels[:, 4:7] = rng.normal(size=(steps, 3, n)).astype(np.float32)
    return channels


def _configs(normalised=True, **overrides):
    jcfg = dataclasses.replace(
        jax_as_env_config(num_trajectories=N, n_steps=T),
        normalise_observation_space=normalised, normalise_action_space=normalised, **overrides,
    )
    return jcfg, torch_config(jcfg)


@pytest.mark.parametrize(
    "normalised,overrides",
    [(True, {}), (True, {"initial_cash": 5.0, "initial_inventory": 3, "start_time": 2 / 6}), (False, {})],
    ids=["bf16-normalised", "bf16-late-start", "float32-raw"],
)
def test_plain_rollout_matches_jax_interpret_kernel(normalised, overrides):
    """Same params, same (T, 7, N) channels.  Normalised observations take
    bf16 matmul operands in both (pallas_rollout.py:855), raw ones float32.
    Tolerances of tests/test_pallas_rollout.py:68-72 (float32 accumulation
    order only): obs rtol 1e-4/atol 2e-4, actions, log-probs, values atol
    1e-3, rewards atol 5e-3; inventory paths exact."""
    jcfg, cfg = _configs(normalised, **overrides)
    params, model = jax_and_port_params(True, hidden=(16, 16), seed=3)
    channels = _channels()
    jp = pallas_rollout.rollout_params_from_config(jcfg)
    want = pallas_rollout.mlp_rollout_pallas(jp, params, 0, N, tile=128, interpret=True,
                                             noise=jnp.asarray(channels[: jp.run_steps]))
    p = mr.rollout_params_from_config(cfg)
    assert p.run_steps == jp.run_steps
    for field in mr.MlpRolloutParams._fields:
        assert getattr(p, field) == getattr(jp, field), field
    got = mr.mlp_rollout(p, model, 0, N, noise=torch.from_numpy(channels[: p.run_steps]), device="cpu")
    got = [x.numpy() for x in got]
    want = [np.asarray(x) for x in want]
    assert [g.shape for g in got] == [w.shape for w in want]
    # inventory paths agree exactly (the normalised plane itself may differ
    # by an ulp: XLA's CPU backend divides by multiplying by the reciprocal)
    def inventory(obs):
        return np.rint((obs[:, 1] + 1.0) * p.obs_grad[1] + p.obs_low[1]) if normalised else obs[:, 1]

    np.testing.assert_array_equal(inventory(got[0]), inventory(want[0]))
    for g, w, atol in zip(got, want, (2e-4, 1e-3, 1e-3, 1e-3, 5e-3)):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=atol)


def _cj_reward_configs(reward_name):
    """tests/test_pallas_rollout.py:270-318's reward cases (but
    exp_utility, which the port lacks): the AS env with the CjMm or running
    reward at exponent 2 or 3, initial inventory 3, normalised."""
    from mbt_gym_tpu.rewards import CjMmCriterion, RunningInventoryPenalty

    e = 3.0 if reward_name.endswith("_e3") else 2.0
    if reward_name.startswith("cjmm"):
        reward = CjMmCriterion(per_step_inventory_aversion=0.5, terminal_inventory_aversion=0.001,
                               terminal_time=1.0, inventory_exponent=e)
    else:
        reward = RunningInventoryPenalty(per_step_inventory_aversion=0.5, terminal_inventory_aversion=0.001,
                                         inventory_exponent=e)
    return _configs(reward_function=reward, initial_inventory=3)


def _port_engine_rewards(cfg, model, channels):
    """The port's engine and networks on the same (T, 7, N) channels, as
    tests/test_pallas_rollout.py's _xla_reference steps the JAX engine:
    the Gaussian sample from the eps channels, clipped to the action box."""
    from mbt_gym_torch import env as env_lib
    from mbt_gym_torch.agents import networks
    from mbt_gym_torch.types import SlotNoise

    ch = torch.from_numpy(channels)
    state, obs = env_lib.reset(cfg, 0, device="cpu")
    std = torch.exp(model.log_std.detach())
    rewards = []
    with torch.no_grad():
        for t in range(ch.shape[0]):
            mean, _ = networks.policy_value(model, obs)
            action = torch.clamp(mean + std * ch[t, 4:6].T, -1.0, 1.0)
            noise = (SlotNoise(normal=ch[t, 6][:, None], uniform=None),
                     SlotNoise(normal=None, uniform=ch[t, 0:2].T.contiguous()),
                     SlotNoise(normal=None, uniform=ch[t, 2:4].T.contiguous()))
            res = env_lib.step(cfg, state, action, noise=noise)
            rewards.append(res.reward)
            state, obs = res.state, res.obs
    return torch.stack(rewards).numpy()


@pytest.mark.parametrize("shared_trunk", [True, False], ids=["shared-trunk", "towers"])
@pytest.mark.parametrize("reward_name", ["cjmm", "running", "cjmm_e3", "running_e3"])
def test_plain_rollout_cj_rewards_match_jax_interpret_kernel(reward_name, shared_trunk):
    """K3's CjMm and running-penalty rewards at exponents 2 and 3: the plain
    version against mlp_rollout_pallas(interpret=True) on the same params
    and channels (the tolerances of test_plain_rollout_matches_jax_interpret_kernel,
    inventory paths exact, rewards atol 5e-3), and against the port's own
    engine on the same channels (tests/test_pallas_rollout.py:311-318's
    tolerance)."""
    jcfg, cfg = _cj_reward_configs(reward_name)
    params, model = jax_and_port_params(shared_trunk, hidden=(16, 16), seed=3)
    channels = _channels(seed=13)
    jp = pallas_rollout.rollout_params_from_config(jcfg)
    p = mr.rollout_params_from_config(cfg)
    for field in mr.MlpRolloutParams._fields:
        assert getattr(p, field) == getattr(jp, field), field
    assert p.reward_kind == reward_name.split("_")[0] and p.inventory_exponent == jp.inventory_exponent
    want = pallas_rollout.mlp_rollout_pallas(jp, params, 0, N, tile=128, interpret=True,
                                             noise=jnp.asarray(channels))
    got = [x.numpy() for x in mr.mlp_rollout(p, model, 0, N, noise=torch.from_numpy(channels), device="cpu")]
    want = [np.asarray(x) for x in want]

    def inventory(obs):
        return np.rint((obs[:, 1] + 1.0) * p.obs_grad[1] + p.obs_low[1])

    np.testing.assert_array_equal(inventory(got[0]), inventory(want[0]))
    assert np.abs(inventory(got[0])).max() >= 3  # the penalties see non-zero inventories
    for g, w, atol in zip(got, want, (2e-4, 1e-3, 1e-3, 1e-3, 5e-3)):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=atol)
    np.testing.assert_allclose(got[4], _port_engine_rewards(cfg, model, channels), rtol=1e-4, atol=5e-3)
    # the penalty terms alone, from the inventory path (steps 0..T-2, whose
    # post-step inventory the next observation holds), against the PnL
    # kind's rewards on the same noise, to float32 rounding
    pnl = mr.mlp_rollout(p._replace(reward_kind="pnl"), model, 0, N, noise=torch.from_numpy(channels),
                         device="cpu")[4].numpy()
    q = inventory(got[0]).astype(np.float64) ** p.inventory_exponent
    q_prev, q_next = q[:-1], q[1:]
    penalty = -p.dt * p.phi * q_next
    if p.reward_kind == "cjmm":
        penalty = penalty - p.alpha * (q_next - q_prev) - p.alpha * p.dt / p.terminal_time * 3.0**p.inventory_exponent
    np.testing.assert_allclose(got[4][:-1] - pnl[:-1], penalty, rtol=0, atol=1e-5)


def test_philox_noise_channels():
    """Native-mode channels: deterministic in (seed, env, step), uniforms
    in [0, 1), normals with unit moments; an env's stream does not depend
    on how many envs run."""
    noise = mr.philox_noise(5, 40, 4096, device="cpu")
    assert noise.shape == (40, 7, 4096) and noise.dtype == torch.float32
    torch.testing.assert_close(mr.philox_noise(5, 40, 128, device="cpu"), noise[..., :128], rtol=0, atol=0)
    u = noise[:, :4]
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.01
    normals = noise[:, 4:]
    assert abs(float(normals.mean())) < 0.02 and abs(float(normals.std()) - 1.0) < 0.02
    assert not torch.equal(mr.philox_noise(6, 40, 128, device="cpu"), noise[..., :128])


def test_native_mode_is_noise_mode_on_philox_channels():
    _, cfg = _configs()
    model = init_actor_critic(0, 4, 2, hidden=(16, 16), shared_trunk=True, device="cpu")
    p = mr.rollout_params_from_config(cfg)
    native = mr.mlp_rollout(p, model, 77, N, device="cpu")
    injected = mr.mlp_rollout(p, model, 0, N, noise=mr.philox_noise(77, T, N, device="cpu"))
    for a, b in zip(native, injected):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_config_guard_names_unported_features():
    from mbt_gym_torch.rewards import CjMmCriterion, CjOeCriterion, ExponentialUtility, RunningInventoryPenalty

    cfg = as_env_config(num_trajectories=N)
    # a random initial inventory runs on K3 through its inv0 plane, a
    # random start through its t0 plane, and the exponential utility as a
    # reward kind, as in JAX
    p = mr.rollout_params_from_config(dataclasses.replace(cfg, initial_inventory=(-2, 3)))
    assert (p.inventory_range, p.initial_inventory) == ((-2, 3), 0.0)
    p = mr.rollout_params_from_config(dataclasses.replace(cfg, start_time=("uniform", 0.0, 0.5)))
    assert (p.random_start, p.start_time, p.run_steps) == (True, 0.0, cfg.n_steps)
    p = mr.rollout_params_from_config(dataclasses.replace(cfg, reward_function=ExponentialUtility(0.3)))
    assert (p.reward_kind, p.risk_aversion) == ("exp_utility", 0.3)
    for change, match in (
        ({"dtype": "float64"}, "float64 reference-parity"),
        ({"reward_scaling": 0.5}, None),
        ({"reward_function": CjOeCriterion()},
         r"\(limit dynamics\) supports PnL / CjMmCriterion / RunningInventoryPenalty / ExponentialUtility; got"),
    ):
        with pytest.raises(AssertionError, match=match):
            mr.rollout_params_from_config(dataclasses.replace(cfg, **change))
    # the CJ market-making rewards run on K3 at any inventory exponent
    for reward, kind in ((CjMmCriterion(0.01, 0.001), "cjmm"), (CjMmCriterion(0.5, 0.001, 3.0), "cjmm"),
                         (RunningInventoryPenalty(0.5, 0.001), "running"),
                         (RunningInventoryPenalty(0.5, 0.001, 1.5), "running")):
        p = mr.rollout_params_from_config(dataclasses.replace(cfg, reward_function=reward))
        assert (p.reward_kind, p.phi, p.alpha, p.inventory_exponent) == (
            kind, reward.per_step_inventory_aversion, reward.terminal_inventory_aversion, reward.inventory_exponent)
    # the separate pi/vf towers now run (the stacked-trunk mode); towers of
    # unequal widths, which the JAX kernel refuses too, raise by name
    towers = init_actor_critic(0, 4, 2, hidden=(16, 16), shared_trunk=False, device="cpu")
    out = mr.mlp_rollout(mr.rollout_params_from_config(cfg), towers, 0, N, device="cpu")
    assert all(bool(torch.isfinite(x).all()) for x in out)
    towers.vf = torch.nn.ModuleList([torch.nn.Linear(4, 8), torch.nn.Linear(8, 16), torch.nn.Linear(16, 1)])
    with pytest.raises(ValueError, match="towers must have matching widths"):
        mr.mlp_rollout(mr.rollout_params_from_config(cfg), towers, 0, N, device="cpu")


def test_collect_rollout_fused_layouts_and_gae():
    """The feature-major batch carries GAE of its own rewards/values
    exactly; the row-major batch is its transposed view."""
    _, cfg = _configs()
    model = init_actor_critic(1, 4, 2, hidden=(16, 16), shared_trunk=True, device="cpu")
    noise = torch.from_numpy(_channels())
    tb = mr.collect_rollout_fused_T(cfg, model, 0, gamma=1.0, lam=0.95, noise=noise, device="cpu")
    adv, ret = compute_gae(tb.rewards, tb.values, torch.zeros_like(tb.values[0]), 1.0, 0.95)
    torch.testing.assert_close(tb.advantages, adv, rtol=0, atol=0)
    torch.testing.assert_close(tb.returns, ret, rtol=0, atol=0)
    rb = mr.collect_rollout_fused(cfg, model, 0, noise=noise, device="cpu")
    assert tuple(rb.obs.shape) == (T, N, 4) and tuple(rb.actions.shape) == (T, N, 2)
    torch.testing.assert_close(rb.obs, tb.obs_t.transpose(1, 2), rtol=0, atol=0)
    native = mr.collect_rollout_fused_T(cfg, model, 3, device="cpu")
    again = mr.collect_rollout_fused_T(cfg, model, 3, device="cpu")
    torch.testing.assert_close(native.rewards, again.rewards, rtol=0, atol=0)


@pytest.mark.parametrize("shared_trunk", [True, False], ids=["shared-trunk", "towers"])
@pytest.mark.parametrize("width", [36, 100])
def test_zero_padded_widths_leave_the_plain_rollout_bitwise_unchanged(width, shared_trunk):
    """The bf16 kernel's wrapper rounds every hidden width up to a multiple
    of 16 with zero weight rows and columns and zero biases (pad_widths):
    each new unit is tanh(0) = 0 and adds exact zeros downstream, so the
    plain version on the padded params gives the same outputs bit for
    bit."""
    _, cfg = _configs()
    model = init_actor_critic(4, 4, 2, hidden=(width, width), shared_trunk=shared_trunk, device="cpu")
    padded = mr.pad_widths(model)
    assert padded.hidden == {36: (48, 48), 100: (112, 112)}[width]
    p = mr.rollout_params_from_config(cfg)
    noise = torch.from_numpy(_channels())
    want = mr.mlp_rollout_plain(p, model, 0, N, noise=noise)
    got = mr.mlp_rollout_plain(p, padded, 0, N, noise=noise)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _unpack_mma_a(block, rows, cols):
    """pack_mma_a's inverse: fragment order back to a row-major matrix."""
    return block.reshape(rows // 16, cols // 16, 8, 4, 2, 2, 2).permute(0, 5, 2, 1, 4, 3, 6).reshape(rows, cols)


@pytest.mark.parametrize("shared_trunk", [True, False], ids=["shared-trunk", "towers"])
def test_bf16_tower_packing_puts_every_value_once_in_place(shared_trunk):
    """pack_tower_bf16: each layer's (out, in) matrix in mma fragment order
    (layer 0's S columns zero-padded to 16), layers concatenated, unpacks to
    the bf16-rounded matrices; the biases concatenated; the head rows
    zero-padded to 16 and packed the same way; the head's biases kept."""
    model = mr.pad_widths(init_actor_critic(2, 4, 2, hidden=(36, 100, 64), shared_trunk=shared_trunk, device="cpu"))
    for trunk, w_head, b_head in mr.tower_params(mr.transpose_params(model)):
        weights, bias, head, bias_head = mr.pack_tower_bf16(trunk, w_head, b_head)
        assert weights.dtype == head.dtype == torch.bfloat16 and weights.is_contiguous()
        off = 0
        for li, (w, _) in enumerate(trunk):
            rows, cols = w.shape[0], 16 if li == 0 else w.shape[1]
            want = torch.zeros((rows, cols), dtype=torch.bfloat16)
            want[:, :w.shape[1]] = w.to(torch.bfloat16)
            assert torch.equal(_unpack_mma_a(weights[off:off + rows * cols], rows, cols), want)
            off += rows * cols
        assert off == weights.numel()
        assert torch.equal(bias, torch.cat([b for _, b in trunk]))
        want = torch.zeros((16, w_head.shape[1]), dtype=torch.bfloat16)
        want[:w_head.shape[0]] = w_head.to(torch.bfloat16)
        assert head.numel() == want.numel() and torch.equal(_unpack_mma_a(head, *want.shape), want)
        assert torch.equal(bias_head, b_head)
