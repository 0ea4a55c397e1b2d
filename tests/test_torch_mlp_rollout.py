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
    cfg = as_env_config(num_trajectories=N)
    for change, match in (
        ({"initial_inventory": (-2, 3)}, "random initial inventory is not ported to CUDA"),
        ({"start_time": ("uniform", 0.0, 0.5)}, "random start times are not ported to CUDA"),
        ({"dtype": "float64"}, "float64 reference-parity"),
        ({"reward_scaling": 0.5}, None),
    ):
        with pytest.raises(AssertionError, match=match):
            mr.rollout_params_from_config(dataclasses.replace(cfg, **change))
    towers = init_actor_critic(0, 4, 2, hidden=(16, 16), shared_trunk=False, device="cpu")
    with pytest.raises(ValueError, match="towers layout .*not ported to CUDA"):
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
