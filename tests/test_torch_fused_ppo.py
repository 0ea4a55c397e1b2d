"""K4's plain version (mbt_gym_torch.ops.fused_ppo) against the JAX
package's feature-major fused update run in interpret mode and against
jax.grad of the JAX loss (as tests/test_fused_ppo.py:113-163), and one
whole fused PPO iteration against JAX's _fused_iteration_body on the same
injected noise."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mbt_gym_tpu.agents import ppo as jppo
from mbt_gym_tpu.ops import fused_ppo as jfused
from mbt_gym_tpu.utils.config import as_env_config as jax_as_env_config

from mbt_gym_torch import convert
from mbt_gym_torch.agents import ppo
from mbt_gym_torch.ops import fused_ppo
from tests.test_torch_env import torch_config
from tests.test_torch_networks import assert_trees_close, jax_and_port_params, jax_numpy_tree, tree_items
from tests.test_torch_ppo import _batch

L = 64  # envs per step


def _feature_major(arrays, t_steps):
    obs, actions, log_probs, adv, returns = arrays
    to_t = lambda x: np.ascontiguousarray(x.reshape(t_steps, L, -1).swapaxes(1, 2))  # noqa: E731
    flat = lambda x: np.ascontiguousarray(x.reshape(t_steps, L))  # noqa: E731
    return to_t(obs), to_t(actions), flat(log_probs), flat(adv), flat(returns)


def _port_grads(model, inputs, compute_dtype):
    grads, metrics = fused_ppo.ppo_fused_grads_T(
        model, *(torch.from_numpy(x) for x in inputs), clip_eps=0.2, vf_coef=0.5, compute_dtype=compute_dtype,
    )
    assert set(grads) == {name for name, _ in model.named_parameters()}
    return convert.actor_critic_to_numpy(model, grads), {k: float(v) for k, v in metrics.items()}


@pytest.mark.parametrize("t_steps", [8, 10])
def test_plain_grads_match_jax_grad_float32(t_steps):
    """float32 against jax.grad of the JAX loss on the same samples, at
    tests/test_fused_ppo.py:155-162's tolerances (grads rtol 2e-4 / atol
    2e-6, metrics rtol 1e-4 / atol 1e-6).  T=10 is not a multiple of 8:
    the port runs the true T, without the TPU kernel's padding."""
    params, model = jax_and_port_params(True, seed=2)
    arrays = _batch(params, m=t_steps * L, seed=5)
    obs, actions, log_probs, adv, returns = (jnp.asarray(x) for x in arrays)
    batch = jppo.RolloutBatch(obs=obs, actions=actions, log_probs=log_probs, values=returns,
                              rewards=jnp.zeros_like(adv), advantages=adv, returns=returns)
    (_, want_m), want_g = jax.value_and_grad(jppo._ppo_loss, has_aux=True)(
        params, jppo.PPOConfig(normalise_advantages=False), batch)
    grads, metrics = _port_grads(model, _feature_major(arrays, t_steps), "float32")
    assert_trees_close(grads, jax_numpy_tree(want_g), rtol=2e-4, atol=2e-6)
    for name in ("pg_loss", "vf_loss", "approx_kl"):
        np.testing.assert_allclose(metrics[name], float(want_m[name]), rtol=1e-4, atol=1e-6, err_msg=name)


def _rel_err(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.mark.parametrize("t_steps", [8, 10])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_plain_grads_match_jax_interpret_kernel(t_steps, compute_dtype):
    """Against ppo_fused_grads_T(..., interpret=True) on the same inputs.
    float32: rtol 2e-4 / atol 2e-6.  bf16: the same roundings in both, but
    XLA's CPU backend may keep bf16 intermediates in float32, so a leaf's
    relative Frobenius error is held to 1e-2; metrics to rtol 1e-4."""
    params, model = jax_and_port_params(True, seed=2)
    inputs = _feature_major(_batch(params, m=t_steps * L, seed=7), t_steps)
    want_g, want_m = jfused.ppo_fused_grads_T(
        params, *(jnp.asarray(x) for x in inputs), clip_eps=0.2, vf_coef=0.5, tile=L, interpret=True,
        compute_dtype=compute_dtype,
    )
    grads, metrics = _port_grads(model, inputs, compute_dtype)
    if compute_dtype == "float32":
        assert_trees_close(grads, jax_numpy_tree(want_g), rtol=2e-4, atol=2e-6)
    else:
        want_items = dict(tree_items(jax_numpy_tree(want_g)))
        for path, got in tree_items(grads):
            assert _rel_err(got, want_items[path]) <= 1e-2, (path, _rel_err(got, want_items[path]))
    for name in ("pg_loss", "vf_loss", "approx_kl"):
        np.testing.assert_allclose(metrics[name], float(want_m[name]), rtol=1e-4, atol=1e-6, err_msg=name)


def test_env_slice_views_read_in_place():
    """A minibatch given as strided env-slice views of wider buffers gives
    the same grads as its contiguous copy."""
    _, model = jax_and_port_params(True, seed=2)
    rng = np.random.default_rng(1)
    full = [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
            for shape in ((8, 4, 3 * L), (8, 2, 3 * L), (8, 3 * L), (8, 3 * L), (8, 3 * L))]
    views = [x[..., L:2 * L] for x in full]
    assert not views[0].is_contiguous()
    got_g, got_m = fused_ppo.ppo_fused_grads_T(model, *views, compute_dtype="bfloat16")
    want_g, want_m = fused_ppo.ppo_fused_grads_T(model, *(v.contiguous() for v in views), compute_dtype="bfloat16")
    for name in want_g:
        torch.testing.assert_close(got_g[name], want_g[name], rtol=0, atol=0)
    for name in want_m:
        torch.testing.assert_close(got_m[name], want_m[name], rtol=0, atol=0)


def test_fused_iteration_matches_jax_on_injected_noise():
    """One whole fused iteration (K3 rollout -> GAE -> 2 env-slice
    minibatches of K4 grads -> entropy grad -> clip + Adam) against JAX's
    _fused_iteration_body in interpret mode on the same (T, 7, N) channels,
    float32 update, ent_coef 0.01: updated params to rtol 5e-4 / atol 5e-6
    and metrics to rtol 1e-3 (tests/test_fused_ppo.py:98-110)."""
    n, t_steps = 128, 8
    jcfg = dataclasses.replace(jax_as_env_config(num_trajectories=n, n_steps=t_steps),
                               normalise_observation_space=True, normalise_action_space=True)
    kw = dict(hidden=(16, 16), n_epochs=1, n_minibatches=2, shuffle=False, shared_trunk=True, ent_coef=0.01,
              fused_rollout=True, fused_update=True, fused_compute_dtype="float32")
    jcfg_ppo = jppo.PPOConfig(fused_interpret_ok=True, fused_rollout_tile=128, **kw)
    rng = np.random.default_rng(11)
    channels = rng.uniform(size=(t_steps, 7, n)).astype(np.float32)
    channels[:, 4:] = rng.normal(size=(t_steps, 3, n)).astype(np.float32)
    params, model = jax_and_port_params(True, hidden=(16, 16), seed=6)
    opt_state = jppo.make_optimizer(jcfg_ppo).init(params)
    want_params, _, want_m = jppo._fused_iteration_body(
        jcfg, jcfg_ppo, params, opt_state, jax.random.PRNGKey(0), noise=jnp.asarray(channels))
    cfg = ppo.PPOConfig(**kw)
    ts = ppo.PPOTrainState(model, ppo.make_optimizer(cfg, model), 0)
    new_ts, metrics = ppo.train_iteration(torch_config(jcfg), cfg, ts, 0, noise=torch.from_numpy(channels))
    assert new_ts.update_count == 1
    assert_trees_close(convert.actor_critic_to_numpy(new_ts.params), jax_numpy_tree(want_params),
                       rtol=5e-4, atol=5e-6)
    for name in ("pg_loss", "vf_loss", "approx_kl", "entropy", "mean_episode_reward"):
        np.testing.assert_allclose(float(metrics[name]), float(want_m[name]), rtol=1e-3, atol=1e-5, err_msg=name)
