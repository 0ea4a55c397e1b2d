"""K4's and K7's plain versions at the widest observations the update
kernels take (S = 9, the all-axes composite config's, and S = 16, K3's
limit; A = 4 and A = 1) against the JAX package's interpret-mode kernels
``ppo_fused_grads_T`` (both layouts) and ``ppo_fused_grads``, and one whole
fully fused iteration on the all-axes config against JAX's
``_fused_iteration_body`` on the same injected noise."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mbt_gym_tpu.processes as jp
from mbt_gym_tpu.agents import networks as jnet
from mbt_gym_tpu.agents import ppo as jppo
from mbt_gym_tpu.ops import fused_ppo as jfused
from mbt_gym_tpu.utils import config as jax_config

from mbt_gym_torch import convert
from mbt_gym_torch.agents import ppo
from mbt_gym_torch.ops import fused_ppo
from mbt_gym_torch.ops import mlp_rollout as mr
from tests.test_torch_env import torch_config
from tests.test_torch_networks import assert_trees_close, jax_numpy_tree, tree_items

STEPS, LANES = 4, 64  # K4's minibatch: 4 steps x 64 envs
DIMS = pytest.mark.parametrize("dims", [(9, 4), (16, 4), (9, 1)], ids=["S9-A4", "S16-A4", "S9-A1"])
DTYPES = pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])


def _params(s_dim, a_dim, shared_trunk, seed=3):
    params = jnet.init_actor_critic(jax.random.PRNGKey(seed), s_dim, a_dim, hidden=(32, 32),
                                    shared_trunk=shared_trunk)
    return params, convert.actor_critic_from_numpy(jax_numpy_tree(params), device="cpu")


def _samples(params, s_dim, a_dim, m, seed):
    """obs, actions, old log-probs (perturbed so both clip branches occur),
    advantages and returns, row-major, as numpy."""
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(m, s_dim)).astype(np.float32)
    mean, values = jnet.policy_value(params, jnp.asarray(obs))
    actions = np.array(mean + jnp.exp(params["log_std"]) * rng.normal(size=(m, a_dim)).astype(np.float32))
    log_probs = np.asarray(jnet.gaussian_log_prob(params, mean, jnp.asarray(actions)))
    log_probs = (log_probs + 0.3 * rng.normal(size=m)).astype(np.float32)
    adv = rng.normal(size=m).astype(np.float32)
    returns = (np.asarray(values) + rng.normal(size=m)).astype(np.float32)
    return obs, actions, log_probs, adv, returns


def _assert_close(model, grads, metrics, want_g, want_m, compute_dtype, bf16_bound=1e-2):
    """float32: grads rtol 2e-4 / atol 2e-6; bf16: each leaf's relative
    Frobenius error at most ``bf16_bound`` (K4's every-trunk tests' 1e-2,
    K7's 1e-3); metrics rtol 1e-4 / atol 1e-6."""
    got = convert.actor_critic_to_numpy(model, grads)
    want = jax_numpy_tree(want_g)
    if compute_dtype == "float32":
        assert_trees_close(got, want, rtol=2e-4, atol=2e-6)
    else:
        want_items = dict(tree_items(want))
        for path, g in tree_items(got):
            w = want_items[path]
            assert np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30) <= bf16_bound, path
    for name in ("pg_loss", "vf_loss", "approx_kl"):
        np.testing.assert_allclose(float(metrics[name]), float(want_m[name]), rtol=1e-4, atol=1e-6, err_msg=name)


@DTYPES
@pytest.mark.parametrize("shared_trunk", [True, False], ids=["shared", "towers"])
@DIMS
def test_k4_plain_at_wide_observations_matches_jax_interpret_kernel(dims, shared_trunk, compute_dtype):
    """K4 at S = 9 and 16 on both layouts against ppo_fused_grads_T(...,
    interpret=True) on the same feature-major inputs."""
    s_dim, a_dim = dims
    params, model = _params(s_dim, a_dim, shared_trunk)
    rows = _samples(params, s_dim, a_dim, STEPS * LANES, 7 + s_dim)
    to_t = lambda x: np.ascontiguousarray(x.reshape(STEPS, LANES, -1).swapaxes(1, 2))  # noqa: E731
    flat = lambda x: np.ascontiguousarray(x.reshape(STEPS, LANES))  # noqa: E731
    inputs = [to_t(rows[0]), to_t(rows[1])] + [flat(x) for x in rows[2:]]
    want_g, want_m = jfused.ppo_fused_grads_T(params, *(jnp.asarray(x) for x in inputs), clip_eps=0.2, vf_coef=0.5,
                                             tile=LANES, interpret=True, compute_dtype=compute_dtype)
    grads, metrics = fused_ppo.ppo_fused_grads_T(model, *(torch.from_numpy(x) for x in inputs),
                                                 compute_dtype=compute_dtype)
    _assert_close(model, grads, metrics, want_g, want_m, compute_dtype)


@DTYPES
@DIMS
def test_k7_plain_at_wide_observations_matches_jax_interpret_kernel(dims, compute_dtype):
    """K7 at S = 9 and 16 against ppo_fused_grads(..., interpret=True) on
    the same row-major inputs, at JAX K7's rounding points (bf16 per leaf
    to 1e-3, as tests/test_torch_fused_ppo_rm.py holds K7)."""
    s_dim, a_dim = dims
    params, model = _params(s_dim, a_dim, True)
    rows = _samples(params, s_dim, a_dim, STEPS * LANES, 17 + s_dim)
    want_g, want_m = jfused.ppo_fused_grads(params, *(jnp.asarray(x) for x in rows), clip_eps=0.2, vf_coef=0.5,
                                           tile=LANES, interpret=True, compute_dtype=compute_dtype)
    grads, metrics = fused_ppo.ppo_fused_grads(model, *(torch.from_numpy(x) for x in rows),
                                               compute_dtype=compute_dtype)
    _assert_close(model, grads, metrics, want_g, want_m, compute_dtype, bf16_bound=1e-3)


def test_fused_iteration_on_the_all_axes_config_matches_jax():
    """One whole fully fused iteration on the all-axes config (Heston
    midprice with the composite family's processes, S = 9, A = 4) at 128
    envs x 8 steps (the config's dt kept: the Hawkes recursion is unstable
    at larger steps): K3's general kind -> GAE -> 2 env-slice minibatches
    of K4 at S = 9 -> entropy grad -> clip + Adam, float32 update, against
    JAX's _fused_iteration_body in interpret mode on the same channels, at
    tests/test_torch_fused_ppo.py's tolerances (params rtol 5e-4 / atol
    5e-6, metrics rtol 1e-3 / atol 1e-5)."""
    n, t_steps = 128, 8
    base = jax_config.composite_env_config(num_trajectories=n)
    jcfg = dataclasses.replace(base, dynamics=dataclasses.replace(base.dynamics, midprice_model=jp.HestonMidprice()),
                               n_steps=t_steps, terminal_time=base.terminal_time * t_steps / base.n_steps,
                               normalise_observation_space=True, normalise_action_space=True)
    assert (jcfg.state_dim, jcfg.action_dim) == (9, 4)
    kw = dict(hidden=(16, 16), n_epochs=1, n_minibatches=2, shuffle=False, shared_trunk=True, ent_coef=0.01,
              fused_rollout=True, fused_update=True, fused_compute_dtype="float32")
    jcfg_ppo = jppo.PPOConfig(fused_interpret_ok=True, fused_rollout_tile=128, **kw)
    cfg = torch_config(jcfg)
    assert ppo.fused_update_refusal(cfg) is None
    p = mr.rollout_params_from_config(cfg)
    rng = np.random.default_rng(19)
    channels = rng.uniform(size=(t_steps, p.n_channels, n)).astype(np.float32)
    channels[:, 4:] = rng.normal(size=(t_steps, p.n_channels - 4, n)).astype(np.float32)
    params, model = _params(9, 4, True, seed=6)
    opt_state = jppo.make_optimizer(jcfg_ppo).init(params)
    want_params, _, want_m = jppo._fused_iteration_body(jcfg, jcfg_ppo, params, opt_state, jax.random.PRNGKey(0),
                                                        noise=jnp.asarray(channels))
    ppo_cfg = ppo.PPOConfig(**kw)
    ts = ppo.PPOTrainState(model, ppo.make_optimizer(ppo_cfg, model), 0)
    new_ts, metrics = ppo.train_iteration(cfg, ppo_cfg, ts, 0, noise=torch.from_numpy(channels))
    assert_trees_close(convert.actor_critic_to_numpy(new_ts.params), jax_numpy_tree(want_params),
                       rtol=5e-4, atol=5e-6)
    for name in ("pg_loss", "vf_loss", "approx_kl", "entropy", "mean_episode_reward"):
        np.testing.assert_allclose(float(metrics[name]), float(want_m[name]), rtol=1e-3, atol=1e-5, err_msg=name)
