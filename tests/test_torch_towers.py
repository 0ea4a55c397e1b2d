"""The separate pi/vf towers (the reference's SB3 net_arch, the JAX
package's default layout) on the port's kernels' plain versions: K4's and
K3's stacked-trunk modes against the JAX kernels in interpret mode, the
fused update on the engine rollout (K7 on the shared trunk, K4 re-blocked
on the towers) against JAX's _fused_grads_and_metrics and against the
port's autograd path, and one fully fused towers iteration against JAX's
_fused_iteration_body on the same injected noise."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mbt_gym_tpu.agents import ppo as jppo
from mbt_gym_tpu.ops import fused_ppo as jfused
from mbt_gym_tpu.ops import pallas_rollout
from mbt_gym_tpu.utils.config import as_env_config as jax_as_env_config

from mbt_gym_torch import convert
from mbt_gym_torch.agents import networks, ppo
from mbt_gym_torch.ops import fused_ppo
from mbt_gym_torch.ops import mlp_rollout as mr
from tests.test_torch_env import torch_config
from tests.test_torch_fused_ppo import _feature_major, _port_grads, _rel_err
from tests.test_torch_mlp_rollout import _channels
from tests.test_torch_networks import LAYOUTS, assert_trees_close, jax_and_port_params, jax_numpy_tree, tree_items
from tests.test_torch_ppo import _batch

L = 64  # envs per step of a feature-major minibatch


@pytest.mark.parametrize("t_steps", [8, 10])
def test_stacked_k4_plain_matches_jax(t_steps):
    """K4's split mode, float32: against ppo_fused_grads_T(..., interpret=True)
    on towers and against jax.grad of the JAX loss on the same samples
    (tests/test_fused_ppo.py:113-163): grads rtol 2e-4 / atol 2e-6, metrics
    rtol 1e-4 / atol 1e-6.  Grads come back under pi.*, vf.* and log_std."""
    params, model = jax_and_port_params(False, hidden=(32, 32), seed=2)
    arrays = _batch(params, m=t_steps * L, seed=5)
    inputs = _feature_major(arrays, t_steps)
    want_g, want_m = jfused.ppo_fused_grads_T(
        params, *(jnp.asarray(x) for x in inputs), clip_eps=0.2, vf_coef=0.5, tile=L, interpret=True,
        compute_dtype="float32",
    )
    grads, metrics = _port_grads(model, inputs, "float32")
    assert_trees_close(grads, jax_numpy_tree(want_g), rtol=2e-4, atol=2e-6)
    obs, actions, log_probs, adv, returns = (jnp.asarray(x) for x in arrays)
    batch = jppo.RolloutBatch(obs=obs, actions=actions, log_probs=log_probs, values=returns,
                              rewards=jnp.zeros_like(adv), advantages=adv, returns=returns)
    (_, ref_m), ref_g = jax.value_and_grad(jppo._ppo_loss, has_aux=True)(
        params, jppo.PPOConfig(normalise_advantages=False), batch)
    assert_trees_close(grads, jax_numpy_tree(ref_g), rtol=2e-4, atol=2e-6)
    for name in ("pg_loss", "vf_loss", "approx_kl"):
        np.testing.assert_allclose(metrics[name], float(want_m[name]), rtol=1e-4, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(metrics[name], float(ref_m[name]), rtol=1e-4, atol=1e-6, err_msg=name)


def test_stacked_k4_plain_matches_jax_interpret_kernel_bf16():
    """bf16: the same roundings in both (saved activations and 1 - h*h in
    bf16), but XLA's CPU backend may keep bf16 intermediates in float32, so
    each leaf's relative Frobenius error is held to 1e-2 (as the
    shared-trunk K4 test); metrics to rtol 1e-4."""
    params, model = jax_and_port_params(False, hidden=(32, 32), seed=2)
    inputs = _feature_major(_batch(params, m=8 * L, seed=7), 8)
    want_g, want_m = jfused.ppo_fused_grads_T(
        params, *(jnp.asarray(x) for x in inputs), clip_eps=0.2, vf_coef=0.5, tile=L, interpret=True,
        compute_dtype="bfloat16",
    )
    grads, metrics = _port_grads(model, inputs, "bfloat16")
    want_items = dict(tree_items(jax_numpy_tree(want_g)))
    for path, got in tree_items(grads):
        assert _rel_err(got, want_items[path]) <= 1e-2, (path, _rel_err(got, want_items[path]))
    for name in ("pg_loss", "vf_loss", "approx_kl"):
        np.testing.assert_allclose(metrics[name], float(want_m[name]), rtol=1e-4, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("normalised", [True, False], ids=["bf16-normalised", "float32-raw"])
def test_stacked_k3_plain_matches_jax_interpret_kernel(normalised):
    """K3's split mode on (16, 16) towers against collect_rollout_fused(...,
    interpret=True, noise=) on the same (T, 7, N) channels, at
    tests/test_pallas_rollout.py:82-102's tolerances: obs rtol 1e-4 / atol
    2e-4, actions, log-probs and values atol 1e-3, rewards atol 5e-3; GAE
    of those to atol 5e-3 on O(1) returns; inventory paths exact."""
    n, t_steps = 128, 6
    jcfg = dataclasses.replace(jax_as_env_config(num_trajectories=n, n_steps=t_steps),
                               normalise_observation_space=normalised, normalise_action_space=normalised)
    params, model = jax_and_port_params(False, hidden=(16, 16), seed=3)
    channels = _channels(seed=9, steps=t_steps, n=n)
    want = pallas_rollout.collect_rollout_fused(jcfg, params, jax.random.PRNGKey(0), tile=128, interpret=True,
                                                noise=jnp.asarray(channels))
    got = mr.collect_rollout_fused(torch_config(jcfg), model, 0, noise=torch.from_numpy(channels), device="cpu")
    p = mr.rollout_params_from_config(torch_config(jcfg))
    inv = lambda obs: np.rint((obs[..., 1] + 1.0) * p.obs_grad[1] + p.obs_low[1]) if normalised else obs[..., 1]  # noqa: E731
    np.testing.assert_array_equal(inv(got.obs.numpy()), inv(np.asarray(want.obs)))
    for name, atol in (("obs", 2e-4), ("actions", 1e-3), ("log_probs", 1e-3), ("values", 1e-3),
                       ("rewards", 5e-3), ("advantages", 5e-3), ("returns", 5e-3)):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)), rtol=1e-4,
                                   atol=atol, err_msg=name)


def _update_configs(shared_trunk, **kw):
    base = dict(shared_trunk=shared_trunk, ent_coef=0.01, fused_update=True, fused_compute_dtype="float32", **kw)
    # the JAX row-major kernel needs its 64-row tile to divide the minibatch
    return jppo.PPOConfig(fused_tile=64, **base), ppo.PPOConfig(**base)


@LAYOUTS
def test_fused_grads_and_metrics_match_jax(shared_trunk):
    """One row-major minibatch through each package's _fused_grads_and_metrics
    (advantage normalisation, K7 or the re-blocked K4, the entropy grad):
    grads rtol 2e-4 / atol 2e-6, metrics rtol 1e-4 / atol 1e-6."""
    params, model = jax_and_port_params(shared_trunk, hidden=(32, 32), seed=4)
    arrays = _batch(params, m=256, seed=6)
    jcfg, cfg = _update_configs(shared_trunk)
    obs, actions, log_probs, adv, returns = (jnp.asarray(x) for x in arrays)
    want_g, want_m = jppo._fused_grads_and_metrics(
        params, jcfg, jppo.RolloutBatch(obs=obs, actions=actions, log_probs=log_probs, values=returns,
                                        rewards=jnp.zeros_like(adv), advantages=adv, returns=returns))
    grads, metrics = ppo._fused_grads_and_metrics(
        model, cfg, ppo.UpdateBatch(*(torch.from_numpy(np.array(x)) for x in arrays)))
    assert_trees_close(convert.actor_critic_to_numpy(model, grads), jax_numpy_tree(want_g), rtol=2e-4, atol=2e-6)
    for name in ("pg_loss", "vf_loss", "approx_kl", "entropy"):
        np.testing.assert_allclose(float(metrics[name]), float(want_m[name]), rtol=1e-4, atol=1e-6, err_msg=name)


@LAYOUTS
def test_fused_update_train_iteration_matches_autograd(shared_trunk):
    """train_iteration with fused_update on the engine rollout (shuffle off,
    ent_coef 0.01, float32 update) against the port's autograd path from
    the same state and seed, as tests/test_fused_ppo.py:74-110 holds the
    JAX pair: params rtol 5e-4 / atol 5e-6, metrics rtol 1e-3."""
    env_cfg = dataclasses.replace(torch_config(jax_as_env_config(num_trajectories=64, n_steps=8)),
                                  normalise_observation_space=True, normalise_action_space=True)
    _, fused = _update_configs(shared_trunk, hidden=(32, 32), n_epochs=2, n_minibatches=2, shuffle=False)
    base = dataclasses.replace(fused, fused_update=False)
    ts0 = ppo.init_train_state(env_cfg, base, 0, device="cpu")
    ts_ref, m_ref = ppo.train_iteration(env_cfg, base, ts0, 7)
    ts_fused, m_fused = ppo.train_iteration(env_cfg, fused, ts0, 7)
    assert_trees_close(convert.actor_critic_to_numpy(ts_fused.params), convert.actor_critic_to_numpy(ts_ref.params),
                       rtol=5e-4, atol=5e-6)
    for name in ("pg_loss", "vf_loss", "approx_kl", "entropy", "mean_episode_reward"):
        np.testing.assert_allclose(float(m_fused[name]), float(m_ref[name]), rtol=1e-3, atol=1e-5, err_msg=name)


def test_fused_towers_iteration_matches_jax_on_injected_noise():
    """One fully fused towers iteration (K3 split -> GAE -> 2 env-slice
    minibatches of K4 split grads -> entropy grad -> clip + Adam) against
    JAX's _fused_iteration_body in interpret mode on the same (T, 7, N)
    channels, float32 update, ent_coef 0.01: params rtol 5e-4 / atol 5e-6,
    metrics rtol 1e-3 (as the shared-trunk iteration test)."""
    n, t_steps = 128, 8
    jcfg = dataclasses.replace(jax_as_env_config(num_trajectories=n, n_steps=t_steps),
                               normalise_observation_space=True, normalise_action_space=True)
    kw = dict(hidden=(16, 16), n_epochs=1, n_minibatches=2, shuffle=False, shared_trunk=False, ent_coef=0.01,
              fused_rollout=True, fused_update=True, fused_compute_dtype="float32")
    jcfg_ppo = jppo.PPOConfig(fused_interpret_ok=True, fused_rollout_tile=128, **kw)
    channels = _channels(seed=11, steps=t_steps, n=n)
    params, model = jax_and_port_params(False, hidden=(16, 16), seed=6)
    opt_state = jppo.make_optimizer(jcfg_ppo).init(params)
    want_params, _, want_m = jppo._fused_iteration_body(
        jcfg, jcfg_ppo, params, opt_state, jax.random.PRNGKey(0), noise=jnp.asarray(channels))
    cfg = ppo.PPOConfig(**kw)
    ts = ppo.PPOTrainState(model, ppo.make_optimizer(cfg, model), 0)
    new_ts, metrics = ppo.train_iteration(torch_config(jcfg), cfg, ts, 0, noise=torch.from_numpy(channels))
    assert_trees_close(convert.actor_critic_to_numpy(new_ts.params), jax_numpy_tree(want_params),
                       rtol=5e-4, atol=5e-6)
    for name in ("pg_loss", "vf_loss", "approx_kl", "entropy", "mean_episode_reward"):
        np.testing.assert_allclose(float(metrics[name]), float(want_m[name]), rtol=1e-3, atol=1e-5, err_msg=name)


def test_evaluate_policy_fused_on_towers():
    """evaluate_policy(backend="fused") runs K3's split mode (its plain
    version here) on a towers model: the mean reward of the K3 rollout with
    log_std = -30, finite, equal to the same rollout taken by hand."""
    env_cfg = dataclasses.replace(torch_config(jax_as_env_config(num_trajectories=128, n_steps=8)),
                                  normalise_observation_space=True, normalise_action_space=True)
    model = networks.init_actor_critic(0, 4, 2, (16, 16), shared_trunk=False, device="cpu")
    got = float(ppo.evaluate_policy(env_cfg, model, 5, 1, backend="fused"))
    det = networks.init_actor_critic(0, 4, 2, (16, 16), shared_trunk=False, device="cpu")
    with torch.no_grad():
        det.log_std.fill_(-30.0)
    tb = mr.collect_rollout_fused_T(env_cfg, det, torch.Generator().manual_seed(5), device="cpu")
    assert np.isfinite(got) and got == float(tb.rewards.sum(dim=0).mean())
    assert float(model.log_std.detach()[0]) == -0.5  # the caller's model is untouched


def test_reblocking_lanes_rule():
    """The towers minibatch is re-blocked on the largest power of two up to
    1024 lanes that divides it (ppo.py:246-248 at the default fused_tile)."""
    assert ppo._lanes(3_276_800) == 1024
    assert ppo._lanes(256) == 256
    assert ppo._lanes(96) == 32
    assert ppo._lanes(250) == 2


def test_mlp_rollout_dispatch_family(monkeypatch):
    """deterministic_policy's mlp_rollout family: mode "evaluate" on a CUDA
    target follows the port's measurement on the card for each layout, and
    names its figures (a width off a multiple of 4 too: K3 takes any
    width; past 256, those measured at 512x512); the other modes, a CPU target, a config outside K3's family and
    a trunk past its depth cap take the engine with a named reason."""
    from mbt_gym_torch.dispatch import MLP_EVALUATE_MEASURED, dispatch_report

    env_cfg = dataclasses.replace(torch_config(jax_as_env_config(num_trajectories=128, n_steps=8)),
                                  normalise_observation_space=True, normalise_action_space=True)
    policy = ppo.deterministic_policy(env_cfg)
    for layout, shared_trunk in (("shared trunk", True), ("separate towers", False)):
        model = networks.init_actor_critic(0, 4, 2, (16, 16), shared_trunk=shared_trunk, device="cpu")
        d = dispatch_report(env_cfg, policy, mode="evaluate", platform="cuda", policy_params=model)
        fused, engine = MLP_EVALUATE_MEASURED[layout]
        assert (d.backend, d.family) == (("fused", "mlp_rollout") if fused > engine else ("engine", None))
        assert layout in d.reason and "env-steps/s" in d.reason and "H100" in d.reason, d.reason
        d = dispatch_report(env_cfg, policy, mode="evaluate", platform="cpu", policy_params=model)
        assert d.backend == "engine" and "requires a CUDA device" in d.reason
    for mode in ("rollout", "stats"):
        d = dispatch_report(env_cfg, policy, mode=mode, platform="cuda")
        assert d.backend == "engine" and "serves evaluate_policy" in d.reason
    # random start times run on K3's t0 plane; a float64 config stays outside its family
    late = dataclasses.replace(env_cfg, start_time=("uniform", 0.0, 0.5))
    d = dispatch_report(late, ppo.deterministic_policy(late), mode="evaluate", platform="cuda")
    assert (d.backend, d.family) == ("fused", "mlp_rollout")
    wide = dataclasses.replace(env_cfg, dtype="float64")
    d = dispatch_report(wide, ppo.deterministic_policy(wide), mode="evaluate", platform="cuda")
    assert d.backend == "engine" and "float64 reference-parity" in d.reason
    odd = networks.init_actor_critic(0, 4, 2, (18, 18), shared_trunk=True, device="cpu")
    d = dispatch_report(env_cfg, policy, mode="evaluate", platform="cuda", policy_params=odd)
    fused, engine = MLP_EVALUATE_MEASURED["shared trunk"]
    assert (d.backend, d.family) == (("fused", "mlp_rollout") if fused > engine else ("engine", None))
    from mbt_gym_torch.dispatch import MLP_EVALUATE_MEASURED_WIDE

    wide = networks.init_actor_critic(0, 4, 2, (300, 300), shared_trunk=False, device="cpu")
    d = dispatch_report(env_cfg, policy, mode="evaluate", platform="cuda", policy_params=wide)
    fused, engine = MLP_EVALUATE_MEASURED_WIDE["separate towers"]
    assert (d.backend, d.family) == (("fused", "mlp_rollout") if fused > engine else ("engine", None))
    assert "512x512" in d.reason and "phase 32a" in d.reason, d.reason
    deep = networks.init_actor_critic(0, 4, 2, (4,) * 65, shared_trunk=True, device="cpu")
    d = dispatch_report(env_cfg, policy, mode="evaluate", platform="cuda", policy_params=deep)
    assert d.backend == "engine" and "1-64 trunk layers" in d.reason
    from mbt_gym_torch.ops import det_rollout

    monkeypatch.setattr(det_rollout, "device_free_bytes", lambda device=None: 1 << 10)
    d = dispatch_report(env_cfg, policy, mode="evaluate", platform="cuda")
    assert d.backend == "engine" and "exceed free device memory" in d.reason
    monkeypatch.undo()
    from mbt_gym_torch.agents.baseline import AvellanedaStoikovAgent

    as_policy = AvellanedaStoikovAgent.from_config(env_cfg, risk_aversion=0.1).policy()
    d = dispatch_report(env_cfg, as_policy, mode="evaluate", platform="cuda")
    assert d.backend == "engine" and "evaluate_policy's contract" in d.reason
