"""mbt_gym_torch PPO learner against the JAX package's: the loss and its
autograd grads, GAE, one optimizer step, the engine train_iteration on the
CPU, train_chunk, evaluation, and the named refusals outside the
kernels' contract.  Inputs are made with numpy from seeds and handed to
both packages."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from __graft_entry__ import _assert_metric_bands
from mbt_gym_tpu.agents import networks as jnet
from mbt_gym_tpu.agents import ppo as jppo

from mbt_gym_torch import convert
from mbt_gym_torch.agents import networks, ppo
from mbt_gym_torch.utils.config import as_env_config
from tests.test_torch_networks import assert_trees_close, jax_and_port_params, jax_numpy_tree


def _batch(params, m=256, seed=5, perturb=0.3):
    """obs, actions, old log-probs (perturbed so both clip branches occur),
    advantages and returns as numpy (tests/test_fused_ppo.py:16-27)."""
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(m, 4)).astype(np.float32)
    mean, values = jnet.policy_value(params, jnp.asarray(obs))
    actions = np.asarray(mean + jnp.exp(params["log_std"]) * rng.normal(size=(m, 2)).astype(np.float32))
    log_probs = np.asarray(jnet.gaussian_log_prob(params, mean, jnp.asarray(actions)))
    log_probs = (log_probs + perturb * rng.normal(size=m)).astype(np.float32)
    adv = rng.normal(size=m).astype(np.float32)
    returns = (np.asarray(values) + rng.normal(size=m)).astype(np.float32)
    return obs, actions, log_probs, adv, returns


def _named(model, grads_tree):
    """A ``{parameter name: tensor}`` dict from a JAX-layout tree."""
    return dict(convert.actor_critic_from_numpy(grads_tree, device="cpu").named_parameters())


def _loss_and_grads(model, cfg, arrays):
    obs, actions, log_probs, adv, returns = (torch.from_numpy(np.array(x)) for x in arrays)
    batch = ppo.UpdateBatch(obs, actions, log_probs, adv, returns)
    model.zero_grad(set_to_none=True)
    loss, metrics = ppo._ppo_loss(model, cfg, batch)
    loss.backward()
    grads = {name: p.grad for name, p in model.named_parameters()}
    return float(loss.detach()), metrics, convert.actor_critic_to_numpy(model, grads)


def _jax_loss_and_grads(params, cfg, arrays):
    obs, actions, log_probs, adv, returns = (jnp.asarray(x) for x in arrays)
    batch = jppo.RolloutBatch(obs=obs, actions=actions, log_probs=log_probs, values=returns,
                              rewards=jnp.zeros_like(adv), advantages=adv, returns=returns)
    (loss, metrics), grads = jax.value_and_grad(jppo._ppo_loss, has_aux=True)(params, cfg, batch)
    return float(loss), metrics, jax_numpy_tree(grads)


@pytest.mark.parametrize("shared_trunk", [True, False], ids=["shared", "towers"])
@pytest.mark.parametrize("normalise", [False, True], ids=["raw-adv", "normalised-adv"])
def test_ppo_loss_and_grads_match_jax(shared_trunk, normalise):
    """Loss, metrics and autograd grads against jax.value_and_grad at
    tests/test_fused_ppo.py:63-71's tolerances (grads rtol 2e-4 / atol
    2e-6, metrics rtol 1e-4 / atol 1e-6).  The normalised case uses the
    population std, as jnp.std does."""
    params, model = jax_and_port_params(shared_trunk)
    kw = dict(normalise_advantages=normalise, ent_coef=0.01, shared_trunk=shared_trunk)
    arrays = _batch(params)
    loss, metrics, grads = _loss_and_grads(model, ppo.PPOConfig(**kw), arrays)
    want_loss, want_metrics, want_grads = _jax_loss_and_grads(params, jppo.PPOConfig(**kw), arrays)
    assert_trees_close(grads, want_grads, rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-4, atol=1e-6)
    for name in ("pg_loss", "vf_loss", "approx_kl", "entropy"):
        np.testing.assert_allclose(float(metrics[name].detach()), float(want_metrics[name]), rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_ppo_loss_grads_at_ties_match_jax():
    """Old log-probs equal to each package's own current log-probs: every
    ratio is exactly 1, where pg1 == pg2 and jnp.minimum / torch.minimum
    split the gradient between the two branches."""
    params, model = jax_and_port_params(True)
    obs, actions, _, adv, returns = _batch(params)
    mean, _ = jnet.policy_value(params, jnp.asarray(obs))
    jax_logp = np.asarray(jnet.gaussian_log_prob(params, mean, jnp.asarray(actions)))
    with torch.no_grad():
        t_mean, _ = networks.policy_value(model, torch.from_numpy(obs))
        port_logp = networks.gaussian_log_prob(model, t_mean, torch.tensor(actions)).numpy()
    cfg = dict(normalise_advantages=False, shared_trunk=True)
    _, metrics, grads = _loss_and_grads(model, ppo.PPOConfig(**cfg), (obs, actions, port_logp, adv, returns))
    _, _, want = _jax_loss_and_grads(params, jppo.PPOConfig(**cfg), (obs, actions, jax_logp, adv, returns))
    assert float(metrics["approx_kl"].detach()) == 0.0
    assert_trees_close(grads, want, rtol=2e-4, atol=2e-6)


def test_compute_gae_matches_jax():
    """GAE(lambda) in the JAX recursion's op order, each op rounded to
    float32: exact against a numpy float32 replay of that order.  XLA's CPU
    backend contracts ``r + gamma*v'`` and ``delta + gamma*lam*gae'`` into
    fused multiply-adds (a float64 replay with those two FMAs reproduces it
    bit for bit), so against JAX the two agree to those roundings:
    atol 4e-6 on O(1-10) advantages."""
    rng = np.random.default_rng(3)
    rewards = rng.normal(size=(10, 64)).astype(np.float32)
    values = rng.normal(size=(10, 64)).astype(np.float32)
    last = rng.normal(size=64).astype(np.float32)
    gamma, lam = 0.99, 0.95
    adv, ret = ppo.compute_gae(torch.from_numpy(rewards), torch.from_numpy(values), torch.from_numpy(last),
                               gamma, lam)
    f32 = np.float32
    replay = np.empty_like(rewards)
    gae_next, value_next = np.zeros(64, f32), last
    for t in range(9, -1, -1):
        delta = (rewards[t] + f32(gamma) * value_next) - values[t]
        gae_next = delta + f32(gamma * lam) * gae_next
        replay[t], value_next = gae_next, values[t]
    np.testing.assert_array_equal(adv.numpy(), replay)
    np.testing.assert_array_equal(ret.numpy(), replay + values)
    want_adv, want_ret = jppo.compute_gae(jnp.asarray(rewards), jnp.asarray(values), jnp.asarray(last), gamma, lam)
    np.testing.assert_allclose(adv.numpy(), np.asarray(want_adv), rtol=0, atol=4e-6)
    np.testing.assert_allclose(ret.numpy(), np.asarray(want_ret), rtol=0, atol=4e-6)


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0], ids=["unclipped", "clipped"])
def test_optimizer_steps_match_optax(grad_scale):
    """Two clip + Adam steps on the same grads: the global-norm clip follows
    optax's formula (no 1e-6 in the norm); params to rtol 1e-5 / atol 1e-7."""
    params, model = jax_and_port_params(True)
    cfg = ppo.PPOConfig(shared_trunk=True, max_grad_norm=0.5)
    tx = jppo.make_optimizer(jppo.PPOConfig(shared_trunk=True, max_grad_norm=0.5))
    opt_state = tx.init(params)
    optimizer = ppo.make_optimizer(cfg, model)
    rng = np.random.default_rng(8)
    for _ in range(2):
        grads = jax.tree_util.tree_map(
            lambda x: jnp.asarray(grad_scale * rng.normal(size=x.shape).astype(np.float32)), params)
        norm = float(optax.global_norm(grads))
        assert (norm >= 0.5) == (grad_scale > 1)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        ppo.apply_gradients(cfg, model, optimizer, _named(model, jax_numpy_tree(grads)))
    assert_trees_close(convert.actor_critic_to_numpy(model), jax_numpy_tree(params), rtol=1e-5, atol=1e-7)


def _env(n=256, steps=16):
    return dataclasses.replace(as_env_config(num_trajectories=n, n_steps=steps),
                               normalise_observation_space=True, normalise_action_space=True)


@pytest.mark.parametrize("shared_trunk", [True, False], ids=["shared", "towers"])
def test_engine_train_iteration_in_bands_on_cpu(shared_trunk):
    """The engine path (rollout, GAE, 2 epochs x 4 shuffled minibatches,
    autograd, clip + Adam) runs on the CPU, stays inside
    __graft_entry__._assert_metric_bands, moves the params and leaves the
    state it was given untouched."""
    env_cfg = _env()
    cfg = ppo.PPOConfig(hidden=(32, 32), n_epochs=2, n_minibatches=4, shared_trunk=shared_trunk,
                        compute_dtype="bfloat16")
    ts = ppo.init_train_state(env_cfg, cfg, 0, device="cpu")
    before = convert.actor_critic_to_numpy(ts.params)
    ts2, metrics = ppo.train_iteration(env_cfg, cfg, ts, 1)
    _assert_metric_bands(metrics, "engine")
    assert ts2.update_count == 1 and ts.update_count == 0
    assert_trees_close(convert.actor_critic_to_numpy(ts.params), before, rtol=0, atol=0)
    moved = [np.abs(a - b).max() for (_, a), (_, b) in zip(
        sorted(_flat(convert.actor_critic_to_numpy(ts2.params))), sorted(_flat(before)))]
    assert max(moved) > 0


def _flat(tree):
    from tests.test_torch_networks import tree_items

    return list(tree_items(tree))


def test_train_chunk_equals_sequential_iterations():
    env_cfg = _env(n=128, steps=8)
    cfg = ppo.PPOConfig(hidden=(16, 16), n_epochs=1, n_minibatches=2, shared_trunk=True)
    ts = ppo.init_train_state(env_cfg, cfg, 2, device="cpu")
    chunk_ts, chunk_m = ppo.train_chunk(env_cfg, cfg, ts, 9, 3)
    assert all(v.shape == (3,) for v in chunk_m.values())
    seq = ts
    for i, k in enumerate(ppo.iteration_keys(9, 3)):
        seq, m = ppo.train_iteration(env_cfg, cfg, seq, k)
        for name, v in m.items():
            assert float(v) == float(chunk_m[name][i]), name
    assert chunk_ts.update_count == seq.update_count == 3
    assert_trees_close(convert.actor_critic_to_numpy(chunk_ts.params),
                       convert.actor_critic_to_numpy(seq.params), rtol=0, atol=0)


def test_unported_fused_layouts_raise_named_errors():
    """Every fused config (either fused flag on the towers, fused_update
    alone on either layout, evaluate_policy's fused backend on the towers)
    runs on the CPU through the plain versions with finite metrics in the
    bands.  What is outside the kernels' contract raises by name: towers
    of unequal widths, and a trunk past the CUDA kernels' depth cap; a
    trunk past the old limits (nine layers) is taken."""
    from mbt_gym_torch.ops import fused_ppo

    env_cfg = _env(n=128, steps=8)
    base = dict(hidden=(16, 16), n_epochs=1, n_minibatches=2)
    for kw in (dict(shared_trunk=False, fused_rollout=True, fused_update=True, shuffle=False),
               dict(shared_trunk=False, fused_rollout=True),
               dict(shared_trunk=False, fused_update=True),
               dict(shared_trunk=True, fused_update=True)):
        cfg = ppo.PPOConfig(**base, **kw)
        ts = ppo.init_train_state(env_cfg, cfg, 0, device="cpu")
        _, metrics = ppo.train_iteration(env_cfg, cfg, ts, 0)
        _assert_metric_bands(metrics, str(kw))
    towers = networks.init_actor_critic(0, 4, 2, (16, 16), device="cpu")
    assert np.isfinite(float(ppo.evaluate_policy(env_cfg, towers, 0, backend="fused")))
    cfg = ppo.PPOConfig(**base, shared_trunk=False, fused_update=True)
    ts = ppo.init_train_state(env_cfg, cfg, 0, device="cpu")
    ts.params.vf = torch.nn.ModuleList([torch.nn.Linear(4, 8), torch.nn.Linear(8, 16), torch.nn.Linear(16, 1)])
    with pytest.raises(ValueError, match="towers must have matching widths"):
        ppo.train_iteration(env_cfg, cfg, ppo.PPOTrainState(ts.params, ppo.make_optimizer(cfg, ts.params), 0), 0)
    assert fused_ppo.check_kernel_limits(towers, 1024, 2, "K4") == fused_ppo.KernelShape(2, (16, 16), (64, 64))
    deep = networks.init_actor_critic(0, 4, 2, (16,) * 9, device="cpu")
    assert fused_ppo.check_kernel_limits(deep, 1024, 2, "K4") == fused_ppo.KernelShape(2, (16,) * 9, (64,) * 9)
    deeper = networks.init_actor_critic(0, 4, 2, (4,) * (fused_ppo.MAX_LAYERS + 1), device="cpu")
    with pytest.raises(ValueError, match=f"K4 kernel takes 1-{fused_ppo.MAX_LAYERS} trunk layers"):
        fused_ppo.check_kernel_limits(deeper, 1024, 2, "K4")


def test_fused_rollout_with_engine_update_runs_on_cpu():
    """fused_rollout alone: K3 (its plain version on the CPU) feeds the
    engine update."""
    env_cfg = _env(n=128, steps=8)
    cfg = ppo.PPOConfig(hidden=(16, 16), n_epochs=1, n_minibatches=2, shared_trunk=True, fused_rollout=True)
    ts = ppo.init_train_state(env_cfg, cfg, 0, device="cpu")
    _, metrics = ppo.train_iteration(env_cfg, cfg, ts, 4)
    _assert_metric_bands(metrics, "fused-rollout")


def test_evaluate_policy_backends_and_dispatch_reason():
    from mbt_gym_torch.dispatch import dispatch_report

    env_cfg = _env(n=128, steps=8)
    model = networks.init_actor_critic(0, 4, 2, (16, 16), shared_trunk=True, device="cpu")
    auto = float(ppo.evaluate_policy(env_cfg, model, 5, 2))
    engine = float(ppo.evaluate_policy(env_cfg, model, 5, 2, backend="engine"))
    fused = float(ppo.evaluate_policy(env_cfg, model, 5, 2, backend="fused"))
    assert auto == engine and np.isfinite(fused) and abs(fused) < 200
    decision = dispatch_report(env_cfg, ppo.deterministic_policy(env_cfg), platform="cuda")
    assert decision.backend == "engine" and "mlp_rollout kernel family" in decision.reason
    # random start times run on K3's t0 plane; a float64 config is refused by name
    late = float(ppo.evaluate_policy(dataclasses.replace(env_cfg, start_time=("uniform", 0.0, 0.5)), model, 0,
                                     backend="fused"))
    assert np.isfinite(late)
    with pytest.raises(ValueError, match="backend='fused' unavailable: .*float64 reference-parity"):
        ppo.evaluate_policy(dataclasses.replace(env_cfg, dtype="float64"), model, 0, backend="fused")


def test_ppo_config_matches_jax_and_carries_across():
    jfields = {f.name: f.default for f in dataclasses.fields(jppo.PPOConfig)}
    fields = {f.name: f.default for f in dataclasses.fields(ppo.PPOConfig)}
    assert fields == jfields
    jcfg = jppo.PPOConfig(hidden=(256, 256), n_epochs=1, n_minibatches=16, shuffle=False,
                          compute_dtype="bfloat16", shared_trunk=True, fused_rollout=True, fused_update=True)
    spec = {"type": "PPOConfig", **{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}}
    spec["hidden"] = list(spec["hidden"])
    assert convert.ppo_config_from_spec(spec) == ppo.PPOConfig(**dataclasses.asdict(jcfg))
    with pytest.raises(ValueError, match="unknown PPOConfig fields"):
        convert.ppo_config_from_spec({"tile": 3})
