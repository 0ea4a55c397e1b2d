"""mbt_gym_torch.agents.reinforce and networks.init_mlp against the JAX
package's REINFORCE (mbt_gym_tpu/agents/reinforce.py): the reward-to-go,
the loss and its gradient on one fixed trajectory, the optimizer's rate
schedule and steps, the plain MLP's init and conversion, and the epoch's
contract."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mbt_gym_tpu.agents import networks as jnet
from mbt_gym_tpu.agents import reinforce as jrf

from mbt_gym_torch import convert
from mbt_gym_torch.agents import networks, reinforce
from mbt_gym_torch.types import Trajectory
from mbt_gym_torch.utils.config import as_env_config

SIZES = [4, 32, 32, 2]


def _jax_and_port_mlp(seed=0, sizes=SIZES):
    params = jnet.init_mlp(jax.random.PRNGKey(seed), sizes)
    layers = [{k: np.asarray(v) for k, v in layer.items()} for layer in params]
    return params, convert.mlp_from_numpy(layers, device="cpu")


def _trajectory(seed=0, steps=7, n=64):
    rng = np.random.default_rng(seed)
    obs = rng.uniform(-1.0, 1.0, size=(steps + 1, n, 4)).astype(np.float32)
    actions = rng.normal(size=(steps, n, 2)).astype(np.float32) * 0.3
    rewards = rng.normal(size=(steps, n)).astype(np.float32)
    return obs, actions, rewards


def test_reward_to_go_matches_jax():
    rewards = np.random.default_rng(1).normal(size=(20, 33)).astype(np.float32)
    want = np.asarray(jrf.reward_to_go(jnp.asarray(rewards)))
    got = reinforce.reward_to_go(torch.from_numpy(rewards)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(reinforce.reward_to_go(torch.tensor([[1.0], [2.0], [3.0]])).numpy(),
                                  [[6.0], [5.0], [3.0]])


@pytest.mark.parametrize("std", [0.3, 0.05])
def test_loss_and_gradient_match_jax_on_a_fixed_trajectory(std):
    """The score-function loss of reinforce._epoch_loss (reinforce.py:87-92)
    on one fixed trajectory, written from the JAX package's own pieces
    (networks.mlp_apply, reinforce.reward_to_go) under jax.value_and_grad,
    against the port's trajectory_loss and autograd: rtol 1e-5 (of each
    gradient leaf's largest entry for its small entries)."""
    params, model = _jax_and_port_mlp()
    obs, actions, rewards = _trajectory()

    def jax_loss(p):
        means = jnet.mlp_apply(p, jnp.asarray(obs[:-1]))
        z = (jnp.asarray(actions) - means) / std
        log_probs = jnp.sum(-0.5 * z**2 - jnp.log(std) - 0.5 * jnp.log(2 * jnp.pi), axis=-1)
        return -jnp.mean(log_probs * jrf.reward_to_go(jnp.asarray(rewards)))

    want_loss, want_grads = jax.value_and_grad(jax_loss)(params)
    traj = Trajectory(observations=torch.from_numpy(obs), actions=torch.from_numpy(actions),
                      rewards=torch.from_numpy(rewards))
    loss = reinforce.trajectory_loss(model, traj, std)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    for lin, g in zip(model, want_grads):
        for got, want in ((lin.weight.grad.numpy().T, np.asarray(g["w"])), (lin.bias.grad.numpy(), np.asarray(g["b"]))):
            # rtol 1e-5 of each leaf's largest entry: float32 sums in another order
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_optimizer_follows_optax_schedule_and_steps():
    """SGD with ExponentialLR stepped after each update is optax's
    sgd(exponential_decay(lr, 1, decay)): the rate of update k is
    lr * decay**k, and three updates on the same gradients land on the
    same parameters (rtol 1e-6)."""
    cfg = reinforce.ReinforceConfig(learning_rate=0.05, lr_decay=0.9)
    params, model = _jax_and_port_mlp(seed=2)
    optimizer, schedule = reinforce.make_optimizer(cfg, model)
    tx = jrf.make_optimizer(jrf.ReinforceConfig(learning_rate=0.05, lr_decay=0.9))
    opt_state = tx.init(params)
    rng = np.random.default_rng(3)
    sched = optax.exponential_decay(init_value=0.05, transition_steps=1, decay_rate=0.9)
    for k in range(3):
        assert optimizer.param_groups[0]["lr"] == pytest.approx(float(sched(k)), rel=1e-6)
        grads = [{"w": rng.normal(size=layer["w"].shape).astype(np.float32),
                  "b": rng.normal(size=layer["b"].shape).astype(np.float32)} for layer in params]
        updates, opt_state = tx.update([{k2: jnp.asarray(v) for k2, v in g.items()} for g in grads], opt_state, params)
        params = optax.apply_updates(params, updates)
        for lin, g in zip(model, grads):
            lin.weight.grad = torch.from_numpy(g["w"].T.copy())
            lin.bias.grad = torch.from_numpy(g["b"])
        optimizer.step()
        schedule.step()
    for layer, got in zip(params, convert.mlp_to_numpy(model)):
        np.testing.assert_allclose(got["w"], np.asarray(layer["w"]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got["b"], np.asarray(layer["b"]), rtol=1e-6, atol=1e-7)
    assert optimizer.param_groups[0]["lr"] == pytest.approx(0.05 * 0.9**3, rel=1e-6)


def test_init_mlp_shapes_scales_and_seed():
    """networks.py:19-31: (out, in) nn.Linear weights of scale sqrt(2/fan_in)
    and 0.01 on the last layer, zero biases, reproducible from the seed."""
    sizes = [4, 256, 256, 2]
    model = networks.init_mlp(0, sizes, device="cpu")
    assert isinstance(model, torch.nn.ModuleList) and len(model) == 3
    for i, lin in enumerate(model):
        assert tuple(lin.weight.shape) == (sizes[i + 1], sizes[i])
        assert not lin.bias.any()
        scale = math.sqrt(2.0 / sizes[i]) if i < 2 else 0.01
        assert float(lin.weight.std()) == pytest.approx(scale, rel=0.15)
    again = networks.init_mlp(0, sizes, device="cpu")
    assert all(torch.equal(a.weight, b.weight) for a, b in zip(model, again))
    assert not torch.equal(networks.init_mlp(1, sizes, device="cpu")[0].weight, model[0].weight)


def test_mlp_from_numpy_round_trip_and_apply_match_jax():
    params, model = _jax_and_port_mlp(seed=4)
    for layer, got in zip(params, convert.mlp_to_numpy(model)):
        np.testing.assert_array_equal(got["w"], np.asarray(layer["w"]))
        np.testing.assert_array_equal(got["b"], np.asarray(layer["b"]))
    x = np.random.default_rng(5).normal(size=(50, 4)).astype(np.float32)
    want = np.asarray(jnet.mlp_apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = networks.mlp_apply(model, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_std_schedule_matches_jax():
    for cfg in (jrf.ReinforceConfig(action_std=0.3), jrf.ReinforceConfig(action_std=0.3, final_action_std=0.05)):
        port_cfg = reinforce.ReinforceConfig(**dataclasses.asdict(cfg))
        for progress in (0.0, 0.25, 1.0):
            assert reinforce._current_std(port_cfg, progress) == pytest.approx(
                float(jrf._current_std(cfg, jnp.asarray(progress, jnp.float32))), rel=1e-6)


def test_train_epoch_leaves_its_state_and_learns_from_data():
    """One epoch returns a new state (epoch + 1, parameters moved, the rate
    decayed once) and leaves the given one untouched; the same seed gives
    the same epoch.  The rollout is data: the loss's gradient is the score
    term's, nonzero in every layer."""
    raw = as_env_config(num_trajectories=128, n_steps=10)
    env_cfg = dataclasses.replace(raw, normalise_observation_space=True, normalise_action_space=True)
    rf_cfg = reinforce.ReinforceConfig(hidden=(16, 16), action_std=0.3, learning_rate=1e-2, lr_decay=0.9)
    ts = reinforce.init_train_state(env_cfg, rf_cfg, 0, device="cpu")
    before = [p.detach().clone() for p in ts.params.parameters()]
    new, metrics = reinforce.train_epoch(env_cfg, rf_cfg, ts, 7)
    again, metrics2 = reinforce.train_epoch(env_cfg, rf_cfg, ts, 7)
    assert ts.epoch == 0 and new.epoch == 1
    assert all(torch.equal(a, b) for a, b in zip(before, ts.params.parameters()))
    assert all(not torch.equal(a, b) for a, b in zip(before, new.params.parameters()))
    assert all(torch.equal(a, b) for a, b in zip(new.params.parameters(), again.params.parameters()))
    assert float(metrics["loss"]) == float(metrics2["loss"]) and np.isfinite(float(metrics["mean_episode_reward"]))
    assert ts.opt_state.param_groups[0]["lr"] == pytest.approx(1e-2)
    assert new.opt_state.param_groups[0]["lr"] == pytest.approx(1e-2 * 0.9)
    newer, _ = reinforce.train_epoch(env_cfg, rf_cfg, new, 8)
    assert newer.epoch == 2 and newer.opt_state.param_groups[0]["lr"] == pytest.approx(1e-2 * 0.9**2)
