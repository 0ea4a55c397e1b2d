"""mbt_gym_torch actor-critic networks against the JAX package's.

JAX parameters cross into the port as numpy (``convert.actor_critic_from_numpy``)
and both packages evaluate the same observations, made with numpy from a
seed.  This file also holds the tree helpers the other PPO parity tests use.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mbt_gym_tpu.agents import networks as jnet

from mbt_gym_torch import convert
from mbt_gym_torch.agents import networks


def jax_numpy_tree(tree):
    """A JAX pytree as the same nesting of numpy arrays."""
    return jax.tree_util.tree_map(np.asarray, tree)


def tree_items(tree, path=""):
    """(path, array) for every leaf of a dict/list tree, in sorted-key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_items(v, f"{path}/{i}")
    else:
        yield path, np.asarray(tree)


def assert_trees_close(got, want, rtol, atol):
    got_items, want_items = dict(tree_items(got)), dict(tree_items(want))
    assert got_items.keys() == want_items.keys()
    for path, w in want_items.items():
        assert got_items[path].shape == w.shape, path
        np.testing.assert_allclose(got_items[path], w, rtol=rtol, atol=atol, err_msg=path)


def jax_and_port_params(shared_trunk, hidden=(32, 32), seed=1):
    params = jnet.init_actor_critic(jax.random.PRNGKey(seed), 4, 2, hidden=hidden, shared_trunk=shared_trunk)
    return params, convert.actor_critic_from_numpy(jax_numpy_tree(params), device="cpu")


LAYOUTS = pytest.mark.parametrize("shared_trunk", [True, False], ids=["shared", "towers"])


@LAYOUTS
def test_convert_roundtrip_is_exact(shared_trunk):
    params, model = jax_and_port_params(shared_trunk)
    tree = convert.actor_critic_to_numpy(model)
    assert_trees_close(tree, jax_numpy_tree(params), rtol=0, atol=0)
    assert model.shared_trunk == shared_trunk
    if shared_trunk:
        assert tuple(model.shared[0].weight.shape) == (32, 4)  # nn.Linear (out, in)


@LAYOUTS
@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"], ids=["f32", "bf16"])
def test_policy_value_matches_jax(shared_trunk, compute_dtype):
    """float32: to float32 rounding (rtol 1e-5, atol 1e-6).  bf16 operands
    with the JAX package's casts (mlp_apply's semantics): within one bf16
    rounding of the ~0.1-scale outputs (atol 1e-3)."""
    params, model = jax_and_port_params(shared_trunk)
    obs = np.random.default_rng(0).normal(size=(256, 4)).astype(np.float32)
    jdt = None if compute_dtype is None else jnp.bfloat16
    want_mean, want_v = jnet.policy_value(params, jnp.asarray(obs), compute_dtype=jdt)
    got_mean, got_v = networks.policy_value(model, torch.from_numpy(obs), compute_dtype)
    rtol, atol = (1e-5, 1e-6) if compute_dtype is None else (0, 1e-3)
    assert got_mean.dtype == torch.float32 and tuple(got_v.shape) == (256,)
    np.testing.assert_allclose(got_mean.detach().numpy(), np.asarray(want_mean), rtol=rtol, atol=atol)
    np.testing.assert_allclose(got_v.detach().numpy(), np.asarray(want_v), rtol=rtol, atol=atol)
    np.testing.assert_allclose(
        networks.policy_mean(model, torch.from_numpy(obs), compute_dtype).detach().numpy(),
        np.asarray(jnet.policy_mean(params, jnp.asarray(obs), compute_dtype=jdt)), rtol=rtol, atol=atol,
    )
    np.testing.assert_allclose(
        networks.value(model, torch.from_numpy(obs), compute_dtype).detach().numpy(),
        np.asarray(jnet.value(params, jnp.asarray(obs), compute_dtype=jdt)), rtol=rtol, atol=atol,
    )


@LAYOUTS
def test_log_prob_and_entropy_match_jax(shared_trunk):
    params, model = jax_and_port_params(shared_trunk)
    rng = np.random.default_rng(4)
    mean = rng.normal(size=(128, 2)).astype(np.float32)
    action = rng.normal(size=(128, 2)).astype(np.float32)
    want = jnet.gaussian_log_prob(params, jnp.asarray(mean), jnp.asarray(action))
    got = networks.gaussian_log_prob(model, torch.from_numpy(mean), torch.from_numpy(action))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(networks.entropy(model).detach()), float(jnet.entropy(params)), rtol=1e-6)


@LAYOUTS
def test_init_actor_critic_scales(shared_trunk):
    """The port draws its own normals (torch.Generator), at the JAX
    package's scales: sqrt(2/fan_in) hidden, 0.01 heads, zero biases,
    log_std -0.5."""
    model = networks.init_actor_critic(0, 4, 2, hidden=(256, 256), shared_trunk=shared_trunk, device="cpu")
    again = networks.init_actor_critic(0, 4, 2, hidden=(256, 256), shared_trunk=shared_trunk, device="cpu")
    for (name, p), (_, q) in zip(model.named_parameters(), again.named_parameters()):
        assert torch.equal(p, q), name
    tree = convert.actor_critic_to_numpy(model)
    ref = jax_numpy_tree(jnet.init_actor_critic(jax.random.PRNGKey(0), 4, 2, hidden=(256, 256),
                                                shared_trunk=shared_trunk))
    for (path, got), (_, want) in zip(tree_items(tree), tree_items(ref)):
        assert got.shape == want.shape, path
        if path.endswith("/b"):
            assert not got.any(), path
        elif path.endswith("/w"):
            np.testing.assert_allclose(got.std(), want.std(), rtol=0.25, err_msg=path)
    np.testing.assert_array_equal(tree["log_std"], np.full(2, -0.5, np.float32))
