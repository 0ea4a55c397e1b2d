"""K7's plain version (mbt_gym_torch.ops.fused_ppo.ppo_fused_grads_plain,
the row-major fused PPO update) against the JAX package's
ppo_fused_grads run in interpret mode and against jax.grad of the JAX
loss (as tests/test_fused_ppo.py:30-71), and against the port's own K4
plain version on the same samples."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mbt_gym_tpu.agents import ppo as jppo
from mbt_gym_tpu.ops import fused_ppo as jfused

from mbt_gym_torch import convert
from mbt_gym_torch.ops import fused_ppo
from tests.test_torch_networks import assert_trees_close, jax_and_port_params, jax_numpy_tree, tree_items
from tests.test_torch_ppo import _batch

M = 256
TILE = 64  # the JAX kernel's row tile in interpret mode
# JAX's own test trunks (tests/test_fused_ppo.py:30), unequal widths the
# CUDA kernels pad, and three layers
TRUNKS = [(32, 32), (64,), (36, 100), (24, 16, 8)]
TRUNK_IDS = ["32x32", "64", "36x100", "24x16x8"]


def _port(model, arrays, compute_dtype):
    grads, metrics = fused_ppo.ppo_fused_grads(
        model, *(torch.tensor(x) for x in arrays), clip_eps=0.2, vf_coef=0.5, compute_dtype=compute_dtype,
    )
    assert set(grads) == {name for name, _ in model.named_parameters()}
    return convert.actor_critic_to_numpy(model, grads), {k: float(v) for k, v in metrics.items()}


def _jax_grad(params, arrays):
    obs, actions, log_probs, adv, returns = (jnp.asarray(x) for x in arrays)
    batch = jppo.RolloutBatch(obs=obs, actions=actions, log_probs=log_probs, values=returns,
                              rewards=jnp.zeros_like(adv), advantages=adv, returns=returns)
    (_, metrics), grads = jax.value_and_grad(jppo._ppo_loss, has_aux=True)(
        params, jppo.PPOConfig(normalise_advantages=False), batch)
    return jax_numpy_tree(grads), metrics


def _jax_kernel(params, arrays, compute_dtype):
    grads, metrics = jfused.ppo_fused_grads(
        params, *(jnp.asarray(x) for x in arrays), clip_eps=0.2, vf_coef=0.5, tile=TILE, interpret=True,
        compute_dtype=compute_dtype,
    )
    return jax_numpy_tree(grads), metrics


@pytest.mark.parametrize("reference", ["jax.grad", "interpret-kernel"])
@pytest.mark.parametrize("hidden", TRUNKS, ids=TRUNK_IDS)
def test_plain_grads_match_jax_float32(hidden, reference):
    """float32 grads to rtol 2e-4 / atol 2e-6 and metrics to rtol 1e-4 /
    atol 1e-6 (tests/test_fused_ppo.py:63-71), at any trunk depth."""
    params, model = jax_and_port_params(True, hidden=hidden, seed=0)
    arrays = _batch(params, m=M, seed=1)
    if reference == "jax.grad":
        want_g, want_m = _jax_grad(params, arrays)
    else:
        want_g, want_m = _jax_kernel(params, arrays, "float32")
    grads, metrics = _port(model, arrays, "float32")
    assert_trees_close(grads, want_g, rtol=2e-4, atol=2e-6)
    for name in ("pg_loss", "vf_loss", "approx_kl"):
        np.testing.assert_allclose(metrics[name], float(want_m[name]), rtol=1e-4, atol=1e-6, err_msg=name)


def _rel_err(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.mark.parametrize("hidden", [(32, 32), (64,)], ids=["32x32", "64"])
def test_plain_grads_match_jax_interpret_kernel_bf16(hidden):
    """bf16 against the interpret-mode kernel at bf16.  Both round every
    matmul operand to bf16; the port also rounds the saved activations and
    evaluates 1 - h*h in bf16 (K4's points, which K7 shares on the card),
    where the JAX row-major kernel keeps both in float32, and XLA's CPU
    backend may keep bf16 intermediates in float32.  So each leaf's
    relative Frobenius error is held to 1e-2 (5.2e-3 seen), as the
    feature-major K4 test holds it; metrics to rtol 1e-4."""
    params, model = jax_and_port_params(True, hidden=hidden, seed=0)
    arrays = _batch(params, m=M, seed=2)
    _assert_bf16_close(_port(model, arrays, "bfloat16"), _jax_kernel(params, arrays, "bfloat16"))


@pytest.mark.parametrize("hidden", TRUNKS, ids=TRUNK_IDS)
def test_plain_grads_match_jax_feature_major_kernel_bf16(hidden):
    """bf16 at every trunk shape against JAX's interpret-mode K4
    (``ppo_fused_grads_T``) on the same samples as one step of M envs: the
    JAX function that rounds where the port's K7 rounds (its saved
    activations and 1 - h*h in bf16).  Against JAX's K7, which keeps those
    in float32, the difference grows with each layer (7.5e-3 to 1.02e-2 of
    the layer-0 grads at three layers, against 5.6e-3 to 6.6e-3 here).
    Each leaf to 1e-2, metrics to rtol 1e-4."""
    params, model = jax_and_port_params(True, hidden=hidden, seed=0)
    arrays = _batch(params, m=M, seed=2)
    obs, actions, log_probs, adv, returns = arrays
    to_t = lambda x: jnp.asarray(x.reshape(1, M, -1).swapaxes(1, 2))  # noqa: E731
    flat = lambda x: jnp.asarray(x.reshape(1, M))  # noqa: E731
    grads, metrics = jfused.ppo_fused_grads_T(
        params, to_t(obs), to_t(actions), flat(log_probs), flat(adv), flat(returns), clip_eps=0.2, vf_coef=0.5,
        tile=TILE, interpret=True, compute_dtype="bfloat16",
    )
    _assert_bf16_close(_port(model, arrays, "bfloat16"), (jax_numpy_tree(grads), metrics))


def _assert_bf16_close(port, want):
    (grads, metrics), (want_g, want_m) = port, want
    want_items = dict(tree_items(want_g))
    for path, got in tree_items(grads):
        assert _rel_err(got, want_items[path]) <= 1e-2, (path, _rel_err(got, want_items[path]))
    for name in ("pg_loss", "vf_loss", "approx_kl"):
        np.testing.assert_allclose(metrics[name], float(want_m[name]), rtol=1e-4, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_plain_rows_equal_feature_major_plain(compute_dtype):
    """K7 and K4 compute one function: the row-major minibatch re-blocked
    into (rows, lanes) feature-major form, sample order kept, gives the same
    grads and metrics from K4's plain version, bit for bit."""
    params, model = jax_and_port_params(True, hidden=(32, 32), seed=3)
    obs, actions, log_probs, adv, returns = (torch.from_numpy(x) for x in _batch(params, m=M, seed=4))
    rows, lanes = 4, M // 4
    to_t = lambda x: x.reshape(rows, lanes, -1).transpose(1, 2)  # noqa: E731
    flat = lambda x: x.reshape(rows, lanes)  # noqa: E731
    got_g, got_m = fused_ppo.ppo_fused_grads(model, obs, actions, log_probs, adv, returns,
                                             compute_dtype=compute_dtype)
    want_g, want_m = fused_ppo.ppo_fused_grads_T(model, to_t(obs), to_t(actions), flat(log_probs), flat(adv),
                                                 flat(returns), compute_dtype=compute_dtype)
    for name in want_g:
        torch.testing.assert_close(got_g[name], want_g[name], rtol=0, atol=0)
    for name in want_m:
        torch.testing.assert_close(got_m[name], want_m[name], rtol=0, atol=0)


def test_refusals_name_the_contract():
    """K7 takes the shared trunk (the JAX kernel's assert).  The CUDA
    kernels take K3's trunks (1-8 layers, widths a multiple of 4 up to 256,
    each padded to a multiple of 64), S <= 8 and a multiple of 32 samples
    per step; outside that the limit is named before any launch."""
    _, towers = jax_and_port_params(False, hidden=(32, 32))
    x = torch.zeros((M, 4))
    with pytest.raises(ValueError, match="K7.*shared-trunk layout"):
        fused_ppo.ppo_fused_grads(towers, x, torch.zeros((M, 2)), *(torch.zeros(M) for _ in range(3)))
    _, model = jax_and_port_params(True, hidden=(32, 32))
    assert fused_ppo.check_kernel_limits(model, M, 4, 2, "K7") == fused_ppo.KernelShape(1, (32, 32), (64, 64))
    for hidden in ((258,), (64, 30), (32,) * 9):
        _, model = jax_and_port_params(True, hidden=hidden)
        with pytest.raises(ValueError, match="K7 kernel takes 1-8 trunk layers, each .*a multiple of 4 wide and "
                                             "at most 256"):
            fused_ppo.check_kernel_limits(model, M, 4, 2, "K7")
    _, model = jax_and_port_params(True, hidden=(64, 64))
    with pytest.raises(ValueError, match="multiple of 32 samples per step, S <= 8"):
        fused_ppo.check_kernel_limits(model, M, 9, 2, "K7")
    with pytest.raises(ValueError, match="multiple of 32 samples"):
        fused_ppo.check_kernel_limits(model, M + 1, 4, 2, "K7")
    assert fused_ppo.check_kernel_limits(model, M, 4, 2, "K7") == fused_ppo.KernelShape(1, (64, 64), (64, 64))
