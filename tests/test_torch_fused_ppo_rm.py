"""K7's plain version (mbt_gym_torch.ops.fused_ppo.ppo_fused_grads_plain,
the row-major fused PPO update) against the JAX package's
ppo_fused_grads run in interpret mode and against jax.grad of the JAX
loss (as tests/test_fused_ppo.py:30-71), and against the port's own K4
plain version on the same samples: bit for bit in float32, at JAX K7's
rounding points (not K4's) in bf16, which an autograd evaluation that
rounds only the matmul operands pins as well."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mbt_gym_tpu.agents import ppo as jppo
from mbt_gym_tpu.ops import fused_ppo as jfused

from mbt_gym_torch import convert
from mbt_gym_torch.ops import fused_ppo, mlp_rollout
from tests.test_torch_networks import assert_trees_close, jax_and_port_params, jax_numpy_tree, tree_items
from tests.test_torch_ppo import _batch

M = 256
TILE = 64  # the JAX kernel's row tile in interpret mode
# JAX's own test trunks (tests/test_fused_ppo.py:30), unequal widths the
# CUDA kernels pad, and three layers
TRUNKS = [(32, 32), (64,), (36, 100), (24, 16, 8)]
TRUNK_IDS = ["32x32", "64", "36x100", "24x16x8"]
# bf16 per-leaf bound of K7's plain version against a reference at JAX K7's
# rounding points; K4's rounding points read more than twice this from one
K7_BF16_BOUND = 1e-3


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


def _worst_leaf(grads, want_g) -> float:
    want_items = dict(tree_items(want_g))
    return max(float(_rel_err(got, want_items[path])) for path, got in tree_items(grads))


@pytest.mark.parametrize("hidden", TRUNKS, ids=TRUNK_IDS)
def test_plain_grads_match_jax_interpret_kernel_bf16(hidden):
    """bf16 against JAX's interpret-mode K7 at every trunk shape.  Both
    round every matmul operand to bf16 and keep the saved activations and
    1 - h*h in float32; XLA's CPU backend may keep bf16 intermediates in
    float32, and the sums run in other orders.  Each leaf's relative
    Frobenius error is held to ``K7_BF16_BOUND`` (worst leaf read 1.06e-4,
    the layer-0 bias at 32x32; 6.5e-6 at 24x16x8), metrics to rtol 1e-4.
    The bound tells the rounding points apart: the same samples through
    the plain arithmetic at K4's points (bf16 saved activations and
    1 - h*h) read 3.98e-3 (64) to 1.02e-2 (24x16x8) from JAX's K7 at their
    worst leaf, and are held to more than twice the bound."""
    params, model = jax_and_port_params(True, hidden=hidden, seed=0)
    arrays = _batch(params, m=M, seed=2)
    want = _jax_kernel(params, arrays, "bfloat16")
    _assert_bf16_close(_port(model, arrays, "bfloat16"), want, K7_BF16_BOUND)
    obs, actions, log_probs, adv, returns = (torch.tensor(x) for x in arrays)
    k4_points, _ = fused_ppo._plain_grads(model, obs.T, actions.T, log_probs, adv, returns, 0.2, 0.5, "bfloat16",
                                          torch.float32, row_major=False)
    assert _worst_leaf(convert.actor_critic_to_numpy(model, k4_points), want[0]) > 2 * K7_BF16_BOUND


@pytest.mark.parametrize("hidden", TRUNKS, ids=TRUNK_IDS)
def test_plain_grads_match_jax_feature_major_kernel_bf16(hidden):
    """K7 and K4 on the same samples (one step of M envs for K4), each port
    plain version against its own JAX kernel in interpret mode, bf16, at
    every trunk shape: K7 (float32 saved activations and 1 - h*h) against
    ``ppo_fused_grads`` at ``K7_BF16_BOUND`` per leaf, K4 (both in bf16)
    against ``ppo_fused_grads_T`` at 1e-2 per leaf (the K4 tests' bound),
    metrics to rtol 1e-4.  The rounding points matter:
    at 24x16x8 the port's K7 reads 1.07e-2 from JAX's K4 on the layer-0
    bias, past the bound, and 6.5e-6 from JAX's K7 at worst."""
    params, model = jax_and_port_params(True, hidden=hidden, seed=0)
    arrays = _batch(params, m=M, seed=2)
    obs, actions, log_probs, adv, returns = arrays
    to_t = lambda x: jnp.asarray(x.reshape(1, M, -1).swapaxes(1, 2))  # noqa: E731
    flat = lambda x: jnp.asarray(x.reshape(1, M))  # noqa: E731
    inputs = [to_t(obs), to_t(actions), flat(log_probs), flat(adv), flat(returns)]
    grads, metrics = jfused.ppo_fused_grads_T(params, *inputs, clip_eps=0.2, vf_coef=0.5, tile=TILE,
                                              interpret=True, compute_dtype="bfloat16")
    k4_g, k4_m = fused_ppo.ppo_fused_grads_T(model, *(torch.from_numpy(np.array(x)) for x in inputs),
                                             compute_dtype="bfloat16")
    k4 = convert.actor_critic_to_numpy(model, k4_g), {k: float(v) for k, v in k4_m.items()}
    _assert_bf16_close(k4, (jax_numpy_tree(grads), metrics), 1e-2)
    _assert_bf16_close(_port(model, arrays, "bfloat16"), _jax_kernel(params, arrays, "bfloat16"), K7_BF16_BOUND)


def _assert_bf16_close(port, want, bound):
    (grads, metrics), (want_g, want_m) = port, want
    want_items = dict(tree_items(want_g))
    for path, got in tree_items(grads):
        assert _rel_err(got, want_items[path]) <= bound, (path, _rel_err(got, want_items[path]))
    for name in ("pg_loss", "vf_loss", "approx_kl"):
        np.testing.assert_allclose(metrics[name], float(want_m[name]), rtol=1e-4, atol=1e-6, err_msg=name)


class _RoundedMatmul(torch.autograd.Function):
    """``a @ b`` with both operands rounded to bf16 and summed in float32,
    and the backward's two products likewise: JAX K7's ``_mm`` under
    autograd, every other value float32."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = mlp_rollout.bf16_round(a), mlp_rollout.bf16_round(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = mlp_rollout.bf16_round(g)
        return g @ b.T, a.T @ g


def _k7_points_autograd(model, obs, actions, log_probs, adv, returns, clip_eps=0.2, vf_coef=0.5):
    """The grads of the PPO loss on the shared trunk by autograd, each
    matmul through :class:`_RoundedMatmul` (layer 0, every hidden layer,
    both heads), tanh and its derivative in float32."""
    params = dict(model.named_parameters())
    leaves = {name: p.detach().clone().requires_grad_(True) for name, p in params.items()}
    mm = _RoundedMatmul.apply
    with mlp_rollout.full_float32_matmul():
        h = obs
        for i in range(sum(1 for name in leaves if name.startswith("shared.") and name.endswith(".weight"))):
            h = torch.tanh(mm(h, leaves[f"shared.{i}.weight"].T) + leaves[f"shared.{i}.bias"])
        mean = mm(h, leaves["pi_head.weight"].T) + leaves["pi_head.bias"]
        value = (mm(h, leaves["vf_head.weight"].T) + leaves["vf_head.bias"])[:, 0]
        log_std = leaves["log_std"]
        z = (actions - mean) * torch.exp(-log_std)
        logp = (-0.5 * z * z - log_std - 0.5 * np.log(2.0 * np.pi)).sum(dim=1)
        ratio = torch.exp(logp - log_probs)
        pg = -torch.minimum(ratio * adv, torch.clamp(ratio, 1.0 - clip_eps, 1.0 + clip_eps) * adv).mean()
        vf = vf_coef * (0.5 * (value - returns) ** 2).mean()
        (pg + vf).backward()
    return {name: leaf.grad for name, leaf in leaves.items()}


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_plain_rows_equal_feature_major_plain(compute_dtype):
    """K7 and K4 compute one function at their own rounding points.  The
    row-major minibatch re-blocked into (rows, lanes) feature-major form,
    sample order kept: in float32 K4's plain version gives K7's grads and
    metrics bit for bit.  In bf16 K7's plain version is an autograd
    evaluation that rounds only the matmul operands
    (:func:`_k7_points_autograd`) to ``K7_BF16_BOUND`` per leaf (read
    1.5e-7), where K4's (bf16 saved activations and 1 - h*h) reads more
    than twice that from it (read 7.6e-3), and the forward's metrics agree
    to rtol 1e-4."""
    params, model = jax_and_port_params(True, hidden=(32, 32), seed=3)
    obs, actions, log_probs, adv, returns = (torch.from_numpy(x) for x in _batch(params, m=M, seed=4))
    rows, lanes = 4, M // 4
    to_t = lambda x: x.reshape(rows, lanes, -1).transpose(1, 2)  # noqa: E731
    flat = lambda x: x.reshape(rows, lanes)  # noqa: E731
    got_g, got_m = fused_ppo.ppo_fused_grads(model, obs, actions, log_probs, adv, returns,
                                             compute_dtype=compute_dtype)
    k4_g, k4_m = fused_ppo.ppo_fused_grads_T(model, to_t(obs), to_t(actions), flat(log_probs), flat(adv),
                                             flat(returns), compute_dtype=compute_dtype)
    if compute_dtype == "bfloat16":
        want = _k7_points_autograd(model, obs, actions, log_probs, adv, returns)
        rel = lambda g: max(float(_rel_err(g[n].numpy(), want[n].numpy())) for n in want)  # noqa: E731
        assert rel(got_g) <= K7_BF16_BOUND, rel(got_g)
        assert rel(k4_g) > 2 * K7_BF16_BOUND, rel(k4_g)
        for name in k4_m:
            torch.testing.assert_close(got_m[name], k4_m[name], rtol=1e-4, atol=0)
        return
    want_g, want_m = k4_g, k4_m
    for name in want_g:
        torch.testing.assert_close(got_g[name], want_g[name], rtol=0, atol=0)
    for name in want_m:
        torch.testing.assert_close(got_m[name], want_m[name], rtol=0, atol=0)


@pytest.mark.parametrize("hidden", [(64, 64), (128, 192), (256, 256), (32, 32), (64,), (36, 100)],
                         ids=["64x64", "128x192", "256x256", "32x32", "64", "36x100"])
def test_k4_rounding_points_fail_the_card_bound_at_the_edge_test_shapes(hidden):
    """The card holds K7 to its plain version at 1e-3 per leaf up to two
    layers (tests/test_torch_cuda.py::test_update_kernels_at_the_mma_tile_edges,
    on the same samples, made with numpy).  At every bf16 case of that test
    up to two layers (1 and 3 tiles a step, S/A 4/2, 8/4, 9/4, 16/4, 5/1),
    the plain arithmetic at K4's rounding points reads more than that bound
    from K7's plain version at its worst leaf (least read 2.24e-3, at (64,),
    32 envs, S = 4), so a K7 still rounding at K4's points fails there."""
    from chip_smoke import leaf_errors, update_samples
    from mbt_gym_torch.agents.networks import init_actor_critic

    for nb in (32, 96):
        for dims in ((4, 2), (8, 4), (9, 4), (16, 4), (5, 1)):
            model = init_actor_critic(7, *dims, hidden=hidden, shared_trunk=True, device="cpu")
            with torch.no_grad():
                model.log_std.add_(0.05)
            rows = update_samples(torch, np, model, 5, nb, 11 + nb, torch.device("cpu"))
            k7, _ = fused_ppo.ppo_fused_grads_plain(model, *rows)
            obs, actions, old, adv, ret = rows
            k4_points, _ = fused_ppo._plain_grads(model, obs.T, actions.T, old, adv, ret, 0.2, 0.5, "bfloat16",
                                                  torch.float32)
            assert max(leaf_errors(torch, k4_points, k7).values()) > K7_BF16_BOUND, (nb, dims)


def test_refusals_name_the_contract():
    """K7 takes the shared trunk (the JAX kernel's assert).  The CUDA
    kernels take K3's trunks (1-8 layers, widths a multiple of 4 up to 256,
    each padded to a multiple of 64), K3's S <= 16 and a multiple of 32
    samples per step; outside that the limit is named before any launch."""
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
    assert fused_ppo.MAX_S == mlp_rollout.MAX_S == 16
    assert fused_ppo.check_kernel_limits(model, M, 16, 4, "K7") == fused_ppo.KernelShape(1, (64, 64), (64, 64))
    with pytest.raises(ValueError, match="multiple of 32 samples per step, S <= 16"):
        fused_ppo.check_kernel_limits(model, M, 17, 2, "K7")
    with pytest.raises(ValueError, match="multiple of 32 samples"):
        fused_ppo.check_kernel_limits(model, M + 1, 4, 2, "K7")
    assert fused_ppo.check_kernel_limits(model, M, 4, 2, "K7") == fused_ppo.KernelShape(1, (64, 64), (64, 64))
