"""K4's plain version (mbt_gym_torch.ops.fused_ppo) against the JAX
package's feature-major fused update run in interpret mode and against
jax.grad of the JAX loss (as tests/test_fused_ppo.py:113-163), at every
trunk shape the CUDA kernels take (one to three layers, widths that the
kernels pad), the wrappers' exact zero padding, the deep instantiations'
chunks of staged planes, and whole fused PPO
iterations against JAX's _fused_iteration_body on the same injected
noise."""
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
from mbt_gym_torch.agents.networks import init_actor_critic
from mbt_gym_torch.ops import fused_ppo
from mbt_gym_torch.ops.mlp_rollout import TransposedParams, transpose_params
from tests.test_torch_env import torch_config
from tests.test_torch_networks import assert_trees_close, jax_and_port_params, jax_numpy_tree, tree_items
from tests.test_torch_ppo import _batch

L = 64  # envs per step
# trunks the CUDA kernels take beside the production 256x256: one layer,
# narrow and unequal widths (padded to multiples of 64 on the card), three layers
TRUNKS = [(64,), (32, 32), (36, 100), (24, 16, 8)]
TRUNK_IDS = ["64", "32x32", "36x100", "24x16x8"]


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
    _check_against_interpret_kernel(*jax_and_port_params(True, seed=2), t_steps, compute_dtype)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shared_trunk", [True, False], ids=["shared", "towers"])
@pytest.mark.parametrize("hidden", TRUNKS, ids=TRUNK_IDS)
def test_plain_grads_match_jax_interpret_kernel_at_every_trunk(hidden, shared_trunk, compute_dtype):
    """The same, on both layouts, at one and three layers and at widths the
    CUDA kernels pad: the JAX kernel loops over any depth and width."""
    _check_against_interpret_kernel(*jax_and_port_params(shared_trunk, hidden=hidden, seed=2), 8, compute_dtype)


def _check_against_interpret_kernel(params, model, t_steps, compute_dtype):
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


def _stacked_samples(s_dim, a_dim, m, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(-1.0, 1.0, (s_dim, m)).astype(np.float32))
    act = torch.from_numpy(rng.normal(size=(a_dim, m)).astype(np.float32))
    old = torch.from_numpy((rng.normal(size=m) * 0.3 - 1.5).astype(np.float32))
    adv, ret = (torch.from_numpy(rng.normal(size=m).astype(np.float32)) for _ in range(2))
    return x, act, old, adv, ret


def _leaves(tp):
    return [t for pair in tp.trunk for t in pair] + [tp.w_head, tp.b_head, tp.log_std]


@pytest.mark.parametrize("shared_trunk", [True, False], ids=["shared", "towers"])
@pytest.mark.parametrize("hidden", [(36, 100), (32, 32), (20, 44, 8), (64,)], ids=["36x100", "32x32", "20x44x8", "64"])
def test_padding_to_the_kernel_widths_is_exact(hidden, shared_trunk):
    """The wrappers pad every hidden width to a multiple of 64 before a
    launch (each tower inside its block) and slice the grads back.  On
    float32 CPU tensors, the plain grads of the padded params, sliced back,
    equal the unpadded plain grads to rtol 1e-6 (atol 1e-6 of the leaf's
    largest value: the padded products sum their real terms in another
    blocking), every sliced-off entry is exactly zero, and the params'
    round trip is exact."""
    model = init_actor_critic(3, 4, 2, hidden=hidden, shared_trunk=shared_trunk, device="cpu")
    shape = fused_ppo.check_kernel_limits(model, L, 2, "K4")
    assert shape == fused_ppo.KernelShape(1 if shared_trunk else 2, hidden, tuple(-(-h // 64) * 64 for h in hidden))
    tp = transpose_params(model)
    padded = fused_ppo.pad_transposed(tp, shape.padded)
    for got, want in zip(_leaves(fused_ppo.unpad_transposed(padded, shape.widths)), _leaves(tp)):
        assert torch.equal(got, want)
    samples = _stacked_samples(4, 2, 256, 9)
    got, got_m = fused_ppo.plain_grads_stacked(padded, *samples, 0.2, 0.5, "float32")
    want, want_m = fused_ppo.plain_grads_stacked(tp, *samples, 0.2, 0.5, "float32")
    ones = TransposedParams([(torch.ones_like(w), torch.ones_like(b)) for w, b in want.trunk],
                            torch.ones_like(want.w_head), want.b_head, want.log_std, want.split_at)
    for g, keep in zip(_leaves(got), _leaves(fused_ppo.pad_transposed(ones, shape.padded))):
        assert torch.equal(g * (keep == 0), torch.zeros_like(g))
    for g, w in zip(_leaves(fused_ppo.unpad_transposed(got, shape.widths)), _leaves(want)):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6 * float(w.abs().max()))
    for name in want_m:
        torch.testing.assert_close(got_m[name], want_m[name], rtol=1e-6, atol=0)


@pytest.mark.parametrize("hidden,shared_trunk,bf16,chunks,row_major", [
    ((256, 256, 256), True, True, 7, False), ((256, 256, 256), True, False, 13, False),
    ((256,) * 8, False, True, 44, False), ((36, 100, 20), False, True, 5, False), ((256,), True, True, 1, False),
    ((256, 256), True, True, 8, True), ((256,), True, True, 4, True), ((256, 256), True, False, 7, True)],
    ids=["256x256x256", "256x256x256-float32", "256x8-towers", "36x100x20-towers", "256", "256x256-k7",
         "256-k7", "256x256-k7-float32"])
def test_deep_layout_bounds_the_staged_planes(hidden, shared_trunk, bf16, chunks, row_major):
    """At config 5's minibatch (200 steps x 16,384 envs, 102,400 tiles of
    32 samples) the kernels stage each tile's hidden-to-hidden inputs
    h_0 .. h_{L-2} and gradients dz_1 .. dz_{L-1} (padded, stacked widths)
    in chunks of tiles whose planes take at most ``_STAGE_BYTES``, each
    plane at its byte offset in the tile, h planes first; one layer stages
    nothing and runs one chunk.  K7 in bf16 stages its h planes in float32
    and h_{L-1} too (its tanh' reads the float32 activations), so a single
    layer stages one plane, and its dz planes in bf16 as K4 does; in
    float32 K7 stages what K4 does."""
    model = init_actor_critic(0, 4, 2, hidden=hidden, shared_trunk=shared_trunk, device="cpu")
    shape = fused_ppo.check_kernel_limits(model, 16_384, 2, "K4")
    n_tiles = 200 * 16_384 // 32
    lay = fused_ppo.deep_layout(shape, n_tiles, 4, 2, bf16, row_major)
    rows = [shape.towers * h for h in shape.padded]
    f32_h = bf16 and row_major
    n_h = len(rows) if f32_h else len(rows) - 1
    value = 2 if bf16 else 4
    h = [r * 32 * (4 if f32_h else value) for r in rows[:n_h]]
    dz = [r * 32 * value for r in rows[1:]]
    assert lay["tile_bytes"] == sum(h) + sum(dz)
    assert lay["sh_off"] == [sum(h[:i]) for i in range(n_h)]
    assert lay["sdz_off"][1:] == [sum(h) + sum(dz[:i]) for i in range(len(dz))]
    assert lay["stage_bytes"] == lay["chunk_tiles"] * lay["tile_bytes"]
    assert lay["stage_bytes"] <= fused_ppo._STAGE_BYTES
    assert -(-n_tiles // lay["chunk_tiles"]) == chunks


def test_fused_iteration_matches_jax_on_injected_noise():
    """One whole fused iteration (K3 rollout -> GAE -> 2 env-slice
    minibatches of K4 grads -> entropy grad -> clip + Adam) against JAX's
    _fused_iteration_body in interpret mode on the same (T, 7, N) channels,
    float32 update, ent_coef 0.01: updated params to rtol 5e-4 / atol 5e-6
    and metrics to rtol 1e-3 (tests/test_fused_ppo.py:98-110)."""
    _fused_iteration_vs_jax((16, 16))


@pytest.mark.parametrize("hidden", [(64,), (24, 16, 8)], ids=["64", "24x16x8"])
def test_fused_iteration_matches_jax_on_injected_noise_at_other_depths(hidden):
    """The same whole iteration on a one-layer and a three-layer trunk."""
    _fused_iteration_vs_jax(hidden)


def _fused_iteration_vs_jax(hidden):
    n, t_steps = 128, 8
    jcfg = dataclasses.replace(jax_as_env_config(num_trajectories=n, n_steps=t_steps),
                               normalise_observation_space=True, normalise_action_space=True)
    kw = dict(hidden=hidden, n_epochs=1, n_minibatches=2, shuffle=False, shared_trunk=True, ent_coef=0.01,
              fused_rollout=True, fused_update=True, fused_compute_dtype="float32")
    jcfg_ppo = jppo.PPOConfig(fused_interpret_ok=True, fused_rollout_tile=128, **kw)
    rng = np.random.default_rng(11)
    channels = rng.uniform(size=(t_steps, 7, n)).astype(np.float32)
    channels[:, 4:] = rng.normal(size=(t_steps, 3, n)).astype(np.float32)
    params, model = jax_and_port_params(True, hidden=hidden, seed=6)
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


@pytest.mark.parametrize("rows, cols", [(64, 64), (128, 192), (512, 256)])
def test_mma_fragment_packing_round_trips(rows, cols):
    """The bf16 kernels' W1 in mma fragment order (pack_mma_a): every value
    kept once, lane 4g+t of block (rb, kb) holding rows g, g+8 x columns 2t,
    2t+1, 2t+8, 2t+9 as the m16n8k16 A registers a0-a3, and unpacked back."""
    w = torch.from_numpy(np.random.default_rng(rows + cols).normal(size=(rows, cols)).astype(np.float32))
    w = w.to(torch.bfloat16)
    packed = fused_ppo.pack_mma_a(w)
    assert packed.shape == (rows * cols,) and packed.is_contiguous()
    unpacked = packed.reshape(rows // 16, cols // 16, 8, 4, 2, 2, 2).permute(0, 5, 2, 1, 4, 3, 6)
    assert torch.equal(unpacked.reshape(rows, cols), w)
    blocks = packed.reshape(rows // 16, cols // 16, 32, 8)
    rb, kb = rows // 16 - 1, 1
    for lane in (0, 5, 31):
        g, t = divmod(lane, 4)
        r0, k0 = 16 * rb, 16 * kb
        want = [w[r0 + g + 8 * (i // 2 % 2), k0 + 2 * t + 8 * (i // 4) + i % 2] for i in range(8)]
        assert torch.equal(blocks[rb, kb, lane], torch.stack(want))
