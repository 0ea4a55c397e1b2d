"""K3's, K4's and K7's plain versions at trunks past the CUDA kernels' old
limits (widths off a multiple of 4, wider than 256, ten layers) and K4/K7
at S = 20, against the JAX package's interpret-mode kernels
``mlp_rollout_pallas``, ``ppo_fused_grads_T`` (both layouts) and
``ppo_fused_grads`` on the same numpy-seeded inputs and injected noise;
padding a width off a multiple of 4 leaves the plain rollout bitwise
unchanged; and the wrappers' shape checks take these trunks, naming only
the depth cap.  The JAX kernels refuse none of these shapes (they read the
depth, S and the widths from their inputs), so neither does the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mbt_gym_tpu.agents import networks as jnet
from mbt_gym_tpu.ops import fused_ppo as jfused
from mbt_gym_tpu.ops import pallas_rollout

from mbt_gym_torch import convert
from mbt_gym_torch.agents.networks import init_actor_critic
from mbt_gym_torch.ops import fused_ppo
from mbt_gym_torch.ops import mlp_rollout as mr
from tests.test_torch_fused_ppo_wide import _assert_close, _samples
from tests.test_torch_mlp_rollout import N, _channels, _configs
from tests.test_torch_networks import jax_numpy_tree

# (hidden, shared trunk): off a multiple of 4, past 256, past 256 on the
# towers (stacked 600 wide), ten layers
TRUNKS = [((30, 30), True), ((260,), True), ((300, 300), False), ((16,) * 10, True)]
TRUNK_IDS = ["30x30", "260", "300x300-towers", "16x10"]
STEPS, LANES = 4, 64  # K4's minibatch: 4 steps x 64 envs


def _params(hidden, shared_trunk, s_dim=4, a_dim=2, seed=5):
    params = jnet.init_actor_critic(jax.random.PRNGKey(seed), s_dim, a_dim, hidden=hidden, shared_trunk=shared_trunk)
    return params, convert.actor_critic_from_numpy(jax_numpy_tree(params), device="cpu")


@pytest.mark.parametrize("normalised", [True, False], ids=["bf16", "float32"])
@pytest.mark.parametrize("trunk", TRUNKS, ids=TRUNK_IDS)
def test_k3_plain_at_wide_and_deep_trunks_matches_jax_interpret_kernel(trunk, normalised):
    """K3's plain version against mlp_rollout_pallas(..., interpret=True)
    on the same params and (T, 7, N) channels, at the tolerances of
    tests/test_torch_mlp_rollout.py (those of tests/test_pallas_rollout.py:
    68-72): obs rtol 1e-4 / atol 2e-4, actions, log-probs and values atol
    1e-3, rewards atol 5e-3; the inventory paths exact."""
    hidden, shared = trunk
    jcfg, cfg = _configs(normalised)
    params, model = _params(hidden, shared)
    channels = _channels()
    jp = pallas_rollout.rollout_params_from_config(jcfg)
    want = pallas_rollout.mlp_rollout_pallas(jp, params, 0, N, tile=128, interpret=True,
                                             noise=jnp.asarray(channels[: jp.run_steps]))
    p = mr.rollout_params_from_config(cfg)
    got = mr.mlp_rollout(p, model, 0, N, noise=torch.from_numpy(channels[: p.run_steps]), device="cpu")
    got = [x.numpy() for x in got]
    want = [np.asarray(x) for x in want]
    assert [g.shape for g in got] == [w.shape for w in want]

    def inventory(obs):
        return np.rint((obs[:, 1] + 1.0) * p.obs_grad[1] + p.obs_low[1]) if normalised else obs[:, 1]

    np.testing.assert_array_equal(inventory(got[0]), inventory(want[0]))
    for g, w, atol in zip(got, want, (2e-4, 1e-3, 1e-3, 1e-3, 5e-3)):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=atol)


def _feature_major(rows):
    to_t = lambda x: np.ascontiguousarray(x.reshape(STEPS, LANES, -1).swapaxes(1, 2))  # noqa: E731
    flat = lambda x: np.ascontiguousarray(x.reshape(STEPS, LANES))  # noqa: E731
    return [to_t(rows[0]), to_t(rows[1])] + [flat(x) for x in rows[2:]]


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shared_trunk", [True, False], ids=["shared", "towers"])
@pytest.mark.parametrize("hidden", [t for t, _ in TRUNKS], ids=TRUNK_IDS)
def test_k4_plain_at_wide_and_deep_trunks_matches_jax_interpret_kernel(hidden, shared_trunk, compute_dtype):
    """K4's plain version against ppo_fused_grads_T(..., interpret=True) on
    both layouts at each trunk, at tests/test_torch_fused_ppo_wide.py's
    tolerances (float32 grads rtol 2e-4 / atol 2e-6; bf16 1e-2 per leaf;
    metrics rtol 1e-4)."""
    params, model = _params(hidden, shared_trunk)
    inputs = _feature_major(_samples(params, 4, 2, STEPS * LANES, 11))
    want_g, want_m = jfused.ppo_fused_grads_T(params, *(jnp.asarray(x) for x in inputs), clip_eps=0.2, vf_coef=0.5,
                                             tile=LANES, interpret=True, compute_dtype=compute_dtype)
    grads, metrics = fused_ppo.ppo_fused_grads_T(model, *(torch.from_numpy(x) for x in inputs),
                                                 compute_dtype=compute_dtype)
    _assert_close(model, grads, metrics, want_g, want_m, compute_dtype)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dims", [(4, 2), (20, 2)], ids=["S4", "S20"])
@pytest.mark.parametrize("hidden", [t for t, _ in TRUNKS], ids=TRUNK_IDS)
def test_k7_plain_at_wide_and_deep_trunks_matches_jax_interpret_kernel(hidden, dims, compute_dtype):
    """K7's plain version against ppo_fused_grads(..., interpret=True) at
    each trunk and at S = 20, on the same row-major inputs (bf16 per leaf
    to 1e-3, as tests/test_torch_fused_ppo_rm.py holds K7)."""
    s_dim, a_dim = dims
    params, model = _params(hidden, True, s_dim, a_dim)
    rows = _samples(params, s_dim, a_dim, STEPS * LANES, 13 + s_dim)
    want_g, want_m = jfused.ppo_fused_grads(params, *(jnp.asarray(x) for x in rows), clip_eps=0.2, vf_coef=0.5,
                                           tile=LANES, interpret=True, compute_dtype=compute_dtype)
    grads, metrics = fused_ppo.ppo_fused_grads(model, *(torch.from_numpy(x) for x in rows),
                                               compute_dtype=compute_dtype)
    _assert_close(model, grads, metrics, want_g, want_m, compute_dtype, bf16_bound=1e-3)


@pytest.mark.parametrize("shared_trunk", [True, False], ids=["shared-trunk", "towers"])
@pytest.mark.parametrize("width", [30, 102])
def test_padding_an_off_4_width_leaves_the_plain_rollout_bitwise_unchanged(width, shared_trunk):
    """The float32 kernel's wrapper rounds every hidden width up to a
    multiple of 4 (pad_widths(params, 4)) with zero weight rows and columns
    and zero biases: each new unit is tanh(0) = 0 and adds exact zeros
    downstream, so the plain version on the padded params gives the same
    outputs bit for bit, raw and normalised."""
    model = init_actor_critic(4, 4, 2, hidden=(width, width), shared_trunk=shared_trunk, device="cpu")
    padded = mr.pad_widths(model, 4)
    assert padded.hidden == {30: (32, 32), 102: (104, 104)}[width]
    noise = torch.from_numpy(_channels())
    for normalised in (False, True):
        _, cfg = _configs(normalised)
        p = mr.rollout_params_from_config(cfg)
        want = mr.mlp_rollout_plain(p, model, 0, N, noise=noise)
        got = mr.mlp_rollout_plain(p, padded, 0, N, noise=noise)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_shape_checks_take_every_width_and_name_only_the_depth_cap():
    """check_kernel_shapes (K3) and check_kernel_limits (K4/K7, which no
    longer read S) take any positive per-tower width and any depth up to
    MAX_LAYERS (64, far past any trunk either package trains); the
    KernelShape pads each width to a multiple of 64; past the cap the depth
    is named."""
    _, cfg = _configs()
    p = mr.rollout_params_from_config(cfg)
    for hidden, shared in TRUNKS + [((512, 512), False), ((1,), True), ((2048,), True)]:
        model = init_actor_critic(0, 4, 2, hidden=hidden, shared_trunk=shared, device="cpu")
        mr.check_kernel_shapes(p, list(hidden), 1024)
        shape = fused_ppo.check_kernel_limits(model, 64, 2, "K4")
        assert shape == fused_ppo.KernelShape(1 if shared else 2, hidden, tuple(-(-h // 64) * 64 for h in hidden))
    deep = [16] * (mr.MAX_LAYERS + 1)
    with pytest.raises(ValueError, match="the K3 kernel takes 1-64 trunk layers; got 65"):
        mr.check_kernel_shapes(p, deep, 1024)
    model = init_actor_critic(0, 4, 2, hidden=tuple(deep), shared_trunk=True, device="cpu")
    with pytest.raises(ValueError, match="the K4 kernel takes 1-64 trunk layers; got 65"):
        fused_ppo.check_kernel_limits(model, 64, 2, "K4")


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "float32"])
def test_routes_and_scratch_follow_shared_memory(bf16):
    """Which route each kernel takes is a function of the shape alone: K3
    in bf16 takes its wide route past 256 rows (two [width][128] bf16 tiles
    a CTA of 128 envs), in float32 its scratch route where its activations
    pass the 227 KB of shared memory a block may hold; pass 1 of K4/K7 its
    scratch route where its tiles, head and partial sums pass it (two tiles
    a CTA of 256).  Pass 2's blocks split every layer's input width into
    column blocks of at most 256."""
    n = 16_384
    assert mr.k3_scratch_bytes([256, 256], bf16, 4, 2, n) == 0
    assert mr.k3_scratch_bytes([512, 512], bf16, 4, 2, n) == (n // 128 * 2 * 512 * 128 * 2 if bf16 else 0)
    assert mr.k3_scratch_bytes([2048], bf16, 4, 2, n) == (
        n // 128 * 2 * 2048 * 128 * 2 if bf16 else n // 32 * 2 * 2048 * 32 * 4)
    for hidden, towers, scratch in (((512, 512), 1, False), ((512, 512), 2, not bf16), ((1536, 1536), 1, True),
                                    ((64,) * 12, 2, False)):
        shape = fused_ppo.KernelShape(towers, hidden, hidden)
        lay = fused_ppo.deep_layout(shape, 100, 4, 2, bf16)
        assert lay["scratch"] == scratch, (hidden, towers)
        smem = fused_ppo.pass1_smem_bytes(lay, 4, 2, towers, bf16)
        assert (smem > fused_ppo.SMEM_OPTIN) == scratch
        h_max = towers * max(hidden)
        assert lay["scratch_bytes"] == (256 * 2 * h_max * (80 if bf16 else 128) if scratch else 0)
        blocks = [towers * hidden[li] // 64 * -(-hidden[li - 1] // 256) for li in range(1, len(hidden))]
        assert lay["rb_start"][len(hidden)] == sum(blocks)
    # S = 32 on (512, 512) towers passes shared memory by its partial sums alone
    lay = fused_ppo.deep_layout(fused_ppo.KernelShape(2, (512, 512), (512, 512)), 100, 32, 2, True)
    assert lay["scratch"] == 1
