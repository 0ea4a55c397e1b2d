"""The port's CUDA kernels against their plain PyTorch versions on the
card: the episode kernels K1 and K2, the MLP rollout K3 and the fused PPO
update K4.  They have no CPU mode, so every test here skips on a host
without a GPU.  This file imports neither JAX nor the JAX package, so it
runs on the GPU machine too, without the suite's conftest:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""
import dataclasses

import numpy as np
import pytest
import torch

from mbt_gym_torch.ops import _build
from mbt_gym_torch.ops import episode as ep
from mbt_gym_torch.utils.config import as_env_config


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the episode kernels run only on the card")
    return torch.device("cuda")


def _channels(seed, steps, n, device):
    rng = np.random.default_rng(seed)
    channels = rng.uniform(size=(steps, 5, n)).astype(np.float32)
    channels[:, 4] = rng.normal(size=(steps, n)).astype(np.float32)
    return torch.from_numpy(channels).to(device)


@pytest.mark.parametrize("risk_aversion", [0.1, 0.0], ids=["as-quotes", "fixed-1/k"])
def test_kernels_match_plain_on_the_card(cuda_device, risk_aversion):
    """K1 and K2 (every emit mode, native and noise mode) against their
    plain versions on the same inputs.  Same float32 op order and
    --fmad=false, so the only differences are libm ULPs: inventory may flip
    on at most 1e-4 of envs; cash to rtol=1e-6/atol=1e-3, price to 1e-3."""
    n = 4096
    cfg = dataclasses.replace(as_env_config(num_trajectories=n, n_steps=200), initial_inventory=3)
    p = ep.params_from_config(cfg, risk_aversion)
    before = dict(_build.launch_counts)
    for kw in ({"noise": _channels(1, 200, n, cuda_device)}, {"seed": 5, "device": cuda_device}):
        got = ep.as_episode(p, num_trajectories=n, **kw)
        want = ep.as_episode_plain(p, num_trajectories=n, **kw)
        torch.cuda.synchronize()
        same = got[1] == want[1]
        assert int((~same).sum()) <= n // 10_000
        torch.testing.assert_close(got[0][same], want[0][same], rtol=1e-6, atol=1e-3)
        torch.testing.assert_close(got[2][same], want[2][same], rtol=0, atol=1e-3)
        for emit in ("state", "full", "container"):
            k2 = ep.as_episode_trajectories(p, num_trajectories=n, emit=emit, **kw)
            plain = ep.as_episode_trajectories_plain(p, num_trajectories=n, emit=emit, **kw)
            for a, b in zip(k2, plain):
                torch.testing.assert_close(a[:, same], b[:, same], rtol=1e-6, atol=1e-3)
    assert _build.launch_counts["as_episode"] == before["as_episode"] + 2
    assert _build.launch_counts["as_episode_trajectories"] == before["as_episode_trajectories"] + 6


def _ppo_cfg(n, normalised=True):
    cfg = as_env_config(num_trajectories=n, n_steps=200)
    return dataclasses.replace(cfg, normalise_observation_space=normalised, normalise_action_space=normalised)


def _mlp_channels(seed, steps, n, device):
    rng = np.random.default_rng(seed)
    channels = rng.uniform(size=(steps, 7, n)).astype(np.float32)
    channels[:, 4:7] = rng.normal(size=(steps, 3, n)).astype(np.float32)
    return torch.from_numpy(channels).to(device)


def _same_inventory_envs(got, want, n):
    """Envs whose inventory stream agrees at every step; a bf16 operand
    rounding can flip a fill, which then changes that env's later path."""
    same = (got[0][:, 1] == want[0][:, 1]).all(dim=0)
    flips = int((~same).sum())
    assert flips <= n // 1000, f"inventory streams differ on {flips} of {n} envs"
    return same


@pytest.mark.parametrize("normalised", [True, False], ids=["bf16-operands", "float32"])
def test_mlp_rollout_kernel_matches_plain_on_the_card(cuda_device, normalised):
    """K3 at 4,096 envs x 200 steps, 256x256 shared trunk, against its plain
    version on the same draws (noise and native mode).  Envs whose
    inventory stream agrees (at least 99.9%; a fill flips only where a
    summation-order difference crosses u < exp(-k d)) agree to
    rtol=1e-4/atol=1e-3."""
    from mbt_gym_torch.agents.networks import init_actor_critic
    from mbt_gym_torch.ops import mlp_rollout as mr

    n = 4096
    cfg = _ppo_cfg(n, normalised)
    p = mr.rollout_params_from_config(cfg)
    model = init_actor_critic(3, 4, 2, hidden=(256, 256), shared_trunk=True, device=cuda_device)
    before = _build.launch_counts["mlp_rollout"]
    for kw in ({"noise": _mlp_channels(2, 200, n, cuda_device)}, {"seed": 7, "device": cuda_device}):
        got = mr.mlp_rollout(p, model, num_trajectories=n, **kw)
        want = mr.mlp_rollout_plain(p, model, num_trajectories=n, **kw)
        torch.cuda.synchronize()
        same = _same_inventory_envs(got, want, n)
        for a, b in zip(got, want):
            torch.testing.assert_close(a[..., same], b[..., same], rtol=1e-4, atol=1e-3)
    assert _build.launch_counts["mlp_rollout"] == before + 2


def _rel_frobenius(a, b):
    return float(torch.linalg.vector_norm(a - b) / torch.clamp(torch.linalg.vector_norm(b), min=1e-30))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_fused_ppo_kernel_matches_plain_on_the_card(cuda_device, compute_dtype):
    """K4 on a 4,096-env slice (a strided view) of a K3 rollout at 8,192 x
    200, against its plain version.  float32: every grad to rtol=1e-4 with
    atol 1e-4 of the leaf's largest value; bf16: relative Frobenius error
    per leaf at most 1e-3 (same roundings, another summation order).
    Metrics to rtol=1e-4."""
    from mbt_gym_torch.agents.networks import init_actor_critic
    from mbt_gym_torch.agents.ppo import normalise
    from mbt_gym_torch.ops import fused_ppo
    from mbt_gym_torch.ops.mlp_rollout import collect_rollout_fused_T

    n, nb = 8192, 4096
    cfg = _ppo_cfg(n)
    model = init_actor_critic(4, 4, 2, hidden=(256, 256), shared_trunk=True, device=cuda_device)
    tb = collect_rollout_fused_T(cfg, model, 11, device=cuda_device)
    sl = lambda x: x[..., nb:]  # noqa: E731
    args = (sl(tb.obs_t), sl(tb.actions_t), sl(tb.log_probs), normalise(sl(tb.advantages)), sl(tb.returns))
    with torch.no_grad():
        model.log_std.add_(0.05)  # ratios away from 1, so both clip branches occur
    before = _build.launch_counts["ppo_fused_grads_T"]
    grads, metrics = fused_ppo.ppo_fused_grads_T(model, *args, compute_dtype=compute_dtype)
    want_g, want_m = fused_ppo.ppo_fused_grads_T_plain(model, *args, compute_dtype=compute_dtype)
    torch.cuda.synchronize()
    assert _build.launch_counts["ppo_fused_grads_T"] == before + 1
    assert set(grads) == {name for name, _ in model.named_parameters()}
    for name, want in want_g.items():
        got = grads[name]
        assert got.shape == want.shape, name
        if compute_dtype == "float32":
            atol = 1e-4 * float(want.abs().max())
            torch.testing.assert_close(got, want, rtol=1e-4, atol=atol, msg=lambda m: f"{name}: {m}")
        else:
            assert _rel_frobenius(got, want) <= 1e-3, (name, _rel_frobenius(got, want))
    for name, want in want_m.items():
        torch.testing.assert_close(metrics[name], want, rtol=1e-4, atol=1e-7)
