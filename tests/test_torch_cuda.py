"""The port's CUDA kernels against their plain PyTorch versions on the
card: the episode kernels K1 and K2, the MLP rollout K3 (both actor-critic
layouts; the limit, lam, touch and speed dynamics kinds, the exponential
utility, the t0 plane and the terminal observation), the fused PPO updates K4 (both layouts) and K7, the
deterministic-policy rollout K5, the OE episode K6 and the CJ episode K8,
and the step pipeline's wide shape.  They have no CPU mode, so every test here skips on a host
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


@pytest.mark.parametrize("shared_trunk", [True, False], ids=["shared-trunk", "towers"])
@pytest.mark.parametrize("reward", ["cjmm", "running", "cjmm-e3", "running-e3"])
def test_mlp_rollout_cj_rewards_match_plain_on_the_card(cuda_device, reward, shared_trunk):
    """K3's CjMm and running-penalty rewards at inventory exponents 2 and 3
    on the normalised CJ env (4,096 envs x 200 steps, 256x256, initial
    inventory 2), noise and native mode, against the plain version at the
    limits of the PnL test; a second launch is bitwise equal."""
    from mbt_gym_torch.agents.networks import init_actor_critic
    from mbt_gym_torch.ops import mlp_rollout as mr
    from mbt_gym_torch.rewards import CjMmCriterion, RunningInventoryPenalty
    from mbt_gym_torch.utils.config import cj_env_config

    n = 4096
    e = 3.0 if reward.endswith("e3") else 2.0
    r = (CjMmCriterion(0.5, 0.001, inventory_exponent=e) if reward.startswith("cjmm")
         else RunningInventoryPenalty(0.5, 0.001, inventory_exponent=e))
    cfg = dataclasses.replace(cj_env_config(num_trajectories=n, n_steps=200), reward_function=r, initial_inventory=2,
                              normalise_observation_space=True, normalise_action_space=True)
    p = mr.rollout_params_from_config(cfg)
    assert (p.reward_kind, p.inventory_exponent) == (reward.split("-")[0], e)
    model = init_actor_critic(5, 4, 2, hidden=(256, 256), shared_trunk=shared_trunk, device=cuda_device)
    for kw in ({"noise": _mlp_channels(6, 200, n, cuda_device)}, {"seed": 11, "device": cuda_device}):
        got = mr.mlp_rollout(p, model, num_trajectories=n, **kw)
        again = mr.mlp_rollout(p, model, num_trajectories=n, **kw)
        want = mr.mlp_rollout_plain(p, model, num_trajectories=n, **kw)
        torch.cuda.synchronize()
        same = _same_inventory_envs(got, want, n)
        for a, b, c in zip(got, want, again):
            torch.testing.assert_close(a[..., same], b[..., same], rtol=1e-4, atol=1e-3)
            assert torch.equal(a, c)


@pytest.mark.parametrize("shared_trunk", [True, False], ids=["shared-trunk", "towers"])
@pytest.mark.parametrize("kind", ["lam", "lam-mask", "touch", "canonical", "lam-float32"])
def test_mlp_rollout_lam_touch_kinds_match_plain_on_the_card(cuda_device, kind, shared_trunk):
    """K3's lam (A = 4, the market-order mask), touch and canonical (the
    per-env inv0 plane with the CjMm reward) kinds at 4,096 envs, 256x256,
    noise and native mode, against the plain version at the PnL test's
    limits (touch: its continuous fills compared to the same tolerance on
    every env; an env whose decision flips at the last step, seen only in
    its last reward, counts among the flips); a second launch is bitwise
    equal."""
    from mbt_gym_torch.agents.networks import init_actor_critic
    from mbt_gym_torch.ops import mlp_rollout as mr
    from mbt_gym_torch.utils.config import lam_env_config, learning_env_config, touch_env_config

    n = 4096
    cfg = {"lam": lam_env_config(num_trajectories=n),
           "lam-mask": dataclasses.replace(lam_env_config(num_trajectories=n, max_inventory=2.0),
                                           mask_market_orders_at_max_inventory=True),
           "touch": touch_env_config(num_trajectories=n),
           "canonical": learning_env_config(num_trajectories=n),
           "lam-float32": lam_env_config(num_trajectories=n)}[kind]
    cfg = dataclasses.replace(cfg, normalise_observation_space=kind != "lam-float32")
    p = mr.rollout_params_from_config(cfg)
    model = init_actor_critic(5, 4, p.a_dim, hidden=(256, 256), shared_trunk=shared_trunk, device=cuda_device)
    inv0 = None
    if p.inventory_range:
        inv0 = torch.from_numpy(np.random.default_rng(4).integers(*p.inventory_range, n).astype(np.float32))
        inv0 = inv0.to(cuda_device)
    rng = np.random.default_rng(6)
    channels = rng.uniform(size=(p.run_steps, mr.n_noise_channels(p.a_dim), n)).astype(np.float32)
    channels[:, 4:] = rng.normal(size=(p.run_steps, mr.n_noise_channels(p.a_dim) - 4, n)).astype(np.float32)
    for kw in ({"noise": torch.from_numpy(channels).to(cuda_device)}, {"seed": 11, "device": cuda_device}):
        got = mr.mlp_rollout(p, model, num_trajectories=n, inv0=inv0, **kw)
        again = mr.mlp_rollout(p, model, num_trajectories=n, inv0=inv0, **kw)
        want = mr.mlp_rollout_plain(p, model, num_trajectories=n, inv0=inv0, **kw)
        torch.cuda.synchronize()
        if kind == "touch":
            same = ((got[0][:, 1] - want[0][:, 1]).abs() <= 1e-3 + 1e-4 * want[0][:, 1].abs()).all(dim=0)
        else:
            same = (got[0][:, 1] == want[0][:, 1]).all(dim=0)
        # a decision flipped at the last step shows only in the last reward
        same &= (got[4][-1] - want[4][-1]).abs() <= 1e-3 + 1e-4 * want[4][-1].abs()
        assert int((~same).sum()) <= n // 1000
        for a, b, c in zip(got, want, again):
            torch.testing.assert_close(a[..., same], b[..., same], rtol=1e-4, atol=1e-3)
            assert torch.equal(a, c)


@pytest.mark.parametrize("shared_trunk", [True, False], ids=["shared-trunk", "towers"])
@pytest.mark.parametrize("kind", ["speed", "speed-float32", "speed-transient", "speed-utility", "limit-utility",
                                  "t0", "final-obs"])
def test_mlp_rollout_speed_and_extras_match_plain_on_the_card(cuda_device, kind, shared_trunk):
    """K3's speed kind (A = 1, S = 5; the transient impact on the general
    instantiation), the exponential utility, the t0 plane of a random start
    (per-env starts on the step grid) and the terminal observation at 4,096
    envs, 256x256, noise and native mode, against the plain version at the
    PnL test's limits (speed's continuous inventory to the tolerance on
    every env); a second launch is bitwise equal."""
    from mbt_gym_torch.agents.networks import init_actor_critic
    from mbt_gym_torch.ops import mlp_rollout as mr
    from mbt_gym_torch.processes.impact import TransientImpact
    from mbt_gym_torch.rewards import ExponentialUtility
    from mbt_gym_torch.utils.config import oe_env_config

    n = 4096
    norm = dict(normalise_observation_space=kind != "speed-float32", normalise_action_space=kind.startswith("speed"))
    base = as_env_config(num_trajectories=n) if kind in ("limit-utility", "t0", "final-obs") else oe_env_config(
        num_trajectories=n)
    cfg = dataclasses.replace(base, **norm)
    if kind == "speed-transient":
        cfg = dataclasses.replace(cfg, dynamics=dataclasses.replace(cfg.dynamics, price_impact_model=TransientImpact()))
    elif kind.endswith("utility"):
        cfg = dataclasses.replace(cfg, reward_function=ExponentialUtility(0.01))
    elif kind == "t0":
        cfg = dataclasses.replace(cfg, start_time=("uniform", 0.0, 0.5))
    p = mr.rollout_params_from_config(cfg)
    model = init_actor_critic(5, cfg.state_dim, p.a_dim, hidden=(256, 256), shared_trunk=shared_trunk,
                              device=cuda_device)
    extra = {"final_obs": kind == "final-obs", "t0": None}
    if kind == "t0":
        steps = np.random.default_rng(4).integers(0, 101, n)
        extra["t0"] = torch.from_numpy((steps * cfg.step_size).astype(np.float32)).to(cuda_device)
    rng = np.random.default_rng(6)
    channels = rng.uniform(size=(p.run_steps, p.n_channels, n)).astype(np.float32)
    channels[:, 4:] = rng.normal(size=(p.run_steps, p.n_channels - 4, n)).astype(np.float32)
    for kw in ({"noise": torch.from_numpy(channels).to(cuda_device)}, {"seed": 11, "device": cuda_device}):
        got = mr.mlp_rollout(p, model, num_trajectories=n, **kw, **extra)
        again = mr.mlp_rollout(p, model, num_trajectories=n, **kw, **extra)
        want = mr.mlp_rollout_plain(p, model, num_trajectories=n, **kw, **extra)
        torch.cuda.synchronize()
        if p.speed:
            same = ((got[0][:, 1] - want[0][:, 1]).abs() <= 1e-3 + 1e-4 * want[0][:, 1].abs()).all(dim=0)
        else:
            same = (got[0][:, 1] == want[0][:, 1]).all(dim=0)
        same &= (got[4][-1] - want[4][-1]).abs() <= 1e-3 + 1e-4 * want[4][-1].abs()
        assert int((~same).sum()) <= n // 1000
        for a, b, c in zip(got, want, again):
            torch.testing.assert_close(a[..., same], b[..., same], rtol=1e-4, atol=1e-3)
            assert torch.equal(a, c)


@pytest.mark.parametrize("shared_trunk", [True, False], ids=["shared-trunk", "towers"])
@pytest.mark.parametrize("hidden", [(64, 64), (36, 100), (256,), (128, 128, 128), (256, 256, 256)],
                         ids=["64x64", "36x100-padded", "256", "128x128x128", "256x256x256-unstaged"])
def test_mlp_rollout_kernel_at_the_mma_tile_edges(cuda_device, hidden, shared_trunk):
    """K3's tensor-core (bf16) path at the edges of its tiles: small, unequal
    and zero-padded widths (36 and 100 run as 48 and 112), one layer and
    three, inner layers too large for shared memory (read from device
    memory), on both layouts, with 4,096 + 32 envs (the last 128-env tile
    ragged), against its plain version at the limits above; a second launch
    on the same noise is bitwise equal."""
    from mbt_gym_torch.agents.networks import init_actor_critic
    from mbt_gym_torch.ops import mlp_rollout as mr

    n = 4096 + 32
    p = mr.rollout_params_from_config(_ppo_cfg(n))
    model = init_actor_critic(8, 4, 2, hidden=hidden, shared_trunk=shared_trunk, device=cuda_device)
    noise = _mlp_channels(4, 200, n, cuda_device)
    for kw in ({"noise": noise}, {"seed": 9, "device": cuda_device}):
        got = mr.mlp_rollout(p, model, num_trajectories=n, **kw)
        again = mr.mlp_rollout(p, model, num_trajectories=n, **kw)
        want = mr.mlp_rollout_plain(p, model, num_trajectories=n, **kw)
        torch.cuda.synchronize()
        same = _same_inventory_envs(got, want, n)
        for a, b, c in zip(got, want, again):
            torch.testing.assert_close(a[..., same], b[..., same], rtol=1e-4, atol=1e-3)
            assert torch.equal(a, c)


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
    _assert_update_close(grads, metrics, want_g, want_m, compute_dtype)


@pytest.mark.parametrize("normalised", [True, False], ids=["bf16-operands", "float32"])
def test_mlp_rollout_towers_kernel_matches_plain_on_the_card(cuda_device, normalised):
    """K3's towers mode (separate 256x256 pi/vf towers: the pi phase, then
    the vf phase's values) at 4,096 envs x 200 steps against its plain
    version, at the shared-trunk test's limits."""
    from mbt_gym_torch.agents.networks import init_actor_critic
    from mbt_gym_torch.ops import mlp_rollout as mr

    n = 4096
    p = mr.rollout_params_from_config(_ppo_cfg(n, normalised))
    model = init_actor_critic(5, 4, 2, hidden=(256, 256), shared_trunk=False, device=cuda_device)
    before = _build.launch_counts["mlp_rollout"]
    for kw in ({"noise": _mlp_channels(3, 200, n, cuda_device)}, {"seed": 8, "device": cuda_device}):
        got = mr.mlp_rollout(p, model, num_trajectories=n, **kw)
        want = mr.mlp_rollout_plain(p, model, num_trajectories=n, **kw)
        torch.cuda.synchronize()
        same = _same_inventory_envs(got, want, n)
        for a, b in zip(got, want):
            torch.testing.assert_close(a[..., same], b[..., same], rtol=1e-4, atol=1e-3)
    assert _build.launch_counts["mlp_rollout"] == before + 2


def _assert_update_close(grads, metrics, want_g, want_m, compute_dtype):
    """float32: every grad to rtol=1e-4 with atol 1e-4 of the leaf's largest
    value; bf16: relative Frobenius error per leaf at most 1e-3 (same
    roundings, another summation order).  Metrics to rtol=1e-4."""
    assert set(grads) == set(want_g)
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


def _update_samples(shared_trunk, device):
    """A moved model (log_std + 0.05, so both clip branches occur) and a
    K3 rollout of the unmoved one at 8,192 x 200 on the card."""
    from mbt_gym_torch.agents.networks import init_actor_critic
    from mbt_gym_torch.ops.mlp_rollout import collect_rollout_fused

    model = init_actor_critic(6, 4, 2, hidden=(256, 256), shared_trunk=shared_trunk, device=device)
    batch = collect_rollout_fused(_ppo_cfg(8192), model, 12, device=device)
    with torch.no_grad():
        model.log_std.add_(0.05)
    return model, batch


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_fused_ppo_towers_kernel_matches_plain_on_the_card(cuda_device, compute_dtype):
    """K4's stacked-trunk mode on separate 256x256 towers, on a 4,096-env
    slice (strided views) of a towers K3 rollout, against its plain
    version."""
    from mbt_gym_torch.agents.ppo import normalise
    from mbt_gym_torch.ops import fused_ppo

    model, batch = _update_samples(False, cuda_device)
    sl = lambda x: x.transpose(1, 2)[..., 4096:] if x.dim() == 3 else x[..., 4096:]  # noqa: E731
    args = (sl(batch.obs), sl(batch.actions), sl(batch.log_probs), normalise(sl(batch.advantages)),
            sl(batch.returns))
    before = _build.launch_counts["ppo_fused_grads_T"]
    grads, metrics = fused_ppo.ppo_fused_grads_T(model, *args, compute_dtype=compute_dtype)
    want_g, want_m = fused_ppo.ppo_fused_grads_T_plain(model, *args, compute_dtype=compute_dtype)
    torch.cuda.synchronize()
    assert _build.launch_counts["ppo_fused_grads_T"] == before + 1
    assert set(grads) == {name for name, _ in model.named_parameters()}
    _assert_update_close(grads, metrics, want_g, want_m, compute_dtype)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_fused_ppo_rows_kernel_matches_plain_on_the_card(cuda_device, compute_dtype):
    """K7 on a shuffled row-major minibatch (819,200 of the 1,638,400
    samples of a shared-trunk K3 rollout, gathered by a permutation)
    against its plain version."""
    from mbt_gym_torch.agents.ppo import normalise
    from mbt_gym_torch.ops import fused_ppo

    model, batch = _update_samples(True, cuda_device)
    flat = [batch.obs.reshape(-1, 4), batch.actions.reshape(-1, 2), batch.log_probs.reshape(-1),
            batch.advantages.reshape(-1), batch.returns.reshape(-1)]
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    idx = torch.randperm(flat[2].numel(), generator=gen, device=cuda_device)[:819_200]
    args = [x[idx] for x in flat]
    args[3] = normalise(args[3])
    before = _build.launch_counts["ppo_fused_grads"]
    grads, metrics = fused_ppo.ppo_fused_grads(model, *args, compute_dtype=compute_dtype)
    want_g, want_m = fused_ppo.ppo_fused_grads_plain(model, *args, compute_dtype=compute_dtype)
    torch.cuda.synchronize()
    assert _build.launch_counts["ppo_fused_grads"] == before + 1
    assert set(grads) == {name for name, _ in model.named_parameters()}
    _assert_update_close(grads, metrics, want_g, want_m, compute_dtype)


def test_update_kernels_refuse_outside_their_limits_on_the_card(cuda_device):
    """The update kernels take K3's trunks ((32, 32) and three-layer towers
    launch); a trunk outside them (nine layers, a width of 258), a ragged
    sample count or a towers minibatch that re-blocks to fewer than 32
    lanes raises a ValueError naming the limit, before any launch."""
    from mbt_gym_torch.agents import ppo
    from mbt_gym_torch.agents.networks import init_actor_critic
    from mbt_gym_torch.ops import fused_ppo

    m = 1024
    rows = [torch.zeros((m, 4), device=cuda_device), torch.zeros((m, 2), device=cuda_device)]
    rows += [torch.zeros(m, device=cuda_device) for _ in range(3)]
    feature_major = [x.reshape(8, m // 8, -1).transpose(1, 2).contiguous() if x.dim() == 2 else x.reshape(8, m // 8)
                     for x in rows]
    before = dict(_build.launch_counts)
    narrow = init_actor_critic(0, 4, 2, hidden=(32, 32), shared_trunk=True, device=cuda_device)
    fused_ppo.ppo_fused_grads(narrow, *rows)
    towers = init_actor_critic(0, 4, 2, hidden=(64, 64, 64), shared_trunk=False, device=cuda_device)
    fused_ppo.ppo_fused_grads_T(towers, *feature_major)
    torch.cuda.synchronize()
    assert _build.launch_counts["ppo_fused_grads"] == before["ppo_fused_grads"] + 1
    assert _build.launch_counts["ppo_fused_grads_T"] == before["ppo_fused_grads_T"] + 1
    for hidden in ((64,) * 9, (258,)):
        outside = init_actor_critic(0, 4, 2, hidden=hidden, shared_trunk=True, device=cuda_device)
        with pytest.raises(ValueError, match="K7 kernel takes 1-8 trunk layers"):
            fused_ppo.ppo_fused_grads(outside, *rows)
        with pytest.raises(ValueError, match="K4 kernel takes 1-8 trunk layers"):
            fused_ppo.ppo_fused_grads_T(outside, *feature_major)
    wide = init_actor_critic(0, 4, 2, hidden=(64, 64), shared_trunk=True, device=cuda_device)
    with pytest.raises(ValueError, match="multiple of 32 samples"):
        fused_ppo.ppo_fused_grads(wide, *(x[: m - 8] for x in rows))
    towers = init_actor_critic(0, 4, 2, hidden=(64, 64), shared_trunk=False, device=cuda_device)
    cfg = ppo.PPOConfig(hidden=(64, 64), fused_update=True)
    odd = ppo.UpdateBatch(*(x[: m - 8] for x in rows))
    with pytest.raises(ValueError, match="at least 32 lanes"):
        ppo._fused_grads_and_metrics(towers, cfg, odd)


@pytest.mark.parametrize("dims", [(4, 2), (8, 4), (9, 4), (16, 4), (5, 1)],
                         ids=["S4-A2", "S8-A4", "S9-A4", "S16-A4", "S5-A1"])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nb", [32, 96])
@pytest.mark.parametrize("hidden", [(64, 64), (128, 192), (256, 256), (32, 32), (64,), (36, 100), (256, 256, 256),
                                    (128,) * 8, (256,) * 8],
                         ids=["64x64", "128x192", "256x256", "32x32", "64", "36x100", "256x256x256", "128x8",
                              "256x8"])
def test_update_kernels_at_the_mma_tile_edges(cuda_device, hidden, nb, compute_dtype, dims):
    """K4 (shared trunk and towers) and K7 at the smallest and unequal
    widths, at one to eight layers (widths padded to multiples of 64 by the
    wrappers) and at 1 and 3 sample tiles per step, at S = 4, A = 2, the
    composite config's S = 8, A = 4, the all-axes config's S = 9, K3's
    S = 16 (two dW0 sweeps) and the OE configs' S = 5, A = 1, against their
    plain versions at the limits of the tests above (up to two layers 1e-3
    per leaf in bf16, K7 at JAX K7's rounding points); bf16 beyond two
    layers against the plain version's float64-summed evaluation at phase
    28a's fixed limits (chip_smoke.DEEP_BF16_LIMITS: a float32
    summation-order difference flips bf16 roundings that the later layers
    carry on).  A second launch on the same minibatch gives bitwise-equal
    grads and metrics (fixed tile ranges and a fixed-order reduction)."""
    from chip_smoke import compare_update, feature_major, update_samples
    from mbt_gym_torch.agents.networks import init_actor_critic
    from mbt_gym_torch.ops import fused_ppo

    t_steps = 5
    for shared_trunk in (True, False):
        model = init_actor_critic(7, *dims, hidden=hidden, shared_trunk=shared_trunk, device=cuda_device)
        with torch.no_grad():
            model.log_std.add_(0.05)
        rows = update_samples(torch, np, model, t_steps, nb, 11 + nb, cuda_device)
        calls = [(fused_ppo.ppo_fused_grads_T, fused_ppo.ppo_fused_grads_T_plain, feature_major(rows, t_steps, nb))]
        if shared_trunk:
            calls.append((fused_ppo.ppo_fused_grads, fused_ppo.ppo_fused_grads_plain, rows))
        for kernel, plain, args in calls:
            grads, metrics = kernel(model, *args, compute_dtype=compute_dtype)
            again, again_m = kernel(model, *args, compute_dtype=compute_dtype)
            torch.cuda.synchronize()
            if len(hidden) <= 2 or compute_dtype == "float32":
                _assert_update_close(grads, metrics, *plain(model, *args, compute_dtype=compute_dtype), compute_dtype)
            else:
                compare_update(torch, grads, metrics, model, args, plain, rows, compute_dtype,
                               f"{kernel.__name__} {hidden} shared={shared_trunk}")
            for name in grads:
                assert torch.equal(grads[name], again[name]), name
            for name in metrics:
                assert torch.equal(metrics[name], again_m[name]), name


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hidden,shared_trunk", [((256, 256, 256), True), ((256, 256, 256), False),
                                                 ((128,) * 8, True), ((36, 100), True), ((256, 256), False)],
                         ids=["256x256x256", "256x256x256-towers", "128x8", "36x100", "256x256-towers"])
def test_deep_update_kernels_over_several_chunks_on_the_card(cuda_device, monkeypatch, hidden, shared_trunk,
                                                             compute_dtype):
    """The deep instantiations with their staged scratch cut to two tiles,
    so that passes 1 and 2 run over 8 chunks of the 15 tiles (the last one
    ragged), each chunk adding to the partial sums of those before: K4 (and
    K7 on the shared trunk) against the plain versions at the edge test's
    limits, a second launch bitwise equal (K7 in bf16 stages float32 h
    planes, so its chunks hold one tile)."""
    from chip_smoke import compare_update, feature_major, update_samples
    from mbt_gym_torch.agents.networks import init_actor_critic
    from mbt_gym_torch.ops import fused_ppo

    t_steps, nb = 5, 96
    bf16 = compute_dtype == "bfloat16"
    model = init_actor_critic(17, 4, 2, hidden=hidden, shared_trunk=shared_trunk, device=cuda_device)
    with torch.no_grad():
        model.log_std.add_(0.05)
    shape = fused_ppo.check_kernel_limits(model, nb, 4, 2, "K4")
    tile_bytes = fused_ppo.deep_layout(shape, 1, 4, 2, bf16)["stage_bytes"]
    monkeypatch.setattr(fused_ppo, "_STAGE_BYTES", 2 * tile_bytes)
    assert fused_ppo.deep_layout(shape, t_steps * nb // 32, 4, 2, bf16)["chunk_tiles"] == 2
    rows = update_samples(torch, np, model, t_steps, nb, 23, cuda_device)
    calls = [(fused_ppo.ppo_fused_grads_T, fused_ppo.ppo_fused_grads_T_plain, feature_major(rows, t_steps, nb))]
    if shared_trunk:
        calls.append((fused_ppo.ppo_fused_grads, fused_ppo.ppo_fused_grads_plain, rows))
    for kernel, plain, args in calls:
        before = _build.launch_counts[kernel.__name__]
        got = kernel(model, *args, compute_dtype=compute_dtype)
        again = kernel(model, *args, compute_dtype=compute_dtype)
        torch.cuda.synchronize()
        assert _build.launch_counts[kernel.__name__] == before + 2
        compare_update(torch, *got, model, args, plain, rows, compute_dtype,
                       f"{kernel.__name__} {hidden} shared={shared_trunk} in chunks")
        for first, second in zip(got, again):
            for name in first:
                assert torch.equal(first[name], second[name]), name


def test_fused_ppo_bf16_repeat_launch_is_bitwise_equal(cuda_device):
    """K4's bf16 passes, built from the shared tensor-core header (mma.cuh),
    give bitwise-equal grads and metrics on a second launch over the same
    200 x 4,096 minibatch at 256x256, on both layouts."""
    from chip_smoke import feature_major, update_samples
    from mbt_gym_torch.agents.networks import init_actor_critic
    from mbt_gym_torch.ops import fused_ppo

    t_steps, nb = 200, 4096
    for shared_trunk in (True, False):
        model = init_actor_critic(9, 4, 2, hidden=(256, 256), shared_trunk=shared_trunk, device=cuda_device)
        args = feature_major(update_samples(torch, np, model, t_steps, nb, 13, cuda_device), t_steps, nb)
        grads, metrics = fused_ppo.ppo_fused_grads_T(model, *args, compute_dtype="bfloat16")
        again, again_m = fused_ppo.ppo_fused_grads_T(model, *args, compute_dtype="bfloat16")
        torch.cuda.synchronize()
        for name in grads:
            assert torch.equal(grads[name], again[name]), name
        for name in metrics:
            assert torch.equal(metrics[name], again_m[name]), name


def _assert_terminal_close(got, want, n):
    """K1's limits for a terminal state (cash, inventory, price, ...):
    inventory may flip on at most 1e-4 of envs (a fill decided at an exp()
    ULP boundary); the other outputs to rtol=1e-6/atol=1e-3 elsewhere."""
    same = got[1] == want[1]
    assert int((~same).sum()) <= n // 10_000
    for a, b in zip(got, want):
        torch.testing.assert_close(a[same], b[same], rtol=1e-6, atol=1e-3)


def _assert_streams_close(got, want, n):
    """K5 streams (obs (T,S,N), actions, log-probs, values, rewards[, final
    obs]) on the envs whose inventory plane agrees at every step."""
    same = (got[0][:, 1] == want[0][:, 1]).all(dim=0)
    assert int((~same).sum()) <= n // 10_000
    for a, b in zip(got, want):
        torch.testing.assert_close(a[..., same], b[..., same], rtol=1e-6, atol=1e-3)


def _det_cases():
    from mbt_gym_torch.agents.baseline import CarteaJaimungalMmAgent, CarteaJaimungalOeAgent
    from mbt_gym_torch.ops import det_rollout as det
    from mbt_gym_torch.rewards import CjMmCriterion, CjOeCriterion, RunningInventoryPenalty
    from mbt_gym_torch.utils.config import cj_env_config, lam_env_config, oe_env_config, touch_env_config

    cj = cj_env_config(num_trajectories=4096, n_steps=300, max_inventory=5.0)
    agent = CarteaJaimungalMmAgent.from_config(cj)
    oe = oe_env_config(num_trajectories=4096)
    oe_agent = CarteaJaimungalOeAgent.from_config(oe, alpha=0.01)
    late = dataclasses.replace(as_env_config(num_trajectories=4096), initial_inventory=(-3, 4), start_time=0.1)
    # inventory exponent 3: the CJ tables come from the exponent-2 agent
    # (its closed form assumes 2)
    cj3 = dataclasses.replace(cj, reward_function=CjMmCriterion(0.01, 0.001, inventory_exponent=3.0),
                              initial_inventory=2)
    as3 = dataclasses.replace(as_env_config(num_trajectories=4096),
                              reward_function=RunningInventoryPenalty(0.01, 0.001, inventory_exponent=3.0))
    oe3 = dataclasses.replace(oe, reward_function=CjOeCriterion(oe.reward_function.per_step_inventory_aversion,
                                                                oe.reward_function.terminal_inventory_aversion,
                                                                inventory_exponent=3.0))
    return {
        "cj-table-e3": (det.cj_rollout_params(cj3, agent), det.cj_depth_tables(agent)),
        "as-fixed-running-e3": (det.fixed_rollout_params(as3, [0.7, 0.9]), ()),
        "oe-fixed-e3": (det.fixed_rollout_params(oe3, [-2.5]), ()),
        "cj-table": (det.cj_rollout_params(cj, agent), det.cj_depth_tables(agent)),
        "as-fixed-random-inventory": (det.fixed_rollout_params(late, [0.7, 0.9]), ()),
        "oe-fixed": (det.fixed_rollout_params(oe, [-2.5]), ()),
        "oe-schedule": (det.schedule_rollout_params(oe), (det.schedule_table_from_policy(oe, oe_agent.policy()),)),
        "lam-fixed": (det.fixed_rollout_params(lam_env_config(num_trajectories=4096), [0.6, 0.6, 0.7, 0.2]), ()),
        "lam-fixed-mask": (det.fixed_rollout_params(dataclasses.replace(
            lam_env_config(num_trajectories=4096, max_inventory=3.0), mask_market_orders_at_max_inventory=True),
            [0.6, 0.6, 0.7, 0.0]), ()),
        "touch-fixed": (det.fixed_rollout_params(touch_env_config(num_trajectories=4096), [1.0, 0.5]), ()),
    }


@pytest.mark.parametrize("case", ["cj-table", "as-fixed-random-inventory", "oe-fixed", "oe-schedule",
                                  "cj-table-e3", "as-fixed-running-e3", "oe-fixed-e3", "lam-fixed",
                                  "lam-fixed-mask", "touch-fixed"])
def test_det_rollout_kernel_matches_plain_on_the_card(cuda_device, case):
    """K5 in both output modes, noise and native, against its plain version
    at K1's limits, at inventory exponent 2 and 3."""
    from mbt_gym_torch.ops import det_rollout as det

    p, tables = _det_cases()[case]
    n = 4096
    inv0 = None
    if p.inventory_range:
        inv0 = torch.from_numpy(np.random.default_rng(3).integers(*p.inventory_range, n).astype(np.float32)).to(cuda_device)
    before = _build.launch_counts["det_rollout"]
    for kw in ({"noise": _channels(4, p.run_steps, n, cuda_device)}, {"seed": 6, "device": cuda_device}):
        for stats in (True, False):
            extra = {"stats_only": stats, "final_obs": not stats, "inv0": inv0}
            got = det.det_rollout(p, tables, num_trajectories=n, **kw, **extra)
            want = det.det_rollout_plain(p, tables, num_trajectories=n, **kw, **extra)
            torch.cuda.synchronize()
            if stats:
                _assert_terminal_close(got, want, n)
            else:
                _assert_streams_close(got, want, n)
    assert _build.launch_counts["det_rollout"] == before + 4


def test_oe_episode_kernel_matches_plain_on_the_card(cuda_device):
    """K6 against its plain version (no fills, so inventory agrees
    exactly), and its native normals are K5's on speed dynamics: the
    schedule kind's terminal state on the same seed agrees."""
    from mbt_gym_torch.agents.baseline import CarteaJaimungalOeAgent
    from mbt_gym_torch.ops import det_rollout as det
    from mbt_gym_torch.ops import oe_episode as oe
    from mbt_gym_torch.utils.config import oe_env_config

    n = 8192
    cfg = oe_env_config(num_trajectories=n)
    agent = CarteaJaimungalOeAgent.from_config(cfg, alpha=0.01)
    p = oe.oe_params_from_config(cfg)
    table = oe.oe_speed_table(cfg, agent)
    before = _build.launch_counts["oe_episode"]
    normals = torch.from_numpy(np.random.default_rng(5).normal(size=(p.run_steps, n)).astype(np.float32)).to(cuda_device)
    for kw in ({"noise": normals}, {"seed": 8, "device": cuda_device}):
        got = oe.oe_episode(p, table, num_trajectories=n, **kw)
        want = oe.oe_episode_plain(p, table, num_trajectories=n, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
        _assert_terminal_close(got, want, n)
    assert _build.launch_counts["oe_episode"] == before + 2
    k5 = det.schedule_rollout(det.schedule_rollout_params(cfg), table[:, None], 8, n, stats_only=True, device=cuda_device)
    # same speeds and normals; K5 adds the impact before the price, K6 after
    torch.testing.assert_close(k5[1], got[1], rtol=0, atol=0)
    torch.testing.assert_close(k5[2], got[2], rtol=0, atol=0)
    torch.testing.assert_close(k5[0], got[0], rtol=1e-6, atol=1e-3)


def test_cj_episode_kernel_matches_plain_and_k5_on_the_card(cuda_device):
    """K8 against its plain version, and its terminal state against K5's
    table stats mode on the same noise and config."""
    import dataclasses as dc

    from mbt_gym_torch.agents.baseline import CarteaJaimungalMmAgent
    from mbt_gym_torch.ops import cj_episode as cj
    from mbt_gym_torch.ops import det_rollout as det
    from mbt_gym_torch.utils.config import cj_env_config

    n = 4096
    cfg = dc.replace(cj_env_config(num_trajectories=n, n_steps=300), max_inventory=5.0)
    agent = CarteaJaimungalMmAgent.from_config(cfg, max_inventory=10)
    p = cj.cj_params_from_config(cfg)
    table = np.asarray(agent.depth_table()[:-1], np.float32)
    before = _build.launch_counts["cj_episode"]
    noise = _channels(9, p.n_steps, n, cuda_device)
    for kw in ({"noise": noise}, {"seed": 12, "device": cuda_device}):
        got = cj.cj_episode(p, table, q_cap=10, num_trajectories=n, **kw)
        want = cj.cj_episode_plain(p, table, q_cap=10, num_trajectories=n, **kw)
        torch.cuda.synchronize()
        _assert_terminal_close(got, want, n)
        k5 = det.table_rollout(det.cj_rollout_params(cfg, agent), *det.cj_depth_tables(agent),
                               num_trajectories=n, stats_only=True, **kw)
        for a, b in zip(got[:3], k5[:3]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert _build.launch_counts["cj_episode"] == before + 2


def _pipeline_cases(run_steps, t_off):
    """K5's five policy/dynamics kinds on configs of ``run_steps`` executed
    steps; with ``t_off`` the episode starts that many steps in (the table
    and schedule rows from ``t_off``) and limit-order envs draw their
    initial inventory (the ``inv0`` plane)."""
    from mbt_gym_torch.agents.baseline import CarteaJaimungalMmAgent, CarteaJaimungalOeAgent
    from mbt_gym_torch.ops import det_rollout as det
    from mbt_gym_torch.utils.config import cj_env_config, oe_env_config

    steps = run_steps + t_off

    def late(cfg, inventory=True):
        if not t_off:
            return cfg
        extra = {"initial_inventory": (-3, 4)} if inventory else {}
        return dataclasses.replace(cfg, start_time=t_off * cfg.step_size, **extra)

    cj = late(cj_env_config(num_trajectories=16, n_steps=steps, max_inventory=5.0))
    agent = CarteaJaimungalMmAgent.from_config(cj)
    as_cfg = late(as_env_config(num_trajectories=16, n_steps=steps))
    oe = late(oe_env_config(num_trajectories=16, n_steps=steps), inventory=False)
    oe_agent = CarteaJaimungalOeAgent.from_config(oe, alpha=0.01)
    depths = np.random.default_rng(7).uniform(0.2, 2.0, size=(steps, 2)).astype(np.float32)
    return {
        "table": (det.cj_rollout_params(cj, agent), det.cj_depth_tables(agent)),
        "limit-fixed": (det.fixed_rollout_params(as_cfg, [0.7, 0.9]), ()),
        "limit-schedule": (det.schedule_rollout_params(as_cfg), (depths,)),
        "speed-fixed": (det.fixed_rollout_params(oe, [-2.5]), ()),
        "speed-schedule": (det.schedule_rollout_params(oe), (det.schedule_table_from_policy(oe, oe_agent.policy()),)),
    }


def _assert_bitwise(got, again):
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("kind", ["table", "limit-fixed", "limit-schedule", "speed-fixed", "speed-schedule"])
@pytest.mark.parametrize("run_steps,t_off", [(1, 0), (7, 3), (300, 0)], ids=["1-step", "7-steps-late", "300-steps"])
def test_det_rollout_pipeline_edges_on_the_card(cuda_device, kind, run_steps, t_off):
    """K5's step pipeline at its edges: 4,100 envs (a ragged last CTA) and
    4,099 (noise rows not 16-byte aligned, so the producers load them
    instead of the bulk-copy engine), episodes of 1, 7 and 300 steps (not
    multiples of a slot's steps), a late start with per-env initial
    inventories; every kind in both draw modes and both output modes
    against its plain version at K1's limits, a repeated launch bitwise."""
    from mbt_gym_torch.ops import det_rollout as det

    p, tables = _pipeline_cases(run_steps, t_off)[kind]
    assert p.run_steps == run_steps and round(p.start_time / p.dt) == t_off
    for n in (4100, 4099):
        inv0 = None
        if p.inventory_range:
            rng = np.random.default_rng(3)
            inv0 = torch.from_numpy(rng.integers(*p.inventory_range, n).astype(np.float32)).to(cuda_device)
        for kw in ({"noise": _channels(4, run_steps, n, cuda_device)}, {"seed": 6, "device": cuda_device}):
            for stats in (True, False):
                extra = {"stats_only": stats, "final_obs": not stats, "inv0": inv0}
                got = det.det_rollout(p, tables, num_trajectories=n, **kw, **extra)
                again = det.det_rollout(p, tables, num_trajectories=n, **kw, **extra)
                want = det.det_rollout_plain(p, tables, num_trajectories=n, **kw, **extra)
                torch.cuda.synchronize()
                _assert_bitwise(got, again)
                if stats:
                    _assert_terminal_close(got, want, n)
                else:
                    _assert_streams_close(got, want, n)


@pytest.mark.parametrize("run_steps", [1, 7, 300])
def test_cj_episode_edges_on_the_card(cuda_device, run_steps):
    """K8 at 4,100 and 4,099 envs and 1, 7 and 300 steps, both draw modes:
    against its plain version at K1's limits, its terminal state bitwise
    K5's table stats mode (the step pipeline) on the same noise, a repeated
    launch bitwise."""
    from mbt_gym_torch.agents.baseline import CarteaJaimungalMmAgent
    from mbt_gym_torch.ops import cj_episode as cj
    from mbt_gym_torch.ops import det_rollout as det
    from mbt_gym_torch.utils.config import cj_env_config

    cfg = cj_env_config(num_trajectories=16, n_steps=run_steps, max_inventory=5.0)
    agent = CarteaJaimungalMmAgent.from_config(cfg, max_inventory=10)
    p = cj.cj_params_from_config(cfg)
    table = np.asarray(agent.depth_table()[:-1], np.float32)
    for n in (4100, 4099):
        for kw in ({"noise": _channels(9, run_steps, n, cuda_device)}, {"seed": 12, "device": cuda_device}):
            got = cj.cj_episode(p, table, q_cap=10, num_trajectories=n, **kw)
            again = cj.cj_episode(p, table, q_cap=10, num_trajectories=n, **kw)
            want = cj.cj_episode_plain(p, table, q_cap=10, num_trajectories=n, **kw)
            k5 = det.table_rollout(det.cj_rollout_params(cfg, agent), *det.cj_depth_tables(agent),
                                   num_trajectories=n, stats_only=True, **kw)
            torch.cuda.synchronize()
            _assert_bitwise(got, again)
            _assert_terminal_close(got, want, n)
            _assert_bitwise(got[:3], k5[:3])


def _assert_planes_close(got, want, n):
    """K2's (T, N) planes on the envs whose inventory plane agrees at every
    step (at most 1e-4 of them may differ), at K1's limits."""
    same = (got[1] == want[1]).all(dim=0)
    assert int((~same).sum()) <= n // 10_000
    for a, b in zip(got, want):
        torch.testing.assert_close(a[:, same], b[:, same], rtol=1e-6, atol=1e-3)


def _assert_trajectory(traj, full, plain, terminal, n, p):
    """K2's trajectory layout: bitwise the layout of its own full streams
    (time column and initial row included), at K1's limits against the
    plain layout, its last row bitwise K1's terminal state."""
    want = ep.as_trajectory_from_full(p, full)
    assert all(torch.equal(a, b) for a, b in zip(traj, want))
    same = (traj.observations[..., 1] == plain.observations[..., 1]).all(dim=0)
    assert int((~same).sum()) <= n // 10_000
    for a, b in zip(traj, plain):
        torch.testing.assert_close(a[:, same], b[:, same], rtol=1e-6, atol=1e-3)
    last = traj.observations[-1]
    _assert_bitwise(terminal, (last[:, 0], last[:, 1], last[:, 3]))


@pytest.mark.parametrize("run_steps", [1, 7, 200])
@pytest.mark.parametrize("start", [0, 3], ids=["t0", "late"])
def test_as_episode_pipeline_edges_on_the_card(cuda_device, run_steps, start):
    """K1's and K2's step pipeline at 4,100 envs (a ragged last CTA) and
    4,099 (noise rows not 16-byte aligned), episodes of 1, 7 and 200 steps
    (not multiples of a slot's steps), a late start with an initial
    inventory, both draw modes: K1 and K2 (state, full, the trajectory
    layout) against their plain versions at K1's limits, K2's last row
    bitwise K1's terminal state, repeated launches bitwise."""
    cfg = dataclasses.replace(as_env_config(num_trajectories=16, n_steps=run_steps + start), initial_inventory=3)
    if start:
        cfg = dataclasses.replace(cfg, start_time=start * cfg.step_size, initial_cash=5.0)
    p = ep.params_from_config(cfg, 0.1)
    assert p.run_steps == run_steps
    for n in (4100, 4099):
        assert ep.kernel_geometry(p, n).shape == ep.trajectory_geometry(p, n).shape == "pipeline"
        for kw in ({"noise": _channels(2, run_steps, n, cuda_device)}, {"seed": 7, "device": cuda_device}):
            got = ep.as_episode(p, num_trajectories=n, **kw)
            again = ep.as_episode(p, num_trajectories=n, **kw)
            want = ep.as_episode_plain(p, num_trajectories=n, **kw)
            k2 = ep.as_episode_trajectories(p, num_trajectories=n, emit="state", **kw)
            full = ep.as_episode_trajectories(p, num_trajectories=n, emit="full", **kw)
            full_again = ep.as_episode_trajectories(p, num_trajectories=n, emit="full", **kw)
            full_plain = ep.as_episode_trajectories_plain(p, num_trajectories=n, emit="full", **kw)
            traj = ep.as_episode_trajectory(p, num_trajectories=n, **kw)
            traj_again = ep.as_episode_trajectory(p, num_trajectories=n, **kw)
            traj_plain = ep.as_episode_trajectory_plain(p, num_trajectories=n, **kw)
            torch.cuda.synchronize()
            _assert_bitwise(got, again)
            _assert_terminal_close(got, want, n)
            _assert_bitwise(got, (k2[0][-1], k2[1][-1], k2[2][-1]))
            _assert_bitwise(full, full_again)
            _assert_planes_close(full, full_plain, n)
            _assert_bitwise(traj, traj_again)
            _assert_trajectory(traj, full, traj_plain, got, n, p)


@pytest.mark.parametrize("run_steps", [1, 7, 200])
def test_oe_episode_pipeline_edges_on_the_card(cuda_device, run_steps):
    """K6's step pipeline (one draw channel, (T, N) noise) at 4,100 envs (a
    ragged last CTA) and 4,099 (noise rows not 16-byte aligned), episodes of
    1, 7 and 200 steps (not multiples of a slot's steps), both draw modes:
    against its plain version (no fills, so the inventory exactly), a
    repeated launch bitwise."""
    from mbt_gym_torch.agents.baseline import CarteaJaimungalOeAgent
    from mbt_gym_torch.ops import oe_episode as oe
    from mbt_gym_torch.utils.config import oe_env_config

    cfg = oe_env_config(num_trajectories=16, n_steps=run_steps)
    p = oe.oe_params_from_config(cfg)
    table = oe.oe_speed_table(cfg, CarteaJaimungalOeAgent.from_config(cfg, alpha=0.01))
    for n in (4100, 4099):
        assert oe.kernel_geometry(p, n).shape == "pipeline"
        normals = torch.from_numpy(np.random.default_rng(3).normal(size=(run_steps, n)).astype(np.float32))
        for kw in ({"noise": normals.to(cuda_device)}, {"seed": 9, "device": cuda_device}):
            got = oe.oe_episode(p, table, num_trajectories=n, **kw)
            again = oe.oe_episode(p, table, num_trajectories=n, **kw)
            want = oe.oe_episode_plain(p, table, num_trajectories=n, **kw)
            torch.cuda.synchronize()
            _assert_bitwise(got, again)
            torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
            _assert_terminal_close(got, want, n)


def test_cj_fill_table_kernel_is_the_plain_exp_on_the_card(cuda_device):
    """K8's fill probabilities from the fill kernel are torch.exp of the
    scaled depths, bitwise, at the CJP shape."""
    from mbt_gym_torch.agents.baseline import CarteaJaimungalMmAgent
    from mbt_gym_torch.ops import cj_episode as cj
    from mbt_gym_torch.utils.config import cj_env_config

    cfg = cj_env_config(num_trajectories=16, max_inventory=100.0)
    p = cj.cj_params_from_config(cfg)
    table = torch.tensor(CarteaJaimungalMmAgent.from_config(cfg, max_inventory=100).depth_table_f32()[:-1],
                         device=cuda_device)
    got = cj.cj_fill_table(p, table)
    torch.cuda.synchronize()
    assert torch.equal(got, cj.cj_fill_table_plain(p, table))


@pytest.mark.parametrize("kernel", ["K1", "K2", "K2 trajectory", "K6", "K8"])
def test_wide_shape_matches_plain_and_the_pipeline_on_the_card(cuda_device, monkeypatch, kernel):
    """From their threshold on (K2's own, the others' WIDE_MIN_ENVS), K1, K2
    (its full streams and its trajectory layout), K6 and K8 take the wide
    shape (one thread per env, no ring).  There (plus 3 envs, a ragged last CTA), in
    both draw modes: against the plain version, a repeated launch bitwise,
    and bitwise the step pipeline's result at the same size, since each
    thread draws its draws in the same operation order.  Episodes are cut
    to 50 steps: the shape does not depend on them."""
    from mbt_gym_torch.agents.baseline import CarteaJaimungalMmAgent, CarteaJaimungalOeAgent
    from mbt_gym_torch.ops import cj_episode as cj
    from mbt_gym_torch.ops import oe_episode as oe
    from mbt_gym_torch.ops import step_pipeline as sp
    from mbt_gym_torch.utils.config import cj_env_config, oe_env_config

    n, steps = (sp.wide_min_envs("as streams") if kernel.startswith("K2") else sp.WIDE_MIN_ENVS) + 3, 50
    gen = torch.Generator(cuda_device).manual_seed(21)
    if kernel == "K6":
        cfg = oe_env_config(num_trajectories=16, n_steps=steps)
        p = oe.oe_params_from_config(cfg)
        table = oe.oe_speed_table(cfg, CarteaJaimungalOeAgent.from_config(cfg, alpha=0.01))
        module, geometry = oe, lambda: oe.kernel_geometry(p, n)
        noise = torch.randn((steps, n), generator=gen, device=cuda_device)
        run = lambda **kw: oe.oe_episode(p, table, num_trajectories=n, **kw)  # noqa: E731
        plain = lambda **kw: oe.oe_episode_plain(p, table, num_trajectories=n, **kw)  # noqa: E731
    else:
        noise = torch.rand((steps, 5, n), generator=gen, device=cuda_device)
        noise[:, 4] = torch.randn((steps, n), generator=gen, device=cuda_device)
        if kernel == "K1":
            p = ep.params_from_config(as_env_config(num_trajectories=16, n_steps=steps), 0.1)
            module, geometry = ep, lambda: ep.kernel_geometry(p, n)
            run = lambda **kw: ep.as_episode(p, num_trajectories=n, **kw)  # noqa: E731
            plain = lambda **kw: ep.as_episode_plain(p, num_trajectories=n, **kw)  # noqa: E731
        elif kernel == "K2":
            p = ep.params_from_config(as_env_config(num_trajectories=16, n_steps=steps), 0.1)
            module, geometry = ep, lambda: ep.trajectory_geometry(p, n)
            run = lambda **kw: ep.as_episode_trajectories(p, num_trajectories=n, emit="full", **kw)  # noqa: E731
            plain = lambda **kw: ep.as_episode_trajectories_plain(p, num_trajectories=n, emit="full", **kw)  # noqa: E731
        elif kernel == "K2 trajectory":
            p = ep.params_from_config(as_env_config(num_trajectories=16, n_steps=steps), 0.1)
            module, geometry = ep, lambda: ep.trajectory_geometry(p, n)
            run = lambda **kw: ep.as_episode_trajectory(p, num_trajectories=n, **kw)  # noqa: E731
            plain = lambda **kw: ep.as_episode_trajectory_plain(p, num_trajectories=n, **kw)  # noqa: E731
        else:
            cfg = cj_env_config(num_trajectories=16, n_steps=steps, max_inventory=100.0)
            p = cj.cj_params_from_config(cfg)
            table = torch.tensor(CarteaJaimungalMmAgent.from_config(cfg, max_inventory=100).depth_table_f32()[:-1],
                                 device=cuda_device)
            module, geometry = cj, lambda: cj.kernel_geometry(p, 100, n)
            run = lambda **kw: cj.cj_episode(p, table, q_cap=100, num_trajectories=n, **kw)  # noqa: E731
            plain = lambda **kw: cj.cj_episode_plain(p, table, q_cap=100, num_trajectories=n, **kw)  # noqa: E731
    assert geometry().shape == "wide"
    for kw in ({"noise": noise}, {"seed": 17, "device": cuda_device}):
        got, again, want = run(**kw), run(**kw), plain(**kw)
        torch.cuda.synchronize()
        _assert_bitwise(got, again)
        if kernel == "K2":
            _assert_planes_close(got, want, n)
        elif kernel == "K2 trajectory":
            full = ep.as_episode_trajectories(p, num_trajectories=n, emit="full", **kw)
            _assert_trajectory(got, full, want, ep.as_episode(p, num_trajectories=n, **kw), n, p)
        else:
            _assert_terminal_close(got, want, n)
        with monkeypatch.context() as m:
            m.setattr(module, "pipeline_geometry",
                      lambda *a, **k: sp.pipeline_geometry(*a, **{**k, "wide": False}))
            assert geometry().shape == "pipeline"
            piped = run(**kw)
            torch.cuda.synchronize()
        _assert_bitwise(got, piped)


def test_a_table_too_wide_to_stage_is_read_from_global_memory_on_the_card(cuda_device):
    """max_inventory 5,000: 10,001 entries per row and side, 160 KB a step
    with the fill tables, more than the ring holds, so K5 reads the tables
    from global memory while
    the draws are still staged; against its plain version, and K8 at the
    same width (its two interleaved tables read from global memory too)
    bitwise K5's terminal state.  The
    depths are random (the closed form at this width is not needed to test
    the read)."""
    from mbt_gym_torch.agents.baseline import CarteaJaimungalMmAgent
    from mbt_gym_torch.ops import cj_episode as cj
    from mbt_gym_torch.ops import det_rollout as det
    from mbt_gym_torch.utils.config import cj_env_config

    q, steps, n = 5000, 50, 4100
    cfg = cj_env_config(num_trajectories=16, n_steps=steps, max_inventory=5.0)
    p = det.cj_rollout_params(cfg, CarteaJaimungalMmAgent.from_config(cfg))._replace(table_size=2 * q + 1)
    rng = np.random.default_rng(13)
    bid, ask = (rng.uniform(0.2, 2.0, size=(steps + 1, 2 * q + 1)).astype(np.float32) for _ in range(2))
    assert det.kernel_geometry(p, n, True).table_path == "global"
    assert cj.kernel_geometry(cj.cj_params_from_config(cfg), q, n).table_path == "global"
    for kw in ({"noise": _channels(5, steps, n, cuda_device)}, {"seed": 14, "device": cuda_device}):
        for stats in (True, False):
            extra = {"stats_only": stats, "final_obs": not stats}
            got = det.table_rollout(p, bid, ask, num_trajectories=n, **kw, **extra)
            want = det.table_rollout_plain(p, bid, ask, num_trajectories=n, **kw, **extra)
            torch.cuda.synchronize()
            if stats:
                _assert_terminal_close(got, want, n)
                k5 = got
            else:
                _assert_streams_close(got, want, n)
        table = np.stack([bid[:-1], ask[:-1]], axis=-1)
        k8 = cj.cj_episode(cj.cj_params_from_config(cfg), table, q_cap=q, num_trajectories=n, **kw)
        k8_plain = cj.cj_episode_plain(cj.cj_params_from_config(cfg), table, q_cap=q, num_trajectories=n, **kw)
        torch.cuda.synchronize()
        _assert_terminal_close(k8, k8_plain, n)
        _assert_bitwise(k8[:3], k5[:3])


def test_streams_memory_rule_counts_the_allocator_cache_as_free(cuda_device):
    """A tensor the process allocated and freed stays reserved by PyTorch's
    caching allocator, and cudaMemGetInfo counts it as taken; the streams
    rule counts it as free, so a warm cache does not flip a decision.  The
    card's free figure may move by 1% (other contexts on the card)."""
    from mbt_gym_torch.ops import det_rollout as det

    torch.cuda.empty_cache()
    cold = det.device_free_bytes(cuda_device)
    block = torch.empty(cold // 2, dtype=torch.uint8, device=cuda_device)
    del block
    try:
        reported_free = torch.cuda.mem_get_info(cuda_device)[0]
        assert reported_free < cold - cold // 3  # the cached block reads as taken
        warm = det.device_free_bytes(cuda_device)
        assert abs(warm - cold) <= cold // 100, (cold, warm)
    finally:
        torch.cuda.empty_cache()


def _process_kind_cases(run_steps):
    """{name: (K5 params, tables)} of the general and composite process
    kinds (phase 24a of chip_smoke.py) at ``run_steps`` steps."""
    from mbt_gym_torch import processes as pc
    from mbt_gym_torch.agents.baseline import CarteaJaimungalMmAgent
    from mbt_gym_torch.ops import det_rollout as det
    from mbt_gym_torch.utils.config import cj_env_config, composite_env_config, oe_env_config

    def with_(cfg, **dyn):
        return dataclasses.replace(cfg, dynamics=dataclasses.replace(cfg.dynamics, **dyn))

    comp = composite_env_config(num_trajectories=4100, n_steps=run_steps)
    cj = cj_env_config(num_trajectories=4100, n_steps=run_steps, max_inventory=10.0)
    agent = CarteaJaimungalMmAgent.from_config(cj, max_inventory=10)
    oe = oe_env_config(num_trajectories=4100, n_steps=run_steps)
    return {
        "composite": (det.fixed_rollout_params(comp, [0.6, 0.6, 0.0, 0.7]), ()),
        "all-axes": (det.fixed_rollout_params(with_(comp, midprice_model=pc.HestonMidprice()), [0.6, 0.6, 0.7, 0.0]),
                     ()),
        "table-power": (det.cj_rollout_params(with_(cj, fill_probability_model=pc.PowerFill()), agent),
                        det.cj_depth_tables(agent)),
        "speed-transient-alpha": (det.fixed_rollout_params(with_(oe, price_impact_model=pc.TransientImpact(),
                                                                  midprice_model=pc.ShortTermOuAlphaMidprice()),
                                                           [-2.5]), ()),
    }


@pytest.mark.parametrize("kind", ["composite", "all-axes", "table-power", "speed-transient-alpha"])
@pytest.mark.parametrize("run_steps", [7, 200])
def test_process_kinds_at_the_pipeline_edges_on_the_card(cuda_device, kind, run_steps):
    """K5's general and composite instantiations at the pipeline's edges:
    4,100 envs (a ragged last CTA) and 4,099 (the injected channels, placed
    by the noise map, not 16-byte aligned), 7 and 200 steps, both draw
    modes and output modes, against the plain version at K1's limits, a
    repeated launch bitwise; K3's general kind on the composite config with
    raw observations (float32 products) and on the all-axes config with
    normalised ones (bf16) at 4,128 envs (a ragged last 128-env tile) the
    same way."""
    from mbt_gym_torch.agents.networks import init_actor_critic
    from mbt_gym_torch.ops import det_rollout as det
    from mbt_gym_torch.ops import mlp_rollout as mr

    p, tables = _process_kind_cases(run_steps)[kind]
    for n in (4100, 4099):
        rng = np.random.default_rng(8)
        c = rng.uniform(size=(run_steps, p.n_channels, n)).astype(np.float32)
        c[:, 4:] = rng.normal(size=(run_steps, p.n_channels - 4, n)).astype(np.float32)
        for kw in ({"noise": torch.from_numpy(c).to(cuda_device)}, {"seed": 6, "device": cuda_device}):
            for stats in (True, False):
                extra = {"stats_only": stats, "final_obs": not stats}
                got = det.det_rollout(p, tables, num_trajectories=n, **kw, **extra)
                again = det.det_rollout(p, tables, num_trajectories=n, **kw, **extra)
                want = det.det_rollout_plain(p, tables, num_trajectories=n, **kw, **extra)
                torch.cuda.synchronize()
                _assert_bitwise(got, again)
                if stats:
                    _assert_terminal_close(got, want, n)
                else:
                    _assert_streams_close(got, want, n)
    if kind not in ("composite", "all-axes"):
        return
    from mbt_gym_torch import processes as pc
    from mbt_gym_torch.utils.config import composite_env_config

    # the composite config on raw observations (the float32 instantiation),
    # the all-axes one normalised (bf16 products)
    cfg = dataclasses.replace(composite_env_config(num_trajectories=4128, n_steps=run_steps),
                              normalise_observation_space=kind == "all-axes")
    if kind == "all-axes":
        cfg = dataclasses.replace(cfg, dynamics=dataclasses.replace(cfg.dynamics, midprice_model=pc.HestonMidprice()))
    q = mr.rollout_params_from_config(cfg)
    model = init_actor_critic(2, cfg.state_dim, 4, hidden=(64, 64), shared_trunk=False, device=cuda_device)
    for kw in ({"noise": mr.philox_noise(3, run_steps, 4128, cuda_device, 4, True, q.has_mid2)},
               {"seed": 6, "device": cuda_device}):
        got = mr.mlp_rollout(q, model, num_trajectories=4128, **kw)
        again = mr.mlp_rollout(q, model, num_trajectories=4128, **kw)
        want = mr.mlp_rollout_plain(q, model, num_trajectories=4128, **kw)
        torch.cuda.synchronize()
        _assert_bitwise(got, again)
        same = (got[0][:, 1] == want[0][:, 1]).all(dim=0)
        assert int((~same).sum()) <= 4
        for a, b in zip(got, want):
            torch.testing.assert_close(a[..., same], b[..., same], rtol=1e-4, atol=1e-3)


# ------------------------------------------------------------ the compiled entry points
def _engine_case(name, n=2048, steps=50):
    from mbt_gym_torch.agents.baseline import (
        AvellanedaStoikovAgent, CarteaJaimungalMmAgent, CarteaJaimungalOeAgent, fixed_action_policy,
    )
    from mbt_gym_torch.utils.config import cj_env_config, composite_env_config, oe_env_config

    if name == "as":
        cfg = as_env_config(num_trajectories=n, n_steps=steps)
        return cfg, AvellanedaStoikovAgent.from_config(cfg).policy()
    if name == "cj":
        cfg = cj_env_config(num_trajectories=n, n_steps=steps, max_inventory=20.0)
        return cfg, CarteaJaimungalMmAgent.from_config(cfg, max_inventory=20).policy()
    if name == "oe":
        cfg = oe_env_config(num_trajectories=n, n_steps=steps)
        return cfg, CarteaJaimungalOeAgent.from_config(cfg).policy()
    cfg = composite_env_config(num_trajectories=n, n_steps=200)
    return cfg, fixed_action_policy([0.6, 0.6, 0.0, 0.7])


@pytest.mark.parametrize("name", ["as", "cj", "oe", "composite"])
def test_jit_rollout_replays_the_engine_bit_for_bit_on_the_card(cuda_device, name):
    """``jit_rollout(backend="engine")``: the capturing call and a replay are
    ``rollout(backend="engine")`` bit for bit for the same int key (the
    final generator state too), the replay given a policy rebuilt from the
    same values after the first was dropped; another key draws another
    episode."""
    import gc

    from chip_smoke import same_bits
    from mbt_gym_torch import compiled
    from mbt_gym_torch.rollout import jit_rollout, rollout

    cfg, policy = _engine_case(name)
    want = rollout(cfg, policy, None, 7, backend="engine", device=cuda_device)
    try:
        for _ in range(2):
            got = jit_rollout(cfg, _engine_case(name)[1], None, 7, backend="engine", device=cuda_device)
            gc.collect()
            torch.cuda.synchronize()
            assert same_bits(torch, got, want)
        other = jit_rollout(cfg, policy, None, 8, backend="engine", device=cuda_device)
        assert not torch.equal(other.trajectory.rewards, want.trajectory.rewards)
        assert len(compiled.cache_info()) == 1
    finally:
        compiled.clear_cache()


@pytest.mark.parametrize("learner", ["engine", "fused_update-shared", "fused_update-towers", "fully-fused",
                                     "k3-autograd"])
def test_jit_train_iteration_and_chunk_are_eager_bit_for_bit_on_the_card(cuda_device, learner):
    """Two ``jit_train_iteration``s are two eager ``train_iteration``s bit for
    bit (params, Adam state, metrics), with the same kernel launches per
    iteration, and ``jit_train_chunk(3)`` three ``jit_train_iteration``s."""
    _jit_iterations_are_eager(cuda_device, learner, (64, 64))


@pytest.mark.parametrize("learner", ["fused_update-shared", "fused_update-towers", "fully-fused"])
@pytest.mark.parametrize("hidden", [(64,), (36, 100, 20)], ids=["64", "36x100x20"])
def test_jit_train_iteration_is_eager_bit_for_bit_at_other_depths_on_the_card(cuda_device, learner, hidden):
    """The same at a one-layer and a three-layer trunk (its widths padded):
    K4 and K7's deep instantiations, their zero padding and chunked
    scratch replay bitwise inside the capture."""
    _jit_iterations_are_eager(cuda_device, learner, hidden)


def _jit_iterations_are_eager(cuda_device, learner, hidden):
    from chip_smoke import same_bits
    from mbt_gym_torch import compiled
    from mbt_gym_torch.agents import ppo

    env_cfg = dataclasses.replace(as_env_config(num_trajectories=4096, n_steps=32),
                                  normalise_observation_space=True, normalise_action_space=True)
    flags = {
        "engine": dict(shared_trunk=True),
        "fused_update-shared": dict(shared_trunk=True, fused_update=True),
        "fused_update-towers": dict(shared_trunk=False, fused_update=True),
        "fully-fused": dict(shared_trunk=True, fused_update=True, fused_rollout=True, shuffle=False),
        "k3-autograd": dict(shared_trunk=False, fused_rollout=True),
    }[learner]
    cfg = ppo.PPOConfig(hidden=hidden, n_epochs=2, n_minibatches=4, compute_dtype="bfloat16", **flags)
    ts0 = ppo.init_train_state(env_cfg, cfg, 1, device=cuda_device)
    assert all(g["capturable"] for g in ts0.opt_state.param_groups)
    try:
        eager = captured = ts0
        for k in (3, 4):
            _build.reset_launch_counts()
            eager, em = ppo.train_iteration(env_cfg, cfg, eager, k)
            want_counts = dict(_build.launch_counts)
            _build.reset_launch_counts()
            captured, cm = ppo.jit_train_iteration(env_cfg, cfg, captured, k)
            torch.cuda.synchronize()
            if k == 4:  # a replay
                assert dict(_build.launch_counts) == want_counts
            assert same_bits(torch, captured.params, eager.params)
            assert same_bits(torch, captured.opt_state, eager.opt_state)
            assert same_bits(torch, cm, em) and captured.update_count == eager.update_count
        chunk_ts, chunk = ppo.jit_train_chunk(env_cfg, cfg, ts0, 9, 3)
        ts, singles = ts0, []
        for k in ppo.iteration_keys(9, 3):
            ts, m = ppo.jit_train_iteration(env_cfg, cfg, ts, k)
            singles.append(m)
        assert same_bits(torch, chunk_ts.params, ts.params) and same_bits(torch, chunk_ts.opt_state, ts.opt_state)
        assert same_bits(torch, chunk, {k: torch.stack([m[k] for m in singles]) for k in singles[0]})
    finally:
        compiled.clear_cache()


def test_jit_train_epoch_is_eager_bit_for_bit_on_the_card(cuda_device):
    from chip_smoke import same_bits
    from mbt_gym_torch import compiled
    from mbt_gym_torch.agents import reinforce

    env_cfg = as_env_config(num_trajectories=256, n_steps=20)
    rf_cfg = reinforce.ReinforceConfig(hidden=(32, 32), action_std=0.3, learning_rate=1e-2, final_action_std=0.1)
    eager = captured = reinforce.init_train_state(env_cfg, rf_cfg, 0, device=cuda_device)
    try:
        for epoch in range(3):
            eager, em = reinforce.train_epoch(env_cfg, rf_cfg, eager, 5 + epoch, 3)
            captured, cm = reinforce.jit_train_epoch(env_cfg, rf_cfg, captured, 5 + epoch, 3)
            torch.cuda.synchronize()
            assert same_bits(torch, captured.params, eager.params) and same_bits(torch, cm, em)
    finally:
        compiled.clear_cache()


def test_a_capture_holding_a_host_read_raises_on_the_card(cuda_device):
    """A captured region that reads a device value back cannot be captured:
    the call raises, caches nothing and leaves the launch counters as they
    were; nothing falls back to the eager path."""
    from mbt_gym_torch import compiled
    from mbt_gym_torch.rollout import jit_rollout

    def syncing(params, obs, state):
        return obs[:, :2] * float(obs[0, 0] > -1e30)

    before = dict(_build.launch_counts)
    with pytest.raises(RuntimeError):
        jit_rollout(as_env_config(num_trajectories=1024, n_steps=4), syncing, None, 1, backend="engine",
                    device=cuda_device)
    assert compiled.cache_info() == [] and dict(_build.launch_counts) == before
    torch.cuda.synchronize()


@pytest.mark.parametrize("failure", ["host-read", "error-in-capture"])
def test_a_failed_capture_leaves_the_allocator_as_it_was_on_the_card(cuda_device, failure):
    """After a capture that fails, by a host read that invalidates it or by
    an error the captured code raises, the caller's stream is current again
    and the caching allocator releases what is freed later: blocks of 2-5
    GiB allocated on a side stream, used on the current one and freed, and
    others of other sizes, leave no more than 64 MiB above what was
    reserved before once ``empty_cache`` runs; and a capture after it runs
    and releases its pool on ``clear_cache``."""
    from mbt_gym_torch import compiled
    from mbt_gym_torch.rollout import jit_rollout

    def syncing(params, obs, state):
        return obs[:, :2] * float(obs[0, 0] > -1e30)

    def raising(params, obs, state):
        if torch.cuda.is_current_stream_capturing():
            raise ValueError("a policy error inside the capture")
        return torch.ones_like(obs[:, :2])

    def steady(params, obs, state):
        return torch.ones_like(obs[:, :2])

    def released():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved(cuda_device)

    small = as_env_config(num_trajectories=1024, n_steps=4)
    compiled.clear_cache()
    current = torch.cuda.current_stream(cuda_device)
    base = released()
    policy, error = (syncing, RuntimeError) if failure == "host-read" else (raising, ValueError)
    with pytest.raises(error):
        jit_rollout(small, policy, None, 1, backend="engine", device=cuda_device)
    assert compiled.cache_info() == []
    assert torch.cuda.current_stream(cuda_device) == current
    side = torch.cuda.Stream(cuda_device)
    for gib in (4, 3, 5, 2):
        with torch.cuda.stream(side):
            x = torch.empty(gib << 28, device=cuda_device)
        x.record_stream(current)
        x.fill_(1.0)
        del x
        y = torch.empty((gib << 28) + 1, device=cuda_device)
        del y
    assert released() <= base + (64 << 20)
    try:
        jit_rollout(small, steady, None, 2, backend="engine", device=cuda_device)
        assert len(compiled.cache_info()) == 1
    finally:
        compiled.clear_cache()
    assert released() <= base + (64 << 20)
