"""The learning gates of tests/test_convergence.py, ported: the port's PPO
(engine and fully fused paths) and REINFORCE must learn on the CPU under
their own RNG, to the JAX gates' bars on the same configurations.

On the CPU the fused path runs K3's and K4's plain versions (the tensors
lie on the CPU), K3 with the CjMm reward; the CUDA kernels are held to the
same bar on the card by chip_smoke.py phase 22."""
import dataclasses

import numpy as np
import pytest
import torch

from mbt_gym_torch.agents import ppo, reinforce
from mbt_gym_torch.agents.baseline import CarteaJaimungalMmAgent
from mbt_gym_torch.ops import mlp_rollout as mr
from mbt_gym_torch.rollout import rollout
from mbt_gym_torch.utils.config import as_env_config, cj_env_config


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    """The gates step batches of a few hundred envs, too small to gain from
    intra-op threads; one thread each keeps a test worker from
    oversubscribing the CPU beside the others (restored after)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cj_ci_env():
    """tests/test_convergence.py:33-37: the CJ CI env (256 envs x 50 steps,
    arrival rate 10, phi 0.5, alpha 0.001, q_max 10), raw and normalised."""
    raw = cj_env_config(
        num_trajectories=256, n_steps=50, arrival_rate=10.0,
        per_step_inventory_aversion=0.5, terminal_inventory_aversion=0.001,
        max_inventory=10.0,
    )
    return raw, dataclasses.replace(raw, normalise_observation_space=True, normalise_action_space=True)


def _best_reward(env_cfg, ppo_cfg, init_seed, keys, noise_rng=None):
    ts = ppo.init_train_state(env_cfg, ppo_cfg, init_seed, device="cpu")
    best = -np.inf
    for key in keys:
        noise = None
        if noise_rng is not None:  # the fused rollout's (T, 7, N) channels
            shape = (env_cfg.n_steps, mr.N_CHANNELS, env_cfg.num_trajectories)
            noise = noise_rng.uniform(size=shape).astype(np.float32)
            noise[:, 4:] = noise_rng.normal(size=(shape[0], shape[1] - 4, shape[2])).astype(np.float32)
            noise = torch.from_numpy(noise)
        ts, m = ppo.train_iteration(env_cfg, ppo_cfg, ts, key, noise=noise)
        best = max(best, float(m["mean_episode_reward"]))
    return best


def test_ppo_learns_at_all_ci_gate():
    """tests/test_convergence.py:22-56: 60 engine iterations of the shared
    trunk (64x64, 4 epochs x 4 contiguous minibatches) must reach more than
    0.35 x the closed-form CJ agent's mean episode reward."""
    raw, env_cfg = _cj_ci_env()
    cj = CarteaJaimungalMmAgent.from_config(raw, max_inventory=10)
    cf = float(rollout(raw, cj.policy(), None, 1, device="cpu").trajectory.rewards.sum(dim=0).mean())
    assert cf > 0
    ppo_cfg = ppo.PPOConfig(hidden=(64, 64), n_epochs=4, n_minibatches=4, shuffle=False,
                            shared_trunk=True, learning_rate=1e-3)
    best = _best_reward(env_cfg, ppo_cfg, 0, range(60))
    assert best > 0.35 * cf, (best, cf)


def test_fused_simplifications_inside_shuffled_xla_band():
    """tests/test_convergence.py:59-132: the fully fused path (shared
    trunk, contiguous env-slice minibatches, K3 with the CjMm reward and K4
    on injected noise, float32 update) must land inside the band of the
    engine's separate pi/vf towers with shuffled minibatches over 3 seeds,
    at the same 60-iteration budget: fused best >= min(engine bests) - 0.35."""
    _, env_cfg = _cj_ci_env()
    engine_cfg = ppo.PPOConfig(hidden=(64, 64), n_epochs=4, n_minibatches=4, shuffle=True,
                               shared_trunk=False, learning_rate=1e-3)
    engine_bests = [_best_reward(env_cfg, engine_cfg, seed, [1000 * seed + i for i in range(60)])
                    for seed in (0, 1, 2)]
    fused_cfg = ppo.PPOConfig(hidden=(64, 64), n_epochs=4, n_minibatches=4, shuffle=False,
                              shared_trunk=True, learning_rate=1e-3, fused_rollout=True, fused_update=True,
                              fused_compute_dtype="float32")
    assert mr.rollout_params_from_config(env_cfg).reward_kind == "cjmm"
    fused_best = _best_reward(env_cfg, fused_cfg, 0, [1000 + i for i in range(60)],
                              noise_rng=np.random.default_rng(7))
    assert fused_best >= min(engine_bests) - 0.35, (fused_best, engine_bests)


def test_reinforce_learns_ci_gate():
    """tests/test_convergence.py:135-176: on the normalised AS env (256 x
    20), 100 REINFORCE epochs must raise the mean episode reward (last 10
    over first 10 by more than 0.3) and beat the uniform-random policy by
    more than 1.0."""
    raw = as_env_config(num_trajectories=256, n_steps=20)
    env_cfg = dataclasses.replace(raw, normalise_observation_space=True, normalise_action_space=True)
    gen = torch.Generator().manual_seed(123)

    def random_policy(p, obs, state):
        return torch.rand((obs.shape[0], env_cfg.action_dim), generator=gen, dtype=obs.dtype) * 2.0 - 1.0

    rand = float(rollout(env_cfg, random_policy, None, 5, device="cpu").trajectory.rewards.sum(dim=0).mean())
    rf_cfg = reinforce.ReinforceConfig(hidden=(32, 32), action_std=0.3, learning_rate=1e-2, lr_decay=0.999)
    ts = reinforce.init_train_state(env_cfg, rf_cfg, 0, device="cpu")
    hist = []
    for i in range(100):
        ts, m = reinforce.train_epoch(env_cfg, rf_cfg, ts, i, 100)
        hist.append(float(m["mean_episode_reward"]))
    first10, last10 = float(np.mean(hist[:10])), float(np.mean(hist[-10:]))
    assert last10 > first10 + 0.3, (first10, last10)
    assert last10 > rand + 1.0, (last10, rand)
