"""The plain reference against the port's plain versions of its kernels,
at tiny sizes on the CPU: the same inputs give the same paths and
numbers, to rounding."""
import json
from pathlib import Path

import pytest
import torch

from benchmark import loops
from benchmark.reference import as_closed_form, market_making as mm
from benchmark.yardstick import weights as weights_lib

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def _config(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def _model(cfg, w):
    from mbt_gym_torch.agents import networks

    env = mm.env_from_config(cfg)
    model = networks.ActorCritic(env.s_dim, env.a_dim, tuple(cfg["policy"]["hidden"]), cfg["policy"]["shared_trunk"],
                                 device="cpu")
    with torch.no_grad():
        model.load_state_dict(w)
    return model


@pytest.mark.parametrize("name", ["as_mm", "cj_canonical"])
def test_rollout_is_the_port_plain_k3(name):
    from mbt_gym_torch.ops import mlp_rollout

    cfg = _config(name)
    env = mm.env_from_config(cfg)
    w = weights_lib.actor_critic(3, env.s_dim, env.a_dim, cfg["policy"], "cpu", head_std=0.3)
    n, key = 96, 424242
    port = mlp_rollout.rollout_fused_T(loops.program_env(cfg, n), _model(cfg, w), key, device="cpu")
    ref = mm.rollout(env, w, mm.key_generator(env, key, "cpu"), n, mm.bf16, "cpu")
    for got, want in zip(port, ref):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert torch.equal(port[4], ref.rewards) and torch.equal(port[0][:, 1], ref.obs[:, 1])  # fills, inventories


@pytest.mark.parametrize("name", ["as_mm", "cj_canonical"])
def test_ppo_gradient_is_the_port_plain_k4(name):
    from mbt_gym_torch.ops import fused_ppo

    cfg = _config(name)
    env = mm.env_from_config(cfg)
    w = weights_lib.actor_critic(5, env.s_dim, env.a_dim, cfg["policy"], "cpu", head_std=0.3)
    n, key = 64, 77
    ro = mm.rollout(env, w, mm.key_generator(env, key, "cpu"), n, mm.bf16, "cpu")
    adv, ret = mm.gae(ro.rewards, ro.values, 1.0, 0.95)
    adv = mm.normalise(adv)
    port_g, port_m = fused_ppo.ppo_fused_grads_T(_model(cfg, w), ro.obs, ro.actions, ro.log_probs, adv, ret,
                                                 clip_eps=0.2, vf_coef=0.5, compute_dtype="bfloat16")
    m = n * env.n_steps
    x = ro.obs.permute(1, 0, 2).reshape(env.s_dim, m)
    act = ro.actions.permute(1, 0, 2).reshape(env.a_dim, m)
    ref_g, ref_m = mm.ppo_grads(w, x, act, ro.log_probs.reshape(m), adv.reshape(m), ret.reshape(m), 0.2, 0.5, mm.bf16)
    assert set(port_g) == set(ref_g)
    for k in ref_g:
        torch.testing.assert_close(port_g[k], ref_g[k], rtol=1e-4, atol=1e-7, msg=k)
    for k in ("pg_loss", "vf_loss", "approx_kl"):
        torch.testing.assert_close(port_m[k], ref_m[k], rtol=1e-4, atol=1e-7)


def test_mc_stats_are_the_port_plain_k1():
    from mbt_gym_torch.ops.episode import as_mc_episode_stats

    cfg = _config("as_mm")
    env = mm.env_from_config(cfg)
    n, key = 512, 99
    for gamma in (0.01, 0.1, 0.5):
        port = as_mc_episode_stats(loops.program_env(cfg, n, raw_spaces=True), gamma, key, episodes=2, device="cpu")
        ref = as_closed_form.mc_stats(env, gamma, key, n, 2, "cpu")
        for k, v in ref.items():  # the port's standard deviations come from float32 moments
            assert float(port[k]) == pytest.approx(v, rel=1e-4, abs=1e-5), k


def test_evaluation_is_the_port_plain_k3():
    from mbt_gym_torch.agents import ppo

    cfg = _config("cj_canonical")
    env = mm.env_from_config(cfg)
    ev = cfg["evaluated_policy"]
    w = weights_lib.actor_critic(9, env.s_dim, env.a_dim, cfg["policy"], "cpu", head_std=ev["head_std"],
                                 head_bias=ev["head_bias"])
    n, key = 128, 31337
    port = float(ppo.evaluate_policy(loops.program_env(cfg, n), _model(cfg, w), key, n_episodes=3, backend="fused"))
    ref, scale = mm.evaluate(env, w, key, n, mm.bf16, "cpu", episodes=3)
    assert abs(port - ref) <= 1e-5 * scale
