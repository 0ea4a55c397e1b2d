"""mbt_gym_torch.agents.external: host_model_policy and sb3_policy on the
engine rollout against the closed-form AS agent when ``predict`` computes
the same quotes (within 1e-6 in float32), the dispatch reason that sends
them to the engine, and JAX's tests/test_external_torch.py loop — a
PyTorch REINFORCE learner trained through VecTradingEnv — on the port."""
import dataclasses

import numpy as np
import pytest
import torch

from mbt_gym_torch import dispatch_report, rollout
from mbt_gym_torch.agents.baseline import AvellanedaStoikovAgent
from mbt_gym_torch.agents.external import host_model_policy, sb3_policy
from mbt_gym_torch.gym_compat import VecTradingEnv
from mbt_gym_torch.utils.config import as_env_config

CPU = "cpu"


def as_predict(agent):
    """The AS closed form on host numpy float32 (BaselineAgents.py:52-83)."""
    gamma, sigma, k, big_t = agent.risk_aversion, agent.volatility, agent.fill_exponent, agent.terminal_time
    half_log = float((2.0 / gamma) * np.log(1 + gamma / k))

    def predict(obs):
        q, t = obs[:, 1], obs[:, 2]
        skew = q * gamma * sigma**2 * (big_t - t)
        spread = gamma * sigma**2 * (big_t - t) + half_log
        return np.stack([skew + spread / 2, -skew + spread / 2], axis=1)

    return predict


class _Model:
    """Duck-typed SB3 model: ``predict(obs, deterministic)`` ->
    (actions, state), with an ``action_space``."""

    class action_space:
        shape = (2,)

    def __init__(self, predict):
        self._predict = predict
        self.calls = []

    def predict(self, obs, deterministic=False):
        self.calls.append((obs.shape, deterministic))
        return self._predict(obs), None


@pytest.mark.parametrize("wrap", ["host_model_policy", "sb3_policy"])
def test_host_policies_match_the_closed_form_agent(wrap):
    cfg = as_env_config(num_trajectories=256, n_steps=50)
    agent = AvellanedaStoikovAgent.from_config(cfg, risk_aversion=0.1)
    if wrap == "host_model_policy":
        policy = host_model_policy(as_predict(agent), 2)
    else:
        model = _Model(as_predict(agent))
        policy = sb3_policy(model)
    want = rollout(cfg, agent.policy(), None, 5, backend="engine", device=CPU).trajectory
    got = rollout(cfg, policy, None, 5, backend="auto", device=CPU).trajectory
    for name, a, b in zip(want._fields, want, got):
        assert b.dtype == torch.float32 and b.device.type == "cpu"
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-6, msg=name)
    if wrap == "sb3_policy":
        assert model.calls[0] == ((256, 4), True) and len(model.calls) == 50


def test_reduced_obs_indices_and_dispatch_reason():
    """The host model sees only the selected columns; the policy carries no
    dispatch metadata, so auto runs the engine and says so."""
    seen = []

    def predict(obs):
        seen.append(obs.shape)
        return np.ones((obs.shape[0], 2), np.float32)

    policy = host_model_policy(predict, 2, reduced_obs_indices=(1, 2))
    obs = torch.zeros(8, 4, dtype=torch.float64)
    out = policy(None, obs, None)
    assert seen == [(8, 2)] and out.dtype == torch.float64 and out.shape == (8, 2)
    cfg = as_env_config(num_trajectories=128)
    decision = dispatch_report(cfg, policy, mode="rollout", platform="cuda")
    assert decision.backend == "engine"
    assert decision.reason.startswith("policy carries no dispatch metadata")


def test_torch_reinforce_trains_through_vecenv():
    """tests/test_external_torch.py on the port: numpy observations in,
    numpy actions out, autoreset infos, and the gradient step moves a
    PyTorch policy."""
    n_envs, n_steps = 64, 10
    cfg = dataclasses.replace(as_env_config(num_trajectories=n_envs, n_steps=n_steps),
                              normalise_observation_space=True, normalise_action_space=True)
    env = VecTradingEnv(cfg, seed=0, device=CPU)
    torch.manual_seed(0)
    policy = torch.nn.Sequential(torch.nn.Linear(cfg.state_dim, 32), torch.nn.Tanh(),
                                 torch.nn.Linear(32, cfg.action_dim))
    log_std = torch.nn.Parameter(torch.full((cfg.action_dim,), -0.5))
    opt = torch.optim.Adam(list(policy.parameters()) + [log_std], lr=3e-3)
    before = [p.detach().clone() for p in policy.parameters()]

    def run_episode():
        obs = env.reset()
        log_probs, rewards = [], []
        for _ in range(n_steps):
            mean = policy(torch.as_tensor(obs, dtype=torch.float32))
            dist = torch.distributions.Normal(mean, log_std.exp())
            action = dist.sample()
            log_probs.append(dist.log_prob(action).sum(-1))
            obs, reward, dones, infos = env.step(action.clamp(-1, 1).numpy())
            rewards.append(torch.as_tensor(np.asarray(reward), dtype=torch.float32))
        assert dones.all() and all("terminal_observation" in i for i in infos)
        return torch.stack(log_probs), torch.stack(rewards)

    losses = []
    for _ in range(3):
        log_probs, rewards = run_episode()
        future = torch.flip(torch.cumsum(torch.flip(rewards, [0]), 0), [0])
        loss = -(log_probs * future.detach()).mean()
        opt.zero_grad()
        loss.backward()
        grad_norm = sum(float(p.grad.norm()) for p in policy.parameters() if p.grad is not None)
        assert np.isfinite(grad_norm) and grad_norm > 0
        opt.step()
        losses.append(float(loss.detach()))
    assert all(np.isfinite(v) for v in losses)
    assert any(not torch.equal(a, b) for a, b in zip(before, policy.parameters()))
