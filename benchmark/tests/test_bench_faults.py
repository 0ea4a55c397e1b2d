"""A run with its timed path broken underneath reads ``correct`` false.

Each test drives the rest of a run on the CPU at a tiny size (the port's
plain kernel versions standing in for the kernels, the look for a card
skipped) once as it is and once with one fault planted in the program:

- ``frozen``: a step returns its state unchanged (no parameter update; an
  episode that never moves; a rollout whose env never pays);
- ``half_batch``: half of the batch left out, the mean taken over the rest;
- ``altered``: an answer altered where it is produced (one env's rewards,
  one path's terminal cash).

The exchange between chips is not a fault these one-chip cells can have.
The cell's own limits hold, and the broken run's number reads at least
three times the sound one's."""
import pytest
import torch

from benchmark import harness

TINY = {"as_ppo_fused": 64, "canon_ppo_towers": 64, "as_mc_stats": 256, "canon_eval_k3": 64}


def _plant(monkeypatch, workload: str, fault: str) -> None:
    from mbt_gym_torch.agents import ppo
    from mbt_gym_torch.ops import episode, fused_ppo, mlp_rollout

    if workload in ("as_ppo_fused", "canon_ppo_towers"):
        if fault == "frozen":
            monkeypatch.setattr(ppo, "apply_gradients", lambda *args, **kwargs: None)
        elif fault == "half_batch":
            real = fused_ppo.ppo_fused_grads_T

            def half(params, obs_t, actions_t, old, adv, ret, **kw):
                h = obs_t.shape[-1] // 2
                return real(params, obs_t[..., :h], actions_t[..., :h], old[..., :h], adv[..., :h], ret[..., :h],
                            **kw)

            monkeypatch.setattr(fused_ppo, "ppo_fused_grads_T", half)
        else:
            real = mlp_rollout.rollout_fused_T

            def altered(*args, **kwargs):
                out = real(*args, **kwargs)
                out[4][:, 0] += 1.0
                return out

            monkeypatch.setattr(mlp_rollout, "rollout_fused_T", altered)
    elif workload == "as_mc_stats":
        real = episode.as_episode

        def broken(params, seed=0, num_trajectories=16384, noise=None, device=None):
            if fault == "frozen":
                n = num_trajectories
                return tuple(torch.full((n,), v, dtype=torch.float32) for v in
                             (params.initial_cash, params.initial_inventory, params.initial_price))
            if fault == "half_batch":
                return real(params, seed, num_trajectories // 2, noise, device)
            cash, inv, price = real(params, seed, num_trajectories, noise, device)
            cash = cash.clone()
            cash[0] += 100.0
            return cash, inv, price

        monkeypatch.setattr(episode, "as_episode", broken)
    else:
        real = mlp_rollout.collect_rollout_fused_T

        def broken(*args, **kwargs):
            tb = real(*args, **kwargs)
            rewards = tb.rewards.clone()
            if fault == "frozen":
                rewards.zero_()
            elif fault == "half_batch":
                rewards = rewards[:, : rewards.shape[1] // 2]
            else:
                rewards[:, 0] += 1.0
            return tb._replace(rewards=rewards)

        monkeypatch.setattr(mlp_rollout, "collect_rollout_fused_T", broken)


def _run(workload: str) -> dict:
    return harness.run_cell(workload, 20231, 0.3, False, device="cpu", overrides={"envs": TINY[workload]})


@pytest.mark.parametrize("fault", ["frozen", "half_batch", "altered"])
@pytest.mark.parametrize("workload", list(TINY))
def test_a_broken_timed_path_reads_incorrect(workload, fault, monkeypatch, cpu_kernels):
    torch.set_num_threads(4)
    sound = _run(workload)["checked"]
    with monkeypatch.context() as m:
        _plant(m, workload, fault)
        broken = _run(workload)
    assert broken["correct"] is False
    worst = max(broken["checked"], key=lambda k: broken["checked"][k]["value"] / broken["checked"][k]["limit"])
    assert broken["checked"][worst]["value"] > broken["checked"][worst]["limit"]
    assert broken["checked"][worst]["value"] >= 3 * sound[worst]["value"]
