"""The compiled entry points of mbt_gym_torch (``jit_rollout``,
``jit_train_iteration``, ``jit_train_chunk``, ``jit_train_epoch``) and
``networks.sample_action`` against the JAX package: JAX's parameter names,
bit-for-bit equality with the eager functions on the CPU (where the
``jit_*`` run them), the AS moments of ``jit_rollout`` against JAX's, and
the capture-safety guard.  The guard runs a warm second call of each
region a CUDA graph captures (the policy, ``env.step`` and the PPO update;
the engine episode; the REINFORCE epoch) under a
``torch.overrides.TorchFunctionMode`` that counts what a capture cannot
hold: a host value copied to the device (``torch.tensor`` or
``torch.as_tensor`` of non-tensor data) and a device value read back
(``item``, ``tolist``, ``__bool__``, ``__float__``, ``__int__``), for every
dynamics family and every process kind, so the captured region stays
capture-safe on a machine without a card."""
import dataclasses
import inspect
import os
import traceback

import jax
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import mbt_gym_tpu
from mbt_gym_tpu.agents import baseline as jax_baseline
from mbt_gym_tpu.agents import networks as jnet
from mbt_gym_tpu.agents import ppo as jppo
from mbt_gym_tpu.agents import reinforce as jrf
from mbt_gym_tpu.utils import config as jax_config

import mbt_gym_torch
from mbt_gym_torch import compiled, convert
from mbt_gym_torch.agents import baseline, networks, ppo, reinforce
from mbt_gym_torch.rollout import episode_stats, jit_rollout, rollout
from mbt_gym_torch.utils import config
from tests.test_torch_composite import K3_CASES
from tests.test_torch_env import torch_config
from tests.test_torch_speed import IMPACTS


# ------------------------------------------------------------ signatures
@pytest.mark.parametrize("port, jax_fn", [
    (jit_rollout, mbt_gym_tpu.jit_rollout),
    (ppo.jit_train_iteration, jppo.jit_train_iteration),
    (ppo.jit_train_chunk, jppo.jit_train_chunk),
    (reinforce.jit_train_epoch, jrf.jit_train_epoch),
    (networks.sample_action, jnet.sample_action),
], ids=["jit_rollout", "jit_train_iteration", "jit_train_chunk", "jit_train_epoch", "sample_action"])
def test_entry_points_take_jaxs_parameter_names(port, jax_fn):
    """JAX's parameters, in order and with JAX's defaults; anything the port
    adds (``jit_rollout``'s ``backend`` and ``device``) is keyword-only."""
    want = inspect.signature(getattr(jax_fn, "__wrapped__", jax_fn)).parameters
    got = inspect.signature(port).parameters
    assert list(got)[:len(want)] == list(want)
    for name, p in want.items():
        assert got[name].default == p.default, name
    assert all(p.kind is inspect.Parameter.KEYWORD_ONLY for p in list(got.values())[len(want):])


def test_jit_rollout_is_exported():
    assert mbt_gym_torch.jit_rollout is jit_rollout and "jit_rollout" in mbt_gym_torch.__all__


# ------------------------------------------------------------ eager bits on the CPU
def _assert_same(a, b):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b) or (a.isnan() == b.isnan()).all() and torch.equal(a.nan_to_num(), b.nan_to_num())
    elif isinstance(a, torch.Generator):
        assert torch.equal(a.get_state(), b.get_state())
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, torch.nn.Module):
        _assert_same(a.state_dict(), b.state_dict())
    else:
        assert a == b


def _rollout_case(name):
    if name == "as":
        cfg = config.as_env_config(num_trajectories=64, n_steps=20)
        return cfg, baseline.AvellanedaStoikovAgent.from_config(cfg).policy()
    if name == "cj":
        cfg = config.cj_env_config(num_trajectories=64, n_steps=20)
        return cfg, baseline.CarteaJaimungalMmAgent.from_config(cfg, max_inventory=10).policy()
    if name == "oe":
        cfg = config.oe_env_config(num_trajectories=64, n_steps=20)
        return cfg, baseline.CarteaJaimungalOeAgent.from_config(cfg).policy()
    cfg = config.composite_env_config(num_trajectories=64, n_steps=200)
    return cfg, baseline.fixed_action_policy([0.6, 0.6, 0.0, 0.7])


@pytest.mark.parametrize("backend", ["auto", "engine"])
@pytest.mark.parametrize("name", ["as", "cj", "oe", "composite"])
def test_jit_rollout_is_rollout_on_the_cpu(name, backend):
    cfg, policy = _rollout_case(name)
    got = jit_rollout(cfg, policy, None, 5, backend=backend, device="cpu")
    want = rollout(cfg, policy, None, 5, backend=backend, device="cpu")
    _assert_same(got, want)


def _ppo_case(fused=False):
    env_cfg = config.as_env_config(num_trajectories=64, n_steps=8)
    env_cfg = dataclasses.replace(env_cfg, normalise_observation_space=True, normalise_action_space=True)
    ppo_cfg = ppo.PPOConfig(hidden=(16, 16), n_epochs=2, n_minibatches=2, shared_trunk=fused,
                            fused_update=fused, fused_rollout=fused, shuffle=not fused)
    return env_cfg, ppo_cfg, ppo.init_train_state(env_cfg, ppo_cfg, 0, device="cpu")


@pytest.mark.parametrize("fused", [False, True], ids=["engine", "fully-fused"])
def test_jit_train_iteration_and_chunk_are_eager_on_the_cpu(fused):
    env_cfg, ppo_cfg, ts = _ppo_case(fused)
    before = [p.detach().clone() for p in ts.params.parameters()]
    got_ts, got = ppo.jit_train_iteration(env_cfg, ppo_cfg, ts, 3)
    want_ts, want = ppo.train_iteration(env_cfg, ppo_cfg, ts, 3)
    _assert_same(got, want)
    _assert_same(got_ts.params, want_ts.params)
    assert got_ts.update_count == want_ts.update_count == 1
    _assert_same(list(ts.params.parameters()), before)  # the state given is untouched
    got_ts, got = ppo.jit_train_chunk(env_cfg, ppo_cfg, ts, 4, 3)
    want_ts, want = ppo.train_chunk(env_cfg, ppo_cfg, ts, 4, 3)
    _assert_same(got, want)
    _assert_same(got_ts.params, want_ts.params)
    assert all(v.shape == (3,) for v in got.values())


def test_jit_train_epoch_is_eager_on_the_cpu():
    env_cfg = config.as_env_config(num_trajectories=64, n_steps=10)
    rf_cfg = reinforce.ReinforceConfig(hidden=(16, 16), action_std=0.3, learning_rate=1e-2,
                                       final_action_std=0.1)
    state = reinforce.init_train_state(env_cfg, rf_cfg, 0, device="cpu")
    for epoch in range(2):
        got_state, got = reinforce.jit_train_epoch(env_cfg, rf_cfg, state, 11 + epoch, 5)
        want_state, want = reinforce.train_epoch(env_cfg, rf_cfg, state, 11 + epoch, 5)
        _assert_same(got, want)
        _assert_same(got_state.params, want_state.params)
        assert got_state.epoch == want_state.epoch == epoch + 1
        assert got_state.opt_state.param_groups[0]["lr"] == want_state.opt_state.param_groups[0]["lr"]
        state = got_state


@pytest.mark.parametrize("call", ["jit_rollout", "jit_train_iteration", "jit_train_chunk", "jit_train_epoch"])
def test_a_generator_key_raises_naming_the_int_form(call):
    gen = torch.Generator().manual_seed(0)
    cfg, policy = _rollout_case("as")
    env_cfg, ppo_cfg, ts = _ppo_case()
    rf_cfg = reinforce.ReinforceConfig(hidden=(8,))
    calls = {
        "jit_rollout": lambda: jit_rollout(cfg, policy, None, gen, device="cpu"),
        "jit_train_iteration": lambda: ppo.jit_train_iteration(env_cfg, ppo_cfg, ts, gen),
        "jit_train_chunk": lambda: ppo.jit_train_chunk(env_cfg, ppo_cfg, ts, gen, 2),
        "jit_train_epoch": lambda: reinforce.jit_train_epoch(
            cfg, rf_cfg, reinforce.init_train_state(cfg, rf_cfg, 0, device="cpu"), gen),
    }
    with pytest.raises(TypeError, match="int seed"):
        calls[call]()


def test_jit_rollout_as_moments_match_jax():
    """The AS agent at 4,096 x 50 through both packages' ``jit_rollout``,
    each on its own RNG: mean PnL and mean terminal inventory within 4
    standard errors, the spread (a function of time alone) to float32."""
    n, steps = 4096, 50
    jcfg = jax_config.as_env_config(num_trajectories=n, n_steps=steps)
    jres = mbt_gym_tpu.jit_rollout(jcfg, jax_baseline.AvellanedaStoikovAgent.from_config(jcfg).policy(), None,
                                   jax.random.PRNGKey(3))
    want_pnl = np.asarray(jres.trajectory.rewards).sum(axis=0)
    want_inv = np.asarray(jres.trajectory.observations)[-1, :, 1]
    cfg = torch_config(jcfg)
    res = jit_rollout(cfg, baseline.AvellanedaStoikovAgent.from_config(cfg).policy(), None, 3, device="cpu")
    got_pnl = res.trajectory.rewards.sum(dim=0).numpy()
    got_inv = res.trajectory.observations[-1, :, 1].numpy()
    for got, want in ((got_pnl, want_pnl), (got_inv, want_inv)):
        se = np.sqrt(got.var() / n + want.var() / n)
        assert abs(got.mean() - want.mean()) < 4 * se
    jstats = mbt_gym_tpu.episode_stats(jcfg, jres.trajectory)
    np.testing.assert_allclose(float(episode_stats(cfg, res.trajectory)["mean_spread"]),
                               float(jstats["mean_spread"]), rtol=1e-5)


# ------------------------------------------------------------ sample_action
def test_sample_action_log_prob_and_moments_match_jax():
    """``sample_action``'s log-prob is ``gaussian_log_prob`` of the action it
    returns; over 65,536 draws at one observation its per-column mean and
    std agree with JAX's within 4 standard errors."""
    n = 65_536
    jparams = jnet.init_actor_critic(jax.random.PRNGKey(1), 4, 2, hidden=(16, 16))
    model = convert.actor_critic_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    with torch.no_grad():
        model.log_std.copy_(torch.tensor([-0.5, 0.2]))
    jparams = {**jparams, "log_std": jax.numpy.asarray([-0.5, 0.2], dtype=jax.numpy.float32)}
    obs = np.tile(np.asarray([[0.1, -0.3, 0.5, 0.2]], dtype=np.float32), (n, 1))
    with torch.no_grad():
        action, log_prob = networks.sample_action(model, torch.from_numpy(obs), 7)
        again, _ = networks.sample_action(model, torch.from_numpy(obs), 7)
        torch.testing.assert_close(log_prob, networks.gaussian_log_prob(model, networks.policy_mean(model, torch.from_numpy(obs)), action), rtol=0, atol=0)
    assert torch.equal(action, again)
    jaction, jlog_prob = jnet.sample_action(jparams, jax.numpy.asarray(obs), jax.random.PRNGKey(7))
    jaction = np.asarray(jaction)
    got = action.numpy()
    std = np.exp([-0.5, 0.2])
    for col in range(2):
        se_mean = std[col] / np.sqrt(n)
        assert abs(got[:, col].mean() - jaction[:, col].mean()) < 4 * np.sqrt(2) * se_mean
        se_std = std[col] / np.sqrt(2 * n)
        assert abs(got[:, col].std() - jaction[:, col].std()) < 4 * np.sqrt(2) * se_std
    np.testing.assert_allclose(np.asarray(jlog_prob).mean(), log_prob.numpy().mean(), rtol=0, atol=0.05)


# ------------------------------------------------------------ capture safety
class HostTraffic(TorchFunctionMode):
    """Counts the calls a CUDA-graph capture cannot hold: a host value
    copied to the device and a device value read back.  Reads inside
    ``torch.optim`` are not counted: on the CPU, Adam keeps its step count
    as a host scalar and reads it; on the card ``ppo.make_optimizer`` builds
    it with ``capturable=True``, which keeps the count on the device and
    reads nothing back (the captured iteration on the card shows it)."""

    READS = ("item", "tolist", "__bool__", "__float__", "__int__")

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if func in (torch.tensor, torch.as_tensor):
            data = args[0] if args else kwargs.get("data")
            if not isinstance(data, torch.Tensor):
                self.seen.append(f"torch.{name}({type(data).__name__})")
        elif name in self.READS and not any(f"torch{os.sep}optim{os.sep}" in frame.filename
                                              for frame in traceback.extract_stack()):
            self.seen.append(f"Tensor.{name}")
        return func(*args, **kwargs)


def _guard(fn):
    fn()  # the warm first call builds the cached device constants
    with HostTraffic() as traffic:
        fn()
    return traffic.seen


_N, _T = 128, 12
GUARD_CASES = {
    **{name: make for name, (make, _) in K3_CASES.items()},
    **{f"speed-{name}": (lambda m=m: dataclasses.replace(jax_config.oe_env_config(num_trajectories=_N, n_steps=_T),
                                                       dynamics=dataclasses.replace(
                                                           jax_config.oe_env_config().dynamics,
                                                           price_impact_model=m)))
       for name, m in IMPACTS.items()},
    "speed-permanent": lambda: jax_config.oe_env_config(num_trajectories=_N, n_steps=_T),
    "limit-plain": lambda: jax_config.as_env_config(num_trajectories=_N, n_steps=_T),
    "lam-canonical": lambda: dataclasses.replace(jax_config.learning_env_config(num_trajectories=_N), n_steps=_T),
    "touch-plain": lambda: jax_config.touch_env_config(num_trajectories=_N, n_steps=_T),
}


@pytest.mark.parametrize("name", list(GUARD_CASES))
def test_captured_regions_copy_nothing_from_and_read_nothing_back_to_the_host(name):
    """For every dynamics family and process kind: a warm PPO iteration's
    captured region (the engine rollout, the policy and ``env.step`` each
    step, GAE, the shuffle and the autograd update; ``_iteration_update``)
    and a warm engine episode of the trained policy's mean
    (``rollout(backend="engine")``, reset included) make no host traffic."""
    cfg = torch_config(GUARD_CASES[name]())
    cfg = dataclasses.replace(cfg, num_trajectories=_N)
    ppo_cfg = ppo.PPOConfig(hidden=(16, 16), n_epochs=1, n_minibatches=2)
    ts = ppo.init_train_state(cfg, ppo_cfg, 0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    assert _guard(lambda: ppo._iteration_update(cfg, ppo_cfg, ts, gen, gen, None)) == []
    policy = ppo.deterministic_policy(cfg)
    assert _guard(lambda: rollout(cfg, policy, ts.params, gen, backend="engine", device="cpu")) == []


@pytest.mark.parametrize("name", ["as", "cj", "oe", "composite"])
def test_closed_form_and_fixed_episodes_are_capture_safe(name):
    cfg, policy = _rollout_case(name)
    gen = torch.Generator().manual_seed(0)
    assert _guard(lambda: rollout(cfg, policy, None, gen, backend="engine", device="cpu")) == []


def test_reinforce_epoch_is_capture_safe():
    env_cfg = config.as_env_config(num_trajectories=64, n_steps=10)
    rf_cfg = reinforce.ReinforceConfig(hidden=(16, 16))
    state = reinforce.init_train_state(env_cfg, rf_cfg, 0, device="cpu")
    std, lr = torch.full((), 0.3), torch.full((), 1e-2)
    gen = torch.Generator().manual_seed(0)
    assert _guard(lambda: reinforce._epoch_update(state.params, env_cfg, std, lr, gen)) == []


def test_the_guard_sees_host_traffic():
    """The guard is not blind: a host copy and a read back are counted."""
    x = torch.ones(3)
    seen = _guard(lambda: (torch.tensor([1.0, 2.0]), float(x.sum()), x.tolist(), bool(x[0] > 0)))
    assert seen == ["torch.tensor(list)", "Tensor.__float__", "Tensor.tolist", "Tensor.__bool__"]


def test_cache_is_empty_on_the_cpu():
    env_cfg, ppo_cfg, ts = _ppo_case()
    compiled.clear_cache()
    ppo.jit_train_iteration(env_cfg, ppo_cfg, ts, 0)
    assert compiled.cache_info() == []


def test_k3_writes_into_the_buffers_it_is_given():
    """``rollout_fused_T(..., out=)``, the K3 launch a captured iteration
    makes before each replay, writes its five outputs into the buffers
    given, the values of a call without them; buffers of another shape
    are refused."""
    from mbt_gym_torch.ops import mlp_rollout as mr

    env_cfg, _, ts = _ppo_case()
    want = mr.rollout_fused_T(env_cfg, ts.params, 3, device="cpu")
    out = tuple(torch.full_like(x, float("nan")) for x in want)
    got = mr.rollout_fused_T(env_cfg, ts.params, 3, device="cpu", out=out)
    assert all(g is o for g, o in zip(got, out))
    _assert_same(got, want)
    with pytest.raises(ValueError, match="out must be"):
        mr.rollout_fused_T(env_cfg, ts.params, 3, device="cpu", out=out[:4] + (out[4][:-1],))


def test_tagged_policies_rebuilt_from_the_same_values_share_a_cache_key():
    """``jit_rollout`` keys a tagged policy by its dispatch tag, so a policy
    rebuilt from the same action or agent (``with_normalised_rewards``
    builds its fixed policy anew on every call) replays the graph captured
    for the first; other values, and untagged callables, key apart."""
    from mbt_gym_torch.utils import reward_scaling

    cfg = config.as_env_config(num_trajectories=64, n_steps=5)
    agent = baseline.AvellanedaStoikovAgent.from_config(cfg)
    key = compiled.policy_key
    assert key(agent.policy()) == key(agent.policy())
    assert key(baseline.fixed_action_policy([0.5, 0.5])) == key(baseline.fixed_action_policy([0.5, 0.5]))
    assert key(baseline.fixed_action_policy([0.5, 0.5])) != key(baseline.fixed_action_policy([0.5, 0.6]))
    assert key(agent.policy()) != key(baseline.AvellanedaStoikovAgent.from_config(cfg, risk_aversion=0.5).policy())
    assert key(reward_scaling.inventory_neutral_simulation(cfg)[1]) == key(
        reward_scaling.inventory_neutral_simulation(cfg)[1])

    def untagged(params, obs, state):
        return obs[:, :2]

    assert key(untagged) is untagged


def test_device_constants_are_never_evicted():
    """A captured graph reads the engine's constants by address, so their
    cache keeps every one."""
    from mbt_gym_torch import types

    assert types._device_constant.cache_info().maxsize is None
    first = types.device_constant((0.25, 0.5), torch.float32)
    assert types.device_constant((0.25, 0.5), torch.float32) is first


def test_reinforce_rate_follows_the_epoch_without_a_schedule_step():
    """REINFORCE's rate is computed from the epoch, ``lr * decay**epoch``
    (optax's ``exponential_decay`` within rtol 1e-6); the returned state's
    SGD and schedule read that rate, and no schedule is stepped (PyTorch's
    step-order warning never fires)."""
    import optax
    import warnings

    env_cfg = dataclasses.replace(config.as_env_config(num_trajectories=64, n_steps=5),
                                  normalise_observation_space=True, normalise_action_space=True)
    rf_cfg = reinforce.ReinforceConfig(hidden=(8,), action_std=0.3, learning_rate=1e-2, lr_decay=0.9)
    sched = optax.exponential_decay(init_value=1e-2, transition_steps=1, decay_rate=0.9)
    state = reinforce.init_train_state(env_cfg, rf_cfg, 0, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        for epoch in range(1, 4):
            state, _ = reinforce.train_epoch(env_cfg, rf_cfg, state, epoch)
            rate = reinforce.learning_rate(rf_cfg, epoch)
            assert rate == 1e-2 * 0.9**epoch and rate == pytest.approx(float(sched(epoch)), rel=1e-6)
            assert state.opt_state.param_groups[0]["lr"] == rate and state.schedule.get_last_lr() == [rate]
            assert state.schedule.last_epoch == epoch == state.epoch
