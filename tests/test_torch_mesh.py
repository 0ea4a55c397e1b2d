"""mbt_gym_torch.parallel.mesh, the mesh paths of agents.ppo and
mbt_gym_torch.entry against the JAX package:

- two Gloo processes (as tests/test_multihost.py runs two JAX processes):
  the fully fused data-parallel iteration with injected noise leaves both
  ranks with bitwise-equal, moved params (WORKER_FUSED), equal to one
  process on the whole batch at tests/test_sharding.py:181-187's
  tolerances and to JAX's _fused_train_iteration_mesh on two virtual
  devices at the fused iteration's tolerances
  (tests/test_torch_fused_ppo.py); the engine path's all-reduce leaves
  both ranks bitwise equal; shard_params, shard_env_state, scaling_report
  over widths 1 and 2, and dryrun_multichip(2) run across the two;
- entry()'s forward step against JAX's on the same converted state and
  draws; assert_metric_bands against __graft_entry__'s;
- dryrun_multichip(1) on the CPU;
- the model axis: two Gloo processes on a (1, 2) mesh run one engine
  iteration equal to one process's (chip_smoke.model_axis_close), both
  ranks bitwise alike after gather_params, the sharded policy_value and
  loss grads against JAX's shard_params on a (1, 2) virtual-device mesh,
  save_checkpoint(mesh=) restoring in one process; four on (2, 2) against
  (2, 1); mlp_sharding_specs leaf for leaf; the refusals.
"""
import copy
import dataclasses
import json
import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import __graft_entry__ as jentry
import chip_smoke
from mbt_gym_tpu import env as jenv
from mbt_gym_tpu.agents import networks as jnet
from mbt_gym_tpu.agents import ppo as jppo
from mbt_gym_tpu.parallel import mesh as jmesh
from mbt_gym_tpu.utils.config import as_env_config as jas_env_config

from mbt_gym_torch import convert, entry
from mbt_gym_torch.agents import ppo
from mbt_gym_torch.parallel import mesh as mesh_lib
from mbt_gym_torch.types import SlotNoise
from mbt_gym_torch.utils.config import as_env_config
from tests.test_torch_env import jax_state_numpy
from tests.test_torch_networks import assert_trees_close, jax_numpy_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, N = 8, 256

COMMON = textwrap.dedent(
    """
    import dataclasses, hashlib, json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from mbt_gym_torch.agents import ppo
    from mbt_gym_torch.parallel import mesh as mesh_lib
    from mbt_gym_torch.utils.config import as_env_config

    rank, port, out, world = int(sys.argv[1]), sys.argv[2], sys.argv[3], int(sys.argv[4])
    mesh_lib.init_distributed(world_size=world, rank=rank, init_method=f"tcp://127.0.0.1:{port}", device="cpu")
    mesh_lib.init_distributed(device="cpu")  # a second call does nothing
    mesh = mesh_lib.make_mesh()
    assert (mesh.rank, mesh.world, mesh.device.type) == (rank, dist.get_world_size(), "cpu")

    def digest(model):
        h = hashlib.sha256()
        for name, v in sorted(model.state_dict().items()):
            h.update(name.encode()); h.update(v.numpy().tobytes())
        return h.hexdigest()
    """
)

WORKER_FUSED = COMMON + textwrap.dedent(
    f"""
    T, N = {T}, {N}
    env_cfg = dataclasses.replace(as_env_config(num_trajectories=N, n_steps=T),
                                  normalise_observation_space=True, normalise_action_space=True)
    cfg = ppo.PPOConfig(hidden=(16, 16), n_epochs=2, n_minibatches=1, shuffle=False, shared_trunk=True,
                        fused_rollout=True, fused_update=True, fused_compute_dtype="float32")
    ts = ppo.init_train_state(env_cfg, cfg, 0, device="cpu")
    rng = np.random.default_rng(3)  # the same on both ranks
    channels = rng.uniform(size=(T, 7, N)).astype(np.float32)
    channels[:, 4:] = rng.normal(size=(T, 3, N)).astype(np.float32)
    new_ts, metrics = ppo.train_iteration(env_cfg, cfg, ts, 7, noise=torch.from_numpy(channels), mesh=mesh)
    moved = max(float((a - b).abs().max()) for a, b in zip(ts.params.parameters(), new_ts.params.parameters()))
    assert moved > 0.0 and new_ts.update_count == 1
    np.savez(f"{{out}}/fused{{rank}}.npz", **{{k: v.numpy() for k, v in new_ts.params.state_dict().items()}})
    print("RESULT", digest(new_ts.params), json.dumps({{k: float(v) for k, v in metrics.items()}}), flush=True)
    """
)

WORKER_ENGINE = COMMON + textwrap.dedent(
    """
    from mbt_gym_torch import entry, env as env_lib
    from mbt_gym_torch.agents.baseline import fixed_action_policy
    from mbt_gym_torch.utils import profiling

    env_cfg = dataclasses.replace(as_env_config(num_trajectories=64, n_steps=8),
                                  normalise_observation_space=True, normalise_action_space=True)
    cfg = ppo.PPOConfig(hidden=(16, 16), n_epochs=2, n_minibatches=2)
    ts = ppo.init_train_state(env_cfg, cfg, rank, device="cpu")  # different params on each rank ...
    mesh_lib.shard_params(mesh, ts.params)  # ... until rank 0's are broadcast
    first = digest(ts.params)
    batch = ppo.collect_rollout(env_cfg, ts.params, 5, mesh=mesh)
    assert batch.rewards.shape == (8, 32)
    new_ts, metrics = ppo.train_iteration(env_cfg, cfg, ts, 11, mesh=mesh)
    state, _ = env_lib.reset(env_cfg, 4, device="cpu")
    local = mesh_lib.shard_env_state(mesh, state)
    rows = slice(32 * rank, 32 * (rank + 1))
    assert torch.equal(local.cash, state.cash[rows]) and local.step is state.step
    assert (local.key is state.key) == (rank == 0)
    rows_report = profiling.scaling_report(as_env_config(num_trajectories=32, n_steps=4),
                                           fixed_action_policy([0.5, 0.5]), episodes_per_call=1, iters=1)
    assert [r["devices"] for r in rows_report] == [1, 2] and rows_report[0]["efficiency"] == 1.0
    entry.dryrun_multichip(2, n_envs=256, t_horizon=8)
    print("RESULT", first, digest(new_ts.params), float(batch.rewards.sum()),
          json.dumps({k: float(v) for k, v in metrics.items()}), flush=True)
    """
)


def _run_workers(tmp_path, worker_src, world=2):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    script = tmp_path / "_mesh_worker.py"
    script.write_text(worker_src)
    procs = []
    try:
        procs = [
            subprocess.Popen([sys.executable, str(script), str(i), port, str(tmp_path), str(world)], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for i in range(world)
        ]
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:  # no orphaned worker holding the port
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for i, out in enumerate(outs):
        assert procs[i].returncode == 0, f"worker {i} failed:\n{out}"
        results.append([line for line in out.splitlines() if line.startswith("RESULT")][0].split(" ", 1)[1])
    return results


def _fused_setup():
    env_cfg = dataclasses.replace(as_env_config(num_trajectories=N, n_steps=T),
                                  normalise_observation_space=True, normalise_action_space=True)
    kw = dict(hidden=(16, 16), n_epochs=2, n_minibatches=1, shuffle=False, shared_trunk=True,
              fused_rollout=True, fused_update=True, fused_compute_dtype="float32")
    rng = np.random.default_rng(3)
    channels = rng.uniform(size=(T, 7, N)).astype(np.float32)
    channels[:, 4:] = rng.normal(size=(T, 3, N)).astype(np.float32)
    return env_cfg, kw, channels


def test_two_process_fused_dp_matches_one_process_and_jax(tmp_path):
    results = _run_workers(tmp_path, WORKER_FUSED)
    digests = [r.split(" ", 1)[0] for r in results]
    assert digests[0] == digests[1], results
    mesh_metrics = json.loads(results[0].split(" ", 1)[1])
    got = {k: torch.from_numpy(v) for k, v in np.load(tmp_path / "fused0.npz").items()}

    env_cfg, kw, channels = _fused_setup()
    cfg = ppo.PPOConfig(**kw)
    ts = ppo.init_train_state(env_cfg, cfg, 0, device="cpu")
    one_ts, one_metrics = ppo.train_iteration(env_cfg, cfg, ts, 7, noise=torch.from_numpy(channels))
    for name, want in one_ts.params.state_dict().items():
        np.testing.assert_allclose(got[name].numpy(), want.numpy(), rtol=1e-6, atol=1e-6, err_msg=name)
    for k, v in one_metrics.items():
        np.testing.assert_allclose(mesh_metrics[k], float(v), rtol=1e-5, atol=1e-6, err_msg=k)

    # JAX's data-parallel fused iteration on two virtual devices, from the
    # same params and noise (interpret mode)
    jcfg = dataclasses.replace(jas_env_config(num_trajectories=N, n_steps=T),
                               normalise_observation_space=True, normalise_action_space=True)
    jcfg_ppo = jppo.PPOConfig(fused_interpret_ok=True, fused_rollout_tile=128, fused_tile=128, **kw)
    params = jax.tree_util.tree_map(jnp.asarray, convert.actor_critic_to_numpy(ts.params))
    jts = jppo.PPOTrainState(params=params, opt_state=jppo.make_optimizer(jcfg_ppo).init(params),
                             update_count=jnp.zeros((), jnp.int32))
    jm = jmesh.make_mesh(data=2, model=1, devices=jax.devices()[:2])
    want_ts, want_m = jppo._fused_train_iteration_mesh(jcfg, jcfg_ppo, jts, jax.random.PRNGKey(7), jm,
                                                       noise=jnp.asarray(channels))
    model = ppo.init_train_state(env_cfg, cfg, 0, device="cpu").params
    model.load_state_dict(got)
    assert_trees_close(convert.actor_critic_to_numpy(model), jax_numpy_tree(want_ts.params), rtol=5e-4, atol=5e-6)
    for name in ("pg_loss", "vf_loss", "approx_kl", "entropy", "mean_episode_reward"):
        np.testing.assert_allclose(mesh_metrics[name], float(want_m[name]), rtol=1e-3, atol=1e-5, err_msg=name)


def test_two_process_engine_dp_is_bitwise_across_ranks(tmp_path):
    results = [r.split(" ") for r in _run_workers(tmp_path, WORKER_ENGINE)]
    (first0, new0, local0, _), (first1, new1, local1, _) = (r[:3] + [r[3:]] for r in results)
    assert first0 == first1  # shard_params broadcast rank 0's params
    assert new0 == new1 and new0 != first0  # the all-reduced update, moved
    assert local0 != local1  # each rank stepped its own envs from its own stream


def test_fold_in_keeps_rank_zero_and_splits_the_others():
    """Rank 0 keeps the key itself (an int stays the same int, a generator
    the same generator), every other rank gets its own int seed, alike on
    every rank holding the key, and apart from the shared shuffle seed."""
    gen = torch.Generator().manual_seed(9)
    assert mesh_lib.fold_in(5, 0) == 5 and mesh_lib.fold_in(gen, 0) is gen
    seeds = [mesh_lib.fold_in(5, r) for r in range(1, 4)]
    assert len(set(seeds + [5, mesh_lib.shared_key(5)])) == 5
    assert all(isinstance(s, int) and 0 <= s < 2**63 for s in seeds)
    g1, g2 = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    assert mesh_lib.fold_in(g1, 1) == mesh_lib.fold_in(g2, 1)


@pytest.fixture()
def gloo_group():
    assert not dist.is_initialized()
    mesh_lib.init_distributed(device="cpu")
    try:
        yield mesh_lib.make_mesh()
    finally:
        dist.destroy_process_group()


def test_make_mesh_and_the_model_axis(gloo_group):
    mesh = gloo_group
    assert (mesh.rank, mesh.world, mesh.data, mesh.model, mesh.device.type) == (0, 1, 1, 1, "cpu")
    with pytest.raises(ValueError, match="mesh 0x2 does not cover the group's 1 processes"):
        mesh_lib.make_mesh(model=2)
    with pytest.raises(ValueError, match="does not cover"):
        mesh_lib.make_mesh(data=2)


def test_one_rank_fused_mesh_equals_the_meshless_iteration(gloo_group):
    """World size 1 (phase 25b's check on the card): the same rollout
    (rank 0 keeps the key), the advantages normalised as the meshless path
    does, K4's grads through a one-rank all-reduce: the same bits."""
    env_cfg, kw, _ = _fused_setup()
    cfg = ppo.PPOConfig(**dict(kw, n_minibatches=2))
    ts = ppo.init_train_state(env_cfg, cfg, 0, device="cpu")
    want_ts, want_m = ppo.train_iteration(env_cfg, cfg, ts, 3)
    got_ts, got_m = ppo.train_iteration(env_cfg, cfg, ts, 3, mesh=gloo_group)
    for (name, a), b in zip(want_ts.params.state_dict().items(), got_ts.params.state_dict().values()):
        assert torch.equal(a, b), name
    assert {k: float(v) for k, v in got_m.items()} == {k: float(v) for k, v in want_m.items()}


def test_dryrun_multichip_one_rank_on_cpu(gloo_group, capsys):
    entry.dryrun_multichip(1, n_envs=256, t_horizon=8, device="cpu")
    out = capsys.readouterr().out
    assert "dryrun_multichip OK" in out and "dryrun fused-DP OK" in out


def test_entry_forward_step_matches_jax():
    """entry()'s forward step on JAX's entry state (converted) with JAX's
    own draws for that step (env.step's fold_in(key, step) draw) injected:
    the same observations, rewards and dones at tests/test_pallas_episode.py's
    float32 tolerances."""
    from mbt_gym_torch.convert import env_state_from_numpy

    jfn, (jstate, jobs) = jentry.entry()
    want_obs, want_reward, want_done = (np.asarray(x) for x in jfn(jstate, jobs))
    jcfg = jas_env_config(num_trajectories=1024)
    jnoise = jenv.draw_step_noise(jcfg, jax.random.fold_in(jstate.key, jstate.step), 1024)
    noise = tuple(SlotNoise(*(None if x is None else np.asarray(x) for x in slot)) for slot in jnoise)
    fn, (state0, obs0) = entry.entry(device="cpu")
    assert tuple(obs0.shape) == (1024, 4) and state0.cash.device.type == "cpu"
    state = env_state_from_numpy(**jax_state_numpy(jstate), device="cpu")
    obs, reward, done = fn(state, torch.from_numpy(np.array(jobs)), noise=noise)
    np.testing.assert_array_equal(obs[:, 1].numpy(), want_obs[:, 1])
    np.testing.assert_allclose(obs.numpy(), want_obs, rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(reward.numpy(), want_reward, rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(done.numpy(), want_done)


BAND_CASES = [
    {"pg_loss": 0.01, "vf_loss": 2.0, "approx_kl": 0.001, "mean_episode_reward": 10.0, "entropy": 1.8},
    {"pg_loss": 0.01, "vf_loss": 2.0, "approx_kl": 0.001, "mean_episode_reward": 10.0},
    {"pg_loss": 0.6, "vf_loss": 2.0, "approx_kl": 0.001, "mean_episode_reward": 10.0},
    {"pg_loss": 0.01, "vf_loss": 0.0, "approx_kl": 0.001, "mean_episode_reward": 10.0},
    {"pg_loss": 0.01, "vf_loss": 2.0, "approx_kl": -0.7, "mean_episode_reward": 10.0},
    {"pg_loss": 0.01, "vf_loss": 2.0, "approx_kl": 0.001, "mean_episode_reward": 250.0},
    {"pg_loss": 0.01, "vf_loss": 2.0, "approx_kl": 0.001, "mean_episode_reward": 10.0, "entropy": 25.0},
    {"pg_loss": float("nan"), "vf_loss": 2.0, "approx_kl": 0.001, "mean_episode_reward": 10.0},
    {"pg_loss": 0.01, "vf_loss": 2.0, "approx_kl": 0.001, "mean_episode_reward": 10.0, "x": float("inf")},
]


@pytest.mark.parametrize("case", range(len(BAND_CASES)))
def test_assert_metric_bands_accepts_and_rejects_as_jax(case):
    metrics = BAND_CASES[case]
    outcomes = []
    for fn in (jentry._assert_metric_bands, entry.assert_metric_bands):
        try:
            outcomes.append(fn({k: torch.tensor(v) for k, v in metrics.items()}, "label"))
        except AssertionError:
            outcomes.append("rejected")
    assert outcomes[0] == outcomes[1]


# ------------------------------------------------------------ the model axis
# The model axis's engine iteration: the normalised AS env, towers of three
# hidden layers (the row-parallel layers 1 and 2, layer 2 and the heads on
# a replicated input cut to the rank's features), two epochs of two
# shuffled minibatches.
MODEL_ENV = dict(num_trajectories=64, n_steps=8)
MODEL_PPO = dict(hidden=(16, 12, 8), n_epochs=2, n_minibatches=2)

WORKER_MODEL = COMMON.replace("mesh = mesh_lib.make_mesh()", "mesh = mesh_lib.make_mesh(model=2)") + textwrap.dedent(
    f"""
    from mbt_gym_torch import checkpoint
    from mbt_gym_torch.agents import networks

    assert (mesh.data, mesh.model, mesh.data_index, mesh.model_index) == (1, 2, 0, rank)
    env_cfg = dataclasses.replace(as_env_config(**{MODEL_ENV!r}),
                                  normalise_observation_space=True, normalise_action_space=True)
    cfg = ppo.PPOConfig(**{MODEL_PPO!r})
    ts = ppo.init_train_state(env_cfg, cfg, rank, device="cpu")  # rank 0's are broadcast, then split
    mesh_lib.shard_params(mesh, ts.params)
    assert ts.params.model_shards == (rank, 2) and ts.params.pi[0].weight.shape == (8, 4)
    assert ts.params.pi[1].weight.shape == (12, 8) and ts.params.pi[3].weight.shape == (2, 4)
    new_ts, metrics = ppo.train_iteration(env_cfg, cfg, ts, 11, mesh=mesh)
    whole = mesh_lib.gather_params(mesh, new_ts.params)
    assert whole.model_shards == (0, 1) and whole.pi[1].weight.shape == (12, 16)
    np.savez(f"{{out}}/iter{{rank}}.npz", **{{k: v.numpy() for k, v in whole.state_dict().items()}})
    checkpoint.save_checkpoint(f"{{out}}/model.ckpt", {{"train_state": new_ts, "key": 4}}, mesh=mesh)

    # one fixed minibatch through the shards: policy_value and the loss grads
    inputs = dict(np.load(f"{{out}}/inputs.npz"))
    model = networks.ActorCritic(4, 2, (16, 12, 8), device="cpu")
    model.load_state_dict(torch.load(f"{{out}}/model.pt"))
    mesh_lib.shard_params(mesh, model)
    obs, actions, log_probs, adv, returns = (torch.from_numpy(inputs[k]) for k in
                                             ("obs", "actions", "log_probs", "adv", "returns"))
    mean, values = networks.policy_value(model, obs, model_group=mesh.model_group)
    loss, mb_metrics = ppo._ppo_loss(model, ppo.PPOConfig(), ppo.UpdateBatch(obs, actions, log_probs, adv, returns),
                                     mesh.model_group)
    loss.backward()
    grads = mesh_lib._gather_leaves(mesh, model, [p.grad for p in model.parameters()])
    names = [name for name, _ in model.named_parameters()]
    np.savez(f"{{out}}/grads{{rank}}.npz", mean=mean.detach().numpy(), values=values.detach().numpy(), loss=loss.detach().numpy(),
             **{{"g:" + n: g.numpy() for n, g in zip(names, grads)}},
             **{{"m:" + k: v.detach().numpy() for k, v in mb_metrics.items()}})
    print("RESULT", digest(whole), json.dumps({{k: float(v) for k, v in metrics.items()}}), flush=True)
    """
)

WORKER_GRID = COMMON.replace("mesh = mesh_lib.make_mesh()", "mesh = mesh_lib.make_mesh(data=2, model=2)") + textwrap.dedent(
    f"""
    assert (mesh.data_index, mesh.model_index) == (rank // 2, rank % 2)
    env_cfg = dataclasses.replace(as_env_config(**{MODEL_ENV!r}),
                                  normalise_observation_space=True, normalise_action_space=True)
    cfg = ppo.PPOConfig(**{MODEL_PPO!r})
    ts = ppo.init_train_state(env_cfg, cfg, 0, device="cpu")
    mesh_lib.shard_params(mesh, ts.params)
    new_ts, metrics = ppo.train_iteration(env_cfg, cfg, ts, 11, mesh=mesh)
    whole = mesh_lib.gather_params(mesh, new_ts.params)
    # (2, 1) over the ranks of model index 0, which hold data indices 0 and 1
    group = dist.new_group([0, 2])
    compact = dict(separators=(",", ":"))
    line = digest(whole) + " " + json.dumps({{k: float(v) for k, v in metrics.items()}}, **compact)
    if rank in (0, 2):
        dp = mesh_lib.make_mesh(data=2, model=1, group=group)
        assert dp.data_index == rank // 2
        dp_ts, dp_metrics = ppo.train_iteration(env_cfg, cfg, ppo.init_train_state(env_cfg, cfg, 0, device="cpu"),
                                                11, mesh=dp)
        np.savez(f"{{out}}/grid{{rank}}.npz", **{{k: v.numpy() for k, v in whole.state_dict().items()}})
        np.savez(f"{{out}}/dp{{rank}}.npz", **{{k: v.numpy() for k, v in dp_ts.params.state_dict().items()}})
        line += " " + json.dumps({{k: float(v) for k, v in dp_metrics.items()}}, **compact)
    print("RESULT", line, flush=True)
    """
)


def _model_inputs(tmp):
    """JAX actor-critic towers (16, 12, 8) and one minibatch (the PPO
    tests' batch), saved for the workers; returns the JAX params, the
    arrays and the port model."""
    from tests.test_torch_ppo import _batch

    jparams = jnet.init_actor_critic(jax.random.PRNGKey(1), 4, 2, hidden=(16, 12, 8))
    arrays = _batch(jparams, m=128)
    model = convert.actor_critic_from_numpy(jax_numpy_tree(jparams), device="cpu")
    torch.save(model.state_dict(), tmp / "model.pt")
    np.savez(tmp / "inputs.npz", **dict(zip(("obs", "actions", "log_probs", "adv", "returns"), arrays)))
    return jparams, arrays, model


@pytest.fixture(scope="module")
def model_run(tmp_path_factory):
    """Two Gloo processes on a (1, 2) mesh, run once for the tests below."""
    tmp = tmp_path_factory.mktemp("model_axis")
    jparams, arrays, model = _model_inputs(tmp)
    results = _run_workers(tmp, WORKER_MODEL)
    return tmp, results, jparams, arrays, model


def _meshless_iteration():
    env_cfg = dataclasses.replace(as_env_config(**MODEL_ENV), normalise_observation_space=True,
                                  normalise_action_space=True)
    cfg = ppo.PPOConfig(**MODEL_PPO)
    ts = ppo.init_train_state(env_cfg, cfg, 0, device="cpu")
    return ts, ppo.train_iteration(env_cfg, cfg, ts, 11)


# The tolerance, argued from the sum order (chip_smoke.model_axis_close):
# the model axis sums two partial products where the meshless path sums
# one, so float32 differs in the last bits; at most a few elements whose
# summed grad lies within that rounding of zero can take an Adam step the
# other way (Adam moves an element by about lr whatever the grad's size),
# so every element within 2 x lr per optimizer step, at least 99.9% within
# tests/test_sharding.py's rtol/atol 1e-6, and the metrics within rtol
# 1e-5 / atol 1e-6.
STEPS = MODEL_PPO["n_epochs"] * MODEL_PPO["n_minibatches"]


def _assert_iteration_close(got, want, label):
    ok, worst, tight = chip_smoke.model_axis_close(got, want, ppo.PPOConfig().learning_rate, STEPS)
    assert ok, (label, worst, tight)


def test_model_axis_iteration_equals_the_meshless_one(model_run):
    """(1, 2): both model ranks step the meshless envs with the meshless
    draws and shuffle; the gathered params and the metrics equal one
    process's iteration from the same params and key at the tolerances
    argued above."""
    tmp, results, *_ = model_run
    _, (want_ts, want_m) = _meshless_iteration()
    got = np.load(tmp / "iter0.npz")
    _assert_iteration_close(dict(got), {k: v.numpy() for k, v in want_ts.params.state_dict().items()}, "(1, 2)")
    metrics = json.loads(results[0].split(" ", 1)[1])
    for k, v in want_m.items():
        np.testing.assert_allclose(metrics[k], float(v), rtol=1e-5, atol=1e-6, err_msg=k)


def test_model_axis_ranks_agree_bitwise(model_run):
    """Replicated leaves and the metrics come out bitwise equal on the two
    model ranks, and gather_params rebuilds the same whole model on both."""
    tmp, results, *_ = model_run
    assert results[0] == results[1]
    a, b = np.load(tmp / "iter0.npz"), np.load(tmp / "iter1.npz")
    for name in a.files:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_model_axis_forward_and_grads_match_jax_shard_params(model_run):
    """policy_value and the PPO loss grads on one fixed minibatch through
    the port's (1, 2) shards against JAX's shard_params on a (1, 2) mesh
    of virtual CPU devices (GSPMD), at tests/test_torch_ppo.py's grad
    tolerances."""
    tmp, _, jparams, arrays, model = model_run
    jm = jmesh.make_mesh(data=1, model=2, devices=jax.devices()[:2])
    sparams = jmesh.shard_params(jm, jax.tree_util.tree_map(jnp.asarray, jparams))
    assert sparams["pi"][1]["w"].sharding.spec == jax.sharding.PartitionSpec("model", None)
    obs, actions, log_probs, adv, returns = (jnp.asarray(x) for x in arrays)
    mean, values = jax.jit(jnet.policy_value)(sparams, obs)
    cfg = jppo.PPOConfig()
    batch = jppo.RolloutBatch(obs=obs, actions=actions, log_probs=log_probs, values=returns,
                              rewards=jnp.zeros_like(adv), advantages=adv, returns=returns)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(jppo._ppo_loss, has_aux=True), static_argnums=1)(
        sparams, cfg, batch)
    for rank in (0, 1):
        got = np.load(tmp / f"grads{rank}.npz")
        np.testing.assert_allclose(got["mean"], np.asarray(mean), rtol=2e-4, atol=2e-6)
        np.testing.assert_allclose(got["values"], np.asarray(values), rtol=2e-4, atol=2e-6)
        np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-4, atol=1e-6)
        for k in ("pg_loss", "vf_loss", "approx_kl", "entropy"):
            np.testing.assert_allclose(got["m:" + k], float(metrics[k]), rtol=1e-4, atol=1e-6, err_msg=k)
        port = copy.deepcopy(model)
        grads_port = {name: torch.from_numpy(got["g:" + name]) for name, _ in port.named_parameters()}
        assert_trees_close(convert.actor_critic_to_numpy(port, grads_port), jax_numpy_tree(grads),
                           rtol=2e-4, atol=2e-6)


def test_model_axis_checkpoint_restores_in_one_process(model_run):
    """save_checkpoint(mesh=) of the split train state gathers it whole:
    a one-process template restores it, its params equal gather_params'
    and its Adam moments hold the whole shapes."""
    from mbt_gym_torch.checkpoint import restore_checkpoint

    tmp, *_ = model_run
    template, _ = _meshless_iteration()
    restored = restore_checkpoint(str(tmp / "model.ckpt"), {"train_state": template, "key": 0})
    got = np.load(tmp / "iter0.npz")
    for name, v in restored["train_state"].params.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), got[name], err_msg=name)
    opt = restored["train_state"].opt_state
    first = next(restored["train_state"].params.parameters())
    assert opt.state[first]["exp_avg"].shape == first.shape and float(opt.state[first]["step"]) == 4.0
    assert restored["key"] == 4


@pytest.fixture(scope="module")
def grid_run(tmp_path_factory):
    """Four Gloo processes: a (2, 2) iteration, then a (2, 1) one over the
    ranks of model index 0."""
    tmp = tmp_path_factory.mktemp("grid")
    return tmp, _run_workers(tmp, WORKER_GRID, world=4)


def test_two_by_two_iteration_equals_two_by_one(grid_run):
    """(2, 2) against (2, 1) from the same params and key: each data index
    steps its own envs (fold_in with the data index) and shuffles alike,
    the model ranks split the towers; equal at the tolerances argued above,
    the four ranks bitwise alike."""
    tmp, results = grid_run
    lines = [r.split(" ") for r in results]
    assert len({line[0] for line in lines}) == 1 and len({line[1] for line in lines}) == 1
    got, want = np.load(tmp / "grid0.npz"), np.load(tmp / "dp0.npz")
    np.testing.assert_array_equal(want["pi.0.weight"], np.load(tmp / "dp2.npz")["pi.0.weight"])
    _assert_iteration_close(dict(got), dict(want), "(2, 2)")
    grid_m, dp_m = json.loads(lines[0][1]), json.loads(lines[0][2])
    for k, v in dp_m.items():
        np.testing.assert_allclose(grid_m[k], v, rtol=1e-5, atol=1e-6, err_msg=k)


def test_mlp_sharding_specs_match_jax_leaf_for_leaf():
    for hidden in ((16, 16), (8,), (16, 12, 8), ()):
        jparams = jnet.init_actor_critic(jax.random.PRNGKey(0), 4, 2, hidden=hidden)
        want = jmesh.mlp_sharding_specs(jparams)
        model = convert.actor_critic_from_numpy(jax_numpy_tree(jparams), device="cpu")
        got = mesh_lib.mlp_sharding_specs(model)
        assert got["log_std"] == tuple(want["log_std"])
        for tower in ("pi", "vf"):
            assert [{k: tuple(v) for k, v in leaf.items()} for leaf in want[tower]] == got[tower], (hidden, tower)


def test_shared_trunk_on_the_model_axis_raises():
    """JAX shards only the towers; a shared trunk on model = 2 raises before
    any collective (the mesh here has no process group behind it)."""
    model = ppo.init_train_state(as_env_config(num_trajectories=8, n_steps=2),
                                 ppo.PPOConfig(hidden=(16, 16), shared_trunk=True), 0, device="cpu").params
    fake = mesh_lib.Mesh(group=None, rank=0, world=2, device=torch.device("cpu"), data=1, model=2)
    with pytest.raises(ValueError, match="shared trunk has no model placement"):
        mesh_lib.shard_params(fake, model)
    with pytest.raises(ValueError, match="shared trunk"):
        mesh_lib.mlp_sharding_specs(model)


def test_placements_and_the_model_axis_refusals(gloo_group):
    """env_sharding splits the env axis over data, replicated keeps a
    tensor whole; the fused learners refuse model > 1; the compiled entry
    points refuse a Gloo mesh on the card (checked here on its rule)."""
    from mbt_gym_torch import compiled

    x = torch.arange(12.0).reshape(6, 2)
    assert mesh_lib.env_sharding(gloo_group).spec == ("data",)
    assert torch.equal(mesh_lib.env_sharding(gloo_group).local(x), x)
    assert torch.equal(mesh_lib.replicated(gloo_group).gather(x), x)
    two = dataclasses.replace(gloo_group, world=2, data=1, model=2)
    env_cfg = as_env_config(num_trajectories=8, n_steps=2)
    for kw in (dict(fused_update=True), dict(fused_rollout=True, fused_update=True, shuffle=False)):
        with pytest.raises(ValueError, match="model > 1 trains on the engine path"):
            ppo._iteration_config(env_cfg, ppo.PPOConfig(**kw), two)
    with pytest.raises(ValueError, match="cannot hold the gloo backend's collectives"):
        compiled._check_capturable_mesh(gloo_group)
