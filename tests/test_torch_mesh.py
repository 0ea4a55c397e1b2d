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
- dryrun_multichip(1) on the CPU.
"""
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
from mbt_gym_tpu import env as jenv
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
    torch.set_num_threads(1)
    from mbt_gym_torch.agents import ppo
    from mbt_gym_torch.parallel import mesh as mesh_lib
    from mbt_gym_torch.utils.config import as_env_config

    rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    mesh_lib.init_distributed(world_size=2, rank=rank, init_method=f"tcp://127.0.0.1:{port}", device="cpu")
    mesh_lib.init_distributed(device="cpu")  # a second call does nothing
    mesh = mesh_lib.make_mesh()
    assert (mesh.rank, mesh.world, mesh.device.type) == (rank, 2, "cpu")

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


def _run_two_process(tmp_path, worker_src):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    script = tmp_path / "_mesh_worker.py"
    script.write_text(worker_src)
    procs = []
    try:
        procs = [
            subprocess.Popen([sys.executable, str(script), str(i), port, str(tmp_path)], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for i in range(2)
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
    results = _run_two_process(tmp_path, WORKER_FUSED)
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
    results = [r.split(" ") for r in _run_two_process(tmp_path, WORKER_ENGINE)]
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
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
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
