"""The port's user examples (examples_torch/, the counterparts of the
eight scripts of examples/) run as a user runs them, each a subprocess
with ``--device cpu`` at a tiny size (a few hundred envs, a few steps, one
or two iterations), all started together: every figure they print is
finite, none imports JAX or the JAX package, replicate_as's table sits in
the AS bands (tests/test_pallas_episode.py:150-152) and replicate_cjp's
t statistics within |t| < 3.29 (tests/test_replication.py:52-80), and
pod_scale_ppo's iterations in the metric bands, also over a (1, 2) mesh
of two Gloo processes.  The lines are parsed by chip_smoke.parse_example,
which phase 30 reads the same lines with on the card."""
import os
import socket
import subprocess
import sys

import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = ("replicate_as", "replicate_cjp", "baseline_agents", "train_ppo", "train_canonical", "train_oe",
           "arrival_rate_sweep", "pod_scale_ppo")
TINY = {
    "replicate_as": ["--trajectories", "512"],
    "replicate_cjp": ["--trajectories", "128"],
    "baseline_agents": ["--trajectories", "256"],
    "train_ppo": ["--trajectories", "128", "--n-steps", "20", "--iterations", "2", "--eval-every", "1",
                  "--production", "--checkpoint", "{tmp}/ppo.ckpt"],
    "train_canonical": ["--trajectories", "256", "--iterations", "2", "--eval-every", "1", "--eval-episodes", "1",
                        "--phases", "2"],
    "train_oe": ["--trajectories", "256", "--n-steps", "20", "--iterations", "3", "--phases", "3", "--eval-every",
                 "1", "--eval-episodes", "1"],
    "arrival_rate_sweep": ["--trajectories", "32", "--iterations", "2", "--chunk", "2"],
    "pod_scale_ppo": ["--envs-per-device", "256", "--n-steps", "8", "--iterations", "2", "--fused"],
}
MODEL_PARALLEL = ["--envs-per-device", "128", "--n-steps", "8", "--iterations", "1", "--model-parallel", "2"]
CHECKS = {  # example_failures' keywords for each run
    "replicate_as": dict(as_table=True),
    "replicate_cjp": dict(t_stats=4),
    "pod_scale_ppo": dict(iterations=2),
    "pod_scale_ppo_mp0": dict(iterations=1),
    "pod_scale_ppo_mp1": dict(iterations=1),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every example's output, the runs started together (one thread each)."""
    tmp = tmp_path_factory.mktemp("examples")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        env.pop(key, None)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    commands = {name: (chip_smoke.example_command(sys.executable, name, [a.format(tmp=tmp) for a in TINY[name]]
                                                  + ["--device", "cpu"]), env) for name in SCRIPTS}
    for rank in range(2):  # torchrun's variables for a two-process group
        mp_env = dict(env, RANK=str(rank), WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
        commands[f"pod_scale_ppo_mp{rank}"] = (
            chip_smoke.example_command(sys.executable, "pod_scale_ppo", MODEL_PARALLEL + ["--device", "cpu"]), mp_env)
    procs = {}
    try:
        for name, (cmd, cmd_env) in commands.items():
            procs[name] = subprocess.Popen(cmd, cwd=REPO, env=cmd_env, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True)
        outs = {name: p.communicate(timeout=300)[0] for name, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return tmp, {name: (procs[name].returncode, outs[name]) for name in commands}


@pytest.mark.parametrize("name", SCRIPTS + ("pod_scale_ppo_mp0", "pod_scale_ppo_mp1"))
def test_example_runs_with_finite_figures_and_no_jax(runs, name):
    _, results = runs
    rc, out = results[name]
    assert rc == 0, out
    parsed = chip_smoke.parse_example(out)
    assert chip_smoke.example_failures(parsed, expect_launches={}, **CHECKS.get(name, {})) == [], out
    assert len(parsed["figures"]) > 3, out


def test_model_parallel_ranks_print_the_same_iteration(runs):
    """The two model ranks of pod_scale_ppo --model-parallel 2 step the same
    envs and apply the same update: their metrics are bitwise alike."""
    _, results = runs
    got = [chip_smoke.parse_example(results[f"pod_scale_ppo_mp{r}"][1])["iterations"] for r in range(2)]
    assert got[0] == got[1] and len(got[0]) == 1
    assert "mesh {'data': 1, 'model': 2} | 256 envs total" in results["pod_scale_ppo_mp0"][1]


def test_train_ppo_checkpoint_restores(runs):
    """train_ppo --checkpoint writes the pre-update train state of its best
    evaluation; it restores into a template of the same architecture."""
    import torch

    from mbt_gym_torch.agents import ppo
    from mbt_gym_torch.checkpoint import restore_checkpoint
    from mbt_gym_torch.utils.config import cj_env_config

    tmp, _ = runs
    cfg = ppo.PPOConfig(hidden=(256, 256), n_minibatches=4, shuffle=False, compute_dtype="bfloat16",
                        shared_trunk=True, fused_update=True)
    template = ppo.init_train_state(cj_env_config(num_trajectories=128, n_steps=20), cfg, 5, device="cpu")
    before = template.params.shared[0].weight.clone()
    restored = restore_checkpoint(str(tmp / "ppo.ckpt"), template)
    assert not torch.equal(restored.params.shared[0].weight, before)


def test_example_sources_import_no_jax():
    for name in SCRIPTS:
        with open(os.path.join(REPO, "examples_torch", f"{name}.py")) as f:
            source = f.read()
        assert "import jax" not in source and "mbt_gym_tpu" not in source.replace("examples/", ""), name
