"""Pod-scale PPO: shard 1M+ envs over every rank of the process group and
train with the on-device learner (BASELINE.json config #5), on the PyTorch
port (``examples/pod_scale_ppo.py`` for the JAX package).

- One process per card, under ``torchrun`` (which sets ``RANK``,
  ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``): the env axis splits
  over the mesh's ``data`` axis, params replicate, or the separate pi/vf
  towers split over ``model`` with ``--model-parallel`` (the engine path).
  NCCL takes one card per rank.
- No process group: one process, world size 1.
- ``--coordinator host:port`` is the process group's ``init_method``
  (``tcp://host:port``), with ``RANK`` and ``WORLD_SIZE`` from the
  environment.

    torchrun --nproc-per-node 8 examples_torch/pod_scale_ppo.py --fused
    torchrun --nproc-per-node 8 examples_torch/pod_scale_ppo.py --model-parallel 2
    python examples_torch/pod_scale_ppo.py --device cpu --envs-per-device 256 --n-steps 8 --iterations 2
"""
import argparse
import dataclasses
import json
import time

import torch

from mbt_gym_torch import compiled
from mbt_gym_torch.agents import ppo
from mbt_gym_torch.parallel import mesh as mesh_lib
from mbt_gym_torch.utils.config import as_env_config


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--envs-per-device", type=int, default=131072)
    parser.add_argument("--iterations", type=int, default=10)
    parser.add_argument("--n-steps", type=int, default=200)
    parser.add_argument("--model-parallel", type=int, default=1)
    parser.add_argument(
        "--fused", action="store_true",
        help="use the fully-fused pipeline (shared trunk, the rollout (K3) and "
        "update (K4) kernels, data-parallel with all-reduced grads) — the "
        "production single- and multi-card data-parallel configuration; "
        "requires --model-parallel 1",
    )
    parser.add_argument("--coordinator", type=str, default=None,
                        help="process-group rendezvous address (host:port)")
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = parser.parse_args()

    mesh_lib.init_distributed(init_method=f"tcp://{args.coordinator}" if args.coordinator else None,
                              device=args.device)
    world = torch.distributed.get_world_size()
    mesh = mesh_lib.make_mesh(data=world // args.model_parallel, model=args.model_parallel)
    total_envs = args.envs_per_device * world
    print(f"mesh {{'data': {mesh.data}, 'model': {mesh.model}}} | {total_envs:,} envs total")

    env_cfg = as_env_config(num_trajectories=total_envs, n_steps=args.n_steps)
    env_cfg = dataclasses.replace(
        env_cfg, normalise_observation_space=True, normalise_action_space=True
    )
    if args.fused:
        assert args.model_parallel == 1, "fused pipeline is replicated-params DP"
        ppo_cfg = ppo.PPOConfig(
            hidden=(256, 256), n_epochs=1, n_minibatches=16, shuffle=False,
            compute_dtype="bfloat16", shared_trunk=True,
            fused_update=True, fused_rollout=True,
        )
    else:
        ppo_cfg = ppo.PPOConfig(hidden=(256, 256), n_epochs=1, n_minibatches=64)
    ts = ppo.init_train_state(env_cfg, ppo_cfg, 0, device=mesh.device)
    mesh_lib.shard_params(mesh, ts.params)  # rank 0's params; the towers split over model

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)

    # untimed warm-up: the first call captures the iteration's CUDA graph
    ts, _ = ppo.jit_train_iteration(env_cfg, ppo_cfg, ts, 99, mesh=mesh)
    sync()

    for i in range(args.iterations):
        t0 = time.time()
        ts, metrics = ppo.jit_train_iteration(env_cfg, ppo_cfg, ts, 100 + i, mesh=mesh)
        sync()
        steps = total_envs * args.n_steps
        m = {k: float(v) for k, v in metrics.items()}
        print(
            f"iter {i}: reward {m['mean_episode_reward']:8.3f}  "
            f"{steps / (time.time() - t0) / 1e6:8.1f}M env-steps/s (incl. learner)  "
            f"metrics={json.dumps(m, separators=(',', ':'))}"
        )
    compiled.clear_cache()  # the graphs holding NCCL collectives go before their communicators
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
