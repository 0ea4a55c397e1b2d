"""Data-parallel mesh over a ``torch.distributed`` process group (counterpart
of ``mbt_gym_tpu/parallel/mesh.py``; the reference's process-level
parallelism was ``MultiprocessTradingEnv``).

One process per device.  The env batch axis splits over the ranks (the
JAX mesh's ``data`` axis): each rank steps its ``N / world`` envs, and the
learner averages its gradients across ranks with one all-reduce per
minibatch (:mod:`mbt_gym_torch.agents.ppo`'s ``mesh=`` paths), so params
stay replicated.  The process group is NCCL on CUDA devices and Gloo on
the CPU; nothing falls back from one to the other.

Not ported: the JAX mesh's ``model`` axis, the GSPMD tensor-parallel MLP
(``mlp_sharding_specs``, ``mbt_gym_tpu/parallel/mesh.py:74-105``).
``make_mesh(model > 1)`` raises ``NotImplementedError``; it is item 3 of
ROADMAP Queue 1.

Usage, one process per card (``torchrun`` sets ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT``; a single process needs none)::

    init_distributed()
    mesh = make_mesh()
    ts, metrics = ppo.train_iteration(env_cfg, ppo_cfg, ts, seed, mesh=mesh)
"""
from __future__ import annotations

import dataclasses
import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

from mbt_gym_torch.env import make_generator, resolve_device

_MODEL_AXIS = (
    "the mesh's model axis (the tensor-parallel MLP, mbt_gym_tpu/parallel/mesh.py:74-105) "
    "is not ported yet: it is item 3 of ROADMAP Queue 1"
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_distributed(world_size: Optional[int] = None, rank: Optional[int] = None,
                     init_method: Optional[str] = None, device=None) -> None:
    """Start this process's process group; does nothing if one is up.

    ``device`` (``None`` means ``"cuda"``) picks the backend: NCCL for a CUDA
    device, Gloo for the CPU.  ``world_size`` and ``rank`` default to the
    ``WORLD_SIZE`` and ``RANK`` variables, else 1 and 0.  ``init_method``
    defaults to ``env://`` where ``MASTER_ADDR`` is set, else to
    ``tcp://127.0.0.1:<a free port>``, which serves a single process.  On
    CUDA, the process's current device becomes ``LOCAL_RANK`` (else the
    rank) modulo the visible devices."""
    if dist.is_initialized():
        return
    device = resolve_device(device)
    world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else int(world_size)
    rank = int(os.environ.get("RANK", 0)) if rank is None else int(rank)
    if init_method is None:
        init_method = "env://" if "MASTER_ADDR" in os.environ else f"tcp://127.0.0.1:{_free_port()}"
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A process group seen as a ``(data, model)`` mesh: ``rank`` and
    ``world`` are this process's place in ``group`` (``None``: the default
    group), ``device`` the device it computes on."""

    group: Optional[dist.ProcessGroup]
    rank: int
    world: int
    device: torch.device
    data: int
    model: int = 1


def make_mesh(data: Optional[int] = None, model: int = 1, group: Optional[dist.ProcessGroup] = None) -> Mesh:
    """The ``(data, model)`` mesh over ``group`` (``None``: the default
    process group, which :func:`init_distributed` starts).  ``data``
    defaults to world // model.  ``model > 1`` raises
    ``NotImplementedError`` (see the module docstring)."""
    if model != 1:
        raise NotImplementedError(_MODEL_AXIS)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call init_distributed() first")
    world = dist.get_world_size(group)
    data = world if data is None else int(data)
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} does not cover the group's {world} processes")
    if dist.get_backend(group) == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    return Mesh(group=group, rank=dist.get_rank(group), world=world, device=device, data=data, model=model)


def local_slice(mesh: Mesh, n: int) -> slice:
    """This rank's envs of a batch of ``n``: contiguous, ``n / world`` each."""
    if n % mesh.world:
        raise ValueError(f"{n} envs do not split evenly over {mesh.world} ranks")
    per = n // mesh.world
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_env_state(mesh: Mesh, state):
    """This rank's rows of an :class:`~mbt_gym_torch.types.EnvState`: every
    tensor whose leading axis is the env batch is sliced; scalars stay; the
    generator becomes :func:`fold_in` of it with the rank, so each rank
    draws its own noise."""
    n = state.cash.shape[0]
    rows = local_slice(mesh, n)

    def place(x):
        if isinstance(x, torch.Tensor) and x.dim() >= 1 and x.shape[0] == n:
            return x[rows]
        if isinstance(x, tuple):
            return tuple(place(v) for v in x)
        return x

    key = None if state.key is None else make_generator(fold_in(state.key, mesh.rank), state.key.device)
    return type(state)(*(place(v) for v in state))._replace(key=key)


def shard_params(mesh: Mesh, params):
    """Broadcast rank 0's parameters (an ``nn.Module``, in place, as one
    flat buffer) to every rank of the mesh; returns ``params``."""
    tensors = [p.data for p in params.parameters()]
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.broadcast(flat, src=dist.get_global_rank(mesh.group, 0) if mesh.group is not None else 0, group=mesh.group)
    start = 0
    for t in tensors:
        t.copy_(flat[start:start + t.numel()].view_as(t))
        start += t.numel()
    return params


def all_reduce_mean(mesh: Mesh, flat: torch.Tensor) -> torch.Tensor:
    """The mean over the ranks of a flat float buffer, in place: one SUM
    all-reduce (every rank gets the same bits), then a division by the
    world size."""
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
    return flat.div_(mesh.world)


def _mix(seed: int, rank: int) -> int:
    """splitmix64 of (seed, rank), 63 bits."""
    z = (seed + 0x9E3779B97F4A7C15 * (rank + 1)) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (z ^ (z >> 31)) >> 1


def key_seed(key) -> int:
    """An int seed from a key: the seed itself, or one 62-bit draw from a
    ``torch.Generator`` (the same draw on every rank whose generator is in
    the same state)."""
    if isinstance(key, torch.Generator):
        return int(torch.randint(0, 2**62, (), generator=key, device=key.device))
    return int(key)


def fold_in(key, rank: int):
    """This rank's key from a key every rank holds (an int seed or a
    ``torch.Generator`` in the same state on every rank) — the counterpart
    of ``jax.random.fold_in(key, axis_index)`` (``ppo.py:317-319``).  Rank
    0 keeps the key itself, so a one-rank mesh draws what the meshless
    call draws; rank r > 0 gets the int seed splitmix64(:func:`key_seed`,
    r)."""
    if rank == 0:
        return key
    return _mix(key_seed(key), rank)


def shared_key(key) -> int:
    """An int seed alike on every rank and apart from every rank's
    :func:`fold_in` stream (the engine path's shuffle)."""
    return _mix(key_seed(key), -1)
