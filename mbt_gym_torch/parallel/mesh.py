"""The ``(data, model)`` mesh over a ``torch.distributed`` process group
(counterpart of ``mbt_gym_tpu/parallel/mesh.py``; the reference's
process-level parallelism was ``MultiprocessTradingEnv``).

One process per device, laid out as JAX lays out its devices
(``reshape(data, model)``): the process at place ``p`` of the group has
``data`` index ``p // model`` and ``model`` index ``p % model``.

- The env batch axis splits over ``data``: each ``data`` index steps its
  ``N / data`` envs from its own key (:func:`fold_in` with the ``data``
  index), and the learner averages its gradients over ``data`` with one
  all-reduce per minibatch (:mod:`mbt_gym_torch.agents.ppo`'s ``mesh=``
  paths).  The ``model`` ranks of one ``data`` index step the same envs
  with the same draws, as GSPMD's do.
- The actor-critic's separate pi/vf towers split over ``model`` as JAX's
  :func:`mlp_sharding_specs` place them (the tensor-parallel MLP):
  :func:`shard_params` keeps each rank's slices, the forward
  (:mod:`mbt_gym_torch.agents.networks`) runs layer 0 column-parallel and
  every later layer row-parallel, with the collectives written as
  Megatron's pair of autograd functions (:func:`copy_to_model`,
  :func:`reduce_from_model`), and :func:`gather_params` rebuilds the whole
  model.  The fused kernels (K3, K4, K7) hold the whole MLP, so a mesh
  with ``model > 1`` trains on the engine path, as JAX's fused path
  asserts.

The process group is NCCL on CUDA devices and Gloo on the CPU unless
:func:`init_distributed` is given ``backend=``; nothing falls back from one
to the other.  NCCL takes one card per rank; ranks sharing a card run Gloo
(``backend="gloo"``, ``make_mesh(device="cuda")``), whose collectives stage
CUDA tensors through the host and which a CUDA graph cannot capture.  Only
``all_reduce`` and ``broadcast`` are used, the two collectives Gloo runs on
CUDA tensors.

Usage, one process per card (``torchrun`` sets ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT``; a single process needs none)::

    init_distributed()
    mesh = make_mesh(model=2)
    shard_params(mesh, ts.params)  # before the first optimizer step
    ts, metrics = ppo.train_iteration(env_cfg, ppo_cfg, ts, seed, mesh=mesh)
"""
from __future__ import annotations

import copy
import dataclasses
import os
import socket
from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from mbt_gym_torch.env import make_generator, resolve_device


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_distributed(world_size: Optional[int] = None, rank: Optional[int] = None,
                     init_method: Optional[str] = None, device=None, backend: Optional[str] = None) -> None:
    """Start this process's process group; does nothing if one is up.

    ``backend`` defaults by ``device`` (``None`` means ``"cuda"``): NCCL for
    a CUDA device, Gloo for the CPU; ``backend="gloo"`` on a CUDA device
    serves ranks that share one card, which NCCL refuses.  ``world_size``
    and ``rank`` default to the ``WORLD_SIZE`` and ``RANK`` variables, else
    1 and 0.  ``init_method`` defaults to ``env://`` where ``MASTER_ADDR``
    is set, else to ``tcp://127.0.0.1:<a free port>``, which serves a
    single process.  On CUDA, the process's current device becomes
    ``LOCAL_RANK`` (else the rank) modulo the visible devices."""
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
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A process group seen as a ``(data, model)`` mesh: ``rank`` and
    ``world`` are this process's place in ``group`` (``None``: the default
    group), ``device`` the device it computes on; ``data_index`` and
    ``model_index`` its place on each axis, ``data_group`` and
    ``model_group`` the groups of the ranks that share its ``model`` and
    ``data`` index, over which the axes' collectives run (the whole group
    where the other axis has one rank; ``None`` where the axis itself has
    one rank, whose collectives are skipped)."""

    group: Optional[dist.ProcessGroup]
    rank: int
    world: int
    device: torch.device
    data: int
    model: int = 1
    data_index: int = 0
    model_index: int = 0
    data_group: Optional[dist.ProcessGroup] = None
    model_group: Optional[dist.ProcessGroup] = None


def make_mesh(data: Optional[int] = None, model: int = 1, group: Optional[dist.ProcessGroup] = None,
              device=None) -> Mesh:
    """The ``(data, model)`` mesh over ``group`` (``None``: the default
    process group, which :func:`init_distributed` starts).  ``data``
    defaults to world // model.  Every rank of ``group`` calls this; where
    both axes are wider than one, each makes every ``data`` and ``model``
    sub-group, in the same order.  ``device`` defaults to the backend's
    (a CUDA card under NCCL, the CPU under Gloo); pass ``"cuda"`` for a
    Gloo group whose ranks compute on a card."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call init_distributed() first")
    world = dist.get_world_size(group)
    model = int(model)
    data = world // model if data is None else int(data)
    if model < 1 or data * model != world:
        raise ValueError(f"mesh {data}x{model} does not cover the group's {world} processes")
    if device is not None:
        device = resolve_device(device)
    elif dist.get_backend(group) == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    rank = dist.get_rank(group)
    whole = group if group is not None else dist.group.WORLD
    data_group = whole if model == 1 else None
    model_group = whole if data == 1 else None
    if data > 1 and model > 1:
        ranks = dist.get_process_group_ranks(group) if group is not None else list(range(world))
        for m in range(model):
            g = dist.new_group([ranks[d * model + m] for d in range(data)], use_local_synchronization=True)
            data_group = g if rank % model == m else data_group
        for d in range(data):
            g = dist.new_group(ranks[d * model:(d + 1) * model], use_local_synchronization=True)
            model_group = g if rank // model == d else model_group
    return Mesh(group=group, rank=rank, world=world, device=device, data=data, model=model,
                data_index=rank // model, model_index=rank % model, data_group=data_group,
                model_group=model_group)


def _global_rank(group: Optional[dist.ProcessGroup], rank: int) -> int:
    return rank if group is None else dist.get_global_rank(group, rank)


# ------------------------------------------------------------ placements
class Sharding(NamedTuple):
    """A tensor's placement on the mesh, ``jax.sharding.NamedSharding``'s
    counterpart: ``spec[i]`` names the mesh axis (``"data"`` or
    ``"model"``) that dimension ``i`` splits over, in equal contiguous
    blocks in axis-index order; ``None`` or a missing entry replicates."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...]

    def _axes(self):
        for dim, axis in enumerate(self.spec):
            if axis == "data" and self.mesh.data > 1:
                yield dim, self.mesh.data, self.mesh.data_index, self.mesh.data_group
            elif axis == "model" and self.mesh.model > 1:
                yield dim, self.mesh.model, self.mesh.model_index, self.mesh.model_group

    def blocks(self, shape) -> dict:
        """This rank's block of a global tensor of ``shape``: a slice for
        each dimension that splits (``ValueError`` where it does not split
        evenly)."""
        out = {}
        for dim, size, index, _ in self._axes():
            if shape[dim] % size:
                raise ValueError(f"dimension {dim} of {tuple(shape)} does not split evenly over {size} ranks")
            per = shape[dim] // size
            out[dim] = slice(index * per, (index + 1) * per)
        return out

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the global tensor ``x`` (a view)."""
        for dim, rows in self.blocks(x.shape).items():
            x = x.narrow(dim, rows.start, rows.stop - rows.start)
        return x

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global tensor (a new one) from every rank's block ``x``
        (collective over the axes ``spec`` names): each block is broadcast
        by its owner, so the result holds the blocks' exact bits on every
        rank."""
        out = x
        for dim, size, index, group in self._axes():
            blocks = []
            for i in range(size):
                block = out.contiguous() if i == index else torch.empty_like(out, memory_format=torch.contiguous_format)
                dist.broadcast(block, src=_global_rank(group, i), group=group)
                blocks.append(block)
            out = torch.cat(blocks, dim=dim)
        return out.clone() if out is x else out


def env_sharding(mesh: Mesh) -> Sharding:
    """Split the leading env axis over ``data``."""
    return Sharding(mesh, ("data",))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def local_slice(mesh: Mesh, n: int) -> slice:
    """This ``data`` index's envs of a batch of ``n`` (:func:`env_sharding`'s
    block): contiguous, ``n / data`` each."""
    return env_sharding(mesh).blocks((n,)).get(0, slice(0, n))


def shard_env_state(mesh: Mesh, state):
    """This rank's rows of an :class:`~mbt_gym_torch.types.EnvState`: every
    tensor whose leading axis is the env batch is sliced over ``data``;
    scalars stay; the generator becomes :func:`fold_in` of it with the
    ``data`` index, so each ``data`` index draws its own noise."""
    n = state.cash.shape[0]
    rows = local_slice(mesh, n)

    def place(x):
        if isinstance(x, torch.Tensor) and x.dim() >= 1 and x.shape[0] == n:
            return x[rows]
        if isinstance(x, tuple):
            return tuple(place(v) for v in x)
        return x

    key = None if state.key is None else make_generator(fold_in(state.key, mesh.data_index), state.key.device)
    return type(state)(*(place(v) for v in state))._replace(key=key)


# ------------------------------------------------------------ the model axis
_TOWERS = ("pi", "vf")


def mlp_sharding_specs(params) -> dict:
    """``mbt_gym_tpu/parallel/mesh.py:74-97``'s placement of the separate
    pi/vf towers over ``model``, leaf for leaf, each spec over the JAX
    leaf's dimensions (``w`` is ``(in, out)``, the transpose of
    ``nn.Linear.weight``): layer 0 column-sharded (``w`` ``(None,
    "model")``, ``b`` ``("model",)``), every later hidden layer
    row-sharded (``w`` ``("model", None)``, ``b`` replicated), the last
    layer row-sharded where the tower has hidden layers, ``log_std``
    replicated.  JAX's specs read ``params["pi"]`` and ``params["vf"]``, so
    a shared trunk has no placement: ``ValueError``."""
    if getattr(params, "shared_trunk", False):
        raise ValueError("the model axis shards the separate pi/vf towers (mbt_gym_tpu/parallel/mesh.py:74-97); "
                         "a shared trunk has no model placement: use shared_trunk=False, or model=1")

    def spec_for_mlp(mlp):
        specs = []
        last = len(mlp) - 1
        for i in range(len(mlp)):
            if i == 0 and last > 0:
                specs.append({"w": (None, "model"), "b": ("model",)})
            elif i < last:
                specs.append({"w": ("model", None), "b": ()})
            else:
                specs.append({"w": ("model", None) if last > 0 else (), "b": ()})
        return specs

    return {"pi": spec_for_mlp(params.pi), "vf": spec_for_mlp(params.vf), "log_std": ()}


def _leaf_specs(params):
    """``(nn.Linear, spec of its weight in its own (out, in) order, spec of
    its bias)`` for every layer of both towers."""
    specs = mlp_sharding_specs(params)
    for tower in _TOWERS:
        for layer, spec in zip(getattr(params, tower), specs[tower]):
            w = tuple(reversed(spec["w"] + (None,) * (2 - len(spec["w"]))))
            yield layer, w, spec["b"]


def sharded_parameter_names(params) -> set:
    """The names (as ``named_parameters`` gives them) of the leaves split
    over ``model``; empty on a model that :func:`shard_params` has not
    split."""
    if params.model_shards[1] == 1:
        return set()
    split = {id(p) for layer, w, b in _leaf_specs(params)
             for p, spec in ((layer.weight, w), (layer.bias, b)) if "model" in spec}
    return {name for name, p in params.named_parameters() if id(p) in split}


def shard_params(mesh: Mesh, params):
    """Broadcast rank 0's parameters (an ``nn.Module``, in place, as one
    flat buffer) to every rank of the mesh; with ``model > 1``, each rank
    then keeps its slices of the towers (:func:`mlp_sharding_specs`), in
    place: the parameter objects stay, so an optimizer built over them
    steps the slices, provided it has not stepped yet.  A shared trunk on
    ``model > 1``, or a width that does not split evenly, raises
    ``ValueError`` before any collective.  Returns ``params``."""
    if mesh.model > 1:
        for layer, w, b in _leaf_specs(params):
            for leaf, spec in ((layer.weight, w), (layer.bias, b)):
                Sharding(mesh, spec).local(leaf)  # raises on an uneven split
    tensors = [p.data for p in params.parameters()]
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.broadcast(flat, src=_global_rank(mesh.group, 0), group=mesh.group)
    start = 0
    for t in tensors:
        t.copy_(flat[start:start + t.numel()].view_as(t))
        start += t.numel()
    if mesh.model > 1:
        for layer, w, b in _leaf_specs(params):
            layer.weight.data = Sharding(mesh, w).local(layer.weight.data).contiguous()
            layer.bias.data = Sharding(mesh, b).local(layer.bias.data).contiguous()
            layer.out_features, layer.in_features = layer.weight.shape
        params.model_shards = (mesh.model_index, mesh.model)
    return params


def _gather_leaves(mesh: Mesh, params, tensors) -> list:
    """The global tensors of ``tensors`` (one per parameter of the sharded
    ``params``, in ``parameters()`` order: the parameters themselves or
    per-parameter optimizer state)."""
    spec = {}
    for layer, w, b in _leaf_specs(params):
        spec[id(layer.weight)], spec[id(layer.bias)] = w, b
    return [Sharding(mesh, spec.get(id(p), ())).gather(t.detach()) for p, t in zip(params.parameters(), tensors)]


def gather_params(mesh: Mesh, params):
    """The whole model from every ``model`` rank's slices (collective over
    ``model``): a new module, alike on every rank, bit for bit the
    parameters each slice came from — the counterpart of reading a
    GSPMD-sharded array as a global one.  An unsplit model comes back as a
    copy."""
    whole = copy.deepcopy(params)
    if params.model_shards[1] == 1:
        return whole
    full = _gather_leaves(mesh, params, list(params.parameters()))
    with torch.no_grad():
        for p, value in zip(whole.parameters(), full):
            p.data = value
    for tower in _TOWERS:
        for layer in getattr(whole, tower):
            layer.out_features, layer.in_features = layer.weight.shape
    whole.model_shards = (0, 1)
    return whole


def gather_train_state(mesh: Mesh, train_state):
    """A PPO train state with :func:`gather_params`' whole model and an
    Adam over it whose moments are gathered the same way (the step count
    and the hyperparameters as they are): what one process would hold.
    ``train_state`` is returned as it is when its model is not split."""
    params, opt = train_state.params, train_state.opt_state
    if params.model_shards[1] == 1:
        return train_state
    whole = gather_params(mesh, params)
    new_opt = type(opt)(whole.parameters())
    new_opt.param_groups[0].update({k: v for k, v in opt.param_groups[0].items() if k != "params"})
    state = {}
    plist = list(params.parameters())
    if all(p in opt.state for p in plist):
        moments = {key: _gather_leaves(mesh, params, [opt.state[p][key] for p in plist])
                   for key in opt.state[plist[0]] if key != "step"}
        state = {i: dict({key: moments[key][i] for key in moments}, step=opt.state[p]["step"].clone())
                 for i, p in enumerate(plist)}
    new_opt.load_state_dict({"state": state, "param_groups": new_opt.state_dict()["param_groups"]})
    return train_state._replace(params=whole, opt_state=new_opt)


class _CopyToModel(torch.autograd.Function):
    """Megatron's ``f``: identity forward, SUM all-reduce of the gradient
    over the ``model`` group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's ``g``: SUM all-reduce over the ``model`` group forward,
    identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x``, replicated on the ``model`` ranks, as the input of a
    model-parallel layer: the ranks' gradients of it are summed."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the ``model`` ranks of their partial results ``x``."""
    return _ReduceFromModel.apply(x, group)


def clip_norm_squared(squares, sharded, group) -> torch.Tensor:
    """The squared global norm of a model's gradients from each leaf's sum
    of squares: the replicated leaves' sum plus the SUM all-reduce over
    ``model`` of the split leaves' (``sharded`` flags them)."""
    split = sum((s for s, flag in zip(squares, sharded) if flag), torch.zeros_like(squares[0])).reshape(1)
    dist.all_reduce(split, op=dist.ReduceOp.SUM, group=group)
    return sum((s for s, flag in zip(squares, sharded) if not flag), split[0])


# ------------------------------------------------------------ the data axis
def all_reduce_mean(mesh: Mesh, flat: torch.Tensor) -> torch.Tensor:
    """The mean over the ``data`` ranks of a flat float buffer, in place:
    one SUM all-reduce over the ``data`` group (every rank gets the same
    bits), then a division by the ``data`` size; nothing where the axis has
    no group (one ``data`` index beside ``model > 1``)."""
    if mesh.data_group is None:
        return flat
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.data_group)
    return flat.div_(mesh.data)


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
    of ``jax.random.fold_in(key, axis_index)`` (``ppo.py:317-319``); the
    learner folds in the ``data`` index.  Index 0 keeps the key itself, so
    a one-index mesh draws what the meshless call draws; index r > 0 gets
    the int seed splitmix64(:func:`key_seed`, r)."""
    if rank == 0:
        return key
    return _mix(key_seed(key), rank)


def shared_key(key) -> int:
    """An int seed alike on every rank and apart from every rank's
    :func:`fold_in` stream (the engine path's shuffle)."""
    return _mix(key_seed(key), -1)
