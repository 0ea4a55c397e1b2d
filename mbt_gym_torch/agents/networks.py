"""MLP policy/value networks (counterpart of ``mbt_gym_tpu/agents/networks.py``).

:class:`ActorCritic` is an ``nn.Module`` holding either layout of the JAX
package's actor-critic:

- separate pi/vf towers (the default, the reference's SB3 convention,
  experiments/helpers.py:69-72): ``pi`` and ``vf`` are ``nn.ModuleList``s
  of ``nn.Linear`` layers, the last one the head;
- ``shared_trunk=True``: one ``shared`` trunk with tanh after every layer
  and the linear heads ``pi_head`` / ``vf_head``.

A plain MLP (REINFORCE's policy mean) is an ``nn.ModuleList`` of
``nn.Linear`` from :func:`init_mlp`, run by :func:`mlp_apply`.

``nn.Linear`` stores its weight as ``(out, in)``, the transpose of the JAX
package's ``(in, out)`` ``w``; :func:`mbt_gym_torch.convert.actor_critic_from_numpy`
and ``actor_critic_to_numpy`` (``mlp_from_numpy`` / ``mlp_to_numpy`` for a
plain MLP) carry weights across.  ``log_std`` is a
parameter of shape ``(A,)``.

``compute_dtype`` follows ``mlp_apply`` (networks.py:34-50): inputs,
weights and biases are cast to it (bfloat16 in production), every matmul,
bias add and tanh runs in it, master parameters stay float32 and the
output is cast back to the input's dtype.

Towers split over a mesh's ``model`` axis
(:func:`mbt_gym_torch.parallel.mesh.shard_params`; ``model_shards`` is
``(this rank's model index, the model size)``, ``(0, 1)`` on a whole
model) run tensor-parallel in :func:`policy_value`, :func:`policy_mean`
and :func:`value`, which then take the mesh's ``model_group``: layer 0
column-parallel, every later layer row-parallel (a partial product, a SUM
all-reduce over ``model``, the replicated bias), a row-parallel layer
whose input is replicated reading this rank's slice of it.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from mbt_gym_torch.env import make_generator, resolve_device

_LOG_2PI = math.log(2.0 * math.pi)

DType = Union[None, str, torch.dtype]

# The JAX package's ``MlpParams`` (a list of {"w", "b"} layers) is an
# ``nn.ModuleList`` of ``nn.Linear`` here.
MlpParams = nn.ModuleList


def as_dtype(compute_dtype: DType) -> Optional[torch.dtype]:
    """``None``, a dtype name (``"bfloat16"``) or a ``torch.dtype``."""
    if compute_dtype is None or isinstance(compute_dtype, torch.dtype):
        return compute_dtype
    return getattr(torch, compute_dtype)


def _fill_normal(layer: nn.Linear, scale: float, gen: torch.Generator) -> None:
    """``scale`` times standard normals drawn as the JAX ``(in, out)``
    matrix, zero bias."""
    shape = (layer.in_features, layer.out_features)
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    layer.weight.copy_((scale * w).T)
    layer.bias.zero_()


def init_mlp(key, sizes: Sequence[int], device=None, dtype: torch.dtype = torch.float32) -> nn.ModuleList:
    """networks.py:19-31: an MLP over ``[in, h1, ..., out]`` as an
    ``nn.ModuleList`` of ``nn.Linear``, each layer's weights scaled normals
    (``sqrt(2 / fan_in)``, ``0.01`` on the last layer) drawn layer by layer
    from ``key`` (an int seed or a ``torch.Generator``), biases zero.
    :func:`mlp_apply` runs it; :func:`mbt_gym_torch.convert.mlp_from_numpy`
    builds one from the JAX package's ``MlpParams``."""
    device = resolve_device(device)
    gen = make_generator(key, device)
    layers = nn.ModuleList(
        nn.utils.skip_init(nn.Linear, i, o, device=device, dtype=dtype) for i, o in zip(sizes[:-1], sizes[1:])
    )
    with torch.no_grad():
        for i, lin in enumerate(layers):
            _fill_normal(lin, math.sqrt(2.0 / lin.in_features) if i < len(layers) - 1 else 0.01, gen)
    return layers


class ActorCritic(nn.Module):
    """Gaussian actor-critic with a state-independent ``log_std``.  Build it
    with :func:`init_actor_critic` or from JAX parameters with
    :func:`mbt_gym_torch.convert.actor_critic_from_numpy`."""

    def __init__(self, obs_dim: int, action_dim: int, hidden: Sequence[int] = (256, 256),
                 shared_trunk: bool = False, device=None):
        super().__init__()
        self.obs_dim, self.action_dim = int(obs_dim), int(action_dim)
        self.hidden = tuple(int(h) for h in hidden)
        self.shared_trunk = bool(shared_trunk)
        sizes = (self.obs_dim, *self.hidden)
        # uninitialised: init_actor_critic and the converter fill every value
        linear = lambda i, o: nn.utils.skip_init(nn.Linear, i, o, device=device)  # noqa: E731
        if self.shared_trunk:
            self.shared = nn.ModuleList(linear(i, o) for i, o in zip(sizes[:-1], sizes[1:]))
            self.pi_head = linear(self.hidden[-1], self.action_dim)
            self.vf_head = linear(self.hidden[-1], 1)
        else:
            self.pi = nn.ModuleList(
                linear(i, o) for i, o in zip(sizes, (*self.hidden, self.action_dim))
            )
            self.vf = nn.ModuleList(linear(i, o) for i, o in zip(sizes, (*self.hidden, 1)))
        self.log_std = nn.Parameter(torch.zeros(self.action_dim, device=device))
        self.model_shards = (0, 1)


def init_actor_critic(
    key,
    obs_dim: int,
    action_dim: int,
    hidden: Sequence[int] = (256, 256),
    init_log_std: float = -0.5,
    shared_trunk: bool = False,
    device=None,
) -> ActorCritic:
    """networks.py:53-90 with draws from ``key`` (an int seed or a
    ``torch.Generator``): the trunk layers, then the pi head, then the vf
    head (shared trunk), or the pi tower, then the vf tower."""
    device = resolve_device(device)
    gen = make_generator(key, device)
    model = ActorCritic(obs_dim, action_dim, hidden, shared_trunk, device=device)
    # init_mlp's scales (networks.py:19-31): sqrt(2 / fan_in) for hidden
    # layers, 0.01 for the output layers
    if shared_trunk:
        scaled = [(lin, math.sqrt(2.0 / lin.in_features)) for lin in model.shared]
        scaled += [(model.pi_head, 0.01), (model.vf_head, 0.01)]
    else:
        scaled = [
            (lin, math.sqrt(2.0 / lin.in_features) if i < len(tower) - 1 else 0.01)
            for tower in (model.pi, model.vf) for i, lin in enumerate(tower)
        ]
    with torch.no_grad():
        for lin, scale in scaled:
            _fill_normal(lin, scale, gen)
        model.log_std.fill_(init_log_std)
    return model


def _linear(layer: nn.Linear, x: torch.Tensor, cdt: Optional[torch.dtype]) -> torch.Tensor:
    w, b = layer.weight, layer.bias
    if cdt is not None:
        w, b = w.to(cdt), b.to(cdt)
    return x @ w.T + b


def mlp_apply(layers: nn.ModuleList, x: torch.Tensor, compute_dtype: DType = None) -> torch.Tensor:
    """A tower: tanh after every layer but the last; the output in the
    input's dtype."""
    cdt = as_dtype(compute_dtype)
    out_dtype = x.dtype
    if cdt is not None:
        x = x.to(cdt)
    for i, layer in enumerate(layers):
        x = _linear(layer, x, cdt)
        if i < len(layers) - 1:
            x = torch.tanh(x)
    return x.to(out_dtype)


def _trunk_apply(layers: nn.ModuleList, x: torch.Tensor, cdt) -> torch.Tensor:
    """tanh after EVERY layer; the result stays in ``cdt`` for the heads."""
    if cdt is not None:
        x = x.to(cdt)
    for layer in layers:
        x = torch.tanh(_linear(layer, x, cdt))
    return x


def _tensor_parallel_apply(layers: nn.ModuleList, x: torch.Tensor, cdt, index: int, group) -> torch.Tensor:
    """:func:`mlp_apply` of a tower split over ``model``
    (``mbt_gym_tpu/parallel/mesh.py:74-97``'s placement): layer 0
    column-parallel, its output this rank's features; every later layer
    row-parallel, its replicated input first cut to this rank's features
    (whose gradient the ranks then sum: a gather of the slices)."""
    from mbt_gym_torch.parallel.mesh import copy_to_model, reduce_from_model

    if len(layers) == 1:  # no hidden layer: the layer is replicated
        return mlp_apply(layers, x, cdt)
    out_dtype = x.dtype
    if cdt is not None:
        x = x.to(cdt)
    for i, layer in enumerate(layers):
        w, b = layer.weight, layer.bias
        if cdt is not None:
            w, b = w.to(cdt), b.to(cdt)
        if i == 0:
            x = copy_to_model(x, group) @ w.T + b
        else:
            if i > 1:
                width = layer.in_features
                x = copy_to_model(x, group).narrow(-1, index * width, width)
            x = reduce_from_model(x @ w.T, group) + b
        if i < len(layers) - 1:
            x = torch.tanh(x)
    return x.to(out_dtype)


def _towers(params: ActorCritic, model_group):
    """The tower function for ``params``: :func:`mlp_apply`, or its
    tensor-parallel form over ``model_group`` on a split model."""
    index, count = params.model_shards
    if count == 1:
        return mlp_apply
    if model_group is None:
        raise ValueError(f"the towers are split over {count} model ranks: pass the mesh's model_group")
    return lambda layers, x, cdt: _tensor_parallel_apply(layers, x, cdt, index, model_group)


def policy_value(params: ActorCritic, obs: torch.Tensor, compute_dtype: DType = None, model_group=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(policy mean ``(.., A)``, value ``(..,)``) in one pass;
    ``model_group`` is the mesh's on towers split over ``model``."""
    cdt = as_dtype(compute_dtype)
    if params.shared_trunk:
        h = _trunk_apply(params.shared, obs, cdt)
        mean = _linear(params.pi_head, h, cdt).to(obs.dtype)
        v = _linear(params.vf_head, h, cdt).to(obs.dtype)[..., 0]
        return mean, v
    tower = _towers(params, model_group)
    return tower(params.pi, obs, cdt), tower(params.vf, obs, cdt)[..., 0]


def policy_mean(params: ActorCritic, obs: torch.Tensor, compute_dtype: DType = None,
                model_group=None) -> torch.Tensor:
    cdt = as_dtype(compute_dtype)
    if params.shared_trunk:
        return _linear(params.pi_head, _trunk_apply(params.shared, obs, cdt), cdt).to(obs.dtype)
    return _towers(params, model_group)(params.pi, obs, cdt)


def value(params: ActorCritic, obs: torch.Tensor, compute_dtype: DType = None, model_group=None) -> torch.Tensor:
    cdt = as_dtype(compute_dtype)
    if params.shared_trunk:
        h = _trunk_apply(params.shared, obs, cdt)
        return _linear(params.vf_head, h, cdt).to(obs.dtype)[..., 0]
    return _towers(params, model_group)(params.vf, obs, cdt)[..., 0]


def sample_action(params: ActorCritic, obs: torch.Tensor, key) -> Tuple[torch.Tensor, torch.Tensor]:
    """A Gaussian policy sample and its log-prob (diagonal,
    state-independent std; networks.py:141-148): ``mean + exp(log_std) *
    eps``, ``eps`` standard normals drawn from ``key`` (an int seed or a
    ``torch.Generator`` on ``obs``'s device)."""
    mean = policy_mean(params, obs)
    std = torch.exp(params.log_std)
    gen = make_generator(key, obs.device)
    eps = torch.randn(mean.shape, generator=gen, dtype=mean.dtype, device=obs.device)
    action = mean + std * eps
    return action, gaussian_log_prob(params, mean, action)


def gaussian_log_prob(params: ActorCritic, mean: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """Diagonal-Gaussian log-density, networks.py:151-154's formula."""
    log_std = params.log_std
    z = (action - mean) * torch.exp(-log_std)
    return torch.sum(-0.5 * z**2 - log_std - 0.5 * _LOG_2PI, dim=-1)


def entropy(params: ActorCritic) -> torch.Tensor:
    return torch.sum(params.log_std + 0.5 * math.log(2 * math.pi * math.e))
