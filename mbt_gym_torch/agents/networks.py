"""MLP policy/value networks (counterpart of ``mbt_gym_tpu/agents/networks.py``).

:class:`ActorCritic` is an ``nn.Module`` holding either layout of the JAX
package's actor-critic:

- separate pi/vf towers (the default, the reference's SB3 convention,
  experiments/helpers.py:69-72): ``pi`` and ``vf`` are ``nn.ModuleList``s
  of ``nn.Linear`` layers, the last one the head;
- ``shared_trunk=True``: one ``shared`` trunk with tanh after every layer
  and the linear heads ``pi_head`` / ``vf_head``.

``nn.Linear`` stores its weight as ``(out, in)``, the transpose of the JAX
package's ``(in, out)`` ``w``; :func:`mbt_gym_torch.convert.actor_critic_from_numpy`
and ``actor_critic_to_numpy`` carry weights across.  ``log_std`` is a
parameter of shape ``(A,)``.

``compute_dtype`` follows ``mlp_apply`` (networks.py:34-50): inputs,
weights and biases are cast to it (bfloat16 in production), every matmul,
bias add and tanh runs in it, master parameters stay float32 and the
output is cast back to the input's dtype.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from mbt_gym_torch.env import make_generator, resolve_device

_LOG_2PI = math.log(2.0 * math.pi)

DType = Union[None, str, torch.dtype]


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


def policy_value(params: ActorCritic, obs: torch.Tensor, compute_dtype: DType = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(policy mean ``(.., A)``, value ``(..,)``) in one pass."""
    cdt = as_dtype(compute_dtype)
    if params.shared_trunk:
        h = _trunk_apply(params.shared, obs, cdt)
        mean = _linear(params.pi_head, h, cdt).to(obs.dtype)
        v = _linear(params.vf_head, h, cdt).to(obs.dtype)[..., 0]
        return mean, v
    return mlp_apply(params.pi, obs, cdt), mlp_apply(params.vf, obs, cdt)[..., 0]


def policy_mean(params: ActorCritic, obs: torch.Tensor, compute_dtype: DType = None) -> torch.Tensor:
    cdt = as_dtype(compute_dtype)
    if params.shared_trunk:
        return _linear(params.pi_head, _trunk_apply(params.shared, obs, cdt), cdt).to(obs.dtype)
    return mlp_apply(params.pi, obs, cdt)


def value(params: ActorCritic, obs: torch.Tensor, compute_dtype: DType = None) -> torch.Tensor:
    cdt = as_dtype(compute_dtype)
    if params.shared_trunk:
        h = _trunk_apply(params.shared, obs, cdt)
        return _linear(params.vf_head, h, cdt).to(obs.dtype)[..., 0]
    return mlp_apply(params.vf, obs, cdt)[..., 0]


def gaussian_log_prob(params: ActorCritic, mean: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """Diagonal-Gaussian log-density, networks.py:151-154's formula."""
    log_std = params.log_std
    z = (action - mean) * torch.exp(-log_std)
    return torch.sum(-0.5 * z**2 - log_std - 0.5 * _LOG_2PI, dim=-1)


def entropy(params: ActorCritic) -> torch.Tensor:
    return torch.sum(params.log_std + 0.5 * math.log(2 * math.pi * math.e))
