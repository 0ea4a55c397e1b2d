"""Carry configs, states and agents into the port from plain Python values.

The port never sees a JAX object.  A caller (the parity tests do) turns a
config of the JAX package into a *spec*: nested dicts of plain values, each
component written as ``{"type": <class name>, <field>: <value>, ...}`` —
the same class and field names in both packages.  Tuples may arrive as
lists.

- :func:`env_config_from_spec` rebuilds an :class:`EnvConfig` with its
  processes, dynamics and reward;
- :func:`env_state_from_numpy` builds an :class:`EnvState` from arrays;
- :func:`as_agent_from_spec`, :func:`cj_mm_agent_from_spec` and
  :func:`cj_oe_agent_from_spec` rebuild the closed-form agents (the CJ
  agents' depth tables and schedules are computed from these fields, so
  they are this slice's "weights");
- :func:`ppo_config_from_spec` rebuilds a :class:`~mbt_gym_torch.agents.ppo.PPOConfig`;
- :func:`actor_critic_from_numpy` / :func:`actor_critic_to_numpy` carry
  actor-critic parameters across as the JAX package's params pytree of
  numpy arrays (``w`` is ``(in, out)`` there and ``(out, in)`` in
  ``nn.Linear``), and :func:`mlp_from_numpy` / :func:`mlp_to_numpy` a
  plain MLP (``MlpParams``, REINFORCE's policy).

A type the port does not know raises ``ValueError`` naming it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from mbt_gym_torch.agents.baseline import (
    AvellanedaStoikovAgent,
    CarteaJaimungalMmAgent,
    CarteaJaimungalOeAgent,
)
from mbt_gym_torch.agents.networks import ActorCritic
from mbt_gym_torch.dynamics import (
    AtTheTouchDynamics,
    LimitAndMarketOrderDynamics,
    LimitOrderDynamics,
    TradingWithSpeedDynamics,
)
from mbt_gym_torch.env import EnvConfig, make_generator, resolve_device
from mbt_gym_torch import processes
from mbt_gym_torch.rewards import (
    CjMmCriterion,
    CjOeCriterion,
    ExponentialUtility,
    PnL,
    RunningInventoryPenalty,
)
from mbt_gym_torch.types import EnvState

_COMPONENTS = {
    cls.__name__: cls
    for cls in (
        *(getattr(processes, name) for name in dir(processes) if name[0].isupper() and name != "ProcessBase"),
        LimitOrderDynamics, AtTheTouchDynamics, LimitAndMarketOrderDynamics,
        TradingWithSpeedDynamics,
        PnL, RunningInventoryPenalty, CjMmCriterion, CjOeCriterion, ExponentialUtility,
    )
}


def _plain(value):
    """Lists become tuples, so the rebuilt frozen dataclasses hash."""
    if isinstance(value, list):
        return tuple(_plain(v) for v in value)
    return value


def _component(spec: Optional[dict]):
    if spec is None:
        return None
    spec = dict(spec)
    name = spec.pop("type")
    if name not in _COMPONENTS:
        raise ValueError(f"{name} is not ported to mbt_gym_torch yet")
    return _COMPONENTS[name](
        **{k: (_component(v) if isinstance(v, dict) else _plain(v)) for k, v in spec.items()}
    )


def env_config_from_spec(spec: dict) -> EnvConfig:
    """Rebuild an :class:`EnvConfig` from its spec (the config's fields,
    with ``dynamics`` and ``reward_function`` as component specs)."""
    fields = {f.name for f in dataclasses.fields(EnvConfig)}
    unknown = set(spec) - fields
    if unknown:
        raise ValueError(f"unknown EnvConfig fields {sorted(unknown)}")
    kwargs = {
        k: (_component(v) if isinstance(v, dict) else _plain(v)) for k, v in spec.items()
    }
    return EnvConfig(**kwargs)


def _agent_from_spec(cls, spec: dict):
    spec = dict(spec)
    name = spec.pop("type", cls.__name__)
    if name != cls.__name__:
        raise ValueError(f"{name} is not a {cls.__name__} spec")
    return cls(**{k: _plain(v) for k, v in spec.items()})


def as_agent_from_spec(spec: dict) -> AvellanedaStoikovAgent:
    """Rebuild the AS agent from ``{"type": "AvellanedaStoikovAgent", ...}``."""
    return _agent_from_spec(AvellanedaStoikovAgent, spec)


def cj_mm_agent_from_spec(spec: dict) -> CarteaJaimungalMmAgent:
    """Rebuild the CJ market-making agent from
    ``{"type": "CarteaJaimungalMmAgent", ...}``."""
    return _agent_from_spec(CarteaJaimungalMmAgent, spec)


def cj_oe_agent_from_spec(spec: dict) -> CarteaJaimungalOeAgent:
    """Rebuild the CJ optimal-execution agent from
    ``{"type": "CarteaJaimungalOeAgent", ...}``."""
    return _agent_from_spec(CarteaJaimungalOeAgent, spec)


def env_state_from_numpy(
    cash,
    inventory,
    time,
    process_states: Sequence,
    step: int = 0,
    initial_inventory=None,
    start_time: float = 0.0,
    clip_events: int = 0,
    key=None,
    dtype: str = "float32",
    device=None,
) -> EnvState:
    """An :class:`EnvState` from numpy arrays (``(N,)`` state vectors,
    ``(N, d_i)`` process states).  ``key`` is an optional int seed or
    ``torch.Generator`` for native noise."""
    device = resolve_device(device)
    tdtype = getattr(torch, dtype)

    def t(x):
        return torch.tensor(np.asarray(x), dtype=tdtype, device=device)

    initial = inventory if initial_inventory is None else initial_inventory
    return EnvState(
        cash=t(cash),
        inventory=t(inventory),
        time=t(time),
        process_states=tuple(t(p) for p in process_states),
        step=torch.tensor(step, dtype=torch.int32, device=device),
        key=None if key is None else make_generator(key, device),
        initial_inventory=t(initial),
        start_time=t(start_time),
        clip_events=torch.tensor(clip_events, dtype=torch.int32, device=device),
    )


def ppo_config_from_spec(spec: dict):
    """A :class:`~mbt_gym_torch.agents.ppo.PPOConfig` from its fields
    (``{"type": "PPOConfig", ...}`` or the bare fields)."""
    from mbt_gym_torch.agents.ppo import PPOConfig

    spec = dict(spec)
    spec.pop("type", None)
    fields = {f.name for f in dataclasses.fields(PPOConfig)}
    unknown = set(spec) - fields
    if unknown:
        raise ValueError(f"unknown PPOConfig fields {sorted(unknown)}")
    return PPOConfig(**{k: _plain(v) for k, v in spec.items()})


def _layers_from_numpy(layers, model_layers, device) -> None:
    for layer, lin in zip(layers, model_layers):
        lin.weight.copy_(torch.tensor(np.asarray(layer["w"]), dtype=torch.float32, device=device).T)
        lin.bias.copy_(torch.tensor(np.asarray(layer["b"]), dtype=torch.float32, device=device))


def mlp_from_numpy(layers, device=None) -> torch.nn.ModuleList:
    """A plain MLP (:func:`mbt_gym_torch.agents.networks.init_mlp`'s
    ``nn.ModuleList`` of ``nn.Linear``) from the JAX package's ``MlpParams``:
    a list of ``{"w": (in, out), "b": (out,)}`` numpy arrays."""
    device = resolve_device(device)
    model = torch.nn.ModuleList(
        torch.nn.utils.skip_init(torch.nn.Linear, *np.shape(layer["w"]), device=device) for layer in layers
    )
    with torch.no_grad():
        _layers_from_numpy(layers, model, device)
    return model


def mlp_to_numpy(model: torch.nn.ModuleList) -> list:
    """The JAX package's ``MlpParams`` of a plain MLP, as numpy arrays."""
    return [
        {"w": lin.weight.detach().float().cpu().numpy().T.copy(), "b": lin.bias.detach().float().cpu().numpy().copy()}
        for lin in model
    ]


def actor_critic_from_numpy(tree: dict, device=None) -> ActorCritic:
    """An :class:`ActorCritic` from the JAX params pytree as nested dicts
    and lists of numpy arrays: ``{"shared": [{"w", "b"}, ...], "pi_head",
    "vf_head", "log_std"}`` or ``{"pi": [...], "vf": [...], "log_std"}``."""
    device = resolve_device(device)
    shared = "shared" in tree
    if shared:
        trunk = tree["shared"]
        obs_dim = np.shape(trunk[0]["w"])[0]
        hidden = [np.shape(layer["w"])[1] for layer in trunk]
        action_dim = np.shape(tree["pi_head"]["w"])[1]
    else:
        obs_dim = np.shape(tree["pi"][0]["w"])[0]
        hidden = [np.shape(layer["w"])[1] for layer in tree["pi"][:-1]]
        action_dim = np.shape(tree["pi"][-1]["w"])[1]
    model = ActorCritic(obs_dim, action_dim, hidden, shared_trunk=shared, device=device)
    with torch.no_grad():
        if shared:
            _layers_from_numpy(tree["shared"], model.shared, device)
            _layers_from_numpy([tree["pi_head"], tree["vf_head"]], [model.pi_head, model.vf_head], device)
        else:
            _layers_from_numpy(tree["pi"], model.pi, device)
            _layers_from_numpy(tree["vf"], model.vf, device)
        model.log_std.copy_(torch.tensor(np.asarray(tree["log_std"]), dtype=torch.float32, device=device))
    return model


def actor_critic_to_numpy(model: ActorCritic, named: Optional[dict] = None) -> dict:
    """The JAX params pytree of ``model``, as numpy arrays.  With ``named``
    (a ``{parameter name: tensor}`` dict in ``model.named_parameters()``'s
    names, such as the grads of :func:`mbt_gym_torch.ops.fused_ppo.ppo_fused_grads_T`)
    the tree holds those tensors instead of the parameters."""
    values = dict(model.named_parameters()) if named is None else named

    def arr(name):
        return values[name].detach().float().cpu().numpy().copy()

    def layer(prefix):
        return {"w": arr(f"{prefix}.weight").T.copy(), "b": arr(f"{prefix}.bias")}

    out = {"log_std": arr("log_std")}
    if model.shared_trunk:
        out["shared"] = [layer(f"shared.{i}") for i in range(len(model.shared))]
        out["pi_head"] = layer("pi_head")
        out["vf_head"] = layer("vf_head")
    else:
        out["pi"] = [layer(f"pi.{i}") for i in range(len(model.pi))]
        out["vf"] = [layer(f"vf.{i}") for i in range(len(model.vf))]
    return out
