"""Carry configs, states and agents into the port from plain Python values.

The port never sees a JAX object.  A caller (the parity tests do) turns a
config of the JAX package into a *spec*: nested dicts of plain values, each
component written as ``{"type": <class name>, <field>: <value>, ...}`` —
the same class and field names in both packages.  Tuples may arrive as
lists.

- :func:`env_config_from_spec` rebuilds an :class:`EnvConfig` with its
  processes, dynamics and reward;
- :func:`env_state_from_numpy` builds an :class:`EnvState` from arrays;
- :func:`as_agent_from_spec` rebuilds the AS agent.

A type that the port has not ported yet raises ``ValueError`` naming it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from mbt_gym_torch.agents.baseline import AvellanedaStoikovAgent
from mbt_gym_torch.dynamics import LimitOrderDynamics
from mbt_gym_torch.env import EnvConfig, make_generator, resolve_device
from mbt_gym_torch.processes.arrivals import PoissonArrivals
from mbt_gym_torch.processes.fills import ExponentialFill
from mbt_gym_torch.processes.midprice import BrownianMotionMidprice
from mbt_gym_torch.rewards import PnL
from mbt_gym_torch.types import EnvState

_COMPONENTS = {
    cls.__name__: cls
    for cls in (BrownianMotionMidprice, PoissonArrivals, ExponentialFill, LimitOrderDynamics, PnL)
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


def as_agent_from_spec(spec: dict) -> AvellanedaStoikovAgent:
    """Rebuild the AS agent from ``{"type": "AvellanedaStoikovAgent", ...}``."""
    spec = dict(spec)
    name = spec.pop("type", "AvellanedaStoikovAgent")
    if name != "AvellanedaStoikovAgent":
        raise ValueError(f"{name} is not ported to mbt_gym_torch yet")
    return AvellanedaStoikovAgent(**spec)


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
