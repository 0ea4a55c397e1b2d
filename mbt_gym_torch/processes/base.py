"""Stochastic-process protocol (counterpart of ``mbt_gym_tpu/processes/base.py``).

A process is a hashable frozen dataclass of parameters exposing pure
functions over ``(N, d)`` state tensors.  Randomness arrives as explicit
noise columns (:class:`mbt_gym_torch.types.SlotNoise`), drawn natively from
a ``torch.Generator`` or injected by a harness for reference-exact replay.

Protocol:

- ``state_dim: int`` — state columns this process adds to the observation.
- ``noise_spec() -> (n_normal, n_uniform)`` — per-step noise columns consumed.
- ``initial_state(n, dtype, device) -> (n, state_dim)`` tensor.
- ``bounds() -> (low, high)`` tuples of length ``state_dim``.
- ``update(state, arrivals, fills, action, noise, dt) -> (n, state_dim)``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


def process_dataclass(cls):
    """Decorator: frozen (hence hashable) parameter dataclass."""
    return dataclasses.dataclass(frozen=True)(cls)


class ProcessBase:
    """Mixin with shared defaults for zero-state, zero-noise processes."""

    state_dim: int = 0

    def noise_spec(self) -> Tuple[int, int]:
        """(num_normal_columns, num_uniform_columns) consumed per step."""
        return (0, 0)

    def initial_state(self, n: int, dtype=torch.float32, device=None) -> torch.Tensor:
        return torch.zeros((n, self.state_dim), dtype=dtype, device=device)

    def bounds(self) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
        return ((), ())

    def update(self, state, arrivals, fills, action, noise, dt: float) -> torch.Tensor:
        return state
