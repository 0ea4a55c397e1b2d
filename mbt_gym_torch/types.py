"""Core state types and index conventions (counterpart of
``mbt_gym_tpu/types.py``).

Runtime state is a structure of ``(N,)`` tensors, one per state column,
with the observation contract of the reference's ``(N, S)`` state matrix
(``mbt_gym/gym/index_names.py:1-7``) rebuilt by :func:`mbt_gym_torch.env.observe`.
The one change from the JAX package: ``EnvState.key`` is a
``torch.Generator`` on the state's device, consumed in order, instead of a
counter-based PRNG key.
"""
from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

# Observation column convention (parity with mbt_gym/gym/index_names.py:1-7).
CASH_INDEX = 0
INVENTORY_INDEX = 1
TIME_INDEX = 2
ASSET_PRICE_INDEX = 3

# Bid/ask column convention for arrivals/fills/depths arrays of shape (N, 2).
BID_INDEX = 0
ASK_INDEX = 1


class EnvState(NamedTuple):
    """Per-step environment state; leading axis = envs.

    Mirrors the information content of the reference's state matrix
    (``mbt_gym/gym/TradingEnvironment.py:196-216``) plus the bits the
    reference keeps in Python-object attributes (reward-function aux state,
    RNG, step counter).
    """

    cash: torch.Tensor  # (N,)
    inventory: torch.Tensor  # (N,)
    time: torch.Tensor  # (N,)
    process_states: Tuple[torch.Tensor, ...]  # each (N, d_i); d_i may be 0
    step: torch.Tensor  # () int32 — steps taken since reset
    key: Optional[torch.Generator]  # native-mode noise source, consumed in order
    # Reward aux captured at reset (CjMm/CjOe criteria; RewardFunctions.py:72-74,111-113)
    initial_inventory: torch.Tensor  # (N,)
    start_time: torch.Tensor  # ()
    # Diagnostics: number of steps with a cash/inventory clip so far (the
    # reference prints a warning instead: TradingEnvironment.py:283-297).
    clip_events: torch.Tensor  # () int32


class SlotNoise(NamedTuple):
    """Noise consumed by one stochastic-process slot in one env step:
    ``normal``/``uniform`` are ``(N, k)`` tensors or None, as the process's
    ``noise_spec`` declares."""

    normal: Optional[torch.Tensor]
    uniform: Optional[torch.Tensor]


# Noise for all active process slots of one env step, in slot order
# (midprice, arrival, fill, impact) — matching the reference's state layout
# and seeding enumeration (TradingEnvironment.py:303-318,345-348).
StepNoise = Tuple[SlotNoise, ...]


class StepResult(NamedTuple):
    state: EnvState
    obs: torch.Tensor  # (N, S)
    reward: torch.Tensor  # (N,)
    done: torch.Tensor  # (N,) bool — all-or-nothing (TradingEnvironment.py:218-220)


class Trajectory(NamedTuple):
    """Stacked rollout buffers, time-major.  Use
    :func:`mbt_gym_torch.rollout.to_reference_layout` for the reference's
    trajectory-major layout."""

    observations: torch.Tensor  # (T+1, N, S)
    actions: torch.Tensor  # (T, N, A)
    rewards: torch.Tensor  # (T, N)


class TrajectoryT(NamedTuple):
    """Feature-major trajectory: minor dims are (time, envs), the layout the
    episode kernels write.  ``observations_t[c, t, i]`` ==
    ``Trajectory.observations[t, i, c]``."""

    observations_t: torch.Tensor  # (S, T+1, N)
    actions_t: torch.Tensor  # (A, T, N)
    rewards: torch.Tensor  # (T, N)

    def to_time_major(self) -> Trajectory:
        """The time-major :class:`Trajectory` view (no copy)."""
        return Trajectory(
            observations=self.observations_t.permute(1, 2, 0),
            actions=self.actions_t.permute(1, 2, 0),
            rewards=self.rewards,
        )

    def to_reference_layout(self):
        """The reference's trajectory-major buffers (obs (N, S, T+1),
        actions (N, A, T), rewards (N, 1, T) — generate_trajectory.py:11-15)."""
        return (
            self.observations_t.permute(2, 0, 1),
            self.actions_t.permute(2, 0, 1),
            self.rewards.permute(1, 0)[:, None, :],
        )


def device_constant(values, dtype: torch.dtype, device=None) -> torch.Tensor:
    """``values`` (a float, or nested tuples of floats) as a tensor on
    ``device``, copied there once per (values, dtype, device) and shared by
    every later call, which must not write to it.  The engine's per-step
    constants (bounds, rates, signs) come from here, so a warm step copies
    nothing from the host, and a CUDA-graph capture of it
    (:mod:`mbt_gym_torch.compiled`) finds each one already on the card.
    The cache is unbounded: a captured graph reads these tensors by
    address and runs no Python that would keep them alive, so none may
    ever be freed (each holds a few floats)."""
    return _device_constant(values, dtype, torch.device("cpu" if device is None else device))


@lru_cache(maxsize=None)
def _device_constant(values, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def as_values(array) -> tuple:
    """A numpy array's values as the hashable tuple :func:`device_constant`
    takes."""
    return tuple(np.asarray(array, dtype=np.float64).tolist())
