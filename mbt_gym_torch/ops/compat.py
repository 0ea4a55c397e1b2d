"""Reference-exact noise replay harness (counterpart of
``mbt_gym_tpu/ops/compat.py``).

The reference gives each stochastic process its own NumPy
``Generator(PCG64(seed + slot_index + 1))`` (TradingEnvironment.py:345-348)
and consumes, per step: arrival uniforms (N,2), fill uniforms (N,2), then the
midprice normal in ``update`` (call-stack order, TradingEnvironment.py:198-211).
Streams are independent per process, so replaying the reference bit for bit
only requires each stream's within-stream order.

:func:`reference_noise_cube` draws an episode's noise on the host with those
per-slot PCG64 streams, shaped ``(T, N, k)`` per slot, as NumPy arrays ready
for ``rollout(..., noise=...)``.  With ``dtype="float64"`` the engine then
reproduces the reference's trajectories (tests/data/golden_as_seed50.npz).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from mbt_gym_torch.env import EnvConfig, noise_specs
from mbt_gym_torch.types import SlotNoise, StepNoise


def reference_noise_cube(
    cfg: EnvConfig, seed: int, n_steps: Optional[int] = None, dtype=None
) -> StepNoise:
    """An episode's noise from the reference's per-process streams.

    Slot ``i`` (state-layout order midprice/arrival/fill/impact) uses
    ``default_rng(seed + i + 1)``.  Within a slot, each step draws normals
    then uniforms — as every reference process draws one array per step.
    """
    n_steps = n_steps or cfg.n_steps
    n = cfg.num_trajectories
    dtype = dtype or cfg.dtype
    slots = []
    for i, (_, (n_norm, n_unif)) in enumerate(noise_specs(cfg)):
        rng = np.random.default_rng(seed + i + 1)
        if n_norm and n_unif:
            # Mixed-kind slot: per-step interleaving matters, keep the loop.
            normals = np.empty((n_steps, n, n_norm), dtype=np.float64)
            uniforms = np.empty((n_steps, n, n_unif), dtype=np.float64)
            for t in range(n_steps):
                normals[t] = rng.normal(size=(n, n_norm))
                uniforms[t] = rng.uniform(size=(n, n_unif))
        else:
            # Single-kind slot: one batched draw is bitwise-identical to the
            # per-step sequence (NumPy Generators fill C-order sequentially).
            normals = rng.normal(size=(n_steps, n, n_norm)) if n_norm else None
            uniforms = rng.uniform(size=(n_steps, n, n_unif)) if n_unif else None
        slots.append(
            SlotNoise(
                normal=None if normals is None else normals.astype(dtype),
                uniform=None if uniforms is None else uniforms.astype(dtype),
            )
        )
    return tuple(slots)


def reference_initial_inventory(cfg: EnvConfig, seed: int, resets: int = 0) -> np.ndarray:
    """Replay the reference's reset-time inventory draw for tuple specs:
    env-level ``default_rng(seed).integers(low, high, size=N)``
    (TradingEnvironment.py:72,270-273).

    The reference consumes one draw when the constructor builds the initial
    state (TradingEnvironment.py:74) and one more per ``env.reset()``
    (:96-99); ``resets`` is how many draws to skip, so ``resets=0`` is the
    constructor's state and ``resets=1`` the state after the first
    ``reset()`` (what ``generate_trajectory`` rolls from,
    generate_trajectory.py:18).  Feed the result to ``reset(...,
    initial_inventory=...)`` or ``rollout(..., initial_inventory=...)``."""
    assert isinstance(cfg.initial_inventory, tuple)
    rng = np.random.default_rng(seed)
    lo, hi = cfg.initial_inventory
    for _ in range(resets):
        rng.integers(int(lo), int(hi), size=cfg.num_trajectories)
    return rng.integers(int(lo), int(hi), size=cfg.num_trajectories).astype(cfg.dtype)
