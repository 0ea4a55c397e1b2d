"""Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
3", SC'11) in plain PyTorch, and the draws the port's kernels make from it.

The kernels key Philox with ``(seed, env)`` and count ``(step, draw, 0,
0)``: draw 0 gives the four arrival and fill uniforms of a step, draw 1 the
Box-Muller words of the first normals, draw 2 (four action columns only)
one more pair.  A uniform is the top 24 bits of a word over 2**24.  The
benchmark's reference and the port's kernels see the same noise from the
same seed; nothing here reads the port.

Words are held in int64 tensors with values in [0, 2**32).
"""
from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def _mul_hi_lo(m: int, x: torch.Tensor):
    """The high and low 32-bit words of ``m * x``, exact in int64: ``x`` is
    split into 16-bit halves so that no partial product passes 2**50."""
    lo_part = m * (x & 0xFFFF)
    hi_part = m * (x >> 16)
    low = lo_part + ((hi_part & 0xFFFF) << 16)
    return (hi_part >> 16) + (low >> 32), low & MASK32


def philox4x32_10(counter, key):
    """Ten rounds of Philox4x32 on broadcastable int64 words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & MASK32
            k1 = (k1 + _W1) & MASK32
        hi0, lo0 = _mul_hi_lo(_M0, c0)
        hi1, lo1 = _mul_hi_lo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniform24(word: torch.Tensor) -> torch.Tensor:
    return (word >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _radius(word: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(-2.0 * torch.log(1.0 - uniform24(word)))


def _angle(word: torch.Tensor) -> torch.Tensor:
    return (2.0 * math.pi) * uniform24(word)


def step_noise(seed: int, steps: torch.Tensor, n_envs: int, a_dim: int) -> dict:
    """The noise of ``steps`` (an int64 ``(k,)`` tensor of step indices) for
    ``n_envs`` envs: ``uniforms`` ``(k, 4, N)`` (arrival bid, arrival ask,
    fill bid, fill ask), ``eps`` ``(k, max(a_dim, 2), N)`` (the policy's
    normals) and ``mid`` ``(k, N)`` (the midprice normal)."""
    device = steps.device
    t = steps[:, None]
    env = torch.arange(n_envs, dtype=torch.int64, device=device)[None, :]
    zero = torch.zeros_like(t)
    key = (int(seed) & MASK32, env)
    a = philox4x32_10((t, zero, zero, zero), key)
    b = philox4x32_10((t, zero + 1, zero, zero), key)
    r0, r1, th0, th1 = _radius(b[0]), _radius(b[1]), _angle(b[2]), _angle(b[3])
    eps = [r0 * torch.cos(th0), r1 * torch.cos(th1)]
    if a_dim > 2:
        c = philox4x32_10((t, zero + 2, zero, zero), key)
        r2, th2 = _radius(c[0]), _angle(c[1])
        eps += [r2 * torch.cos(th2), r2 * torch.sin(th2)]
    return {
        "uniforms": torch.stack([uniform24(w) for w in a], dim=1),
        "eps": torch.stack(eps, dim=1),
        "mid": r0 * torch.sin(th0),
    }
