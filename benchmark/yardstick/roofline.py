"""The chip's peaks and the operations and bytes each measured kernel
needs, from its shapes alone.

Peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit: dense
bf16 on the tensor cores, float32 outside them, HBM3 bandwidth.  A bound is
the larger of operations over the peak and bytes over the bandwidth: the
least time the chip could take.  Each input byte is counted once and each
output byte once.
"""
from __future__ import annotations

BF16_OPS_PER_S = 989e12
FP32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12

# Operations one Avellaneda-Stoikov env-step takes in K1's native mode,
# each integer or float operation and each libm call counted as one: two
# Philox4x32-10 calls (10 rounds of 8 operations and 9 key bumps of 2,
# twice: 196), six 24-bit uniforms (18), Box-Muller (7), the quotes with
# the step's time (9), arrivals, fills and masks (14), bookkeeping and clip
# (10), the price move (3).  Integer operations are held to the float32
# peak too, so the bound stays a lower bound.
OPS_PER_AS_ENV_STEP = 196 + 18 + 7 + 9 + 14 + 10 + 3


def mlp_forward_flops(s_dim: int, widths, a_dim: int, towers: int) -> int:
    """Matrix-product FLOPs of one actor-critic forward: a shared trunk
    (``towers`` 1) or separate pi/vf towers of ``widths`` (2), each head
    reading its own tower: 2 (T S h_0 + T sum h_{l-1} h_l + (A + 1) h_last)."""
    inner = sum(a * b for a, b in zip(widths, widths[1:]))
    return 2 * (towers * s_dim * widths[0] + towers * inner + (a_dim + 1) * widths[-1])


def ppo_grad_flops(s_dim: int, widths, a_dim: int, towers: int) -> int:
    """Forward and backward FLOPs of one PPO sample: the forward, then the
    head's dh and dW, each hidden-to-hidden layer's dh and dW and the first
    layer's dW: 2 (2 (A + 1) h_last + 2 T sum h_{l-1} h_l + T S h_0)."""
    inner = sum(a * b for a, b in zip(widths, widths[1:]))
    backward = 2 * (2 * (a_dim + 1) * widths[-1] + 2 * towers * inner + towers * s_dim * widths[0])
    return mlp_forward_flops(s_dim, widths, a_dim, towers) + backward


def bound_s(bytes_moved: float, ops: float, peak: float) -> tuple:
    """``(least seconds, "bytes" or "operations")``."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / peak
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k3_bound(env_steps: int, s_dim: int, widths, a_dim: int, towers: int) -> tuple:
    """K3, one rollout in native mode: it reads nothing per step and writes
    the observation, the action, the log-prob, the value and the reward,
    (S + A + 3) floats per env-step."""
    return bound_s(4 * (s_dim + a_dim + 3) * env_steps,
                   mlp_forward_flops(s_dim, widths, a_dim, towers) * env_steps, BF16_OPS_PER_S)


def k4_bound(samples: int, s_dim: int, widths, a_dim: int, towers: int) -> tuple:
    """K4, one minibatch: it reads each sample's observation, action, old
    log-prob, advantage and return once; its gradients are a few MB."""
    return bound_s(4 * (s_dim + a_dim + 3) * samples, ppo_grad_flops(s_dim, widths, a_dim, towers) * samples,
                   BF16_OPS_PER_S)


def k1_bound(n_envs: int, steps: int) -> tuple:
    """K1, one AS episode in native mode: it reads nothing and writes the
    terminal (cash, inventory, price)."""
    return bound_s(4 * 3 * n_envs, OPS_PER_AS_ENV_STEP * steps * n_envs, FP32_OPS_PER_S)
