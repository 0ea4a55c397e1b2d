"""Fused MLP-policy rollout K3 (counterpart of the MLP part of
``mbt_gym_tpu/ops/pallas_rollout.py``), beside its plain PyTorch version.

:func:`mlp_rollout` replaces ``mlp_rollout_pallas``
(``ops/pallas_rollout.py:1514``): the whole PPO data-collection episode —
the actor-critic forward, the Gaussian sample and the env step — in one
CUDA kernel (``csrc/mlp_rollout.cu``; its source note gives what bounds it
on the H100 and what the design does about it).  It returns feature-major
buffers, envs on the minor dimension: obs ``(T, S, N)``, actions
``(T, A, N)``, log-probs, values and rewards ``(T, N)``.

Ported scope: the "limit" family (BM midprice, Poisson arrivals,
exponential fill, limit-order dynamics, PnL reward) with a fixed start
time and a fixed initial inventory, and the shared-trunk actor-critic.
:func:`rollout_params_from_config` raises ``AssertionError`` naming any
other feature as not ported to CUDA yet; separate pi/vf towers raise in
:func:`transpose_params`.

Which path a call takes depends only on the device of its tensors: CPU
tensors run :func:`mlp_rollout_plain`, CUDA tensors launch the kernel or
raise.  The plain version runs on any device; on the card it is what the
kernel is held against.  It repeats the kernel's arithmetic: with
normalised observations every matmul operand is rounded to bf16
(``x.to(torch.bfloat16).float()``) with a float32 sum, else all float32
(``pallas_rollout.py:855``); its matmuls run with TF32 off and float32
matmul precision "highest", set for the call.

Noise: ``noise`` is ``(T, 7, N)`` float32 channels in the JAX kernel's
order (:data:`N_CHANNELS`).  Without it, native mode draws Philox4x32-10
keyed by ``(seed, env)``; :func:`philox_noise` reproduces that stream as
channels, so the plain version sees the kernel's draws on any device.
"""
from __future__ import annotations

import contextlib
import ctypes
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from mbt_gym_torch.env import EnvConfig, resolve_device
from mbt_gym_torch.ops import _build
from mbt_gym_torch.ops.episode import _MASK32, _uniform24, philox4x32_10

_LOG_2PI = math.log(2.0 * math.pi)

S_DIM = 4  # AS env state columns (cash, inventory, time, price)
A_DIM = 2  # bid/ask depths

# The CUDA kernel's limits (csrc/mlp_rollout.cu).
_ENV_TILE = 32
_MAX_WIDTH = 256
_MAX_LAYERS = 8


def n_noise_channels(a_dim: int) -> int:
    """Injected-noise channel count of the MLP policy on the ported family
    (pallas_rollout.py:98-109): 4 env uniforms + max(a_dim, 2)
    policy-sample normals + 1 midprice normal."""
    return 4 + max(a_dim, 2) + 1


# Injected-noise channel order (noise mode): 4 env uniforms (u_arr_bid,
# u_arr_ask, u_fill_bid, u_fill_ask), then max(a_dim, 2) policy-sample
# normals, then the midprice normal.
N_CHANNELS = n_noise_channels(A_DIM)


class MlpRolloutParams(NamedTuple):
    """Static scalars of the fused policy rollout: the fields of the JAX
    package's ``MlpRolloutParams`` that the ported family reads, with the
    same names and values (AS env contract, TradingEnvironment.py:103-110;
    normalisation per :112-126).  The JAX kind fields are implied: limit
    dynamics, BM midprice, Poisson arrivals, exponential fills, PnL, MLP."""

    n_steps: int
    dt: float
    drift: float
    volatility: float
    initial_price: float
    intensity_bid: float
    intensity_ask: float
    fill_exponent: float
    max_inventory: float
    max_cash: float
    initial_cash: float
    initial_inventory: float
    start_time: float
    obs_low: tuple  # (S,) cash, inventory, time, price
    obs_grad: tuple  # (high - low) / 2 per channel
    act_low: tuple  # (A,) bid/ask depth lower bounds
    act_grad: tuple
    normalise_obs: bool
    normalise_act: bool

    @property
    def run_steps(self) -> int:
        return self.n_steps - round(self.start_time / self.dt)


def rollout_params_from_config(cfg: EnvConfig) -> MlpRolloutParams:
    """The rollout scalars of ``cfg``; ``AssertionError`` naming the first
    feature outside the ported family (pallas_rollout.py:277-665)."""
    from mbt_gym_torch.dynamics import LimitOrderDynamics
    from mbt_gym_torch.processes.arrivals import PoissonArrivals
    from mbt_gym_torch.processes.fills import ExponentialFill
    from mbt_gym_torch.processes.midprice import BrownianMotionMidprice
    from mbt_gym_torch.rewards import PnL

    d = cfg.dynamics
    assert isinstance(d, LimitOrderDynamics) and d.action_dim == 2, (
        "fused rollout: limit-order dynamics only; the limit-and-market-"
        "order, at-the-touch and trading-speed families are not ported to "
        "CUDA yet"
    )
    assert isinstance(d.midprice_model, BrownianMotionMidprice), (
        f"fused rollout midprice: Brownian motion only; {d.midprice_model} "
        "is not ported to CUDA yet"
    )
    assert isinstance(d.arrival_model, PoissonArrivals), (
        f"fused rollout arrivals: linear Poisson only; {d.arrival_model} is "
        "not ported to CUDA yet"
    )
    assert isinstance(d.fill_probability_model, ExponentialFill), (
        f"fused rollout fills: exponential only; {d.fill_probability_model} "
        "is not ported to CUDA yet"
    )
    assert isinstance(cfg.reward_function, PnL), (
        f"fused rollout (limit dynamics) supports PnL only; "
        f"{cfg.reward_function} is not ported to CUDA yet"
    )
    assert cfg.reward_scaling is None
    assert not callable(cfg.initial_inventory), (
        "callable initial_inventory is host-evaluated per reset; use the "
        "engine rollout"
    )
    assert not isinstance(cfg.initial_inventory, tuple), (
        "fused rollout: random initial inventory is not ported to CUDA yet"
    )
    assert not callable(cfg.start_time), (
        "callable start_time is host-evaluated per reset; use the engine rollout"
    )
    assert not isinstance(cfg.start_time, tuple), (
        "fused rollout: random start times are not ported to CUDA yet"
    )
    assert cfg.dtype == "float32", (
        "fused rollout computes in float32/bf16; float64 reference-parity "
        "configs must use the engine rollout"
    )
    obs_low, obs_high = cfg.observation_bounds()
    act_low, act_high = cfg.action_bounds()
    return MlpRolloutParams(
        n_steps=cfg.n_steps,
        dt=cfg.step_size,
        drift=d.midprice_model.drift,
        volatility=d.midprice_model.volatility,
        initial_price=d.midprice_model.initial_price,
        intensity_bid=d.arrival_model.intensity[0],
        intensity_ask=d.arrival_model.intensity[1],
        fill_exponent=d.fill_probability_model.fill_exponent,
        max_inventory=float(cfg.max_inventory),
        max_cash=float(cfg.resolved_max_cash()),
        initial_cash=float(cfg.initial_cash),
        initial_inventory=float(cfg.initial_inventory),
        start_time=round(float(cfg.start_time) / cfg.step_size) * cfg.step_size,
        obs_low=tuple(float(x) for x in obs_low),
        obs_grad=tuple(float(h - l) / 2.0 for l, h in zip(obs_low, obs_high)),
        act_low=tuple(float(x) for x in act_low),
        act_grad=tuple(float(h - l) / 2.0 for l, h in zip(act_low, act_high)),
        normalise_obs=bool(cfg.normalise_observation_space),
        normalise_act=bool(cfg.normalise_action_space),
    )


class TransposedParams(NamedTuple):
    """The kernel's view of the actor-critic: ``trunk`` is a list of
    ``(W (out, in), b (out,))`` float32 tensors; ``w_head`` ``(A+1, H)`` has
    the pi rows then the vf row; ``b_head`` ``(A+1,)``; ``log_std`` ``(A,)``."""

    trunk: list
    w_head: torch.Tensor
    b_head: torch.Tensor
    log_std: torch.Tensor


def transpose_params(params) -> TransposedParams:
    """pallas_rollout.py:668-712 for the shared trunk.  ``nn.Linear``
    already stores ``W`` as ``(out, in)``, the JAX kernel's ``W^T``.
    Separate pi/vf towers (the JAX kernel's stacked-trunk ``split_at``
    mode) are not ported to CUDA yet and raise ``ValueError``."""
    if not params.shared_trunk:
        raise ValueError(
            "the separate pi/vf towers layout (the JAX kernels' stacked-trunk "
            "split_at mode) is not ported to CUDA yet; use shared_trunk=True "
            "or the engine path"
        )
    trunk = [(lin.weight.detach().float(), lin.bias.detach().float()) for lin in params.shared]
    w_head = torch.cat([params.pi_head.weight, params.vf_head.weight], dim=0).detach().float()
    b_head = torch.cat([params.pi_head.bias, params.vf_head.bias]).detach().float()
    return TransposedParams(trunk, w_head, b_head, params.log_std.detach().float())


# ------------------------------------------------------------- native noise
def philox_noise(seed: int, run_steps: int, num_trajectories: int, device=None) -> torch.Tensor:
    """The kernel's native noise as ``(run_steps, 7, N)`` float32 channels:
    Philox4x32-10 keyed by ``(seed, env)``; counter ``(step, 0)`` gives the
    four arrival/fill uniforms and ``(step, 1)`` four Box-Muller uniforms,
    whose pairs give eps0, eps1 and the midprice normal."""
    device = resolve_device(device)
    steps = torch.arange(run_steps, dtype=torch.int64, device=device)[:, None]
    envs = torch.arange(num_trajectories, dtype=torch.int64, device=device)[None, :]
    zero = torch.zeros_like(steps)
    key = (int(seed) & _MASK32, envs)
    a = philox4x32_10((steps, zero, zero, zero), key)
    b = philox4x32_10((steps, zero + 1, zero, zero), key)
    r0 = torch.sqrt(-2.0 * torch.log(1.0 - _uniform24(b[0])))
    r1 = torch.sqrt(-2.0 * torch.log(1.0 - _uniform24(b[1])))
    th0 = (2.0 * math.pi) * _uniform24(b[2])
    th1 = (2.0 * math.pi) * _uniform24(b[3])
    return torch.stack(
        [_uniform24(a[0]), _uniform24(a[1]), _uniform24(a[2]), _uniform24(a[3]),
         r0 * torch.cos(th0), r1 * torch.cos(th1), r0 * torch.sin(th0)],
        dim=1,
    )


# ------------------------------------------------------------ constants
class MlpKernelParams(ctypes.Structure):
    """float32 step constants shared by the plain version and the kernel
    (``struct MlpKernelParams`` in ``csrc/mlp_rollout.cu``).  Each float is
    the float32 rounding of the double computed here, as the JAX kernel's
    Python-float constants are rounded where they meet float32 arrays."""

    _fields_ = [
        ("run_steps", ctypes.c_int),
        ("n_layers", ctypes.c_int),
        ("s_dim", ctypes.c_int),
        ("a_dim", ctypes.c_int),
        ("normalise_obs", ctypes.c_int),
        ("normalise_act", ctypes.c_int),
        ("widths", ctypes.c_int * _MAX_LAYERS),
        ("start_time", ctypes.c_float),
        ("dt", ctypes.c_float),
        ("obs_low", ctypes.c_float * 8),
        ("obs_grad", ctypes.c_float * 8),
        ("act_low", ctypes.c_float * 4),
        ("act_grad", ctypes.c_float * 4),
        ("act_high", ctypes.c_float * 4),
        ("p_arr_bid", ctypes.c_float),
        ("p_arr_ask", ctypes.c_float),
        ("neg_k", ctypes.c_float),
        ("max_inventory", ctypes.c_float),
        ("max_cash", ctypes.c_float),
        ("drift_dt", ctypes.c_float),
        ("vol_sqrt_dt", ctypes.c_float),
        ("initial_cash", ctypes.c_float),
        ("initial_inventory", ctypes.c_float),
        ("initial_price", ctypes.c_float),
        ("logp_const", ctypes.c_float),
    ]


def kernel_params(p: MlpRolloutParams, widths) -> MlpKernelParams:
    a_dim = len(p.act_low)
    return MlpKernelParams(
        run_steps=p.run_steps,
        n_layers=len(widths),
        s_dim=len(p.obs_low),
        a_dim=a_dim,
        normalise_obs=int(p.normalise_obs),
        normalise_act=int(p.normalise_act),
        widths=(ctypes.c_int * _MAX_LAYERS)(*widths),
        start_time=p.start_time,
        dt=p.dt,
        obs_low=(ctypes.c_float * 8)(*p.obs_low),
        obs_grad=(ctypes.c_float * 8)(*p.obs_grad),
        act_low=(ctypes.c_float * 4)(*p.act_low),
        act_grad=(ctypes.c_float * 4)(*p.act_grad),
        act_high=(ctypes.c_float * 4)(*(lo + 2 * g for lo, g in zip(p.act_low, p.act_grad))),
        p_arr_bid=p.intensity_bid * p.dt,
        p_arr_ask=p.intensity_ask * p.dt,
        neg_k=-p.fill_exponent,
        max_inventory=p.max_inventory,
        max_cash=p.max_cash,
        drift_dt=p.drift * p.dt,
        vol_sqrt_dt=p.volatility * math.sqrt(p.dt),
        initial_cash=p.initial_cash,
        initial_inventory=p.initial_inventory,
        initial_price=p.initial_price,
        logp_const=0.5 * _LOG_2PI * a_dim,
    )


@contextlib.contextmanager
def full_float32_matmul():
    """Plain versions' matmuls in full float32 on the card: TF32 off and
    float32 matmul precision "highest" for the duration, restored after."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    precision = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.set_float32_matmul_precision(precision)


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 (nearest even) and back to float32."""
    return x.to(torch.bfloat16).float()


# ------------------------------------------------------------ plain version
def mlp_rollout_plain(p: MlpRolloutParams, params, seed: int = 0, num_trajectories: int = 16384,
                      noise: Optional[torch.Tensor] = None, device=None):
    """Plain PyTorch K3 on any device; returns what :func:`mlp_rollout`
    returns."""
    device = noise.device if noise is not None else resolve_device(device)
    n = num_trajectories
    tp = transpose_params(params)
    trunk = [(w.to(device), b.to(device)) for w, b in tp.trunk]
    kp = kernel_params(p, [w.shape[0] for w, _ in trunk])
    T, S, A = kp.run_steps, kp.s_dim, kp.a_dim
    if noise is None:
        noise = philox_noise(seed, T, n, device)
    else:
        _check_noise(p, n, noise)
    rnd = bf16_round if p.normalise_obs else (lambda x: x)
    trunk = [(rnd(w), b[:, None]) for w, b in trunk]
    w_head, b_head = rnd(tp.w_head.to(device)), tp.b_head.to(device)[:, None]
    log_std = tp.log_std.to(device)
    std = torch.exp(log_std)
    f32 = torch.float32
    obs_out = torch.empty((T, S, n), dtype=f32, device=device)
    act_out = torch.empty((T, A, n), dtype=f32, device=device)
    logp_out, val_out, rew_out = (torch.empty((T, n), dtype=f32, device=device) for _ in range(3))
    cash = torch.full((n,), kp.initial_cash, dtype=f32, device=device)
    inv = torch.full((n,), kp.initial_inventory, dtype=f32, device=device)
    price = torch.full((n,), kp.initial_price, dtype=f32, device=device)
    with full_float32_matmul():
        for i in range(T):
            t = float(np.float32(kp.start_time) + np.float32(i) * np.float32(kp.dt))
            planes = [cash, inv, torch.full_like(cash, t), price]
            if p.normalise_obs:
                # a tensor divisor: PyTorch's CUDA division by a Python
                # scalar multiplies by its reciprocal, the kernel divides
                planes = [(x - kp.obs_low[c]) / torch.full_like(x, kp.obs_grad[c]) - 1.0
                          for c, x in enumerate(planes)]
            X = torch.stack(planes)
            obs_out[i] = X
            h = X
            for w, b in trunk:
                h = torch.tanh(w @ rnd(h) + b)
            hd = w_head @ rnd(h) + b_head
            d = noise[i]
            lp = torch.zeros_like(cash)
            exec_action = []
            for a in range(A):
                eps = d[4 + a]
                action = hd[a] + std[a] * eps
                act_out[i, a] = action
                lp = lp + ((-0.5 * eps) * eps - log_std[a])
                if p.normalise_act:
                    clipped = torch.clamp(action, -1.0, 1.0)
                    exec_action.append((clipped + 1.0) * kp.act_grad[a] + kp.act_low[a])
                else:
                    exec_action.append(torch.clamp(action, kp.act_low[a], kp.act_high[a]))
            logp_out[i] = lp - kp.logp_const
            val_out[i] = hd[A]
            bid, ask = exec_action[0], exec_action[1]
            arr_bid = (d[0] < kp.p_arr_bid).to(f32)
            arr_ask = (d[1] < kp.p_arr_ask).to(f32)
            fill_bid = (d[2] < torch.exp(kp.neg_k * bid)).to(f32)
            fill_ask = (d[3] < torch.exp(kp.neg_k * ask)).to(f32)
            fill_bid = fill_bid * (inv < kp.max_inventory).to(f32)
            fill_ask = fill_ask * (inv > -kp.max_inventory).to(f32)
            hit_bid = arr_bid * fill_bid
            hit_ask = arr_ask * fill_ask
            new_inv = torch.clamp(inv + hit_bid - hit_ask, -kp.max_inventory, kp.max_inventory)
            new_cash = cash - hit_bid * (price - bid) + hit_ask * (price + ask)
            new_cash = torch.clamp(new_cash, -kp.max_cash, kp.max_cash)
            new_price = price + kp.drift_dt + kp.vol_sqrt_dt * d[6]
            rew_out[i] = (new_cash + new_inv * new_price) - (cash + inv * price)
            cash, inv, price = new_cash, new_inv, new_price
    return obs_out, act_out, logp_out, val_out, rew_out


# ------------------------------------------------------------ kernel wrapper
def _check_noise(p: MlpRolloutParams, n: int, noise: torch.Tensor) -> None:
    want = (p.run_steps, N_CHANNELS, n)
    if noise.dtype != torch.float32 or tuple(noise.shape) != want:
        raise ValueError(f"noise must be float32 of shape {want}; got {noise.dtype} {tuple(noise.shape)}")


def _kernels() -> ctypes.CDLL:
    lib = _build.load("mlp_rollout.cu")
    if not getattr(lib, "_mbt_declared", False):
        ptr, i32, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
        lib.mbt_mlp_rollout.argtypes = [
            ptr, i32, i32, u32, ptr, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
        ]
        lib.mbt_mlp_rollout.restype = i32
        lib._mbt_declared = True
    return lib


def _check_kernel_shapes(p: MlpRolloutParams, widths, n: int) -> None:
    if len(p.obs_low) != S_DIM or len(p.act_low) != A_DIM:
        raise ValueError(f"the K3 kernel takes S={S_DIM}, A={A_DIM}; got {len(p.obs_low)}, {len(p.act_low)}")
    if not 1 <= len(widths) <= _MAX_LAYERS or any(w % 4 or not 0 < w <= _MAX_WIDTH for w in widths):
        raise ValueError(
            f"the K3 kernel takes 1-{_MAX_LAYERS} trunk layers, each a multiple of 4 wide and at "
            f"most {_MAX_WIDTH}; got {tuple(widths)}"
        )
    if n % _ENV_TILE:
        raise ValueError(f"the K3 kernel takes a multiple of {_ENV_TILE} envs; got {n}")


def mlp_rollout(p: MlpRolloutParams, params, seed: int = 0, num_trajectories: int = 16384,
                noise: Optional[torch.Tensor] = None, device=None):
    """K3: one full episode for ``num_trajectories`` envs with the MLP
    policy fused in.  Returns ``(obs (T, S, N), actions (T, A, N),
    log_probs (T, N), values (T, N), rewards (T, N))``, float32.

    ``noise`` (optional) injects ``(T, 7, N)`` channels; otherwise native
    Philox noise keyed by ``seed``.  On a CPU target this is
    :func:`mlp_rollout_plain`; on CUDA it launches the kernel."""
    if noise is not None:
        if device is not None and torch.device(device).type != noise.device.type:
            raise ValueError(f"noise lives on {noise.device}, the call targets {device}")
        device = noise.device
    else:
        device = resolve_device(device)
    if device.type == "cpu":
        return mlp_rollout_plain(p, params, seed, num_trajectories, noise, device)
    if device.type != "cuda":
        raise ValueError(f"the rollout kernel runs on CUDA devices, not {device}")
    n = num_trajectories
    tp = transpose_params(params)
    widths = [w.shape[0] for w, _ in tp.trunk]
    _check_kernel_shapes(p, widths, n)
    if noise is not None:
        _check_noise(p, n, noise)
        if not noise.is_contiguous():
            raise ValueError("noise must be contiguous")
    kp = kernel_params(p, widths)
    T, S, A = kp.run_steps, kp.s_dim, kp.a_dim
    bf16 = bool(p.normalise_obs)
    wdt = torch.bfloat16 if bf16 else torch.float32
    # each layer's (in, out) matrix, layers concatenated
    w_t = torch.cat([w.to(device).T.contiguous().reshape(-1) for w, _ in tp.trunk]).to(wdt)
    bias = torch.cat([b.to(device) for _, b in tp.trunk]).contiguous()
    w_head = tp.w_head.to(device)
    w_head = (bf16_round(w_head) if bf16 else w_head).contiguous()
    b_head = tp.b_head.to(device).contiguous()
    log_std = tp.log_std.to(device).contiguous()
    f32 = torch.float32
    obs = torch.empty((T, S, n), dtype=f32, device=device)
    act = torch.empty((T, A, n), dtype=f32, device=device)
    logp, val, rew = (torch.empty((T, n), dtype=f32, device=device) for _ in range(3))
    index = device.index if device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(index).cuda_stream
    rc = _kernels().mbt_mlp_rollout(
        ctypes.byref(kp), index, n, int(seed) & _MASK32,
        None if noise is None else noise.data_ptr(), int(bf16), w_t.data_ptr(), bias.data_ptr(),
        w_head.data_ptr(), b_head.data_ptr(), log_std.data_ptr(),
        obs.data_ptr(), act.data_ptr(), logp.data_ptr(), val.data_ptr(), rew.data_ptr(), stream,
    )
    if rc != 0:
        raise RuntimeError(f"mlp_rollout kernel launch failed: CUDA error {rc}")
    _build.count_launch("mlp_rollout")
    return obs, act, logp, val, rew


# ------------------------------------------------------------ PPO batches
class TRolloutBatch(NamedTuple):
    """Feature-major rollout batch: envs on the minor dimension of every
    leaf, the layout the K3 kernel writes and the K4 kernel reads."""

    obs_t: torch.Tensor  # (T, S, N)
    actions_t: torch.Tensor  # (T, A, N)
    log_probs: torch.Tensor  # (T, N)
    values: torch.Tensor  # (T, N)
    rewards: torch.Tensor  # (T, N)
    advantages: torch.Tensor  # (T, N)
    returns: torch.Tensor  # (T, N)


def collect_rollout_fused_T(env_cfg: EnvConfig, params, key, gamma: float = 1.0, lam: float = 0.95,
                            noise: Optional[torch.Tensor] = None, device=None) -> TRolloutBatch:
    """K3 rollout in its feature-major layout + GAE — the input of
    :func:`mbt_gym_torch.ops.fused_ppo.ppo_fused_grads_T`
    (pallas_rollout.py:2198-2256).  ``key`` (an int seed or a
    ``torch.Generator``) gives the kernel's Philox seed; ``noise`` injects
    ``(T, 7, N)`` channels instead."""
    from mbt_gym_torch.agents.ppo import compute_gae
    from mbt_gym_torch.ops.episode import seed_from_key

    p = rollout_params_from_config(env_cfg)
    seed = 0 if noise is not None else seed_from_key(key)
    obs_t, actions_t, log_probs, values, rewards = mlp_rollout(
        p, params, seed, env_cfg.num_trajectories, noise=noise, device=device,
    )
    advantages, returns = compute_gae(rewards, values, torch.zeros_like(values[0]), gamma, lam)
    return TRolloutBatch(obs_t, actions_t, log_probs, values, rewards, advantages, returns)


def collect_rollout_fused(env_cfg: EnvConfig, params, key, gamma: float = 1.0, lam: float = 0.95,
                          noise: Optional[torch.Tensor] = None, device=None):
    """Drop-in for :func:`mbt_gym_torch.agents.ppo.collect_rollout`: the
    row-major :class:`~mbt_gym_torch.agents.ppo.RolloutBatch` of a K3
    rollout (obs ``(T, N, S)``, actions ``(T, N, A)``; views, no copy)."""
    from mbt_gym_torch.agents.ppo import RolloutBatch

    tb = collect_rollout_fused_T(env_cfg, params, key, gamma, lam, noise=noise, device=device)
    return RolloutBatch(
        obs=tb.obs_t.transpose(1, 2), actions=tb.actions_t.transpose(1, 2),
        log_probs=tb.log_probs, values=tb.values, rewards=tb.rewards,
        advantages=tb.advantages, returns=tb.returns,
    )
