"""Fused MLP-policy rollout K3 (counterpart of the MLP part of
``mbt_gym_tpu/ops/pallas_rollout.py``), beside its plain PyTorch version.

:func:`mlp_rollout` replaces ``mlp_rollout_pallas``
(``ops/pallas_rollout.py:1514``): the whole PPO data-collection episode —
the actor-critic forward, the Gaussian sample and the env step — in one
CUDA kernel (``csrc/mlp_rollout.cu``; its source note gives what bounds it
on the H100 and what the design does about it).  It returns feature-major
buffers, envs on the minor dimension: obs ``(T, S, N)``, actions
``(T, A, N)``, log-probs, values and rewards ``(T, N)``.

With bf16 operands (normalised observations) the kernel runs its products
on the tensor cores over tiles of 128 envs, the weights staged in shared
memory in mma fragment order: :func:`pad_widths` rounds every hidden width
up to a multiple of 16 with zero rows, columns and biases (tanh(0) = 0,
and zero columns add exact zeros, so the outputs do not change), and
:func:`pack_tower_bf16` packs each tower for the kernel.  With float32
operands it runs on CUDA cores over tiles of 32 envs, the widths padded to
a multiple of 4.  Like the JAX kernel it takes any trunk (up to
:data:`MAX_LAYERS` layers, a cap far past any trunk either package
trains): a bf16 trunk wider than 256 rows, or a float32 one whose
activations do not fit in shared memory, keeps its activation tiles in a
device-memory scratch (:func:`k3_scratch_bytes`; the kernel's wide route).

Ported scope, the JAX kernel's whole MLP contract: four dynamics kinds
(``dynamics_kind``, each its own kernel instantiation): "limit"
(limit-order dynamics, A = 2), "lam" (limit orders plus unit market
orders at mid -/+ ``fixed_half_spread``, A = 4, with the optional
market-order mask at +/- max inventory), "touch" (post-or-not at
``fixed_half_spread``, the fills the clipped post columns, A = 2) and
"speed" (trading-speed execution against price impact, A = 1, the impact
state observed after the price); every midprice model (no fill-driven
jump on speed), linear and exact-probability Poisson and Hawkes arrivals,
exponential, triangular, power and exogenous-market-maker fills (OU, BM
or GBM sides), and the four impact models — the plain processes (BM,
linear Poisson, exponential, temporary and permanent impact) on each
dynamics kind's original instantiation, any other (the composite stress
family of bench_suite config 10 too) on the dynamics kind's general one
(:mod:`~mbt_gym_torch.ops.proc_kinds`); the PnL, pathwise CJ
market-making (``CjMmCriterion``), running-penalty
(``RunningInventoryPenalty``) or, on speed, CJ execution (``CjOeCriterion``)
reward at any inventory exponent, and the terminal exponential utility
(``ExponentialUtility``) on every kind; a fixed start time, or a random
one (``start_time=("uniform", lo, hi)``: the full horizon with a per-env
``t0`` plane, post-done steps frozen with zero rewards, as the engine
masks them); a fixed initial inventory or a per-env one drawn in
``inventory_range`` (the ``inv0`` plane, under CjMm with its per-env
constant ``(alpha dt / ep_len) q(inv0)``); the terminal observation
(``final_obs``, fixed starts); and both actor-critic layouts: the shared
trunk, and the separate pi/vf towers as the JAX kernel's stacked trunk
(``split_at`` mode, ``pallas_rollout.py:668-712`` and ``:858-873``).
The ``t0`` plane and ``final_obs`` run the general instantiation's
"extras" variant (the plain processes' bits are the same there), so the
main paths' instantiations do not carry them.
:func:`rollout_params_from_config` raises ``AssertionError`` naming what
the JAX kernel refuses, in its words; towers of unequal widths raise
``ValueError`` in :func:`transpose_params`.

Which path a call takes depends only on the device of its tensors: CPU
tensors run :func:`mlp_rollout_plain`, CUDA tensors launch the kernel or
raise.  The plain version runs on any device; on the card it is what the
kernel is held against.  It repeats the kernel's arithmetic: with
normalised observations every matmul operand is rounded to bf16
(``x.to(torch.bfloat16).float()``) with a float32 sum, else all float32
(``pallas_rollout.py:855``); its matmuls run with TF32 off and float32
matmul precision "highest", set for the call.

Noise: ``noise`` is ``(T, p.n_channels, N)`` float32 channels in the
JAX kernel's order: 4 env uniforms, max(A, 2) policy-sample normals, the
midprice normal, then 2 exogenous best-depth normals (exogenous-MM fills)
and 1 second-midprice normal (Heston, short-term alphas) — 7 at A = 2 and
A = 1 (speed reads the first eps row) on the plain processes
(:data:`N_CHANNELS`), 9 at A = 4, 11 on the composite config.  Without it, native mode draws Philox4x32-10 keyed by
``(seed, env)``; :func:`philox_noise` reproduces that stream as channels,
so the plain version sees the kernel's draws on any device.
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
from mbt_gym_torch.ops import proc_kinds as pk
from mbt_gym_torch.ops.det_rollout import dynamics_kind_of, market_making_step, obs_planes, q_pow, reward_fields
from mbt_gym_torch.ops.episode import _MASK32, _target, _uniform24, philox4x32_10
from mbt_gym_torch.utils.profiling import span

_LOG_2PI = math.log(2.0 * math.pi)

MAX_S = 16  # state columns the kernel takes: layer 0's padded k (csrc/mlp_rollout.cu kK0)
A_DIM = 2  # bid/ask depths (limit) or post flags (touch)
# action columns per dynamics kind: lam adds the two market-order triggers,
# speed has its one trading speed
ACTION_DIMS = {"limit": 2, "lam": 4, "touch": 2, "speed": 1}
_DYNAMICS = {"limit": 0, "lam": 1, "touch": 2, "speed": 3}

# The CUDA kernel's limits (csrc/mlp_rollout.cu): the env count is a
# multiple of _ENV_TILE (the float32 kernel's tile; the bf16 kernel's tiles
# of 128 envs mask a ragged last one); at most MAX_LAYERS trunk layers (the
# size of MlpKernelParams' widths), any width.
_ENV_TILE = 32
MAX_LAYERS = 64
# The bf16 kernel's operand layout: widths a multiple of _MMA_WIDTH, layer
# 0's k (S) padded to _MMA_WIDTH with zero columns, the head as one
# _MMA_WIDTH-row block; the float32 kernel's register tiles take 4 rows.
_MMA_WIDTH = 16
_F32_WIDTH = 4
# The bf16 kernel's narrow route covers _PASS_ROWS output rows a layer (16
# warps of 32 rows x 64 envs) over _BF16_TILE envs; wider trunks take the
# wide route.
_PASS_ROWS = 256
_BF16_TILE = 128
# The dynamic shared memory one block may hold on Hopper (227 KB), by
# which K3's and K4/K7's wrappers pick their routes; the C launchers read
# the card's own (cudaDevAttrMaxSharedMemoryPerBlockOptin) and refuse a
# route that does not fit it.
SMEM_OPTIN = 232_448


def n_noise_channels(a_dim: int, exomm: bool = False, mid2: bool = False) -> int:
    """Injected-noise channel count of the MLP policy (pallas_rollout.py:98-111):
    4 env uniforms + max(a_dim, 2) policy-sample normals + 1 midprice
    normal (+ 2 exogenous best-depth normals for the exogenous-MM fill
    kind, + 1 second-midprice normal for the 2-dim midprice kinds)."""
    return 4 + max(a_dim, 2) + 1 + (2 if exomm else 0) + (1 if mid2 else 0)


# Injected-noise channel order (noise mode): 4 env uniforms (u_arr_bid,
# u_arr_ask, u_fill_bid, u_fill_ask), then max(a_dim, 2) policy-sample
# normals, then the midprice normal.
N_CHANNELS = n_noise_channels(A_DIM)


class MlpRolloutParams(NamedTuple):
    """Static scalars of the fused policy rollout: the fields of the JAX
    package's ``MlpRolloutParams`` that the ported kinds read, with the
    same names and values (TradingEnvironment.py:103-110; normalisation
    per :112-126).  The policy is the MLP; the process fields are those of
    :func:`mbt_gym_torch.ops.proc_kinds.process_fields`."""

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
    obs_low: tuple  # (S,) cash, inventory, time, price, then the process states
    obs_grad: tuple  # (high - low) / 2 per channel
    act_low: tuple  # (A,) bid/ask depth (limit) or speed (speed) lower bounds
    act_grad: tuple
    normalise_obs: bool
    normalise_act: bool
    # reward: "pnl" (RewardFunctions.py:20-36), "cjmm" (pathwise CJ MM
    # criterion, :77-113), "running" (RunningInventoryPenalty, :116-141),
    # "cjoe" (CJ execution criterion, :39-74, speed only), at any
    # inventory_exponent (reference semantics: inventory**exp, so a
    # fractional exponent is NaN on negative inventory, as in the engine),
    # or "exp_utility" (terminal -exp(-risk_aversion * value), :149-166)
    reward_kind: str = "pnl"
    phi: float = 0.0  # per-step inventory aversion
    alpha: float = 0.0  # terminal inventory aversion
    inventory_exponent: float = 2.0
    terminal_time: float = 1.0
    # "limit" (ModelDynamics.py:87-131), "lam" (:179-240, limit orders +
    # unit market orders at mid +/- fixed_half_spread), "touch" (:134-176,
    # post-or-not at fixed_half_spread) or "speed" (:243-275, trading speed
    # against price impact)
    dynamics_kind: str = "limit"
    # speed dynamics' impact model (price_impact_models.py): "temp_perm",
    # "power", "transient" or "temp_transient"
    impact_kind: str = "temp_perm"
    impact_exponent: float = 1.0
    impact_kappa: float = 0.0
    impact_rho: float = 0.0
    impact_gamma: float = 0.0
    impact_initial: float = 0.0
    temporary_impact: float = 0.0
    permanent_impact: float = 0.0
    fixed_half_spread: float = 0.0
    risk_aversion: float = 0.0  # "exp_utility" only
    # () = deterministic initial_inventory; (lo, hi) = per-env integer draw
    # in [lo, hi) per episode, passed to the kernel as the inv0 plane
    inventory_range: tuple = ()
    # start_time=("uniform", lo, hi): the full horizon (start_time 0.0) with
    # a per-env t0 plane; post-done steps frozen, as the engine masks them
    random_start: bool = False
    # EnvConfig.mask_market_orders_at_max_inventory (lam only)
    mask_mo_at_max_inventory: bool = False
    # the process kinds, with the JAX names and meanings
    # (pallas_rollout.py:168-228; mbt_gym_torch/ops/proc_kinds.py)
    midprice_kind: str = "bm"
    mid_level: float = 0.0  # OU mean-reversion level / CEV elasticity gamma
    mid_speed: float = 0.0  # OU mean-reversion speed
    mid_dt_scaled: bool = False
    mid_jump: float = 0.0
    mid2_initial: float = 0.0  # Heston variance / short-term alpha
    mid2_level: float = 0.0
    mid2_speed: float = 0.0
    mid2_vol: float = 0.0
    mid2_dt_scaled: bool = False
    mid2_corr: float = 0.0
    arrival_kind: str = "poisson"  # "poisson" | "poisson_nl" | "hawkes" (baseline in intensity_*)
    hawkes_jump: float = 0.0
    hawkes_mean_reversion: float = 0.0
    fill_kind: str = "exp"  # "exp" | "triangular" | "power" | "exomm"
    fill_param: float = 0.0  # triangular max depth / power multiplier
    exo_kind: tuple = ()  # (bid, ask) in {"ou", "bm", "gbm"}
    exo_level: tuple = ()  # OU level / BM-GBM drift
    exo_speed: tuple = ()
    exo_vol: tuple = ()
    exo_initial: tuple = ()
    exo_dt_scaled: tuple = ()
    exo_base_fill: float = 1.0

    @property
    def run_steps(self) -> int:
        if self.random_start:
            return self.n_steps
        return self.n_steps - round(self.start_time / self.dt)

    @property
    def a_dim(self) -> int:
        return ACTION_DIMS[self.dynamics_kind]

    @property
    def speed(self) -> bool:
        return self.dynamics_kind == "speed"

    @property
    def has_mid2(self) -> bool:
        return pk.has_mid2(self)

    @property
    def n_channels(self) -> int:
        """Noise-mode channels per step."""
        return n_noise_channels(self.a_dim, self.fill_kind == "exomm", self.has_mid2)


_REWARDS = {"pnl": 0, "cjmm": 1, "running": 2, "cjoe": 3, "exp_utility": 4}


def rollout_params_from_config(cfg: EnvConfig) -> MlpRolloutParams:
    """The rollout scalars of ``cfg``; ``AssertionError``, in the JAX
    kernel's words, naming the first feature outside its contract
    (pallas_rollout.py:277-665)."""
    d = cfg.dynamics
    dynamics_kind = dynamics_kind_of(d)
    procs = pk.process_fields(d, dynamics_kind)
    half_spread = float(d.fixed_market_half_spread) if dynamics_kind in ("lam", "touch") else 0.0
    r = cfg.reward_function
    reward_kind, phi, alpha, gamma_u = reward_fields(r, dynamics_kind)
    assert cfg.reward_scaling is None
    assert not callable(cfg.initial_inventory), (
        "callable initial_inventory is host-evaluated per reset; use the "
        "engine rollout"
    )
    if isinstance(cfg.initial_inventory, tuple):
        lo, hi = cfg.initial_inventory
        inventory_range, inv0 = (int(lo), int(hi)), 0.0  # per-env draws come in as the inv0 plane
    else:
        inventory_range, inv0 = (), float(cfg.initial_inventory)
    assert not callable(cfg.start_time), (
        "callable start_time is host-evaluated per reset; use the engine rollout"
    )
    random_start = isinstance(cfg.start_time, tuple)
    if random_start:
        assert cfg.start_time[0] == "uniform", f"Unknown start_time spec {cfg.start_time}"
        start_time = 0.0  # the full horizon; per-env t0 comes in as the t0 plane
    else:
        start_time = round(float(cfg.start_time) / cfg.step_size) * cfg.step_size
    assert cfg.dtype == "float32", (
        "fused rollout computes in float32/bf16; float64 reference-parity "
        "configs must use the engine rollout"
    )
    obs_low, obs_high = cfg.observation_bounds()
    act_low, act_high = cfg.action_bounds()
    return MlpRolloutParams(
        n_steps=cfg.n_steps,
        dt=cfg.step_size,
        max_inventory=float(cfg.max_inventory),
        max_cash=float(cfg.resolved_max_cash()),
        initial_cash=float(cfg.initial_cash),
        initial_inventory=inv0,
        start_time=start_time,
        obs_low=tuple(float(x) for x in obs_low),
        obs_grad=tuple(float(h - l) / 2.0 for l, h in zip(obs_low, obs_high)),
        act_low=tuple(float(x) for x in act_low),
        act_grad=tuple(float(h - l) / 2.0 for l, h in zip(act_low, act_high)),
        normalise_obs=bool(cfg.normalise_observation_space),
        normalise_act=bool(cfg.normalise_action_space),
        reward_kind=reward_kind,
        phi=phi,
        alpha=alpha,
        inventory_exponent=float(getattr(r, "inventory_exponent", 2.0)),
        terminal_time=cfg.terminal_time,
        dynamics_kind=dynamics_kind,
        fixed_half_spread=half_spread,
        risk_aversion=gamma_u,
        inventory_range=inventory_range,
        random_start=random_start,
        mask_mo_at_max_inventory=bool(cfg.mask_market_orders_at_max_inventory),
        **procs,
    )


class TransposedParams(NamedTuple):
    """The kernels' view of the actor-critic: ``trunk`` is a list of
    ``(W (out, in), b (out,))`` float32 tensors; ``w_head`` ``(A+1, H)`` has
    the pi rows then the vf row; ``b_head`` ``(A+1,)``; ``log_std`` ``(A,)``;
    ``split_at`` is ``None`` for the shared trunk, else the per-tower widths
    of the stacked trunk."""

    trunk: list
    w_head: torch.Tensor
    b_head: torch.Tensor
    log_std: torch.Tensor
    split_at: Optional[tuple] = None


def _linear(lin) -> tuple:
    return lin.weight.detach().float(), lin.bias.detach().float()


def transpose_params(params) -> TransposedParams:
    """pallas_rollout.py:668-712.  ``nn.Linear`` already stores ``W`` as
    ``(out, in)``, the JAX kernel's ``W^T``.  Separate pi/vf towers become
    a stacked trunk: every layer's rows are the pi tower's then the vf
    tower's (layer 0 reads the observation, layer i > 0 block-wise the
    carry below), and the merged ``(A+1, 2H)`` head is zero off its
    towers' blocks.  Towers of unequal widths raise ``ValueError``."""
    log_std = params.log_std.detach().float()
    if params.shared_trunk:
        trunk = [_linear(lin) for lin in params.shared]
        w_head = torch.cat([params.pi_head.weight, params.vf_head.weight], dim=0).detach().float()
        b_head = torch.cat([params.pi_head.bias, params.vf_head.bias]).detach().float()
        return TransposedParams(trunk, w_head, b_head, log_std)
    t_pi, t_vf = params.pi[:-1], params.vf[:-1]
    if [lin.weight.shape for lin in t_pi] != [lin.weight.shape for lin in t_vf]:
        raise ValueError(
            "separate pi/vf towers must have matching widths (the reference always uses a "
            f"symmetric net_arch); got {[lin.out_features for lin in t_pi]} and "
            f"{[lin.out_features for lin in t_vf]}"
        )
    trunk = []
    for p_lin, v_lin in zip(t_pi, t_vf):
        (wp, bp), (wv, bv) = _linear(p_lin), _linear(v_lin)
        trunk.append((torch.cat([wp, wv]), torch.cat([bp, bv])))
    split_at = tuple(lin.out_features for lin in t_pi)
    (wp, bp), (wv, bv) = _linear(params.pi[-1]), _linear(params.vf[-1])
    a_dim, h = wp.shape
    w_head = torch.zeros((a_dim + 1, 2 * h), dtype=torch.float32, device=wp.device)
    w_head[:a_dim, :h] = wp
    w_head[a_dim:, h:] = wv
    return TransposedParams(trunk, w_head, torch.cat([bp, bv]), log_std, split_at)


def tower_params(tp: TransposedParams) -> list:
    """The ``(trunk, w_head, b_head)`` of each tower the K3 kernel runs:
    the shared trunk with its merged ``(A+1)``-row head, or the pi tower
    with its ``A`` head rows and the vf tower with its value row, each cut
    from its blocks of the stacked trunk."""
    if tp.split_at is None:
        return [(tp.trunk, tp.w_head, tp.b_head)]
    a_dim, h = tp.log_std.shape[0], tp.split_at[-1]
    towers = []
    for blk, rows in ((0, slice(0, a_dim)), (1, slice(a_dim, a_dim + 1))):
        trunk = [(w[blk * wo:(blk + 1) * wo], b[blk * wo:(blk + 1) * wo])
                 for (w, b), wo in zip(tp.trunk, tp.split_at)]
        towers.append((trunk, tp.w_head[rows, blk * h:(blk + 1) * h], tp.b_head[rows]))
    return towers


# ------------------------------------------------------------- native noise
def philox_noise(seed: int, run_steps: int, num_trajectories: int, device=None, a_dim: int = A_DIM,
                 exomm: bool = False, mid2: bool = False) -> torch.Tensor:
    """The kernel's native noise as ``(run_steps, n_noise_channels(a_dim,
    exomm, mid2), N)`` float32 channels: Philox4x32-10 keyed by ``(seed,
    env)``; counter ``(step, 0)`` gives the four arrival/fill uniforms and
    ``(step, 1)`` four Box-Muller uniforms, whose pairs give eps0, eps1 and
    the midprice normal.  At ``a_dim`` 4 a third call, counter ``(step,
    2)``, gives one more pair (r2 from its first word, theta2 from its
    second): eps2 = r2 cos theta2, eps3 = r2 sin theta2.  The extra normals
    of the exogenous-MM and 2-dim midprice kinds: the exogenous bid's is
    the spare r1 sin theta1 of counter 1, and a fourth call, counter
    ``(step, 3)``, gives one more pair (words x, y): the exogenous ask's
    r3 cos theta3 and the second midprice column's r3 sin theta3.  Every
    earlier channel keeps its bits."""
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
    eps = [r0 * torch.cos(th0), r1 * torch.cos(th1)]
    if a_dim > 2:
        c = philox4x32_10((steps, zero + 2, zero, zero), key)
        r2 = torch.sqrt(-2.0 * torch.log(1.0 - _uniform24(c[0])))
        th2 = (2.0 * math.pi) * _uniform24(c[1])
        eps += [r2 * torch.cos(th2), r2 * torch.sin(th2)]
    extra = []
    if exomm or mid2:
        _, exo_ask, mid2_n = pk.philox_extras(seed, run_steps, num_trajectories, device, 3, "xy")
        extra = ([r1 * torch.sin(th1), exo_ask] if exomm else []) + ([mid2_n] if mid2 else [])
    return torch.stack(
        [_uniform24(a[0]), _uniform24(a[1]), _uniform24(a[2]), _uniform24(a[3]), *eps, r0 * torch.sin(th0), *extra],
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
        ("widths", ctypes.c_int * MAX_LAYERS),
        ("start_time", ctypes.c_float),
        ("dt", ctypes.c_float),
        ("obs_low", ctypes.c_float * MAX_S),
        ("obs_grad", ctypes.c_float * MAX_S),
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
        ("reward", ctypes.c_int),
        ("dt_phi", ctypes.c_float),
        ("alpha", ctypes.c_float),
        ("cjmm_coef", ctypes.c_float),
        ("inv_exp", ctypes.c_float),
        ("dynamics", ctypes.c_int),
        ("mask_mo", ctypes.c_int),
        ("half_spread", ctypes.c_float),
        ("proc_mode", ctypes.c_int),  # proc_kinds.proc_mode: the plain or the general instantiation
        ("proc", pk.ProcParams),
        # speed dynamics, the CJ execution and exponential-utility rewards,
        # the t0 plane and the terminal observation
        ("temporary_impact", ctypes.c_float),
        ("permanent_impact", ctypes.c_float),
        ("dt_alpha", ctypes.c_float),     # dt * alpha (cjoe)
        ("ep_len", ctypes.c_float),       # terminal_time - start_time (cjoe, fixed start)
        ("neg_gamma", ctypes.c_float),    # -risk_aversion (exp_utility)
        ("random_start", ctypes.c_int),   # the t0 plane is read
        ("terminal_time", ctypes.c_float),
        ("alpha_dt", ctypes.c_float),     # alpha * dt (cjmm under the t0 plane: / (terminal_time - t0))
        ("t_done", ctypes.c_float),       # terminal_time - dt / 2: a step starting at or past it is post-done
        ("t_last", ctypes.c_float),       # terminal_time - 1.5 dt: a step starting at or past it is the last
        ("t_term", ctypes.c_float),       # start_time + run_steps * dt: the terminal observation's time
    ]


def kernel_params(p: MlpRolloutParams, widths, extras: bool = False) -> MlpKernelParams:
    """The step constants of ``p``.  ``dt*phi``, ``dt*alpha``,
    ``alpha*dt/ep_len`` and the random start's thresholds are formed in
    double, as the JAX kernel forms them from Python floats; each env's
    CjMm constant ``(alpha*dt/ep_len) * q(inv0)`` is that float32 times the
    float32 ``q(inv0)`` of its initial inventory, rounded to float32, as
    the JAX kernel multiplies it by its float32 inv0 plane
    (pallas_rollout.py:1157).  ``extras`` (a t0 plane or the terminal
    observation) selects the general instantiation's extras variant."""
    a_dim = len(p.act_low)
    ep_len = p.terminal_time - p.start_time
    return MlpKernelParams(
        run_steps=p.run_steps,
        n_layers=len(widths),
        s_dim=len(p.obs_low),
        a_dim=a_dim,
        normalise_obs=int(p.normalise_obs),
        normalise_act=int(p.normalise_act),
        widths=(ctypes.c_int * MAX_LAYERS)(*widths),
        start_time=p.start_time,
        dt=p.dt,
        obs_low=(ctypes.c_float * MAX_S)(*p.obs_low),
        obs_grad=(ctypes.c_float * MAX_S)(*p.obs_grad),
        act_low=(ctypes.c_float * 4)(*p.act_low),
        act_grad=(ctypes.c_float * 4)(*p.act_grad),
        act_high=(ctypes.c_float * 4)(*(lo + 2 * g for lo, g in zip(p.act_low, p.act_grad))),
        p_arr_bid=pk.arrival_probability(p)[0],
        p_arr_ask=pk.arrival_probability(p)[1],
        neg_k=-p.fill_exponent,
        max_inventory=p.max_inventory,
        max_cash=p.max_cash,
        drift_dt=p.drift * p.dt,
        vol_sqrt_dt=p.volatility * math.sqrt(p.dt),
        initial_cash=p.initial_cash,
        initial_inventory=p.initial_inventory,
        initial_price=p.initial_price,
        logp_const=0.5 * _LOG_2PI * a_dim,
        reward=_REWARDS[p.reward_kind],
        dt_phi=p.dt * p.phi,
        alpha=p.alpha,
        cjmm_coef=p.alpha * p.dt / ep_len,
        inv_exp=p.inventory_exponent,
        dynamics=_DYNAMICS[p.dynamics_kind],
        mask_mo=int(p.mask_mo_at_max_inventory),
        half_spread=p.fixed_half_spread,
        proc_mode=pk.PROC_GENERAL if extras else pk.proc_mode(p, composite_ok=False),
        proc=pk.proc_params(p, max(a_dim, 2)),
        temporary_impact=p.temporary_impact,
        permanent_impact=p.permanent_impact,
        dt_alpha=p.dt * p.alpha,
        ep_len=ep_len,
        neg_gamma=-p.risk_aversion,
        random_start=int(p.random_start),
        terminal_time=p.terminal_time,
        alpha_dt=p.alpha * p.dt,
        t_done=p.terminal_time - p.dt / 2,
        t_last=p.terminal_time - 1.5 * p.dt,
        t_term=p.start_time + p.run_steps * p.dt,
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


def pack_mma_a(w: torch.Tensor) -> torch.Tensor:
    """A row-major ``(R, K)`` matrix (R, K multiples of 16) in the order of
    ``mma.m16n8k16``'s A fragments: for each 16 x 16 block (row blocks
    outer, k blocks inner), lane ``4 g + t`` of a warp holds its four
    registers as 8 consecutive values, rows ``g`` and ``g + 8``, columns
    ``2 t, 2 t + 1`` and ``2 t + 8, 2 t + 9``, so one 16-byte load fetches
    them.  Returns a flat tensor of ``R * K`` values."""
    r, k = w.shape
    # (row block, row half, g, k block, k half, t, column pair) ->
    # (row block, k block, g, t, k half, row half, column pair)
    return w.reshape(r // 16, 2, 8, k // 16, 2, 4, 2).permute(0, 3, 2, 5, 4, 1, 6).reshape(-1)


def pad_widths(params, multiple: int = _MMA_WIDTH):
    """A copy of the actor-critic ``params`` with every hidden width rounded
    up to a multiple of ``multiple`` (the bf16 kernel's 16, the float32
    kernel's 4): the new rows of a layer's weight and bias are zero, and so
    are the columns of the next layer (or head) that read them.  Each
    padded unit computes tanh(0) = 0 and adds exact zeros downstream, so
    the policy's outputs are unchanged."""
    from mbt_gym_torch.agents.networks import ActorCritic

    hidden = tuple(-(-h // multiple) * multiple for h in params.hidden)
    device = params.log_std.device
    padded = ActorCritic(params.obs_dim, params.action_dim, hidden, params.shared_trunk, device=device)
    with torch.no_grad():
        for lin in padded.modules():
            if isinstance(lin, torch.nn.Linear):
                lin.weight.zero_()
                lin.bias.zero_()
        pairs = (zip(params.shared, padded.shared) if params.shared_trunk
                 else zip((*params.pi, *params.vf), (*padded.pi, *padded.vf)))
        heads = ((params.pi_head, padded.pi_head), (params.vf_head, padded.vf_head)) if params.shared_trunk else ()
        for src, dst in (*pairs, *heads):
            o, i = src.weight.shape
            dst.weight[:o, :i] = src.weight
            dst.bias[:o] = src.bias
        padded.log_std.copy_(params.log_std)
    return padded


def pack_tower_bf16(trunk, w_head: torch.Tensor, b_head: torch.Tensor) -> tuple:
    """One tower (``trunk`` a list of ``(W (out, in), b)``, every width a
    multiple of 16, and its head rows) in the bf16 kernel's layout:
    ``(weights, bias, w_head, b_head)``.  The weights are every layer's
    matrix as bf16 in mma fragment order (:func:`pack_mma_a`), layer 0's
    ``S`` columns padded to 16 with zeros, layers concatenated; the biases
    concatenated; the head rows zero-padded to one 16-row block, as bf16 in
    fragment order; the head's biases as they are."""
    mats = []
    for li, (w, _) in enumerate(trunk):
        if li == 0:
            w = torch.nn.functional.pad(w, (0, _MMA_WIDTH - w.shape[1]))
        mats.append(pack_mma_a(w.to(torch.bfloat16)))
    head = torch.nn.functional.pad(w_head, (0, 0, 0, _MMA_WIDTH - w_head.shape[0]))
    return (torch.cat(mats), torch.cat([b for _, b in trunk]).contiguous(), pack_mma_a(head.to(torch.bfloat16)),
            b_head.contiguous())


# ------------------------------------------------------------ plain version
def _initial_inventory(p: MlpRolloutParams, kp: MlpKernelParams, n: int, inv0, device) -> torch.Tensor:
    if p.inventory_range:
        if inv0 is None or tuple(inv0.shape) != (n,):
            raise ValueError("inventory_range set: pass inv0 (N,) draws")
        return inv0.to(device, torch.float32)
    if inv0 is not None:
        raise ValueError("inv0 only valid with inventory_range")
    return torch.full((n,), kp.initial_inventory, dtype=torch.float32, device=device)


def _start_times(p: MlpRolloutParams, n: int, t0, final_obs: bool, device) -> Optional[torch.Tensor]:
    """The ``(N,)`` float32 t0 plane under a random start; the JAX
    wrapper's argument contract (pallas_rollout.py:1590-1625)."""
    if p.random_start:
        if t0 is None or tuple(t0.shape) != (n,):
            raise ValueError("random_start set: pass t0 (N,) start times")
        if final_obs:
            raise ValueError("final_obs with random starts: use the engine")
        return t0.to(device, torch.float32)
    if t0 is not None:
        raise ValueError("t0 only valid with a random start_time spec")
    return None


def mlp_rollout_plain(p: MlpRolloutParams, params, seed: int = 0, num_trajectories: int = 16384,
                      noise: Optional[torch.Tensor] = None, device=None, inv0: Optional[torch.Tensor] = None,
                      t0: Optional[torch.Tensor] = None, final_obs: bool = False,
                      sum_dtype: torch.dtype = torch.float32):
    """Plain PyTorch K3 on any device; returns what :func:`mlp_rollout`
    returns.  ``sum_dtype=torch.float64`` keeps the operands' roundings and
    takes each product's sums in float64 (everything else in float32): the
    reference against which the card's checks measure how far two float32
    summation orders drift apart on deep and wide bf16 trunks."""
    device = noise.device if noise is not None else resolve_device(device)
    n = num_trajectories
    tp = transpose_params(params)
    trunk = [(w.to(device), b.to(device)) for w, b in tp.trunk]
    start = _start_times(p, n, t0, final_obs, device)
    kp = kernel_params(p, tp.split_at or [w.shape[0] for w, _ in trunk], extras=start is not None or final_obs)
    T, S, A = kp.run_steps, kp.s_dim, kp.a_dim
    if noise is None:
        noise = philox_noise(seed, T, n, device, A, p.fill_kind == "exomm", p.has_mid2)
    else:
        _check_noise(p, n, noise)
    mid_ch = 4 + max(A, 2)
    pp = kp.proc
    names = pk.state_planes(p, speed=p.speed)
    rnd = bf16_round if p.normalise_obs else (lambda x: x)
    trunk = [(rnd(w), b[:, None]) for w, b in trunk]
    w_head, b_head = rnd(tp.w_head.to(device)), tp.b_head.to(device)[:, None]

    def mm(w, h):  # a product's sums in sum_dtype
        return w @ h if sum_dtype == torch.float32 else (w.to(sum_dtype) @ h.to(sum_dtype)).to(torch.float32)

    log_std = tp.log_std.to(device)
    std = torch.exp(log_std)
    f32 = torch.float32
    obs_out = torch.empty((T, S, n), dtype=f32, device=device)
    act_out = torch.empty((T, A, n), dtype=f32, device=device)
    logp_out, val_out, rew_out = (torch.empty((T, n), dtype=f32, device=device) for _ in range(3))
    cash = torch.full((n,), kp.initial_cash, dtype=f32, device=device)
    inv = _initial_inventory(p, kp, n, inv0, device)
    price = torch.full((n,), kp.initial_price, dtype=f32, device=device)
    ps = pk.initial_planes(pp, names, cash)  # the process states past the price
    q0 = q_pow(inv, kp.inv_exp)
    if start is None:
        cjmm_const = kp.cjmm_coef * q0  # per env under inventory_range
        ep_len = kp.ep_len
    else:  # per-env episode lengths (pallas_rollout.py:1352-1358)
        ep_len = kp.terminal_time - start
        cjmm_const = (torch.full_like(ep_len, kp.alpha_dt) / ep_len) * q0
    with full_float32_matmul():
        for i in range(T):
            step_t = float(np.float32(i) * np.float32(kp.dt))
            if start is None:
                t = float(np.float32(kp.start_time) + np.float32(step_t))
                last = i == T - 1
            else:  # pallas_rollout.py:1303-1320
                t_start = start + step_t
                t = torch.clamp(t_start, max=kp.terminal_time)
                was_done = t_start >= kp.t_done
                last = t_start >= kp.t_last
            X = obs_planes(kp, t, (cash, inv, price, *(ps[name] for name in names)))
            obs_out[i] = X
            h = X
            for li, (w, b) in enumerate(trunk):
                if tp.split_at is None or li == 0:
                    pre = mm(w, rnd(h))
                else:  # stacked towers: one product per tower on its row blocks
                    wo, wi = tp.split_at[li], tp.split_at[li - 1]
                    pre = torch.cat([mm(w[:wo], rnd(h[:wi])), mm(w[wo:], rnd(h[wi:]))])
                h = torch.tanh(pre + b)
            hd = mm(w_head, rnd(h)) + b_head
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
            before = dict(ps) if start is not None else None  # the process states a post-done step keeps
            hit_bid = hit_ask = None
            if p.speed:  # impact at the pre-update state (pallas_rollout.py:1056-1072)
                speed = exec_action[0]
                impact = pk.speed_impact(pp, kp, ps, speed)
                volume = speed * kp.dt
                new_inv = inv + volume
                new_cash = cash - volume * (price + impact)
            elif kp.proc_mode:
                new_inv, new_cash, hit_bid, hit_ask = pk.market_step(p.dynamics_kind, kp, pp, ps, d, exec_action,
                                                                     cash, inv, price)
            else:
                new_inv, new_cash = market_making_step(p.dynamics_kind, kp, d, exec_action, cash, inv, price)
            new_inv = torch.clamp(new_inv, -kp.max_inventory, kp.max_inventory)
            new_cash = torch.clamp(new_cash, -kp.max_cash, kp.max_cash)
            if kp.proc_mode:
                new_price = pk.midprice_update(pp, kp, ps, price, d[mid_ch], d[pp.ch_mid2] if pp.ch_mid2 >= 0 else None,
                                               hit_bid, hit_ask)
            else:
                new_price = price + kp.drift_dt + kp.vol_sqrt_dt * d[mid_ch]
            terminal = last.to(f32) if isinstance(last, torch.Tensor) else (1.0 if last else 0.0)
            if p.reward_kind == "exp_utility":  # pallas_rollout.py:1173-1179
                reward = terminal * -torch.exp(kp.neg_gamma * (new_cash + new_inv * new_price))
            else:
                reward = (new_cash + new_inv * new_price) - (cash + inv * price)
            if p.reward_kind in ("cjmm", "running", "cjoe"):  # pallas_rollout.py:1150-1172, in its op order
                q_new = q_pow(new_inv, kp.inv_exp)
                if p.reward_kind == "cjmm":
                    reward = reward - kp.dt_phi * q_new - kp.alpha * (q_new - q_pow(inv, kp.inv_exp)) - cjmm_const
                elif p.reward_kind == "cjoe":
                    e = kp.inv_exp
                    reward = reward - kp.dt_phi * q_new - kp.dt_alpha * (
                        e * exec_action[0] * q_pow(inv, e - 1.0) + q0 * ep_len)
                else:  # "running": the terminal penalty at the last step only
                    reward = reward - kp.dt_phi * q_new - (kp.alpha * terminal) * q_new
            if start is not None:  # post-done steps frozen, their rewards zero
                reward = torch.where(was_done, torch.zeros_like(reward), reward)
                new_cash, new_inv, new_price = (torch.where(was_done, old, new) for old, new in
                                                ((cash, new_cash), (inv, new_inv), (price, new_price)))
                ps.update({k: torch.where(was_done, before[k], v) for k, v in ps.items()})
            rew_out[i] = reward
            cash, inv, price = new_cash, new_inv, new_price
    outs = (obs_out, act_out, logp_out, val_out, rew_out)
    if final_obs:  # the terminal observation (pallas_rollout.py:1432-1438)
        outs += (obs_planes(kp, kp.t_term, (cash, inv, price, *(ps[name] for name in names))),)
    return outs


# ------------------------------------------------------------ kernel wrapper
def _check_noise(p: MlpRolloutParams, n: int, noise: torch.Tensor) -> None:
    want = (p.run_steps, p.n_channels, n)
    if noise.dtype != torch.float32 or tuple(noise.shape) != want:
        raise ValueError(f"noise must be float32 of shape {want}; got {noise.dtype} {tuple(noise.shape)}")


def _kernels(wide: bool = False) -> ctypes.CDLL:
    """K3's library: the bf16 wide route's (``wide``: a bf16 trunk that
    takes a scratch, :func:`k3_scratch_bytes`) or every other route's."""
    lib = _build.load("mlp_rollout_wide.cu" if wide else "mlp_rollout.cu")
    if not getattr(lib, "_mbt_declared", False):
        ptr, i32, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
        lib.mbt_mlp_rollout.argtypes = [ptr, i32, i32, u32, ptr, ptr, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                                        ptr, ptr, ptr, ptr]
        lib.mbt_mlp_rollout.restype = i32
        lib._mbt_declared = True
    return lib


def check_kernel_shapes(p: MlpRolloutParams, widths, n: int) -> None:
    """The K3 kernel's limits on the config, the (per-tower) trunk widths
    and the env count; ``ValueError`` naming the first one broken.  Every
    width is taken (the wrapper pads it); the depth up to
    :data:`MAX_LAYERS`."""
    s_dim = 4 + len(pk.state_planes(p, speed=p.speed))
    if len(p.obs_low) != s_dim or s_dim > MAX_S or len(p.act_low) != p.a_dim:
        raise ValueError(f"the K3 kernel takes S={s_dim} (at most {MAX_S}), A={p.a_dim} on {p.dynamics_kind} "
                         f"dynamics; got {len(p.obs_low)}, {len(p.act_low)}")
    if not 1 <= len(widths) <= MAX_LAYERS:
        raise ValueError(f"the K3 kernel takes 1-{MAX_LAYERS} trunk layers; got {len(widths)}")
    if n % _ENV_TILE:
        raise ValueError(f"the K3 kernel takes a multiple of {_ENV_TILE} envs; got {n}")


def k3_scratch_bytes(widths, bf16: bool, s_dim: int, a_dim: int, n: int) -> int:
    """The device scratch K3 takes at the (per-tower) ``widths``, padded as
    the wrapper pads them, for ``n`` envs, 0 where its activation tiles fit
    in shared memory: in
    bf16 past 256 rows (the wide route; at most 256 rows the narrow route's
    shared memory always fits, its inner weights read from device memory
    where they do not), two ``[max width][128]`` bf16 tiles a CTA; in
    float32 where ``csrc/mlp_rollout.cu``'s ``cc::layout`` exceeds
    :data:`SMEM_OPTIN`, two ``[h_max][32]`` float tiles a CTA."""
    multiple = _MMA_WIDTH if bf16 else _F32_WIDTH
    widths = [-(-w // multiple) * multiple for w in widths]
    if bf16:
        if max(widths) <= _PASS_ROWS:
            return 0
        return -(-n // _BF16_TILE) * 2 * max(widths) * _BF16_TILE * 2
    h_max = max(s_dim, *widths)
    n_head = a_dim + 1
    smem = 4 * (2 * h_max * _ENV_TILE + n_head * widths[-1] + n_head * _ENV_TILE + sum(widths))
    if smem <= SMEM_OPTIN:
        return 0
    return n // _ENV_TILE * 2 * h_max * _ENV_TILE * 4


def mlp_rollout(p: MlpRolloutParams, params, seed: int = 0, num_trajectories: int = 16384,
                noise: Optional[torch.Tensor] = None, device=None, inv0: Optional[torch.Tensor] = None,
                t0: Optional[torch.Tensor] = None, final_obs: bool = False, out=None):
    """K3: one full episode for ``num_trajectories`` envs with the MLP
    policy fused in.  Returns ``(obs (T, S, N), actions (T, A, N),
    log_probs (T, N), values (T, N), rewards (T, N))``, float32, and with
    ``final_obs`` the terminal observation ``(S, N)`` after them.

    ``noise`` (optional) injects ``(T, p.n_channels, N)`` channels;
    otherwise native Philox noise keyed by ``seed``.  ``inv0`` is the
    ``(N,)`` per-env initial inventory, required under
    ``p.inventory_range`` and refused otherwise; ``t0`` the ``(N,)``
    per-env start times, required under ``p.random_start`` (on the step
    grid; :func:`collect_rollout_fused_T` draws one shared value per
    episode) and refused otherwise, as is ``final_obs`` with it.  ``out``
    (optional) holds the output tensors to write (contiguous, of the
    shapes and dtype returned), which are returned.  On a CPU target this
    is :func:`mlp_rollout_plain`; on CUDA it launches the kernel."""
    device = _target(noise, device)
    if device.type == "cpu":
        result = mlp_rollout_plain(p, params, seed, num_trajectories, noise, device, inv0, t0, final_obs)
        if out is None:
            return result
        _check_out(out, tuple(tuple(x.shape) for x in result), device)
        for o, x in zip(out, result):
            o.copy_(x)
        return tuple(out)
    if device.type != "cuda":
        raise ValueError(f"the rollout kernel runs on CUDA devices, not {device}")
    # the host's work before the launch: checks, the parameters' transpose,
    # padding and packing, the planes, the outputs and the scratch
    with span("mbt.k3.prepare"):
        n = num_trajectories
        tp = transpose_params(params)
        widths = list(tp.split_at or [w.shape[0] for w, _ in tp.trunk])
        check_kernel_shapes(p, widths, n)
        if noise is not None:
            _check_noise(p, n, noise)
            if not noise.is_contiguous():
                raise ValueError("noise must be contiguous")
        start = _start_times(p, n, t0, final_obs, device)
        bf16 = bool(p.normalise_obs)
        padded = pad_widths(params, _MMA_WIDTH if bf16 else _F32_WIDTH)
        widths = list(padded.hidden)
        towers = tower_params(transpose_params(padded))
        if bf16:  # the tensor-core kernel's layout
            tensors = [pack_tower_bf16([(w.to(device), b.to(device)) for w, b in trunk], w_head.to(device),
                                       b_head.to(device)) for trunk, w_head, b_head in towers]
        else:  # each layer's (in, out) matrix, layers concatenated; the head rows
            tensors = [(torch.cat([w.to(device).T.contiguous().reshape(-1) for w, _ in trunk]),
                        torch.cat([b.to(device) for _, b in trunk]).contiguous(),
                        w_head.to(device).contiguous(), b_head.to(device).contiguous())
                       for trunk, w_head, b_head in towers]
        # `tensors` stays alive until the launch returns
        kp = kernel_params(p, widths, extras=start is not None or final_obs)
        T, S, A = kp.run_steps, kp.s_dim, kp.a_dim
        if p.inventory_range:
            inv0 = _initial_inventory(p, kp, n, inv0, device).contiguous()
        elif inv0 is not None:
            raise ValueError("inv0 only valid with inventory_range")
        if start is not None:
            start = start.contiguous()
        pointers = [(ctypes.c_void_p * 4)(*(x.data_ptr() for x in t)) for t in tensors]
        if len(pointers) == 1:
            pointers.append((ctypes.c_void_p * 4)())
        log_std = tp.log_std.to(device).contiguous()
        f32 = torch.float32
        shapes = ((T, S, n), (T, A, n), (T, n), (T, n), (T, n)) + (((S, n),) if final_obs else ())
        if out is None:
            out = tuple(torch.empty(shape, dtype=f32, device=device) for shape in shapes)
        else:
            _check_out(out, shapes, device)
        obs, act, logp, val, rew = out[:5]
        fin = out[5] if final_obs else None
        scratch_bytes = k3_scratch_bytes(widths, bf16, S, A, n)
        scratch = torch.empty(scratch_bytes, dtype=torch.uint8, device=device) if scratch_bytes else None
    with span("mbt.k3.launch"):
        index, stream = _build.device_stream(device)
        rc = _kernels(bf16 and scratch is not None).mbt_mlp_rollout(
            ctypes.byref(kp), index, n, int(seed) & _MASK32,
            None if noise is None else noise.data_ptr(), None if inv0 is None else inv0.data_ptr(), int(bf16),
            pointers[0], pointers[1], log_std.data_ptr(),
            obs.data_ptr(), act.data_ptr(), logp.data_ptr(), val.data_ptr(), rew.data_ptr(),
            None if start is None else start.data_ptr(), None if fin is None else fin.data_ptr(),
            None if scratch is None else scratch.data_ptr(), stream,
        )
        if rc != 0:
            raise RuntimeError(f"mlp_rollout kernel launch failed: CUDA error {rc}")
        _build.count_launch("mlp_rollout")
    return tuple(out)


def _check_out(out, shapes, device) -> None:
    """``out=`` of :func:`mlp_rollout`: one contiguous float32 tensor on
    ``device`` per output, of its shape."""
    got = tuple((tuple(x.shape), x.dtype, x.device.type, x.is_contiguous()) for x in out)
    want = tuple((shape, torch.float32, device.type, True) for shape in shapes)
    if got != want:
        raise ValueError(f"out must be contiguous float32 tensors on {device} of shapes {shapes}; got {got}")


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


def rollout_fused_T(env_cfg: EnvConfig, params, key, noise: Optional[torch.Tensor] = None, device=None,
                    inv0: Optional[torch.Tensor] = None, t0: Optional[torch.Tensor] = None, out=None):
    """K3's five feature-major outputs ``(obs (T, S, N), actions (T, A,
    N), log_probs, values, rewards (T, N))`` for ``env_cfg``, written into
    ``out`` where given (:func:`mlp_rollout`'s).  ``key`` (an int seed or a
    ``torch.Generator``) gives the kernel's Philox seed; ``noise`` injects
    ``(T, p.n_channels, N)`` channels instead.  Under a random initial
    inventory (``initial_inventory=(lo, hi)``) the per-env draws in [lo,
    hi) come from ``key`` first, each episode (the distribution of
    ``env.reset``); ``inv0`` injects them (the parity tests).  Under a
    random start time (``start_time=("uniform", lo, hi)``) one shared start
    per episode, quantised to the step grid as ``env.reset`` draws it,
    comes from ``key`` next and fills the kernel's t0 plane; ``t0`` injects
    an ``(N,)`` plane (per-env values are taken).  Post-done steps are
    frozen with zero rewards, so GAE over the full horizon sees the
    engine's masking."""
    from mbt_gym_torch.env import make_generator
    from mbt_gym_torch.ops.episode import seed_from_key

    with span("mbt.k3.prepare"):  # the episode's draws and seed
        p = rollout_params_from_config(env_cfg)
        n = env_cfg.num_trajectories
        target = _target(noise, device)
        if (p.inventory_range and inv0 is None) or (p.random_start and t0 is None):
            key = make_generator(key, target)
        if p.inventory_range and inv0 is None:
            lo, hi = p.inventory_range
            inv0 = torch.randint(lo, hi, (n,), generator=key, device=target).to(torch.float32)
        if p.random_start and t0 is None:  # env.reset's draw (mbt_gym_torch/env.py)
            _, lo, hi = env_cfg.start_time
            raw = torch.rand((), generator=key, dtype=torch.float32, device=target) * (hi - lo) + lo
            t0 = (torch.round(raw / env_cfg.step_size) * env_cfg.step_size).expand(n)
        seed = 0 if noise is not None else seed_from_key(key)
    return mlp_rollout(p, params, seed, n, noise=noise, device=device, inv0=inv0, t0=t0, out=out)


def gae_T(outputs, gamma: float = 1.0, lam: float = 0.95) -> TRolloutBatch:
    """The :class:`TRolloutBatch` of K3's five ``outputs``: GAE over the
    full horizon, terminal value 0."""
    from mbt_gym_torch.agents.ppo import compute_gae

    obs_t, actions_t, log_probs, values, rewards = outputs
    advantages, returns = compute_gae(rewards, values, torch.zeros_like(values[0]), gamma, lam)
    return TRolloutBatch(obs_t, actions_t, log_probs, values, rewards, advantages, returns)


def collect_rollout_fused_T(env_cfg: EnvConfig, params, key, gamma: float = 1.0, lam: float = 0.95,
                            noise: Optional[torch.Tensor] = None, device=None,
                            inv0: Optional[torch.Tensor] = None, t0: Optional[torch.Tensor] = None,
                            out=None) -> TRolloutBatch:
    """K3 rollout in its feature-major layout + GAE — the input of
    :func:`mbt_gym_torch.ops.fused_ppo.ppo_fused_grads_T`
    (pallas_rollout.py:2198-2256): :func:`rollout_fused_T` (its ``key``,
    ``noise``, ``inv0``, ``t0`` and ``out``), then :func:`gae_T`."""
    outputs = rollout_fused_T(env_cfg, params, key, noise=noise, device=device, inv0=inv0, t0=t0, out=out)
    with span("mbt.k3.gae"):
        return gae_T(outputs, gamma, lam)


def row_major(tb: TRolloutBatch):
    """The row-major :class:`~mbt_gym_torch.agents.ppo.RolloutBatch` of a
    feature-major one (obs ``(T, N, S)``, actions ``(T, N, A)``; views, no
    copy)."""
    from mbt_gym_torch.agents.ppo import RolloutBatch

    return RolloutBatch(
        obs=tb.obs_t.transpose(1, 2), actions=tb.actions_t.transpose(1, 2),
        log_probs=tb.log_probs, values=tb.values, rewards=tb.rewards,
        advantages=tb.advantages, returns=tb.returns,
    )


def collect_rollout_fused(env_cfg: EnvConfig, params, key, gamma: float = 1.0, lam: float = 0.95,
                          noise: Optional[torch.Tensor] = None, device=None, inv0: Optional[torch.Tensor] = None,
                          t0: Optional[torch.Tensor] = None):
    """Drop-in for :func:`mbt_gym_torch.agents.ppo.collect_rollout`: the
    row-major :class:`~mbt_gym_torch.agents.ppo.RolloutBatch` of a K3
    rollout (obs ``(T, N, S)``, actions ``(T, N, A)``; views, no copy)."""
    return row_major(collect_rollout_fused_T(env_cfg, params, key, gamma, lam, noise=noise, device=device,
                                             inv0=inv0, t0=t0))
