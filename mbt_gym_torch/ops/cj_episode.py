"""CJP market-making episode kernel K8 (counterpart of the CJ part of
``mbt_gym_tpu/ops/pallas_episode.py``), beside its plain PyTorch version.

:func:`cj_episode` replaces ``cj_episode_pallas``
(``ops/pallas_episode.py:409``): one whole CJP 2015 market-making episode
per env, quoting from the closed-form depth table per step, returning only
the terminal ``(cash, inventory, price, sum q_t^2)``.  The CjMm episode
reward telescopes to those (:func:`cj_episode_rewards`), which is the
value-function lane of the CJP replication.  CUDA C++ in
``csrc/cj_episode.cu``, on the step pipeline of ``csrc/step_pipeline.cuh``
with the geometry of :func:`kernel_geometry`; the fill probabilities
``exp(-k * depth)`` of the table it stages come from
:func:`cj_fill_table`.

The JAX kernel has hardware PRNG only.  This one also has a noise mode in
K1's ``(T, 5, N)`` layout (arrival-bid u, arrival-ask u, fill-bid u,
fill-ask u, midprice normal), and its native mode draws K1's Philox
stream (:func:`mbt_gym_torch.ops.episode.philox_noise`): on the same
noise its terminal state equals K5's table stats mode on the same CJ
config.

Which path a call takes depends only on the device of its tensors: CPU
tensors run :func:`cj_episode_plain`, CUDA tensors launch the kernel or
raise.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from mbt_gym_torch.env import EnvConfig, resolve_device
from mbt_gym_torch.ops import _build
from mbt_gym_torch.ops.episode import _MASK32, _target, philox_noise
from mbt_gym_torch.ops.step_pipeline import PipelineGeometry, pipeline_geometry


class CjEpisodeParams(NamedTuple):
    """Scalars of the CJP market-making episode (pallas_episode.py:283-305)."""

    n_steps: int
    dt: float
    drift: float
    volatility: float
    initial_price: float
    intensity_bid: float
    intensity_ask: float
    fill_exponent: float
    max_inventory: float  # fill-masking bound (the env's max_inventory)
    terminal_time: float
    phi: float  # per-step inventory aversion
    alpha: float  # terminal inventory aversion


def cj_params_from_config(cfg: EnvConfig) -> CjEpisodeParams:
    """pallas_episode.py:308-342: ``AssertionError`` on any feature outside
    the kernel's contract."""
    from mbt_gym_torch.dynamics import LimitOrderDynamics
    from mbt_gym_torch.processes.arrivals import PoissonArrivals
    from mbt_gym_torch.processes.fills import ExponentialFill
    from mbt_gym_torch.processes.midprice import BrownianMotionMidprice
    from mbt_gym_torch.rewards import CjMmCriterion

    d = cfg.dynamics
    assert isinstance(d, LimitOrderDynamics) and d.action_dim == 2, (
        "CJ episode kernel: pure limit-order dynamics only"
    )
    assert isinstance(d.midprice_model, BrownianMotionMidprice), "CJ episode kernel: Brownian-motion midprice only"
    assert isinstance(d.arrival_model, PoissonArrivals), "CJ episode kernel: Poisson arrivals only"
    assert isinstance(d.fill_probability_model, ExponentialFill), "CJ episode kernel: exponential fills only"
    r = cfg.reward_function
    assert isinstance(r, CjMmCriterion) and r.inventory_exponent == 2.0, (
        "CJ episode kernel: the CJ market-making criterion with inventory exponent 2 only"
    )
    assert not cfg.normalise_action_space and not cfg.normalise_observation_space, (
        "CJ episode kernel: raw action and observation spaces only"
    )
    assert cfg.initial_cash == 0.0 and cfg.initial_inventory == 0 and cfg.start_time == 0.0, (
        "CJ episode kernel assumes cash0=inv0=0 at t=0"
    )
    assert cfg.dtype == "float32", "the CJ episode kernel computes in float32"
    return CjEpisodeParams(
        n_steps=cfg.n_steps,
        dt=cfg.step_size,
        drift=d.midprice_model.drift,
        volatility=d.midprice_model.volatility,
        initial_price=d.midprice_model.initial_price,
        intensity_bid=d.arrival_model.intensity[0],
        intensity_ask=d.arrival_model.intensity[1],
        fill_exponent=d.fill_probability_model.fill_exponent,
        max_inventory=float(cfg.max_inventory),
        terminal_time=cfg.terminal_time,
        phi=r.per_step_inventory_aversion,
        alpha=r.terminal_inventory_aversion,
    )


class CjKernelParams(ctypes.Structure):
    """float32 step constants shared by the plain version and the kernel,
    then the kernel's step-pipeline geometry (``struct CjKernelParams`` in
    ``csrc/cj_episode.cu``)."""

    _fields_ = [
        ("n_steps", ctypes.c_int),
        ("q_cap", ctypes.c_int),
        ("p_arr_bid", ctypes.c_float),
        ("p_arr_ask", ctypes.c_float),
        ("neg_k", ctypes.c_float),
        ("max_inventory", ctypes.c_float),
        ("drift_dt", ctypes.c_float),
        ("vol_sqrt_dt", ctypes.c_float),
        ("initial_price", ctypes.c_float),
        ("pipe", PipelineGeometry),
    ]


def kernel_geometry(p: CjEpisodeParams, q_cap: int, num_trajectories: int):
    """K8's step-pipeline geometry (:func:`pipeline_geometry`): limit
    dynamics, the terminal state alone, and each step's interleaved
    ``(2Q+1, 2)`` rows of two tables (the depths and their fill
    probabilities) staged where they fit; the wide shape at wide calls."""
    return pipeline_geometry(num_trajectories, p.n_steps, "limit", "table", True, 2 * (2 * q_cap + 1), table_rows=2)


def kernel_params(p: CjEpisodeParams, q_cap: int) -> CjKernelParams:
    return CjKernelParams(
        n_steps=p.n_steps,
        q_cap=q_cap,
        p_arr_bid=p.intensity_bid * p.dt,
        p_arr_ask=p.intensity_ask * p.dt,
        neg_k=-p.fill_exponent,
        max_inventory=p.max_inventory,
        drift_dt=p.drift * p.dt,
        vol_sqrt_dt=p.volatility * math.sqrt(p.dt),
        initial_price=p.initial_price,
    )


def _check_call(p: CjEpisodeParams, table: torch.Tensor, q_cap: int, n: int, noise) -> None:
    want = (p.n_steps, 2 * q_cap + 1, 2)
    assert tuple(table.shape) == want, (tuple(table.shape), want)
    if noise is not None and (noise.dtype != torch.float32 or tuple(noise.shape) != (p.n_steps, 5, n)):
        raise ValueError(
            f"noise must be float32 of shape ({p.n_steps}, 5, {n}); got {noise.dtype} {tuple(noise.shape)}"
        )


def cj_fill_table_plain(p: CjEpisodeParams, depth_table) -> torch.Tensor:
    """Plain PyTorch :func:`cj_fill_table`: ``exp(-k * depth)`` of every
    entry, on the table's device."""
    return torch.exp(kernel_params(p, 0).neg_k * torch.as_tensor(depth_table, dtype=torch.float32))


def cj_fill_table(p: CjEpisodeParams, depth_table: torch.Tensor) -> torch.Tensor:
    """The fill probabilities ``exp(-k * depth)`` of every entry of a depth
    table, the same shape: what K8's step compares its fill draws with.  On
    a CPU tensor this is :func:`cj_fill_table_plain`; on a CUDA tensor one
    launch of ``csrc/cj_episode.cu``'s fill kernel, the same ``expf`` of the
    same float as the step, so the bits agree."""
    if depth_table.device.type == "cpu":
        return cj_fill_table_plain(p, depth_table)
    if depth_table.device.type != "cuda" or depth_table.dtype != torch.float32:
        raise ValueError(f"the fill table is float32 on a CUDA device, not {depth_table.dtype} on {depth_table.device}")
    table = depth_table.contiguous()
    fill = torch.empty_like(table)
    index, stream = _build.device_stream(table.device)
    rc = _kernels().mbt_cj_fill_table(kernel_params(p, 0).neg_k, index, table.data_ptr(), fill.data_ptr(),
                                      table.numel(), stream)
    if rc != 0:
        raise RuntimeError(f"cj_fill_table kernel launch failed: CUDA error {rc}")
    return fill


def cj_episode_plain(p: CjEpisodeParams, depth_table, seed: int = 0, q_cap: int = 100,
                     num_trajectories: int = 16384, noise: Optional[torch.Tensor] = None, device=None,
                     fill_table: Optional[torch.Tensor] = None):
    """Plain PyTorch K8 on any device, in the kernel's float32 operation
    order (pallas_episode.py:365-397); returns what :func:`cj_episode`
    returns.  With ``fill_table`` (:func:`cj_fill_table` of the table) the
    fill probabilities are gathered from it instead of exponentiated per
    step, as the kernel does: the same floats."""
    device = noise.device if noise is not None else resolve_device(device)
    n = num_trajectories
    table = torch.as_tensor(depth_table, dtype=torch.float32, device=device)
    _check_call(p, table, q_cap, n, noise)
    kp = kernel_params(p, q_cap)
    if fill_table is not None:
        fill_table = torch.as_tensor(fill_table, dtype=torch.float32, device=device)
        assert fill_table.shape == table.shape, (tuple(fill_table.shape), tuple(table.shape))
    draws = philox_noise(seed, kp.n_steps, n, device) if noise is None else noise
    f32 = torch.float32
    cash, inv, sumq2 = (torch.zeros((n,), dtype=f32, device=device) for _ in range(3))
    price = torch.full((n,), kp.initial_price, dtype=f32, device=device)
    for i in range(kp.n_steps):
        d = draws[i]
        idx = torch.clamp(inv + kp.q_cap, 0, 2 * kp.q_cap).to(torch.int64)
        quotes = table[i][idx]  # (N, 2): the one-hot contraction's single term
        bid, ask = quotes[:, 0], quotes[:, 1]
        if fill_table is None:
            fill_p_bid, fill_p_ask = torch.exp(kp.neg_k * bid), torch.exp(kp.neg_k * ask)
        else:
            fill_p = fill_table[i][idx]
            fill_p_bid, fill_p_ask = fill_p[:, 0], fill_p[:, 1]
        arr_bid = (d[0] < kp.p_arr_bid).to(f32)
        arr_ask = (d[1] < kp.p_arr_ask).to(f32)
        fill_bid = (d[2] < fill_p_bid).to(f32) * (inv < kp.max_inventory).to(f32)
        fill_ask = (d[3] < fill_p_ask).to(f32) * (inv > -kp.max_inventory).to(f32)
        hit_bid = arr_bid * fill_bid
        hit_ask = arr_ask * fill_ask
        inv = inv + hit_bid - hit_ask
        cash = cash - hit_bid * (price - bid) + hit_ask * (price + ask)
        sumq2 = sumq2 + inv * inv  # post-update inventory (RewardFunctions.py:103)
        price = price + kp.drift_dt + kp.vol_sqrt_dt * d[4]
    return cash, inv, price, sumq2


def _kernels() -> ctypes.CDLL:
    lib = _build.load("cj_episode.cu")
    if not getattr(lib, "_mbt_declared", False):
        ptr, i32, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
        lib.mbt_cj_episode.argtypes = [ptr, i32, i32, u32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr]
        lib.mbt_cj_episode.restype = i32
        lib.mbt_cj_fill_table.argtypes = [ctypes.c_float, i32, ptr, ptr, ctypes.c_size_t, ptr]
        lib.mbt_cj_fill_table.restype = i32
        lib._mbt_declared = True
    return lib


def cj_episode(p: CjEpisodeParams, depth_table, seed: int = 0, q_cap: int = 100,
               num_trajectories: int = 16384, noise: Optional[torch.Tensor] = None, device=None,
               fill_table: Optional[torch.Tensor] = None):
    """K8: one whole CJP episode for ``num_trajectories`` envs; returns the
    terminal ``(cash, inventory, price, sum q_t^2)``, each ``(N,)`` float32.
    ``depth_table`` is ``(n_steps, 2*q_cap+1, 2)`` float32 — pass
    ``agent.depth_table()[:-1]``, rows indexed by step.  Fills are masked
    at the env's ``max_inventory``, not at ``q_cap``.  ``noise`` (optional)
    injects ``(n_steps, 5, N)`` channels; otherwise native Philox noise
    keyed by ``seed``.  ``fill_table`` is :func:`cj_fill_table` of the
    table, computed here where not given.  On a CPU target this is
    :func:`cj_episode_plain`; on CUDA it launches the kernel."""
    device = _target(noise, device)
    if device.type == "cpu":
        return cj_episode_plain(p, depth_table, seed, q_cap, num_trajectories, noise, device, fill_table)
    if device.type != "cuda":
        raise ValueError(f"the CJ episode kernel runs on CUDA devices, not {device}")
    n = num_trajectories
    table = torch.as_tensor(depth_table, dtype=torch.float32, device=device).contiguous()
    _check_call(p, table, q_cap, n, noise)
    if noise is not None and not noise.is_contiguous():
        raise ValueError("noise must be contiguous")
    fill = cj_fill_table(p, table) if fill_table is None else fill_table
    if fill.shape != table.shape or fill.dtype != torch.float32 or fill.device != table.device or not fill.is_contiguous():
        raise ValueError("fill_table must be the table's contiguous float32 fill probabilities, on its device")
    kp = kernel_params(p, q_cap)
    kp.pipe = kernel_geometry(p, q_cap, n).ctypes()
    outs = tuple(torch.empty(n, dtype=torch.float32, device=device) for _ in range(4))
    index, stream = _build.device_stream(device)
    rc = _kernels().mbt_cj_episode(
        ctypes.byref(kp), index, n, int(seed) & _MASK32,
        None if noise is None else noise.data_ptr(), table.data_ptr(), fill.data_ptr(),
        *(o.data_ptr() for o in outs), stream,
    )
    if rc != 0:
        raise RuntimeError(f"cj_episode kernel launch failed: CUDA error {rc}")
    _build.count_launch("cj_episode")
    return outs


def cj_episode_tables(agent, p: CjEpisodeParams, device):
    """K8's ``(n_steps, 2Q+1, 2)`` depth table of a CJ agent and its fill
    probabilities (:func:`cj_fill_table`) on ``device``, made there once per
    agent, device and fill exponent."""
    from mbt_gym_torch.agents.baseline import _device_table, agent_device_tables

    table = _device_table(agent_device_tables(agent, "K8 depth"), agent.depth_table_f32()[:-1], device)
    fill = _device_table(agent_device_tables(agent, f"K8 fill {p.fill_exponent!r}"), lambda: cj_fill_table(p, table),
                         device)
    return table, fill


def cj_episode_rewards(cfg: EnvConfig, agent, seed: int = 0, num_trajectories: int = 16384,
                       noise: Optional[torch.Tensor] = None, device=None) -> torch.Tensor:
    """Total CjMm episode rewards ``(N,)`` from K8's terminal state
    (pallas_episode.py:445-459): the PnL telescopes to terminal
    mark-to-market, the running penalty is ``phi*dt*sum q_t^2`` and the
    pathwise terminal term telescopes to ``alpha*q_T^2`` for a start at 0
    with no inventory."""
    p = cj_params_from_config(cfg)
    table, fill = cj_episode_tables(agent, p, _target(noise, device))
    cash, inv, price, sumq2 = cj_episode(p, table, seed, agent.max_inventory, num_trajectories, noise, device, fill)
    pnl = cash + inv * price - 0.0
    return pnl - p.phi * p.dt * sumq2 - p.alpha * inv**2
