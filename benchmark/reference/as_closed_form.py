"""The plain reference of the Avellaneda-Stoikov Monte Carlo cells: the
closed-form AS market maker (Avellaneda & Stoikov 2008; mbt_gym's
``AvellanedaStoikovAgent``) on the AS env, in plain PyTorch.

At time ``t`` with inventory ``q`` the agent quotes bid and ask depths
``+/- q gamma sigma^2 (T - t)`` around half the optimal spread
``gamma sigma^2 (T - t) / 2 + ln(1 + gamma / k) / gamma``.  The env books
Poisson arrivals (``u < A dt``) thinned by exponential fills (``u <
exp(-k depth)``) on the pre-step inventory, clips inventory and cash and
moves the midprice by ``sigma sqrt(dt) N(0, 1)``.  The PnL of an episode is
its terminal mark-to-market minus the initial value.  The noise is the
Philox stream the port's AS kernels draw in native mode (counter ``(step,
0)`` the four uniforms, ``(step, 1)`` a Box-Muller pair for the midprice),
seeded per episode by ``seed0 + episode``, ``seed0`` a 30-bit draw of a
host generator seeded with the call's key.

``dtype`` is the precision of the state's arithmetic: float32 as the
configuration states, bfloat16 for the control.  Nothing here imports the
port.
"""
from __future__ import annotations

import math

import torch

from benchmark.reference import philox
from benchmark.reference.market_making import Env

STEP_CHUNK = 25  # steps whose Philox words are drawn at once


def episode_seed(key: int) -> int:
    gen = torch.Generator().manual_seed(int(key))
    return int(torch.randint(0, 2**30, (), generator=gen))


def _noise(seed: int, steps: torch.Tensor, n: int):
    t = steps[:, None]
    env = torch.arange(n, dtype=torch.int64, device=steps.device)[None, :]
    zero = torch.zeros_like(t)
    key = (int(seed) & philox.MASK32, env)
    a = philox.philox4x32_10((t, zero, zero, zero), key)
    b = philox.philox4x32_10((t, zero + 1, zero, zero), key)
    u = [philox.uniform24(w) for w in a]
    normal = torch.sqrt(-2.0 * torch.log(1.0 - philox.uniform24(b[0]))) * torch.cos(
        (2.0 * math.pi) * philox.uniform24(b[1]))
    return u, normal


@torch.no_grad()
def terminal_state(env: Env, gamma: float, seed: int, n: int, device, dtype=torch.float32):
    """``(cash, inventory, price)`` after one episode of ``n`` envs."""
    sigma2, k = env.volatility**2, env.fill_exponent
    half_gss = 0.5 * gamma * sigma2
    const_half = math.log(1.0 + gamma / k) / gamma if gamma > 0 else 1.0 / k
    cash = torch.full((n,), env.initial_cash, dtype=dtype, device=device)
    inv = torch.full((n,), env.initial_inventory, dtype=dtype, device=device)
    price = torch.full((n,), env.initial_price, dtype=dtype, device=device)
    f32 = torch.float32
    for c0 in range(0, env.n_steps, STEP_CHUNK):
        steps = torch.arange(c0, min(c0 + STEP_CHUNK, env.n_steps), dtype=torch.int64, device=device)
        u, normal = _noise(seed, steps, n)
        for j, i in enumerate(steps.tolist()):
            t = float(torch.tensor(i, dtype=f32) * torch.tensor(env.dt, dtype=f32))
            tau = float(torch.tensor(env.terminal_time, dtype=f32) - torch.tensor(t, dtype=f32))
            half_spread = float(torch.tensor(half_gss, dtype=f32) * torch.tensor(tau, dtype=f32)
                                + torch.tensor(const_half, dtype=f32))
            skew = inv * (gamma * sigma2) * tau
            bid = skew + half_spread
            ask = -skew + half_spread
            arr_bid = (u[0][j] < env.p_arrival).to(dtype)
            arr_ask = (u[1][j] < env.p_arrival).to(dtype)
            fill_bid = (u[2][j] < torch.exp(-k * bid).to(f32)).to(dtype) * (inv < env.max_inventory).to(dtype)
            fill_ask = (u[3][j] < torch.exp(-k * ask).to(f32)).to(dtype) * (inv > -env.max_inventory).to(dtype)
            hit_bid, hit_ask = arr_bid * fill_bid, arr_ask * fill_ask
            inv = inv + hit_bid - hit_ask
            cash = torch.clamp(cash - hit_bid * (price - bid) + hit_ask * (price + ask), -env.max_cash, env.max_cash)
            price = price + env.drift * env.dt + (env.volatility * math.sqrt(env.dt)) * normal[j].to(dtype)
    return cash, inv, price


def mc_stats(env: Env, gamma: float, key: int, n: int, episodes: int, device, dtype=torch.float32) -> dict:
    """The call's summary: the mean and standard deviation of the episode
    PnL and of the terminal inventory over ``episodes`` x ``n`` paths."""
    seed0 = episode_seed(key)
    initial = env.initial_cash + env.initial_inventory * env.initial_price
    sums = torch.zeros(4, dtype=torch.float64, device=device)
    for e in range(episodes):
        cash, inv, price = terminal_state(env, gamma, seed0 + e, n, device, dtype)
        pnl = (cash + inv * price).to(torch.float32) - initial
        inv = inv.to(torch.float32)
        sums += torch.stack([pnl.mean(), (pnl * pnl).mean(), inv.mean(), (inv * inv).mean()]).to(torch.float64)
    m_pnl, m_pnl2, m_inv, m_inv2 = (sums / episodes).tolist()
    return {"mean_pnl": m_pnl, "std_pnl": math.sqrt(max(m_pnl2 - m_pnl**2, 0.0)),
            "mean_terminal_inventory": m_inv, "std_terminal_inventory": math.sqrt(max(m_inv2 - m_inv**2, 0.0))}
