"""The plain reference of the benchmark's market-making cells: the env, the
Gaussian MLP policy, PPO's rollout, GAE, loss gradients and Adam step, and
the deterministic policy's evaluation, in plain PyTorch.

It follows mbt_gym's published semantics (arXiv:2209.07823; its
``ModelDynamics``, ``RewardFunctions`` and ``TradingEnvironment``): one step
draws Poisson arrivals (``u < intensity * dt``) and exponential fills
(``u < exp(-k * depth)``) on the pre-step inventory, books them at mid -/+
depth (limit dynamics) or also fires unit market orders at mid +/- the
half-spread where a trigger column exceeds 0.5 (limit-and-market-order
dynamics), clips inventory and cash, moves the midprice by
``drift * dt + sigma * sqrt(dt) * N(0, 1)`` and pays the PnL or the
Cartea-Jaimungal market-making criterion.  Observations (cash, inventory,
time, price) and actions are scaled to [-1, 1] where the configuration says
so.  It draws its noise with :mod:`benchmark.reference.philox`, the stream
the port's kernels draw in native mode, so both sides step the same paths.

Precision is a parameter: ``rnd`` rounds every matrix-product operand (the
configuration's bf16 for the reference; a scaled fp8 for the control), the
products summed in float32 with TF32 off.  The gradient follows the
reference PPO loss (clipped surrogate plus ``vf_coef`` times half the mean
squared value error) written out by hand, the activations kept as rounded
as the operands that read them.

Nothing here imports the port; the configuration's JSON is all it reads.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, NamedTuple

import torch

from benchmark.reference import philox

LOG_2PI = math.log(2.0 * math.pi)
Rounding = Callable[[torch.Tensor], torch.Tensor]


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """Per-tensor scaled float8 (e4m3): the tensor's largest magnitude maps
    to the format's largest value, as an fp8 matrix product scales it."""
    amax = x.detach().abs().max()
    scale = torch.where(amax > 0, amax / 448.0, torch.ones_like(amax))
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


ROUNDINGS = {"bfloat16": bf16, "fp8": fp8}


@contextlib.contextmanager
def full_float32():
    """Products in full float32: TF32 off for the duration."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.set_float32_matmul_precision(old[1])


# ------------------------------------------------------------ the env
class Env(NamedTuple):
    dynamics: str  # "limit" (A = 2) or "lam" (A = 4)
    reward: str  # "pnl" or "cjmm"
    n_steps: int
    dt: float
    terminal_time: float
    initial_price: float
    drift: float
    volatility: float
    p_arrival: float
    fill_exponent: float
    max_inventory: float
    max_cash: float
    initial_cash: float
    initial_inventory: float
    inventory_range: tuple  # () or [lo, hi): a per-env draw each episode
    half_spread: float
    phi: float
    alpha: float
    normalise_obs: bool
    normalise_act: bool
    obs_low: tuple
    obs_high: tuple
    act_low: tuple
    act_high: tuple

    @property
    def a_dim(self) -> int:
        return 2 if self.dynamics == "limit" else 4

    @property
    def s_dim(self) -> int:
        return 4


def env_from_config(cfg: dict) -> Env:
    """The env of a configuration file's ``env`` section: mbt_gym's
    Avellaneda-Stoikov replication env (``as_env_config``) or the
    reference's canonical learning env (``learning_env_config``,
    experiments/helpers.py ``get_cj_env``), each with its published
    defaults for the keys the file leaves out."""
    env = cfg["env"]
    kw = env["kwargs"]
    t_end = float(kw.get("terminal_time", 1.0))
    if env["factory"] == "as_env_config":
        n_steps = int(kw.get("n_steps", 200))
        dynamics, reward = "limit", "pnl"
        price, sigma = float(kw.get("initial_price", 100.0)), float(kw.get("sigma", 2.0))
        rate, k = float(kw.get("arrival_rate", 140.0)), float(kw.get("fill_exponent", 1.5))
        inv0, inv_range, half_spread, phi, alpha = float(kw.get("initial_inventory", 0)), (), 0.0, 0.0, 0.0
    elif env["factory"] == "learning_env_config":
        rate, k = float(kw.get("arrival_rate", 10.0)), float(kw.get("fill_exponent", 0.1))
        n_steps = int(10 * t_end * rate)
        dynamics = "lam"
        phi, alpha = float(kw.get("phi", 0.5)), float(kw.get("alpha", 0.001))
        reward = "cjmm" if phi > 0 or alpha > 0 else "pnl"
        price, sigma = 100.0, float(kw.get("sigma", 0.1))
        inv_range = tuple(int(v) for v in kw.get("initial_inventory", (-5, 6)))
        inv0, half_spread = 0.0, float(kw.get("fixed_market_half_spread", 0.5))
    else:
        raise ValueError(f"no reference for the env factory {env['factory']!r}")
    max_inventory = float(n_steps)
    max_price = price + 4.0 * sigma * math.sqrt(t_end)
    max_cash = n_steps * max_price
    max_depth = -math.log(0.01) / k
    a_dim = 2 if dynamics == "limit" else 4
    act_high = (max_depth, max_depth, 1.0, 1.0)[:a_dim]
    return Env(
        dynamics=dynamics, reward=reward, n_steps=n_steps, dt=t_end / n_steps, terminal_time=t_end,
        initial_price=price, drift=0.0, volatility=sigma, p_arrival=rate * (t_end / n_steps), fill_exponent=k,
        max_inventory=max_inventory, max_cash=max_cash, initial_cash=0.0, initial_inventory=inv0,
        inventory_range=inv_range, half_spread=half_spread, phi=phi, alpha=alpha,
        normalise_obs=bool(env.get("normalise_observation_space", False)),
        normalise_act=bool(env.get("normalise_action_space", False)),
        obs_low=(-max_cash, -max_inventory, 0.0, price - 4.0 * sigma * math.sqrt(t_end)),
        obs_high=(max_cash, max_inventory, t_end, max_price),
        act_low=(0.0,) * a_dim, act_high=act_high,
    )


def _f32(x: float) -> float:
    return float(torch.tensor(x, dtype=torch.float32))


def _half_width(lo: float, hi: float) -> float:
    """Half a box's width, its bounds held in float32 as the env's spaces
    hold them."""
    return float(torch.tensor(hi, dtype=torch.float32) - torch.tensor(lo, dtype=torch.float32)) / 2.0


def observe(env: Env, t: float, cash, inv, price) -> torch.Tensor:
    time = torch.full_like(cash, t)
    planes = [cash, inv, time, price]
    if env.normalise_obs:
        planes = [(x - _f32(lo)) / torch.full_like(x, _half_width(lo, hi)) - 1.0
                  for x, lo, hi in zip(planes, env.obs_low, env.obs_high)]
    return torch.stack(planes)


def executed(env: Env, action: torch.Tensor) -> List[torch.Tensor]:
    """The actions the env executes: clipped to the box (SB3's convention),
    after scaling from [-1, 1] where actions are normalised."""
    out = []
    for a in range(env.a_dim):
        lo, hi = env.act_low[a], env.act_high[a]
        if env.normalise_act:
            out.append((torch.clamp(action[a], -1.0, 1.0) + 1.0) * _half_width(lo, hi) + _f32(lo))
        else:
            out.append(torch.clamp(action[a], _f32(lo), _f32(hi)))
    return out


def step(env: Env, u: torch.Tensor, mid_normal: torch.Tensor, act: List[torch.Tensor], cash, inv, price,
         cjmm_const):
    """One env step: the new ``(cash, inventory, price)`` and the reward."""
    f32 = torch.float32
    arr_bid = (u[0] < env.p_arrival).to(f32)
    arr_ask = (u[1] < env.p_arrival).to(f32)
    can_buy = (inv < env.max_inventory).to(f32)
    can_sell = (inv > -env.max_inventory).to(f32)
    bid, ask = act[0], act[1]
    hit_bid = arr_bid * (u[2] < torch.exp(-env.fill_exponent * bid)).to(f32) * can_buy
    hit_ask = arr_ask * (u[3] < torch.exp(-env.fill_exponent * ask)).to(f32) * can_sell
    if env.dynamics == "lam":  # the market orders book first
        mo_buy = (act[2] > 0.5).to(f32)
        mo_sell = (act[3] > 0.5).to(f32)
        new_inv = inv + (mo_buy - mo_sell) + hit_bid - hit_ask
        new_cash = (cash + mo_sell * (price - env.half_spread) - mo_buy * (price + env.half_spread)
                    - hit_bid * (price - bid) + hit_ask * (price + ask))
    else:
        new_inv = inv + hit_bid - hit_ask
        new_cash = cash - hit_bid * (price - bid) + hit_ask * (price + ask)
    new_inv = torch.clamp(new_inv, -env.max_inventory, env.max_inventory)
    new_cash = torch.clamp(new_cash, -env.max_cash, env.max_cash)
    new_price = price + env.drift * env.dt + env.volatility * math.sqrt(env.dt) * mid_normal
    reward = (new_cash + new_inv * new_price) - (cash + inv * price)
    if env.reward == "cjmm":
        q_new, q_old = new_inv * new_inv, inv * inv
        reward = reward - env.dt * env.phi * q_new - env.alpha * (q_new - q_old) - cjmm_const
    return new_cash, new_inv, new_price, reward


def key_generator(env: Env, key: int, device) -> torch.Generator:
    """The generator the port's learner draws an episode's inventories and
    seed from, for an int ``key``: on the target device under a random
    initial inventory, else on the host."""
    gen = torch.Generator(device=torch.device(device) if env.inventory_range else "cpu")
    gen.manual_seed(int(key))
    return gen


def episode_draws(env: Env, gen: torch.Generator, n: int, device) -> tuple:
    """One episode's Philox seed and ``(N,)`` initial inventories, drawn
    from ``gen`` as the port draws them with PyTorch's generators: under a
    random initial inventory the inventories first, then a 30-bit seed;
    else the seed alone."""
    if env.inventory_range:
        lo, hi = env.inventory_range
        inv0 = torch.randint(lo, hi, (n,), generator=gen, device=gen.device).to(device, torch.float32)
    else:
        inv0 = torch.full((n,), env.initial_inventory, dtype=torch.float32, device=device)
    return int(torch.randint(0, 2**30, (), generator=gen, device=gen.device)), inv0


# ------------------------------------------------------------ the policy
class Tower(NamedTuple):
    layers: list  # [(W (out, in), b (out,))]
    head_w: torch.Tensor  # (rows, H)
    head_b: torch.Tensor  # (rows,)


def towers_of(weights: Dict[str, torch.Tensor]) -> List[tuple]:
    """``[(tower, head rows)]`` of an actor-critic's weights (named as
    ``torch.nn`` names them: ``shared.{i}``/``pi_head``/``vf_head`` for a
    shared trunk, ``pi.{i}``/``vf.{i}`` for separate towers): one tower
    whose head gives the policy mean then the value, or the pi tower and
    the vf tower."""
    if "pi_head.weight" in weights:
        n = sum(1 for k in weights if k.startswith("shared.") and k.endswith(".weight"))
        layers = [(weights[f"shared.{i}.weight"], weights[f"shared.{i}.bias"]) for i in range(n)]
        head_w = torch.cat([weights["pi_head.weight"], weights["vf_head.weight"]])
        head_b = torch.cat([weights["pi_head.bias"], weights["vf_head.bias"]])
        return [Tower(layers, head_w, head_b)]
    out = []
    for name in ("pi", "vf"):
        n = sum(1 for k in weights if k.startswith(f"{name}.") and k.endswith(".weight"))
        layers = [(weights[f"{name}.{i}.weight"], weights[f"{name}.{i}.bias"]) for i in range(n - 1)]
        out.append(Tower(layers, weights[f"{name}.{n - 1}.weight"], weights[f"{name}.{n - 1}.bias"]))
    return out


def forward(weights: Dict[str, torch.Tensor], x: torch.Tensor, rnd: Rounding):
    """The policy mean ``(A, N)`` and value ``(N,)`` of feature-major
    observations ``x`` ``(S, N)``."""
    heads = []
    for tower in towers_of(weights):
        h = rnd(x)
        for w, b in tower.layers:
            h = rnd(torch.tanh(rnd(w) @ h + b[:, None]))
        heads.append(rnd(tower.head_w) @ h + tower.head_b[:, None])
    out = torch.cat(heads)
    return out[:-1], out[-1]


# ------------------------------------------------------------ rollout
class Rollout(NamedTuple):
    obs: torch.Tensor  # (T, S, N)
    actions: torch.Tensor  # (T, A, N)
    log_probs: torch.Tensor  # (T, N)
    values: torch.Tensor  # (T, N)
    rewards: torch.Tensor  # (T, N)


NOISE_CHUNK = 8  # steps whose Philox words are drawn at once


@torch.no_grad()
def rollout(env: Env, weights: Dict[str, torch.Tensor], gen: torch.Generator, n: int, rnd: Rounding, device,
            stochastic: bool = True) -> Rollout:
    """One episode of ``n`` envs under the Gaussian policy (``stochastic``)
    or its mean, its seed and inventories drawn from ``gen``."""
    device = torch.device(device)
    seed, inv = episode_draws(env, gen, n, device)
    weights = {k: v.to(device, torch.float32) for k, v in weights.items()}
    log_std = weights["log_std"]
    std = torch.exp(log_std)
    a_dim, t_count = env.a_dim, env.n_steps
    f32 = torch.float32
    obs = torch.empty((t_count, env.s_dim, n), dtype=f32, device=device)
    act = torch.empty((t_count, a_dim, n), dtype=f32, device=device)
    logp, val, rew = (torch.empty((t_count, n), dtype=f32, device=device) for _ in range(3))
    cash = torch.full((n,), env.initial_cash, dtype=f32, device=device)
    price = torch.full((n,), env.initial_price, dtype=f32, device=device)
    cjmm_const = (env.alpha * env.dt / env.terminal_time) * (inv * inv)
    noise = None
    with full_float32():
        for i in range(t_count):
            if i % NOISE_CHUNK == 0:
                steps = torch.arange(i, min(i + NOISE_CHUNK, t_count), dtype=torch.int64, device=device)
                noise = philox.step_noise(seed, steps, n, a_dim)
            j = i % NOISE_CHUNK
            eps = noise["eps"][j][:a_dim]
            t = float(torch.tensor(i, dtype=f32) * torch.tensor(env.dt, dtype=f32))
            x = observe(env, t, cash, inv, price)
            obs[i] = x
            mean, value = forward(weights, x, rnd)
            if stochastic:
                action = mean + std[:, None] * eps
                logp[i] = ((-0.5 * eps) * eps - log_std[:, None]).sum(dim=0) - 0.5 * LOG_2PI * a_dim
            else:
                action = mean
                logp[i] = 0.0
            act[i] = action
            val[i] = value
            cash, inv, price, rew[i] = step(env, noise["uniforms"][j], noise["mid"][j], executed(env, action),
                                            cash, inv, price, cjmm_const)
    return Rollout(obs, act, logp, val, rew)


def gae(rewards: torch.Tensor, values: torch.Tensor, gamma: float, lam: float):
    """GAE(lambda) over a fixed-horizon episode (terminal value 0):
    ``(advantages, returns)``."""
    adv = torch.empty_like(rewards)
    running = torch.zeros_like(rewards[0])
    next_value = torch.zeros_like(rewards[0])
    for t in range(rewards.shape[0] - 1, -1, -1):
        delta = rewards[t] + gamma * next_value - values[t]
        running = delta + gamma * lam * running
        adv[t] = running
        next_value = values[t]
    return adv, adv + values


# ------------------------------------------------------------ PPO gradient
def ppo_grads(weights: Dict[str, torch.Tensor], x, act, old, adv, ret, clip_eps: float, vf_coef: float,
              rnd: Rounding):
    """The gradient of the PPO loss over the samples (``x (S, M)``, ``act
    (A, M)``, the rest ``(M,)``, advantages already normalised) by name, and
    the loss terms: ``pg_loss`` (the clipped surrogate), ``vf_loss`` (half
    the mean squared value error) and ``approx_kl``."""
    a_dim, m = act.shape
    towers = towers_of(weights)
    saved = []  # per tower, its activations, layer input first
    outs = []
    with full_float32():
        for tower in towers:
            hs = [rnd(x)]
            for w, b in tower.layers:
                hs.append(rnd(torch.tanh(rnd(w) @ hs[-1] + b[:, None])))
            saved.append(hs)
            outs.append(rnd(tower.head_w) @ hs[-1] + tower.head_b[:, None])
        mv = torch.cat(outs)
        log_std = weights["log_std"]
        inv_std = torch.exp(-log_std)[:, None]
        z = (act - mv[:a_dim]) * inv_std
        logp = (((-0.5 * z) * z - log_std[:, None]) - 0.5 * LOG_2PI).sum(dim=0)
        ratio = torch.exp(logp - old)
        pg1 = ratio * adv
        pg2 = torch.clamp(ratio, 1.0 - clip_eps, 1.0 + clip_eps) * adv
        vf_err = mv[a_dim] - ret
        # d(-min(pg1, pg2))/d ratio: the unclipped branch where it is the
        # smaller, or where the ratio is inside the clip range
        inside = ((ratio > 1.0 - clip_eps) & (ratio < 1.0 + clip_eps)).to(torch.float32)
        take1 = (pg1 < pg2).to(torch.float32)
        tie = (pg1 == pg2).to(torch.float32)
        branch = take1 + (1.0 - take1 - tie) * inside + 0.5 * tie * (1.0 + inside)
        dlogp = -(adv / m) * branch * ratio
        dmean = dlogp * (z * inv_std)
        dvalue = (vf_coef / m) * vf_err
        grads = {"log_std": (dlogp * (z * z - 1.0)).sum(dim=1)}
        rows = [dmean, dvalue[None]] if len(towers) == 2 else [torch.cat([dmean, dvalue[None]])]
        names = ["pi", "vf"] if len(towers) == 2 else ["shared"]
        for tower, hs, dout, name in zip(towers, saved, rows, names):
            g_head_w = rnd(dout) @ hs[-1].T
            g_head_b = dout.sum(dim=1)
            dh = rnd(tower.head_w).T @ rnd(dout)
            n_layers = len(tower.layers)
            if name == "shared":
                grads["pi_head.weight"], grads["vf_head.weight"] = g_head_w[:a_dim], g_head_w[a_dim:]
                grads["pi_head.bias"], grads["vf_head.bias"] = g_head_b[:a_dim], g_head_b[a_dim:]
            else:
                grads[f"{name}.{n_layers}.weight"], grads[f"{name}.{n_layers}.bias"] = g_head_w, g_head_b
            for li in range(n_layers - 1, -1, -1):
                h = hs[li + 1]
                dz = dh * rnd(1.0 - rnd(h * h))
                grads[f"{name}.{li}.weight"] = rnd(dz) @ hs[li].T
                grads[f"{name}.{li}.bias"] = dz.sum(dim=1)
                if li:
                    dh = rnd(tower.layers[li][0]).T @ rnd(dz)
    metrics = {"pg_loss": torch.sum(-torch.minimum(pg1, pg2)) / m,
               "vf_loss": torch.sum((0.5 * vf_err) * vf_err) / m,
               "approx_kl": torch.sum(old - logp) / m}
    return grads, metrics


# ------------------------------------------------------------ the learner
class Adam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8) after a clip of the global norm to
    ``max_norm`` (unchanged below it, else scaled onto it), on a dict of
    float32 tensors updated in place."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, max_norm: float):
        self.params, self.lr, self.max_norm = params, lr, max_norm
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        scale = torch.where(norm < self.max_norm, torch.ones_like(norm), self.max_norm / norm)
        self.t += 1
        c1, c2 = 1.0 - 0.9**self.t, 1.0 - 0.999**self.t
        for k, p in self.params.items():
            g = grads[k] * scale
            self.m[k].mul_(0.9).add_(g, alpha=0.1)
            self.v[k].mul_(0.999).addcmul_(g, g, value=0.001)
            p.sub_(self.lr * (self.m[k] / c1) / (torch.sqrt(self.v[k] / c2) + 1e-8))


class Iteration(NamedTuple):
    metrics: Dict[str, float]
    episode_returns: torch.Tensor  # (N,)


def normalise(adv: torch.Tensor) -> torch.Tensor:
    return (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)


def train_iteration(env: Env, learner: dict, opt: Adam, key: int, n: int, rnd: Rounding, device,
                    sample_share: float = 1.0, freeze: bool = False) -> Iteration:
    """One fully on-policy PPO iteration: the rollout of ``n`` envs, GAE,
    then ``n_epochs`` passes over ``n_minibatches`` contiguous env slices
    (every step of each), advantages normalised per minibatch, one Adam
    step each.  ``sample_share`` < 1 and ``freeze`` plant the faults the
    benchmark's check must catch: the gradient and the metrics over the
    first share of each minibatch alone; no parameter update."""
    ro = rollout(env, opt.params, key_generator(env, key, device), n, rnd, device)
    adv_all, ret_all = gae(ro.rewards, ro.values, learner["gamma"], learner["gae_lambda"])
    t_count, s_dim, _ = ro.obs.shape
    a_dim = ro.actions.shape[1]
    n_mb = learner["n_minibatches"]
    nb = n // n_mb
    history = []
    for _ in range(learner["n_epochs"]):
        for mi in range(n_mb):
            sl = slice(mi * nb, mi * nb + max(1, int(nb * sample_share)))
            x = ro.obs[:, :, sl].permute(1, 0, 2).reshape(s_dim, -1)
            act = ro.actions[:, :, sl].permute(1, 0, 2).reshape(a_dim, -1)
            old, adv, ret = (v[:, sl].reshape(-1) for v in (ro.log_probs, adv_all, ret_all))
            if learner.get("normalise_advantages", True):
                adv = normalise(adv)
            grads, metrics = ppo_grads(opt.params, x, act, old, adv, ret, learner["clip_eps"], learner["vf_coef"],
                                       rnd)
            ent_coef = learner.get("ent_coef", 0.0)
            if ent_coef:
                grads["log_std"] = grads["log_std"] - ent_coef
            if not freeze:
                opt.step(grads)
            history.append(metrics)
    metrics = {k: float(torch.stack([h[k] for h in history]).mean()) for k in history[0]}
    returns = ro.rewards.sum(dim=0)
    metrics["mean_episode_reward"] = float(returns.mean())
    return Iteration(metrics, returns)


@torch.no_grad()
def evaluate(env: Env, weights: Dict[str, torch.Tensor], key: int, n: int, rnd: Rounding, device,
             episodes: int = 1) -> tuple:
    """The deterministic policy's mean episode reward over ``episodes``
    episodes of ``n`` envs, each episode's inventories and seed drawn in
    turn from one generator on the device seeded with ``key``, and the
    mean absolute episode return, the scale the comparison measures
    against."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(key))
    means, scales = [], []
    for _ in range(episodes):
        returns = rollout(env, weights, gen, n, rnd, device, stochastic=False).rewards.sum(dim=0)
        means.append(float(returns.mean()))
        scales.append(float(returns.abs().mean()))
    return sum(means) / episodes, sum(scales) / episodes
