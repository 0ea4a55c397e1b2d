"""On-device PPO learner (counterpart of ``mbt_gym_tpu/agents/ppo.py``;
hyperparameter conventions from experiments/helpers.py:68-96: 256x256,
gamma=1, gae_lambda=0.95, batch = n_steps*N/n_minibatches).

One :func:`train_iteration` = rollout + GAE + epochs x minibatch
clipped-surrogate updates.  Two paths:

- the **engine** path (the JAX package's XLA path): the rollout steps
  :mod:`mbt_gym_torch.env` eagerly with the policy forward in PyTorch, and
  each minibatch's gradient comes from ``torch.autograd`` of
  :func:`_ppo_loss`;
- the **fused** path, ``PPOConfig(fused_rollout=True, fused_update=True)``
  on the shared trunk: the rollout is the K3 kernel
  (:func:`mbt_gym_torch.ops.mlp_rollout.collect_rollout_fused_T`) and each
  minibatch's gradient the K4 kernel
  (:func:`mbt_gym_torch.ops.fused_ppo.ppo_fused_grads_T`), minibatches
  being contiguous env slices of the feature-major buffers.

``fused_rollout`` alone runs K3 with the engine update.  Not ported to
CUDA yet, and refused with a ``ValueError`` naming it: the separate
pi/vf towers with either fused flag (the JAX kernels' stacked-trunk
``split_at`` mode), and ``fused_update`` without ``fused_rollout`` (the
row-major kernel K7, ``ops/fused_ppo.py:634``).

The optimizer is ``torch.optim.Adam`` after a global-norm clip written to
optax's formula.  :class:`PPOTrainState` holds the model and its
optimizer; :func:`train_iteration` returns a new state and leaves the one
it was given untouched, as the JAX function does (it updates a deep copy;
at 256x256 the copy is ~1 MB).  Randomness comes from an int seed or a
``torch.Generator``.  Everything runs on the device of the model's
parameters.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from mbt_gym_torch import env as env_lib
from mbt_gym_torch.agents import networks
from mbt_gym_torch.env import EnvConfig


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """The JAX package's ``PPOConfig``, field for field.  ``fused_tile``,
    ``fused_rollout_tile`` and ``fused_interpret_ok`` are TPU-only (Pallas
    lane tiles, the Mosaic interpreter's PRNG stub): they are kept so that
    a JAX config carries across, and the port does not read them."""

    learning_rate: float = 3e-4
    gamma: float = 1.0  # experiments/helpers.py:83 uses gamma=1 (finite horizon)
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.0
    max_grad_norm: float = 0.5
    n_epochs: int = 4
    n_minibatches: int = 4
    hidden: Tuple[int, ...] = (256, 256)
    normalise_advantages: bool = True
    shuffle: bool = True
    # None = float32 everywhere; "bfloat16" runs the engine path's matmuls
    # in bf16 with float32 master params and optimizer state.
    compute_dtype: Optional[str] = None
    shared_trunk: bool = False
    # K4 (ops/fused_ppo.py) for the minibatch gradients; needs fused_rollout
    # and the shared trunk in this port.
    fused_update: bool = False
    fused_tile: int = 1024  # TPU-only, unused
    fused_compute_dtype: str = "bfloat16"
    # K3 (ops/mlp_rollout.py) for the rollout; shared trunk only.
    fused_rollout: bool = False
    fused_rollout_tile: Optional[int] = None  # TPU-only, unused
    fused_interpret_ok: bool = False  # TPU-only, unused


class PPOTrainState(NamedTuple):
    params: networks.ActorCritic
    opt_state: torch.optim.Optimizer  # Adam over params.parameters()
    update_count: int


class RolloutBatch(NamedTuple):
    obs: torch.Tensor  # (T, N, S)
    actions: torch.Tensor  # (T, N, A)
    log_probs: torch.Tensor  # (T, N)
    values: torch.Tensor  # (T, N)
    rewards: torch.Tensor  # (T, N)
    advantages: torch.Tensor  # (T, N)
    returns: torch.Tensor  # (T, N)


class UpdateBatch(NamedTuple):
    """The fields the update consumes."""

    obs: torch.Tensor
    actions: torch.Tensor
    log_probs: torch.Tensor
    advantages: torch.Tensor
    returns: torch.Tensor


# ------------------------------------------------------------ optimizer
def make_optimizer(cfg: PPOConfig, params: networks.ActorCritic) -> torch.optim.Adam:
    """Adam at ``cfg.learning_rate`` with optax's defaults (b1=0.9,
    b2=0.999, eps=1e-8); :func:`apply_gradients` clips before each step."""
    return torch.optim.Adam(params.parameters(), lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8)


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    """``optax.clip_by_global_norm``: unchanged while the global norm is
    below ``max_norm``, else ``(g / norm) * max_norm``.  (Not
    ``torch.nn.utils.clip_grad_norm_``, which adds 1e-6 to the norm.)"""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    trigger = norm < max_norm
    return [torch.where(trigger, g, (g / norm) * max_norm) for g in grads]


def apply_gradients(cfg: PPOConfig, params: networks.ActorCritic, optimizer: torch.optim.Optimizer,
                    grads: Dict[str, torch.Tensor]) -> None:
    """Clip ``grads`` (a ``{parameter name: tensor}`` dict) by their global
    norm, put them in ``p.grad`` and take one optimizer step, in place."""
    named = list(params.named_parameters())
    clipped = clip_by_global_norm([grads[name] for name, _ in named], cfg.max_grad_norm)
    for (_, p), g in zip(named, clipped):
        p.grad = g.to(p.dtype)
    optimizer.step()


def init_train_state(env_cfg: EnvConfig, ppo_cfg: PPOConfig, key, device=None) -> PPOTrainState:
    params = networks.init_actor_critic(
        key, env_cfg.state_dim, env_cfg.action_dim, hidden=ppo_cfg.hidden,
        shared_trunk=ppo_cfg.shared_trunk, device=device,
    )
    return PPOTrainState(params=params, opt_state=make_optimizer(ppo_cfg, params), update_count=0)


def _device_of(params: networks.ActorCritic) -> torch.device:
    return next(params.parameters()).device


# ------------------------------------------------------------ engine path
def _clip_to_action_box(env_cfg: EnvConfig, action: torch.Tensor) -> torch.Tensor:
    """Executed actions are clipped to the action box (SB3's convention);
    log-probs stay those of the unclipped sample."""
    if env_cfg.normalise_action_space:
        return torch.clamp(action, -1.0, 1.0)
    low, high = env_cfg.action_bounds()
    low = torch.as_tensor(low, dtype=action.dtype, device=action.device)
    high = torch.as_tensor(high, dtype=action.dtype, device=action.device)
    return torch.minimum(torch.maximum(action, low), high)


@torch.no_grad()
def collect_rollout(env_cfg: EnvConfig, params: networks.ActorCritic, key, gamma: float = 1.0,
                    lam: float = 0.95, compute_dtype=None) -> RolloutBatch:
    """One on-policy episode for all N trajectories, with values and
    log-probs (ppo.py:133-186), on the parameters' device.  ``key`` (an int
    seed or a ``torch.Generator``) drives the reset, the env noise and the
    policy samples.  Random start times are refused: their post-done steps
    would enter GAE."""
    from mbt_gym_torch.rollout import _episode_steps

    assert not isinstance(env_cfg.start_time, tuple), (
        "PPO training does not support random start times (post-done steps "
        "would enter GAE); use a fixed start_time."
    )
    device = _device_of(params)
    gen = env_lib.make_generator(key, device)
    state, obs = env_lib.reset(env_cfg, gen, device=device)
    n_steps = _episode_steps(env_cfg)
    std = torch.exp(params.log_std)
    outs = []
    for _ in range(n_steps):
        mean, v = networks.policy_value(params, obs, compute_dtype)
        eps = torch.randn(mean.shape, generator=gen, dtype=mean.dtype, device=device)
        action = mean + std * eps
        log_prob = networks.gaussian_log_prob(params, mean, action)
        res = env_lib.step(env_cfg, state, _clip_to_action_box(env_cfg, action))
        outs.append((obs, action, log_prob, v, res.reward))
        state, obs = res.state, res.obs
    obs_seq, actions, log_probs, values, rewards = (torch.stack(x) for x in zip(*outs))
    # fixed-horizon episode: terminal value 0 (no bootstrap past done)
    advantages, returns = compute_gae(rewards, values, torch.zeros_like(values[0]), gamma, lam)
    return RolloutBatch(obs_seq, actions, log_probs, values, rewards, advantages, returns)


def compute_gae(rewards: torch.Tensor, values: torch.Tensor, last_value: torch.Tensor,
                gamma: float, lam: float):
    """GAE(lambda) over the time axis, last step first (ppo.py:189-202)."""
    advantages = torch.empty_like(rewards)
    gae_next = torch.zeros_like(last_value)
    value_next = last_value
    for t in range(rewards.shape[0] - 1, -1, -1):
        delta = rewards[t] + gamma * value_next - values[t]
        gae_next = delta + gamma * lam * gae_next
        advantages[t] = gae_next
        value_next = values[t]
    return advantages, advantages + values


def normalise(adv: torch.Tensor) -> torch.Tensor:
    """``(adv - mean) / (std + 1e-8)`` with the population std (``jnp.std``)."""
    return (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)


def _ppo_loss(params: networks.ActorCritic, ppo_cfg: PPOConfig, batch):
    """Clipped surrogate + value loss - entropy bonus (ppo.py:205-222);
    returns ``(loss, metrics)``, differentiable in ``params``."""
    mean, values = networks.policy_value(params, batch.obs, ppo_cfg.compute_dtype)
    log_probs = networks.gaussian_log_prob(params, mean, batch.actions)
    adv = batch.advantages
    if ppo_cfg.normalise_advantages:
        adv = normalise(adv)
    ratio = torch.exp(log_probs - batch.log_probs)
    pg1 = ratio * adv
    pg2 = torch.clamp(ratio, 1.0 - ppo_cfg.clip_eps, 1.0 + ppo_cfg.clip_eps) * adv
    pg_loss = -torch.mean(torch.minimum(pg1, pg2))
    vf_loss = 0.5 * torch.mean((values - batch.returns) ** 2)
    ent = networks.entropy(params)
    loss = pg_loss + ppo_cfg.vf_coef * vf_loss - ppo_cfg.ent_coef * ent
    return loss, {"pg_loss": pg_loss, "vf_loss": vf_loss, "entropy": ent,
                  "approx_kl": torch.mean(batch.log_probs - log_probs)}


def _check_fused_flags(ppo_cfg: PPOConfig) -> None:
    if (ppo_cfg.fused_rollout or ppo_cfg.fused_update) and not ppo_cfg.shared_trunk:
        raise ValueError(
            "fused_rollout/fused_update with the separate pi/vf towers layout "
            "(the JAX kernels' stacked-trunk split_at mode) are not ported to "
            "CUDA yet; use shared_trunk=True or the engine path"
        )
    if ppo_cfg.fused_update and not ppo_cfg.fused_rollout:
        raise ValueError(
            "fused_update without fused_rollout needs the row-major update "
            "kernel K7 (ppo_fused_grads, mbt_gym_tpu/ops/fused_ppo.py:634), "
            "which is not ported to CUDA yet; set fused_rollout=True too, or "
            "use the engine update"
        )


def _copy_state(train_state: PPOTrainState) -> PPOTrainState:
    """A deep copy whose optimizer steps the copied model's parameters."""
    return copy.deepcopy(train_state)


def _mean_metrics(metrics: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    return {k: torch.stack([m[k] for m in metrics]).mean() for k in metrics[0]}


def _engine_update(ppo_cfg: PPOConfig, ts: PPOTrainState, batch: RolloutBatch,
                   gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """n_epochs x n_minibatches autograd updates of ``ts`` in place
    (ppo.py:504-548); returns the mean metrics."""
    t, n = batch.rewards.shape
    flat = UpdateBatch(
        obs=batch.obs.reshape(t * n, -1), actions=batch.actions.reshape(t * n, -1),
        log_probs=batch.log_probs.reshape(-1), advantages=batch.advantages.reshape(-1),
        returns=batch.returns.reshape(-1),
    )
    total = t * n
    mb_size = total // ppo_cfg.n_minibatches
    params, optimizer = ts.params, ts.opt_state
    names = [name for name, _ in params.named_parameters()]
    metrics = []
    for _ in range(ppo_cfg.n_epochs):
        perm = torch.randperm(total, generator=gen, device=gen.device) if ppo_cfg.shuffle else None
        for m in range(ppo_cfg.n_minibatches):
            sl = slice(m * mb_size, (m + 1) * mb_size)
            idx = perm[sl] if perm is not None else sl
            mb = UpdateBatch(*(x[idx] for x in flat))
            params.zero_grad(set_to_none=True)
            loss, mb_metrics = _ppo_loss(params, ppo_cfg, mb)
            loss.backward()
            grads = {name: p.grad for name, p in zip(names, params.parameters())}
            apply_gradients(ppo_cfg, params, optimizer, grads)
            metrics.append({k: v.detach() for k, v in mb_metrics.items()})
    return _mean_metrics(metrics)


# ------------------------------------------------------------ fused path
def _fused_iteration_body(env_cfg: EnvConfig, ppo_cfg: PPOConfig, params: networks.ActorCritic,
                          optimizer: torch.optim.Optimizer, key,
                          noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The fully fused pipeline (ppo.py:282-382, single device): K3's
    feature-major ``(T, C, N)`` buffers feed K4 directly.  Minibatches are
    contiguous env slices (all T steps each), passed to K4 as views;
    advantages are normalised per minibatch; the entropy term, which
    depends on ``log_std`` alone, enters the ``log_std`` grad here; Adam
    steps through ``p.grad``.  Updates ``params``/``optimizer`` in place
    and returns the mean metrics.  ``noise`` injects the rollout's
    ``(T, 7, N)`` channels (the parity tests)."""
    from mbt_gym_torch.ops import fused_ppo, mlp_rollout

    assert not ppo_cfg.shuffle, "fused path uses contiguous env-slice minibatches"
    assert not isinstance(env_cfg.start_time, tuple), (
        "PPO training does not support random start times (post-done steps "
        "would enter GAE); use a fixed start_time."
    )
    device = _device_of(params)
    tb = mlp_rollout.collect_rollout_fused_T(
        env_cfg, params, key, gamma=ppo_cfg.gamma, lam=ppo_cfg.gae_lambda, noise=noise, device=device,
    )
    n = env_cfg.num_trajectories
    nb = n // ppo_cfg.n_minibatches
    assert nb * ppo_cfg.n_minibatches == n, (n, ppo_cfg.n_minibatches)
    metrics = []
    for _ in range(ppo_cfg.n_epochs):
        for mi in range(ppo_cfg.n_minibatches):
            start = mi * nb

            def sl(x):
                return x[..., start:start + nb]

            adv = sl(tb.advantages)
            if ppo_cfg.normalise_advantages:
                adv = normalise(adv)
            grads, mb_metrics = fused_ppo.ppo_fused_grads_T(
                params, sl(tb.obs_t), sl(tb.actions_t), sl(tb.log_probs), adv, sl(tb.returns),
                clip_eps=ppo_cfg.clip_eps, vf_coef=ppo_cfg.vf_coef,
                compute_dtype=ppo_cfg.fused_compute_dtype,
            )
            if ppo_cfg.ent_coef:
                grads["log_std"] = grads["log_std"] - ppo_cfg.ent_coef
            mb_metrics = dict(mb_metrics)
            mb_metrics["entropy"] = networks.entropy(params).detach()
            apply_gradients(ppo_cfg, params, optimizer, grads)
            metrics.append(mb_metrics)
    out = _mean_metrics(metrics)
    out["mean_episode_reward"] = tb.rewards.sum(dim=0).mean()
    return out


def _fused_train_iteration(env_cfg: EnvConfig, ppo_cfg: PPOConfig, train_state: PPOTrainState, key,
                           noise: Optional[torch.Tensor] = None):
    ts = _copy_state(train_state)
    metrics = _fused_iteration_body(env_cfg, ppo_cfg, ts.params, ts.opt_state, key, noise=noise)
    return ts._replace(update_count=ts.update_count + 1), metrics


# ------------------------------------------------------------ entry points
def train_iteration(env_cfg: EnvConfig, ppo_cfg: PPOConfig, train_state: PPOTrainState, key,
                    noise: Optional[torch.Tensor] = None) -> Tuple[PPOTrainState, Dict[str, torch.Tensor]]:
    """rollout -> GAE -> n_epochs x n_minibatches updates; returns the new
    state and the mean metrics (``pg_loss``, ``vf_loss``, ``entropy``,
    ``approx_kl``, ``mean_episode_reward``).  ``key`` is an int seed or a
    ``torch.Generator`` on the parameters' device.  ``noise`` (fused
    rollout only) injects K3's ``(T, 7, N)`` channels."""
    _check_fused_flags(ppo_cfg)
    if ppo_cfg.fused_rollout and ppo_cfg.fused_update:
        return _fused_train_iteration(env_cfg, ppo_cfg, train_state, key, noise=noise)
    device = _device_of(train_state.params)
    gen = env_lib.make_generator(key, device)
    ts = _copy_state(train_state)
    if ppo_cfg.fused_rollout:
        from mbt_gym_torch.ops.mlp_rollout import collect_rollout_fused

        batch = collect_rollout_fused(
            env_cfg, ts.params, gen, gamma=ppo_cfg.gamma, lam=ppo_cfg.gae_lambda, noise=noise, device=device,
        )
    else:
        assert noise is None, "noise= injects the fused rollout's channels"
        batch = collect_rollout(
            env_cfg, ts.params, gen, gamma=ppo_cfg.gamma, lam=ppo_cfg.gae_lambda,
            compute_dtype=ppo_cfg.compute_dtype,
        )
    metrics = _engine_update(ppo_cfg, ts, batch, gen)
    metrics["mean_episode_reward"] = batch.rewards.sum(dim=0).mean()
    return ts._replace(update_count=ts.update_count + 1), metrics


def iteration_keys(key, n_iterations: int) -> List[int]:
    """The per-iteration int seeds :func:`train_chunk` uses, drawn from
    ``key`` (an int seed or a ``torch.Generator``)."""
    gen = key if isinstance(key, torch.Generator) else torch.Generator().manual_seed(int(key))
    return torch.randint(0, 2**62, (n_iterations,), generator=gen, device=gen.device).tolist()


def train_chunk(env_cfg: EnvConfig, ppo_cfg: PPOConfig, train_state: PPOTrainState, key,
                n_iterations: int) -> Tuple[PPOTrainState, Dict[str, torch.Tensor]]:
    """``n_iterations`` train iterations on the seeds
    :func:`iteration_keys` draws from ``key``; metrics come back stacked
    with a leading ``(n_iterations,)`` axis (ppo.py:558-587)."""
    history = []
    for k in iteration_keys(key, n_iterations):
        train_state, metrics = train_iteration(env_cfg, ppo_cfg, train_state, k)
        history.append(metrics)
    return train_state, {k: torch.stack([m[k] for m in history]) for k in history[0]}


def deterministic_policy(env_cfg: EnvConfig):
    """The trained actor's mean action, clipped to the action space
    (ppo.py:595-618), tagged ``kind="mlp_deterministic"`` for the dispatch
    front door (whose mlp_rollout family is not ported yet, so it runs the
    engine)."""
    from mbt_gym_torch.dispatch import tag_policy

    def policy(params, obs, state):
        return _clip_to_action_box(env_cfg, networks.policy_mean(params, obs))

    return tag_policy(policy, kind="mlp_deterministic", env_cfg=env_cfg)


@torch.no_grad()
def evaluate_policy(env_cfg: EnvConfig, params: networks.ActorCritic, key, n_episodes: int = 1,
                    backend: str = "auto") -> torch.Tensor:
    """Mean episode reward of the deterministic policy over ``n_episodes``
    fresh episodes (ppo.py:621-702), on the parameters' device.

    ``backend``: "auto" and "engine" run the engine (the JAX package's
    auto also picks its engine, measured faster there).  "fused" runs K3
    with ``log_std = -30`` (std ~1e-13, negligible against float32 action
    scales) and raises ``ValueError`` naming the feature when the config or
    layout is outside the kernel's contract."""
    assert backend in ("auto", "engine", "fused"), backend
    device = _device_of(params)
    gen = env_lib.make_generator(key, device)
    total = torch.zeros((), dtype=torch.float32, device=device)
    if backend == "fused":
        from mbt_gym_torch.ops import mlp_rollout

        try:
            mlp_rollout.rollout_params_from_config(env_cfg)
        except AssertionError as e:
            raise ValueError(f"backend='fused' unavailable: {e}") from None
        if not params.shared_trunk:
            raise ValueError(
                "backend='fused' unavailable: the separate pi/vf towers layout is "
                "not ported to CUDA yet"
            )
        det = copy.deepcopy(params)
        det.log_std.fill_(-30.0)
        for _ in range(n_episodes):
            tb = mlp_rollout.collect_rollout_fused_T(env_cfg, det, gen, device=device)
            total += tb.rewards.sum(dim=0).mean()
        return total / n_episodes
    from mbt_gym_torch.rollout import rollout

    policy = deterministic_policy(env_cfg)
    for _ in range(n_episodes):
        res = rollout(env_cfg, policy, params, gen, backend="engine", device=device)
        total += res.trajectory.rewards.sum(dim=0).mean()
    return total / n_episodes
