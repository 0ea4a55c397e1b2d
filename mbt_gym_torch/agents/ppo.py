"""On-device PPO learner (counterpart of ``mbt_gym_tpu/agents/ppo.py``;
hyperparameter conventions from experiments/helpers.py:68-96: 256x256,
gamma=1, gae_lambda=0.95, batch = n_steps*N/n_minibatches).

One :func:`train_iteration` = rollout + GAE + epochs x minibatch
clipped-surrogate updates, on either actor-critic layout (the separate
pi/vf towers, the default, or ``shared_trunk=True``), routed as
``ppo.py:461-550`` routes:

- the **engine** path (the JAX package's XLA path): the rollout steps
  :mod:`mbt_gym_torch.env` eagerly with the policy forward in PyTorch, the
  samples are shuffled globally (``shuffle=True``) into row-major
  minibatches, and each minibatch's gradient comes from ``torch.autograd``
  of :func:`_ppo_loss`;
- ``fused_update=True`` alone keeps that rollout and those minibatches and
  takes each gradient from a kernel (:func:`_fused_grads_and_metrics`): K7
  (:func:`mbt_gym_torch.ops.fused_ppo.ppo_fused_grads`) on the shared
  trunk, K4 (:func:`~mbt_gym_torch.ops.fused_ppo.ppo_fused_grads_T`) in its
  stacked-trunk mode on the towers, the minibatch re-blocked feature-major;
- ``fused_rollout=True`` alone runs the K3 rollout
  (:func:`mbt_gym_torch.ops.mlp_rollout.collect_rollout_fused`) with the
  engine update;
- both: the fully **fused** path, K3's feature-major buffers feeding K4
  directly, minibatches being contiguous env slices (``shuffle=False``).

K4 and K7 take the trunks and observations K3 takes (1-8 layers, each
per-tower width a multiple of 4 up to 256, the wrappers padding the widths
to multiples of 64 with exact zeros; at most ``fused_ppo.MAX_S`` (16)
observation columns, K3's own limit), on every fused path: the all-axes
composite config (S = 9) trains fully fused.  ``fused_update`` on a config
observing more columns than that raises ``ValueError`` naming the limit
(:func:`fused_update_refusal`), as K3 refuses such a rollout; nothing
falls back to autograd.

``mesh=`` (a :class:`mbt_gym_torch.parallel.mesh.Mesh`) makes
:func:`collect_rollout`, :func:`train_iteration` and :func:`train_chunk`
data-parallel over a ``torch.distributed`` process group (ppo.py:116-458):
each rank steps its ``N / world`` envs from its own key
(:func:`~mbt_gym_torch.parallel.mesh.fold_in` of the key with its rank,
ppo.py:317-319), normalises each minibatch's advantages with the global
mean and std, and averages each minibatch's grads and metrics over the
ranks with one all-reduce of one flat buffer before the optimizer step,
so params stay replicated.  The fused path takes the global ``noise``
``(T, C, N)`` and uses this rank's columns; the engine path shuffles each
rank's own samples with a permutation drawn from a generator seeded
alike on every rank.  ``mesh=None`` is the single-device path, unchanged.

:func:`jit_train_iteration` and :func:`jit_train_chunk` are the compiled
entry points: on the card, replays of a CUDA graph of the iteration
(:mod:`mbt_gym_torch.compiled`), bit for bit the eager ones.

The optimizer is ``torch.optim.Adam`` after a global-norm clip written to
optax's formula, ``capturable`` on the card (:func:`make_optimizer`).
:class:`PPOTrainState` holds the model and its optimizer;
:func:`train_iteration` returns a new state and leaves the one it was
given untouched, as the JAX function does (it updates a deep copy;
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
from mbt_gym_torch.types import as_values, device_constant


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
    # K7 or K4 (ops/fused_ppo.py) for the minibatch gradients
    fused_update: bool = False
    fused_tile: int = 1024  # TPU-only, unused
    fused_compute_dtype: str = "bfloat16"
    # K3 (ops/mlp_rollout.py) for the rollout
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
    b2=0.999, eps=1e-8); :func:`apply_gradients` clips before each step.
    On the card it is built with ``capturable=True``: the step count stays
    on the device and the bias correction runs there in float32, as optax
    computes it, so an eager iteration and its CUDA-graph capture
    (:func:`jit_train_iteration`) step bit for bit alike.  On the CPU it is
    PyTorch's default Adam (the step count a host scalar)."""
    capturable = next(params.parameters()).device.type == "cuda"
    return torch.optim.Adam(params.parameters(), lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8,
                            capturable=capturable)


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
    low, high = (device_constant(as_values(b), action.dtype, action.device) for b in env_cfg.action_bounds())
    return torch.minimum(torch.maximum(action, low), high)


def _local_config(env_cfg: EnvConfig, mesh) -> EnvConfig:
    """The config of this rank's ``N / world`` envs."""
    from mbt_gym_torch.parallel.mesh import local_slice

    rows = local_slice(mesh, env_cfg.num_trajectories)
    return dataclasses.replace(env_cfg, num_trajectories=rows.stop - rows.start)


@torch.no_grad()
def collect_rollout(env_cfg: EnvConfig, params: networks.ActorCritic, key, gamma: float = 1.0,
                    lam: float = 0.95, compute_dtype=None, mesh=None) -> RolloutBatch:
    """One on-policy episode for all N trajectories, with values and
    log-probs (ppo.py:133-186), on the parameters' device.  ``key`` (an int
    seed or a ``torch.Generator``) drives the reset, the env noise and the
    policy samples.  Random start times are refused: their post-done steps
    would enter GAE.  With ``mesh``, this rank's ``N / world`` envs, from
    ``fold_in(key, rank)``; the batch returned is this rank's."""
    from mbt_gym_torch.rollout import _episode_steps

    assert not isinstance(env_cfg.start_time, tuple), (
        "PPO training does not support random start times (post-done steps "
        "would enter GAE); use a fixed start_time."
    )
    device = _device_of(params)
    if mesh is not None:
        from mbt_gym_torch.parallel.mesh import fold_in

        env_cfg = _local_config(env_cfg, mesh)
        key = fold_in(key, mesh.rank)
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


def normalise_global(mesh, adv: torch.Tensor) -> torch.Tensor:
    """:func:`normalise` with the mean and std over every rank's
    minibatch, as ppo.py:349-350 writes them: the mean of the ranks' means,
    then the square root of the mean of the ranks' mean squared deviations
    (equal shard sizes make both the global ones).  On one rank the global
    statistics are the rank's own, computed as :func:`normalise` computes
    them, so a one-rank mesh normalises bit for bit as the meshless path
    does."""
    from mbt_gym_torch.parallel.mesh import all_reduce_mean

    if mesh.world == 1:
        return normalise(adv)
    mean = all_reduce_mean(mesh, adv.mean().reshape(1))
    var = all_reduce_mean(mesh, ((adv - mean) ** 2).mean().reshape(1))
    return (adv - mean) / (torch.sqrt(var) + 1e-8)


def mesh_mean(mesh, grads: Dict[str, torch.Tensor], metrics: Dict[str, torch.Tensor]):
    """The ranks' mean of one minibatch's grads and metrics, through ONE
    all-reduce of one flat float32 buffer (the pmeans of ppo.py:361-362).
    Each rank's values are means over its own minibatch; equal shard sizes
    make their mean the global one."""
    from mbt_gym_torch.parallel.mesh import all_reduce_mean

    parts = list(grads.items()) + list(metrics.items())
    flat = torch.cat([v.detach().reshape(-1).to(torch.float32) for _, v in parts])
    all_reduce_mean(mesh, flat)
    out, start = [], 0
    for _, v in parts:
        out.append(flat[start:start + v.numel()].view(v.shape).to(v.dtype))
        start += v.numel()
    n = len(grads)
    return dict(zip(grads, out[:n])), dict(zip(metrics, out[n:]))


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


# Re-blocking of a towers minibatch for K4: the most lanes (envs of a
# feature-major row) tried, as the JAX rule's default fused_tile, and the
# fewest the CUDA kernel takes (its 32-sample tile).
_MAX_LANES = 1024
_MIN_LANES = 32


def _lanes(m: int) -> int:
    """The largest power of two up to 1024 that divides ``m``
    (ppo.py:246-248)."""
    lanes = _MAX_LANES
    while lanes > 1 and m % lanes:
        lanes //= 2
    return lanes


def _fused_grads_and_metrics(params: networks.ActorCritic, ppo_cfg: PPOConfig, mb: UpdateBatch
                             ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """One row-major minibatch's grads from a kernel (ppo.py:225-279):
    advantages normalised per minibatch, then K7 on the shared trunk, or
    K4's stacked-trunk mode on the towers, the ``(M,)`` minibatch re-blocked
    into ``(rows, lanes)`` feature-major form (the loss is a mean over
    samples, so any re-blocking is exact).  The entropy term depends on
    ``log_std`` alone and enters its grad here."""
    from mbt_gym_torch.ops import fused_ppo

    adv = normalise(mb.advantages) if ppo_cfg.normalise_advantages else mb.advantages
    kw = dict(clip_eps=ppo_cfg.clip_eps, vf_coef=ppo_cfg.vf_coef, compute_dtype=ppo_cfg.fused_compute_dtype)
    if params.shared_trunk:
        grads, metrics = fused_ppo.ppo_fused_grads(params, mb.obs, mb.actions, mb.log_probs, adv, mb.returns, **kw)
    else:
        m = mb.obs.shape[0]
        lanes = _lanes(m)
        if mb.obs.device.type == "cuda" and lanes < _MIN_LANES:
            raise ValueError(
                f"fused_update with separate towers re-blocks the {m}-sample minibatch into "
                f"(rows, lanes) and the K4 kernel needs at least {_MIN_LANES} lanes; pick "
                f"num_trajectories * n_steps / n_minibatches divisible by {_MIN_LANES}, or "
                "fused_update=False"
            )
        rows = m // lanes

        def to_t(x):
            return x.reshape(rows, lanes, -1).transpose(1, 2).contiguous()

        def flat_t(x):
            return x.reshape(rows, lanes)

        grads, metrics = fused_ppo.ppo_fused_grads_T(
            params, to_t(mb.obs), to_t(mb.actions), flat_t(mb.log_probs), flat_t(adv), flat_t(mb.returns), **kw)
    if ppo_cfg.ent_coef:
        grads["log_std"] = grads["log_std"] - ppo_cfg.ent_coef
    metrics = dict(metrics)
    metrics["entropy"] = networks.entropy(params).detach()
    return grads, metrics


def _copy_state(train_state: PPOTrainState) -> PPOTrainState:
    """A deep copy whose optimizer steps the copied model's parameters."""
    return copy.deepcopy(train_state)


def _mean_metrics(metrics: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    return {k: torch.stack([m[k] for m in metrics]).mean() for k in metrics[0]}


def _engine_update(ppo_cfg: PPOConfig, ts: PPOTrainState, batch: RolloutBatch,
                   gen: torch.Generator, mesh=None) -> Dict[str, torch.Tensor]:
    """n_epochs x n_minibatches updates of ``ts`` in place over row-major
    minibatches, shuffled globally per epoch when ``shuffle`` (ppo.py:504-548),
    each gradient from autograd or, with ``fused_update``, from
    :func:`_fused_grads_and_metrics`; returns the mean metrics.  With
    ``mesh``, ``batch`` is this rank's and ``gen`` in the same state on
    every rank: advantages are normalised with the global statistics and
    each minibatch's grads and metrics averaged over the ranks."""
    mb_cfg = ppo_cfg
    if mesh is not None and ppo_cfg.normalise_advantages:
        mb_cfg = dataclasses.replace(ppo_cfg, normalise_advantages=False)
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
            if mb_cfg is not ppo_cfg:
                mb = mb._replace(advantages=normalise_global(mesh, mb.advantages))
            if ppo_cfg.fused_update:
                grads, mb_metrics = _fused_grads_and_metrics(params, mb_cfg, mb)
            else:
                params.zero_grad(set_to_none=True)
                loss, mb_metrics = _ppo_loss(params, mb_cfg, mb)
                loss.backward()
                grads = {name: p.grad for name, p in zip(names, params.parameters())}
            if mesh is not None:
                grads, mb_metrics = mesh_mean(mesh, grads, mb_metrics)
            apply_gradients(ppo_cfg, params, optimizer, grads)
            metrics.append({k: v.detach() for k, v in mb_metrics.items()})
    return _mean_metrics(metrics)


# ------------------------------------------------------------ fused path
def _fused_iteration_body(env_cfg: EnvConfig, ppo_cfg: PPOConfig, params: networks.ActorCritic,
                          optimizer: torch.optim.Optimizer, key,
                          noise: Optional[torch.Tensor] = None,
                          inv0: Optional[torch.Tensor] = None, mesh=None) -> Dict[str, torch.Tensor]:
    """The fully fused pipeline (ppo.py:282-382, single device): K3's
    feature-major ``(T, C, N)`` buffers feed K4 directly
    (:func:`_fused_update_body`).  Updates ``params``/``optimizer`` in place
    and returns the mean metrics.  ``noise`` injects the rollout's
    ``(T, p.n_channels, N)`` channels and ``inv0`` the per-env
    initial inventories of a random-inventory config (the parity tests).

    ``mesh`` (ppo.py:301-307's ``axis_name``): ``env_cfg``, ``noise`` and
    ``inv0`` are this rank's; the rollout draws from ``fold_in(key, rank)``;
    advantages are normalised with the global statistics; each K4 call's
    grads and metrics, and the episode reward, are averaged over the
    ranks, so every rank applies the same update."""
    _check_fully_fused(env_cfg, ppo_cfg)
    if mesh is not None:
        from mbt_gym_torch.parallel.mesh import fold_in

        key = fold_in(key, mesh.rank)
    outputs = _k3_rollout(env_cfg, params, key, noise=noise, inv0=inv0)
    return _fused_update_body(env_cfg, ppo_cfg, params, optimizer, outputs, mesh=mesh)


def _check_fully_fused(env_cfg: EnvConfig, ppo_cfg: PPOConfig) -> None:
    assert not ppo_cfg.shuffle, "fused path uses contiguous env-slice minibatches"
    assert not isinstance(env_cfg.start_time, tuple), (
        "PPO training does not support random start times (post-done steps "
        "would enter GAE); use a fixed start_time."
    )


def _k3_rollout(env_cfg: EnvConfig, params: networks.ActorCritic, key, noise=None, inv0=None, out=None):
    """K3's five feature-major outputs for one iteration's rollout
    (:func:`mbt_gym_torch.ops.mlp_rollout.rollout_fused_T`), written into
    ``out`` where given."""
    from mbt_gym_torch.ops import mlp_rollout

    return mlp_rollout.rollout_fused_T(env_cfg, params, key, noise=noise, device=_device_of(params), inv0=inv0,
                                       out=out)


def _fused_update_body(env_cfg: EnvConfig, ppo_cfg: PPOConfig, params: networks.ActorCritic,
                       optimizer: torch.optim.Optimizer, outputs, mesh=None) -> Dict[str, torch.Tensor]:
    """GAE over K3's ``outputs`` and the K4 updates of the fully fused
    path.  Minibatches are contiguous env slices (all T steps each),
    passed to K4 as views; advantages are normalised per minibatch; the
    entropy term, which depends on ``log_std`` alone, enters the
    ``log_std`` grad here; Adam steps through ``p.grad``.  Updates
    ``params``/``optimizer`` in place and returns the mean metrics."""
    from mbt_gym_torch.ops import fused_ppo, mlp_rollout

    tb = mlp_rollout.gae_T(outputs, gamma=ppo_cfg.gamma, lam=ppo_cfg.gae_lambda)
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
                adv = normalise(adv) if mesh is None else normalise_global(mesh, adv)
            grads, mb_metrics = fused_ppo.ppo_fused_grads_T(
                params, sl(tb.obs_t), sl(tb.actions_t), sl(tb.log_probs), adv, sl(tb.returns),
                clip_eps=ppo_cfg.clip_eps, vf_coef=ppo_cfg.vf_coef,
                compute_dtype=ppo_cfg.fused_compute_dtype,
            )
            if mesh is not None:
                grads, mb_metrics = mesh_mean(mesh, grads, mb_metrics)
            if ppo_cfg.ent_coef:
                grads["log_std"] = grads["log_std"] - ppo_cfg.ent_coef
            mb_metrics = dict(mb_metrics)
            mb_metrics["entropy"] = networks.entropy(params).detach()
            apply_gradients(ppo_cfg, params, optimizer, grads)
            metrics.append(mb_metrics)
    out = _mean_metrics(metrics)
    out["mean_episode_reward"] = _episode_reward(tb.rewards, mesh)
    return out


def _episode_reward(rewards: torch.Tensor, mesh) -> torch.Tensor:
    """Mean episode reward over the envs (over every rank's, with ``mesh``)."""
    reward = rewards.sum(dim=0).mean()
    if mesh is None:
        return reward
    from mbt_gym_torch.parallel.mesh import all_reduce_mean

    return all_reduce_mean(mesh, reward.reshape(1)).reshape(())


# ------------------------------------------------------------ entry points
def fused_update_refusal(env_cfg: EnvConfig) -> Optional[str]:
    """Why the update kernels K4 and K7 cannot take ``env_cfg``'s
    minibatches, or None: they take at most ``fused_ppo.MAX_S`` (16)
    observation columns, as K3 does."""
    from mbt_gym_torch.ops.fused_ppo import MAX_S

    if env_cfg.state_dim > MAX_S:
        return f"the fused update (K4/K7) takes S <= {MAX_S}; the config observes S = {env_cfg.state_dim}"
    return None


def check_fused_update(env_cfg: EnvConfig, ppo_cfg: PPOConfig) -> None:
    """``ValueError`` with :func:`fused_update_refusal`'s reason where
    ``ppo_cfg`` asks for the update kernels and they cannot take
    ``env_cfg``."""
    refusal = fused_update_refusal(env_cfg) if ppo_cfg.fused_update else None
    if refusal is not None:
        raise ValueError(refusal)


def _fully_fused(ppo_cfg: PPOConfig) -> bool:
    return ppo_cfg.fused_rollout and ppo_cfg.fused_update


def _learner_keys(ppo_cfg: PPOConfig, key, mesh, generator):
    """``(K3's key, the rollout's generator, the shuffle's generator)`` of
    one iteration, from ``key``: the fully fused path seeds K3 from the key
    itself (``fold_in(key, rank)`` on a mesh) and draws nothing else; K3
    with the engine update seeds K3 from the generator the shuffle then
    draws from; the engine draws its rollout and its shuffle from one
    generator, or on a mesh from ``fold_in(key, rank)`` and from
    ``shared_key(key)``.  ``generator(seed, role)`` gives the generator
    seeded with ``seed`` for role 0 (rollout) or 1 (shuffle)."""
    from mbt_gym_torch.parallel.mesh import fold_in, key_seed, shared_key

    if _fully_fused(ppo_cfg):
        return (key if mesh is None else fold_in(key, mesh.rank)), None, None
    if mesh is None:
        gen = generator(key, 0)
        return (gen if ppo_cfg.fused_rollout else None), gen, gen
    if ppo_cfg.fused_rollout:
        raise ValueError("fused_rollout without fused_update is single-device (mesh must be None)")
    base = key_seed(key)
    return None, generator(fold_in(base, mesh.rank), 0), generator(shared_key(base), 1)


def _iteration_config(env_cfg: EnvConfig, ppo_cfg: PPOConfig, mesh) -> EnvConfig:
    """The config this process steps: its rank's envs on a mesh."""
    if _fully_fused(ppo_cfg):
        _check_fully_fused(env_cfg, ppo_cfg)
    if mesh is None:
        return env_cfg
    if _fully_fused(ppo_cfg) and mesh.model != 1:
        raise ValueError("the fused kernels hold the whole MLP on each rank (replicated-params data parallelism)")
    return _local_config(env_cfg, mesh)


def _iteration_update(env_cfg: EnvConfig, ppo_cfg: PPOConfig, ts: PPOTrainState, gen, shuffle_gen, outputs,
                      mesh=None) -> Dict[str, torch.Tensor]:
    """Everything of one iteration after K3, in place on ``ts``: the fully
    fused update on K3's ``outputs``; GAE on them and the engine update
    (K3 with the engine update); or the engine rollout from ``gen`` and
    the engine update (``env_cfg`` is this rank's on a mesh).  Returns the
    metrics."""
    if _fully_fused(ppo_cfg):
        return _fused_update_body(env_cfg, ppo_cfg, ts.params, ts.opt_state, outputs, mesh=mesh)
    if ppo_cfg.fused_rollout:
        from mbt_gym_torch.ops import mlp_rollout

        batch = mlp_rollout.row_major(mlp_rollout.gae_T(outputs, gamma=ppo_cfg.gamma, lam=ppo_cfg.gae_lambda))
    else:
        batch = collect_rollout(
            env_cfg, ts.params, gen, gamma=ppo_cfg.gamma, lam=ppo_cfg.gae_lambda,
            compute_dtype=ppo_cfg.compute_dtype,
        )
    metrics = _engine_update(ppo_cfg, ts, batch, shuffle_gen, mesh=mesh)
    metrics["mean_episode_reward"] = _episode_reward(batch.rewards, mesh)
    return metrics


def _noise_columns(env_cfg: EnvConfig, noise, mesh):
    """This rank's env columns of the global ``(T, C, N)`` noise."""
    if noise is None or mesh is None:
        return noise
    from mbt_gym_torch.parallel.mesh import local_slice

    return noise[..., local_slice(mesh, env_cfg.num_trajectories)].contiguous()


def train_iteration(env_cfg: EnvConfig, ppo_cfg: PPOConfig, train_state: PPOTrainState, key,
                    noise: Optional[torch.Tensor] = None, mesh=None
                    ) -> Tuple[PPOTrainState, Dict[str, torch.Tensor]]:
    """rollout -> GAE -> n_epochs x n_minibatches updates; returns the new
    state and the mean metrics (``pg_loss``, ``vf_loss``, ``entropy``,
    ``approx_kl``, ``mean_episode_reward``).  ``key`` is an int seed or a
    ``torch.Generator`` on the parameters' device.  ``noise`` (K3 rollout
    only) injects K3's ``(T, p.n_channels, N)`` channels.  ``fused_update``
    on a config that :func:`fused_update_refusal` refuses raises
    ``ValueError`` with its reason.  ``mesh`` runs the
    iteration data-parallel (see the module docstring); the rollout with
    K3 alone, without the K4 update, is single-device."""
    check_fused_update(env_cfg, ppo_cfg)
    device = _device_of(train_state.params)
    k3_key, gen, shuffle_gen = _learner_keys(ppo_cfg, key, mesh,
                                             lambda seed, role: env_lib.make_generator(seed, device))
    local_cfg = _iteration_config(env_cfg, ppo_cfg, mesh)
    if not ppo_cfg.fused_rollout:
        assert noise is None, "noise= injects the fused rollout's channels"
    ts = _copy_state(train_state)
    outputs = None
    if ppo_cfg.fused_rollout:
        outputs = _k3_rollout(local_cfg, ts.params, k3_key, noise=_noise_columns(env_cfg, noise, mesh))
    metrics = _iteration_update(local_cfg, ppo_cfg, ts, gen, shuffle_gen, outputs, mesh=mesh)
    return ts._replace(update_count=ts.update_count + 1), metrics


def jit_train_iteration(env_cfg: EnvConfig, ppo_cfg: PPOConfig, train_state: PPOTrainState, key, mesh=None
                        ) -> Tuple[PPOTrainState, Dict[str, torch.Tensor]]:
    """:func:`train_iteration` compiled (ppo.py:553-555): on the card, one
    replay of a CUDA graph of the iteration, captured at the first call
    for these configs, this model's layout and this mesh
    (:mod:`mbt_gym_torch.compiled`); K3, where the learner rolls out on it,
    launches before the replay into the graph's buffers.  Bit for bit
    :func:`train_iteration` for the same int ``key``; the state given is
    left untouched.  On the CPU it is :func:`train_iteration`."""
    from mbt_gym_torch import compiled

    return compiled.train_iteration(env_cfg, ppo_cfg, train_state, key, mesh=mesh)


def iteration_keys(key, n_iterations: int) -> List[int]:
    """The per-iteration int seeds :func:`train_chunk` uses, drawn from
    ``key`` (an int seed or a ``torch.Generator``)."""
    gen = key if isinstance(key, torch.Generator) else torch.Generator().manual_seed(int(key))
    return torch.randint(0, 2**62, (n_iterations,), generator=gen, device=gen.device).tolist()


def train_chunk(env_cfg: EnvConfig, ppo_cfg: PPOConfig, train_state: PPOTrainState, key,
                n_iterations: int, mesh=None) -> Tuple[PPOTrainState, Dict[str, torch.Tensor]]:
    """``n_iterations`` train iterations on the seeds
    :func:`iteration_keys` draws from ``key``; metrics come back stacked
    with a leading ``(n_iterations,)`` axis (ppo.py:558-587).  ``mesh`` as
    in :func:`train_iteration`."""
    history = []
    for k in iteration_keys(key, n_iterations):
        train_state, metrics = train_iteration(env_cfg, ppo_cfg, train_state, k, mesh=mesh)
        history.append(metrics)
    return train_state, {k: torch.stack([m[k] for m in history]) for k in history[0]}


def jit_train_chunk(env_cfg: EnvConfig, ppo_cfg: PPOConfig, train_state: PPOTrainState, key,
                    n_iterations: int, mesh=None) -> Tuple[PPOTrainState, Dict[str, torch.Tensor]]:
    """:func:`train_chunk` compiled (ppo.py:590-592): on the card,
    ``n_iterations`` replays of :func:`jit_train_iteration`'s graph on the
    seeds of :func:`iteration_keys`, the state staying in the graph's
    buffers between them and each iteration's metrics copied into
    ``(n_iterations,)`` device buffers, with no host read in between.  On
    the CPU it is :func:`train_chunk`."""
    from mbt_gym_torch import compiled

    return compiled.train_chunk(env_cfg, ppo_cfg, train_state, key, n_iterations, mesh=mesh)


def deterministic_policy(env_cfg: EnvConfig):
    """The trained actor's mean action, clipped to the action space
    (ppo.py:595-618), tagged ``kind="mlp_deterministic"`` for the dispatch
    front door, whose ``mlp_rollout`` family (K3) serves
    :func:`evaluate_policy`."""
    from mbt_gym_torch.dispatch import tag_policy

    def policy(params, obs, state):
        return _clip_to_action_box(env_cfg, networks.policy_mean(params, obs))

    return tag_policy(policy, kind="mlp_deterministic", env_cfg=env_cfg)


@torch.no_grad()
def evaluate_policy(env_cfg: EnvConfig, params: networks.ActorCritic, key, n_episodes: int = 1,
                    backend: str = "auto") -> torch.Tensor:
    """Mean episode reward of the deterministic policy over ``n_episodes``
    fresh episodes (ppo.py:621-702), on the parameters' device, for either
    actor-critic layout.

    ``backend``: "fused" runs K3 with ``log_std = -30`` (std ~1e-13,
    negligible against float32 action scales) and raises ``ValueError``
    naming the feature when the config is outside the kernel's contract;
    "engine" the engine; "auto" (the default) what
    :func:`mbt_gym_torch.dispatch.dispatch_report` decides in its
    ``"evaluate"`` mode, where the choice between the two follows the
    port's measurement on the card (the JAX package's auto picks its
    engine, measured faster on its TPU)."""
    from mbt_gym_torch.dispatch import dispatch_report

    assert backend in ("auto", "engine", "fused"), backend
    device = _device_of(params)
    gen = env_lib.make_generator(key, device)
    total = torch.zeros((), dtype=torch.float32, device=device)
    if backend == "auto":
        decision = dispatch_report(env_cfg, deterministic_policy(env_cfg), mode="evaluate", platform=device,
                                   policy_params=params)
        backend = decision.backend
    if backend == "fused":
        from mbt_gym_torch.ops import mlp_rollout

        try:
            mlp_rollout.rollout_params_from_config(env_cfg)
        except AssertionError as e:
            raise ValueError(f"backend='fused' unavailable: {e}") from None
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
