"""Gym-API interop (counterpart of ``mbt_gym_tpu/gym_compat.py``; reference
``TradingEnvironment(gym.Env)`` and ``StableBaselinesTradingEnvironment``).

The engine's native interface is pure functions over a state on the
device; these adapters wrap it in the stateful APIs external RL stacks
expect:

- :class:`GymTradingEnv` — a gymnasium ``Env`` stepping all N trajectories
  per call with batched arrays, like the reference's batched
  ``TradingEnvironment`` (its spaces describe one trajectory; arrays carry
  a leading N axis).  It needs gymnasium and raises ``ImportError``
  without it.
- :class:`VecTradingEnv` — the Stable-Baselines3 ``VecEnv`` API
  (step_async/step_wait/reset, the terminal-observation autoreset
  convention, StableBaselinesTradingEnvironment.py:25-37).  Duck-typed, so
  it works without SB3 and, without spaces, without gymnasium; where SB3
  imports it is registered as a virtual subclass of its ``VecEnv``.
- ``VectorTradingEnv`` — a native ``gymnasium.vector.VectorEnv``, built
  when first read (``ImportError`` without gymnasium).

The env state lives on ``device`` (``None`` means ``"cuda"``) and is
stepped by :func:`mbt_gym_torch.env.step`; actions come in as NumPy and
go to the device, observations, rewards and dones come back as NumPy.

Seeds: ``seed`` (default 0) becomes a ``torch.Generator`` on the device.
Each reset passes that generator to :func:`mbt_gym_torch.env.reset`, which
draws from it, in this order, the random start time (a ``("uniform", lo,
hi)`` spec), then the random initial inventories (an ``(lo, hi)`` spec),
and makes it the state's noise source: every step then draws its noise
from it in :func:`~mbt_gym_torch.env.draw_step_noise`'s slot order, and
the next reset continues the same stream.  Callable specs are evaluated on
the host at each reset (TradingEnvironment.py:257-281) and draw nothing.
So a seed and a sequence of actions fix every observation.

The per-step list of N info dicts is host work that grows with N (the SB3
contract asks for it); it is built once per step, and the terminal
observations are stored in it only on the episode's last step.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from mbt_gym_torch import env as env_lib
from mbt_gym_torch.dynamics import AtTheTouchDynamics
from mbt_gym_torch.env import EnvConfig

try:  # pragma: no cover - import guard
    import gymnasium

    _GYM_BASE = gymnasium.Env
except ImportError:  # pragma: no cover
    gymnasium = None
    _GYM_BASE = object


def _require_gymnasium(what: str) -> None:
    if gymnasium is None:
        raise ImportError(f"gymnasium is required for {what} (pip install gymnasium)")


def _adapter_reset(cfg: EnvConfig, gen: torch.Generator, device: torch.device):
    """Shared reset of the adapters: callable specs are evaluated on the
    host at each reset (TradingEnvironment.py:257-281 semantics) and passed
    to :func:`mbt_gym_torch.env.reset` as overrides."""
    start, inv = env_lib.resolve_reset_overrides(cfg)
    return env_lib.reset(cfg, gen, start_time=start, initial_inventory=inv, device=device)


def _make_obs_reducer(observation_indices):
    """Reduced-observation plumbing shared by the adapters: the normalised
    index tuple (or None) and ``reduce(obs (N, S)) -> (N, k)`` (identity
    when no indices were given)."""
    if observation_indices is None:
        return None, (lambda obs: obs)
    indices = tuple(observation_indices)
    idx = np.asarray(indices, dtype=np.intp)
    return indices, (lambda obs: obs[:, idx])


def _build_spaces(cfg: EnvConfig, observation_indices=None):
    """(observation_space, action_space) for one trajectory (gymnasium).

    ``observation_indices`` reduces the advertised observation space to the
    selected state columns — the adapter-level counterpart of the
    reference's ``ReduceStateSizeWrapper`` (wrappers.py:10-43), which its
    RL workflow applies below the SB3 adapter (experiments/helpers.py:63-65)."""
    _require_gymnasium("gym-API spaces")
    obs_low, obs_high = cfg.observation_bounds()
    if cfg.normalise_observation_space:
        obs_low, obs_high = -np.ones_like(obs_low), np.ones_like(obs_high)
    if observation_indices is not None:
        idx = list(observation_indices)
        obs_low, obs_high = obs_low[idx], obs_high[idx]
    observation_space = gymnasium.spaces.Box(low=obs_low.astype(np.float32), high=obs_high.astype(np.float32))
    if isinstance(cfg.dynamics, AtTheTouchDynamics):
        action_space = gymnasium.spaces.MultiBinary(2)  # ModelDynamics.py:166-167
    else:
        act_low, act_high = cfg.action_bounds()
        if cfg.normalise_action_space:
            act_low, act_high = -np.ones_like(act_low), np.ones_like(act_high)
        action_space = gymnasium.spaces.Box(low=act_low.astype(np.float32), high=act_high.astype(np.float32))
    return observation_space, action_space


class ActionInfoCalculator:
    """Per-step info hook (counterpart of ``ActionInfoCalculator``,
    info_calculators.py:18-52): empty infos every non-terminal step, then at
    the terminal step per-trajectory mean actions over the episode.

    Reference semantics kept: the terminal step's own action is NOT
    recorded (the reference returns before appending on done,
    info_calculators.py:35-44), and the reference's ``ndarray.nanmean``
    AttributeError at :52 is fixed to the intended mean.  The running sum
    is an (N, A) float64 array on the host."""

    def __init__(self, num_trajectories: int, action_dim: int):
        self.num_trajectories = num_trajectories
        self.action_dim = action_dim
        self.reset(None)

    def reset(self, initial_state=None) -> None:
        self._sum = np.zeros((self.num_trajectories, self.action_dim))
        self._count = 0

    def calculate(self, state, action, reward, done: bool):
        if done:
            mean_actions = self._sum / max(self._count, 1)
            return [
                {f"action_{j}": float(mean_actions[i, j]) for j in range(self.action_dim)}
                for i in range(self.num_trajectories)
            ]
        self._sum += np.asarray(action).reshape(self.num_trajectories, self.action_dim)
        self._count += 1
        return [{} for _ in range(self.num_trajectories)]


class _Stepper:
    """The device side both adapters share: the config, the generator, the
    state, and one step from host actions to host arrays."""

    def __init__(self, cfg: EnvConfig, seed: Optional[int], device):
        self.cfg = cfg
        self.device = env_lib.resolve_device(device)
        self.seed(seed)
        self._state = None

    def seed(self, seed: Optional[int]) -> None:
        self._gen = env_lib.make_generator(0 if seed is None else int(seed), self.device)

    def reset(self) -> np.ndarray:
        self._state, obs = _adapter_reset(self.cfg, self._gen, self.device)
        return obs.cpu().numpy()

    def step(self, actions):
        cfg = self.cfg
        action = np.asarray(actions, dtype=cfg.dtype).reshape(cfg.num_trajectories, cfg.action_dim)
        res = env_lib.step(cfg, self._state, torch.from_numpy(action).to(self.device))
        self._state = res.state
        return action, res.obs.cpu().numpy(), res.reward.cpu().numpy(), res.done.cpu().numpy()


class GymTradingEnv(_GYM_BASE):
    """Batched gymnasium adapter over the engine.

    ``observation_indices`` (e.g. ``(INVENTORY_INDEX, TIME_INDEX)``) makes
    the adapter advertise AND emit only those state columns (the
    reference's ``wrap_env`` = ReduceStateSizeWrapper below the SB3
    adapter, experiments/helpers.py:63-65)."""

    metadata = {"render_modes": ["human"]}

    def __init__(self, cfg: EnvConfig, seed: Optional[int] = None,
                 info_calculator: Optional[ActionInfoCalculator] = None,
                 observation_indices: Optional[tuple] = None, device=None):
        _require_gymnasium("GymTradingEnv")
        self.cfg = cfg
        self._env = _Stepper(cfg, seed, device)
        self.info_calculator = info_calculator
        self.observation_indices, self._reduce = _make_obs_reducer(observation_indices)
        self.observation_space, self.action_space = _build_spaces(cfg, self.observation_indices)

    @property
    def num_trajectories(self) -> int:
        return self.cfg.num_trajectories

    @property
    def n_steps(self) -> int:
        return self.cfg.n_steps

    def seed(self, seed: Optional[int] = None):
        self._env.seed(seed)

    def reset(self, *, seed: Optional[int] = None, options=None):
        if seed is not None:
            self.seed(seed)
        obs = self._env.reset()
        if self.info_calculator is not None:
            self.info_calculator.reset(obs)
        return self._reduce(obs), {}

    def step(self, action):
        action, obs, reward, terminated = self._env.step(action)
        truncated = np.zeros_like(terminated)
        # Per-step infos (TradingEnvironment.py:222-227): a list of N dicts
        # either way, as the reference returns.
        if self.info_calculator is not None:
            info = self.info_calculator.calculate(obs, action, reward, bool(terminated[0]))
        else:
            info = [{} for _ in range(self.cfg.num_trajectories)]
        return self._reduce(obs), reward, terminated, truncated, info


class VecTradingEnv:
    """SB3 ``VecEnv``-shaped adapter with the terminal-observation autoreset
    convention (StableBaselinesTradingEnvironment.py:28-37).

    Implements the full SB3 ``VecEnv`` abstract API — ``get_attr`` /
    ``set_attr`` / ``env_method`` / ``env_is_wrapped`` /
    ``getattr_depth_check`` / ``get_images`` / ``render`` — with
    DummyVecEnv semantics against the single batched env: each "sub-env"
    resolves to this adapter, so per-env results are the adapter's value
    replicated ``num_envs`` times.  The spaces are set where gymnasium
    imports and absent otherwise."""

    def __init__(self, cfg: EnvConfig, seed: Optional[int] = None,
                 store_terminal_observation_info: bool = True,
                 info_calculator: Optional[ActionInfoCalculator] = None,
                 observation_indices: Optional[tuple] = None, device=None):
        self.cfg = cfg
        self.num_envs = cfg.num_trajectories
        self.store_terminal_observation_info = store_terminal_observation_info
        self.info_calculator = info_calculator
        # spaces, emitted observations and terminal_observation infos are
        # all reduced to the selected columns
        self.observation_indices, self._reduce = _make_obs_reducer(observation_indices)
        self._env = _Stepper(cfg, seed, device)
        self._actions = None
        if gymnasium is not None:  # SB3's BaseAlgorithm reads these
            self.observation_space, self.action_space = _build_spaces(cfg, self.observation_indices)
        self.render_mode = None

    # ------------------------------------------------------------- stepping
    def reset(self):
        obs = self._env.reset()
        if self.info_calculator is not None:
            self.info_calculator.reset(obs)
        return self._reduce(obs)

    def step_async(self, actions) -> None:
        self._actions = actions

    def step_wait(self):
        action, obs, rewards, dones = self._env.step(self._actions)
        done = bool(dones.min())
        if self.info_calculator is not None:
            infos = self.info_calculator.calculate(obs, action, rewards, done)
        else:
            infos = [{} for _ in range(self.num_envs)]
        obs = self._reduce(obs)
        if done:
            if self.store_terminal_observation_info:
                for info, row in zip(infos, obs):
                    info["terminal_observation"] = row
            obs = self.reset()
        return obs, rewards, dones, infos

    def step(self, actions):
        self.step_async(actions)
        return self.step_wait()

    def seed(self, seed: Optional[int] = None):
        self._env.seed(seed)
        # SB3 convention: one seed entry per sub-env (DummyVecEnv.seed).
        return [seed for _ in range(self.num_envs)]

    def close(self) -> None:
        pass

    # ---------------------------------------------- VecEnv abstract surface
    @property
    def unwrapped(self):
        return self

    def _get_indices(self, indices) -> list:
        """Normalise SB3's VecEnvIndices (None | int | Iterable[int])."""
        if indices is None:
            return list(range(self.num_envs))
        if isinstance(indices, int):
            return [indices]
        return list(indices)

    def get_attr(self, attr_name: str, indices=None) -> list:
        value = getattr(self, attr_name)
        return [value for _ in self._get_indices(indices)]

    def set_attr(self, attr_name: str, value, indices=None) -> None:
        # One batched env backs every index: setting on any index sets all.
        setattr(self, attr_name, value)

    def env_method(self, method_name: str, *method_args, indices=None, **method_kwargs) -> list:
        result = getattr(self, method_name)(*method_args, **method_kwargs)
        return [result for _ in self._get_indices(indices)]

    def env_is_wrapped(self, wrapper_class, indices=None) -> list:
        # No per-env gym wrappers underneath (the reference's constant
        # False, StableBaselinesTradingEnvironment.py:53-54).
        return [False for _ in self._get_indices(indices)]

    def getattr_depth_check(self, name: str, already_found: bool):
        """SB3 VecEnv.getattr_depth_check: report shadowed attributes."""
        if hasattr(self, name) and already_found:
            return f"{type(self).__module__}.{type(self).__name__}"
        return None

    def get_images(self):
        return [None for _ in range(self.num_envs)]

    def render(self, mode: Optional[str] = None):
        return None

    # Convenience parity accessors (StableBaselinesTradingEnvironment.py:61-66)
    @property
    def num_trajectories(self) -> int:
        return self.cfg.num_trajectories

    @property
    def n_steps(self) -> int:
        return self.cfg.n_steps


try:  # pragma: no cover - optional SB3 registration
    from stable_baselines3.common.vec_env import VecEnv as _SB3VecEnv

    _SB3VecEnv.register(VecTradingEnv)  # type: ignore[attr-defined]
except ImportError:
    pass


@functools.cache
def _make_vector_trading_env_class():
    """Build VectorTradingEnv when first read, so the module imports
    without gymnasium (VecTradingEnv above is duck-typed)."""
    _require_gymnasium("VectorTradingEnv")
    from gymnasium.vector import AutoresetMode, VectorEnv
    from gymnasium.vector.utils import batch_space

    class VectorTradingEnv(VectorEnv):
        """Native ``gymnasium.vector.VectorEnv`` adapter, with gymnasium >=
        1.0 NEXT_STEP autoreset semantics (``metadata['autoreset_mode']``):
        the terminal step returns the FINAL observations with
        ``terminations=True``; the following ``step`` ignores its actions,
        resets every sub-env (all episodes share the fixed horizon) and
        returns the reset observations with zero rewards and all-False
        terminations."""

        metadata = {"autoreset_mode": AutoresetMode.NEXT_STEP}
        render_mode = None

        def __init__(self, cfg: EnvConfig, seed: Optional[int] = None,
                     observation_indices: Optional[tuple] = None, device=None):
            self.cfg = cfg
            self.num_envs = cfg.num_trajectories
            self.observation_indices, self._reduce = _make_obs_reducer(observation_indices)
            self.single_observation_space, self.single_action_space = _build_spaces(
                cfg, self.observation_indices
            )
            self.observation_space = batch_space(self.single_observation_space, self.num_envs)
            self.action_space = batch_space(self.single_action_space, self.num_envs)
            self._env = _Stepper(cfg, seed, device)
            self._needs_reset = True

        def _do_reset(self):
            obs = self._env.reset()
            self._needs_reset = False
            return self._reduce(obs)

        def reset(self, *, seed: Optional[int] = None, options=None):
            if seed is not None:
                self._env.seed(seed)
            return self._do_reset(), {}

        def step(self, actions):
            n = self.num_envs
            if self._needs_reset:
                # NEXT_STEP autoreset: this step's actions are ignored,
                # every sub-env resets (episodes are synchronized).
                obs = self._do_reset()
                zeros = np.zeros(n, dtype=self.cfg.dtype)  # the engine's reward dtype
                falses = np.zeros(n, dtype=bool)
                return obs, zeros, falses, falses, {}
            _, obs, reward, terminations = self._env.step(actions)
            self._needs_reset = bool(terminations.all())
            return self._reduce(obs), reward, terminations, np.zeros(n, dtype=bool), {}

        def close_extras(self, **kwargs):
            pass

    return VectorTradingEnv


def __getattr__(name):
    if name == "VectorTradingEnv":
        return _make_vector_trading_env_class()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
