"""The general generator: one closed loop per kind of traffic, driven by a
traffic mix's parameters and a configuration's.

A traffic file names its ``loop`` and its sizes:

- ``train``: back-to-back PPO iterations (``ppo.jit_train_iteration``) of
  ``envs`` envs, each ended by reading its metrics to the host.  Set-up
  builds the train state from the seed and drives it through ``checked``
  iterations of the same call, which the reference follows.
- ``mc_stats``: back-to-back ``rollout.mc_episode_stats(backend="auto")``
  calls of the configuration's closed-form agent, ``envs`` envs x
  ``episodes`` episodes a call, a fresh key each call, the agent's risk
  aversion cycling through ``risk_aversions``.
- ``evaluate``: back-to-back ``ppo.evaluate_policy(backend="auto")`` calls
  of a policy made from the seed, ``envs`` envs x ``episodes`` episodes, a
  fresh key each call.

A call is timed from its start until its result is on the host.  Every key
comes from the seed, so a seed fixes the inputs; every seed gives the same
sizes.  After the window, :meth:`Loop.check` works the checked answers out
again with the plain reference and returns the numbers that decide
``correct``.  ``rounding`` and the ``fault`` hooks put the reference in the
program's place, at a lower precision or with a planted fault: that is how
the limits' upper readings are taken.
"""
from __future__ import annotations

import gc
import importlib
import math
import random
import statistics
from typing import Dict, List, Optional

import torch

from benchmark.yardstick import compare, roofline, weights as weights_lib


def reference(name: str):
    """The plain reference module ``benchmark/reference/<name>.py`` a
    configuration names."""
    return importlib.import_module(f"benchmark.reference.{name}")


def loop_class(kind: str):
    """The loop of a traffic mix: one of :data:`LOOPS`, or ``LOOP`` of a
    module ``benchmark/loop_<kind>.py`` that a later change adds."""
    if kind in LOOPS:
        return LOOPS[kind]
    return importlib.import_module(f"benchmark.loop_{kind}").LOOP


def rate(calls: int, work: float, window_s: float) -> dict:
    """Env-steps a second over the whole window: every call's work over
    every second of it."""
    return {"value": calls * work / window_s, "unit": "env-steps/s"}


def p95(values) -> float:
    """The 95th percentile of every value (``statistics.quantiles``,
    inclusive method); a single value is its own."""
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=20, method="inclusive")[18]


def key_stream(seed: int, salt: int):
    """The int keys of a run, drawn from its seed."""
    rng = random.Random(int(seed) * 7919 + salt)
    while True:
        yield rng.randrange(1, 2**31 - 1)


def _sources(device: torch.device, names) -> None:
    """Build the cell's kernel libraries, in parallel, before anything loads
    them (a library already built in this checkout is reused)."""
    if device.type != "cuda":
        return
    from concurrent.futures import ThreadPoolExecutor

    from mbt_gym_torch.ops import _build

    with ThreadPoolExecutor(len(names)) as pool:
        for f in [pool.submit(_build.build, name) for name in names]:
            f.result()


def expect_launch(device: torch.device, counter: str, before: int) -> None:
    """On the card, the call just made must have launched ``counter``'s
    kernel: the cell measures the kernel path, not a fallback."""
    if device.type != "cuda":
        return
    from mbt_gym_torch.ops import _build

    if _build.launch_counts[counter] <= before:
        raise RuntimeError(f"the timed call did not launch {counter}: it took another path than the cell's")


def launches(counter: str) -> int:
    from mbt_gym_torch.ops import _build

    return _build.launch_counts[counter]


def k3_spec(bound: tuple) -> dict:
    names = ("mlp_rollout_kernel", "mlp_rollout_wide_kernel")
    return {"bound": bound, "names": names, "each_launch": names}


def program_env(config: dict, envs: int, raw_spaces: bool = False):
    """The port's ``EnvConfig`` of a configuration at ``envs`` envs, from
    the port's own factory of the env (``raw_spaces``: unnormalised, as a
    closed-form agent acts)."""
    import dataclasses

    from mbt_gym_torch.utils import config as factories

    env = config["env"]
    kwargs = {k: tuple(v) if isinstance(v, list) else v for k, v in env["kwargs"].items()}
    cfg = getattr(factories, env["factory"])(num_trajectories=envs, **kwargs)
    if raw_spaces:
        return cfg
    return dataclasses.replace(cfg, normalise_observation_space=bool(env.get("normalise_observation_space")),
                               normalise_action_space=bool(env.get("normalise_action_space")))


class Loop:
    """One cell's closed loop (module docstring)."""

    kind = ""
    kernel_sources: tuple = ()

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.device = torch.device(device)
        self.envs = int(traffic["envs"])
        self.ref = reference(config["reference"])
        self.env = self.ref.env_from_config(config)
        self.answers: list = []
        self.failed = 0

    @property
    def precision(self) -> str:
        """The precision the configuration states for the timed path's
        arithmetic, which the reference computes in."""
        return self.config["policy"]["precision"]

    # The kernels a call launches, by the program's launch counter: the
    # bound of one launch (seconds, "bytes" or "operations"), the names of
    # its device kernels, and those of them each launch runs at least once;
    # and the matrix FLOPs of a call.
    kernels: Dict[str, dict] = {}
    flops_per_call = 0.0

    def work_per_call(self) -> float:
        raise NotImplementedError

    def end_to_end(self, window_s: float, call_s: List[float]) -> Dict[str, dict]:
        """The loop's end-to-end metrics over the window (``setup_s`` aside)."""
        raise NotImplementedError

    def setup(self) -> None:
        raise NotImplementedError

    def call(self) -> None:
        raise NotImplementedError

    def free(self) -> None:
        """Release the program's state before the reference runs."""
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def check(self, rounding: Optional[str] = None, fault: Optional[str] = None) -> Dict[str, float]:
        raise NotImplementedError

    def _sample(self, k: int) -> list:
        """``k`` of the window's answers, drawn from the seed."""
        rng = random.Random(self.seed * 31 + 7)
        picks = sorted(rng.sample(range(len(self.answers)), min(k, len(self.answers))))
        return [self.answers[i] for i in picks]


# ------------------------------------------------------------ training
class TrainLoop(Loop):
    kind = "train"
    kernel_sources = ("mlp_rollout.cu", "fused_ppo.cu")

    def __init__(self, config, traffic, seed, device):
        super().__init__(config, traffic, seed, device)
        self.learner = config["learner"]
        self.policy = config["policy"]
        self.checked = int(traffic.get("checked", 3))
        env, pol = self.env, self.policy
        towers = 1 if pol["shared_trunk"] else 2
        steps = env.n_steps * self.envs
        n_mb = self.learner["n_minibatches"]
        samples = steps // n_mb
        widths = tuple(pol["hidden"])
        self.kernels = {
            "mlp_rollout": k3_spec(roofline.k3_bound(steps, env.s_dim, widths, env.a_dim, towers)),
            "ppo_fused_grads_T": {"bound": roofline.k4_bound(samples, env.s_dim, widths, env.a_dim, towers),
                                  "names": ("ppo_deep_pass1", "ppo_deep_pass2", "reduce_parts"),
                                  "each_launch": ("ppo_deep_pass1",)},
        }
        self.flops_per_call = (roofline.mlp_forward_flops(env.s_dim, widths, env.a_dim, towers) * steps
                               + roofline.ppo_grad_flops(env.s_dim, widths, env.a_dim, towers) * steps
                               * self.learner["n_epochs"])

    def work_per_call(self) -> float:
        return self.envs * self.env.n_steps

    def end_to_end(self, window_s, call_s):
        return {"train_env_steps_per_s": rate(len(call_s), self.work_per_call(), window_s)}

    def setup(self) -> None:
        _sources(self.device, self.kernel_sources)
        from mbt_gym_torch.agents import networks, ppo

        self.ppo = ppo
        self.env_cfg = program_env(self.config, self.envs)
        self.ppo_cfg = ppo.PPOConfig(hidden=tuple(self.policy["hidden"]), shared_trunk=self.policy["shared_trunk"],
                                     **self.learner)
        self.weights0 = weights_lib.actor_critic(self.seed, self.env.s_dim, self.env.a_dim, self.policy,
                                                 self.device)
        model = networks.ActorCritic(self.env.s_dim, self.env.a_dim, tuple(self.policy["hidden"]),
                                     self.policy["shared_trunk"], device=self.device)
        with torch.no_grad():
            model.load_state_dict({k: v.clone() for k, v in self.weights0.items()})
        self.ts = ppo.PPOTrainState(model, ppo.make_optimizer(self.ppo_cfg, model), 0)
        self.keys = key_stream(self.seed, 1)
        self.checked_keys, self.checked_metrics = [], []
        for i in range(self.checked):
            key = next(self.keys)
            before = launches("ppo_fused_grads_T")
            self.ts, metrics = ppo.jit_train_iteration(self.env_cfg, self.ppo_cfg, self.ts, key)
            expect_launch(self.device, "ppo_fused_grads_T", before)
            self.checked_keys.append(key)
            self.checked_metrics.append({k: float(v) for k, v in metrics.items()})
            if i == 0:
                self.first_moment = self._moments()
        self.params_after = {k: v.detach().clone() for k, v in self.ts.params.named_parameters()}

    def _moments(self) -> Dict[str, torch.Tensor]:
        opt = self.ts.opt_state  # a parameter the optimizer never stepped has no state: a zero moment
        return {name: opt.state[p]["exp_avg"].detach().clone() if "exp_avg" in opt.state[p] else torch.zeros_like(p)
                for name, p in self.ts.params.named_parameters()}

    def call(self) -> None:
        self.ts, metrics = self.ppo.jit_train_iteration(self.env_cfg, self.ppo_cfg, self.ts, next(self.keys))
        values = torch.stack([metrics[k] for k in sorted(metrics)]).tolist()
        if not all(math.isfinite(v) for v in values):
            self.failed += 1

    def free(self) -> None:
        from mbt_gym_torch import compiled

        self.ts = None
        compiled.clear_cache()
        super().free()

    def _reference(self, rounding: str, fault: Optional[str]):
        """The reference's ``checked`` iterations: their metrics and episode
        returns, Adam's first moment after the first, the parameters after
        the last."""
        params = {k: v.clone() for k, v in self.weights0.items()}
        opt = self.ref.Adam(params, self.learner["learning_rate"], self.learner["max_grad_norm"])
        share = 0.5 if fault == "half_batch" else 1.0
        iterations, first_moment = [], None
        for i, key in enumerate(self.checked_keys):
            it = self.ref.train_iteration(self.env, self.learner, opt, key, self.envs, self.ref.ROUNDINGS[rounding], self.device,
                                    sample_share=share, freeze=fault == "frozen")
            iterations.append(it)
            if i == 0:
                first_moment = {k: v.clone() for k, v in opt.m.items()}
        return iterations, first_moment, params

    def check(self, rounding: Optional[str] = None, fault: Optional[str] = None) -> Dict[str, float]:
        """The numbers of the program's checked iterations against the
        reference's; with ``rounding`` or ``fault`` the reference at that
        precision, or with that fault, stands in for the program."""
        if getattr(self, "_reference_run", None) is None:
            self._reference_run = self._reference(self.precision, None)
        ref_its, ref_moment, ref_params = self._reference_run
        if rounding is None and fault is None:
            prog = [it for it in self.checked_metrics]
            prog_moment, prog_params = self.first_moment, self.params_after
        else:
            its, prog_moment, prog_params = self._reference(rounding or self.precision, fault)
            prog = [it.metrics for it in its]
        vf = self.learner["vf_coef"]
        losses, rewards = [], []
        for p, r in zip(prog, ref_its):
            loss_r = r.metrics["pg_loss"] + vf * r.metrics["vf_loss"]
            losses.append(compare.scalar_gap(p["pg_loss"] + vf * p["vf_loss"], loss_r, abs(loss_r)))
            rewards.append(compare.scalar_gap(p["mean_episode_reward"], r.metrics["mean_episode_reward"],
                                              float(r.episode_returns.abs().mean())))
        change_p = {k: prog_params[k] - self.weights0[k] for k in ref_params}
        change_r = {k: ref_params[k] - self.weights0[k] for k in ref_params}
        self.details = {
            "loss_gaps": losses, "reward_gaps": rewards,
            "moment_leaves": compare.leaf_gaps(prog_moment, ref_moment),
            "change_leaves": compare.leaf_gaps(change_p, change_r, gradient=ref_moment),
        }
        # the first step's loss and reward: the later steps' swing with the
        # rounding-level difference of the parameters they start from
        return {
            "loss_gap": losses[0],
            "reward_gap": rewards[0],
            "moment_gap": compare.median_leaf_gap(prog_moment, ref_moment),
            "change_gap": compare.median_leaf_gap(change_p, change_r, gradient=ref_moment),
        }


# ------------------------------------------------------------ Monte Carlo
class McStatsLoop(Loop):
    kind = "mc_stats"
    kernel_sources = ("as_episode.cu",)
    STATS = ("mean_pnl", "std_pnl", "mean_terminal_inventory", "std_terminal_inventory")

    def __init__(self, config, traffic, seed, device):
        super().__init__(config, traffic, seed, device)
        self.episodes = int(traffic["episodes"])
        self.gammas = [float(g) for g in traffic["risk_aversions"]]
        self.kernels = {"as_episode": {"bound": roofline.k1_bound(self.envs, self.env.n_steps),
                                       "names": ("as_episode_kernel",), "each_launch": ("as_episode_kernel",)}}

    @property
    def precision(self) -> str:
        return self.config["closed_form_agent"]["precision"]

    def work_per_call(self) -> float:
        return self.envs * self.env.n_steps * self.episodes

    def end_to_end(self, window_s, call_s):
        return {"sim_env_steps_per_s": rate(len(call_s), self.work_per_call(), window_s),
                "sim_call_ms_p95": {"value": p95(call_s) * 1e3, "unit": "ms"}}

    def setup(self) -> None:
        _sources(self.device, self.kernel_sources)
        from mbt_gym_torch.agents.baseline import AvellanedaStoikovAgent
        from mbt_gym_torch.rollout import mc_episode_stats

        self.mc_episode_stats = mc_episode_stats
        self.env_cfg = program_env(self.config, self.envs, raw_spaces=True)
        self.policies = [AvellanedaStoikovAgent.from_config(self.env_cfg, risk_aversion=g).policy()
                         for g in self.gammas]
        self.keys = key_stream(self.seed, 2)
        self.calls = 0
        for i in range(len(self.gammas)):  # every agent once, untimed
            before = launches("as_episode")
            self._stats(i, next(key_stream(self.seed, 3 + i)))
            expect_launch(self.device, "as_episode", before)

    def _stats(self, i: int, key: int) -> List[float]:
        stats = self.mc_episode_stats(self.env_cfg, self.policies[i], None, key, episodes=self.episodes,
                                      backend="auto", device=self.device)
        return torch.stack([stats[k] for k in self.STATS]).tolist()

    def call(self) -> None:
        i = self.calls % len(self.gammas)
        key = next(self.keys)
        values = self._stats(i, key)
        self.calls += 1
        if not all(math.isfinite(v) for v in values):
            self.failed += 1
        self.answers.append((self.gammas[i], key, values))

    def check(self, rounding: Optional[str] = None, fault: Optional[str] = None) -> Dict[str, float]:
        worst = 0.0
        dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[rounding or self.precision]
        agent_ref = reference(self.config["closed_form_agent"]["reference"])
        for gamma, key, values in self._sample(int(self.traffic.get("checked", 3))):
            ref = agent_ref.mc_stats(self.env, gamma, key, self.envs, self.episodes, self.device)
            if rounding is not None:
                got = agent_ref.mc_stats(self.env, gamma, key, self.envs, self.episodes, self.device, dtype)
                values = [got[k] for k in self.STATS]
            for name, v in zip(self.STATS, values):
                scale = ref["std_pnl"] if "pnl" in name else ref["std_terminal_inventory"]
                worst = max(worst, compare.scalar_gap(v, ref[name], scale))
        return {"stats_gap": worst}


# ------------------------------------------------------------ evaluation
class EvaluateLoop(Loop):
    kind = "evaluate"
    kernel_sources = ("mlp_rollout.cu",)

    def __init__(self, config, traffic, seed, device):
        super().__init__(config, traffic, seed, device)
        self.policy = config["policy"]
        self.episodes = int(traffic["episodes"])
        env = self.env
        towers = 1 if self.policy["shared_trunk"] else 2
        steps = env.n_steps * self.envs
        widths = tuple(self.policy["hidden"])
        self.kernels = {"mlp_rollout": k3_spec(roofline.k3_bound(steps, env.s_dim, widths, env.a_dim, towers))}
        self.flops_per_call = roofline.mlp_forward_flops(env.s_dim, widths, env.a_dim, towers) * steps * self.episodes

    def work_per_call(self) -> float:
        return self.envs * self.env.n_steps * self.episodes

    def end_to_end(self, window_s, call_s):
        return {"eval_env_steps_per_s": rate(len(call_s), self.work_per_call(), window_s)}

    def _weights(self) -> Dict[str, torch.Tensor]:
        evaluated = self.config["evaluated_policy"]
        return weights_lib.actor_critic(self.seed, self.env.s_dim, self.env.a_dim, self.policy, self.device,
                                        head_std=evaluated["head_std"], head_bias=evaluated["head_bias"])

    def setup(self) -> None:
        _sources(self.device, self.kernel_sources)
        from mbt_gym_torch.agents import networks, ppo

        self.ppo = ppo
        self.env_cfg = program_env(self.config, self.envs)
        self.weights = self._weights()
        self.model = networks.ActorCritic(self.env.s_dim, self.env.a_dim, tuple(self.policy["hidden"]),
                                          self.policy["shared_trunk"], device=self.device)
        with torch.no_grad():
            self.model.load_state_dict({k: v.clone() for k, v in self.weights.items()})
        self.keys = key_stream(self.seed, 4)
        before = launches("mlp_rollout")
        self._reward(next(key_stream(self.seed, 5)))  # untimed
        expect_launch(self.device, "mlp_rollout", before)

    def _reward(self, key: int) -> float:
        return float(self.ppo.evaluate_policy(self.env_cfg, self.model, key, n_episodes=self.episodes,
                                              backend="auto"))

    def call(self) -> None:
        key = next(self.keys)
        value = self._reward(key)
        if not math.isfinite(value):
            self.failed += 1
        self.answers.append((key, value))

    def free(self) -> None:
        self.model = None
        super().free()

    def check(self, rounding: Optional[str] = None, fault: Optional[str] = None) -> Dict[str, float]:
        worst = 0.0
        for key, value in self._sample(int(self.traffic.get("checked", 3))):
            ref, scale = self.ref.evaluate(self.env, self.weights, key, self.envs, self.ref.ROUNDINGS[self.precision], self.device, self.episodes)
            if rounding is not None:
                value, _ = self.ref.evaluate(self.env, self.weights, key, self.envs, self.ref.ROUNDINGS[rounding], self.device,
                                       self.episodes)
            worst = max(worst, compare.scalar_gap(value, ref, scale))
        return {"reward_gap": worst}


LOOPS = {cls.kind: cls for cls in (TrainLoop, McStatsLoop, EvaluateLoop)}
