"""The compiled entry points: CUDA-graph captures of the engine and of the
PPO and REINFORCE iterations (the port's counterpart of the JAX package's
``jax.jit`` wrappers).

The JAX package compiles four entry points into one program each:

- ``jit_rollout``, ``mbt_gym_tpu/rollout.py:214-216`` ->
  :func:`mbt_gym_torch.rollout.jit_rollout` (:func:`rollout` here);
- ``jit_train_iteration``, ``mbt_gym_tpu/agents/ppo.py:553-555`` ->
  :func:`mbt_gym_torch.agents.ppo.jit_train_iteration`
  (:func:`train_iteration` here);
- ``jit_train_chunk``, ``mbt_gym_tpu/agents/ppo.py:590-592`` ->
  :func:`mbt_gym_torch.agents.ppo.jit_train_chunk` (:func:`train_chunk`);
- ``jit_train_epoch``, ``mbt_gym_tpu/agents/reinforce.py:116-118`` ->
  :func:`mbt_gym_torch.agents.reinforce.jit_train_epoch`
  (:func:`train_epoch`).

On the card each is one replay of a ``torch.cuda.CUDAGraph`` captured at
the first call for its static arguments (the frozen configs, the policy
callable or its dispatch tag, the layout of the parameters and of the
optimizer, the device and the mesh: JAX's static arguments) and kept in a
small LRU cache
(:data:`MAX_ENTRIES` entries, each pinning its graph's memory pool;
:func:`clear_cache` empties it, as ``jax.clear_caches`` does).  A capture
is PyTorch's documented one: :data:`WARMUP_CALLS` eager calls on a side
stream, then one call under ``torch.cuda.graph``.  A call then copies the
caller's state into the graph's static buffers, seeds the entry's own
``torch.Generator`` (registered with the graph) with the int ``key``, so
the replay draws what the eager function draws from
``env.make_generator(key)``, replays, and copies the outputs into fresh
tensors, which carry no autograd history (the episode is captured under
``torch.no_grad``): the state given is left untouched, and nothing is
read back to the host.  The captured bits are the eager ones (no ``torch.compile``: its
fusions change the float bits).

K3 takes its Philox seed by value, so a capture would freeze it: where a
learner rolls out on K3, K3 launches eagerly before each replay into the
entry's buffers (``ops.mlp_rollout.rollout_fused_T(..., out=)``) and the
graph holds the rest.  K4 and K7 are captured as they are.  A replay adds
the launches its capture recorded to ``ops._build.launch_counts``, so the
counters read as they do eagerly.

Keys are int seeds: a ``torch.Generator`` raises ``TypeError``.  On the
CPU every entry point runs its eager function.  On the card a capture
that fails raises; nothing falls back to the eager path, and the caching
allocator is left as it was before the capture (:func:`_abandon_capture`).
"""
from __future__ import annotations

import collections
import copy
import operator
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

import torch
from torch import nn

from mbt_gym_torch import env as env_lib
from mbt_gym_torch.ops import _build
from mbt_gym_torch.utils.profiling import span

WARMUP_CALLS = 1
MAX_ENTRIES = 4


class Entry(NamedTuple):
    """One captured call: its graph, the static buffers it reads
    (``inputs``) and writes (``outputs``), the generators registered with
    it, the kernel launches one replay makes, the seconds the warm-up and
    capture took and the bytes its memory pool took."""

    graph: Any
    inputs: Any
    outputs: Any
    generators: tuple
    launches: Dict[str, int]
    capture_seconds: float
    pool_bytes: int


_CACHE: "collections.OrderedDict[tuple, Entry]" = collections.OrderedDict()


def clear_cache() -> None:
    """Drop every captured graph and release its memory pool.  Call it
    before ``torch.distributed.destroy_process_group`` where a graph holds
    NCCL collectives: NCCL's communicator teardown waits for every graph
    that holds its work to be released."""
    while _CACHE:
        _, entry = _CACHE.popitem()
        entry.graph.reset()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def cache_info() -> List[dict]:
    """``{"entry", "capture_seconds", "pool_bytes", "launches"}`` of every
    cached capture, oldest first; ``entry`` names the entry point."""
    return [{"entry": key[0], "capture_seconds": e.capture_seconds, "pool_bytes": e.pool_bytes,
             "launches": dict(e.launches)} for key, e in _CACHE.items()]


def int_key(key) -> int:
    """The int seed of a compiled entry point's ``key``."""
    if isinstance(key, torch.Generator):
        raise TypeError("the compiled entry points take an int seed as key (a torch.Generator cannot seed a "
                        "captured graph without a read back to the host); pass an int")
    return operator.index(key)


# ------------------------------------------------------------ static state
def signature(obj) -> Any:
    """A hashable description of ``obj``'s layout: each tensor's shape,
    dtype and device, a module's parameter names, other values as they
    are.  Two arguments with one signature share a captured graph."""
    if isinstance(obj, torch.Tensor):
        return ("tensor", tuple(obj.shape), obj.dtype, obj.device)
    if isinstance(obj, nn.Module):
        return (type(obj).__name__,) + tuple((name, signature(t)) for name, t in obj.state_dict(keep_vars=True).items())
    if isinstance(obj, dict):
        return ("dict",) + tuple((k, signature(v)) for k, v in sorted(obj.items()))
    if isinstance(obj, (tuple, list)):
        return (type(obj).__name__,) + tuple(signature(v) for v in obj)
    hash(obj)  # anything else is a static argument, by value
    return obj


def tensors(obj) -> List[torch.Tensor]:
    """The tensors of ``obj`` (a module's state, a tensor, nested tuples,
    lists and dicts of them), in :func:`signature`'s order."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, nn.Module):
        return list(obj.state_dict(keep_vars=True).values())
    if isinstance(obj, dict):
        return [t for _, v in sorted(obj.items()) for t in tensors(v)]
    if isinstance(obj, (tuple, list)):
        return [t for v in obj for t in tensors(v)]
    return []


def copy_into(dst: Sequence[torch.Tensor], src: Sequence[torch.Tensor]) -> None:
    """``dst[i] <- src[i]`` for every pair, on the current stream."""
    if dst:
        with torch.no_grad():
            torch._foreach_copy_(list(dst), list(src))


def fresh(obj, generators=()):
    """``obj`` with every tensor cloned and every generator of
    ``generators`` replaced by a new one in its state: the outputs a replay
    hands the caller, which the next replay does not overwrite."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().clone()
    if isinstance(obj, torch.Generator):
        if any(obj is g for g in generators):
            gen = torch.Generator(device=obj.device)
            gen.set_state(obj.get_state())
            return gen
        return obj
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(fresh(v, generators) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(fresh(v, generators) for v in obj)
    if isinstance(obj, dict):
        return type(obj)((k, fresh(v, generators)) for k, v in obj.items())
    return obj


def _cuda(device) -> torch.device:
    return torch.device("cuda", device.index if device.index is not None else torch.cuda.current_device())


# ------------------------------------------------------------ capture
def capture(device: torch.device, body: Callable[[], Any],
            generators: Callable[[], Sequence[torch.Generator]] = tuple):
    """Warm ``body`` up (:data:`WARMUP_CALLS` eager calls on a side stream),
    then capture one call of it into a ``torch.cuda.CUDAGraph`` with the
    generators that ``generators()`` gives after the warm-up (which may
    make some) registered; returns ``(graph, body's outputs, launches per
    replay, seconds, pool bytes)``: the seconds of its ``mbt.graph.capture``
    span, which records whether tracing is on or not.  The warm-up's
    launches are real and counted; the capture's are recorded and taken
    back off the counters."""
    with span("mbt.graph.capture", always=True) as timer, torch.cuda.device(device):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(WARMUP_CALLS):
                body()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        graph = torch.cuda.CUDAGraph()
        for gen in generators():
            graph.register_generator_state(gen)
        before = dict(_build.launch_counts)
        stream, pool = torch.cuda.current_stream(), torch.cuda.graph_pool_handle()
        try:
            with torch.cuda.graph(graph, pool=pool):
                outputs = body()
        except BaseException:
            _abandon_capture(graph, device, stream, pool)
            raise
        finally:
            launches = {k: v - before[k] for k, v in _build.launch_counts.items() if v != before[k]}
            _build.launch_counts.update(before)
        torch.cuda.synchronize()
        pool_bytes = torch.cuda.memory_reserved() - reserved
    return graph, outputs, launches, timer.record.seconds, pool_bytes


def _abandon_capture(graph: torch.cuda.CUDAGraph, device: torch.device, stream: torch.cuda.Stream,
                     pool) -> None:
    """Undo what a failed capture leaves behind.  When the stream capture is
    invalidated (a host read inside it), ``torch.cuda.graph``'s exit raises
    in PyTorch's ``capture_end`` at ``cudaStreamEndCapture``: before it
    restores the caller's current ``stream``, and before it stops routing
    the device's allocations to the graph's memory ``pool`` (whose handle
    the graph no longer gives).  While a pool is being captured into, the
    caching allocator releases none of its cached blocks, not on
    ``empty_cache`` and not when an allocation runs out, so every later
    allocation's freed memory would stay reserved (8 GiB made, used on
    another stream and freed after one failed capture stayed reserved:
    chip_smoke.py phase 27f).  This restores the stream, ends the routing
    where it is still on, then lets the pool go as a destroyed graph's
    does."""
    torch.cuda.set_stream(stream)
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        torch._C._cuda_endAllocateToPool(index, pool)
    except RuntimeError:  # capture_end got past it: reset releases the pool if the capture ended
        graph.reset()
        return
    torch._C._cuda_releasePool(index, pool)


@span("mbt.graph.replay")
def replay(entry: Entry) -> None:
    """Replay ``entry``'s graph and count the kernel launches its capture
    recorded."""
    entry.graph.replay()
    for name, n in entry.launches.items():
        _build.count_launch(name, n)


def _cached(key: tuple, build: Callable[[], Entry]) -> Entry:
    entry = _CACHE.get(key)
    if entry is None:
        entry = build()
        _CACHE[key] = entry
        while len(_CACHE) > MAX_ENTRIES:
            _, old = _CACHE.popitem(last=False)
            old.graph.reset()
    _CACHE.move_to_end(key)
    return entry


# ------------------------------------------------------------ jit_rollout
def policy_key(policy) -> Any:
    """A policy's part of a ``jit_rollout`` cache key: a tagged policy's
    ``dispatch_meta`` (the baseline and PPO policies' tags name everything
    they compute: an action, an agent, an env config), so a policy rebuilt
    from the same values replays the graph captured for the first; else
    the callable itself."""
    from mbt_gym_torch import dispatch

    meta = dispatch.policy_meta(policy)
    if meta is None:
        return policy
    key = ("dispatch_meta",) + tuple(sorted(meta.items()))
    try:
        hash(key)
    except TypeError:
        return policy
    return key


def rollout(cfg, policy, policy_params, key, backend: str = "auto", device=None):
    """:func:`mbt_gym_torch.rollout.jit_rollout`."""
    from mbt_gym_torch import dispatch
    from mbt_gym_torch.rollout import _check_backend, rollout as eager

    _check_backend(backend)
    key = int_key(key)
    device = env_lib.resolve_device(device)
    kernel = backend != "engine" and dispatch.dispatch_report(
        cfg, policy, mode="rollout", platform=device, policy_params=policy_params).backend == "fused"
    if device.type != "cuda" or kernel or backend == "fused":
        # the CPU, and the kernel families (one launch and its set-up), run
        # as rollout runs them; backend="fused" without a kernel raises there
        return eager(cfg, policy, policy_params, key, backend=backend, device=device)
    device = _cuda(device)

    def build() -> Entry:
        params = copy.deepcopy(policy_params)
        gen = torch.Generator(device=device)

        def body():
            with torch.no_grad():
                return eager(cfg, policy, params, gen, backend="engine", device=device)

        # a policy's own CUDA generators (random_policy's) are registered
        # too: each replay then advances them as an eager call does
        graph, outputs, launches, seconds, pool = capture(device, body, lambda: (gen, *(
            g for g in getattr(policy, "generators", tuple)() if g.device.type == "cuda")))
        # the captured policy stays alive with its graph: the tensors it
        # holds (a CJ agent's depth table) are read by address
        return Entry(graph, (params, policy), outputs, (gen,), launches, seconds, pool)

    entry = _cached(("jit_rollout", cfg, policy_key(policy), signature(policy_params), device), build)
    copy_into(tensors(entry.inputs[0]), tensors(policy_params))
    entry.generators[0].manual_seed(key)
    replay(entry)
    return fresh(entry.outputs, entry.generators)


# ------------------------------------------------------------ PPO
def _adam_signature(opt: torch.optim.Optimizer) -> tuple:
    """The optimizer's type and hyperparameters (its captured step bakes
    them in); ``capturable`` aside, which every captured Adam is."""
    return (type(opt).__name__,) + tuple(
        tuple((k, v) for k, v in sorted(g.items()) if k not in ("params", "capturable"))
        for g in opt.param_groups)


def _capturable_copy(train_state):
    """A deep copy of a PPO train state whose Adam steps on the device
    (``capturable=True``), the step counters moved there."""
    ts = copy.deepcopy(train_state)
    for group in ts.opt_state.param_groups:
        group["capturable"] = True
        for p in group["params"]:
            state = ts.opt_state.state.get(p)
            if state and "step" in state:
                state["step"] = state["step"].to(device=p.device, dtype=torch.float32)
    return ts


@span("mbt.learner.load_state")
def _load_train_state(static, train_state) -> None:
    """Copy ``train_state``'s parameters and Adam state into ``static``'s;
    a parameter Adam has not stepped yet loads step 0 and zero moments."""
    copy_into(list(static.params.parameters()), list(train_state.params.parameters()))
    dst, src, zero = [], [], []
    for sp, cp in zip(static.params.parameters(), train_state.params.parameters()):
        have = train_state.opt_state.state.get(cp, {})
        for name, value in static.opt_state.state[sp].items():
            if name in have:
                dst.append(value)
                src.append(have[name])
            else:
                zero.append(value)
    with torch.no_grad():
        for d, s in zip(dst, src):
            d.copy_(s)
        if zero:
            torch._foreach_zero_(zero)


class _Iteration(NamedTuple):
    """The static state of a captured PPO iteration: the train state the
    graph updates in place, K3's output buffers (or None), the learner's
    config and this process's env config."""

    ts: Any
    k3_outputs: Optional[tuple]
    ppo_cfg: Any
    local_cfg: Any


@span("mbt.learner.seed")
def _seed_learner(ppo, it: _Iteration, entry_gens, key, mesh):
    """Seed the entry's generators for one iteration; returns
    ``(K3's key, rollout generator, shuffle generator)``."""

    def generator(seed, role):
        entry_gens[role].manual_seed(int(seed))
        return entry_gens[role]

    return ppo._learner_keys(it.ppo_cfg, key, mesh, generator)


def _n_generators(ppo, ppo_cfg, mesh) -> int:
    if ppo._fully_fused(ppo_cfg):
        return 0
    return 1 if mesh is None or mesh.data == 1 else 2


def _check_capturable_mesh(mesh) -> None:
    """A CUDA graph holds NCCL's collectives but not Gloo's, which stage
    CUDA tensors through the host: a Gloo mesh on the card raises."""
    import torch.distributed as dist

    if mesh is not None and dist.get_backend(mesh.group) != "nccl":
        raise ValueError(
            f"the compiled entry points capture a CUDA graph, which cannot hold the {dist.get_backend(mesh.group)} "
            "backend's collectives (they run on the host); on the card use an NCCL group, one card per rank, "
            "or the eager ppo.train_iteration / train_chunk")


def _iteration_entry(env_cfg, ppo_cfg, train_state, key, mesh, device) -> Entry:
    from mbt_gym_torch.agents import ppo

    mesh_key = None if mesh is None else (mesh.rank, mesh.world, mesh.data, mesh.model, id(mesh.group))

    def build() -> Entry:
        local_cfg = ppo._iteration_config(env_cfg, ppo_cfg, mesh)
        ts = _capturable_copy(train_state)
        gens = tuple(torch.Generator(device=device) for _ in range(_n_generators(ppo, ppo_cfg, mesh)))
        it = _Iteration(ts, None, ppo_cfg, local_cfg)
        k3_key, gen, shuffle_gen = _seed_learner(ppo, it, gens, key, mesh)
        if ppo_cfg.fused_rollout:
            it = it._replace(k3_outputs=ppo._k3_rollout(local_cfg, ts.params, k3_key))

        def body():
            return ppo._iteration_update(local_cfg, ppo_cfg, ts, gen, shuffle_gen, it.k3_outputs, mesh=mesh)

        graph, outputs, launches, seconds, pool = capture(device, body, lambda: gens)
        return Entry(graph, it, outputs, gens, launches, seconds, pool)

    return _cached(("jit_train_iteration", env_cfg, ppo_cfg, signature(train_state.params),
                    _adam_signature(train_state.opt_state), device, mesh_key), build)


def _run_iteration(entry: Entry, key, mesh) -> None:
    """Seed, launch K3 where the learner rolls out on it, replay."""
    from mbt_gym_torch.agents import ppo

    it = entry.inputs
    k3_key, _, _ = _seed_learner(ppo, it, entry.generators, key, mesh)
    if it.ppo_cfg.fused_rollout:
        ppo._k3_rollout(it.local_cfg, it.ts.params, k3_key, out=it.k3_outputs)
    replay(entry)


def _check_train_args(train_state, key):
    key = int_key(key)
    return key, next(train_state.params.parameters()).device


def train_iteration(env_cfg, ppo_cfg, train_state, key, mesh=None):
    """:func:`mbt_gym_torch.agents.ppo.jit_train_iteration`."""
    from mbt_gym_torch.agents import ppo

    key, device = _check_train_args(train_state, key)
    if device.type != "cuda":
        return ppo.train_iteration(env_cfg, ppo_cfg, train_state, key, mesh=mesh)
    ppo.check_fused_update(ppo._iteration_config(env_cfg, ppo_cfg, mesh), ppo_cfg, train_state.params, device)
    _check_capturable_mesh(mesh)
    device = _cuda(device)
    entry = _iteration_entry(env_cfg, ppo_cfg, train_state, key, mesh, device)
    _load_train_state(entry.inputs.ts, train_state)
    _run_iteration(entry, key, mesh)
    with span("mbt.learner.outputs"):
        ts = ppo._copy_state(entry.inputs.ts)
        outputs = fresh(entry.outputs)
    return ts._replace(update_count=train_state.update_count + 1), outputs


def train_chunk(env_cfg, ppo_cfg, train_state, key, n_iterations: int, mesh=None):
    """:func:`mbt_gym_torch.agents.ppo.jit_train_chunk`."""
    from mbt_gym_torch.agents import ppo

    key, device = _check_train_args(train_state, key)
    if device.type != "cuda":
        return ppo.train_chunk(env_cfg, ppo_cfg, train_state, key, n_iterations, mesh=mesh)
    ppo.check_fused_update(ppo._iteration_config(env_cfg, ppo_cfg, mesh), ppo_cfg, train_state.params, device)
    _check_capturable_mesh(mesh)
    device = _cuda(device)
    keys = ppo.iteration_keys(key, n_iterations)
    entry = _iteration_entry(env_cfg, ppo_cfg, train_state, keys[0], mesh, device)
    _load_train_state(entry.inputs.ts, train_state)
    stacked = {name: torch.empty((n_iterations,) + tuple(v.shape), dtype=v.dtype, device=v.device)
               for name, v in entry.outputs.items()}
    for i, k in enumerate(keys):
        _run_iteration(entry, k, mesh)
        copy_into([stacked[name][i] for name in stacked], [entry.outputs[name] for name in stacked])
    with span("mbt.learner.outputs"):
        ts = ppo._copy_state(entry.inputs.ts)
    return ts._replace(update_count=train_state.update_count + n_iterations), stacked


# ------------------------------------------------------------ REINFORCE
class _Epoch(NamedTuple):
    params: Any
    std: torch.Tensor
    lr: torch.Tensor


def train_epoch(env_cfg, rf_cfg, state, key, num_epochs: int = 1):
    """:func:`mbt_gym_torch.agents.reinforce.jit_train_epoch`."""
    from mbt_gym_torch.agents import reinforce

    key = int_key(key)
    first = next(state.params.parameters())
    if first.device.type != "cuda":
        return reinforce.train_epoch(env_cfg, rf_cfg, state, key, num_epochs)
    device = _cuda(first.device)

    def build() -> Entry:
        params = copy.deepcopy(state.params)
        ep = _Epoch(params, *(torch.zeros((), dtype=first.dtype, device=device) for _ in range(2)))
        gen = torch.Generator(device=device)

        def body():
            for p in params.parameters():
                p.grad = None
            return reinforce._epoch_update(params, env_cfg, ep.std, ep.lr, gen)

        graph, outputs, launches, seconds, pool = capture(device, body, lambda: (gen,))
        return Entry(graph, ep, outputs, (gen,), launches, seconds, pool)

    entry = _cached(("jit_train_epoch", env_cfg, rf_cfg, signature(state.params), device), build)
    ep = entry.inputs
    copy_into(list(ep.params.parameters()), list(state.params.parameters()))
    std, lr = reinforce._epoch_rates(rf_cfg, state, num_epochs)
    ep.std.fill_(std)
    ep.lr.fill_(lr)
    entry.generators[0].manual_seed(key)
    replay(entry)
    loss, mean_reward = fresh(entry.outputs)
    new_state = reinforce._state_at(rf_cfg, copy.deepcopy(ep.params), state.epoch + 1)
    return new_state, {"loss": loss, "mean_episode_reward": mean_reward}
