"""Tracing and profiling (counterpart of ``mbt_gym_tpu/utils/profiling.py``;
the reference has no tracing of its own).

Spans live here; the kernels' launch counters live in
:mod:`mbt_gym_torch.ops._build` (``launch_counts``).

- :class:`span` — a named host span, as a context manager or a decorator.
  The port opens them at its layer boundaries (entry points, the dispatch,
  the free-memory query, the learner's phases, the kernel wrappers), every
  name prefixed ``mbt.``; ``mbt.sync.*`` marks a place where the host
  blocks on the device.  Tracing is on while a ``torch.profiler`` records
  or inside :func:`recording`; off, a span is one flag check.  On, a span
  appends a :class:`SpanRecord` to a bounded in-memory buffer
  (:data:`MAX_SPANS`), and under the profiler it also enters
  ``torch.profiler.record_function``, so the span is a host event on the
  clock of the trace's device records.  A span made with ``always=True``
  records whether tracing is on or not: the graph capture
  (``mbt.graph.capture``) and a kernel build (``mbt.build``), each once
  per process.
- :func:`recording`, :func:`spans`, :func:`reset_spans` — turn in-memory
  recording on without the profiler; read and clear the records.
- :func:`host_seconds` — a span's host time: its duration less what its
  ``mbt.sync.*`` descendants cover.
- :func:`trace` — a context manager around ``torch.profiler.profile`` (CPU
  and, where a GPU is visible, CUDA activity) that writes a Chrome trace
  into ``log_dir`` (``trace_<ms since epoch>.pt.trace.json``).
- :func:`scaling_report` — env-steps/s across data-parallel widths of a
  process group, envs per rank held fixed, with the efficiency against the
  first width.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import os
import threading
import time
from typing import TYPE_CHECKING, Callable, Dict, Iterable, List, NamedTuple, Optional

import torch

if TYPE_CHECKING:
    from mbt_gym_torch.env import EnvConfig

MAX_SPANS = 50_000
SYNC_PREFIX = "mbt.sync."

_profiler_enabled = torch._C._autograd._profiler_enabled


class SpanRecord(NamedTuple):
    """One closed span: its name, its ``time.perf_counter_ns`` start and
    end, its id, its parent's id (0 for a root) and the id of the root it
    runs under (its own for a root): every span of one entry-point call
    shares that call id."""

    name: str
    start_ns: int
    end_ns: int
    span_id: int
    parent_id: int
    call_id: int

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


_records: "collections.deque[SpanRecord]" = collections.deque(maxlen=MAX_SPANS)
_ids = itertools.count(1)
_local = threading.local()  # each thread's stack of open spans
_lock = threading.Lock()
_recording = 0  # how many recording() blocks are open


class span:
    """A host span named ``name``: ``with span(name):`` or ``@span(name)``.
    Off (no profiler recording, no :func:`recording` block open, not
    ``always``) it costs one flag check.  On, it records a
    :class:`SpanRecord` when it closes (:attr:`record`), and under the
    profiler it is also a ``record_function`` host event."""

    __slots__ = ("name", "always", "record", "_frame", "_start", "_rf")

    def __init__(self, name: str, always: bool = False):
        self.name, self.always = name, always
        self.record: Optional[SpanRecord] = None
        self._frame = None

    def __enter__(self) -> "span":
        if not (self.always or _recording or _profiler_enabled()):
            return self
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        span_id = next(_ids)
        parent_id, call_id = (stack[-1][0], stack[-1][1]) if stack else (0, span_id)
        self._frame = (span_id, call_id, parent_id)
        stack.append(self._frame)
        self._rf = None
        if _profiler_enabled():
            self._rf = torch.autograd.profiler.record_function(self.name)
            self._rf.__enter__()
        self._start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        frame = self._frame
        if frame is None:
            return False
        end = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        _local.stack.pop()  # spans of one thread close in the order they opened
        span_id, call_id, parent_id = frame
        self.record = SpanRecord(self.name, self._start, end, span_id, parent_id, call_id)
        _records.append(self.record)
        self._frame = None
        return False

    def __call__(self, fn: Callable) -> Callable:
        name, always = self.name, self.always

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if not (always or _recording or _profiler_enabled()):
                return fn(*args, **kwargs)
            with span(name, always):
                return fn(*args, **kwargs)

        return spanned


@contextlib.contextmanager
def recording():
    """Record spans in memory inside the block, without a profiler (read
    them with :func:`spans`)."""
    global _recording
    with _lock:
        _recording += 1
    try:
        yield
    finally:
        with _lock:
            _recording -= 1


def spans() -> List[SpanRecord]:
    """The records in the buffer, in the order their spans closed (a
    child before its parent); the oldest go once :data:`MAX_SPANS` are
    held."""
    return list(_records)


def reset_spans() -> None:
    _records.clear()


def host_seconds(name: str, records: Optional[Iterable[SpanRecord]] = None) -> List[float]:
    """For each span named ``name`` (of ``records``, default :func:`spans`),
    its host time in seconds: its duration less what its ``mbt.sync.*``
    descendants cover (a sync span inside another counts once)."""
    records = spans() if records is None else list(records)
    by_id = {r.span_id: r for r in records}
    blocked: Dict[int, int] = collections.defaultdict(int)
    for r in records:
        if not r.name.startswith(SYNC_PREFIX):
            continue
        ancestors, parent = [], by_id.get(r.parent_id)
        while parent is not None and not parent.name.startswith(SYNC_PREFIX):
            ancestors.append(parent.span_id)
            parent = by_id.get(parent.parent_id)
        if parent is None:  # not inside another sync span
            for a in ancestors:
                blocked[a] += r.end_ns - r.start_ns
    return [(r.end_ns - r.start_ns - blocked[r.span_id]) / 1e9 for r in records if r.name == name]


@contextlib.contextmanager
def trace(log_dir: str = "profiler-trace"):
    """Profile the block and write its Chrome trace into ``log_dir``
    (created if missing); yields ``log_dir``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield log_dir
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, f"trace_{int(time.time() * 1e3)}.pt.trace.json"))


def _episode_thunk(cfg: EnvConfig, policy, episodes_per_call: int, device) -> Callable[..., torch.Tensor]:
    """``many(key)`` (an int seed or a ``torch.Generator``) runs ``episodes_per_call`` engine episodes of ``cfg``
    (profiling.py:34-80): reset, the episode's noise drawn up front where
    :func:`mbt_gym_torch.rollout._should_predraw` says so, the steps, and
    the rewards summed so that their computation is part of the work; it
    returns the sum of the final cash and the rewards (a checksum)."""
    from mbt_gym_torch import env as env_lib
    from mbt_gym_torch.rollout import _episode_steps, _noise_at, _should_predraw, native_noise_cube

    n_scan = _episode_steps(cfg)
    predraw = _should_predraw(cfg, n_scan)

    @torch.no_grad()
    def many(key) -> torch.Tensor:
        gen = env_lib.make_generator(key, device)
        acc = torch.zeros((), dtype=cfg.torch_dtype, device=device)
        for _ in range(episodes_per_call):
            state, obs = env_lib.reset(cfg, gen, device=device)
            cube = native_noise_cube(cfg, state.key, n_scan) if predraw else None
            reward_acc = torch.zeros((), dtype=cfg.torch_dtype, device=device)
            for t in range(n_scan):
                action = policy(None, obs, state)
                res = env_lib.step(cfg, state, action, noise=None if cube is None else _noise_at(cube, t))
                state, obs = res.state, res.obs
                reward_acc = reward_acc + res.reward.sum()
            acc = acc + state.cash.sum() + reward_acc
        return acc

    return many


def _timed(device: torch.device, fn: Callable[[], torch.Tensor]):
    """(seconds, result) of one call: CUDA events on a card, the host clock
    on the CPU."""
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3, out
    t0 = time.perf_counter()
    out = fn()
    return time.perf_counter() - t0, out


def scaling_report(cfg: EnvConfig, policy, widths: Optional[List[int]] = None, episodes_per_call: int = 8,
                   iters: int = 3) -> List[Dict[str, float]]:
    """Env-steps/s and efficiency by data-parallel width, over the process
    group of :func:`mbt_gym_torch.parallel.mesh.init_distributed`, one
    rank per device.  Envs per rank are held at ``cfg.num_trajectories``
    (weak scaling).  At width d the first d ranks each run
    ``episodes_per_call`` engine episodes per call, each from its own
    generator (:func:`~mbt_gym_torch.parallel.mesh.fold_in`), and all-reduce their
    checksums; a call's time is the slowest rank's.  ``widths`` default to
    the powers of two up to the group's size; every rank must call this,
    and every rank gets the rows.  ``efficiency`` is the rate over (the
    first width's rate x d / that width)."""
    import torch.distributed as dist

    from mbt_gym_torch.parallel.mesh import fold_in, make_mesh
    from mbt_gym_torch.rollout import _episode_steps

    mesh = make_mesh()
    widths = widths or [d for d in (1, 2, 4, 8, 16, 32) if d <= mesh.world]
    rows = []
    base = None
    for d in widths:
        group = dist.new_group(list(range(d)))
        member = mesh.rank < d
        thunk = _episode_thunk(cfg, policy, episodes_per_call, mesh.device) if member else None

        def call(seed):
            out = thunk(fold_in(seed, mesh.rank)).reshape(1).to(torch.float64)
            dist.all_reduce(out, group=group)
            return out

        elapsed = torch.zeros(1, dtype=torch.float64, device=mesh.device)
        if member:
            call(0)  # warm-up
            for i in range(iters):
                seconds, _ = _timed(mesh.device, lambda: call(1 + i))
                elapsed += seconds / iters
        dist.all_reduce(elapsed, op=dist.ReduceOp.MAX)
        rate = d * cfg.num_trajectories * _episode_steps(cfg) * episodes_per_call / float(elapsed)
        if base is None:
            base = (rate, d)
        rows.append({"devices": d, "env_steps_per_s": rate, "efficiency": rate / (base[0] * d / base[1])})
        dist.destroy_process_group(group)
    return rows
