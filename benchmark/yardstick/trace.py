"""The reading of a traced sub-window: ``torch.profiler`` over a few calls
of the cell's timed path, after one traced call that is thrown away.

From the device's events it takes the time each kernel ran, by name; the
union of the events' intervals, which counts no time twice (the busy
time); the idle gaps between one call's last device operation and the
next call's first; and, for each idle stretch, what the host was doing
then, named by the innermost host event that spans its middle.  The
profiler's own step annotations, which it mirrors onto the device's
timeline, are not device work.  Each call runs inside a host annotation
named :data:`CALL`, on the same clock as the device's events.
"""
from __future__ import annotations

import bisect
from typing import Callable, Dict, List, NamedTuple, Optional

CALL = "bench.call"
BETWEEN_OPS = "(host, between ops)"


def union_seconds(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals in microseconds,
    returned in seconds."""
    busy, end = 0.0, float("-inf")
    for start, stop in sorted(intervals):
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    return busy / 1e6


def idle_stretches(intervals, start: float, stop: float) -> List[tuple]:
    """The stretches of ``[start, stop]`` (microseconds) that no interval
    covers."""
    out, cursor = [], start
    for a, b in sorted(intervals):
        if a > cursor:
            out.append((cursor, min(a, stop)))
        cursor = max(cursor, b)
        if cursor >= stop:
            break
    if cursor < stop:
        out.append((cursor, stop))
    return [(a, b) for a, b in out if b > a]


class Summary(NamedTuple):
    by_name: Dict[str, tuple]  # device kernel name -> (seconds, records)
    busy_s: float
    window_s: float
    call_gaps_s: List[float]  # device idle from one call's last op to the next call's first
    idle_by_host: List[tuple]  # [(host event name, idle seconds)], longest first
    device_ops: List[tuple]  # [(device op name, seconds)], longest first
    launches: Dict[str, int]  # the program's launch counters over the traced calls


def _innermost(host: List[tuple], points: List[float]) -> List[str]:
    """For each of the sorted ``points``, the name of the shortest host
    event that spans it (host events of one thread nest, so the one that
    started last among those still open), or :data:`BETWEEN_OPS`."""
    order = sorted(host)
    names, stack, i = [], [], 0
    for p in points:
        while i < len(order) and order[i][0][0] <= p:
            stack.append(order[i])
            i += 1
        open_ = [e for e in stack if e[0][1] >= p]
        stack = open_
        names.append(min(open_, key=lambda e: e[0][1] - e[0][0])[1] if open_ else BETWEEN_OPS)
    return names


def summarise(events, launches: Dict[str, int]) -> Optional[Summary]:
    """The :class:`Summary` of a profiler's events, or None where it saw no
    device work."""
    from torch.autograd import DeviceType

    device, host, calls = [], [], []
    for e in events:
        span = (e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            if not e.is_user_annotation and not e.name.startswith("ProfilerStep"):
                device.append((span, e.name))
        elif e.name == CALL:
            calls.append(span)
        elif not e.name.startswith("ProfilerStep"):
            host.append((span, e.name))
    if not device or not calls:
        return None
    calls.sort()
    start, stop = calls[0][0], calls[-1][1]
    device = [((max(a, start), min(b, stop)), name) for (a, b), name in device if b > start and a < stop]
    intervals = sorted(span for span, _ in device)
    by_name: Dict[str, list] = {}
    for (a, b), name in device:
        entry = by_name.setdefault(name, [0.0, 0])
        entry[0] += (b - a) / 1e6
        entry[1] += 1
    starts = [a for a, _ in intervals]
    firsts_lasts = []
    for a, b in calls:
        inside = intervals[bisect.bisect_left(starts, a):bisect.bisect_right(starts, b)]
        inside = [span for span in inside if span[1] <= b]
        if inside:
            firsts_lasts.append((min(s for s, _ in inside), max(e for _, e in inside)))
    gaps = [max(0.0, first - last) / 1e6 for (_, last), (first, _) in zip(firsts_lasts, firsts_lasts[1:])]
    stretches = idle_stretches(intervals, start, stop)
    idle: Dict[str, float] = {}
    for (a, b), name in zip(stretches, _innermost(host, [0.5 * (a + b) for a, b in stretches])):
        idle[name] = idle.get(name, 0.0) + (b - a) / 1e6
    ops = sorted(((v[0], k) for k, v in by_name.items()), reverse=True)
    return Summary(
        by_name={k: (v[0], v[1]) for k, v in by_name.items()},
        busy_s=union_seconds(intervals),
        window_s=(stop - start) / 1e6,
        call_gaps_s=gaps,
        idle_by_host=sorted(idle.items(), key=lambda kv: -kv[1]),
        device_ops=[(name, s) for s, name in ops],
        launches=dict(launches),
    )


def trace_calls(call: Callable[[], None], n_calls: int, launch_counts: Dict[str, int], sync: Callable[[], None],
                chrome_path: Optional[str] = None) -> Optional[Summary]:
    """Trace ``n_calls`` calls of ``call`` in one profiler step, after one
    traced call that is thrown away (the warm-up step of the profiler's
    schedule); the program's launch counters are read over the kept calls.
    ``chrome_path``, where given, receives the kept calls' Chrome trace."""
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    kept = []

    def ready(prof):
        kept.extend(prof.events())
        if chrome_path:
            prof.export_chrome_trace(chrome_path)

    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1), on_trace_ready=ready) as prof:
        with record_function(CALL):
            call()
        sync()
        prof.step()
        before = dict(launch_counts)
        for _ in range(n_calls):
            with record_function(CALL):
                call()
        prof.step()
    launches = {k: v - before.get(k, 0) for k, v in launch_counts.items() if v - before.get(k, 0)}
    return summarise(kept, launches)
