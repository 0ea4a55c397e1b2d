"""The yardstick: the bounds of the kernels at the main paths' shapes, as
PERF.md's kernel table gives them, and the readings of a window."""
import statistics

import pytest

from benchmark import loops
from benchmark.yardstick import roofline, trace


@pytest.mark.parametrize("what, bound_ms, by", [
    ("k4_config5", 1.332, "operations"),  # 3,276,800 samples, 256x256 shared, S 4, A 2
    ("k3_config5", 7.138, "operations"),  # 262,144 x 200
    ("k3_canonical_towers", 7.125, "operations"),  # 262,144 x 100, towers, A 4
    ("k1_16k", 0.01257, "operations"),  # 16,384 x 200
])
def test_bounds(what, bound_ms, by):
    s, got_by = {
        "k4_config5": lambda: roofline.k4_bound(3_276_800, 4, (256, 256), 2, 1),
        "k3_config5": lambda: roofline.k3_bound(262_144 * 200, 4, (256, 256), 2, 1),
        "k3_canonical_towers": lambda: roofline.k3_bound(262_144 * 100, 4, (256, 256), 4, 2),
        "k1_16k": lambda: roofline.k1_bound(16_384, 200),
    }[what]()
    assert s * 1e3 == pytest.approx(bound_ms, rel=5e-4)
    assert got_by == by


def test_k4_flops_per_sample():
    assert roofline.ppo_grad_flops(4, (256, 256), 2, 1) == 401_920


def test_union_counts_no_time_twice():
    assert trace.union_seconds([(0, 10), (5, 15), (20, 30)]) == pytest.approx(25e-6)
    assert trace.idle_stretches([(0, 10), (5, 15), (20, 30)], 0, 40) == [(15, 20), (30, 40)]


class _Range:
    def __init__(self, start, end):
        self.start, self.end = start, end


class _Event:
    def __init__(self, name, start, end, cuda):
        from torch.autograd import DeviceType

        self.name, self.time_range = name, _Range(start, end)
        self.device_type = DeviceType.CUDA if cuda else DeviceType.CPU
        self.is_user_annotation = False


def _window(stall_us: float):
    """Ten calls of 100 us of device work after 10 us of host work each;
    the sixth call's host work stalls for ``stall_us`` more."""
    events, t = [], 0.0
    for i in range(10):
        host = 10.0 + (stall_us if i == 5 else 0.0)
        events.append(_Event(trace.CALL, t, t + host + 100.0, False))
        events.append(_Event("host_work", t, t + host, False))
        events.append(_Event("kernel", t + host, t + host + 100.0, True))
        t += host + 100.0
    return trace.summarise(events, {"k": 10})


def test_idle_share_and_gaps_move_with_a_stall():
    calm, stalled = _window(0.0), _window(500.0)
    assert calm.busy_s == stalled.busy_s == pytest.approx(1e-3)
    assert 1 - stalled.busy_s / stalled.window_s > 1 - calm.busy_s / calm.window_s
    assert max(stalled.call_gaps_s) == pytest.approx(510e-6)
    assert statistics.median(stalled.call_gaps_s) == pytest.approx(10e-6)
    assert stalled.idle_by_host[0][0] == "host_work"


def test_p95_of_all_calls_moves_with_a_stall():
    calls = [0.010] * 400
    stalled = calls[:380] + [0.050] * 20
    assert loops.p95(calls) == pytest.approx(0.010)
    assert loops.p95(stalled) > 0.010
