"""The per-layer metrics that read the program's own spans
(``mbt_gym_torch.utils.profiling``): on the CPU at a tiny size, through
``run_cell`` with a traced window, each reads a number in its own cells
and None in the others.  On the CPU no CUDA graph is captured, so
``capture_s`` reads None there until a capture span is recorded; a
program without spans reads None everywhere."""
import types

import pytest
import torch

from benchmark import harness, loops

from test_bench_faults import TINY

SPAN_METRICS = ("eval_host_ms", "sim_host_ms", "train_host_ms", "capture_s")


def _cells_of(metric: str) -> list:
    return next(m["workloads"] for m in harness.manifest()["per_layer"] if m["name"] == metric)


@pytest.mark.parametrize("workload", list(TINY))
def test_span_readers_read_their_own_cells(workload, cpu_kernels):
    from mbt_gym_torch.utils import profiling

    torch.set_num_threads(4)
    profiling.reset_spans()
    result = harness.run_cell(workload, 3000000001, 0.2, True, device="cpu", overrides={"envs": TINY[workload]})
    own = {m for m in SPAN_METRICS if workload in _cells_of(m)}
    on_cpu = own - {"capture_s"}
    assert on_cpu and {m for m in SPAN_METRICS if m in result["metrics"]} == on_cpu
    assert all(result["metrics"][m]["value"] > 0 for m in on_cpu)
    cell = harness.cell_of(harness.manifest(), workload)
    ctx = types.SimpleNamespace(kind=loops.loop_class(harness.load_json(
        harness.HERE / "traffic" / f"{cell['traffic']}.json")["loop"]).kind)
    for metric in SPAN_METRICS:
        assert (harness.reader(metric)(ctx) is not None) == (metric in on_cpu), metric
    with profiling.span("mbt.graph.capture", always=True):  # a capture, as the card makes at set-up
        pass
    capture = harness.reader("capture_s")(ctx)
    assert (capture is not None) == ("capture_s" in own)
    profiling.reset_spans()
    assert all(harness.reader(metric)(ctx) is None for metric in SPAN_METRICS)


def test_span_readers_read_none_without_spans(monkeypatch):
    """A program whose ``profiling`` has no spans (the commit before them)
    gives every span reader None, and none raises."""
    from mbt_gym_torch.utils import profiling

    for name in ("spans", "host_seconds"):
        monkeypatch.delattr(profiling, name)
    for kind in ("train", "mc_stats", "evaluate"):
        ctx = types.SimpleNamespace(kind=kind)
        assert all(harness.reader(metric)(ctx) is None for metric in SPAN_METRICS)
