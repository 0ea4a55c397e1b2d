"""One run of one cell: set-up, the measured window, the traced sub-window,
the check against the plain reference, and the result line.

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``, its configuration in ``configs/<config>.json``, its
traffic in ``traffic/<traffic>.json``, the limits of its check in
``limits/<cell>.json`` and each per-layer metric's reader in
``metrics/<metric>.py``.  A later cell, configuration or metric is a new
file and a new entry; no file here changes for it.
"""
from __future__ import annotations

import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import torch

from benchmark import loops
from benchmark.yardstick import compare, trace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mbt_gym_tpu")
TRACE_SECONDS = 2.0  # the traced sub-window's length, in calls of the window's mean length
TRACE_CALLS = (3, 200)
OUT_DIR = ROOT / "bench_out"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_of(manifest_: dict, name: str) -> dict:
    for cell in manifest_["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")


def forbidden_modules() -> list:
    """The modules loaded in this process whose top-level name is JAX's,
    its libraries' or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN})


def reader(metric: str):
    """The ``read(ctx)`` of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unread"
    except (OSError, subprocess.TimeoutExpired):
        return "unread"


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


class Context:
    """What a per-layer metric's reader reads: the loop (its kind, the
    kernels a call moves through and their bounds, a call's FLOPs), the
    window's host-clock times and the traced sub-window's summary."""

    def __init__(self, loop: loops.Loop, window_s: float, call_s: list, summary: Optional[trace.Summary]):
        self.loop, self.window_s, self.call_s, self.trace = loop, window_s, call_s, summary
        self.kind = loop.kind

    def kernel_roofline(self, counter: str) -> Optional[float]:
        """The kernel's bound over its device time a launch, in %: the time
        of the traced device records whose names the loop gives, over the
        launches the program's counter saw.  Where the profiler kept fewer
        records of the kernel's launch (the names that each launch runs
        once or more) than the counter has launches, it says so and divides
        by the records it kept."""
        spec = self.loop.kernels.get(counter)
        if self.trace is None or spec is None:
            return None
        bound, by = spec["bound"]
        launches = self.trace.launches.get(counter, 0)
        records = {n: sc for n, sc in self.trace.by_name.items() if any(k in n for k in spec["names"])}
        kept = sum(c for n, (_, c) in records.items() if any(k in n for k in spec["each_launch"]))
        if not records or not launches:
            log(f"trace: no device record of {counter} ({launches} launches counted)")
            return None
        used = launches
        if kept < launches:
            log(f"trace: the profiler kept {kept} records of {counter} against {launches} launches counted; "
                f"the time a launch divides by {kept}")
            used = kept
        per_launch = sum(s for s, _ in records.values()) / used
        log(f"trace: {counter} {per_launch * 1e3:.4f} ms a launch over {used} launches, bound "
            f"{bound * 1e3:.5f} ms ({by})")
        return 100.0 * bound / per_launch

    def idle_pct(self) -> Optional[float]:
        if self.trace is None:
            return None
        return 100.0 * (1.0 - self.trace.busy_s / self.trace.window_s)


def run_cell(workload: str, seed: int, seconds: float, trace_on: bool, device=None, overrides: Optional[dict] = None,
             t_start: Optional[float] = None) -> dict:
    """One run of ``workload``; returns the result line's object.  The CLI
    passes a card; a test may pass ``device="cpu"`` and ``overrides`` of the
    traffic's sizes, which only this function's callers in the tests do."""
    t_start = time.perf_counter() if t_start is None else t_start
    man = manifest()
    cell = cell_of(man, workload)
    config = load_json(HERE / "configs" / f"{cell['config']}.json")
    traffic = dict(load_json(HERE / "traffic" / f"{cell['traffic']}.json"), **(overrides or {}))
    path = HERE / "limits" / f"{workload}.json"
    limits = load_json(path)["numbers"] if path.exists() else {}
    device = torch.device(device or "cuda:0")
    on_card = device.type == "cuda"
    if on_card:
        log(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    loop = loops.loop_class(traffic["loop"])(config, traffic, seed, device)

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    loop.setup()
    sync()
    setup_s = time.perf_counter() - t_start
    log(f"set-up: {setup_s:.2f} s")
    from mbt_gym_torch.ops import _build

    call_s = []
    t0 = time.perf_counter()
    while True:
        c0 = time.perf_counter()
        loop.call()
        c1 = time.perf_counter()
        call_s.append(c1 - c0)
        if c1 - t0 >= seconds:
            break
    window_s = c1 - t0
    attempted, failed = len(call_s), loop.failed
    q = statistics.quantiles(call_s, n=100, method="inclusive") if attempted > 1 else call_s * 99
    log(f"window: {attempted} calls in {window_s:.3f} s; call ms median {q[49] * 1e3:.3f}, p90 {q[89] * 1e3:.3f}, "
        f"p95 {q[94] * 1e3:.3f}, p99 {q[98] * 1e3:.3f}, max {max(call_s) * 1e3:.3f}")
    summary = None
    if trace_on:
        n = max(TRACE_CALLS[0], min(TRACE_CALLS[1], math.ceil(TRACE_SECONDS / (window_s / attempted))))
        OUT_DIR.mkdir(exist_ok=True)
        chrome = OUT_DIR / f"{workload}.trace.json"
        summary = trace.trace_calls(loop.call, n, _build.launch_counts, sync, str(chrome) if on_card else None)
        log(f"trace: {n} calls traced after one thrown away; Chrome trace {chrome if on_card else '(none)'}; "
            f"launches counted {summary.launches if summary else {}}")
        if summary is None:
            log("trace: the profiler saw no device work")
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    e2e = dict(loop.end_to_end(window_s, call_s), setup_s={"value": setup_s, "unit": "s"})
    metrics = {}
    if trace_on:
        ctx = Context(loop, window_s, call_s, summary)
        for m in man["per_layer"]:
            if "workloads" in m and workload not in m["workloads"]:
                continue
            value = reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        wanted = {m["name"] for m in man["end_to_end"] if "workloads" not in m or workload in m["workloads"]}
        metrics = {k: v for k, v in e2e.items() if k in wanted}
    loop.free()
    t_check = time.perf_counter()
    numbers = loop.check()
    log(f"check: the reference took {time.perf_counter() - t_check:.1f} s")
    correct, checked = compare.judge(numbers, limits)
    correct = correct and failed == 0
    # last of all that loads code (the readers, the reference), so that what
    # any of it loads is seen before a result is printed
    found = forbidden_modules()
    if found:
        log(f"modules of JAX or the JAX package are loaded: {found}")
        raise SystemExit(4)
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                   "count": 1, "memory_peak_bytes": peak}
    if trace_on and summary is not None:
        device_info.update(busy_s=summary.busy_s, window_s=summary.window_s)
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics, "device": device_info}
    if trace_on and summary is not None:
        result["breakdown"] = {"device_ops": [[n, s] for n, s in summary.device_ops[:10]],
                               "idle_gaps": [[n, s] for n, s in summary.idle_by_host[:10]]}
    result["checked"] = checked
    for name, c in checked.items():
        log(f"checked {name} {c['value']} limit {c['limit']}")
    return result


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="One run of one benchmark cell on the card.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cell = cell_of(manifest(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        log(f"this run needs {cell['chips']} CUDA card(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 3
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_start=t_start)
    print(json.dumps(result), flush=True)
    return 0
