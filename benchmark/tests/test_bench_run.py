"""The command's own behaviour: no card, no result; a checkout that holds
only the benchmark, no result; a cell, a configuration, a traffic mix and
a per-layer metric added as new files are found without an edit; nothing
of JAX or the JAX package is loaded."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
RUN = ["benchmark/run.py", "--workload", "as_mc_stats", "--seed", "3000000001", "--seconds", "1", "--trace", "0"]


def _has_card() -> bool:
    import torch

    return torch.cuda.is_available()


def test_no_card_no_result():
    if _has_card():
        pytest.skip("this host has a card")
    proc = subprocess.run([sys.executable, *RUN], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_only_the_benchmark_no_result(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    env = dict(os.environ, PYTHONPATH="")
    proc = subprocess.run([sys.executable, *RUN], cwd=tmp_path, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


_DROPPED_IN = r'''
import json, sys
sys.path.insert(0, sys.argv[1])
sys.path.insert(1, sys.argv[2])
sys.path[0:0] = sys.argv[3:]  # a stub package stands before the installed ones
from mbt_gym_torch import dispatch
real = dispatch.dispatch_report
dispatch.dispatch_report = lambda cfg, policy, mode="rollout", platform=None, policy_params=None: real(
    cfg, policy, mode, "cuda", policy_params)
from benchmark import harness
assert harness.__file__.startswith(sys.argv[1])
r = harness.run_cell("dummy_cell", 5, 0.2, True, device="cpu")
print(json.dumps(r))
'''


def _drop_in(tmp_path, metric_source="def read(ctx):\n    return ctx.window_s\n", reference=None):
    """A copy of the benchmark with a cell, a configuration, a traffic mix,
    limits and a per-layer metric added as new files; ``reference`` names a
    plain reference module the configuration's agent takes instead of its
    own.  Returns the bytes of every file the copy had before."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    bench = tmp_path / "benchmark"
    cfg = json.loads((bench / "configs" / "as_mm.json").read_text())
    cfg = dict(cfg, name="dummy_cfg")
    if reference is not None:
        cfg["closed_form_agent"] = dict(cfg["closed_form_agent"], reference=reference)
    (bench / "configs" / "dummy_cfg.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "dummy_mc.json").write_text(json.dumps(
        {"loop": "mc_stats", "envs": 128, "episodes": 1, "risk_aversions": [0.1], "checked": 1}))
    (bench / "limits" / "dummy_cell.json").write_text(json.dumps({"numbers": {"stats_gap": {"limit": 1e-3}}}))
    (bench / "metrics" / "dummy_metric.py").write_text(metric_source)
    man["configs"].append({"name": "dummy_cfg", "source": "https://example.org", "file": "benchmark/configs/dummy_cfg.json",
                           "reduced": [], "why": "a dropped-in configuration"})
    man["workloads"].append({"name": "dummy_cell", "config": "dummy_cfg", "traffic": "dummy_mc", "chips": 1,
                             "why": "a dropped-in cell"})
    man["per_layer"].append({"name": "dummy_metric", "unit": "s", "better": "lower", "source": "host_clock",
                             "layer": "entry points", "moves": "sim_call_ms_p95", "workloads": ["dummy_cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    return before


def _run_dropped_in(tmp_path, *extra_path):
    return subprocess.run([sys.executable, "-c", _DROPPED_IN, str(tmp_path), str(ROOT), *map(str, extra_path)],
                          cwd=tmp_path, capture_output=True, text=True, timeout=600)


def test_dropped_in_files_are_found(tmp_path):
    before = _drop_in(tmp_path)
    proc = _run_dropped_in(tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "dummy_metric" in result["metrics"] and result["correct"] is True
    assert all(p.read_bytes() == b for p, b in before.items())  # nothing that was there changed


@pytest.mark.parametrize("where", ["metric_reader", "reference"])
def test_jax_loaded_after_the_window_refuses_the_run(tmp_path, where):
    """A module named ``jax`` (a stub here) that a per-layer reader or the
    plain reference loads after the window still stops the run before it
    prints a result."""
    stub = tmp_path / "stub"
    (stub / "jax").mkdir(parents=True)
    (stub / "jax" / "__init__.py").write_text("")
    if where == "metric_reader":
        _drop_in(tmp_path, metric_source="import jax\n\n\ndef read(ctx):\n    return ctx.window_s\n")
    else:
        _drop_in(tmp_path, reference="dummy_ref")
        (tmp_path / "benchmark" / "reference" / "dummy_ref.py").write_text(
            "import jax  # noqa: F401\n\nfrom benchmark.reference.as_closed_form import *  # noqa: F401,F403\n")
    proc = _run_dropped_in(tmp_path, stub)
    assert proc.returncode != 0 and proc.stdout.strip() == "", proc.stdout[-2000:]
    assert "modules of JAX or the JAX package are loaded: ['jax']" in proc.stderr, proc.stderr[-3000:]


_IMPORTS = r'''
import sys
sys.path.insert(0, sys.argv[1])
import torch
from mbt_gym_torch import dispatch
real = dispatch.dispatch_report
dispatch.dispatch_report = lambda cfg, policy, mode="rollout", platform=None, policy_params=None: real(
    cfg, policy, mode, "cuda", policy_params)
from benchmark import harness, loops
man = harness.manifest()
for cell in man["workloads"]:
    config = harness.load_json(harness.HERE / "configs" / f"{cell['config']}.json")
    traffic = dict(harness.load_json(harness.HERE / "traffic" / f"{cell['traffic']}.json"), envs=64)
    loop = loops.loop_class(traffic["loop"])(config, traffic, 1, torch.device("cpu"))
    loop.setup()
    loop.call()
    ctx = harness.Context(loop, 1.0, [1.0], None)
    for m in man["per_layer"]:
        harness.reader(m["name"])(ctx)
    loop.free()
    loop.check()
print(harness.forbidden_modules())
'''


def test_nothing_of_jax_is_loaded():
    proc = subprocess.run([sys.executable, "-c", _IMPORTS, str(ROOT)], cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
