"""BENCHMARK.json against the shape its readers expect: names, units and lines of
the allowed characters, every cell's pieces found by name."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def line_ok(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(MANIFEST) == KEYS
    assert MANIFEST["command"] == ["python3", "benchmark/run.py"]
    assert MANIFEST["paths"] == ["benchmark"]
    assert 1 <= MANIFEST["run_seconds"] <= 51 and isinstance(MANIFEST["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_unique_and_allowed(section):
    names = [e["name"] for e in MANIFEST[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names), names


def test_configs():
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line_ok(c["source"]) and line_ok(c["why"]) and c["source"].startswith("https://")
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"] == []
        assert any(w["config"] == c["name"] for w in MANIFEST["workloads"])


def test_workloads():
    configs = {c["name"] for c in MANIFEST["configs"]}
    pairs = set()
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4) and line_ok(w["why"])
        assert NAME.match(w["traffic"])
        assert (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "benchmark" / "limits" / f"{w['name']}.json").is_file()
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(MANIFEST["workloads"])


def test_metrics():
    cells = {w["name"] for w in MANIFEST["workloads"]}
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and line_ok(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for cell in cells:  # setup_s, another end-to-end metric and a per-layer one in every cell
        assert sum(cell in m.get("workloads", cells) for m in MANIFEST["end_to_end"]) >= 2
        assert any(cell in m["workloads"] for m in MANIFEST["per_layer"])
