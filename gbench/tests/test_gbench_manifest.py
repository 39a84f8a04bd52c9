"""BENCHMARK.json against the benchmark's contract: keys, names, units,
bounds, and every configuration, traffic mix, limits file and metric
reader found by name."""

import importlib
import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["gbench"]
    assert bench["command"][:3] == ["python3", "-m", "gbench.run"]
    assert 1 <= bench["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 65536


def test_configs(bench):
    names = [c["name"] for c in bench["configs"]]
    assert len(names) == len(set(names))
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert c["file"] == f"gbench/configs/{c['name']}.json"
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"] and cfg["assumed"]
        assert all(NAME.match(k) for k in c["reduced"])
        assert not any(k.endswith(("_dim", "_rank")) for k in c["reduced"])
        assert 1 <= len(c["source"]) <= 200 and "\n" not in c["source"]


def test_workloads(bench):
    cells = bench["workloads"]
    names = [w["name"] for w in cells]
    assert len(names) == len(set(names))
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    four = [w for w in cells if w["chips"] == 4]
    assert len(four) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        with open(os.path.join(ROOT, "gbench", "traffic",
                               w["traffic"] + ".json")) as f:
            assert json.load(f)["ranks"] == w["chips"]
        assert os.path.exists(os.path.join(ROOT, "gbench", "limits",
                                           w["name"] + ".json"))


def test_metrics(bench):
    e2e, per = bench["end_to_end"], bench["per_layer"]
    names = [m["name"] for m in e2e + per]
    assert len(names) == len(set(names))
    assert "setup_s" in names
    cells = {w["name"] for w in bench["workloads"]}
    for m in e2e:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in per:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in e2e}
        assert set(m.get("workloads", cells)) <= cells
        layers.setdefault(m["layer"], m["layer"])
    for m in e2e + per:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        # every metric has its reader
        assert callable(importlib.import_module(
            f"gbench.metrics.{m['name']}").read)
    for c in cells:    # every cell: setup_s, another end-to-end, a layer
        assert any(c in m.get("workloads", cells) for m in per)
        assert sum(c in m.get("workloads", cells) for m in e2e) >= 2
    for m in per:      # each per-layer cell reports what the metric moves
        moved = next(e for e in e2e if e["name"] == m["moves"])
        assert set(m.get("workloads", cells)) <= set(
            moved.get("workloads", cells))
