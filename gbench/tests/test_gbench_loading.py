"""Every configuration, traffic mix, limits file and metric reader is
found by its name; a cell, a traffic mix and a metric added as new files
(and entries in BENCHMARK.json) in a copy are found with no edit to a
file that was there."""

import json
import os
import shutil
import sys

import pytest

from gbench import harness

ROOT = harness.ROOT


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("cell", [w["name"] for w in _bench()["workloads"]])
def test_cell_loads(cell):
    c = harness.load_cell(cell)
    assert c["config"]["scene"]["name"] == "box_medium"
    assert c["traffic"]["dump_every"] >= 1 and c["limits"]
    names = {m["name"] for m in c["end_to_end"]}
    assert names >= {"setup_s", "pass_s", "peak_mem_gib"}
    for m in c["end_to_end"] + c["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))


def test_unknown_cell():
    with pytest.raises(KeyError):
        harness.load_cell("no-such-cell")


def test_added_cell_is_found(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "gbench"), root / "gbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append(dict(
        name="vpm512-late", config="gvpm-distance-512", traffic="late",
        chips=1, why="scales as after 100 passes"))
    bench["per_layer"].append(dict(
        name="late_metric", unit="s", better="lower",
        source="program_span", layer="light pass", moves="pass_s",
        workloads=["vpm512-late"]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "gbench" / "traffic" / "late.json").write_text(json.dumps(dict(
        use_manifold=False, me_pair_budget=4096, ranks=1, dump_every=5,
        scales=[0.21, 0.35])))
    (root / "gbench" / "limits" / "vpm512-late.json").write_text(
        json.dumps(dict(gather_err=1e-5)))
    (root / "gbench" / "metrics" / "late_metric.py").write_text(
        "def read(rec):\n    return 42.0\n")
    cell = harness.load_cell("vpm512-late", root=str(root))
    assert cell["traffic"]["scales"] == [0.21, 0.35]
    assert [m["name"] for m in cell["per_layer"]] == ["late_metric"]
    sys.path.insert(0, str(root))
    ours = {k: m for k, m in sys.modules.items() if k.startswith("gbench")}
    try:
        for k in ours:
            sys.modules.pop(k)
        import gbench.harness as h2
        assert h2.ROOT == str(root)
        assert h2.metric_reader("late_metric")({}) == 42.0
    finally:
        sys.path.remove(str(root))
        for k in [m for m in sys.modules if m.startswith("gbench")]:
            sys.modules.pop(k)
        sys.modules.update(ours)    # the modules other tests hold
    changed = [p for p, b in before.items()
               if p.name != "BENCHMARK.json" and p.read_bytes() != b]
    assert changed == []
