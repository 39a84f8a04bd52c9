"""Every configuration, check module, reference scene, traffic mix,
limits file and metric reader is found by its name; a configuration with
its own check module and reference scene, a cell, a traffic mix and a
metric added as new files (and entries in BENCHMARK.json) in a copy are
found with no edit to a file that was there; a configuration without a
check module, or whose check module or scene has no file, is refused at
load."""

import json
import os
import shutil
import sys

import pytest
import torch

from gbench import harness

ROOT = harness.ROOT


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("cell", [w["name"] for w in _bench()["workloads"]])
def test_cell_loads(cell):
    c = harness.load_cell(cell)
    assert c["config"]["scene"]["name"] == "box_medium"
    assert harness.checks_of(c).__name__ == "gbench.checks.distance"
    assert c["traffic"]["dump_every"] >= 1 and c["limits"]
    names = {m["name"] for m in c["end_to_end"]}
    assert names >= {"setup_s", "pass_s", "peak_mem_gib"}
    for m in c["end_to_end"] + c["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))


def test_unknown_cell():
    with pytest.raises(KeyError):
        harness.load_cell("no-such-cell")


def _copy(tmp_path):
    """A checkout of BENCHMARK.json and gbench/ under tmp_path, and its
    files' bytes."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "gbench"), root / "gbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    return root, {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}


# a configuration's own check module and reference scene, as new files
LATE_CHECK = """
from ..check import MISSING

TARGETS = dict(late_solve=("ops.poisson", "solve"))


def expected_calls(cell, me_calls):
    return dict(late_solve=cell["config"]["solves"])


def numbers(log, sc, cell, seed, it, light, control=None):
    outs = [o for k, _, _, o in log if k == "late_solve"]
    return dict(late_err=float(outs[0].abs().sum()) if outs else MISSING)
"""
LATE_SCENE = """
from ..scene import CONDUCTOR
from . import box_medium


def build(b, second=0.1, **kw):
    box_medium.build(b, **kw)
    mirror = b.material(CONDUCTOR, (1.0, 1.0, 1.0), eta3=(0.2, 0.92, 1.1),
                        k=(3.9, 2.45, 2.14))
    b.spheres.append(((0.7, 0.15, 0.3), second, mirror))
"""


def test_added_cell_is_found(tmp_path):
    root, before = _copy(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(
        name="gvpm-late", source="a test",
        file="gbench/configs/gvpm-late.json", reduced=[],
        why="its own check module and reference scene"))
    bench["workloads"].append(dict(
        name="vpm512-late", config="gvpm-late", traffic="late",
        chips=1, why="scales as after 100 passes"))
    bench["per_layer"].append(dict(
        name="late_metric", unit="s", better="lower",
        source="program_span", layer="light pass", moves="pass_s",
        workloads=["vpm512-late"]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    config = json.loads(
        (root / "gbench" / "configs" / "gvpm-distance-512.json").read_text())
    config.update(check="late", solves=1,
                  scene=dict(name="box_late", width=8, height=8, second=0.12))
    (root / "gbench" / "configs" / "gvpm-late.json").write_text(
        json.dumps(config))
    (root / "gbench" / "checks" / "late.py").write_text(LATE_CHECK)
    (root / "gbench" / "reference" / "scenes" / "box_late.py").write_text(
        LATE_SCENE)
    (root / "gbench" / "traffic" / "late.json").write_text(json.dumps(dict(
        use_manifold=False, me_pair_budget=4096, ranks=1, dump_every=5,
        scales=[0.21, 0.35])))
    (root / "gbench" / "limits" / "vpm512-late.json").write_text(
        json.dumps(dict(late_err=0.0)))
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
        from gvpm_tpu_torch.ops import poisson
        assert h2.ROOT == str(root)
        assert h2.metric_reader("late_metric")({}) == 42.0
        cell = h2.load_cell("vpm512-late")
        late = h2.checks_of(cell)
        assert late.__file__ == str(root / "gbench" / "checks" / "late.py")
        sc = h2.rscene.build(cell["config"]["scene"])
        assert sc["sph_radius"].tolist() == [0.2, 0.12]
        assert h2.expected_calls(cell, {}) == dict(
            light=1, camera=1, buffers=1, film=1, surface_gather=1,
            late_solve=1)
        log = []
        with h2.capture.recording(log, late.TARGETS):
            zero = torch.zeros(4, 4, 3)
            poisson.solve(zero, zero, zero, iters=2, irls_iters=1)
        assert [k for k, *_ in log] == ["late_solve"]
        assert h2.check.stage_calls(log, dict(late_solve=1)) == 0
        ok, rows = h2.check.judge(late.numbers(log, sc, cell, 7, 2, None),
                                  cell["limits"])
        assert ok and rows == [("late_err", 0.0, 0.0)]
        ok, _ = h2.check.judge(late.numbers([], sc, cell, 7, 2, None),
                               cell["limits"])
        assert not ok
    finally:
        sys.path.remove(str(root))
        for k in [m for m in sys.modules if m.startswith("gbench")]:
            sys.modules.pop(k)
        sys.modules.update(ours)    # the modules other tests hold
    changed = [p for p, b in before.items()
               if p.name != "BENCHMARK.json" and p.read_bytes() != b]
    assert changed == []


@pytest.mark.parametrize("fault,missing", [
    ("no check key", "configs/gvpm-distance-512.json"),
    ("no check module", "checks/no_such_check.py"),
    ("no reference scene", "reference/scenes/no_such_scene.py")])
def test_refused_at_load(tmp_path, fault, missing):
    root, _ = _copy(tmp_path)
    path = root / "gbench" / "configs" / "gvpm-distance-512.json"
    config = json.loads(path.read_text())
    if fault == "no check key":
        del config["check"]
    elif fault == "no check module":
        config["check"] = "no_such_check"
    else:
        config["scene"]["name"] = "no_such_scene"
    path.write_text(json.dumps(config))
    with pytest.raises((KeyError, FileNotFoundError)) as e:
        harness.load_cell("vpm512-me", root=str(root))
    assert str(root / "gbench" / missing) in str(e.value)
