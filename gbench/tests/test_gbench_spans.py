"""The span table (gbench/spans.py) on synthetic kineto-like events, on a
CPU profile of the program's own ranges, and the reader of the build
counter."""

import pytest
import torch

from gbench import spans
from gbench.metrics import setup_build_s

# host ranges (us): a pass holding the light pass's two steps and an ME
# stage with its Newton part
RANGES = [("pass", 0.0, 100.0), ("light_trace", 0.0, 40.0),
          ("light_step", 0.0, 20.0), ("light_step", 20.0, 40.0),
          ("surface_me", 50.0, 90.0), ("me:newton", 55.0, 80.0)]
# launch times by correlation id
LAUNCHES = {1: 5.0, 2: 25.0, 3: 60.0, 4: 95.0, 5: 45.0}
# device activity: each kernel runs after its launch; one copy, and one
# kernel whose launch the trace does not hold
DEVICE = [("light_kernel", 10.0, 12.0, 1), ("light_kernel", 30.0, 32.0, 2),
          ("Memcpy HtoD", 46.0, 47.0, 5), ("newton_kernel", 70.0, 75.0, 3),
          ("film_kernel", 96.0, 97.0, 4), ("lost_kernel", 98.0, 99.0, 99)]


def test_kernels_go_to_the_spans_open_at_their_launch():
    rows = spans.table(RANGES, DEVICE, LAUNCHES)
    kernels = {n: r["kernels"] for n, r in rows.items()}
    # the innermost span has its own kernels and its parents hold them
    # too; the copy is left out and the kernel of no launch is outside
    assert kernels == {"pass": 4, "light_trace": 2, "light_step": 2,
                       "surface_me": 1, "me:newton": 1,
                       spans.OUTSIDE: 1}
    assert rows["me:newton"]["device_s"] == pytest.approx(5e-6)
    assert rows["light_step"]["device_s"] == pytest.approx(4e-6)
    assert rows["pass"]["device_s"] == pytest.approx(10e-6)
    # host seconds: the union of the name's ranges
    assert rows["light_step"]["host_s"] == pytest.approx(40e-6)
    assert rows["surface_me"]["host_s"] == pytest.approx(40e-6)


def test_idle_gaps_go_to_the_innermost_range_where_they_begin():
    rows = spans.table(RANGES, DEVICE, LAUNCHES)
    idle = {n: r["idle_s"] * 1e6 for n, r in rows.items() if r["idle_s"]}
    # gaps begin at 12 (step 1), 32 (step 2), 47 (the pass between its
    # stages), 75 (inside the Newton part) and 97 (the pass)
    assert idle == pytest.approx({"light_step": 18.0 + 14.0,
                                  "pass": 23.0 + 1.0, "me:newton": 21.0})
    assert spans.line(rows).startswith("spans: light_step kernels 2")


def test_a_gap_outside_every_range():
    rows = spans.table([("pass", 0.0, 10.0)],
                       [("k", 1.0, 2.0, 1), ("k", 20.0, 21.0, 2)],
                       {1: 0.5, 2: 15.0})
    assert rows[spans.OUTSIDE]["kernels"] == 1
    assert rows["pass"]["idle_s"] == pytest.approx(18e-6)


def test_events_of_a_cpu_profile():
    from gvpm_tpu_torch.core.logging import span
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU]) as prof:
        with span("pass"):
            with span("light_step"):
                torch.ones(4).sum()
    ranges, device, launches = spans.events(prof)
    assert [r[0] for r in sorted(ranges, key=lambda r: r[1])] == [
        "pass", "light_step"]
    assert device == [] and launches == {}
    rows = spans.table(ranges, device, launches)
    assert rows["pass"]["kernels"] == 0 and rows["pass"]["host_s"] > 0


def test_setup_build_s_reads_the_program_counter(monkeypatch):
    from gvpm_tpu_torch.core.logging import StatsCounter, count_build
    monkeypatch.setattr(StatsCounter, "REGISTRY", {})
    assert setup_build_s.read({}) is None
    count_build(True, 4.5)
    count_build(False, 0.25)
    assert setup_build_s.read({}) == pytest.approx(4.75)
