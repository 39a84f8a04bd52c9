"""The benchmark's run rehearsed on the CPU at a test-only tiny cell: the
harness drives the program (its plain PyTorch kernels here) through
set-up, window and check, and the reference agrees with the port."""

import json

import pytest
import torch

from gbench import check, harness, run
from gbench.metrics import gather_s, light_trace_s, poisson_solve_s

from .conftest import tiny_cell

# the port against the reference at the tiny size: the program's plain
# versions compute the same formulas in float32
AGREE = dict(gather_err=1e-5, count_err=0.0, me_key_err=0.0,
             me_count_err=0.0, table_err=0.0, film_err=1e-6,
             solve_err=1e-4, repeat_err=0.0, sweep_err=1e-5,
             sweep_count_err=0.0, light_err=1e-5, light_miss=0.0,
             camera_err=1e-5, camera_miss=0.0, me_shift_err=0.05,
             me_shift_miss=0.05, stage_calls=0.0, segment_err=0.0,
             sgather_err=1e-6, sgather_miss=0.0, vgather_err=1e-6,
             vgather_miss=0.01, buffers_err=1e-6)
# (the ME numbers and vgather_miss: a tiny cell shifts a few dozen lanes,
# one of which may fall on the other side of a convergence or fold test)


@pytest.mark.parametrize("volume,me", [("distance", False),
                                       ("distance", True),
                                       ("plane0d", False)])
def test_reference_agrees_with_port(cpu, volume, me):
    rec, nums = harness.run_cell(tiny_cell(volume, me), 2 ** 31 + 5, 0.2,
                                 False, 0.0, device=cpu)
    assert rec["passes"] >= 2 and rec["window_s"] > 0
    want = {"gather_err", "count_err", "table_err", "film_err", "solve_err",
            "repeat_err", "light_err", "light_miss", "camera_err",
            "camera_miss", "stage_calls"}
    if volume == "distance":
        want |= {"segment_err", "sgather_err", "sgather_miss",
                 "vgather_err", "vgather_miss", "buffers_err"}
    if me:
        want |= {"me_key_err", "me_count_err", "me_shift_err",
                 "me_shift_miss"}
    if volume == "plane0d":
        want |= {"sweep_err", "sweep_count_err"}
    assert set(nums) == want
    for k, v in nums.items():
        assert v <= AGREE[k], (k, v)


def test_traced_run_reads_its_layers(cpu):
    rec, nums = harness.run_cell(tiny_cell("distance", True), 77, 0.2,
                                 True, 0.0, device=cpu)
    assert light_trace_s.read(rec) > 0 and gather_s.read(rec) > 0
    assert poisson_solve_s.read(rec) > 0
    w = rec["work"]["gather"]
    assert [x["kind"] for x in w] == ["surface", "volume", "volume"]
    assert all(x["visits"] > 0 and x["rows"] > 0 for x in w)


def test_result_line(cpu, monkeypatch):
    cell = tiny_cell(limits=dict(AGREE, me_key_err=None))
    cell["end_to_end"] = [dict(name="pass_s", unit="s"),
                          dict(name="setup_s", unit="s")]
    rec, nums = harness.run_cell(cell, 3, 0.2, False, 0.0, device=cpu)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "cpu")
    monkeypatch.setattr(run, "power_limit", lambda: None)
    cell["limits"] = {k: v for k, v in AGREE.items() if k in nums}
    line, rows = run.result(cell, rec, nums)
    assert line["correct"] is True and line["failed"] == 0, rows
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"pass_s", "setup_s"}
    assert line["device"]["count"] == 1
    json.dumps(line)
    bad, _ = check.judge(dict(nums, gather_err=1.0), cell["limits"])
    assert not bad


def test_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        run.main(["--workload", "vpm512-nome", "--seed", "1",
                  "--seconds", "1", "--trace", "0"])
    assert e.value.code not in (0, None)
    assert capsys.readouterr().out == ""
