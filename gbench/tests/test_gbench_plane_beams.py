"""The photon-plane cell at a beam map (configuration gvpm-plane-512,
check module checks/plane0d_beams.py) and the four-rank cell: both load
and are found; faults planted in the beam map, its normalisation and the
planes each put one of the plane check's own numbers over the cell's
committed limit while the sound run keeps it under; the bfloat16 control
fails them; and the sweep roofline's counts on one known pair."""

import functools

import pytest
import torch

from gbench import capture, harness
from gbench.checks import plane0d_beams
from gbench.metrics import sweep_roofline
from gbench.reference import sweep as ref_sweep
from gbench.roofline import peaks, sweep

from .conftest import tiny_cell

SEED = 2 ** 31 + 13
BUDGET = 600


def _limits():
    return harness.load_cell("plane512-nome")["limits"]


def _cell():
    cell = tiny_cell("plane0d", False, check="plane0d_beams")
    cell["config"]["gradient_config"]["beams"] = BUDGET
    return cell


@functools.lru_cache(maxsize=None)
def _sound():
    return _numbers(())


def _numbers(patches):
    with capture.patched(list(patches)):
        _, nums = harness.run_cell(_cell(), SEED, 0.1, False, 0.0,
                                   device=torch.device("cpu"))
    return nums


def _caught(patches):
    lim, sound = _limits(), _sound()
    bad = _numbers(patches)
    return [k for k, v in bad.items()
            if k in lim and v > lim[k] and sound.get(k, 0.0) <= lim[k]]


def test_plane_cell_loads():
    cell = harness.load_cell("plane512-nome")
    assert harness.checks_of(cell) is plane0d_beams
    cfg = cell["config"]
    assert cfg["volume"] == "plane0d" and cfg["reduced"] == []
    assert cfg["gradient_config"]["beams"] == 20000
    assert not cell["traffic"]["use_manifold"] and cell["chips"] == 1
    # every per-layer metric the plane pass has something for: all but ME's
    assert {m["name"] for m in cell["per_layer"]} == {
        "poisson_solve_s", "light_trace_s", "camera_trace_s", "grid_s",
        "gather_s", "gather_roofline", "device_idle_share",
        "device_kernels_per_pass", "setup_build_s", "sweep_roofline"}
    assert set(plane0d_beams.NEW) <= set(cell["limits"])
    assert not {"segment_err", "vgather_err", "vgather_miss"} \
        & set(cell["limits"])


def test_four_rank_cell_loads():
    cell = harness.load_cell("vpm512-nome-x4")
    one = harness.load_cell("vpm512-nome")
    assert cell["chips"] == cell["traffic"]["ranks"] == 4
    assert cell["config"] == one["config"]
    # light_err is held to the worst of four ranks' samples: its own limit,
    # set from the four-rank readings (PERF.md, section 6)
    assert cell["limits"] == dict(one["limits"], film_gather_err=0.0,
                                  light_err=3e-4)
    # rank 0's profiled pass and its laps
    assert {m["name"] for m in cell["per_layer"]} == {
        "device_idle_share", "device_kernels_per_pass", "poisson_solve_s",
        "light_trace_s", "camera_trace_s", "grid_s", "gather_s"}


def test_sound_run_meets_the_limits():
    lim, sound = _limits(), _sound()
    assert set(sound) == set(lim)
    assert all(sound[k] <= lim[k] for k in lim), sound


def _past_budget():
    """Beams past the budget kept: the map of 1.5 times it."""
    from gvpm_tpu_torch.integrators import sppm
    real = sppm.select_beams
    return (sppm, "select_beams",
            lambda beams, n, budget: real(beams, n, budget * 3 // 2))


def _by_all_paths():
    """The beam estimate divided by the pass's light paths."""
    from gvpm_tpu_torch.integrators import sppm
    real = sppm.select_beams
    return (sppm, "select_beams",
            lambda beams, n, budget: (real(beams, n, budget)[0], n))


def _w1_altered():
    """A hundredth of the planes' w1 turned to another direction."""
    from gvpm_tpu_torch.integrators import estimators
    real = estimators.make_planes

    def broken(scene, lb, key):
        out = dict(real(scene, lb, key))
        rows = torch.nonzero(out["valid"])[:, 0]
        g = torch.Generator().manual_seed(5)
        pick = rows[torch.randperm(rows.shape[0], generator=g)[
            :max(1, rows.shape[0] // 100)]]
        w1 = out["w1"].clone()
        w1[pick] = w1[pick].roll(1, -1)
        out["w1"] = w1
        return out

    return (estimators, "make_planes", broken)


@pytest.mark.parametrize("fault,number", [
    (_past_budget, "beam_select_err"), (_by_all_paths, "vscale_err"),
    (_w1_altered, "plane_err")])
def test_beam_map_faults_fail(fault, number):
    assert number in _caught([fault()])


def test_control_fails_the_new_numbers():
    """The reference in bfloat16 in the program's place."""
    lim = _limits()
    run = harness.Pass(_cell(), 11, torch.device("cpu"))
    log = []
    harness.rerun(run, 2, log)
    nums = harness.pass_numbers(run, log, 2, dtype=torch.bfloat16)
    over = {k for k in plane0d_beams.NEW if nums[k] > lim[k]}
    assert {"plane_err", "vscale_err"} <= over, nums


def test_module_refuses_a_program_without_beam_map(monkeypatch):
    import importlib
    import sys

    from gvpm_tpu_torch.integrators import sppm
    monkeypatch.delattr(sppm, "select_beams")
    monkeypatch.delitem(sys.modules, "gbench.checks.plane0d_beams")
    with pytest.raises(ImportError, match="select_beams"):
        importlib.import_module("gbench.checks.plane0d_beams")


def _one_pair():
    """A segment along +z from the origin through a plane spanned by +x
    and +y at z = 0.5: one hit."""
    q = torch.zeros((1, 20))
    s = ref_sweep.QSLOT
    q[0, s["o"]:s["o"] + 3] = torch.tensor([0.2, 0.3, 0.0])
    q[0, s["d"]:s["d"] + 3] = torch.tensor([0.0, 0.0, 1.0])
    q[0, s["length"]] = 1.0
    q[0, s["valid"]] = 1.0
    q[0, s["st"]:s["st"] + 3] = 0.45
    q[0, s["ss"]:s["ss"] + 3] = 0.4
    q[0, s["w"]] = 1.0
    b = torch.zeros((1, 16))
    t = ref_sweep.BSLOT
    b[0, t["o"]:t["o"] + 3] = torch.tensor([0.0, 0.0, 0.5])
    b[0, t["d"]:t["d"] + 3] = torch.tensor([1.0, 0.0, 0.0])
    b[0, t["length"]] = 1.0
    b[0, t["alpha"]:t["alpha"] + 3] = 1.0
    b[0, t["w1"]:t["w1"] + 3] = torch.tensor([0.0, 1.0, 0.0])
    b[0, t["l1"]] = 1.0
    b[0, t["sig"]] = 0.45
    return q, torch.zeros((1, 4 * ref_sweep.XSTRIDE)), b, torch.zeros((1, 32))


def test_sweep_roofline_count_on_one_pair():
    q, qx, b, tails = _one_pair()
    _, visits, reconn = ref_sweep.sweep(q, qx, b, tails, torch.tensor([0]))
    assert int(visits[0]) == 1 and int(reconn[0]) == 0   # identity shifts
    # a plane's row o, d, length, med, alpha, w1, l1, sig (16) and the 29
    # tail slots the shifts read; a segment's 18 query slots and its four
    # offset rays' 10 each
    assert sweep.slots_read() == (16 + 29, 18 + 40)
    # the parts add up to the docstring's totals: the base term and four
    # identity shifts a hit, and a rotation in an identity's place
    assert (sweep.BASE_OPS, sweep.IDENTITY_OPS, sweep.ROTATION_OPS) \
        == (120, 193, 389)
    assert sweep.operations(1, 0) == 892
    assert sweep.operations(1, 4) == 120 + 4 * 389
    n_bytes = 4 * (1 * 45 + 1 * (58 + 27))
    assert sweep.least_seconds(1, 0, 1, 1) == pytest.approx(
        max(n_bytes / peaks.PEAK_BYTES_S, 892 / peaks.PEAK_FP32_S))


def test_sweep_roofline_reads_the_counters(monkeypatch):
    from gvpm_tpu_torch.core.logging import StatsCounter
    rec = dict(profile=dict(kernels=[("void gsweep_kernel<P>(float)", 0.0,
                                      2000.0),
                                     ("fused_gather_kernel<V>", 0.0, 50.0)]))
    monkeypatch.setattr(StatsCounter, "REGISTRY", {})
    assert sweep_roofline.read(rec) is None      # no counters: the parent
    for name, per_pass in (("hits", 1e7), ("reconnections", 6e6),
                           ("rows", 2e4), ("segments", 5e5)):
        c = StatsCounter.get("sweep/" + name, "average")
        c.add(torch.tensor(per_pass * 2))
        c.add(0.0)          # two passes: the mean is per_pass
    want = 100.0 * sweep.least_seconds(1e7, 6e6, 2e4, 5e5) / 2e-3
    assert sweep_roofline.read(rec) == pytest.approx(want)
    assert sweep_roofline.read(dict(profile=dict(kernels=[]))) is None
