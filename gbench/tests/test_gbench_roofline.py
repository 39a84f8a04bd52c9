"""The roofline counts, the trace reduction and the metric readers
against hand counts on tiny inputs."""

import pytest
import torch

from gbench import trace
from gbench.metrics import (device_idle_share, device_kernels_per_pass,
                            gather_roofline, gather_s, me_s, pass_s)
from gbench.reference import gather as ref_gather
from gbench.roofline import gather, peaks


def test_slots_read_by_hand():
    # volume: p, wi, alpha, parent_p / wi / ns, scatter_base, st, pm_alb,
    # pm_spec, pm_eta3, pm_sigs (12 x 3) and pdf_dir_base, parent_type,
    # reconnectable, vtype, pm_btype / alpha / eta1 / g / ptype (9)
    assert gather.slots_read("volume", False)[0] == 12 * 3 + 9
    # with ME also pm_delta; surface adds ns and, with ME, own_delta
    assert gather.slots_read("volume", True)[0] == 12 * 3 + 10
    assert gather.slots_read("surface", False)[0] == 13 * 3 + 9
    assert gather.slots_read("surface", True)[0] == 13 * 3 + 11
    # volume queries: x, d, 4 offset points and directions (30) and
    # g, pt, sok, 4 x (cam_ok, prc, border) (15)
    assert gather.slots_read("volume", False)[1] == 30 + 15


def test_least_seconds_by_hand():
    w = dict(kind="volume", me=False, visits=1e6, rows=1000, queries=500)
    rows, qs = gather.slots_read("volume", False)
    n_bytes = 4 * (1000 * rows + 500 * qs + 500 * 29)
    flops = 1e6 * (46 + 4 * (112 + 86 + 49))
    assert gather.least_seconds(w) == pytest.approx(
        max(n_bytes / 3.35e12, flops / 67e12))
    assert flops / 67e12 > n_bytes / 3.35e12   # these inputs: compute


def test_reference_pair_count_by_hand():
    # three photons around one query: two inside the radius, one out
    table = torch.zeros((3, ref_gather.ROW_F))
    s = ref_gather.ROW_SLOT
    table[:, s["vtype"]] = 2.0
    table[0, s["p"]:s["p"] + 3] = torch.tensor([0.5, 0.5, 0.5])
    table[1, s["p"]:s["p"] + 3] = torch.tensor([0.55, 0.5, 0.5])
    table[2, s["p"]:s["p"] + 3] = torch.tensor([0.7, 0.5, 0.5])
    table[:, s["alpha"]:s["alpha"] + 3] = 1.0
    q = torch.zeros((1, 64))
    qs = ref_gather.VOL_QSLOT
    q[0, qs["x"]:qs["x"] + 3] = torch.tensor([0.51, 0.5, 0.5])
    q[0, qs["sok"]] = 1.0
    out, key, rows = ref_gather.gather("volume", table, q, 0.1 ** 2,
                                            1.0, 0)
    assert out[0, 27] == 2 and rows == 2
    # isotropic phase 1/4pi times k3 = 1, alpha 1: primal 2 / 4pi
    assert out[0, 0] == pytest.approx(2 / (4 * torch.pi), rel=1e-6)


def _rec():
    k = [("fused_gather_kernel<V>", 0.0, 1000.0),
         ("row_heads_kernel", 1000.0, 1100.0),
         ("Memcpy HtoD", 1100.0, 1200.0),
         ("gsweep_kernel<P>", 2000.0, 4000.0),
         ("elementwise", 3500.0, 5000.0)]
    kern = trace.compute_kernels(k)
    return dict(window_s=10.0, passes=4, timings=dict(
        surface_gather=1.0, volume_gather=3.0), profile=dict(
        passes=2, wall_s=0.01, busy_s=trace.busy_us(k) * 1e-6,
        n_kernels=len(kern), kernels=kern), work=dict(gather=[dict(
            kind="volume", me=False, visits=1e6, rows=0, queries=0)]))


def test_trace_reduction_by_hand():
    k = _rec()["profile"]["kernels"]
    assert len(k) == 4          # the copy left out
    # union: [0, 1100] and [2000, 5000]
    assert trace.busy_us(_rec()["profile"]["kernels"]) == 4100.0
    gaps = trace.idle_gaps(k, [("light_trace", 0.0, 1500.0),
                               ("gather_kernel", 1500.0, 6000.0)])
    assert gaps == [["light_trace", pytest.approx(900e-6)]]
    top = trace.top_ops(k, 2)
    assert [t[0] for t in top] == ["gsweep_kernel<P>", "elementwise"]


def test_readers_by_hand():
    r = _rec()
    assert pass_s.read(r) == 2.5
    assert gather_s.read(r) == 1.0
    assert me_s.read(r) is None                  # nothing to read: left out
    assert device_kernels_per_pass.read(r) == 2.0
    assert device_idle_share.read(r) == pytest.approx(100 * (1 - 0.0042 / 0.01))
    t = 1100e-6
    assert gather_roofline.read(r) == pytest.approx(
        100 * 1e6 * (46 + 4 * 247) / peaks.PEAK_FP32_S / t)
    assert gather_roofline.read(dict(r, profile=None)) is None


def test_table_check_is_a_multiset_compare():
    """Two records at one position with other fields apart, a row
    changed, a row dropped."""
    from gbench import check

    class Scene:
        med_sigma_a = torch.zeros((1, 3))
        med_sigma_s = torch.zeros((1, 3))
        bsdf_type = torch.zeros(1, dtype=torch.int64)
        bsdf_albedo = bsdf_k = bsdf_eta3 = torch.zeros((1, 3))
        bsdf_alpha = bsdf_eta = med_g = torch.zeros(1)
        med_phase = torch.zeros(1, dtype=torch.int64)

    n = 6
    pv = {f: torch.zeros((n, 3)) for f in ref_gather.ROW3}
    pv.update({f: torch.zeros(n, dtype=torch.int64)
               for f in ref_gather.ROW1})
    pv["med"] = torch.zeros(n, dtype=torch.int64)
    pv["vtype"][:] = 2
    pv["p"] = torch.rand((n, 3), generator=torch.Generator().manual_seed(1))
    pv["p"][1] = pv["p"][0]
    pv["alpha"][0, 0], pv["alpha"][1, 0] = 1.0, 2.0
    table = ref_gather.pack_rows(Scene, pv)

    def err(t, cap=0):
        ev = type("Ev", (), {"name": "volume", "me": False})
        log = [("gather", (ev, None, t, None, 0.0, 0.0, 0), {},
                (None, None))]
        return check.table_numbers(log, Scene, pv, dict(volume=cap))

    assert err(table[torch.randperm(n)]) == 0.0
    changed = table.clone()
    changed[3, ref_gather.ROW_SLOT["wi"]] = 0.5
    assert err(changed) == pytest.approx(1 / n)
    assert err(table[1:]) == pytest.approx(1 / n)
    assert err(table[1:], cap=n - 1) == 0.0
