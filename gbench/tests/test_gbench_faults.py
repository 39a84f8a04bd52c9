"""The check against faults planted in the timed path, and the control:
a run of the tiny cell on the CPU with the program broken underneath, or
with the reference in bfloat16 put in its place, has to put a number over
its committed limit that the sound run keeps under it."""

import functools

import pytest
import torch

from gbench import capture, check, harness
from gbench.reference import gather as ref_gather

from .conftest import tiny_cell

VTYPE = ref_gather.ROW_SLOT["vtype"]
SEED = 2 ** 31 + 9
# the plane cell was held back; its sweep numbers keep the limits it had
SWEEP_LIMITS = dict(sweep_err=1e-4, sweep_count_err=1e-2)


def _limits(me):
    lim = dict(harness.load_cell("vpm512-me" if me else "vpm512-nome")
               ["limits"])
    lim.update(SWEEP_LIMITS)
    return lim


@functools.lru_cache(maxsize=None)
def _sound(volume, me):
    return _numbers(volume, me, ())


def _numbers(volume, me, patches):
    cell = tiny_cell(volume, me)
    with capture.patched(list(patches)):
        _, nums = harness.run_cell(cell, SEED, 0.1, False, 0.0,
                                   device=torch.device("cpu"))
    return nums


def _caught(volume, me, patches):
    """The numbers the fault puts over their limit, of those the sound
    run keeps under it."""
    lim = _limits(me)
    sound = _sound(volume, me)
    bad = _numbers(volume, me, patches)
    return [k for k, v in bad.items()
            if k in lim and v > lim[k] and sound.get(k, 0.0) <= lim[k]]


def _pick(n, share=0.01, seed=5):
    g = torch.Generator().manual_seed(seed)
    return torch.randperm(n, generator=g)[:max(1, int(n * share))]


def _gather_fault(fault):
    from gvpm_tpu_torch.ops import fused_gather as fg
    real = fg.fused_gather

    def broken(ev, plan, table, qrows, r2, k3, min_depth):
        if fault == "half":       # half the photons left out, the rest x2
            table = table.clone()
            table[table.shape[0] // 2:, VTYPE] = 0.0
        out, me = real(ev, plan, table, qrows, r2, k3, min_depth)
        if fault == "unchanged":  # the accumulators returned as they came
            out = torch.zeros_like(out)
        elif fault == "half":
            out = out * 2.0
        elif fault == "altered":  # a seeded hundredth of the answers
            out = out.clone()
            out[_pick(out.shape[0]), :27] *= 1.5
        return out, me

    return (fg, "fused_gather", broken)


def _light_fault(fault):
    from gvpm_tpu_torch.integrators import sppm
    real = sppm.shoot_photons

    def broken(scene, cfg, n, key, **kw):
        ph, beams = real(scene, cfg, n, key, **kw)
        ph = dict(ph)
        steps = ph["p"].shape[0] // n
        if fault == "half":       # half the paths shot, the rest's power x2
            lane = torch.arange(ph["p"].shape[0]) % n
            ph["vtype"] = torch.where(lane >= n // 2, 0, ph["vtype"])
            ph["alpha"] = ph["alpha"] * 2.0
        elif fault == "unchanged":  # every step's record the first step's
            ph = {k: v.reshape((steps, n) + v.shape[1:])[:1].expand(
                (steps, n) + v.shape[1:]).reshape(v.shape)
                for k, v in ph.items()}
        elif fault == "altered":  # a hundredth of the photons moved
            ph["p"] = ph["p"].clone()
            ph["p"][_pick(ph["p"].shape[0])] += 0.01
        return ph, beams

    return (sppm, "shoot_photons", broken)


def _camera_fault(fault):
    from gvpm_tpu_torch.integrators import gatherpoint
    real = gatherpoint.trace

    def broken(scene, cfg, key, px, py, rand_tile=1):
        gps, cbs = real(scene, cfg, key, px, py, rand_tile)
        n = gps.valid.shape[0]
        if fault == "half":       # half the pixels find no gather point
            gps = gps.replace(valid=gps.valid & (torch.arange(n) % 2 == 0))
        elif fault == "unchanged":  # the segments never leave the camera
            cbs = cbs.replace(length=torch.zeros_like(cbs.length))
        elif fault == "altered":  # a hundredth of the throughputs x1.5
            thr = gps.thr.clone()
            thr[_pick(n)] *= 1.5
            gps = gps.replace(thr=thr)
        return gps, cbs

    return (gatherpoint, "trace", broken)


def _me_fault(fault):
    from gvpm_tpu_torch.integrators import manifold
    real = manifold.me_shift_volume

    def broken(scene, ch, c_t, **kw):
        ar, pr, ok, wi = real(scene, ch, c_t, **kw)
        L = ok.shape[0]
        if fault == "unchanged":  # no photon shifted
            ok = torch.zeros_like(ok)
        elif fault == "half":     # half the lanes dropped
            ok = ok & (torch.arange(L) < L // 2)
        elif fault == "altered":  # a tenth of the shifted powers x1.5
            ar = ar.clone()
            ar[_pick(L, 0.1)] *= 1.5
        return torch.where(ok[:, None], ar, 0.0), \
            torch.where(ok, pr, 0.0), ok, wi

    return (manifold, "me_shift_volume", broken)


def _query_fault():
    """Every gather's query rows built 1e-3 off in their first point."""
    from gvpm_tpu_torch.integrators import gradient_gather as gg
    real = gg._qrows

    def broken(cols3, cols1, width, order):
        q = real(cols3, cols1, width, order).clone()
        q[:, 0:3] += 1e-3
        return q

    return (gg, "_qrows", broken)


def _me_terms_dropped():
    """The ME pairs' terms never added to S and W."""
    from gvpm_tpu_torch.integrators import gradient_gather as gg
    return (gg, "_add_me", lambda *args: None)


def _buffers_fault():
    """A hundredth of the pixels' offset sums altered where the pass
    buffers are assembled."""
    from gvpm_tpu_torch.integrators import gvpm
    real = gvpm.pass_buffers

    def broken(*args, **kw):
        p, S, W, st = real(*args, **kw)
        S = S.clone()
        S[:, _pick(S.shape[1])] *= 1.5
        return p, S, W, st

    return (gvpm, "pass_buffers", broken)


def _hidden(stage):
    """The pass run with one recorded stage called past the recorder (a
    change that stops calling the stage the check reads)."""
    from gvpm_tpu_torch.integrators import (gatherpoint, gradient_gather,
                                            gvpm, manifold, sppm)
    from gvpm_tpu_torch.ops import fused_gather
    mod, attr = dict(film=(gvpm, "assemble_gradients"),
                     gather=(fused_gather, "fused_gather"),
                     volume=(gradient_gather, "volume_gather"),
                     light=(sppm, "shoot_photons"),
                     camera=(gatherpoint, "trace"),
                     me=(manifold, "me_shift_volume"))[stage]
    plain = getattr(mod, attr)
    real = gvpm.render_pass

    def render_pass(*args, **kw):
        seen = getattr(mod, attr)
        setattr(mod, attr, plain)
        try:
            return real(*args, **kw)
        finally:
            setattr(mod, attr, seen)

    return (gvpm, "render_pass", render_pass)


FAULTS = ["unchanged", "half", "altered"]


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("me", [True, False])
def test_gather_faults_fail(me, fault):
    assert _caught("distance", me, [_gather_fault(fault)])


@pytest.mark.parametrize("fault", FAULTS)
def test_light_faults_fail(fault):
    caught = _caught("distance", False, [_light_fault(fault)])
    assert set(caught) & {"light_err", "light_miss"}, caught


@pytest.mark.parametrize("fault", FAULTS)
def test_camera_faults_fail(fault):
    caught = _caught("distance", False, [_camera_fault(fault)])
    assert set(caught) & {"camera_err", "camera_miss"}, caught


@pytest.mark.parametrize("fault", FAULTS)
def test_me_faults_fail(fault):
    caught = _caught("distance", True, [_me_fault(fault)])
    assert set(caught) & {"me_shift_err", "me_shift_miss"}, caught


@pytest.mark.parametrize("stage", ["film", "gather", "volume", "light",
                                   "camera", "me"])
def test_stage_not_called_fails(stage):
    caught = _caught("distance", True, [_hidden(stage)])
    assert "stage_calls" in caught, caught


@pytest.mark.parametrize("me", [True, False])
def test_wrong_queries_fail(me):
    caught = _caught("distance", me, [_query_fault()])
    assert set(caught) & {"sgather_err", "sgather_miss", "vgather_err",
                          "vgather_miss"}, caught


def test_me_terms_dropped_fail():
    caught = _caught("distance", True, [_me_terms_dropped()])
    assert set(caught) & {"sgather_err", "sgather_miss", "vgather_err",
                          "vgather_miss"}, caught


def test_buffers_fault_fails():
    caught = _caught("distance", False, [_buffers_fault()])
    assert "buffers_err" in caught, caught


@pytest.mark.parametrize("fault", FAULTS)
def test_sweep_faults_fail(fault):
    from gvpm_tpu_torch.ops import beam_sweep as bs
    real = bs.gsweep

    def broken(kind, q, qx, rows, tails, p):
        if fault == "half":
            rows = rows.clone()
            rows[rows.shape[0] // 2:, 7] = -5.0        # no medium: no pair
        pr, S, W, v, ok = real(kind, q, qx, rows, tails, p)[:5]
        if fault == "unchanged":
            pr, S, W = (torch.zeros_like(a) for a in (pr, S, W))
        elif fault == "half":
            pr, S, W = pr * 2, S * 2, W * 2
        else:
            pr = pr * 1.5
        return pr, S, W, v, ok

    assert _caught("plane0d", False, [(bs, "gsweep", broken)])


def test_sweep_of_another_kind_fails():
    """A pass whose recorded sweeps are beam1d's, judged by the plane's
    check: the plane reference does not hold them, so its numbers read
    inf."""
    cell = tiny_cell("beam1d", check="plane0d")
    run = harness.Pass(cell, SEED, torch.device("cpu"))
    log = []
    harness.rerun(run, 2, log)
    kinds = {args[0] for kind, args, _, _ in log if kind == "sweep"}
    assert kinds == {"gbeam1d"}
    nums = harness.pass_numbers(run, log, 2)
    assert nums["sweep_err"] == nums["sweep_count_err"] == check.MISSING
    assert not check.judge(nums, _limits(False))[0]


def test_solve_unchanged_fails():
    from gvpm_tpu_torch.ops import poisson

    def broken(primal, gx, gy, **kw):
        return primal.clone()

    assert "solve_err" in _caught("distance", False,
                                  [(poisson, "solve", broken)])


@pytest.mark.parametrize("volume,me", [("distance", True),
                                       ("plane0d", False)])
def test_control_fails(volume, me):
    """The reference in bfloat16 in the program's place."""
    limits = _limits(me)
    run = harness.Pass(tiny_cell(volume, me), 11, torch.device("cpu"))
    log = []
    harness.rerun(run, 2, log)
    nums = harness.pass_numbers(run, log, 2, dtype=torch.bfloat16)
    film = next(o for k, _, _, o in log if k == "film")
    nums["solve_err"] = check.solve_numbers(film, None, run.cfg,
                                            torch.bfloat16)
    over = [k for k, v in nums.items() if v > limits[k]]
    assert over, nums
