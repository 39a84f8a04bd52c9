"""The port's spans (core.logging.span / PhaseClock.span) on a tiny G-VPM
distance pass in box_medium at 16x16, ME on (a pair budget of 16) and
off, on the CPU:

- a profiled ME pass holds the span tree: light_step in light_trace,
  gather_kernel in the gathers, every me: part in an ME stage, the ME
  stages beside the gathers, everything but solve inside pass;
- the `timings` key sets are the ones the per-phase laps wrote before the
  spans replaced them (written out literally);
- with neither a timings dict nor a profiler a pass calls neither
  record_function nor torch.cuda.synchronize;
- the light lanes in the pass's stats count the light pass's records;
- a kernel-library build is counted in the build/* statistics."""

import pytest
import torch

from gvpm_tpu_torch import scenes
from gvpm_tpu_torch.core.config import GradientConfig
from gvpm_tpu_torch.core.logging import StatsCounter
from gvpm_tpu_torch.integrators import gvpm, ptracer, sppm
from gvpm_tpu_torch.native import bind
from gvpm_tpu_torch.ops import poisson
from tests.test_torch_common import torch_threads  # noqa: F401

PASS_KW = dict(max_depth=4, null_bounces=2, max_cam_depth=4,
               surface_photons=1 << 11, volume_photons=1 << 11,
               volume_samples=2, vol_segments_per_pixel=2,
               initial_scale_volume=2.0, grid_dims=(8, 8, 8),
               rr_depth_photon=10, me_pair_budget=16)
N_PATHS = 1 << 11
STEPS = PASS_KW["max_depth"] + PASS_KW["null_bounces"]

ME_OFF_KEYS = {"light_trace", "camera_trace", "surface_grid",
               "surface_gather", "volume_grid", "volume_gather", "splat"}
ME_ON_KEYS = ME_OFF_KEYS | {"surface_me", "volume_me", "me:compact",
                            "me:chains", "me:newton", "me:ratios",
                            "me:occlusion"}
ME_PARTS = ("me:compact", "me:chains", "me:newton", "me:ratios",
            "me:occlusion")


def _pass(me, timings=None):
    scene = scenes.box_medium(16, 16, device="cpu")
    cfg = GradientConfig(use_manifold=me, **PASS_KW)
    return gvpm.render_pass(scene, cfg, "distance", N_PATHS, 5, 2, 1.0, 1.0,
                            sppm.base_volume_radius(scene, cfg),
                            timings=timings)


def _ranges(prof):
    """(name, start ns, end ns) of every host range the profile holds."""
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation()
            and e.device_type() == torch.autograd.DeviceType.CPU]


@pytest.fixture(scope="module")
def profiled():
    """The ME pass and a solve of its images under torch.profiler, with a
    timings dict, and the light pass's photon dict."""
    shot = []
    real = sppm.shoot_photons

    def shoot(*args, **kw):
        out = real(*args, **kw)
        shot.append(out[0])
        return out

    timings = {}
    act = torch.profiler.ProfilerActivity
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sppm, "shoot_photons", shoot)
        with torch.profiler.profile(activities=[act.CPU]) as prof:
            p, gx, gy, stats = _pass(True, timings)
            poisson.solve(p, gx, gy, iters=2, irls_iters=1)
    return _ranges(prof), timings, stats, shot[0]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _within(ranges, child, parents):
    """Every range named `child` lies inside one named in `parents`."""
    kids = [r for r in ranges if r[0] == child]
    outer = [r for r in ranges if r[0] in parents]
    return bool(kids) and all(any(_inside(k, o) for o in outer)
                              for k in kids)


def test_profiled_pass_holds_the_span_tree(profiled):
    ranges = profiled[0]
    names = {r[0] for r in ranges}
    assert {"pass", "light_trace", "light_step", "camera_trace",
            "surface_grid", "surface_gather", "gather_kernel", "surface_me",
            "volume_grid", "volume_gather", "volume_me", "splat", "film",
            "solve"} | set(ME_PARTS) <= names
    assert sum(r[0] == "light_step" for r in ranges) == STEPS
    assert _within(ranges, "light_step", {"light_trace"})
    assert _within(ranges, "gather_kernel",
                   {"surface_gather", "volume_gather"})
    for part in ME_PARTS:
        assert _within(ranges, part, {"surface_me", "volume_me"}), part
    # the ME stages lie beside the gathers, not inside them
    assert not any(_inside(m, g) for m in ranges for g in ranges
                   if m[0].endswith("_me") and g[0].endswith("_gather"))
    passes = [r for r in ranges if r[0] == "pass"]
    assert len(passes) == 1
    for r in ranges:
        assert _inside(r, passes[0]) == (r[0] != "solve"), r[0]


def test_timing_keys_are_the_laps_keys(profiled):
    timings = profiled[1]
    assert set(timings) == ME_ON_KEYS
    assert all(v > 0.0 for v in timings.values())
    parts = sum(timings[k] for k in ME_PARTS)
    assert parts <= timings["surface_me"] + timings["volume_me"]
    off = {}
    _pass(False, off)
    assert set(off) == ME_OFF_KEYS


def test_light_lanes_count_the_records(profiled):
    _, _, stats, photons = profiled
    live = int((photons["vtype"] != ptracer.VERT_NONE).sum())
    assert int(stats["light_lanes_live"]) == live > 0
    assert int(stats["light_lanes"]) == STEPS * N_PATHS
    assert stats["light_lanes_live"].dtype == torch.int64


def test_untraced_pass_records_and_synchronizes_nothing(monkeypatch):
    calls = dict(record_function=0, synchronize=0)

    def counted(name, real):
        def f(*args, **kw):
            calls[name] += 1
            return real(*args, **kw)
        return f

    rf = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        counted("record_function", rf))
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        counted("record_function", rf))
    monkeypatch.setattr(torch.cuda, "synchronize",
                        counted("synchronize", lambda *a, **k: None))
    _pass(True)
    assert calls == dict(record_function=0, synchronize=0)
    # the counters do see a profiled pass's ranges
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _pass(False)
    assert calls["record_function"] > 0


def test_native_build_counts_a_compile_then_a_load(tmp_path, monkeypatch):
    monkeypatch.setattr(bind, "BUILD_DIR", str(tmp_path))

    def count(name):
        c = StatsCounter.REGISTRY.get(name)
        return 0.0 if c is None else c.value()

    before = [count(f"build/{k}") for k in ("compiles", "loads", "seconds")]
    bind.build()
    after = [count(f"build/{k}") for k in ("compiles", "loads", "seconds")]
    assert after[0] - before[0] == 1 and after[1] - before[1] == 1
    assert after[2] > before[2]
    bind.build()
    again = [count(f"build/{k}") for k in ("compiles", "loads")]
    assert again == [after[0], after[1] + 1]
