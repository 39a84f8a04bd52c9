"""The port's beam map (PhotonConfig.beams, integrators.sppm.select_beams)
on the CPU:

- beams=0 renders every medium edge as a beam, as before the port read
  the setting: the gradient and primal beam1d / beam3d / plane0d passes
  keep their bits (sha256 of the float32 images, on one thread, as the
  port computed them before), and select_beams is never called;
- select_beams keeps what the benchmark's plain reference
  (gbench/reference/beams.py) keeps, at budgets below one path's edges,
  between, and above all edges;
- the beam and plane estimates divide by the kept paths;
- a 32x32 gradient plane0d pass with a beam map, held by the benchmark's
  plane check (gbench/checks/plane0d_beams.py: the selection, the planes,
  the sweep against reference/sweep.py and the scaling);
- a beam map on more than one rank is refused (parallel.dist).
"""

import hashlib

import pytest
import torch

from gbench import harness
from gbench.reference import beams as ref_beams
from gbench.tests.conftest import tiny_cell
from gvpm_tpu_torch import scenes
from gvpm_tpu_torch.core.config import GradientConfig, PhotonConfig
from gvpm_tpu_torch.core.logging import StatsCounter
from gvpm_tpu_torch.integrators import (gradient_gather, gvpm, ptracer,
                                        sppm)
from gvpm_tpu_torch.parallel import dist
from gvpm_tpu_torch.parallel.mesh import Mesh

N_PATHS = 1 << 10
KW = dict(max_depth=4, null_bounces=2, max_cam_depth=4,
          surface_photons=N_PATHS, volume_photons=N_PATHS, volume_samples=1,
          vol_segments_per_pixel=2, grid_dims=(16, 16, 16),
          initial_scale_volume=2.0)
GRAD_KW = dict(KW, grid_surface_rows=1024, grid_volume_rows=1024,
               use_manifold=False)
# the images' bits at beams=0: (primal, gx, gy) of gvpm.render_pass, the
# image of sppm.render_pass, 16x16 box_medium, seed 7, pass 3
BITS = {("gvpm", "beam1d"): "f88487ce9fdd2f3a",
        ("gvpm", "beam3d"): "5f54fc66fdb1f3fd",
        ("gvpm", "plane0d"): "8170597f7f7b74a1",
        ("sppm", "beam1d"): "12b1f1652e50de99",
        ("sppm", "beam3d"): "28e126346e906584",
        ("sppm", "plane0d"): "3dacc32d93e9f777"}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    return scenes.box_medium(16, 16, device="cpu")


def _pass(scene, integrator, volume, beams=0):
    if integrator == "gvpm":
        cfg = GradientConfig(beams=beams, **GRAD_KW)
        return gvpm.render_pass(scene, cfg, volume, N_PATHS, 7, 3, 1.0, 1.0,
                                sppm.base_volume_radius(scene, cfg))[:3]
    cfg = PhotonConfig(beams=beams, **KW)
    return (sppm.render_pass(scene, cfg, volume, N_PATHS, 7, 3, 1.0, 1.0,
                             sppm.base_volume_radius(scene, cfg)),)


@pytest.mark.parametrize("integrator,volume", sorted(BITS))
def test_beams_zero_keeps_every_edge(scene, monkeypatch, integrator, volume):
    def never(*args, **kw):
        raise AssertionError("select_beams called at beams=0")

    monkeypatch.setattr(sppm, "select_beams", never)
    assert GradientConfig().beams == PhotonConfig().beams == 0
    h = hashlib.sha256()
    for img in _pass(scene, integrator, volume):
        h.update(img.contiguous().numpy().tobytes())
    assert h.hexdigest()[:16] == BITS[(integrator, volume)]


@pytest.fixture(scope="module")
def light_beams(scene):
    cfg = GradientConfig(**GRAD_KW)
    key = torch.tensor([17, 4242], dtype=torch.int64)
    _, beams = sppm.shoot_photons(scene, cfg, N_PATHS, key)
    return beams


def _edges(beams):
    return beams["valid"].reshape(-1, N_PATHS).sum(0)


def _budgets(beams):
    per_path = _edges(beams)
    first = int(per_path[per_path > 0][0])
    total = int(per_path.sum())
    # below the first path with edges (it and every later path left out,
    # or the paths before it kept with none), within, all, above all
    return [max(first - 1, 1), 7, 300, 1234, total, total + 1000]


@pytest.mark.parametrize("which", range(6))
def test_select_beams_matches_the_reference(light_beams, which):
    budget = _budgets(light_beams)[which]
    out, n_paths = sppm.select_beams(light_beams, N_PATHS, budget)
    idx, n_ref = ref_beams.select(light_beams["valid"], N_PATHS, budget)
    keep = out["valid"]
    assert out["valid"].shape[0] == min(budget, light_beams["valid"].numel())
    assert int(keep.sum()) == idx.shape[0] <= budget
    assert bool(keep[:idx.shape[0]].all())      # the kept beams first
    for k, v in light_beams.items():
        assert torch.equal(out[k][keep], v[idx]), k
    assert int(n_paths) == n_ref
    cum = torch.cumsum(_edges(light_beams), 0)
    # whole paths from the start: the next path would pass the budget
    kept_paths = int((cum <= budget).to(torch.int64).cumprod(0).sum())
    assert max(kept_paths, 1) == n_ref
    if kept_paths < N_PATHS:
        assert int(cum[kept_paths]) > budget


def test_select_beams_path_order():
    """Path by path, each path's beams in depth order; a path whose beams
    would pass the budget is left out whole, with every later one."""
    valid = torch.tensor([[1, 0, 1, 1, 0], [1, 1, 0, 1, 1],
                          [0, 1, 0, 1, 1]], dtype=torch.bool).reshape(-1)
    beams = dict(valid=valid, o=torch.arange(15.0))
    for budget, kept, paths in ((1, [], 1), (2, [0, 5], 1),
                                (4, [0, 5, 6, 11], 2),
                                (7, [0, 5, 6, 11, 2], 3),
                                (20, [0, 5, 6, 11, 2, 3, 8, 13, 9, 14], 5)):
        out, n = sppm.select_beams(beams, 5, budget)
        assert out["o"][out["valid"]].to(torch.int64).tolist() == kept
        assert int(n) == paths
        idx, n_ref = ref_beams.select(valid, 5, budget)
        assert idx.tolist() == kept and n_ref == paths


def test_select_beams_counts(light_beams):
    kept, paths = (StatsCounter.get(f"beams/{k}", "average")
                   for k in ("kept", "paths"))
    before = [(c.num, c.den) for c in (kept, paths)]
    out, n = sppm.select_beams(light_beams, N_PATHS, 300)
    assert isinstance(kept.num, torch.Tensor)    # summed where it lives
    assert kept.num - before[0][0] == int(out["valid"].sum())
    assert paths.num - before[1][0] == int(n)
    assert kept.den - before[0][1] == 1


def test_plane_estimate_divides_by_kept_paths(scene, monkeypatch):
    seen = []
    real = gradient_gather.plane_gradient_gather

    def record(*args, **kw):
        out = real(*args, **kw)
        seen.append((args, kw, out))
        return out

    monkeypatch.setattr(gradient_gather, "plane_gradient_gather", record)
    shot = []
    real_shoot = sppm.shoot_photons
    monkeypatch.setattr(sppm, "shoot_photons",
                        lambda *a, **k: shot.append(real_shoot(*a, **k))
                        or shot[-1])
    _pass(scene, "gvpm", "plane0d", beams=300)
    (args, kw, out), = seen
    _, n_ref = ref_beams.select(shot[0][1]["valid"], N_PATHS, 300)
    assert int(args[4]) == n_ref < N_PATHS
    once = real(*args[:4], 1, *args[5:], **kw)
    for a, b in zip(out[:3], once[:3]):
        torch.testing.assert_close(a, b / n_ref, rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("volume", ["beam1d", "beam3d"])
def test_beam_estimates_divide_by_kept_paths(scene, monkeypatch, volume):
    name = dict(beam1d="beam_gradient_gather",
                beam3d="beam3d_gradient_gather")[volume]
    seen = []
    real = getattr(gradient_gather, name)
    monkeypatch.setattr(gradient_gather, name,
                        lambda *a, **k: seen.append(a) or real(*a, **k))
    _pass(scene, "gvpm", volume, beams=300)
    assert 0 < int(seen[0][4]) < N_PATHS


def test_plane_pass_with_beam_map_meets_the_reference():
    """A 32x32 pass of 2^11 paths at a beam map of 600, held by the
    benchmark's plane check as its cell holds a 512^2 one."""
    cell = tiny_cell("plane0d", False, width=32, check="plane0d_beams")
    cell["config"]["gradient_config"]["beams"] = 600
    run = harness.Pass(cell, 2 ** 31 + 77, torch.device("cpu"))
    log = []
    harness.rerun(run, 2, log)
    nums = harness.pass_numbers(run, log, 2)
    assert nums["beam_select_err"] == 0.0
    assert nums["plane_err"] < 1e-6 and nums["vscale_err"] < 1e-6
    assert nums["sweep_err"] < 1e-5 and nums["sweep_count_err"] == 0.0
    assert nums["buffers_err"] < 1e-6 and nums["stage_calls"] == 0.0
    lb = next(a[1] for k, a, _, _ in log if k == "make_planes")
    assert 600 - int(_max_path_edges(log)) < int(lb["valid"].sum()) <= 600


def test_plane_pass_counts_its_sweep(scene, monkeypatch):
    """The sweep/* counters of a plane pass hold the reference's hits and
    successful rotations over every query of its sweep, its plane rows
    and its valid segments."""
    from gbench.reference import sweep as ref_sweep
    from gvpm_tpu_torch.ops import beam_sweep
    calls = []
    real = beam_sweep.gsweep
    monkeypatch.setattr(beam_sweep, "gsweep",
                        lambda kind, *a: calls.append(a) or real(kind, *a))
    names = ("hits", "reconnections", "rows", "segments")
    counters = [StatsCounter.get("sweep/" + k, "average") for k in names]
    before = [float(c.num) for c in counters]
    _pass(scene, "gvpm", "plane0d", beams=300)
    got = [float(c.num) - b for c, b in zip(counters, before)]
    hits = reconn = 0
    for q, qx, rows, tails, _ in calls:
        _, v, r = ref_sweep.sweep(q, qx, rows, tails,
                                  torch.arange(q.shape[0]))
        hits, reconn = hits + int(v.sum()), reconn + int(r.sum())
    valid_segments = sum(int((q[:, ref_sweep.QSLOT["valid"]] > 0.5).sum())
                         for q, *_ in calls)
    assert got[:2] == [hits, reconn] and hits > reconn > 0
    assert 0 < got[2] <= 300 and got[3] == valid_segments


def _max_path_edges(log):
    args, (_, beams) = next((a, o) for k, a, _, o in log if k == "light")
    return beams["valid"].reshape(-1, int(args[2])).sum(0).max()


def _mesh(size):
    return Mesh(rank=0, size=size, device=torch.device("cpu"),
                backend="gloo", group=None)


@pytest.mark.parametrize("volume", sorted(sppm.BEAM_VOLUMES))
@pytest.mark.parametrize("fn", ["gvpm_render_pass_sharded",
                                "gvpm_render_pass_sharded_ring",
                                "render_pass_sharded",
                                "render_pass_sharded_ring"])
def test_dist_refuses_a_beam_map_over_ranks(scene, fn, volume):
    cls = GradientConfig if fn.startswith("gvpm") else PhotonConfig
    kw = GRAD_KW if cls is GradientConfig else KW
    cfg = cls(beams=300, **kw)
    with pytest.raises(ValueError, match="beam map"):
        getattr(dist, fn)(_mesh(2), scene, cfg, volume, N_PATHS, 7, 3, 1.0,
                          1.0, 0.1)


def test_dist_one_rank_keeps_the_beam_map(scene):
    """One rank shoots every path in order: the check lets it pass."""
    dist._check_beam_map(_mesh(1), GradientConfig(beams=300), "plane0d")
    dist._check_beam_map(_mesh(2), GradientConfig(), "plane0d")
    dist._check_beam_map(_mesh(2), GradientConfig(beams=300), "distance")


def test_light_beams_are_step_major(scene, light_beams):
    """select_beams reads the beam dict as [steps, paths] flattened."""
    steps = GRAD_KW["max_depth"] + GRAD_KW["null_bounces"]
    assert light_beams["valid"].shape[0] == steps * N_PATHS
    cfg = GradientConfig(**GRAD_KW)
    _, lb = ptracer.shoot(scene, cfg, N_PATHS,
                          torch.tensor([17, 4242], dtype=torch.int64))
    assert torch.equal(lb.valid.reshape(-1), light_beams["valid"])
