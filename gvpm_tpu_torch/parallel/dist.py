"""Multi-GPU SPPM and G-VPM: pixel rows sharded over the ranks, light
paths sharded for shooting (mirrors gvpm_tpu/parallel/dist.py).

Every function here runs on every rank of a `mesh.Mesh` (SPMD: each
rank calls it with the same arguments, as parallel.launch does) and
returns the whole film on every rank.

  light pass      each rank shoots n_photons / ranks paths with the SAME
                  key at its global path offset (rng.lane_uniform), so
                  the union of the partitions is one shoot of all paths
                  at any rank count
  photon map      all-gathered, rank-major: rank d's [S * per] rows at
                  [d * S * per, (d + 1) * S * per); or, in the ring
                  variants, never gathered: the partitions go round the
                  ring one hop a step
  camera pass     each rank its H / ranks pixel rows; camera and gather
                  randoms are keyed by pixel id, so a rank needs no key
                  of its own
  film            each rank's rows all-gathered; the gradients are
                  assembled and solved on the whole film (no halo)

The all-gathered photons keep the JAX package's layout row for row, but
their provenance is made global here: the light pass records
`parent_idx` as the shard-local flat id s * per + i and `path` as the
shard-local lane, and the gather adds d * S * per to every parent_idx
>= 0 (photons and beams) and d * per to `path`. The JAX package does
not, so its manifold chains walk into rank 0's rows at more than one
device (ROADMAP section 3). A ring partition is resident whole, so its
shard-local ids stay right.
"""

from __future__ import annotations

import torch

from ..core import rng
from ..core.logging import PhaseClock
from ..integrators import gvpm, sppm
from ..ops import poisson
from .mesh import Mesh, all_gather_rows, all_reduce_sum, rotate


def _check_split(mesh: Mesh, scene, n_photons):
    H = scene.height
    if H % mesh.size or n_photons % mesh.size:
        raise ValueError(f"H % n and n_photons % n must be 0: a film of "
                         f"{H} rows and {n_photons} paths do not split "
                         f"over {mesh.size} ranks")


def _keys(seed, it, device):
    return (rng.pass_key(seed, it, rng.STREAM_LIGHT, device),
            rng.pass_key(seed, it, rng.STREAM_CAMERA, device),
            rng.pass_key(seed, it, rng.STREAM_GATHER, device))


def _rank_pixels(mesh: Mesh, scene):
    """(px, py) of this rank's pixel rows, row-major (float32)."""
    rows, W = scene.height // mesh.size, scene.width
    py, px = torch.meshgrid(
        torch.arange(mesh.rank * rows, (mesh.rank + 1) * rows,
                     device=scene.device, dtype=torch.float32),
        torch.arange(W, device=scene.device, dtype=torch.float32),
        indexing="ij")
    return px.reshape(-1), py.reshape(-1)


def _shoot(mesh: Mesh, scene, cfg, n_photons, key, with_beams):
    per = n_photons // mesh.size
    return sppm.shoot_photons(scene, cfg, per, key, with_beams=with_beams,
                              path_offset=mesh.rank * per)


def remap_provenance(records, per, n):
    """Rank-major all-gathered light records made global: rank d's rows
    get d * S * per added to every parent_idx >= 0 and, where the dict
    has it, d * per to `path`."""
    pi = records["parent_idx"]
    rows = pi.shape[0] // n                       # S * per, one rank's
    d = torch.arange(pi.shape[0], device=pi.device) // rows
    out = dict(records, parent_idx=torch.where(pi >= 0, pi + d * rows, pi))
    if "path" in records:
        out["path"] = records["path"] + d * per
    return out


def gather_photons(mesh: Mesh, scene, cfg, n_photons, key, with_beams,
                   timings=None):
    """This rank's share of the light pass, all-gathered: (photons,
    beams) of all n_photons paths, rank-major, provenance global (see
    the module docstring); beams None unless with_beams. `timings`
    receives the laps light_trace and allgather."""
    clock = PhaseClock(scene.device, timings)
    photons, beams = _shoot(mesh, scene, cfg, n_photons, key, with_beams)
    clock.lap("light_trace")
    per = n_photons // mesh.size
    photons = remap_provenance(all_gather_rows(mesh, photons), per,
                               mesh.size)
    if beams is not None:
        beams = remap_provenance(all_gather_rows(mesh, beams), per,
                                 mesh.size)
    clock.lap("allgather")
    return photons, beams


def _film(mesh: Mesh, scene, img, timings):
    clock = PhaseClock(scene.device, timings)
    out = all_gather_rows(mesh, {"img": img})["img"]
    clock.lap("film")
    return out.reshape(scene.height, scene.width, 3)


def render_pass_sharded(mesh: Mesh, scene, cfg, volume, n_photons, seed,
                        it, surf_scale, vol_scale, r_vol_base, timings=None):
    """One progressive SPPM pass over the ranks; returns the pass image
    [H,W,3] on every rank. Requires H % ranks == 0 and n_photons % ranks
    == 0. `timings` as in sppm.render_pass, plus allgather and film."""
    _check_split(mesh, scene, n_photons)
    k_light, k_cam, k_gather = _keys(seed, it, scene.device)
    photons, beams = gather_photons(mesh, scene, cfg, n_photons, k_light,
                                    volume in sppm.BEAM_VOLUMES, timings)
    px, py = _rank_pixels(mesh, scene)
    img = sppm.gather_images(scene, cfg, volume, photons, beams, n_photons,
                             k_cam, k_gather, px, py, surf_scale, vol_scale,
                             r_vol_base, timings=timings)
    return _film(mesh, scene, img, timings)


def render_pass_sharded_ring(mesh: Mesh, scene, cfg, volume, n_photons,
                             seed, it, surf_scale, vol_scale, r_vol_base,
                             timings=None):
    """render_pass_sharded with the photon map never gathered: each rank
    gathers its rows against the resident partition, then the partitions
    go one hop round the ring; after `ranks` steps every partition has
    visited every rank. The same gather key every step makes the sum
    equal the all-gather pass for estimators linear in the photons, and
    the directly seen emission is weighed 1 / ranks a step. A photon
    memory of 2 / ranks of the map a rank. Not for `bre` with
    cfg.bre_knn > 0: kNN radii from a partition's density are biased."""
    _check_split(mesh, scene, n_photons)
    if volume == "bre" and cfg.bre_knn:
        raise ValueError(
            "render_pass_sharded_ring: bre_knn radii are computed from "
            "the local photon partition and would be biased; use "
            "render_pass_sharded (all-gather) or bre_knn=0")
    k_light, k_cam, k_gather = _keys(seed, it, scene.device)
    clock = PhaseClock(scene.device, timings)
    photons, beams = _shoot(mesh, scene, cfg, n_photons, k_light,
                            volume in sppm.BEAM_VOLUMES)
    clock.lap("light_trace")
    px, py = _rank_pixels(mesh, scene)
    img = 0.0
    for step in range(mesh.size):
        if step:
            clock = PhaseClock(scene.device, timings)
            photons = rotate(mesh, photons)
            beams = beams if beams is None else rotate(mesh, beams)
            clock.lap("ring")
        img = img + sppm.gather_images(
            scene, cfg, volume, photons, beams, n_photons, k_cam, k_gather,
            px, py, surf_scale, vol_scale, r_vol_base, timings=timings,
            emission_scale=1.0 / mesh.size)
    return _film(mesh, scene, img, timings)


def _rounded(cfg, mesh):
    n = max(cfg.volume_photons, cfg.surface_photons)
    return (n + mesh.size - 1) // mesh.size * mesh.size


def render(mesh: Mesh, scene, cfg, volume="distance", seed=0, passes=None,
           timings=None):
    """Sharded progressive APA SPPM render: dict(image=[H,W,3] averaged,
    passes=n) on every rank. n_photons is rounded up to a multiple of the
    rank count. `timings` as in render_pass_sharded, summed over the
    passes."""
    n_passes = passes if passes is not None else cfg.max_passes
    n_photons = _rounded(cfg, mesh)
    r_vol_base = sppm.base_volume_radius(scene, cfg)
    dim = sppm.KERNEL_DIM.get(volume, 3)
    accum = torch.zeros((scene.height, scene.width, 3), dtype=torch.float32,
                        device=scene.device)
    surf_scale, vol_scale = 1.0, 1.0
    for it in range(n_passes):
        accum = accum + render_pass_sharded(
            mesh, scene, cfg, volume, n_photons, seed, it, surf_scale,
            vol_scale, r_vol_base, timings=timings)
        surf_scale, vol_scale = sppm.next_scales(it, cfg, dim, surf_scale,
                                                 vol_scale)
    return dict(image=accum / n_passes, passes=n_passes)


def _assemble(mesh: Mesh, scene, p, S, W, stats, timings):
    """The rows' unassembled buffers all-gathered into the film, the
    gradients assembled on it (computeGradient's cross-pixel differences
    need no halo then), the stats summed over the ranks."""
    clock = PhaseClock(scene.device, timings)
    film = all_gather_rows(mesh, dict(p=p, S=S.transpose(0, 1),
                                      W=W.transpose(0, 1)))
    stats = all_reduce_sum(mesh, stats)
    clock.lap("film")
    primal, gx, gy = gvpm.assemble_gradients(
        film["p"], film["S"].transpose(0, 1), film["W"].transpose(0, 1),
        scene.height, scene.width)
    return primal, gx, gy, stats


def _gradient_setup(mesh: Mesh, scene, cfg, volume, n_photons):
    """Whether the pass reads the beams, after the checks of a pass."""
    _check_split(mesh, scene, n_photons)
    gvpm.prepare_pass(scene)
    return gvpm.reads_beams(cfg, volume)


def gvpm_render_pass_sharded(mesh: Mesh, scene, cfg, volume, n_photons,
                             seed, it, surf_scale, vol_scale, r_vol_base,
                             timings=None):
    """One G-VPM gradient pass over the ranks: the photon map
    all-gathered, each rank the whole 5-way gradient gather
    (gvpm.pass_buffers) for its pixel rows. Returns (primal, gx, gy
    [H,W,3], stats) on every rank, stats (visits, shift_ok, win_dropped,
    me_dropped, me_pairs) summed over the ranks. `timings` as in
    gvpm.render_pass, plus allgather and film."""
    with_beams = _gradient_setup(mesh, scene, cfg, volume, n_photons)
    k_light, k_cam, k_gather = _keys(seed, it, scene.device)
    photons, beams = gather_photons(mesh, scene, cfg, n_photons, k_light,
                                    with_beams, timings)
    px, py = _rank_pixels(mesh, scene)
    p, S, W, stats = gvpm.pass_buffers(
        scene, cfg, volume, n_photons, photons, beams, k_cam, k_gather, px,
        py, gvpm.pixel_border(scene, px, py), surf_scale, vol_scale,
        r_vol_base, timings=timings)
    return _assemble(mesh, scene, p, S, W, stats, timings)


def gvpm_render_pass_sharded_ring(mesh: Mesh, scene, cfg, volume,
                                  n_photons, seed, it, surf_scale, vol_scale,
                                  r_vol_base, timings=None):
    """gvpm_render_pass_sharded with the partitions rotated round the ring
    instead of all-gathered (render_pass_sharded_ring's memory model for
    the gradient pass). The terms linear in the photons (the gathers and
    the shift buffers) add up over the steps exactly; the directly seen
    emission is weighed 1 / ranks a step. The camera paths are traced
    again every step. A cell grid's row cap (grid_surface_rows,
    grid_volume_rows) applies to the resident partition: size it so that
    it drops nothing (win_dropped counts what it drops)."""
    with_beams = _gradient_setup(mesh, scene, cfg, volume, n_photons)
    k_light, k_cam, k_gather = _keys(seed, it, scene.device)
    clock = PhaseClock(scene.device, timings)
    photons, beams = _shoot(mesh, scene, cfg, n_photons, k_light,
                            with_beams)
    clock.lap("light_trace")
    px, py = _rank_pixels(mesh, scene)
    border = gvpm.pixel_border(scene, px, py)
    acc = None
    for step in range(mesh.size):
        if step:
            clock = PhaseClock(scene.device, timings)
            photons = rotate(mesh, photons)
            beams = beams if beams is None else rotate(mesh, beams)
            clock.lap("ring")
        out = gvpm.pass_buffers(
            scene, cfg, volume, n_photons, photons, beams, k_cam, k_gather,
            px, py, border, surf_scale, vol_scale, r_vol_base,
            timings=timings, emission_scale=1.0 / mesh.size)
        acc = out if acc is None else (
            acc[0] + out[0], acc[1] + out[1], acc[2] + out[2],
            {k: acc[3][k] + out[3][k] for k in acc[3]})
    return _assemble(mesh, scene, *acc, timings)


def gvpm_render(mesh: Mesh, scene, cfg, volume="distance", seed=0,
                passes=None, timings=None):
    """Sharded progressive G-VPM render and screened-Poisson
    reconstruction: dict(image, primal, gx, gy, passes) on every rank.
    `timings` as in gvpm_render_pass_sharded, summed over the passes,
    plus the solve."""
    n_passes = passes if passes is not None else cfg.max_passes
    n_photons = _rounded(cfg, mesh)
    r_vol_base = sppm.base_volume_radius(scene, cfg)
    dim = sppm.KERNEL_DIM.get(volume, 3)
    acc = [torch.zeros((scene.height, scene.width, 3), dtype=torch.float32,
                       device=scene.device) for _ in range(3)]
    surf_scale, vol_scale = 1.0, 1.0
    for it in range(n_passes):
        p, gx, gy, _ = gvpm_render_pass_sharded(
            mesh, scene, cfg, volume, n_photons, seed, it, surf_scale,
            vol_scale, r_vol_base, timings=timings)
        acc = [acc[0] + p, acc[1] + gx, acc[2] + gy]
        surf_scale, vol_scale = sppm.next_scales(it, cfg, dim, surf_scale,
                                                 vol_scale)
    primal, gx, gy = [a / n_passes for a in acc]
    clock = PhaseClock(scene.device, timings)
    recon = poisson.solve(primal, gx, gy, alpha=cfg.recon_alpha,
                          iters=cfg.recon_iters,
                          irls_iters=cfg.recon_irls_iters, l1=cfg.recon_l1)
    clock.lap("solve")
    return dict(image=recon, primal=primal, gx=gx, gy=gy, passes=n_passes)
