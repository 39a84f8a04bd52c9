"""Progressive photon mapping with volumetric estimators, primal domain
(mirrors gvpm_tpu/integrators/sppm.py).

reference: SPPMIntegrator (photonmapper/sppm.cpp:161): per pass —
regenerate gather points, shoot photons, build the hash grids, run the
selected volume estimator, accumulate; APA (average-per-pass) radius
schedule scaleVolumeAPA (sppm.cpp:255, gvpm.cpp:181-215).

  shoot_photons(...)  -> flattened photon / beam SoA    (light pass)
  gather_images(...)  -> per-pixel radiance for a pixel slice (camera pass)

Every volume estimator of the JAX package: "none", "distance", "bre"
(with per-photon kNN radii when cfg.bre_knn > 0), "beam1d", "beam3d"
and "plane0d"; the beam and plane pair sweeps run the CUDA kernel of
ops/beam_sweep.py on the card.
"""

from __future__ import annotations

import torch

from ..core import rng
from ..core.config import PhotonConfig
from ..core.logging import PhaseClock, StatsCounter, log, span
from ..ops import hashgrid
from ..scene.camera import pixel_grid
from ..scene.types import Scene
from ..utils import checkpoint as ckpt
from . import estimators, gatherpoint, ptracer

VOLUME_ESTIMATORS = ("none", "distance", "bre", "beam1d",
                     "beam3d", "plane0d")
# the estimators that read the light pass's beams
BEAM_VOLUMES = ("beam1d", "beam3d", "plane0d")
CAMERA_FIELDS = ("valid", "o", "d", "length", "med", "thr")
# the beam dict of the light pass (gvpm_tpu/integrators/sppm.py:64-73)
BEAM_FIELDS = ("valid", "o", "d", "length", "alpha", "med", "parent_p",
               "parent_type", "parent_wi", "parent_ns", "parent_bsdf",
               "parent_med", "scatter_base", "pdf_dir_base",
               "reconnectable", "parent_idx", "at_origin")

# kernel dimension per estimator -> APA radius exponent 1/dim
# (reference: volume_utils.h:23-53 kernel-dimension helpers)
KERNEL_DIM = {"distance": 3, "bre": 2, "beam1d": 1, "beam3d": 3,
              "plane0d": 0}


def radius_ratio(it, alpha):
    """APA per-pass radius ratio after pass `it` (0-based):
    (k+alpha)/(k+1) with k = it+1 (gvpm.cpp:181-215)."""
    k = it + 1
    return (k + alpha) / (k + 1.0)


def next_scales(it, cfg: PhotonConfig, dim, surf_scale, vol_scale):
    """The APA radius scales after pass `it` (gvpm.cpp:875,983,1078): the
    surface radius shrinks by ratio^(1/2), a volume of kernel dimension
    dim > 0 by ratio^(1/dim)."""
    ratio = radius_ratio(it, cfg.alpha)
    surf_scale *= ratio ** 0.5
    if dim > 0:
        vol_scale *= ratio ** (1.0 / dim)
    return surf_scale, vol_scale


def base_volume_radius(scene: Scene, cfg: PhotonConfig):
    ext = scene.medium_hi - scene.medium_lo
    diag = float(torch.sqrt((ext * ext).sum()))
    return 0.02 * diag * cfg.initial_scale_volume


def shoot_photons(scene: Scene, cfg: PhotonConfig, n_photons, key,
                  with_beams=True, path_offset=None):
    """Light pass -> (photon dict, beam dict), both flattened [S*P]. The
    beam dict carries the shift caches of the beam reconnection; it is
    None when with_beams is false (the pass reads no beam).
    path_offset: see ptracer.shoot (sharded shooting)."""
    lv, lb = ptracer.shoot(scene, cfg, n_photons, key, with_beams=with_beams,
                           path_offset=path_offset)
    pv, _ = ptracer.flatten_vertices(lv)
    if lb is None:
        return pv.asdict(), None
    lb = lb.map(lambda a: a.reshape((-1,) + a.shape[2:]))
    return pv.asdict(), {f: getattr(lb, f) for f in BEAM_FIELDS}


def light_lanes(photons):
    """The light pass's lanes, as int64 device tensors:
    light_lanes_live, the (step, path) records of shoot_photons' photon
    dict that hold a vertex (vtype not VERT_NONE), and light_lanes,
    steps x paths. Their ratio is the share of the lockstep walk's lanes
    that did useful work."""
    vt = photons["vtype"]
    return dict(light_lanes_live=(vt != ptracer.VERT_NONE).sum(),
                light_lanes=torch.full((), vt.numel(), dtype=torch.int64,
                                       device=vt.device))


def select_beams(beams, n_paths, budget):
    """The pass's beam map (LTBeamMap::tryAppendLT, gvpm_beams.h:54-84;
    its size is the `beams` setting, photon_proc.h:17 / photon_proc.cpp as
    SURVEY.md cites them): the light paths are taken in shooting order, by
    path index, and each path's valid medium edges (its beams, in depth
    order) are counted; whole paths are kept from the start of the pass
    while the running count stays at most `budget`, so the first path
    whose beams would pass it, and every later path, is left out. The
    beam and plane estimators then divide by the kept paths, not by the
    pass's light paths: the beam map holds those paths' beams and no
    other. Surface photons and volume photons are not touched.

    beams: shoot_photons' beam dict (flattened [S * n_paths], step-major);
    budget > 0. Returns (the kept beams as a dict of min(budget, S *
    n_paths) rows, path-major: the kept beams first, then rows with
    `valid` false; the kept paths, an int64 device tensor, at least 1: a
    budget below the first path's edges keeps no beam, and the estimate
    is 0). Nothing is read back to the host. The StatsCounters beams/kept
    and beams/paths (kind average) count the kept beams and paths of each
    call."""
    valid = beams["valid"].reshape(-1, n_paths)            # [S, P]
    n_steps = valid.shape[0]
    dev = valid.device
    keep_path = torch.cumsum(valid.sum(0), 0) <= budget    # a prefix
    kept = (valid & keep_path[None]).t().reshape(-1)       # path-major
    n_rows = min(budget, kept.shape[0])
    n_kept = kept.sum()
    # step-major slot of each path-major (path, step), scattered to its
    # rank among the kept beams (the others to a spare last row)
    slot = (torch.arange(n_steps, device=dev)[None] * n_paths
            + torch.arange(n_paths, device=dev)[:, None]).reshape(-1)
    rank = torch.where(kept, torch.cumsum(kept, 0) - 1, n_rows)
    src = torch.zeros(n_rows + 1, dtype=torch.int64, device=dev)
    src = src.scatter(0, rank, slot)[:n_rows]
    out = {k: v[src] for k, v in beams.items()}
    out["valid"] = torch.arange(n_rows, device=dev) < n_kept
    n_beam_paths = keep_path.sum()
    StatsCounter.get("beams/kept", "average").add(n_kept)
    StatsCounter.get("beams/paths", "average").add(n_beam_paths)
    return out, n_beam_paths.clamp(min=1)


def uses_beam_map(cfg: PhotonConfig, volume):
    """Whether a pass of `volume` reads a beam map: a beam or plane volume
    with cfg.beams > 0."""
    return volume in BEAM_VOLUMES and cfg.beams > 0


def beam_map(cfg: PhotonConfig, volume, beams, n_paths, clock):
    """The beams that a pass's volume estimate reads and the light paths
    it divides by: select_beams' map, in clock's span beam_select, where
    uses_beam_map; else `beams` and `n_paths` as they are."""
    if not uses_beam_map(cfg, volume):
        return beams, n_paths
    with clock.span("beam_select"):
        return select_beams(beams, n_paths, cfg.beams)


def gather_images(scene: Scene, cfg: PhotonConfig, volume, photons, beams,
                  n_emitted, key_cam, key_gather, px, py, surf_scale,
                  vol_scale, r_vol_base, timings=None, emission_scale=1.0):
    """Camera pass over a pixel slice. Returns the flat image [n,3]
    indexed by lane (one lane per pixel in px/py order). photons, beams:
    the dicts of shoot_photons (beams may be None unless volume is one
    of BEAM_VOLUMES). surf_scale, vol_scale, r_vol_base:
    floats, taken as float32 scalars (the JAX package's traced
    arguments). With cfg.beams > 0 the beam and plane volumes read the
    beam map of select_beams (the span beam_select) and divide by its
    paths. `timings` as in render_pass. emission_scale weighs the
    directly seen emission: a ring pass (parallel.dist) gathers the same
    camera paths against each photon partition in turn and passes
    1 / partitions, so that the emission adds up to once."""
    if volume not in VOLUME_ESTIMATORS:
        raise ValueError(volume)
    dev = scene.device
    clock = PhaseClock(dev, timings)
    f32 = dict(dtype=torch.float32, device=dev)
    n = px.shape[0]
    with clock.span("camera_trace"):
        gps, cam_beams = gatherpoint.trace(scene, cfg, key_cam, px, py)

    # ---- surface gather (8-stencil: cell = 2 * max radius) ----
    with clock.span("surface_grid"):
        pp = photons["p"]
        r_surf = gps.radius * torch.tensor(surf_scale, **f32)
        cell_surf = 2.0 * torch.clamp(
            torch.where(gps.valid, r_surf, 0.0).amax(), min=1e-5)
        grid_s = hashgrid.build(pp, photons["vtype"] == ptracer.VERT_SURFACE,
                                scene.world_lo, cell_surf,
                                hash_size=cfg.grid_hash_size)
    with clock.span("surface_gather"):
        L_surf = estimators.surface_gather(
            scene, gps.replace(radius=r_surf), grid_s, pp, photons,
            n_emitted, 1.0, max_per_cell=cfg.grid_max_photons_per_cell,
            stencil=8)
        out = L_surf + emission_scale * gps.emission
    if volume == "none":
        return out
    beams, n_vol = beam_map(cfg, volume, beams, n_emitted, clock)

    # ---- volume estimator: the segments' compaction is the first
    # span's, the grid's (distance, bre), the planes' (plane0d) or the
    # gather's (the beams) ----
    first = dict(distance="volume_grid", bre="volume_grid",
                 plane0d="planes").get(volume, "volume_gather")
    max_per_cell = cfg.grid_max_photons_per_cell
    with clock.span(first):
        cb = {f: getattr(cam_beams, f).reshape(
            (-1,) + getattr(cam_beams, f).shape[2:]) for f in CAMERA_FIELDS}
        # splat by lane: lane i of every step is pixel slot i
        cb["pixel"] = torch.arange(n, device=dev).repeat(
            cam_beams.valid.shape[0])
        # compact: valid medium segments first (a stable sort keeps the
        # JAX package's order), fixed per-pixel budget
        budget = min(cb["valid"].shape[0], n * cfg.vol_segments_per_pixel)
        order = torch.argsort((~cb["valid"]).to(torch.int8),
                              stable=True)[:budget]
        cb = {k: v[order] for k, v in cb.items()}
        r_vol = torch.tensor(r_vol_base, **f32) \
            * torch.tensor(vol_scale, **f32)
        if volume in ("distance", "bre"):
            med_valid = photons["vtype"] == ptracer.VERT_MEDIUM
            grid_v = hashgrid.build(pp, med_valid, scene.medium_lo,
                                    2.0 * r_vol, hash_size=cfg.grid_hash_size)
        elif volume == "plane0d":
            planes = estimators.make_planes(scene, beams, key_gather)
    with clock.span("volume_gather"):
        if volume == "distance":
            Lv, pix = estimators.volume_distance_gather(
                scene, cb, grid_v, pp, photons, n_emitted, r_vol, key_gather,
                n_samples=cfg.volume_samples, max_per_cell=max_per_cell,
                stencil=8)
        elif volume == "bre":
            pr = None
            if cfg.bre_knn > 0:
                # per-photon radii from the local density (bre.cpp:29-93)
                pr = estimators.knn_radii(grid_v, pp, med_valid, r_vol,
                                          cfg.bre_knn,
                                          max_per_cell=max_per_cell)
            Lv, pix = estimators.bre_gather(
                scene, cb, grid_v, pp, photons, n_emitted, r_vol,
                max_per_cell=max_per_cell, pr=pr)
        elif volume == "beam1d":
            Lv, pix = estimators.beam_beam_gather(scene, cb, beams,
                                                  n_vol, r_vol)
        elif volume == "beam3d":
            Lv, pix = estimators.beam_point_gather(
                scene, cb, beams, n_vol, r_vol, key_gather,
                n_samples=cfg.volume_samples, tile=cfg.beam_tile)
        else:
            Lv, pix = estimators.plane_gather(scene, cb, planes, n_vol)
    with clock.span("splat"):
        out = out.index_add_(0, pix,
                             torch.where(cb["valid"][..., None], Lv, 0.0))
    return out


def render_pass(scene: Scene, cfg: PhotonConfig, volume, n_photons, seed,
                it, surf_scale, vol_scale, r_vol_base, timings=None):
    """One progressive pass, the span `pass`; returns the pass image
    [H,W,3]. `timings` (optional dict) collects the seconds of its spans,
    each ending in a device synchronize: light_trace, camera_trace,
    surface_grid, surface_gather, beam_select (a beam or plane volume
    with cfg.beams > 0), volume_grid (distance, bre), planes (plane0d),
    volume_gather, splat."""
    with span("pass"):
        dev = scene.device
        H, W = scene.height, scene.width
        k_cam = rng.pass_key(seed, it, rng.STREAM_CAMERA, dev)
        k_light = rng.pass_key(seed, it, rng.STREAM_LIGHT, dev)
        k_gather = rng.pass_key(seed, it, rng.STREAM_GATHER, dev)
        clock = PhaseClock(dev, timings)
        with clock.span("light_trace"):
            photons, beams = shoot_photons(
                scene, cfg, n_photons, k_light,
                with_beams=volume in BEAM_VOLUMES)
        px, py = pixel_grid(scene)
        img = gather_images(scene, cfg, volume, photons, beams, n_photons,
                            k_cam, k_gather, px, py, surf_scale, vol_scale,
                            r_vol_base, timings=timings)
    return img.reshape(H, W, 3)


def render(scene: Scene, cfg: PhotonConfig = PhotonConfig(),
           volume="distance", seed=0, passes=None, callback=None,
           checkpoint_path=None, checkpoint_every=10, timings=None):
    """Progressive APA render loop. Returns dict(image=[H,W,3] averaged,
    passes=n). checkpoint_path: atomic NPZ save every `checkpoint_every`
    passes and at the end, and resume from an existing one.
    `callback(it, image_so_far)` runs after each pass."""
    n_passes = passes if passes is not None else cfg.max_passes
    n_photons = max(cfg.volume_photons, cfg.surface_photons)
    r_vol_base = base_volume_radius(scene, cfg)
    dim = KERNEL_DIM.get(volume, 3)
    dev = scene.device
    accum = torch.zeros((scene.height, scene.width, 3), dtype=torch.float32,
                        device=dev)
    surf_scale, vol_scale = 1.0, 1.0
    it0 = 0
    if checkpoint_path:
        state = ckpt.load(checkpoint_path)
        if state is not None:
            it0, bufs, scal = state
            it0 += 1
            accum = torch.as_tensor(bufs["accum"], dtype=torch.float32,
                                    device=dev)
            surf_scale = scal["surf_scale"]
            vol_scale = scal["vol_scale"]
            log.info("resumed from %s at pass %d", checkpoint_path, it0)
    for it in range(it0, n_passes):
        accum = accum + render_pass(scene, cfg, volume, n_photons, seed, it,
                                    surf_scale, vol_scale, r_vol_base,
                                    timings=timings)
        # APA radius reduction AFTER the pass
        surf_scale, vol_scale = next_scales(it, cfg, dim, surf_scale,
                                            vol_scale)
        if checkpoint_path and ((it + 1) % checkpoint_every == 0
                                or it == n_passes - 1):
            ckpt.save(checkpoint_path, it, dict(accum=accum.cpu().numpy()),
                      dict(surf_scale=surf_scale, vol_scale=vol_scale))
        if callback is not None:
            callback(it, accum / (it + 1))
    return dict(image=accum / n_passes, passes=n_passes)
