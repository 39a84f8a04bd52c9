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
from ..core.logging import PhaseClock, log
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


def gather_images(scene: Scene, cfg: PhotonConfig, volume, photons, beams,
                  n_emitted, key_cam, key_gather, px, py, surf_scale,
                  vol_scale, r_vol_base, timings=None, emission_scale=1.0):
    """Camera pass over a pixel slice. Returns the flat image [n,3]
    indexed by lane (one lane per pixel in px/py order). photons, beams:
    the dicts of shoot_photons (beams may be None unless volume is one
    of BEAM_VOLUMES). surf_scale, vol_scale, r_vol_base:
    floats, taken as float32 scalars (the JAX package's traced
    arguments). `timings` as in render_pass. emission_scale weighs the
    directly seen emission: a ring pass (parallel.dist) gathers the same
    camera paths against each photon partition in turn and passes
    1 / partitions, so that the emission adds up to once."""
    if volume not in VOLUME_ESTIMATORS:
        raise ValueError(volume)
    dev = scene.device
    clock = PhaseClock(dev, timings)
    f32 = dict(dtype=torch.float32, device=dev)
    n = px.shape[0]
    gps, cam_beams = gatherpoint.trace(scene, cfg, key_cam, px, py)
    clock.lap("camera_trace")
    pp = photons["p"]

    # ---- surface gather (8-stencil: cell = 2 * max radius) ----
    r_surf = gps.radius * torch.tensor(surf_scale, **f32)
    cell_surf = 2.0 * torch.clamp(
        torch.where(gps.valid, r_surf, 0.0).amax(), min=1e-5)
    grid_s = hashgrid.build(pp, photons["vtype"] == ptracer.VERT_SURFACE,
                            scene.world_lo, cell_surf,
                            hash_size=cfg.grid_hash_size)
    clock.lap("surface_grid")
    L_surf = estimators.surface_gather(
        scene, gps.replace(radius=r_surf), grid_s, pp, photons, n_emitted,
        1.0, max_per_cell=cfg.grid_max_photons_per_cell, stencil=8)
    out = L_surf + emission_scale * gps.emission
    clock.lap("surface_gather")
    if volume == "none":
        return out

    # ---- volume estimator ----
    cb = {f: getattr(cam_beams, f).reshape(
        (-1,) + getattr(cam_beams, f).shape[2:]) for f in CAMERA_FIELDS}
    # splat by lane: lane i of every step is pixel slot i
    cb["pixel"] = torch.arange(n, device=dev).repeat(cam_beams.valid.shape[0])
    # compact: valid medium segments first (a stable sort keeps the JAX
    # package's order), fixed per-pixel budget
    budget = min(cb["valid"].shape[0], n * cfg.vol_segments_per_pixel)
    order = torch.argsort((~cb["valid"]).to(torch.int8), stable=True)[:budget]
    cb = {k: v[order] for k, v in cb.items()}
    r_vol = torch.tensor(r_vol_base, **f32) * torch.tensor(vol_scale, **f32)
    max_per_cell = cfg.grid_max_photons_per_cell
    if volume in ("distance", "bre"):
        med_valid = photons["vtype"] == ptracer.VERT_MEDIUM
        grid_v = hashgrid.build(pp, med_valid, scene.medium_lo, 2.0 * r_vol,
                                hash_size=cfg.grid_hash_size)
        clock.lap("volume_grid")
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
                                      cfg.bre_knn, max_per_cell=max_per_cell)
        Lv, pix = estimators.bre_gather(
            scene, cb, grid_v, pp, photons, n_emitted, r_vol,
            max_per_cell=max_per_cell, pr=pr)
    elif volume == "beam1d":
        Lv, pix = estimators.beam_beam_gather(scene, cb, beams, n_emitted,
                                              r_vol)
    elif volume == "beam3d":
        Lv, pix = estimators.beam_point_gather(
            scene, cb, beams, n_emitted, r_vol, key_gather,
            n_samples=cfg.volume_samples, tile=cfg.beam_tile)
    else:
        planes = estimators.make_planes(scene, beams, key_gather)
        clock.lap("planes")
        Lv, pix = estimators.plane_gather(scene, cb, planes, n_emitted)
    clock.lap("volume_gather")
    out = out.index_add_(0, pix, torch.where(cb["valid"][..., None], Lv, 0.0))
    clock.lap("splat")
    return out


def render_pass(scene: Scene, cfg: PhotonConfig, volume, n_photons, seed,
                it, surf_scale, vol_scale, r_vol_base, timings=None):
    """One progressive pass; returns the pass image [H,W,3]. `timings`
    (optional dict) collects per-phase seconds, each phase ending in a
    device synchronize: light_trace, camera_trace, surface_grid,
    surface_gather, volume_grid (distance, bre), planes (plane0d),
    volume_gather, splat."""
    dev = scene.device
    H, W = scene.height, scene.width
    k_cam = rng.pass_key(seed, it, rng.STREAM_CAMERA, dev)
    k_light = rng.pass_key(seed, it, rng.STREAM_LIGHT, dev)
    k_gather = rng.pass_key(seed, it, rng.STREAM_GATHER, dev)
    clock = PhaseClock(dev, timings)
    photons, beams = shoot_photons(scene, cfg, n_photons, k_light,
                                   with_beams=volume in BEAM_VOLUMES)
    clock.lap("light_trace")
    px, py = pixel_grid(scene)
    img = gather_images(scene, cfg, volume, photons, beams, n_photons, k_cam,
                        k_gather, px, py, surf_scale, vol_scale, r_vol_base,
                        timings=timings)
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
