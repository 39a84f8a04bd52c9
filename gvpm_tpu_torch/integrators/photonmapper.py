"""Classic two-pass photon mapper + Knaus-style PPM (mirrors
gvpm_tpu/integrators/photonmapper.py; reference:
src/integrators/photonmapper/photonmapper.cpp and ppm.cpp).

Both reuse the SPPM machinery: gather points from gatherpoint.trace,
photons from sppm.shoot_photons, the hash-grid surface gather of
estimators.surface_gather. The classic mapper splits direct light (one
NEE sample a pixel) from the indirect photon-map estimate by photon
depth, as the reference does; PPM shrinks a global radius scale with the
APA alpha schedule (ppm.cpp:75).
"""

from __future__ import annotations

import torch

from ..core import rng
from ..core.config import PhotonConfig
from ..core.math import coordinate_system, dot, to_local
from ..ops import hashgrid
from ..render.bsdf import eval_bsdf
from ..render.emitter import sample_direct
from ..render.visibility import segment_transmittance
from ..scene.camera import pixel_grid
from ..scene.types import Scene
from . import estimators, gatherpoint, ptracer, sppm


def _direct_light(scene: Scene, gps, key):
    """One NEE sample at each gather point (photonmapper.cpp's
    sampleEmitterDirect path) -> [N,3], premultiplied by gps.thr."""
    ns = gps.ns
    s_ax, t_ax = coordinate_system(ns)
    wo_loc = to_local(ns, s_ax, t_ax, gps.wo)
    ds = sample_direct(scene, gps.p, rng.uniform(key, (ns.shape[0], 3)))
    f, _ = eval_bsdf(scene, gps.bsdf, wo_loc, to_local(ns, s_ax, t_ax,
                                                       ds.wl))
    tr = segment_transmittance(
        scene, gps.p + ns * torch.sign(dot(ns, ds.wl, keepdims=True)) * 1e-4,
        ds.p_light, gps.med)
    L = gps.thr * f * tr * ds.li_over_pdf * torch.abs(
        dot(ns, ds.wl))[..., None]
    return torch.where((gps.valid & ds.valid)[..., None], L, 0.0)


def render_pass(scene: Scene, cfg: PhotonConfig, n_photons, seed, it,
                radius_scale, direct_nee=True):
    """One photon-mapping pass: NEE direct light + the indirect photon
    estimate (photons with >= 2 light bounces) at the first diffuse hit.
    Returns [H,W,3]."""
    dev = scene.device
    H, W = scene.height, scene.width
    k_cam = rng.pass_key(seed, it, rng.STREAM_CAMERA, dev)
    k_light = rng.pass_key(seed, it, rng.STREAM_LIGHT, dev)
    k_nee = rng.pass_key(seed, it, rng.STREAM_NEE, dev)
    px, py = pixel_grid(scene)
    gps, _ = gatherpoint.trace(scene, cfg, k_cam, px, py)
    photons, _ = sppm.shoot_photons(scene, cfg, n_photons, k_light,
                                    with_beams=False)
    pp = photons["p"]

    # indirect: photons that bounced at least once since emission
    indirect = (photons["vtype"] == ptracer.VERT_SURFACE) \
        & (photons["depth"] >= 2)
    r_surf = gps.radius * torch.tensor(radius_scale, dtype=torch.float32,
                                       device=dev)
    cell = 2.0 * torch.clamp(torch.where(gps.valid, r_surf, 0.0).amax(),
                             min=1e-5)
    grid = hashgrid.build(pp, indirect, scene.world_lo, cell,
                          hash_size=cfg.grid_hash_size)
    L_ind = estimators.surface_gather(
        scene, gps.replace(radius=r_surf), grid, pp, photons, n_photons,
        1.0, max_per_cell=cfg.grid_max_photons_per_cell, stencil=8)
    L_dir = _direct_light(scene, gps, k_nee) if direct_nee \
        else torch.zeros_like(L_ind)
    return (L_ind + L_dir + gps.emission).reshape(H, W, 3)


def render(scene: Scene, cfg: PhotonConfig = PhotonConfig(), seed=0,
           passes=None, progressive=False, callback=None):
    """Classic photon mapper (progressive=False: a fixed radius across
    passes, photonmapper.cpp) or Knaus-PPM (progressive=True: the global
    APA alpha schedule, ppm.cpp:75). Returns dict(image, passes)."""
    n_passes = passes if passes is not None else cfg.max_passes
    accum = torch.zeros((scene.height, scene.width, 3), dtype=torch.float32,
                        device=scene.device)
    scale = 1.0
    for it in range(n_passes):
        accum = accum + render_pass(scene, cfg, cfg.surface_photons, seed,
                                    it, scale)
        if progressive:
            scale *= sppm.radius_ratio(it, cfg.alpha) ** 0.5
        if callback is not None:
            callback(it, accum / (it + 1))
    return dict(image=accum / n_passes, passes=n_passes)


def render_ppm(scene: Scene, cfg: PhotonConfig = PhotonConfig(), seed=0,
               passes=None, callback=None):
    """Knaus-style progressive photon mapping (ppm.cpp)."""
    return render(scene, cfg, seed=seed, passes=passes, progressive=True,
                  callback=callback)
