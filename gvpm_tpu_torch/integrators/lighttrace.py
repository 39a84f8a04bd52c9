"""Light tracer: photon paths connected to the camera (mirrors
gvpm_tpu/integrators/lighttrace.py; reference: integrators/ptracer +
PathVertex::sampleSensor, vertex.h:360).

Every stored light vertex, the emitter surface and each point / spot
light is connected to the pinhole: contribution = alpha * scatter(w ->
eye) * Tr(v -> eye) * We_pixel / d^2, splatted at the projected pixel.
It checks the importance transport (emission, BSDF adjoint, media)
independently of the photon-density estimators.
"""

from __future__ import annotations

import torch

from ..core import rng
from ..core.config import PhotonConfig
from ..core.math import dot
from ..render import film
from ..render.emitter import _spot_falloff, sample_position
from ..render.visibility import segment_transmittance
from ..scene.camera import importance_weight, project
from ..scene.types import DE_DIRECTIONAL, DE_SPOT, Scene
from . import ptracer, shift


def _unit(v):
    return v / torch.clamp(torch.sqrt((v * v).sum(-1, keepdim=True)),
                           min=1e-12)


def _connect(scene: Scene, p, alpha_times_scatter, med_at_v, valid):
    """Connect points p (alpha * scatter toward the camera premultiplied)
    to the eye -> (px, py, value, ok)."""
    eye = scene.cam_to_world[:3, 3]
    seg = eye - p
    d2 = torch.clamp(dot(seg, seg), min=1e-12)
    w = seg / torch.sqrt(d2)[..., None]
    px, py, inside, _ = project(scene, p)
    we = importance_weight(scene, -w)
    tr = segment_transmittance(scene, p, eye.expand(p.shape), med_at_v)
    val = alpha_times_scatter * tr * (we / d2)[..., None]
    return px, py, val, valid & inside & (we > 0)


def render_pass(scene: Scene, cfg: PhotonConfig, n_paths, seed, it):
    """One light-tracing pass of n_paths paths -> the splatted [H,W,3]."""
    dev = scene.device
    lv, _ = ptracer.shoot(scene, cfg, n_paths,
                          rng.pass_key(seed, it, rng.STREAM_LIGHT, dev),
                          with_beams=False)
    pv, vmask = ptracer.flatten_vertices(lv)
    img = film.new_film(scene.height, scene.width, device=dev)
    eye = scene.cam_to_world[:3, 3]

    # --- direct emitter -> eye connections (path length 1) ---
    es = sample_position(scene, rng.uniform(
        rng.pass_key(seed, it, rng.STREAM_NEE, dev), (n_paths, 3)))
    wl = _unit(eye - es.p)
    cos_e = torch.clamp(dot(es.n, wl), min=0.0)
    alpha_em = es.radiance * (cos_e / torch.clamp(es.pdf_area, min=1e-20)
                              )[..., None]
    px, py, val, ok = _connect(scene, es.p + es.n * 1e-4, alpha_em,
                               scene.cam_medium.expand(n_paths),
                               es.valid & (cos_e > 0))
    film.splat(img, px, py, val / n_paths, ok)

    # --- deterministic delta-light -> eye connections (point / spot) ---
    n_de = scene.de_type.shape[0]
    if n_de > 0:
        w_eye = _unit(eye - scene.de_p)
        k_all = torch.arange(n_de, device=dev)
        fall = torch.where(scene.de_type == DE_SPOT,
                           _spot_falloff(scene, k_all, w_eye), 1.0)
        px, py, val, ok = _connect(
            scene, scene.de_p, scene.de_intensity * fall[..., None],
            scene.de_medium, scene.de_type != DE_DIRECTIONAL)
        film.splat(img, px, py, val, ok)

    # --- scatter-vertex connections ---
    wcam = _unit(eye - pv.p)
    # the scatter value at the vertex toward the camera: the shift
    # machinery's parent-style evaluator on the vertex itself
    sc, _, ok_sc = shift.parent_scatter(scene, pv.vtype, pv.wi, pv.ns,
                                        pv.bsdf, pv.med, wcam)
    med_at = torch.where(pv.vtype == ptracer.VERT_MEDIUM, pv.med,
                         scene.cam_medium)
    p_off = torch.where(
        (pv.vtype == ptracer.VERT_SURFACE)[..., None],
        pv.p + pv.ns * torch.sign(dot(pv.ns, wcam, keepdims=True)) * 1e-4,
        pv.p)
    px, py, val, ok = _connect(scene, p_off, pv.alpha * sc, med_at,
                               vmask & ok_sc & (pv.depth < cfg.max_depth))
    film.splat(img, px, py, val / n_paths, ok)
    return img


def render(scene: Scene, cfg: PhotonConfig = PhotonConfig(), seed=0,
           passes=8):
    """Light tracing over `passes` passes of max(surface_photons,
    volume_photons) paths each -> [H,W,3]."""
    img = film.new_film(scene.height, scene.width, device=scene.device)
    n = max(cfg.surface_photons, cfg.volume_photons)
    for it in range(passes):
        img = img + render_pass(scene, cfg, n, seed, it)
    return img / passes
