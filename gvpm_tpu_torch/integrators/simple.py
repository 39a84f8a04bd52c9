"""Small baseline integrators: direct illumination, ambient occlusion,
and the surface path tracer alias (mirrors gvpm_tpu/integrators/simple.py;
reference: src/integrators/direct/direct.cpp, misc/ao.cpp,
path/path.cpp).
"""

from __future__ import annotations

import torch

from ..core import rng
from ..core.config import VolPathConfig
from ..core.math import coordinate_system, dot, to_local, to_world
from ..core.warp import square_to_cosine_hemisphere
from ..render.bsdf import eval_bsdf
from ..render.emitter import env_le, eval_radiance, sample_direct
from ..render.visibility import segment_transmittance
from ..scene.camera import generate_rays, pixel_grid
from ..scene.intersect import intersect, occluded
from ..scene.types import Scene
from . import volpath


def render_path(scene: Scene, cfg: VolPathConfig = VolPathConfig(),
                seed=0):
    """Surface path tracer (reference `path`): volpath shares the code."""
    return volpath.render(scene, cfg, seed=seed)


def _primary_hit(scene: Scene, seed, it):
    """The camera rays of one pass and their hits -> (key for the
    pass's second draw, d, hit, ns facing the viewer, its frame)."""
    n = scene.height * scene.width
    k_pix, k_second = rng.split(rng.pass_key(seed, it, rng.STREAM_CAMERA,
                                             scene.device), 2)
    px, py = pixel_grid(scene)
    o, d, _ = generate_rays(scene, px, py, rng.uniform(k_pix, (n, 2)))
    hit = intersect(scene, o, d)
    ns = hit.ns * torch.sign(dot(hit.ns, -d, keepdims=True))
    s_ax, t_ax = coordinate_system(ns)
    return k_second, d, hit, ns, s_ax, t_ax


def _direct_pass(scene: Scene, seed, it):
    H, W = scene.height, scene.width
    n = H * W
    k_nee, d, hit, ns, s_ax, t_ax = _primary_hit(scene, seed, it)
    L = eval_radiance(scene, hit.prim, hit.ng, -d)
    wi_loc = to_local(ns, s_ax, t_ax, -d)
    bi = torch.clamp(scene.prim_bsdf(hit.prim), 0,
                     scene.bsdf_type.shape[0] - 1)
    ds = sample_direct(scene, hit.p, rng.uniform(k_nee, (n, 3)))
    f, _ = eval_bsdf(scene, bi, wi_loc, to_local(ns, s_ax, t_ax, ds.wl))
    tr = segment_transmittance(scene, hit.p + ns * 1e-4, ds.p_light,
                               scene.cam_medium.expand(n))
    cos_s = torch.abs(dot(ns, ds.wl))
    ok = hit.valid & ds.valid
    contrib = f * ds.li_over_pdf * tr * cos_s[..., None]
    L = L + torch.where(ok[..., None], contrib, 0.0)
    return torch.where(hit.valid[..., None], L,
                       env_le(scene, d)).reshape(H, W, 3)


def render_direct(scene: Scene, spp=16, seed=0):
    """Direct illumination only (emitter hit + one NEE sample)."""
    img = torch.zeros((scene.height, scene.width, 3), dtype=torch.float32,
                      device=scene.device)
    for it in range(spp):
        img = img + _direct_pass(scene, seed, it)
    return img / spp


def _ao_pass(scene: Scene, seed, it, ray_length):
    H, W = scene.height, scene.width
    n = H * W
    k_dir, _, hit, ns, s_ax, t_ax = _primary_hit(scene, seed, it)
    wo = to_world(ns, s_ax, t_ax, square_to_cosine_hemisphere(
        rng.uniform(k_dir, (n, 2))))
    blocked = occluded(scene, hit.p + ns * 1e-3, hit.p + wo * ray_length)
    vis = torch.where(hit.valid & ~blocked, 1.0, 0.0)
    return vis[..., None].expand(n, 3).reshape(H, W, 3)


def render_ao(scene: Scene, spp=16, seed=0, ray_length=0.5):
    """Ambient occlusion (reference misc/ao.cpp)."""
    img = torch.zeros((scene.height, scene.width, 3), dtype=torch.float32,
                      device=scene.device)
    for it in range(spp):
        img = img + _ao_pass(scene, seed, it, ray_length)
    return img / spp
