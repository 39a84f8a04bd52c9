"""Gather-point generation: camera paths traced to the first diffuse
vertex (mirrors gvpm_tpu/integrators/gatherpoint.py).

One lane per pixel sample; a Python loop walks every lane through
specular/null bounces in lockstep until a diffuse-like vertex is found.
Camera rays do not scatter in media; each step emits a camera-segment
record for the volume estimators. Gather radius: pixel spread x path
distance x initial_scale (gvpm_gatherpoint.h:238).
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import rng
from ..core.config import PhotonConfig
from ..core.math import coordinate_system, dot, to_local, to_world
from ..core.struct import TensorStruct
from ..render import medium as med
from ..render.bsdf import is_diffuse_like, require_ported, sample_bsdf
from ..render.emitter import eval_radiance
from ..render.visibility import medium_transition
from ..scene.camera import generate_rays
from ..scene.intersect import intersect
from ..scene.types import BSDF_NULL, Scene

RAY_EPS = 1e-4


@dataclasses.dataclass
class GatherPoints(TensorStruct):
    valid: torch.Tensor     # [N] found a diffuse vertex
    p: torch.Tensor         # [N,3]
    ns: torch.Tensor        # [N,3] shading normal
    wo: torch.Tensor        # [N,3] direction GP -> previous camera vertex
    bsdf: torch.Tensor      # [N]
    thr: torch.Tensor       # [N,3] camera throughput at the GP
    radius: torch.Tensor    # [N] gather radius (before the pass schedule)
    emission: torch.Tensor  # [N,3] directly-seen emission along the path
    pixel: torch.Tensor     # [N] flat pixel id
    depth: torch.Tensor     # [N] camera path scatter count at GP
    med: torch.Tensor       # [N] medium at the GP
    pdf_prod: torch.Tensor  # [N] product of BSDF sample pdfs to the GP


@dataclasses.dataclass
class CameraBeams(TensorStruct):
    """Medium segments of the camera paths, [S, N]."""
    valid: torch.Tensor
    o: torch.Tensor
    d: torch.Tensor
    length: torch.Tensor
    med: torch.Tensor
    thr: torch.Tensor       # camera throughput at segment start
    pixel: torch.Tensor
    spread: torch.Tensor
    pdf_prod: torch.Tensor  # camera-subpath pdf product at segment start
    depth: torch.Tensor     # camera scatter count at segment start


def trace(scene: Scene, cfg: PhotonConfig, key, px, py, rand_tile=1):
    """Trace gather points for float pixel coords px, py ([N]).

    rand_tile > 1: px/py hold `rand_tile` equal pixel groups and every
    random draw is tiled so lane i of each group sees the SAME randoms
    (the one-wavefront form of the base + 4 offset retraces)."""
    require_ported(scene)
    n = px.shape[0]
    if n % rand_tile:
        raise ValueError("rand_tile must divide the lane count")
    g = n // rand_tile
    dev = scene.device
    pix_base = (py[:g].to(torch.int64) * scene.width
                + px[:g].to(torch.int64))

    def draw(k, d2):
        u = rng.lane_uniform(k, pix_base, (d2,))
        return u.repeat(rand_tile, 1)

    k_pix, k_walk = rng.split(key, 2)
    o, d, spread = generate_rays(scene, px, py, draw(k_pix, 2))
    pixel = py.to(torch.int64) * scene.width + px.to(torch.int64)
    f32 = dict(dtype=torch.float32, device=dev)
    zeros3 = torch.zeros((n, 3), **f32)
    cur_med = scene.cam_medium.expand(n)
    thr = torch.ones((n, 3), **f32)
    dist = torch.zeros((n,), **f32)
    pdfp = torch.ones((n,), **f32)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    emission = zeros3
    depth = torch.zeros((n,), dtype=torch.int64, device=dev)
    gp = dict(valid=torch.zeros_like(active), p=zeros3, ns=zeros3,
              wo=zeros3, bsdf=torch.zeros_like(depth), thr=zeros3,
              radius=torch.zeros_like(dist), depth=torch.zeros_like(depth),
              med=cur_med, pdf_prod=torch.ones_like(dist))
    step_keys = rng.split(k_walk, cfg.max_cam_depth)
    beams = []
    for step in range(cfg.max_cam_depth):
        hit = intersect(scene, o, d)
        alive_hit = active & hit.valid
        seg_len = torch.where(hit.valid, hit.t, 0.0)
        beams.append(dict(
            valid=active & (cur_med >= 0) & (seg_len > 1e-6), o=o, d=d,
            length=seg_len, med=cur_med, thr=thr, pixel=pixel,
            spread=spread, pdf_prod=pdfp, depth=depth))

        thr_h = thr * med.transmittance(scene, cur_med, seg_len)
        dist_h = dist + seg_len
        Le = eval_radiance(scene, hit.prim, hit.ng, -d)
        emission = emission + torch.where(alive_hit[..., None],
                                          thr_h * Le, 0.0)
        bi = torch.clamp(scene.prim_bsdf(hit.prim), 0,
                         scene.bsdf_type.shape[0] - 1)
        is_null = scene.bsdf_type[bi] == BSDF_NULL
        found = alive_hit & is_diffuse_like(scene, bi,
                                            cfg.bounce_roughness) & ~is_null
        f3 = found[..., None]
        ns = hit.ns
        gp = dict(
            valid=torch.where(found, True, gp["valid"]),
            p=torch.where(f3, hit.p, gp["p"]),
            ns=torch.where(f3, ns, gp["ns"]),
            wo=torch.where(f3, -d, gp["wo"]),
            bsdf=torch.where(found, bi, gp["bsdf"]),
            thr=torch.where(f3, thr_h, gp["thr"]),
            radius=torch.where(found, spread * dist_h * cfg.initial_scale,
                               gp["radius"]),
            depth=torch.where(found, depth + 1, gp["depth"]),
            med=torch.where(found, cur_med, gp["med"]),
            pdf_prod=torch.where(found, pdfp, gp["pdf_prod"]))

        # continue through specular / null surfaces
        s_ax, t_ax = coordinate_system(ns)
        wi_loc = to_local(ns, s_ax, t_ax, -d)
        bs = sample_bsdf(scene, bi, wi_loc, draw(step_keys[step], 3))
        wo_w = to_world(ns, s_ax, t_ax, bs.wo)
        cont = alive_hit & ~found & bs.valid
        c3 = cont[..., None]
        crossed = dot(wo_w, hit.ng) * dot(-d, hit.ng) < 0.0
        cur_med = torch.where(cont & crossed, medium_transition(
            scene, hit.prim, hit.ng, wo_w), cur_med)
        o = torch.where(c3, hit.p + hit.ng * torch.sign(
            dot(hit.ng, wo_w, keepdims=True)) * RAY_EPS, o)
        d = torch.where(c3, wo_w, d)
        thr = torch.where(c3, thr_h * bs.weight, thr)
        pdfp = torch.where(cont, pdfp * torch.clamp(bs.pdf, min=1e-20),
                           pdfp)
        dist = torch.where(cont, dist_h, dist)
        active = cont
        depth = depth + (cont & ~is_null).to(torch.int64)

    gps = GatherPoints(
        valid=gp["valid"], p=gp["p"], ns=gp["ns"], wo=gp["wo"],
        bsdf=gp["bsdf"], thr=gp["thr"],
        radius=torch.clamp(gp["radius"], min=1e-5), emission=emission,
        pixel=pixel, depth=gp["depth"], med=gp["med"],
        pdf_prod=gp["pdf_prod"])
    cbs = CameraBeams(**{f: torch.stack([b[f] for b in beams])
                         for f in beams[0]})
    return gps, cbs
