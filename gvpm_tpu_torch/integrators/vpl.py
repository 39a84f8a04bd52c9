"""VPL (instant-radiosity) integrator (mirrors gvpm_tpu/integrators/vpl.py;
reference: src/integrators/vpl/vpl.cpp + librender/vpl.h generateVPLs).

Every stored light vertex of the particle tracer (ptracer.shoot) is a
virtual point light; each pixel's first diffuse hit sums the
contribution of every VPL with a clamped geometry term, plus one NEE
sample of direct light. The scatter at the VPL toward the shading point
is the shift machinery's parent-style evaluator (shift.parent_scatter).
The pixel x VPL double loop streams VPL tiles against the pixel
wavefront.
"""

from __future__ import annotations

import torch

from ..core import rng
from ..core.config import PhotonConfig
from ..core.math import coordinate_system, dot, to_local
from ..render.bsdf import eval_bsdf
from ..render.emitter import sample_direct
from ..render.visibility import segment_transmittance
from ..scene.camera import pixel_grid
from ..scene.types import Scene
from . import gatherpoint, ptracer, shift


def _tile_contrib(scene: Scene, gps, ns, s_ax, t_ax, wo_loc, v, vok,
                  clamp_dist):
    """Radiance at every pixel [n] from one tile of VPLs `v` (dict of
    flattened vertex fields [T,...]) -> [n,3]."""
    n, T = gps.p.shape[0], v["p"].shape[0]
    seg = v["p"][None, :, :] - gps.p[:, None, :]               # [n,T,3]
    d2 = torch.clamp((seg * seg).sum(-1), min=1e-12)
    wl = seg / torch.sqrt(d2)[..., None]
    cos_x = torch.abs((ns[:, None, :] * wl).sum(-1))

    def lanes(a):
        """A VPL field [T,...] -> one lane a pair [n*T,...]."""
        return a[None].expand((n,) + a.shape).reshape((n * T,) + a.shape[1:])

    # scatter at the VPL toward the pixel (importance transport)
    sc, _, ok_sc = shift.parent_scatter(
        scene, lanes(v["vtype"]), lanes(v["wi"]), lanes(v["ns"]),
        lanes(v["bsdf"]), lanes(v["med"]), -wl.reshape(-1, 3))
    sc = sc.reshape(n, T, 3)
    ok_sc = ok_sc.reshape(n, T)
    # BSDF at the pixel toward the VPL
    wl_loc = torch.stack([(s_ax[:, None] * wl).sum(-1),
                          (t_ax[:, None] * wl).sum(-1),
                          (ns[:, None] * wl).sum(-1)], dim=-1)
    f, _ = eval_bsdf(scene, gps.bsdf[:, None].expand(n, T).reshape(-1),
                     wo_loc[:, None].expand(n, T, 3).reshape(-1, 3),
                     wl_loc.reshape(-1, 3))
    f = f.reshape(n, T, 3)
    # clamped geometry term (vpl.cpp's clamp bounds the singularity)
    G = cos_x / torch.clamp(d2, min=clamp_dist * clamp_dist)
    ok = gps.valid[:, None] & vok[None, :] & ok_sc
    # visibility: one shadow ray a (pixel, VPL) pair, as one flat batch
    off = gps.p + ns * 1e-4
    tr = segment_transmittance(
        scene, off[:, None].expand(n, T, 3).reshape(-1, 3),
        v["p"][None].expand(n, T, 3).reshape(-1, 3),
        gps.med[:, None].expand(n, T).reshape(-1)).reshape(n, T, 3)
    contrib = gps.thr[:, None, :] * f * sc * v["alpha"][None, :, :] \
        * G[..., None] * tr
    contrib = torch.where(ok[..., None] & torch.isfinite(contrib), contrib,
                          0.0)
    return contrib.sum(1)


def render_pass(scene: Scene, cfg: PhotonConfig, n_paths, seed, it,
                clamp_dist=0.1, tile=128):
    """One VPL pass: each pixel's first diffuse hit shaded by every VPL
    of this pass, plus NEE direct light and the emission seen on the way.
    Returns [H,W,3]."""
    dev = scene.device
    H, W = scene.height, scene.width
    k_cam = rng.pass_key(seed, it, rng.STREAM_CAMERA, dev)
    k_light = rng.pass_key(seed, it, rng.STREAM_LIGHT, dev)
    k_nee = rng.pass_key(seed, it, rng.STREAM_NEE, dev)
    px, py = pixel_grid(scene)
    gps, _ = gatherpoint.trace(scene, cfg, k_cam, px, py)
    ns = gps.ns
    s_ax, t_ax = coordinate_system(ns)
    wo_loc = to_local(ns, s_ax, t_ax, gps.wo)

    # ---- VPL generation: every stored light vertex is a VPL ----
    lv, _ = ptracer.shoot(scene, cfg, n_paths, k_light, with_beams=False)
    pv, vmask = ptracer.flatten_vertices(lv)
    fields = ("p", "wi", "ns", "bsdf", "med", "vtype", "alpha")
    acc = torch.zeros_like(gps.thr)
    for t0 in range(0, pv.p.shape[0], tile):
        v = {k: getattr(pv, k)[t0:t0 + tile] for k in fields}
        acc = acc + _tile_contrib(scene, gps, ns, s_ax, t_ax, wo_loc, v,
                                  vmask[t0:t0 + tile], clamp_dist)
    L_vpl = acc / n_paths

    # direct light at the pixel (NEE), plus the emission seen directly
    ds = sample_direct(scene, gps.p, rng.uniform(k_nee, (H * W, 3)))
    f, _ = eval_bsdf(scene, gps.bsdf, wo_loc, to_local(ns, s_ax, t_ax,
                                                       ds.wl))
    tr = segment_transmittance(scene, gps.p + ns * 1e-4, ds.p_light,
                               gps.med)
    L_dir = gps.thr * f * tr * ds.li_over_pdf \
        * torch.abs(dot(ns, ds.wl))[..., None]
    L_dir = torch.where((gps.valid & ds.valid)[..., None], L_dir, 0.0)
    return (L_vpl + L_dir + gps.emission).reshape(H, W, 3)


def render(scene: Scene, cfg: PhotonConfig = PhotonConfig(), seed=0,
           passes=4, vpls_per_pass=64, clamp_dist=0.1, callback=None):
    """VPL render: `vpls_per_pass` light paths a pass (each yields up to
    max_depth VPLs). Returns dict(image, passes)."""
    accum = torch.zeros((scene.height, scene.width, 3), dtype=torch.float32,
                        device=scene.device)
    for it in range(passes):
        accum = accum + render_pass(scene, cfg, vpls_per_pass, seed, it,
                                    clamp_dist=clamp_dist)
        if callback is not None:
            callback(it, accum / (it + 1))
    return dict(image=accum / passes, passes=passes)
