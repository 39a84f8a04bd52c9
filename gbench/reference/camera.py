"""Plain reference of the camera pass: for a sample of pixels, the path
from the pinhole through the pixel (at an in-pixel offset drawn from the
pixel's own stream) and through the mirror and the null boundaries to
the first diffuse surface, the gather point; the medium segments it
crosses on the way, one a step; and the same for each of the four
neighbouring pixels with the base pixel's draws (the offset paths of the
gradient shifts).
"""

from __future__ import annotations

import torch

from . import rng
from . import scene as rs
from .light import sample_surface
from .scene import dot, normalize

OFFSETS = ((1, 0), (-1, 0), (0, 1), (0, -1))
GP_EXACT = ("valid", "depth", "med", "bsdf")
GP_FLOAT = ("p", "ns", "wo", "thr", "radius", "emission", "pdf_prod")
SEG_EXACT = ("valid", "med", "depth")
SEG_FLOAT = ("o", "d", "length", "thr", "spread", "pdf_prod")


def rays(sc, px, py, u):
    """Pinhole rays through (px + u0, py + u1) -> (o, d, spread)."""
    W, H = sc["width"], sc["height"]
    th = sc["tan_half_fov"]
    dx = (((px + u[:, 0]) / W) * 2.0 - 1.0) * th
    dy = (1.0 - ((py + u[:, 1]) / H) * 2.0) * th * (H / W)
    d = normalize(dx[:, None] * sc["cam_right"] + dy[:, None] * sc["cam_up"]
                  + sc["cam_fwd"])
    spread = (2.0 * th / W) / torch.sqrt(1.0 + dx * dx + dy * dy)
    return sc["cam_origin"].expand_as(d), d, spread


def trace(sc, cfg, seed, it, pixels, dtype=torch.float64):
    """Gather points and segments of the base paths of `pixels` (flat
    ids) and of their four offset paths, in that order (5 groups of
    len(pixels)). cfg: max_cam_depth, initial_scale. Returns (gp dict of
    [5P, ...], segment dict of [max_cam_depth, 5P, ...])."""
    dev = pixels.device
    f = dict(dtype=dtype, device=dev)
    W = sc["width"]
    k_pix, k_walk = rng.split(rng.pass_key(seed, it, rng.STREAM_CAMERA), 2)
    u = rng.rows(k_pix.to(dev), pixels, 2, lane_keyed=True).to(dtype)
    bx, by = (pixels % W).to(dtype), (pixels // W).to(dtype)
    px = torch.cat([bx] + [bx + dx for dx, _ in OFFSETS])
    py = torch.cat([by] + [by + dy for _, dy in OFFSETS])
    o, d, spread = rays(sc, px, py, u.repeat(5, 1))
    n = px.shape[0]
    pixel = py.to(torch.int64) * W + px.to(torch.int64)
    med = torch.full((n,), rs.NO_MEDIUM, dtype=torch.int64, device=dev)
    thr = torch.ones(n, 3, **f)
    dist = torch.zeros(n, **f)
    pdfp = torch.ones(n, **f)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    depth = torch.zeros(n, dtype=torch.int64, device=dev)
    emission = torch.zeros(n, 3, **f)
    gp = dict(valid=torch.zeros_like(active), p=torch.zeros(n, 3, **f),
              ns=torch.zeros(n, 3, **f), wo=torch.zeros(n, 3, **f),
              bsdf=torch.zeros_like(depth), thr=torch.zeros(n, 3, **f),
              radius=torch.zeros(n, **f), depth=torch.zeros_like(depth),
              med=med, pdf_prod=torch.ones(n, **f))
    segs = []
    for _ in range(cfg["max_cam_depth"]):
        hit = rs.intersect(sc, o, d)
        alive = active & hit["valid"]
        seg = torch.where(hit["valid"], hit["t"], 0.0)
        segs.append(dict(valid=active & (med >= 0) & (seg > 1e-6), o=o, d=d,
                         length=seg, med=med, thr=thr, spread=spread,
                         pdf_prod=pdfp, depth=depth))
        st = torch.where((med >= 0)[:, None], sc["sigma_t"], 0.0)
        tr = torch.exp(-st * seg[:, None])
        thr_h = thr * torch.where(tr.amax(-1, keepdim=True) < 1e-20, 0.0, tr)
        dist_h = dist + seg
        lit = alive & (dot(hit["ng"], -d) > 0)
        emission = emission + torch.where(lit[:, None],
                                          thr_h * hit["radiance"], 0.0)
        kind = sc["mat_kind"][hit["mat"]]
        found = alive & (kind == rs.DIFFUSE)
        f3 = found[:, None]
        gp = dict(
            valid=gp["valid"] | found,
            p=torch.where(f3, hit["p"], gp["p"]),
            ns=torch.where(f3, hit["ng"], gp["ns"]),
            wo=torch.where(f3, -d, gp["wo"]),
            bsdf=torch.where(found, hit["mat"], gp["bsdf"]),
            thr=torch.where(f3, thr_h, gp["thr"]),
            radius=torch.where(found, spread * dist_h * cfg["initial_scale"],
                               gp["radius"]),
            depth=torch.where(found, depth + 1, gp["depth"]),
            med=torch.where(found, med, gp["med"]),
            pdf_prod=torch.where(found, pdfp, gp["pdf_prod"]))
        # on through the mirror and the null boundaries (neither reads a
        # random number)
        wo, wgt, pdf, ok, _ = sample_surface(
            sc, hit["mat"], hit["ng"], d, torch.zeros(n, 3, **f))
        cont = alive & ~found & ok
        c3 = cont[:, None]
        crossed = dot(wo, hit["ng"]) * dot(-d, hit["ng"]) < 0
        med = torch.where(cont & crossed, torch.where(
            dot(wo, hit["ng"]) < 0, hit["med_in"], hit["med_out"]), med)
        side = torch.sign(dot(hit["ng"], wo))[:, None]
        o = torch.where(c3, hit["p"] + hit["ng"] * side * rs.RAY_EPS, o)
        d = torch.where(c3, wo, d)
        thr = torch.where(c3, thr_h * wgt, thr)
        pdfp = torch.where(cont, pdfp * torch.clamp(pdf, min=1e-20), pdfp)
        dist = torch.where(cont, dist_h, dist)
        active = cont
        depth = depth + (cont & (kind != rs.NULL)).to(torch.int64)
    gp["radius"] = torch.clamp(gp["radius"], min=1e-5)
    gp["emission"] = emission
    gp["pixel"] = pixel
    return gp, {k: torch.stack([s[k] for s in segs]) for k in segs[0]}


def lanes_of(pixels, n_pixels):
    """The program's lanes of the 5 groups of `pixels` (base, then each
    offset), group-major over the whole film."""
    return torch.cat([pixels + g * n_pixels for g in range(5)])


def compare(gp_p, gp_r, seg_p, seg_r):
    """(mean error, share of paths that differ): a path differs where an
    exact field of its gather point, or of a segment that either side
    holds, differs; the error is the mean over the other paths' gather
    points and live segments of the largest per-field error."""
    from .light import _per_record
    bad = torch.zeros_like(gp_r["valid"])
    for k in GP_EXACT:
        bad |= (gp_p[k].to(torch.int64) != gp_r[k].to(torch.int64)) \
            & (gp_p["valid"] | gp_r["valid"])
    bad |= gp_p["pixel"] != gp_r["pixel"]
    live = seg_p["valid"] | seg_r["valid"]
    for k in SEG_EXACT:
        bad |= (live & (seg_p[k].to(torch.int64)
                        != seg_r[k].to(torch.int64))).any(0)
    errs = []
    keep = gp_r["valid"] & ~bad
    if bool(keep.any()):
        e = torch.stack([_per_record(gp_p[k][keep], gp_r[k][keep])
                         for k in GP_FLOAT]).amax(0)
        errs.append(e)
    sk = live & ~bad[None]
    if bool(sk.any()):
        e = torch.stack([_per_record(seg_p[k][sk], seg_r[k][sk])
                         for k in SEG_FLOAT]).amax(0)
        errs.append(e)
    e = torch.cat(errs) if errs else torch.zeros(0, dtype=torch.float64)
    return (float(e.mean()) if e.numel() else 0.0,
            float(bad.double().mean()))
