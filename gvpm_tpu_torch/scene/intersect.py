"""Batched ray-scene intersection (mirrors gvpm_tpu/scene/intersect.py).

All primitives are streamed against the ray batch in fixed tiles with
a running minimum: an exact closest hit, so the port finds the same
`prim` and `t` as the JAX package.

  intersect(scene, o, d, t_max) -> Hit  (closest hit)
  occluded(scene, a, b)         -> bool mask (segment visibility)
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.math import EPS, cross, dot, normalize, safe_rcp
from .types import Scene

TILE = 256  # triangle tile per scan step; keeps temps ~ N*TILE floats


@dataclasses.dataclass
class Hit:
    valid: torch.Tensor    # [N] bool
    t: torch.Tensor        # [N]
    prim: torch.Tensor     # [N] global prim id (-1 none)
    p: torch.Tensor        # [N,3]
    ng: torch.Tensor       # [N,3] geometric normal
    ns: torch.Tensor       # [N,3] shading normal


def _tri_tile_hit(o, d, p0, e1, e2, t_best):
    """Moller-Trumbore for a tile: o,d [N,3]; p0,e1,e2 [K,3]."""
    pvec = cross(d[:, None, :], e2[None, :, :])
    det = dot(e1[None], pvec)
    inv_det = safe_rcp(det)
    tvec = o[:, None, :] - p0[None, :, :]
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1[None, :, :])
    v = dot(d[:, None, :], qvec) * inv_det
    t = dot(e2[None], qvec) * inv_det
    ok = ((torch.abs(det) > 1e-12) & (u >= 0.0) & (v >= 0.0)
          & (u + v <= 1.0) & (t > EPS) & (t < t_best[:, None]))
    t = torch.where(ok, t, torch.inf)
    k = torch.argmin(t, dim=1, keepdim=True)
    return (t.gather(1, k)[:, 0], k[:, 0], u.gather(1, k)[:, 0],
            v.gather(1, k)[:, 0])


def _sphere_hit(o, d, c, r, t_best):
    """Analytic sphere hit: c [S,3], r [S] -> per-ray best (t, s)."""
    oc = o[:, None, :] - c[None, :, :]
    b = dot(oc, d[:, None, :])
    cq = dot(oc, oc) - (r * r)[None, :]
    disc = b * b - cq
    ok = disc >= 0.0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0 = -b - sq
    t1 = -b + sq
    t = torch.where(t0 > EPS, t0, t1)
    ok = ok & (t > EPS) & (t < t_best[:, None])
    t = torch.where(ok, t, torch.inf)
    s = torch.argmin(t, dim=1, keepdim=True)
    return t.gather(1, s)[:, 0], s[:, 0]


def intersect(scene: Scene, o, d, t_max=None) -> Hit:
    """Closest hit for a ray batch. o,d: [N,3]; d must be normalized;
    t_max (scalar or [N]) bounds the hit distance."""
    n = o.shape[0]
    f32 = dict(dtype=torch.float32, device=o.device)
    t_best = torch.full((n,), torch.inf, **f32) if t_max is None \
        else torch.as_tensor(t_max, **f32).expand(n)
    idx = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    uu = torch.zeros((n,), **f32)
    vv = torch.zeros((n,), **f32)
    for base in range(0, scene.n_tris, TILE):
        sl = slice(base, base + TILE)
        t, k, u, v = _tri_tile_hit(o, d, scene.tri_p0[sl], scene.tri_e1[sl],
                                   scene.tri_e2[sl], t_best)
        better = t < t_best
        t_best = torch.where(better, t, t_best)
        idx = torch.where(better, base + k, idx)
        uu = torch.where(better, u, uu)
        vv = torch.where(better, v, vv)

    prim = idx
    if scene.n_spheres > 0:
        ts, si = _sphere_hit(o, d, scene.sph_center, scene.sph_radius,
                             t_best)
        sph_better = ts < t_best
        t_best = torch.where(sph_better, ts, t_best)
        prim = torch.where(sph_better, scene.n_tris + si, idx)

    valid = (prim >= 0) & torch.isfinite(t_best)
    p = o + d * t_best[:, None]
    ti = torch.clamp(prim, 0, scene.n_tris - 1)
    ng_tri = normalize(cross(scene.tri_e1[ti], scene.tri_e2[ti]))
    w = torch.stack([1.0 - uu - vv, uu, vv], dim=-1)
    ns_tri = normalize((scene.tri_vn[ti] * w[..., None]).sum(-2))
    if scene.n_spheres > 0:
        si = torch.clamp(prim - scene.n_tris, 0, scene.n_spheres - 1)
        ng_sph = normalize(p - scene.sph_center[si])
        is_tri = (prim < scene.n_tris)[:, None]
        ng = torch.where(is_tri, ng_tri, ng_sph)
        ns = torch.where(is_tri, ns_tri, ng_sph)
    else:
        ng, ns = ng_tri, ns_tri
    return Hit(valid=valid, t=torch.where(valid, t_best, torch.inf),
               prim=prim, p=p, ng=ng, ns=ns)


def occluded(scene: Scene, a, b, eps=1e-3):
    """True where the open segment a->b is blocked (shadow ray). Null-BSDF
    boundaries count as blockers; media are the caller's business."""
    seg = b - a
    dist = torch.sqrt(torch.clamp(dot(seg, seg), min=1e-20))
    d = seg / dist[:, None]
    return intersect(scene, a + d * (eps * dist)[:, None], d,
                     t_max=dist * (1.0 - 2.0 * eps)).valid
