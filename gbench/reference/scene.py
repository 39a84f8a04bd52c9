"""The reference's own description of a configuration's scene, built from
the configuration's `scene` entry and nothing of the program: its
triangles (each rectangle as two, in the order the scene lists them),
spheres, materials, media and camera, in float64, with a closest-hit
ray test (Moller-Trumbore for the triangles, the analytic sphere).

A scene is a plain dict of tensors; materials carry a `kind` of the
three a scene here holds: diffuse, conductor (a smooth mirror) and null
(the boundary of a medium).
"""

from __future__ import annotations

import math

import torch

DIFFUSE, CONDUCTOR, NULL = 0, 1, 2       # material kinds
NO_MEDIUM = -1
ISOTROPIC, HG = 0, 1
RAY_EPS = 1e-4                          # nearest hit distance, and the
                                        # offset of a ray leaving a surface
F64 = torch.float64


class _Builder:
    def __init__(self):
        self.tris, self.spheres, self.mats, self.media = [], [], [], []
        self.camera = self.medium_box = None

    def material(self, kind, albedo, eta3=(1.0, 1.0, 1.0), k=(0.0, 0.0, 0.0)):
        self.mats.append(dict(kind=kind, albedo=albedo, eta3=eta3, k=k))
        return len(self.mats) - 1

    def rectangle(self, o, e1, e2, mat, radiance=None, med_in=NO_MEDIUM,
                  med_out=NO_MEDIUM):
        o, e1, e2 = (torch.tensor(v, dtype=torch.float32) for v in
                     (o, e1, e2))
        for p0, p1, p2 in ((o, o + e1, o + e1 + e2), (o, o + e1 + e2, o + e2)):
            self.tris.append((p0, p1 - p0, p2 - p0, mat, radiance, med_in,
                              med_out))

    def cube(self, lo, hi, mat, med_in, med_out):
        lo, hi = torch.tensor(lo), torch.tensor(hi)
        ex, ey, ez = (torch.diag(hi - lo)[i] for i in range(3))
        for o, e1, e2 in ((lo, ey, ex), (lo + ez, ex, ey), (lo, ex, ez),
                          (lo + ey, ez, ex), (lo, ez, ey), (lo + ex, ey, ez)):
            self.rectangle(o.tolist(), e1.tolist(), e2.tolist(), mat, None,
                           med_in, med_out)


def _open_box(b):
    white = b.material(DIFFUSE, (0.73, 0.73, 0.73))
    red = b.material(DIFFUSE, (0.63, 0.065, 0.05))
    green = b.material(DIFFUSE, (0.14, 0.45, 0.091))
    b.rectangle([0, 0, 0], [0, 0, 1], [1, 0, 0], white)       # floor
    b.rectangle([0, 1, 0], [1, 0, 0], [0, 0, 1], white)       # ceiling
    b.rectangle([0, 0, 1], [0, 1, 0], [1, 0, 0], white)       # back
    b.rectangle([0, 0, 0], [0, 1, 0], [0, 0, 1], red)         # left
    b.rectangle([1, 0, 0], [0, 0, 1], [0, 1, 0], green)       # right


def _box_medium(b, sigma_s=0.4, sigma_a=0.05, g=0.0):
    """The open box lit by a ceiling area light, a fog box inside it and
    a mirror sphere (the repository's box-medium scene)."""
    _open_box(b)
    black = b.material(DIFFUSE, (0.0, 0.0, 0.0))
    b.rectangle([0.34, 0.998, 0.34], [0.32, 0, 0], [0, 0, 0.32], black,
                radiance=(20.0, 17.0, 9.0))
    b.media.append(dict(sigma_a=sigma_a, sigma_s=sigma_s, g=g))
    null = b.material(NULL, (1.0, 1.0, 1.0))
    b.medium_box = ([0.02, 0.02, 0.02], [0.98, 0.98, 0.98])
    b.cube(*b.medium_box, null, 0, NO_MEDIUM)
    mirror = b.material(CONDUCTOR, (1.0, 1.0, 1.0), eta3=(0.2, 0.92, 1.1),
                        k=(3.9, 2.45, 2.14))
    b.spheres.append(((0.32, 0.2, 0.62), 0.2, mirror))
    b.camera = dict(origin=(0.5, 0.5, -1.35), target=(0.5, 0.5, 0.5),
                    up=(0.0, 1.0, 0.0), fov=40.0)


SCENES = {"box_medium": _box_medium}


def build(desc, device="cpu", dtype=F64):
    """The scene of a configuration's `scene` entry, as tensors of
    `dtype` on `device`."""
    desc = dict(desc)
    b = _Builder()
    width, height = desc.pop("width"), desc.pop("height")
    SCENES[desc.pop("name")](b, **desc)
    f = dict(dtype=dtype, device=device)
    i64 = dict(dtype=torch.int64, device=device)
    p0 = torch.stack([t[0] for t in b.tris]).to(**f)
    e1 = torch.stack([t[1] for t in b.tris]).to(**f)
    e2 = torch.stack([t[2] for t in b.tris]).to(**f)
    ng = cross(e1, e2)
    area = 0.5 * torch.linalg.vector_norm(ng, dim=-1)
    rad = torch.tensor([t[4] or (0.0, 0.0, 0.0) for t in b.tris], **f)
    emissive = torch.tensor([t[4] is not None for t in b.tris],
                            device=device)
    em_prim = torch.nonzero(emissive)[:, 0]
    lum = rad[em_prim] @ torch.tensor([0.212671, 0.715160, 0.072169], **f)
    flux = area[em_prim] * lum
    cam = b.camera
    origin = torch.tensor(cam["origin"], **f)
    fwd = torch.tensor(cam["target"], **f) - origin
    fwd = fwd / torch.linalg.vector_norm(fwd)
    right = normalize(cross(fwd, torch.tensor(cam["up"], **f)))
    up = cross(right, fwd)
    med = b.media[0]
    st = med["sigma_a"] + med["sigma_s"]
    c = torch.tensor([s[0] for s in b.spheres], **f)
    r = torch.tensor([s[1] for s in b.spheres], **f)
    pts = torch.cat([p0, p0 + e1, p0 + e2, c - r[:, None], c + r[:, None]])
    return dict(
        world_diag=float(torch.linalg.vector_norm(pts.amax(0) - pts.amin(0))),
        width=width, height=height, n_tris=p0.shape[0],
        tri_p0=p0, tri_e1=e1, tri_e2=e2,
        tri_ng=ng / torch.linalg.vector_norm(ng, dim=-1, keepdim=True),
        tri_mat=torch.tensor([t[3] for t in b.tris], **i64),
        tri_med_in=torch.tensor([t[5] for t in b.tris], **i64),
        tri_med_out=torch.tensor([t[6] for t in b.tris], **i64),
        tri_radiance=rad, em_prim=em_prim, em_area=area[em_prim],
        em_cdf=torch.cumsum(flux / flux.sum(), 0),
        sph_center=c, sph_radius=r,
        sph_mat=torch.tensor([s[2] for s in b.spheres], **i64),
        mat_kind=torch.tensor([m["kind"] for m in b.mats], **i64),
        mat_albedo=torch.tensor([m["albedo"] for m in b.mats], **f),
        mat_eta3=torch.tensor([m["eta3"] for m in b.mats], **f),
        mat_k=torch.tensor([m["k"] for m in b.mats], **f),
        sigma_t=torch.full((3,), st, **f),
        sigma_s=torch.full((3,), med["sigma_s"], **f),
        g=med["g"], phase=ISOTROPIC if abs(med["g"]) < 1e-6 else HG,
        medium_lo=torch.tensor(b.medium_box[0], **f),
        medium_hi=torch.tensor(b.medium_box[1], **f),
        cam_origin=origin, cam_right=right, cam_up=up, cam_fwd=fwd,
        tan_half_fov=math.tan(math.radians(cam["fov"]) * 0.5))


def intersect_all(sc, o, d):
    """Every primitive's hit distance along rays (o, d) [N, 3] (inf where
    it is missed) and material: dict(t [N, P], mat [N, P]), the
    triangles first, then the spheres."""
    e1, e2 = sc["tri_e1"][None], sc["tri_e2"][None]
    pvec = cross(d[:, None, :], e2)
    det = dot(e1, pvec)
    inv = 1.0 / torch.where(det == 0.0, 1.0, det)
    tvec = o[:, None, :] - sc["tri_p0"][None]
    u = dot(tvec, pvec) * inv
    qvec = cross(tvec, e1)
    v = dot(d[:, None, :], qvec) * inv
    t = dot(e2, qvec) * inv
    ok = (det.abs() > 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1) \
        & (t > RAY_EPS)
    t = torch.where(ok, t, torch.inf)
    oc = o[:, None, :] - sc["sph_center"][None]
    bq = (oc * d[:, None, :]).sum(-1)
    cq = (oc * oc).sum(-1) - sc["sph_radius"][None] ** 2
    disc = bq * bq - cq
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    ts = torch.where(-bq - sq > RAY_EPS, -bq - sq, -bq + sq)
    ts = torch.where((disc >= 0) & (ts > RAY_EPS), ts, torch.inf)
    mat = torch.cat([sc["tri_mat"], sc["sph_mat"]])
    return dict(t=torch.cat([t, ts], 1), mat=mat[None].expand(o.shape[0], -1))


def intersect(sc, o, d):
    """Closest hit of rays (o, d) [N, 3] -> dict(valid, t, prim, p, ng,
    mat, radiance, med_in, med_out); prim is the triangle's index, or
    n_tris + the sphere's."""
    tbest, prim = intersect_all(sc, o, d)["t"].min(1)
    valid = torch.isfinite(tbest)
    p = o + d * torch.where(valid, tbest, 0.0)[:, None]
    T = sc["n_tris"]
    is_tri = prim < T
    ti = torch.clamp(prim, max=T - 1)
    si = torch.clamp(prim - T, min=0)
    n_sph = normalize(p - sc["sph_center"][si])
    ng = torch.where(is_tri[:, None], sc["tri_ng"][ti], n_sph)
    mat = torch.where(is_tri, sc["tri_mat"][ti], sc["sph_mat"][si])
    rad = torch.where(is_tri[:, None], sc["tri_radiance"][ti], 0.0)
    return dict(valid=valid, t=tbest, prim=torch.where(valid, prim, -1),
                p=p, ng=ng, mat=mat, radiance=rad,
                med_in=torch.where(is_tri, sc["tri_med_in"][ti], NO_MEDIUM),
                med_out=torch.where(is_tri, sc["tri_med_out"][ti],
                                    NO_MEDIUM))


def cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def dot(a, b):
    return (a * b).sum(-1)


def normalize(v):
    return v / torch.sqrt(dot(v, v))[..., None]


def frame(n):
    """Duff et al.'s orthonormal basis (s, t) around the unit vector n."""
    nx, ny, nz = n.unbind(-1)
    sign = torch.where(nz >= 0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    return (torch.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], -1),
            torch.stack([b, sign + ny * ny * a, -ny], -1))


def to_local(n, s, t, v):
    return torch.stack([dot(v, s), dot(v, t), dot(v, n)], -1)


def to_world(n, s, t, v):
    return s * v[..., 0:1] + t * v[..., 1:2] + n * v[..., 2:3]
