"""Host-side scene construction in numpy, turned into a `Scene` of
tensors by `build()` (mirrors gvpm_tpu/scene/builder.py, trimmed to
what the built-in scenes call: diffuse/conductor/null BSDFs,
homogeneous media, triangles, rectangles, boxes, spheres, area lights
and a pinhole camera).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.spectrum import luminance
from .types import (BSDF_CONDUCTOR, BSDF_DIFFUSE, BSDF_NULL, NO_EMITTER,
                    NO_MEDIUM, PHASE_HG, PHASE_ISOTROPIC, STATIC_FIELDS,
                    Scene)


def _v(x):
    return np.asarray(x, dtype=np.float32)


def look_at(origin, target, up):
    """Camera-to-world matrix; camera space: +x right, +y up, +z forward."""
    origin, target, up = _v(origin), _v(target), _v(up)
    fwd = target - origin
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    if np.linalg.norm(right) < 1e-8:
        raise ValueError("up parallel to viewing direction")
    right /= np.linalg.norm(right)
    new_up = np.cross(right, fwd)
    m = np.eye(4, dtype=np.float32)
    m[:3, 0] = right
    m[:3, 1] = new_up
    m[:3, 2] = fwd
    m[:3, 3] = origin
    return m


def scene_from_numpy(arrays, device=None, **static):
    """Scene from a dict of numpy arrays (one per tensor field) and the
    static ints: floating arrays become float32, integer arrays int64.
    `device`: None means the CUDA card (core.device.resolve_device)."""
    device = resolve_device(device)
    fields = {}
    for name, a in arrays.items():
        a = np.asarray(a)
        dt = torch.float32 if np.issubdtype(a.dtype, np.floating) \
            else torch.int64
        fields[name] = torch.tensor(a, dtype=dt, device=device)
    bad = set(static) - set(STATIC_FIELDS)
    if bad:
        raise ValueError(f"unknown static scene fields {sorted(bad)}")
    return Scene(**fields, **static)


class SceneBuilder:
    def __init__(self):
        self._tris = []
        self._spheres = []
        self._bsdfs = []
        self._media = []
        self._emitters = []
        self._cam = None
        self._cam_medium = NO_MEDIUM

    # ---------------- materials ----------------
    def _add_bsdf(self, **row):
        base = dict(type=BSDF_DIFFUSE, albedo=(0.5, 0.5, 0.5), eta=1.5,
                    k=(0.0, 0.0, 0.0), eta3=(1.0, 1.0, 1.0), alpha=0.1)
        base.update(row)
        self._bsdfs.append(base)
        return len(self._bsdfs) - 1

    def diffuse(self, albedo):
        return self._add_bsdf(type=BSDF_DIFFUSE, albedo=tuple(albedo))

    def conductor(self, eta3=(0.2, 0.92, 1.1), k=(3.9, 2.45, 2.14),
                  reflectance=(1.0, 1.0, 1.0)):
        return self._add_bsdf(type=BSDF_CONDUCTOR, albedo=tuple(reflectance),
                              eta3=tuple(eta3), k=tuple(k))

    def null_bsdf(self):
        return self._add_bsdf(type=BSDF_NULL, albedo=(1.0, 1.0, 1.0))

    # ---------------- media ----------------
    def homogeneous(self, sigma_a, sigma_s, g=0.0):
        pid = PHASE_ISOTROPIC if abs(g) < 1e-6 else PHASE_HG
        self._media.append(dict(sigma_a=tuple(sigma_a),
                                sigma_s=tuple(sigma_s), g=g, phase=pid))
        return len(self._media) - 1

    # ---------------- geometry ----------------
    def triangle(self, p0, p1, p2, bsdf, emitter=NO_EMITTER,
                 med_in=NO_MEDIUM, med_out=NO_MEDIUM):
        p0, p1, p2 = _v(p0), _v(p1), _v(p2)
        e1, e2 = p1 - p0, p2 - p0
        ng = np.cross(e1, e2)
        n = np.linalg.norm(ng)
        if n < 1e-12:
            return
        ng = ng / n
        vn = np.stack([ng, ng, ng])
        self._tris.append((p0, e1, e2, vn, bsdf, emitter, med_in, med_out))

    def rectangle(self, origin, edge1, edge2, bsdf, emitter=NO_EMITTER,
                  med_in=NO_MEDIUM, med_out=NO_MEDIUM):
        """Two triangles; geometric normal = edge1 x edge2 direction."""
        o, e1, e2 = _v(origin), _v(edge1), _v(edge2)
        self.triangle(o, o + e1, o + e1 + e2, bsdf, emitter, med_in, med_out)
        self.triangle(o, o + e1 + e2, o + e2, bsdf, emitter, med_in, med_out)

    def cube(self, lo, hi, bsdf, emitter=NO_EMITTER, med_in=NO_MEDIUM,
             med_out=NO_MEDIUM):
        """Axis-aligned box with outward normals."""
        lo, hi = _v(lo), _v(hi)
        d = hi - lo
        ex, ey, ez = (np.array([d[0], 0, 0], np.float32),
                      np.array([0, d[1], 0], np.float32),
                      np.array([0, 0, d[2]], np.float32))
        for o, e1, e2 in ((lo, ey, ex), (lo + ez, ex, ey), (lo, ex, ez),
                          (lo + ey, ez, ex), (lo, ez, ey), (lo + ex, ey, ez)):
            self.rectangle(o, e1, e2, bsdf, emitter, med_in, med_out)

    def sphere(self, center, radius, bsdf, emitter=NO_EMITTER,
               med_in=NO_MEDIUM, med_out=NO_MEDIUM):
        self._spheres.append((_v(center), float(radius), bsdf, emitter,
                              med_in, med_out))

    def area_light(self, radiance):
        """Returns an emitter id to attach to geometry."""
        self._emitters.append(tuple(radiance))
        return len(self._emitters) - 1

    def medium_box(self, lo, hi, medium, bsdf=None):
        """Axis-aligned null-boundary box filled with `medium`."""
        if bsdf is None:
            bsdf = self.null_bsdf()
        self.cube(lo, hi, bsdf, med_in=medium, med_out=NO_MEDIUM)

    # ---------------- camera ----------------
    def camera(self, origin, target, up=(0, 1, 0), fov=45.0,
               medium=NO_MEDIUM):
        """Perspective pinhole (horizontal fov in degrees)."""
        focus = float(np.linalg.norm(_v(target) - _v(origin)))
        self._cam = (look_at(origin, target, up), float(fov), focus)
        self._cam_medium = medium

    # ---------------- build ----------------
    def arrays(self):
        """The scene tables as numpy arrays (the builder's own output,
        before the tensor conversion)."""
        if self._cam is None:
            raise ValueError("no camera set")
        if not self._tris:
            raise NotImplementedError(
                "triangle-free scenes: ROADMAP queue 1 item 17 (loaders)")
        if not self._bsdfs:
            self.diffuse((0.5, 0.5, 0.5))
        if not self._media:
            self._media.append(dict(sigma_a=(0., 0., 0.),
                                    sigma_s=(0., 0., 0.), g=0.0,
                                    phase=PHASE_ISOTROPIC))
        if not self._emitters:
            self._emitters.append((0.0, 0.0, 0.0))
        T = len(self._tris)
        tp0 = np.stack([t[0] for t in self._tris])
        te1 = np.stack([t[1] for t in self._tris])
        te2 = np.stack([t[2] for t in self._tris])
        tvn = np.stack([t[3] for t in self._tris])
        ti = [np.array([t[j] for t in self._tris], np.int32)
              for j in range(4, 8)]

        S = len(self._spheres)
        if S:
            sc = np.stack([s[0] for s in self._spheres])
            sr = np.array([s[1] for s in self._spheres], np.float32)
            si = [np.array([s[j] for s in self._spheres], np.int32)
                  for j in range(2, 6)]
        else:
            sc = np.zeros((0, 3), np.float32)
            sr = np.zeros((0,), np.float32)
            si = [np.zeros((0,), np.int32)] * 4
        tem, sem = ti[1], si[1]

        # emitter flux CDF over emissive prims (Scene::weightEmitterFlux)
        em_rad = np.asarray(self._emitters, np.float32)
        em_prim, em_area, em_flux = [], [], []
        tri_area = 0.5 * np.linalg.norm(np.cross(te1, te2), axis=-1)
        for i in range(T):
            if tem[i] != NO_EMITTER:
                em_prim.append(i)
                em_area.append(tri_area[i])
                em_flux.append(tri_area[i] * np.pi
                               * float(luminance(em_rad[tem[i]])))
        for i in range(S):
            if sem[i] != NO_EMITTER:
                em_prim.append(T + i)
                a = 4.0 * np.pi * sr[i] ** 2
                em_area.append(a)
                em_flux.append(a * np.pi * float(luminance(em_rad[sem[i]])))
        if em_prim:
            em_prim = np.array(em_prim, np.int32)
            em_area = np.array(em_area, np.float32)
            flux = np.array(em_flux, np.float64)
            area_total = flux.sum()
            cdf = np.cumsum(flux / area_total).astype(np.float32)
            cdf[-1] = 1.0
        else:
            em_prim = np.zeros((0,), np.int32)
            em_area = np.zeros((0,), np.float32)
            cdf = np.zeros((0,), np.float32)
            area_total = 0.0

        pts = np.concatenate([tp0, tp0 + te1, tp0 + te2], axis=0)
        if S:
            pts = np.concatenate([pts, sc - sr[:, None], sc + sr[:, None]])
        world_lo = pts.min(axis=0)
        world_hi = pts.max(axis=0)

        # medium AABB: bounds of prims that reference a medium
        tmi, tmo = ti[2], ti[3]
        has_med = (tmi != NO_MEDIUM) | (tmo != NO_MEDIUM)
        if has_med.any():
            mpts = np.concatenate([tp0[has_med], (tp0 + te1)[has_med],
                                   (tp0 + te2)[has_med]])
            med_lo, med_hi = mpts.min(axis=0), mpts.max(axis=0)
        else:
            med_lo, med_hi = world_lo, world_hi
        shas = (si[2] != NO_MEDIUM) | (si[3] != NO_MEDIUM)
        if S and shas.any():
            med_lo = np.minimum(med_lo, (sc - sr[:, None])[shas].min(axis=0))
            med_hi = np.maximum(med_hi, (sc + sr[:, None])[shas].max(axis=0))

        cam_mat, fov, _ = self._cam
        # no delta / environment emitters: the env group keeps the
        # constant-environment table layout with zero radiance
        env_total = 0.0
        total = area_total + env_total
        group_p = (np.array([area_total, 0.0, env_total], np.float64) / total
                   if total > 0 else np.array([1.0, 0.0, 0.0]))
        f32 = np.float32
        return dict(
            tri_p0=tp0, tri_e1=te1, tri_e2=te2, tri_vn=tvn,
            tri_bsdf=ti[0], tri_emitter=ti[1], tri_med_in=ti[2],
            tri_med_out=ti[3],
            sph_center=sc, sph_radius=sr, sph_bsdf=si[0], sph_emitter=si[1],
            sph_med_in=si[2], sph_med_out=si[3],
            bsdf_type=np.array([b["type"] for b in self._bsdfs], np.int32),
            bsdf_albedo=np.array([b["albedo"] for b in self._bsdfs], f32),
            bsdf_eta=np.array([b["eta"] for b in self._bsdfs], f32),
            bsdf_k=np.array([b["k"] for b in self._bsdfs], f32),
            bsdf_eta3=np.array([b["eta3"] for b in self._bsdfs], f32),
            bsdf_alpha=np.array([b["alpha"] for b in self._bsdfs], f32),
            med_sigma_a=np.array([m["sigma_a"] for m in self._media], f32),
            med_sigma_s=np.array([m["sigma_s"] for m in self._media], f32),
            med_g=np.array([m["g"] for m in self._media], f32),
            med_phase=np.array([m["phase"] for m in self._media], np.int32),
            het_density=np.zeros((0, 0, 0), f32),
            het_lo=np.zeros(3, f32), het_hi=np.ones(3, f32),
            het_sigma_scale=np.ones(3, f32), het_albedo=np.ones(3, f32),
            het_majorant=np.array(1.0, f32),
            em_radiance=em_rad, em_prim=em_prim, em_prim_area=em_area,
            em_cdf=cdf, em_power=np.array(total, f32),
            de_type=np.zeros((0,), np.int32), de_p=np.zeros((0, 3), f32),
            de_dir=np.zeros((0, 3), f32), de_intensity=np.zeros((0, 3), f32),
            de_cos_cutoff=np.zeros((0,), f32),
            de_cos_falloff=np.zeros((0,), f32),
            de_medium=np.zeros((0,), np.int32), de_cdf=np.zeros((0,), f32),
            env_radiance=np.zeros(3, f32), env_map=np.ones((1, 1, 3), f32),
            env_row_cdf=np.ones(1, f32), env_cond_cdf=np.ones((1, 1), f32),
            env_mean_lum=np.array(0.0, f32),
            light_group_p=group_p.astype(f32),
            cam_to_world=cam_mat,
            cam_tan_half_fov_x=np.array(np.tan(np.radians(fov) * 0.5), f32),
            cam_medium=np.array(self._cam_medium, np.int32),
            world_lo=world_lo, world_hi=world_hi,
            medium_lo=med_lo, medium_hi=med_hi)

    def build(self, width=256, height=256, device=None) -> Scene:
        device = resolve_device(device)
        _, _, focus = self._cam if self._cam else (None, None, 1.0)
        return scene_from_numpy(self.arrays(), device, width=width,
                                height=height, cam_aperture=0.0,
                                cam_focus=focus)
