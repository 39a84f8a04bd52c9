"""Host-side scene construction in numpy, turned into a `Scene` of
tensors by `build()` (mirrors gvpm_tpu/scene/builder.py):

    b = SceneBuilder()
    white = b.diffuse([0.8, 0.8, 0.8])
    med   = b.homogeneous(sigma_a=[...], sigma_s=[...], g=0.0)
    b.rectangle(origin, edge1, edge2, bsdf=white)
    light = b.area_light([10, 10, 10])
    b.camera(origin, target, up, fov=45)
    scene = b.build(device="cpu")

Every BSDF lobe (diffuse, conductor, dielectric, rough conductor and
dielectric, phong, plastic, null), homogeneous media with any phase
function, one heterogeneous grid medium, triangles / meshes / boxes /
spheres, area / point / spot / directional lights, a constant or a
lat-long environment, and a pinhole or thinlens camera. The tables have
the JAX package's layout value for value.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.spectrum import luminance
from .types import (BSDF_CONDUCTOR, BSDF_DIELECTRIC, BSDF_DIFFUSE, BSDF_NULL,
                    BSDF_PHONG, BSDF_PLASTIC, BSDF_ROUGH_CONDUCTOR,
                    BSDF_ROUGH_DIELECTRIC, DE_DIRECTIONAL, DE_POINT,
                    DE_SPOT, NO_EMITTER, NO_MEDIUM, PHASE_HG,
                    PHASE_ISOTROPIC, PHASE_RAYLEIGH, STATIC_FIELDS, Scene)


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
        self._tris = []          # (p0, e1, e2, vn(3,3), bsdf, emitter, mi, mo)
        self._spheres = []       # (c, r, bsdf, emitter, mi, mo)
        self._bsdfs = []
        self._media = []
        self._emitters = []      # area radiance rows
        self._delta = []         # point / spot / directional rows (dicts)
        self._env = (0.0, 0.0, 0.0)
        self._env_map = None
        self._het = None         # the heterogeneous medium (at most one)
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

    def dielectric(self, int_ior=1.5, ext_ior=1.0):
        return self._add_bsdf(type=BSDF_DIELECTRIC, eta=int_ior / ext_ior,
                              albedo=(1.0, 1.0, 1.0))

    def rough_conductor(self, alpha=0.1, eta3=(0.2, 0.92, 1.1),
                        k=(3.9, 2.45, 2.14), reflectance=(1.0, 1.0, 1.0)):
        return self._add_bsdf(type=BSDF_ROUGH_CONDUCTOR, alpha=alpha,
                              albedo=tuple(reflectance), eta3=tuple(eta3),
                              k=tuple(k))

    def rough_dielectric(self, alpha=0.1, int_ior=1.5, ext_ior=1.0):
        return self._add_bsdf(type=BSDF_ROUGH_DIELECTRIC, alpha=alpha,
                              eta=int_ior / ext_ior, albedo=(1.0, 1.0, 1.0))

    def phong(self, diffuse=(0.5, 0.5, 0.5), specular=(0.2, 0.2, 0.2),
              exponent=30.0):
        """albedo = diffuse reflectance, k = specular, alpha = exponent."""
        return self._add_bsdf(type=BSDF_PHONG, albedo=tuple(diffuse),
                              k=tuple(specular), alpha=exponent)

    def plastic(self, diffuse=(0.5, 0.5, 0.5), int_ior=1.49):
        return self._add_bsdf(type=BSDF_PLASTIC, albedo=tuple(diffuse),
                              eta=int_ior)

    def null_bsdf(self):
        return self._add_bsdf(type=BSDF_NULL, albedo=(1.0, 1.0, 1.0))

    # ---------------- media ----------------
    def homogeneous(self, sigma_a, sigma_s, g=0.0, phase="auto"):
        """phase: 'auto' (isotropic / hg by g), 'isotropic', 'hg' or
        'rayleigh' (src/phase/rayleigh.cpp)."""
        if phase == "auto":
            pid = PHASE_ISOTROPIC if abs(g) < 1e-6 else PHASE_HG
        else:
            pid = {"isotropic": PHASE_ISOTROPIC, "hg": PHASE_HG,
                   "rayleigh": PHASE_RAYLEIGH}[phase]
        self._media.append(dict(sigma_a=tuple(sigma_a),
                                sigma_s=tuple(sigma_s), g=g, phase=pid))
        return len(self._media) - 1

    def heterogeneous(self, density, lo, hi, sigma_t_scale=(1.0, 1.0, 1.0),
                      albedo=(0.9, 0.9, 0.9), g=0.0, phase="auto"):
        """Grid-density medium (src/medium/heterogeneous.cpp):
        sigma_t(x) = trilinear(density, x) * sigma_t_scale, sigma_s =
        albedo * sigma_t; density: numpy [Gx,Gy,Gz] >= 0. One a scene.
        Its medium-table row carries the phase function and the
        majorant-level coefficients (read by the homogeneous closed
        forms)."""
        if self._het is not None:
            raise ValueError("only one heterogeneous medium per scene")
        density = np.asarray(density, np.float32)
        if density.ndim != 3:
            raise ValueError("density must be [Gx,Gy,Gz]")
        maj_sig = density.max() * np.asarray(sigma_t_scale, np.float32)
        mid = self.homogeneous(
            sigma_a=tuple(maj_sig * (1.0 - np.asarray(albedo))),
            sigma_s=tuple(maj_sig * np.asarray(albedo)), g=g, phase=phase)
        self._het = dict(density=density, lo=_v(lo), hi=_v(hi),
                         scale=_v(sigma_t_scale), albedo=_v(albedo),
                         medium=mid)
        return mid

    # ---------------- geometry ----------------
    def triangle(self, p0, p1, p2, bsdf, emitter=NO_EMITTER,
                 med_in=NO_MEDIUM, med_out=NO_MEDIUM, normals=None):
        p0, p1, p2 = _v(p0), _v(p1), _v(p2)
        e1, e2 = p1 - p0, p2 - p0
        ng = np.cross(e1, e2)
        n = np.linalg.norm(ng)
        if n < 1e-12:
            return
        ng = ng / n
        vn = np.stack([ng, ng, ng]) if normals is None else _v(normals)
        self._tris.append((p0, e1, e2, vn, bsdf, emitter, med_in, med_out))

    def rectangle(self, origin, edge1, edge2, bsdf, emitter=NO_EMITTER,
                  med_in=NO_MEDIUM, med_out=NO_MEDIUM):
        """Two triangles; geometric normal = edge1 x edge2 direction."""
        o, e1, e2 = _v(origin), _v(edge1), _v(edge2)
        self.triangle(o, o + e1, o + e1 + e2, bsdf, emitter, med_in, med_out)
        self.triangle(o, o + e1 + e2, o + e2, bsdf, emitter, med_in, med_out)

    def cube(self, lo, hi, bsdf, emitter=NO_EMITTER, med_in=NO_MEDIUM,
             med_out=NO_MEDIUM, inward=False):
        """Axis-aligned box; normals face outward unless inward=True."""
        lo, hi = _v(lo), _v(hi)
        d = hi - lo
        ex, ey, ez = (np.array([d[0], 0, 0], np.float32),
                      np.array([0, d[1], 0], np.float32),
                      np.array([0, 0, d[2]], np.float32))
        for o, e1, e2 in ((lo, ey, ex), (lo + ez, ex, ey), (lo, ex, ez),
                          (lo + ey, ez, ex), (lo, ez, ey), (lo + ex, ey, ez)):
            if inward:
                e1, e2 = e2, e1
            self.rectangle(o, e1, e2, bsdf, emitter, med_in, med_out)

    def sphere(self, center, radius, bsdf, emitter=NO_EMITTER,
               med_in=NO_MEDIUM, med_out=NO_MEDIUM):
        self._spheres.append((_v(center), float(radius), bsdf, emitter,
                              med_in, med_out))

    def mesh(self, vertices, faces, bsdf, emitter=NO_EMITTER,
             med_in=NO_MEDIUM, med_out=NO_MEDIUM, normals=None):
        """Indexed triangle mesh (vertices [V,3], faces [F,3] int)."""
        vertices = _v(vertices)
        faces = np.asarray(faces, dtype=np.int64)
        for f in faces:
            vn = None if normals is None else _v(normals)[f]
            self.triangle(vertices[f[0]], vertices[f[1]], vertices[f[2]],
                          bsdf, emitter, med_in, med_out, normals=vn)

    def medium_box(self, lo, hi, medium, bsdf=None):
        """Axis-aligned null-boundary box filled with `medium`."""
        if bsdf is None:
            bsdf = self.null_bsdf()
        self.cube(lo, hi, bsdf, med_in=medium, med_out=NO_MEDIUM)

    # ---------------- emitters ----------------
    def area_light(self, radiance):
        """Returns an emitter id to attach to geometry."""
        self._emitters.append(tuple(radiance))
        return len(self._emitters) - 1

    def point_light(self, position, intensity, medium=NO_MEDIUM):
        """Isotropic point light (emitters/point.cpp), intensity W/sr."""
        self._delta.append(dict(type=DE_POINT, p=tuple(position),
                                dir=(0.0, 0.0, 1.0),
                                intensity=tuple(intensity),
                                cos_cutoff=-1.0, cos_falloff=-1.0,
                                medium=medium))

    def spot_light(self, position, target, intensity, cutoff_deg=20.0,
                   beam_width_deg=None, medium=NO_MEDIUM):
        """Spot light, linear falloff between beamWidth and cutoff
        (emitters/spot.cpp)."""
        if beam_width_deg is None:
            beam_width_deg = cutoff_deg * 0.75
        axis = _v(target) - _v(position)
        axis = axis / np.linalg.norm(axis)
        self._delta.append(dict(
            type=DE_SPOT, p=tuple(position), dir=tuple(axis),
            intensity=tuple(intensity),
            cos_cutoff=float(np.cos(np.radians(cutoff_deg))),
            cos_falloff=float(np.cos(np.radians(beam_width_deg))),
            medium=medium))

    def directional_light(self, direction, irradiance, medium=NO_MEDIUM):
        """Distant directional light (emitters/directional.cpp);
        irradiance on a surface facing the light, W/m^2."""
        d = _v(direction)
        d = d / np.linalg.norm(d)
        self._delta.append(dict(type=DE_DIRECTIONAL, p=(0.0, 0.0, 0.0),
                                dir=tuple(d), intensity=tuple(irradiance),
                                cos_cutoff=-1.0, cos_falloff=-1.0,
                                medium=medium))

    def constant_env(self, radiance):
        """Constant environment emitter (emitters/constant.cpp)."""
        self._env = tuple(radiance)

    def envmap(self, image, scale=(1.0, 1.0, 1.0)):
        """Lat-long environment map (emitters/envmap.cpp): image [He,We,3]
        of HDR texels, y-up, luminance importance-sampled."""
        img = np.asarray(image, np.float32)
        if img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"env map must be [He,We,3], got {img.shape}")
        self._env_map = img
        self._env = tuple(scale)

    # ---------------- camera ----------------
    def camera(self, origin, target, up=(0, 1, 0), fov=45.0,
               medium=NO_MEDIUM, aperture_radius=0.0, focus_distance=None):
        """Perspective camera (horizontal fov in degrees): a pinhole, or
        with aperture_radius > 0 a thinlens focused at focus_distance
        (default |target - origin|)."""
        if focus_distance is None:
            focus_distance = float(np.linalg.norm(_v(target) - _v(origin)))
        self._cam = (look_at(origin, target, up), float(fov),
                     float(aperture_radius), float(focus_distance))
        self._cam_medium = medium

    # ---------------- build ----------------
    def arrays(self):
        """(the scene tables as numpy arrays, the static fields): the
        builder's own output before the tensor conversion."""
        if self._cam is None:
            raise ValueError("no camera set")
        if not self._tris:  # degenerate placeholder triangle far away
            self._tris.append((_v([1e8, 1e8, 1e8]), _v([1, 0, 0]),
                               _v([0, 1, 0]), np.tile(_v([0, 0, 1]), (3, 1)),
                               0, NO_EMITTER, NO_MEDIUM, NO_MEDIUM))
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
        # (volume_utils.h:220 max_AABB_medium)
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

        cam_mat, fov, cam_ap, cam_focus = self._cam
        f32 = np.float32

        # delta / env emitter power: infinite emitters convert by the
        # scene's bounding-sphere radius (directional flux E*pi*R^2,
        # constant env 4*pi^2*R^2*L, emitters/constant.cpp)
        wc = 0.5 * (world_lo + world_hi)
        wr = float(np.linalg.norm(world_hi - wc)) + 1e-6
        if self._delta:
            de = {k: [d[k] for d in self._delta] for k in self._delta[0]}
            de_type = np.array(de["type"], np.int32)
            de_p = np.stack([_v(p) for p in de["p"]])
            de_dir = np.stack([_v(p) for p in de["dir"]])
            de_int = np.stack([_v(p) for p in de["intensity"]])
            de_cc = np.array(de["cos_cutoff"], f32)
            de_cf = np.array(de["cos_falloff"], f32)
            de_med = np.array(de["medium"], np.int32)
            lum = np.array([float(luminance(i)) for i in de_int], np.float64)
            # power: point 4*pi*I; spot: the falloff curve's solid angle
            # 2*pi*(1 - (cosFall + cosCut)/2) (spot.cpp); directional
            # E*pi*R^2
            sa_spot = 2.0 * np.pi * (1.0 - 0.5 * (de_cf + de_cc))
            de_power = np.where(
                de_type == DE_POINT, 4.0 * np.pi * lum,
                np.where(de_type == DE_SPOT, sa_spot * lum,
                         np.pi * wr * wr * lum))
            delta_total = de_power.sum()
            de_cdf = np.cumsum(de_power / max(delta_total, 1e-30)).astype(f32)
            de_cdf[-1] = 1.0
        else:
            de_type = de_med = np.zeros((0,), np.int32)
            de_p = de_dir = de_int = np.zeros((0, 3), f32)
            de_cc = de_cf = de_cdf = np.zeros((0,), f32)
            delta_total = 0.0

        if self._het is not None:
            het = self._het
            het_maj = float(het["density"].max() * het["scale"].max()) + 1e-8
            het_tabs = dict(het_density=het["density"], het_lo=het["lo"],
                            het_hi=het["hi"], het_sigma_scale=het["scale"],
                            het_albedo=het["albedo"],
                            het_majorant=np.array(het_maj, f32))
            het_medium = het["medium"]
        else:
            het_tabs = dict(het_density=np.zeros((0, 0, 0), f32),
                            het_lo=np.zeros(3, f32), het_hi=np.ones(3, f32),
                            het_sigma_scale=np.ones(3, f32),
                            het_albedo=np.ones(3, f32),
                            het_majorant=np.array(1.0, f32))
            het_medium = -1

        # environment tables: sin-weighted luminance CDFs over the
        # lat-long grid (emitters/envmap.cpp); a constant env keeps the
        # 1x1 table and samples the uniform sphere
        emap = self._env_map if self._env_map is not None \
            else np.ones((1, 1, 3), f32)
        He, We = emap.shape[:2]
        scale_rgb = _v(self._env)
        lum_px = (emap * scale_rgb).astype(np.float64) @ \
            np.array([0.212671, 0.715160, 0.072169])
        sin_row = np.sin((np.arange(He) + 0.5) / He * np.pi)
        wpx = lum_px * sin_row[:, None]
        row_w = wpx.sum(axis=1)
        Z = float(row_w.sum())
        if Z > 0:
            env_row_cdf = np.cumsum(row_w) / Z
            wpx_safe = np.where(row_w[:, None] > 0, wpx, 1.0)
            env_cond_cdf = np.cumsum(wpx_safe, axis=1) \
                / wpx_safe.sum(axis=1, keepdims=True)
        else:
            env_row_cdf = np.linspace(1.0 / He, 1.0, He)
            env_cond_cdf = np.tile(np.linspace(1.0 / We, 1.0, We), (He, 1))
        # spherical-mean luminance Z * dtheta * dphi / 4pi: the pdf
        # normalizer of emitter.pdf_env_sa
        env_mean_lum = Z * (np.pi / He) * (2.0 * np.pi / We) / (4.0 * np.pi)
        env_total = 4.0 * np.pi ** 2 * wr * wr * (
            float(luminance(scale_rgb)) if He * We == 1 else env_mean_lum)
        total = area_total + delta_total + env_total
        group_p = (np.array([area_total, delta_total, env_total],
                            np.float64) / total
                   if total > 0 else np.array([1.0, 0.0, 0.0]))

        arrays = dict(
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
            **het_tabs,
            em_radiance=em_rad, em_prim=em_prim, em_prim_area=em_area,
            em_cdf=cdf, em_power=np.array(total, f32),
            de_type=de_type, de_p=de_p, de_dir=de_dir, de_intensity=de_int,
            de_cos_cutoff=de_cc, de_cos_falloff=de_cf, de_medium=de_med,
            de_cdf=de_cdf,
            env_radiance=scale_rgb, env_map=emap,
            env_row_cdf=env_row_cdf.astype(f32),
            env_cond_cdf=env_cond_cdf.astype(f32),
            env_mean_lum=np.array(env_mean_lum, f32),
            light_group_p=group_p.astype(f32),
            cam_to_world=cam_mat,
            cam_tan_half_fov_x=np.array(np.tan(np.radians(fov) * 0.5), f32),
            cam_medium=np.array(self._cam_medium, np.int32),
            world_lo=world_lo, world_hi=world_hi,
            medium_lo=med_lo, medium_hi=med_hi)
        static = dict(cam_aperture=cam_ap, cam_focus=cam_focus,
                      het_medium=het_medium)
        return arrays, static

    def build(self, width=256, height=256, device=None) -> Scene:
        """The Scene's tensors on `device` (None: the CUDA card, and a
        raise without one; pass "cpu" for the CPU)."""
        device = resolve_device(device)
        arrays, static = self.arrays()
        return scene_from_numpy(arrays, device, width=width, height=height,
                                **static)
