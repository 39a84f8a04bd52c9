"""Mitsuba 0.5 scene-XML loader (the reference's scene format; mirrors
gvpm_tpu/scene/mitsuba.py on the port's SceneBuilder).

Replaces the Xerces SceneHandler + Properties pipeline (reference:
include/mitsuba/render/scenehandler.h:83, src/librender/scenehandler.cpp)
with a compact ElementTree parser that builds our Scene via SceneBuilder.
Covers the subset the GVPM paper scenes use:

  * <default>/$param substitution (the -D flag mechanism, mitsuba.cpp)
  * sensors: perspective (fov, toWorld lookat/matrix), film width/height
  * bsdfs: diffuse, conductor, dielectric, roughconductor,
    roughdielectric, phong, plastic, null, twosided (unwrapped), mask->null
  * emitters: area (radiance)
  * media: homogeneous (sigmaS/sigmaA or sigmaT+albedo, scale), phase
    isotropic/hg
  * shapes: rectangle, cube, sphere, disk, obj, ply, serialized (via
    utils.meshio; OBJ through the native parser), with
    toWorld transforms (matrix/translate/rotate/scale/lookAt), ref'd or
    inline bsdf/medium/emitter
  * integrator block parsed into a dict of properties (returned, not
    interpreted — the caller maps it onto our configs)

Returns (Scene, dict) where dict carries integrator type/props and film
size. The scene's tensors live on `device` (None: the CUDA card, and a
raise without one).
"""

from __future__ import annotations

import os
import re
import xml.etree.ElementTree as ET

import numpy as np

from ..core.device import resolve_device
from .builder import SceneBuilder, look_at
from .types import NO_EMITTER, NO_MEDIUM


def _parse_value(s, defaults):
    if s is None:
        return s
    return re.sub(r"\$(\w+)", lambda m: str(defaults.get(m.group(1),
                                                         m.group(0))), s)


def _to_floats(s):
    return [float(x) for x in re.split(r"[ ,]+", s.strip()) if x]


def _spectrum(val):
    v = _to_floats(val)
    if len(v) == 1:
        return (v[0], v[0], v[0])
    if len(v) == 3:
        return tuple(v)
    # wavelength:value pairs -> crude average (paper scenes use rgb)
    nums = [float(p.split(":")[1]) for p in val.split(",") if ":" in p]
    if nums:
        m = sum(nums) / len(nums)
        return (m, m, m)
    return tuple(v[:3])


def _props(elem, defaults):
    """Collect typed child properties into a dict."""
    out = {}
    for ch in elem:
        name = ch.get("name")
        val = _parse_value(ch.get("value"), defaults)
        if ch.tag in ("integer",):
            out[name] = int(float(val))
        elif ch.tag in ("float",):
            out[name] = float(val)
        elif ch.tag in ("boolean",):
            out[name] = val.lower() == "true"
        elif ch.tag in ("string",):
            out[name] = val
        elif ch.tag in ("spectrum", "rgb", "srgb"):
            out[name] = _spectrum(val)
        elif ch.tag in ("point", "vector"):
            if val is not None:
                out[name] = tuple(_to_floats(val))
            else:
                out[name] = (float(ch.get("x", 0)), float(ch.get("y", 0)),
                             float(ch.get("z", 0)))
    return out


def _transform(elem, defaults):
    """Accumulate a toWorld matrix from transform children (applied in
    document order, matching Mitsuba semantics)."""
    m = np.eye(4, dtype=np.float64)
    if elem is None:
        return m
    for ch in elem:
        t = np.eye(4)
        if ch.tag == "matrix":
            vals = _to_floats(_parse_value(ch.get("value"), defaults))
            t = np.array(vals, dtype=np.float64).reshape(4, 4)
        elif ch.tag == "translate":
            t[:3, 3] = [float(_parse_value(ch.get(a, "0"), defaults))
                        for a in "xyz"]
        elif ch.tag == "scale":
            if ch.get("value") is not None:
                s = float(_parse_value(ch.get("value"), defaults))
                t[0, 0] = t[1, 1] = t[2, 2] = s
            else:
                for i, a in enumerate("xyz"):
                    t[i, i] = float(_parse_value(ch.get(a, "1"), defaults))
        elif ch.tag == "rotate":
            ax = np.array([float(_parse_value(ch.get(a, "0"), defaults))
                           for a in "xyz"])
            ax = ax / max(np.linalg.norm(ax), 1e-12)
            ang = np.radians(float(_parse_value(ch.get("angle", "0"),
                                                defaults)))
            c, s = np.cos(ang), np.sin(ang)
            x, y, z = ax
            t[:3, :3] = np.array([
                [c + x * x * (1 - c), x * y * (1 - c) - z * s,
                 x * z * (1 - c) + y * s],
                [y * x * (1 - c) + z * s, c + y * y * (1 - c),
                 y * z * (1 - c) - x * s],
                [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s,
                 c + z * z * (1 - c)]])
        elif ch.tag in ("lookat", "lookAt"):
            o = _to_floats(_parse_value(ch.get("origin"), defaults))
            tg = _to_floats(_parse_value(ch.get("target"), defaults))
            up = _to_floats(_parse_value(ch.get("up", "0,1,0"), defaults))
            t = look_at(o, tg, up).astype(np.float64)
        # document order = application order (first child applied first)
        m = t @ m
    return m


def _apply(m, pts):
    pts = np.asarray(pts, np.float64)
    return (pts @ m[:3, :3].T) + m[:3, 3]


class MitsubaLoader:
    def __init__(self, path):
        self.path = path
        self.dir = os.path.dirname(os.path.abspath(path))
        self.b = SceneBuilder()
        self.defaults = {}
        self.bsdf_ids = {}
        self.medium_ids = {}
        self.integrator = {"type": "path"}
        self.film = {"width": 256, "height": 256}
        self._cam_medium = NO_MEDIUM

    # ------------------------------------------------------------------
    def _make_bsdf(self, elem):
        btype = elem.get("type")
        p = _props(elem, self.defaults)
        b = self.b
        if btype == "twosided" or btype == "bumpmap" or btype == "coating":
            inner = elem.find("bsdf")
            if inner is not None:
                return self._make_bsdf(inner)
            btype = "diffuse"
        if btype == "diffuse":
            return b.diffuse(p.get("reflectance", (0.5, 0.5, 0.5)))
        if btype == "conductor":
            return b.conductor(
                reflectance=p.get("specularReflectance", (1, 1, 1)))
        if btype == "dielectric" or btype == "thindielectric":
            return b.dielectric(int_ior=p.get("intIOR", 1.5046),
                                ext_ior=p.get("extIOR", 1.000277))
        if btype == "roughconductor":
            return b.rough_conductor(
                alpha=p.get("alpha", 0.1),
                reflectance=p.get("specularReflectance", (1, 1, 1)))
        if btype == "roughdielectric":
            return b.rough_dielectric(alpha=p.get("alpha", 0.1),
                                      int_ior=p.get("intIOR", 1.5046),
                                      ext_ior=p.get("extIOR", 1.000277))
        if btype == "phong":
            return b.phong(diffuse=p.get("diffuseReflectance",
                                         (0.5, 0.5, 0.5)),
                           specular=p.get("specularReflectance",
                                          (0.2, 0.2, 0.2)),
                           exponent=p.get("exponent", 30.0))
        if btype == "plastic" or btype == "roughplastic":
            return b.plastic(diffuse=p.get("diffuseReflectance",
                                           (0.5, 0.5, 0.5)),
                             int_ior=p.get("intIOR", 1.49))
        if btype in ("null", "mask"):
            return b.null_bsdf()
        # unknown -> gray diffuse (log-and-degrade like PluginManager)
        return b.diffuse((0.5, 0.5, 0.5))

    def _make_medium(self, elem):
        p = _props(elem, self.defaults)
        scale = p.get("scale", 1.0)
        if "sigmaS" in p and "sigmaA" in p:
            ss = tuple(scale * x for x in p["sigmaS"])
            sa = tuple(scale * x for x in p["sigmaA"])
        elif "sigmaT" in p:
            albedo = p.get("albedo", (0.75, 0.75, 0.75))
            st = p["sigmaT"]
            ss = tuple(scale * st[i] * albedo[i] for i in range(3))
            sa = tuple(scale * st[i] * (1 - albedo[i]) for i in range(3))
        else:
            ss, sa = (0.5,) * 3, (0.1,) * 3
        g = 0.0
        ph = elem.find("phase")
        if ph is not None and ph.get("type") == "hg":
            g = _props(ph, self.defaults).get("g", 0.0)
        if elem.get("type") == "heterogeneous":
            # gridvolume density (medium/heterogeneous.cpp)
            from ..utils.volume import read_vol
            for vol in elem.findall("volume"):
                if vol.get("type") == "gridvolume":
                    vp = _props(vol, self.defaults)
                    fn = os.path.join(self.dir, vp.get("filename", ""))
                    dens, lo, hi = read_vol(fn)
                    albedo = p.get("albedo", (0.75,) * 3)
                    return self.b.heterogeneous(
                        dens, lo, hi,
                        sigma_t_scale=(scale,) * 3, albedo=albedo, g=g)
            # constant-volume heterogeneous degrades to homogeneous
        return self.b.homogeneous(sigma_a=sa, sigma_s=ss, g=g)

    # ------------------------------------------------------------------
    def _shape_refs(self, elem):
        """Resolve bsdf/emitter/media attached to a shape."""
        bsdf = None
        emitter = NO_EMITTER
        med_in = NO_MEDIUM
        med_out = NO_MEDIUM
        for ref in elem.findall("ref"):
            rid = ref.get("id")
            name = ref.get("name")
            if rid in self.bsdf_ids and name in (None, "bsdf"):
                bsdf = self.bsdf_ids[rid]
            elif rid in self.medium_ids:
                if name == "exterior":
                    med_out = self.medium_ids[rid]
                else:
                    med_in = self.medium_ids[rid]
        inner = elem.find("bsdf")
        if inner is not None:
            bsdf = self._make_bsdf(inner)
        for meds in elem.findall("medium"):
            mid = self._make_medium(meds)
            if meds.get("name") == "exterior":
                med_out = mid
            else:
                med_in = mid
        em = elem.find("emitter")
        if em is not None and em.get("type") == "area":
            p = _props(em, self.defaults)
            emitter = self.b.area_light(p.get("radiance", (1, 1, 1)))
        if bsdf is None:
            bsdf = self.b.null_bsdf() if (med_in != NO_MEDIUM
                                          and em is None) \
                else self.b.diffuse((0.5, 0.5, 0.5))
        return bsdf, emitter, med_in, med_out

    def _add_shape(self, elem):
        stype = elem.get("type")
        p = _props(elem, self.defaults)
        m = _transform(elem.find("transform"), self.defaults)
        bsdf, emitter, mi, mo = self._shape_refs(elem)
        b = self.b
        if stype == "rectangle":
            # unit square [-1,1]^2 in the xy-plane, normal +z
            pts = _apply(m, [[-1, -1, 0], [1, -1, 0], [-1, 1, 0]])
            o = pts[0]
            e1 = pts[1] - pts[0]
            e2 = pts[2] - pts[0]
            b.rectangle(o, e1, e2, bsdf, emitter, mi, mo)
        elif stype == "cube":
            c = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                          for z in (-1, 1)], np.float64)
            w = _apply(m, c)
            # transformed cube: emit 12 triangles from the 8 corners
            faces = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1),
                     (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
            for f in faces:
                b.triangle(w[f[0]], w[f[1]], w[f[2]], bsdf, emitter, mi, mo)
                b.triangle(w[f[0]], w[f[2]], w[f[3]], bsdf, emitter, mi, mo)
        elif stype == "sphere":
            center = np.array(p.get("center", (0, 0, 0)))
            r = p.get("radius", 1.0)
            c_w = _apply(m, [center])[0]
            sc = np.linalg.norm(m[:3, 0])  # uniform scale assumed
            b.sphere(c_w, r * sc, bsdf, emitter, mi, mo)
        elif stype in ("obj", "ply"):
            from ..utils import meshio
            fn = os.path.join(self.dir, p.get("filename", ""))
            if stype == "obj":
                v, f, _ = meshio.load_obj(fn)
            else:
                v, f, _ = meshio.load_ply(fn)
            # flat shading, as the JAX loader builds meshes: the file's
            # vertex normals are read and not used
            self.b.mesh(_apply(m, v), f, bsdf, emitter, mi, mo)
        elif stype == "serialized":
            from ..utils import meshio
            fn = os.path.join(self.dir, p.get("filename", ""))
            v, f = meshio.load_serialized(fn, p.get("shapeIndex", 0))
            v = _apply(m, v)
            self.b.mesh(v, f, bsdf, emitter, mi, mo)
        elif stype == "disk":
            # triangulated disk in xy-plane
            nseg = 32
            ang = np.linspace(0, 2 * np.pi, nseg + 1)
            ring = np.stack([np.cos(ang), np.sin(ang),
                             np.zeros_like(ang)], -1)
            ringw = _apply(m, ring)
            cw = _apply(m, [[0, 0, 0]])[0]
            for i in range(nseg):
                b.triangle(cw, ringw[i], ringw[i + 1], bsdf, emitter,
                           mi, mo)

    # ------------------------------------------------------------------
    def load(self, device=None):
        tree = ET.parse(self.path)
        root = tree.getroot()
        for d in root.findall("default"):
            self.defaults.setdefault(d.get("name"), d.get("value"))

        for elem in root:
            if elem.tag == "integrator":
                self.integrator = {"type": elem.get("type"),
                                   **_props(elem, self.defaults)}
            elif elem.tag == "bsdf":
                bid = self._make_bsdf(elem)
                if elem.get("id"):
                    self.bsdf_ids[elem.get("id")] = bid
            elif elem.tag == "medium":
                mid = self._make_medium(elem)
                if elem.get("id"):
                    self.medium_ids[elem.get("id")] = mid
            elif elem.tag == "shape":
                self._add_shape(elem)
            elif elem.tag == "emitter":
                self._add_emitter(elem)
            elif elem.tag == "sensor":
                self._parse_sensor(elem)

        scene = self.b.build(width=self.film["width"],
                             height=self.film["height"], device=device)
        return scene, {"integrator": self.integrator, "film": self.film}

    def _add_emitter(self, elem):
        """Scene-level (non-shape) emitters: point | spot | directional |
        constant (src/emitters/*.cpp)."""
        etype = elem.get("type")
        p = _props(elem, self.defaults)
        m = _transform(elem.find("transform"), self.defaults)
        if etype == "point":
            pos = p.get("position", tuple(m[:3, 3]))
            self.b.point_light(pos, p.get("intensity", (1, 1, 1)))
        elif etype == "spot":
            origin = m[:3, 3]
            target = origin + m[:3, 2]
            cutoff = p.get("cutoffAngle", 20.0)
            beam = p.get("beamWidth", cutoff * 0.75)
            self.b.spot_light(origin, target, p.get("intensity", (1, 1, 1)),
                              cutoff_deg=cutoff, beam_width_deg=beam)
        elif etype == "directional":
            d = p.get("direction", tuple(m[:3, 2]))
            self.b.directional_light(d, p.get("irradiance", (1, 1, 1)))
        elif etype == "constant":
            self.b.constant_env(p.get("radiance", (1, 1, 1)))
        elif etype == "envmap":
            from ..utils.exr import read_exr
            fn = os.path.join(self.dir, p.get("filename", ""))
            img = read_exr(fn)
            sc = p.get("scale", 1.0)
            sc = (sc,) * 3 if not hasattr(sc, "__len__") else tuple(sc)
            self.b.envmap(img, scale=sc)
        # sun/sky: unsupported in round 1 (ignored, logged upstream)

    def _parse_sensor(self, elem):
        p = _props(elem, self.defaults)
        m = _transform(elem.find("transform"), self.defaults)
        film = elem.find("film")
        if film is not None:
            fp = _props(film, self.defaults)
            self.film["width"] = fp.get("width", 256)
            self.film["height"] = fp.get("height", 256)
        # camera medium by ref or inline
        for ref in elem.findall("ref"):
            if ref.get("id") in self.medium_ids:
                self._cam_medium = self.medium_ids[ref.get("id")]
        for meds in elem.findall("medium"):
            self._cam_medium = self._make_medium(meds)
        origin = m[:3, 3]
        fwd = m[:3, 2]
        up = m[:3, 1]
        ap = p.get("apertureRadius", 0.0) \
            if elem.get("type") == "thinlens" else 0.0
        self.b.camera(origin=origin, target=origin + fwd, up=up,
                      fov=p.get("fov", 45.0), medium=self._cam_medium,
                      aperture_radius=ap,
                      focus_distance=p.get("focusDistance", None))


def load(path, defaults=None, device=None):
    """Load a Mitsuba scene XML -> (Scene, metadata dict).

    `defaults` overrides $parameters (the CLI -D mechanism). `device`:
    None means the CUDA card, and raises without one before the file is
    read; pass "cpu" for the CPU."""
    device = resolve_device(device)
    ld = MitsubaLoader(path)
    if defaults:
        ld.defaults.update({k: str(v) for k, v in defaults.items()})
    return ld.load(device)
