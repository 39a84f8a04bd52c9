"""Built-in scene registry (mirrors gvpm_tpu/scenes.py): a surface-only
box, the homogeneous-medium box with isotropic or anisotropic fog, a
caustic through a glass sphere into fog, and a laser-like shaft through
dense fog. Every builder takes `device`: None builds on the CUDA card
(and raises without one); pass "cpu" to build on the CPU."""

from __future__ import annotations

import numpy as np

from .scene.builder import SceneBuilder


def _open_box(b, white=None):
    w = white if white is not None else b.diffuse([0.73, 0.73, 0.73])
    red = b.diffuse([0.63, 0.065, 0.05])
    green = b.diffuse([0.14, 0.45, 0.091])
    b.rectangle([0, 0, 0], [0, 0, 1], [1, 0, 0], w)         # floor
    b.rectangle([0, 1, 0], [1, 0, 0], [0, 0, 1], w)         # ceiling
    b.rectangle([0, 0, 1], [0, 1, 0], [1, 0, 0], w)         # back
    b.rectangle([0, 0, 0], [0, 1, 0], [0, 0, 1], red)       # left
    b.rectangle([1, 0, 0], [0, 0, 1], [0, 1, 0], green)     # right
    return w


def box_surface(width=256, height=256, device=None):
    """Surface-only cornell box with a mirror and a glass sphere."""
    b = SceneBuilder()
    _open_box(b)
    light = b.area_light([17.0, 12.0, 4.0])
    b.rectangle([0.34, 0.998, 0.34], [0.32, 0, 0], [0, 0, 0.32],
                b.diffuse([0, 0, 0]), emitter=light)
    mirror = b.conductor()
    b.sphere([0.3, 0.18, 0.6], 0.18, mirror)
    glass = b.dielectric(int_ior=1.5)
    b.sphere([0.72, 0.16, 0.35], 0.16, glass)
    b.camera(origin=[0.5, 0.5, -1.35], target=[0.5, 0.5, 0.5], fov=40)
    return b.build(width=width, height=height, device=device)


def box_medium(width=256, height=256, sigma_s=0.4, sigma_a=0.05, g=0.0,
               device=None):
    """Homogeneous-medium box (BASELINE configs 1-2)."""
    b = SceneBuilder()
    _open_box(b)
    light = b.area_light([20.0, 17.0, 9.0])
    b.rectangle([0.34, 0.998, 0.34], [0.32, 0, 0], [0, 0, 0.32],
                b.diffuse([0, 0, 0]), emitter=light)
    m = b.homogeneous(sigma_a=[sigma_a] * 3, sigma_s=[sigma_s] * 3, g=g)
    b.medium_box([0.02, 0.02, 0.02], [0.98, 0.98, 0.98], m)
    mirror = b.conductor()
    b.sphere([0.32, 0.2, 0.62], 0.2, mirror)
    b.camera(origin=[0.5, 0.5, -1.35], target=[0.5, 0.5, 0.5], fov=40)
    return b.build(width=width, height=height, device=device)


def caustic_glass(width=256, height=256, device=None):
    """Glass sphere focusing light into a medium (caustic / ME case)."""
    b = SceneBuilder()
    _open_box(b)
    light = b.area_light([40.0, 38.0, 33.0])
    b.rectangle([0.42, 0.998, 0.42], [0.16, 0, 0], [0, 0, 0.16],
                b.diffuse([0, 0, 0]), emitter=light)
    m = b.homogeneous(sigma_a=[0.02] * 3, sigma_s=[0.25] * 3, g=0.4)
    b.medium_box([0.02, 0.02, 0.02], [0.98, 0.98, 0.98], m)
    glass = b.dielectric(int_ior=1.5)
    b.sphere([0.5, 0.62, 0.5], 0.16, glass)
    b.camera(origin=[0.5, 0.45, -1.35], target=[0.5, 0.45, 0.5], fov=38)
    return b.build(width=width, height=height, device=device)


def laser_beam(width=256, height=256, device=None):
    """Narrow emitter driving a bright shaft through dense fog (the
    LASER scene's analog: the beam and plane estimators' stress case)."""
    b = SceneBuilder()
    dark = b.diffuse([0.2, 0.2, 0.22])
    _open_box(b, white=dark)
    light = b.area_light([900.0, 850.0, 800.0])
    # small tilted emitter near the upper-left corner aiming into the fog
    b.rectangle([0.06, 0.9, 0.3], [0.03, 0.0, 0.015],
                [0.0, 0.02, -0.025], b.diffuse([0, 0, 0]), emitter=light)
    m = b.homogeneous(sigma_a=[0.03] * 3, sigma_s=[0.9] * 3, g=0.7)
    b.medium_box([0.02, 0.02, 0.02], [0.98, 0.98, 0.98], m)
    b.camera(origin=[0.5, 0.5, -1.35], target=[0.5, 0.5, 0.5], fov=40)
    return b.build(width=width, height=height, device=device)


FEATURES = ("het", "lights", "envmap", "materials", "bare")


def feature_box(b, kind, seed=0, grid=32):
    """Fill builder `b` (this package's SceneBuilder, or any builder with
    its methods) with a test scene of the scene-description features the
    registry scenes leave out, and return it:

      het       — the open box and its area light around a heterogeneous
                  fog: a grid^3 density from `seed`, non-gray sigma_t;
      lights    — the open box in Rayleigh fog lit by a point, a spot and
                  a directional light and a constant environment;
      envmap    — the open box in HG fog lit by a lat-long environment
                  map from `seed` alone (no area light), a rough
                  dielectric sphere;
      materials — an area-lit box whose walls are plastic, phong (low
                  exponent) and rough conductor (alpha 0.3), fog inside,
                  seen through a thinlens;
      bare      — no triangle and no area light: a diffuse sphere under a
                  point light."""
    rs = np.random.default_rng(seed)
    cam = dict(origin=[0.5, 0.5, -1.35], target=[0.5, 0.5, 0.5], fov=40)
    if kind == "bare":
        b.sphere([0.0, 0.0, 0.0], 0.5, b.diffuse([0.7, 0.6, 0.5]))
        b.point_light([0.8, 1.2, -0.9], [6.0, 6.0, 6.0])
        b.camera(origin=[0, 0, -2.5], target=[0, 0, 0], fov=35)
        return b
    if kind == "materials":
        w = b.plastic(diffuse=[0.6, 0.6, 0.55], int_ior=1.5)
        _open_box(b, white=w)
        back = b.phong(diffuse=[0.3, 0.35, 0.3], specular=[0.4, 0.4, 0.4],
                       exponent=4.0)
        b.rectangle([0, 0, 0.999], [0, 1, 0], [1, 0, 0], back)
        metal = b.rough_conductor(alpha=0.3)
        b.rectangle([0.001, 0, 0], [0, 1, 0], [0, 0, 1], metal)
        b.sphere([0.65, 0.2, 0.55], 0.18, b.rough_conductor(alpha=0.3))
    else:
        _open_box(b)
    if kind in ("het", "materials"):
        light = b.area_light([20.0, 17.0, 9.0])
        b.rectangle([0.34, 0.998, 0.34], [0.32, 0, 0], [0, 0, 0.32],
                    b.diffuse([0, 0, 0]), emitter=light)
    lo, hi = [0.02, 0.02, 0.02], [0.98, 0.98, 0.98]
    if kind == "het":
        density = rs.gamma(2.0, 0.5, (grid, grid, grid)).astype(np.float32)
        m = b.heterogeneous(density, lo, hi, sigma_t_scale=(0.9, 0.7, 0.5),
                            albedo=(0.8, 0.85, 0.9), g=0.3)
    elif kind == "lights":
        m = b.homogeneous(sigma_a=[0.03] * 3, sigma_s=[0.3] * 3,
                          phase="rayleigh")
        b.point_light([0.3, 0.8, 0.4], [0.6, 0.5, 0.4])
        b.spot_light([0.7, 0.9, 0.3], [0.5, 0.0, 0.6], [3.0, 3.0, 2.5],
                     cutoff_deg=25.0)
        b.directional_light([0.3, -0.5, 1.0], [0.8, 0.8, 1.0])
        b.constant_env([0.05, 0.06, 0.08])
    elif kind == "envmap":
        m = b.homogeneous(sigma_a=[0.02] * 3, sigma_s=[0.2] * 3, g=0.5)
        img = rs.random((8, 16, 3)).astype(np.float32) * 0.3
        img[2, 5] = [8.0, 7.0, 5.0]                    # a sun
        b.envmap(img, scale=(1.0, 1.0, 1.2))
        b.sphere([0.5, 0.3, 0.5], 0.2, b.rough_dielectric(alpha=0.2))
    else:
        m = b.homogeneous(sigma_a=[0.05] * 3, sigma_s=[0.3] * 3, g=0.2)
    b.medium_box(lo, hi, m)
    if kind == "materials":
        cam.update(aperture_radius=0.05, focus_distance=1.6)
    b.camera(**cam)
    return b


def feature_scene(kind, width=256, height=256, seed=0, grid=32,
                  device=None):
    """`feature_box` built by this package's SceneBuilder."""
    return feature_box(SceneBuilder(), kind, seed, grid).build(
        width=width, height=height, device=device)


REGISTRY = {
    "box-surface": box_surface,
    "box-medium": box_medium,
    "box-medium-hg": lambda **kw: box_medium(g=0.5, **kw),
    "caustic-glass": caustic_glass,
    "laser": laser_beam,
}


def get(name, **kw):
    return REGISTRY[name](**kw)
