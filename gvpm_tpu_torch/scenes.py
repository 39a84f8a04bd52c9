"""Built-in scene registry (mirrors gvpm_tpu/scenes.py, trimmed to the
homogeneous-medium box the G-VPM distance pass is gated on)."""

from __future__ import annotations

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


def box_medium(width=256, height=256, sigma_s=0.4, sigma_a=0.05, g=0.0,
               device="cpu"):
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


REGISTRY = {"box-medium": box_medium}


def get(name, **kw):
    if name not in REGISTRY:
        raise NotImplementedError(
            f"scene {name!r}: the remaining built-in scenes "
            "(caustic_glass, laser_beam) come with ROADMAP queue 1 item 16")
    return REGISTRY[name](**kw)
