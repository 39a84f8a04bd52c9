"""The open box lit by a ceiling area light, a fog box inside it and a
mirror sphere (the repository's box-medium scene)."""

from __future__ import annotations

from ..scene import CONDUCTOR, DIFFUSE, NO_MEDIUM, NULL


def _open_box(b):
    white = b.material(DIFFUSE, (0.73, 0.73, 0.73))
    red = b.material(DIFFUSE, (0.63, 0.065, 0.05))
    green = b.material(DIFFUSE, (0.14, 0.45, 0.091))
    b.rectangle([0, 0, 0], [0, 0, 1], [1, 0, 0], white)       # floor
    b.rectangle([0, 1, 0], [1, 0, 0], [0, 0, 1], white)       # ceiling
    b.rectangle([0, 0, 1], [0, 1, 0], [1, 0, 0], white)       # back
    b.rectangle([0, 0, 0], [0, 1, 0], [0, 0, 1], red)         # left
    b.rectangle([1, 0, 0], [0, 0, 1], [0, 1, 0], green)       # right


def build(b, sigma_s=0.4, sigma_a=0.05, g=0.0):
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
