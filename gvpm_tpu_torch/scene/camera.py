"""Perspective camera with ray differentials: a pinhole, or a thinlens
(mirrors gvpm_tpu/scene/camera.py::generate_rays; reference:
src/sensors/perspective.cpp, thinlens.cpp).

Camera space +x right, +y up, +z forward; pixel (0,0) is the top-left
corner of the film; fov is the horizontal field of view.
"""

from __future__ import annotations

import torch

from ..core.math import dot, normalize
from ..core.warp import square_to_uniform_disk_concentric
from .types import Scene


def generate_rays(scene: Scene, px, py, u, u_lens=None):
    """Primary rays through pixel (px, py) at in-pixel offset u in
    [0,1)^2 -> (o, d, spread); the pixel's world radius at distance t
    along the ray is ~ spread * t. A thinlens (scene.cam_aperture > 0)
    re-aims the pinhole ray from the lens-disk point of u_lens at its
    focal-plane point; without u_lens the ray leaves the lens center."""
    m = scene.cam_to_world
    right, up, fwd, origin = m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3]
    W, H = scene.width, scene.height
    aspect = H / W
    thf = scene.cam_tan_half_fov_x
    sx = ((px + u[..., 0]) / W) * 2.0 - 1.0
    sy = 1.0 - ((py + u[..., 1]) / H) * 2.0
    dx = sx * thf
    dy = sy * thf * aspect
    d = normalize(dx[..., None] * right + dy[..., None] * up
                  + torch.ones_like(dx)[..., None] * fwd)
    o = origin.expand(d.shape)
    if scene.cam_aperture > 0.0 and u_lens is not None:
        t_focus = scene.cam_focus / torch.clamp(dot(d, fwd), min=1e-6)
        pf = o + d * t_focus[..., None]
        lens = square_to_uniform_disk_concentric(u_lens) \
            * scene.cam_aperture
        o = origin + right * lens[..., 0:1] + up * lens[..., 1:2]
        d = normalize(pf - o)
    pix_dx = 2.0 * thf / W
    inv_len = torch.reciprocal(torch.sqrt(1.0 + dx * dx + dy * dy))
    return o, d, pix_dx * inv_len
