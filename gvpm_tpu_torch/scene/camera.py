"""Perspective camera with ray differentials: a pinhole, or a thinlens
(mirrors gvpm_tpu/scene/camera.py; reference:
src/sensors/perspective.cpp, thinlens.cpp). `project` and
`importance_weight` connect light-path vertices to the pinhole (the
light tracer and VPL).

Camera space +x right, +y up, +z forward; pixel (0,0) is the top-left
corner of the film; fov is the horizontal field of view.
"""

from __future__ import annotations

import torch

from ..core.math import dot, normalize
from ..core.warp import square_to_uniform_disk_concentric
from .types import Scene


def _cam_axes(scene: Scene):
    m = scene.cam_to_world
    return m[:3, 3], m[:3, 0], m[:3, 1], m[:3, 2]


def pixel_grid(scene: Scene):
    """Float pixel coordinates (px, py) [H*W] of the film, row-major."""
    py, px = torch.meshgrid(
        torch.arange(scene.height, device=scene.device, dtype=torch.float32),
        torch.arange(scene.width, device=scene.device, dtype=torch.float32),
        indexing="ij")
    return px.reshape(-1), py.reshape(-1)


def generate_rays(scene: Scene, px, py, u, u_lens=None):
    """Primary rays through pixel (px, py) at in-pixel offset u in
    [0,1)^2 -> (o, d, spread); the pixel's world radius at distance t
    along the ray is ~ spread * t. A thinlens (scene.cam_aperture > 0)
    re-aims the pinhole ray from the lens-disk point of u_lens at its
    focal-plane point; without u_lens the ray leaves the lens center."""
    origin, right, up, fwd = _cam_axes(scene)
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


def project(scene: Scene, p):
    """World points -> (px, py, inside, dist): the inverse of
    generate_rays for the pinhole (PathVertex::sampleSensor,
    vertex.h:360)."""
    origin, right, up, fwd = _cam_axes(scene)
    W, H = scene.width, scene.height
    thf = scene.cam_tan_half_fov_x
    v = p - origin
    z = dot(v, fwd)
    valid = z > 1e-6
    zs = torch.where(valid, z, 1.0)
    sx = dot(v, right) / zs / thf
    sy = dot(v, up) / zs / (thf * (H / W))
    px = (sx + 1.0) * 0.5 * W
    py = (1.0 - sy) * 0.5 * H
    inside = valid & (px >= 0) & (px < W) & (py >= 0) & (py < H)
    return px, py, inside, torch.sqrt(torch.clamp(dot(v, v), min=1e-20))


def importance_weight(scene: Scene, d_world):
    """We(d) per pixel for a pinhole whose film maps to [-1,1]^2 on the
    focal plane: W*H / (4 tan^2(fov_x/2) aspect cos^3) (perspective.cpp
    importance), so that splatting integrates to the box-filtered
    image."""
    _, _, _, fwd = _cam_axes(scene)
    cos_t = dot(d_world, fwd)
    W, H = scene.width, scene.height
    thf = scene.cam_tan_half_fov_x
    film_area = 4.0 * thf * (thf * (H / W))
    valid = cos_t > 1e-6
    c = torch.where(valid, cos_t, 1.0)
    return torch.where(valid, (W * H) / (film_area * c * c * c), 0.0)
