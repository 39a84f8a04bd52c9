"""Sampling warps (mirrors the slice of gvpm_tpu/core/warp.py the
G-VPM distance pass uses)."""

from __future__ import annotations

import math

import torch

from .math import safe_sqrt

INV_PI = 1.0 / math.pi
INV_FOURPI = 1.0 / (4.0 * math.pi)


def square_to_uniform_sphere(u):
    z = 1.0 - 2.0 * u[..., 0]
    r = safe_sqrt(1.0 - z * z)
    phi = 2.0 * math.pi * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def square_to_cosine_hemisphere(u):
    d = square_to_uniform_disk_concentric(u)
    z = safe_sqrt(1.0 - d[..., 0] ** 2 - d[..., 1] ** 2)
    return torch.stack([d[..., 0], d[..., 1], z], dim=-1)


def square_to_cosine_hemisphere_pdf(v):
    return torch.clamp(v[..., 2], min=0.0) * INV_PI


def square_to_uniform_disk_concentric(u):
    x = 2.0 * u[..., 0] - 1.0
    y = 2.0 * u[..., 1] - 1.0
    use_x = torch.abs(x) > torch.abs(y)
    r = torch.where(use_x, x, y)
    phi = torch.where(
        use_x,
        (math.pi / 4.0) * torch.where(
            torch.abs(x) > 1e-12, y / torch.where(x == 0, 1.0, x), 0.0),
        (math.pi / 2.0) - (math.pi / 4.0) * torch.where(
            torch.abs(y) > 1e-12, x / torch.where(y == 0, 1.0, y), 0.0),
    )
    both_zero = (x == 0.0) & (y == 0.0)
    r = torch.where(both_zero, 0.0, r)
    phi = torch.where(both_zero, 0.0, phi)
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)


def square_to_uniform_triangle(u):
    su = safe_sqrt(u[..., 0])
    return torch.stack([1.0 - su, u[..., 1] * su], dim=-1)


def square_to_hg(u, g):
    """Henyey-Greenstein direction around +z, with pdf (hg.cpp)."""
    iso = torch.abs(g) < 1e-3
    sqr = (1.0 - g * g) / torch.clamp(1.0 - g + 2.0 * g * u[..., 0],
                                      min=1e-12)
    lo = torch.where(g >= 0, 1e-12, -math.inf)
    cos_t_hg = torch.where(
        torch.abs(g) > 1e-12,
        (1.0 + g * g - sqr * sqr) / torch.maximum(2.0 * g, lo), 0.0)
    cos_t = torch.where(iso, 1.0 - 2.0 * u[..., 0],
                        torch.clamp(cos_t_hg, -1.0, 1.0))
    sin_t = safe_sqrt(1.0 - cos_t * cos_t)
    phi = 2.0 * math.pi * u[..., 1]
    d = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t],
                    dim=-1)
    return d, hg_pdf(cos_t, g)


def hg_pdf(cos_theta, g):
    """HG value == pdf; cos_theta between propagation directions."""
    denom = 1.0 + g * g - 2.0 * g * cos_theta
    return INV_FOURPI * (1.0 - g * g) / torch.clamp(
        denom * safe_sqrt(denom), min=1e-12)
