"""Batched 3D math primitives (mirrors gvpm_tpu/core/math.py).

A "vector" is a tensor whose last axis has size 3.
"""

from __future__ import annotations

import torch

EPS = 1e-4          # ray epsilon


def dot(a, b, keepdims=False):
    return (a * b).sum(-1, keepdim=keepdims)


def cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def length(v, keepdims=False):
    return torch.sqrt(torch.clamp(dot(v, v, keepdims=keepdims), min=0.0))


def normalize(v):
    return v * torch.reciprocal(
        torch.clamp(length(v, keepdims=True), min=1e-20))


def safe_sqrt(x):
    return torch.sqrt(torch.clamp(x, min=0.0))


def safe_rcp(x, eps=1e-20):
    """Reciprocal with sign-preserving clamp away from zero."""
    ax = torch.clamp(torch.abs(x), min=eps)
    return torch.sign(torch.where(x == 0.0, 1.0, x)) / ax


def coordinate_system(n):
    """Duff et al. branchless ONB around unit normal n -> (s, t)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    s = torch.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], dim=-1)
    t = torch.stack([b, sign + ny * ny * a, -ny], dim=-1)
    return s, t


def to_local(n, s, t, v):
    return torch.stack([dot(v, s), dot(v, t), dot(v, n)], dim=-1)


def to_world(n, s, t, v):
    return s * v[..., 0:1] + t * v[..., 1:2] + n * v[..., 2:3]


def reflect_local(wo):
    return torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], dim=-1)


def fresnel_conductor(cos_i, eta, k):
    """Approximate unpolarized conductor Fresnel (per-channel eta, k)."""
    ci2 = torch.clamp(cos_i * cos_i, 0.0, 1.0)[..., None]
    e2k2 = eta * eta + k * k
    t0 = e2k2 * ci2
    two_e_ci = 2.0 * eta * torch.sqrt(ci2)
    r_par2 = (t0 - two_e_ci + 1.0 - ci2 + ci2 * ci2) / torch.clamp(
        t0 + two_e_ci + 1.0 - ci2 + ci2 * ci2, min=1e-12)
    r_perp2 = (e2k2 - two_e_ci + ci2) / torch.clamp(
        e2k2 + two_e_ci + ci2, min=1e-12)
    return torch.clamp(0.5 * (r_par2 + r_perp2), 0.0, 1.0)
