"""Phase functions: isotropic, Henyey-Greenstein, Rayleigh (mirrors
gvpm_tpu/render/phase.py::sample_phase and ::eval_phase). Value == pdf; `wi`
points toward the previous vertex, `wo` toward the next."""

from __future__ import annotations

import math

import torch

from ..core import warp
from ..core.math import coordinate_system, dot, safe_sqrt, to_world
from ..scene.types import PHASE_HG, PHASE_RAYLEIGH, Scene


def rayleigh_pdf(cos_theta):
    return 3.0 / (16.0 * math.pi) * (1.0 + cos_theta * cos_theta)


def _rayleigh_sample_cos(u):
    """Invert the Rayleigh CDF (Cardano, single real root)."""
    d = 4.0 - 8.0 * u
    s = torch.sqrt(d * d * 0.25 + 1.0)
    a = -0.5 * d + s
    b = -0.5 * d - s
    return (torch.sign(a) * torch.abs(a) ** (1.0 / 3.0)
            + torch.sign(b) * torch.abs(b) ** (1.0 / 3.0))


def sample_phase(scene: Scene, mi, wi, u2):
    """Sample wo; returns (wo [N,3], pdf [N]). Weight is always 1."""
    idx = torch.clamp(mi, 0, scene.med_g.shape[0] - 1)
    g = scene.med_g[idx]
    ptype = scene.med_phase[idx]
    fwd = -wi
    d_local, pdf_hg = warp.square_to_hg(u2, g)
    s, t = coordinate_system(fwd)
    wo_hg = to_world(fwd, s, t, d_local)
    wo_iso = warp.square_to_uniform_sphere(u2)
    cos_r = torch.clamp(_rayleigh_sample_cos(u2[..., 0]), -1.0, 1.0)
    sin_r = safe_sqrt(1.0 - cos_r * cos_r)
    phi = 2.0 * math.pi * u2[..., 1]
    wo_ray = to_world(fwd, s, t, torch.stack(
        [sin_r * torch.cos(phi), sin_r * torch.sin(phi), cos_r], dim=-1))
    is_hg = ptype == PHASE_HG
    is_ray = ptype == PHASE_RAYLEIGH
    wo = torch.where(is_hg[..., None], wo_hg,
                     torch.where(is_ray[..., None], wo_ray, wo_iso))
    pdf = torch.where(is_hg, pdf_hg,
                      torch.where(is_ray, rayleigh_pdf(cos_r),
                                  warp.INV_FOURPI))
    return wo, pdf


def eval_phase(scene: Scene, mi, wi, wo):
    """p(wi -> wo); returns [N]. mi: medium index per lane (>= 0)."""
    idx = torch.clamp(mi, 0, scene.med_g.shape[0] - 1)
    g = scene.med_g[idx]
    ptype = scene.med_phase[idx]
    cos_theta = dot(-wi, wo)
    return torch.where(ptype == PHASE_HG, warp.hg_pdf(cos_theta, g),
                       torch.where(ptype == PHASE_RAYLEIGH,
                                   rayleigh_pdf(cos_theta),
                                   warp.INV_FOURPI))
