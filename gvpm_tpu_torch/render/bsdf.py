"""Batched BSDF sampling and roughness classification
(mirrors the slice of gvpm_tpu/render/bsdf.py the G-VPM distance pass
runs).

Directions are in the local shading frame (z = shading normal); wi
points toward the previous vertex, wo is the sampled direction, both
away from the surface. sample() returns weight = f * |cos| / pdf.
Sampling is ported for the lobes of the built-in scenes (diffuse,
smooth conductor, null); `require_ported` rejects the others loudly.
The gather-time evaluation of every reconnectable lobe lives in
integrators/planar.py.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import warp
from ..core.math import fresnel_conductor, reflect_local
from ..scene.types import (BSDF_CONDUCTOR, BSDF_DIELECTRIC, BSDF_DIFFUSE,
                           BSDF_NULL, BSDF_PHONG, BSDF_PLASTIC,
                           BSDF_ROUGH_CONDUCTOR, BSDF_ROUGH_DIELECTRIC, Scene)

SAMPLED_TYPES = (BSDF_DIFFUSE, BSDF_CONDUCTOR, BSDF_NULL)


@dataclasses.dataclass
class BSDFSample:
    wo: torch.Tensor        # [N,3] sampled direction (local)
    weight: torch.Tensor    # [N,3] f * |cos| / pdf
    pdf: torch.Tensor       # [N] solid-angle pdf (0 for delta lobes)
    is_delta: torch.Tensor  # [N] bool
    valid: torch.Tensor     # [N] bool


def require_ported(scene: Scene):
    """Raise if the scene holds a BSDF whose sampling is not ported."""
    known = torch.tensor(SAMPLED_TYPES, device=scene.bsdf_type.device)
    if not bool(torch.isin(scene.bsdf_type, known).all()):
        raise NotImplementedError(
            "sampling of dielectric / rough / phong / plastic BSDFs: "
            "ROADMAP queue 1 item 16")


def _twosided_flip(btype, wi):
    """Non-transmissive lobes evaluate a back-side hit in the z-mirrored
    frame (bsdfs/twosided.cpp); returns the per-lane z flip."""
    transmissive = (btype == BSDF_DIELECTRIC) \
        | (btype == BSDF_ROUGH_DIELECTRIC) | (btype == BSDF_NULL)
    back = wi[..., 2] < 0.0
    return torch.where(back & ~transmissive, -1.0, 1.0)


def _flip_z(v, flip):
    return torch.stack([v[..., 0], v[..., 1], v[..., 2] * flip], dim=-1)


def sample_bsdf(scene: Scene, bi, wi, u3) -> BSDFSample:
    """Sample wo given wi. u3: [N,3] uniforms (lobe select + 2D).
    The lobes left are transport-symmetric, so radiance and importance
    transport sample alike."""
    btype = scene.bsdf_type[bi]
    albedo = scene.bsdf_albedo[bi]
    flip = _twosided_flip(btype, wi)
    wi = _flip_z(wi, flip)
    ci = wi[..., 2]
    u2 = u3[..., 1:3]

    # diffuse: cosine hemisphere on wi's side
    wo_d = warp.square_to_cosine_hemisphere(u2)
    wo_diff = torch.stack([wo_d[..., 0], wo_d[..., 1],
                           wo_d[..., 2] * torch.sign(ci)], dim=-1)
    pdf_diff = warp.square_to_cosine_hemisphere_pdf(wo_d)
    w_diff = albedo.expand(wo_d.shape[:-1] + (3,))

    # smooth conductor: delta mirror
    wo_mir = reflect_local(wi)
    w_mir = albedo * fresnel_conductor(torch.abs(ci), scene.bsdf_eta3[bi],
                                       scene.bsdf_k[bi])

    is_c = btype == BSDF_CONDUCTOR
    is_n = btype == BSDF_NULL
    wo = torch.where(is_c[..., None], wo_mir,
                     torch.where(is_n[..., None], -wi, wo_diff))
    wgt = torch.where(is_c[..., None], w_mir,
                      torch.where(is_n[..., None], torch.ones_like(albedo),
                                  w_diff))
    pdf = torch.where(is_c | is_n, 0.0, pdf_diff)
    valid = wgt.amax(-1) > 0.0
    return BSDFSample(wo=_flip_z(wo, flip), weight=wgt, pdf=pdf,
                      is_delta=is_c | is_n, valid=valid)


def effective_roughness(scene: Scene, bi):
    """Scalar roughness proxy for VertexClassifier (gvpm_struct.h:46)."""
    btype = scene.bsdf_type[bi]
    alpha = scene.bsdf_alpha[bi]
    r = torch.full_like(alpha, torch.inf)
    r = torch.where((btype == BSDF_CONDUCTOR) | (btype == BSDF_DIELECTRIC)
                    | (btype == BSDF_NULL), 0.0, r)
    r = torch.where((btype == BSDF_ROUGH_CONDUCTOR)
                    | (btype == BSDF_ROUGH_DIELECTRIC), alpha, r)
    r = torch.where(btype == BSDF_PHONG, torch.sqrt(2.0 / (alpha + 2.0)), r)
    return torch.where(btype == BSDF_PLASTIC, torch.inf, r)


def is_diffuse_like(scene: Scene, bi, bounce_roughness=0.05):
    """True where the vertex classifies 'diffuse' for shift selection."""
    return effective_roughness(scene, bi) >= bounce_roughness
