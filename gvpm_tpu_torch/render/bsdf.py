"""Batched BSDF sampling and roughness classification
(mirrors the slice of gvpm_tpu/render/bsdf.py the G-VPM distance pass
runs).

Directions are in the local shading frame (z = shading normal); wi
points toward the previous vertex, wo is the sampled direction, both
away from the surface. sample() returns weight = f * |cos| / pdf.
Sampling is ported for the lobes of the built-in scenes (diffuse,
smooth conductor, null); `require_ported` rejects the others loudly.
`eval_bsdf_pdf_params` evaluates every reconnectable lobe on tuples of
same-shape tensors ("planes"), which is how the gathers' per-pair math
(integrators/planar.py) calls it; `eval_bsdf` feeds it the scene's table
rows.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..core import warp
from ..core.math import fresnel_conductor, reflect_local
from ..scene.types import (BSDF_CONDUCTOR, BSDF_DIELECTRIC, BSDF_DIFFUSE,
                           BSDF_NULL, BSDF_PHONG, BSDF_PLASTIC,
                           BSDF_ROUGH_CONDUCTOR, BSDF_ROUGH_DIELECTRIC, Scene)

SAMPLED_TYPES = (BSDF_DIFFUSE, BSDF_CONDUCTOR, BSDF_NULL)
INV_PI = 1.0 / math.pi


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


def _fresnel_dielectric_planar(cos_i, eta):
    rel_eta = torch.where(cos_i > 0.0, eta, 1.0 / eta)
    abs_ci = torch.abs(cos_i)
    sin2_t = (1.0 - abs_ci * abs_ci) / (rel_eta * rel_eta)
    tir = sin2_t >= 1.0
    abs_ct = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    r_s = (abs_ci - rel_eta * abs_ct) / torch.clamp(
        abs_ci + rel_eta * abs_ct, min=1e-12)
    r_p = (rel_eta * abs_ci - abs_ct) / torch.clamp(
        rel_eta * abs_ci + abs_ct, min=1e-12)
    F = 0.5 * (r_s * r_s + r_p * r_p)
    return torch.where(tir, 1.0, F)


def _smith_g1_planar(cv, v_dot_m, alpha):
    back = (v_dot_m * cv) <= 0.0
    tan_t = torch.sqrt(torch.clamp(1.0 - cv * cv, min=0.0)) \
        / torch.clamp(torch.abs(cv), min=1e-9)
    a = 1.0 / torch.clamp(alpha * tan_t, min=1e-9)
    rational = (3.535 * a + 2.181 * a * a) \
        / (1.0 + 2.276 * a + 2.577 * a * a)
    g = torch.where(a < 1.6, rational, 1.0)
    return torch.where(back, 0.0, g)


def eval_bsdf_pdf_params(params, wi_loc, wo_loc):
    """(f r, f g, f b, pdf) of the reconnectable reflective lobes —
    diffuse, rough conductor (Beckmann), phong, plastic — on parameter
    planes: btype, alb (3), spec (3), eta3 (3), alpha, eta1. Delta lobes
    and rough dielectric give 0. Must match render.bsdf.eval_bsdf of the
    JAX package exactly: the shift divides it by cached base values."""
    btype = params["btype"]
    alb = params["alb"]
    spec = params["spec"]
    alpha = params["alpha"]
    eta1 = params["eta1"]

    ci, co = wi_loc[2], wo_loc[2]
    upper = (ci > 0.0) & (co > 0.0)

    pdf_diff = torch.abs(co) * INV_PI
    pdf_diff = torch.where((ci * co) > 0.0, pdf_diff, 0.0)

    # rough conductor (Beckmann)
    hx, hy, hz = (wi_loc[0] + wo_loc[0], wi_loc[1] + wo_loc[1], ci + co)
    hl = torch.sqrt(torch.clamp(hx * hx + hy * hy + hz * hz, min=1e-18))
    sgn = torch.sign(hz / hl)
    sgn = torch.where(sgn == 0.0, 1.0, sgn)
    mx, my, mz = sgn * hx / hl, sgn * hy / hl, sgn * hz / hl
    c2 = torch.clamp(mz * mz, 1e-9, 1.0)
    t2 = (1.0 - c2) / c2
    a2 = alpha * alpha
    D = torch.exp(-t2 / a2) / (math.pi * a2 * c2 * c2)
    wi_m = wi_loc[0] * mx + wi_loc[1] * my + ci * mz
    wo_m = wo_loc[0] * mx + wo_loc[1] * my + co * mz
    G = _smith_g1_planar(ci, wi_m, alpha) * _smith_g1_planar(co, wo_m, alpha)
    denom = 4.0 * torch.clamp(torch.abs(ci) * torch.abs(co), min=1e-9)
    f_rc_s = D * G / denom
    pdf_rc = D * torch.abs(mz) / torch.clamp(4.0 * torch.abs(wi_m), min=1e-9)

    def fres_c(ch):
        eta = params["eta3"][ch]
        k = params["spec"][ch]
        ci2 = torch.clamp(wi_m * wi_m, 0.0, 1.0)
        aci = torch.sqrt(ci2)
        e2k2 = eta * eta + k * k
        t0 = e2k2 * ci2
        two = 2.0 * eta * aci
        r_par2 = (t0 - two + 1.0 - ci2 + ci2 * ci2) / torch.clamp(
            t0 + two + 1.0 - ci2 + ci2 * ci2, min=1e-12)
        r_perp2 = (e2k2 - two + ci2) / torch.clamp(e2k2 + two + ci2,
                                                   min=1e-12)
        return torch.clamp(0.5 * (r_par2 + r_perp2), 0.0, 1.0)

    # phong (albedo/pi + spec*(n+2)/(2pi) cos^n); pdf mixture
    cos_r = torch.clamp(-wi_loc[0] * wo_loc[0] - wi_loc[1] * wo_loc[1]
                        + ci * co, 0.0, 1.0)
    n_exp = alpha
    ph_spec = (n_exp + 2.0) * (0.5 * INV_PI) * torch.pow(cos_r, n_exp)
    lum_d = (alb[0] + alb[1] + alb[2]) / 3.0
    lum_s = (spec[0] + spec[1] + spec[2]) / 3.0
    w_spec = lum_s / torch.clamp(lum_d + lum_s, min=1e-9)
    pdf_ph = ((1.0 - w_spec) * pdf_diff
              + w_spec * (n_exp + 1.0) * (0.5 * INV_PI)
              * torch.pow(cos_r, n_exp))

    # plastic: Fresnel-weighted diffuse
    Fi = _fresnel_dielectric_planar(torch.abs(ci), eta1)
    Fo = _fresnel_dielectric_planar(torch.abs(co), eta1)
    f_pl_s = (1.0 - Fi) * (1.0 - Fo) * INV_PI
    pdf_pl = (1.0 - Fi) * pdf_diff

    is_d = btype == BSDF_DIFFUSE
    is_rc = btype == BSDF_ROUGH_CONDUCTOR
    is_ph = btype == BSDF_PHONG
    is_pl = btype == BSDF_PLASTIC

    def chan(ch):
        f = torch.where(is_d, alb[ch] * INV_PI, 0.0)
        f = torch.where(is_rc, alb[ch] * f_rc_s * fres_c(ch), f)
        f = torch.where(is_ph, alb[ch] * INV_PI + spec[ch] * ph_spec, f)
        f = torch.where(is_pl, alb[ch] * f_pl_s, f)
        return torch.where(upper, f, 0.0)

    pdf = torch.where(is_d, pdf_diff, 0.0)
    pdf = torch.where(is_rc, pdf_rc, pdf)
    pdf = torch.where(is_ph, pdf_ph, pdf)
    pdf = torch.where(is_pl, pdf_pl, pdf)
    pdf = torch.where(upper, pdf, 0.0)
    return chan(0), chan(1), chan(2), pdf


def eval_bsdf(scene: Scene, bi, wi, wo):
    """f(wi, wo) without cosine and the pdf of sampling wo given wi ->
    (f [N,3], pdf [N]), for the reconnectable reflective lobes (diffuse,
    rough conductor, phong, plastic); delta lobes and rough dielectric
    give 0. These lobes are transport-symmetric, so radiance and
    importance transport evaluate alike. The lobe formulas are those of
    the gathers (eval_bsdf_pdf_params), fed the scene's table rows."""
    btype = scene.bsdf_type[bi]
    flip = _twosided_flip(btype, wi)
    wi = _flip_z(wi, flip)
    wo = _flip_z(wo, flip)
    params = dict(btype=btype, alb=scene.bsdf_albedo[bi].unbind(-1),
                  spec=scene.bsdf_k[bi].unbind(-1),
                  eta3=scene.bsdf_eta3[bi].unbind(-1),
                  alpha=scene.bsdf_alpha[bi], eta1=scene.bsdf_eta[bi])
    fr, fg, fb, pdf = eval_bsdf_pdf_params(params, wi.unbind(-1),
                                           wo.unbind(-1))
    return torch.stack([fr, fg, fb], dim=-1), pdf
