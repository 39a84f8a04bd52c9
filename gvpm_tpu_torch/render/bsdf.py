"""Batched BSDF sampling, evaluation and roughness classification
(mirrors gvpm_tpu/render/bsdf.py; reference: bsdfs/diffuse.cpp,
conductor.cpp, dielectric.cpp, roughconductor.cpp, roughdielectric.cpp,
phong.cpp, plastic.cpp, null.cpp).

Every lane computes every lobe and selects by `bsdf_type`. Directions
are in the local shading frame (z = shading normal); wi points toward
the previous vertex, wo is the sampled direction, both away from the
surface. sample() returns weight = f * |cos| / pdf; eval() returns f
without the cosine. `transport` is 'radiance' (camera paths) or
'importance' (light paths): refraction compresses radiance by 1/eta^2.
`eval_bsdf_pdf_params` evaluates the reconnectable reflective lobes on
tuples of same-shape tensors ("planes"), which is how the gathers'
per-pair math (integrators/planar.py) calls it; `eval_bsdf` feeds it the
scene's table rows and adds the rough dielectric.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..core import warp
from ..core.math import (coordinate_system, fresnel_conductor,
                         fresnel_dielectric, reflect_local, safe_sqrt,
                         to_world)
from ..scene.types import (BSDF_CONDUCTOR, BSDF_DIELECTRIC, BSDF_DIFFUSE,
                           BSDF_NULL, BSDF_PHONG, BSDF_PLASTIC,
                           BSDF_ROUGH_CONDUCTOR, BSDF_ROUGH_DIELECTRIC, Scene)

INV_PI = 1.0 / math.pi


@dataclasses.dataclass
class BSDFSample:
    wo: torch.Tensor        # [N,3] sampled direction (local)
    weight: torch.Tensor    # [N,3] f * |cos| / pdf
    pdf: torch.Tensor       # [N] solid-angle pdf (0 for delta lobes)
    is_delta: torch.Tensor  # [N] bool
    eta: torch.Tensor       # [N] relative IOR of the event (1 if none)
    valid: torch.Tensor     # [N] bool


def _twosided_flip(btype, wi):
    """Non-transmissive lobes evaluate a back-side hit in the z-mirrored
    frame (bsdfs/twosided.cpp); transmissive ones keep the signed frame,
    whose sign drives the relative IOR. Returns the per-lane z flip."""
    transmissive = (btype == BSDF_DIELECTRIC) \
        | (btype == BSDF_ROUGH_DIELECTRIC) | (btype == BSDF_NULL)
    back = wi[..., 2] < 0.0
    return torch.where(back & ~transmissive, -1.0, 1.0)


def _flip_z(v, flip):
    return torch.stack([v[..., 0], v[..., 1], v[..., 2] * flip], dim=-1)


def _dot(a, b):
    return (a * b).sum(-1)


# ------------------------- microfacet (Beckmann) ---------------------------

def _beckmann_d(m, alpha):
    c2 = torch.clamp(m[..., 2] ** 2, 1e-9, 1.0)
    t2 = (1.0 - c2) / c2
    a2 = alpha * alpha
    return torch.exp(-t2 / a2) / (math.pi * a2 * c2 * c2)


def _smith_g1(v, m, alpha):
    cv = v[..., 2]
    back = (_dot(v, m) * cv) <= 0.0
    tan_t = safe_sqrt(1.0 - cv * cv) / torch.clamp(torch.abs(cv), min=1e-9)
    a = 1.0 / torch.clamp(alpha * tan_t, min=1e-9)
    rational = (3.535 * a + 2.181 * a * a) / (1.0 + 2.276 * a + 2.577 * a * a)
    g = torch.where(a < 1.6, rational, 1.0)
    return torch.where(back, 0.0, g)


def _sample_beckmann(u, alpha):
    """Half-vector from D(m)|cos m| -> (m, pdf)."""
    a2 = alpha * alpha
    log_u = torch.log(torch.clamp(1.0 - u[..., 0], min=1e-20))
    t2 = -a2 * log_u
    c2 = 1.0 / (1.0 + t2)
    cos_t = torch.sqrt(c2)
    sin_t = safe_sqrt(1.0 - c2)
    phi = 2.0 * math.pi * u[..., 1]
    m = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t],
                    dim=-1)
    return m, _beckmann_d(m, alpha) * cos_t


def _rough_dielectric_eval(albedo, alpha, eta, wi, wo, transport):
    """Walter et al. 2007 microfacet transmission (Beckmann), reflection
    and refraction lobes merged -> (f [N,3], pdf [N])
    (roughdielectric.cpp eval / pdf)."""
    ci, co = wi[..., 2], wo[..., 2]
    reflect = (ci * co) > 0.0
    rel = torch.where(ci > 0.0, eta, 1.0 / eta)
    m = torch.where(reflect[..., None], wi + wo, wi + rel[..., None] * wo)
    m_len = torch.sqrt(torch.clamp(_dot(m, m), min=1e-18))
    m = m / m_len[..., None]
    m = m * torch.sign(m[..., 2])[..., None]          # orient to +z
    wi_m, wo_m = _dot(wi, m), _dot(wo, m)
    F, _ = fresnel_dielectric(wi_m, eta)
    D = _beckmann_d(m, alpha)
    G = _smith_g1(wi, m, alpha) * _smith_g1(wo, m, alpha)
    pdf_m = D * torch.abs(m[..., 2])

    f_r = F * D * G / torch.clamp(4.0 * torch.abs(ci * co), min=1e-9)
    pdf_r = pdf_m * F / torch.clamp(4.0 * torch.abs(wo_m), min=1e-9)
    # refraction (Walter eq. 21): sqrtDenom = wi.m + rel * wo.m
    denom = wi_m + rel * wo_m
    denom2 = torch.clamp(denom * denom, min=1e-9)
    f_t = (torch.abs(wi_m * wo_m) / torch.clamp(torch.abs(ci * co), min=1e-9)
           * rel * rel * (1.0 - F) * G * D / denom2)
    if transport == "radiance":
        f_t = f_t / torch.clamp(rel * rel, min=1e-9)
    pdf_t = pdf_m * (1.0 - F) * rel * rel * torch.abs(wo_m) / denom2
    t_ok = (wi_m * wo_m) < 0.0
    f = torch.where(reflect, f_r, torch.where(t_ok, f_t, 0.0))
    pdf = torch.where(reflect, pdf_r, torch.where(t_ok, pdf_t, 0.0))
    return albedo * f[..., None], pdf


def _rough_dielectric_sample(albedo, alpha, eta, wi, u0, u2, transport):
    """Sample the Walter model (roughdielectric.cpp sample) ->
    (wo, weight, pdf, eta_out, ok)."""
    ci = wi[..., 2]
    m, pdf_m = _sample_beckmann(u2, alpha)          # up-oriented
    wi_m = _dot(wi, m)
    F, _ = fresnel_dielectric(wi_m, eta)
    choose_refl = u0 < F
    wo_r = 2.0 * wi_m[..., None] * m - wi
    rel = torch.where(wi_m > 0.0, eta, 1.0 / eta)   # n_t / n_i
    eta_r = 1.0 / rel
    cos2_t = 1.0 - eta_r * eta_r * (1.0 - wi_m * wi_m)
    cos_t = safe_sqrt(cos2_t)
    wo_t = eta_r[..., None] * (-wi) + (
        (eta_r * torch.abs(wi_m) - cos_t) * torch.sign(wi_m))[..., None] * m
    wo = torch.where(choose_refl[..., None], wo_r, wo_t)
    wo_m = _dot(wo, m)
    co = wo[..., 2]
    side_ok = torch.where(choose_refl, (ci * co) > 0.0, (ci * co) < 0.0)
    G = _smith_g1(wi, m, alpha) * _smith_g1(wo, m, alpha)
    # Walter eq. 41 weight for D|cos m| sampling (F cancels with the
    # lobe pick)
    w = torch.abs(wi_m) * G / torch.clamp(
        torch.abs(ci) * torch.abs(m[..., 2]), min=1e-9)
    if transport == "radiance":
        w = torch.where(choose_refl, w, w / torch.clamp(rel * rel, min=1e-9))
    denom = wi_m + rel * wo_m
    denom2 = torch.clamp(denom * denom, min=1e-9)
    pdf = torch.where(
        choose_refl, pdf_m * F / torch.clamp(4.0 * torch.abs(wo_m), min=1e-9),
        pdf_m * (1.0 - F) * rel * rel * torch.abs(wo_m) / denom2)
    ok = side_ok & (G > 0.0) & (choose_refl | (cos2_t > 0.0))
    weight = albedo * torch.where(ok, w, 0.0)[..., None]
    return wo, weight, pdf, torch.where(choose_refl, 1.0, rel), ok


def _phong_eval_pdf(albedo, spec, n_exp, w_spec, wi, wo):
    wr = reflect_local(wi)
    cos_r = torch.clamp(_dot(wr, wo), 0.0, 1.0)
    f = (albedo * INV_PI
         + spec * ((n_exp + 2.0) * (0.5 * INV_PI)
                   * torch.pow(cos_r, n_exp))[..., None])
    pdf_d = torch.abs(wo[..., 2]) * INV_PI
    pdf_s = (n_exp + 1.0) * (0.5 * INV_PI) * torch.pow(cos_r, n_exp)
    return f, (1.0 - w_spec) * pdf_d + w_spec * pdf_s


# ------------------------------ sample -------------------------------------

def sample_bsdf(scene: Scene, bi, wi, u3, transport="radiance") -> BSDFSample:
    """Sample wo given wi. u3: [N,3] uniforms (lobe select + 2D). Only
    the lobes of the types the scene holds are computed."""
    kinds = scene.bsdf_kinds
    btype = scene.bsdf_type[bi]
    albedo = scene.bsdf_albedo[bi]
    alpha = scene.bsdf_alpha[bi]
    eta = scene.bsdf_eta[bi]
    eta3 = scene.bsdf_eta3[bi]
    spec = scene.bsdf_k[bi]           # conductor k; phong specular
    flip = _twosided_flip(btype, wi)
    wi = _flip_z(wi, flip)
    ci = wi[..., 2]
    u0 = u3[..., 0]
    u2 = u3[..., 1:3]
    ones = torch.ones_like(ci)
    zero = torch.zeros_like(ci)
    yes = torch.ones_like(ci, dtype=torch.bool)
    no = torch.zeros_like(yes)
    lobes = {}                  # type -> (wo, weight, pdf, is_delta, eta)

    # diffuse: cosine hemisphere on wi's side (also phong's and plastic's
    # diffuse part)
    wo_d = warp.square_to_cosine_hemisphere(u2)
    wo_diff = torch.stack([wo_d[..., 0], wo_d[..., 1],
                           wo_d[..., 2] * torch.sign(ci)], dim=-1)
    pdf_diff = warp.square_to_cosine_hemisphere_pdf(wo_d)
    w_diff = albedo.expand(wo_d.shape[:-1] + (3,))
    wo_mir = reflect_local(wi)

    # smooth conductor: delta mirror
    if BSDF_CONDUCTOR in kinds:
        w_mir = albedo * fresnel_conductor(torch.abs(ci), eta3, spec)
        lobes[BSDF_CONDUCTOR] = (wo_mir, w_mir, zero, yes, ones)

    # smooth dielectric: reflect / refract by Fresnel
    if BSDF_DIELECTRIC in kinds:
        Fd, cos_t = fresnel_dielectric(ci, eta)
        choose_refl = u0 < Fd
        rel_eta = torch.where(ci > 0.0, eta, 1.0 / eta)
        scale = -1.0 / rel_eta
        wo_refr = torch.stack([scale * wi[..., 0], scale * wi[..., 1],
                               cos_t], dim=-1)
        # radiance transport picks up 1/eta_rel^2 on refraction
        refr = 1.0 / (rel_eta * rel_eta) if transport == "radiance" \
            else ones
        wo_diel = torch.where(choose_refl[..., None], wo_mir, wo_refr)
        w_diel = torch.where(choose_refl[..., None], torch.ones_like(albedo),
                             refr[..., None] * torch.ones_like(albedo)) \
            * albedo
        lobes[BSDF_DIELECTRIC] = (wo_diel, w_diel, zero, yes,
                                  torch.where(choose_refl, 1.0, rel_eta))

    # rough conductor
    if BSDF_ROUGH_CONDUCTOR in kinds:
        m, pdf_m = _sample_beckmann(u2, alpha)
        m = torch.stack([m[..., 0], m[..., 1], m[..., 2] * torch.sign(ci)],
                        dim=-1)
        wi_dot_m = _dot(wi, m)
        wo_rc = 2.0 * wi_dot_m[..., None] * m - wi
        pdf_rc = pdf_m / torch.clamp(4.0 * torch.abs(wi_dot_m), min=1e-9)
        D = _beckmann_d(m * torch.sign(m[..., 2])[..., None], alpha)
        G = _smith_g1(wi, m, alpha) * _smith_g1(wo_rc, m, alpha)
        F = fresnel_conductor(torch.abs(wi_dot_m), eta3, spec)
        f_rc = albedo * F * (D * G / torch.clamp(
            4.0 * torch.abs(ci * wo_rc[..., 2]), min=1e-9))[..., None]
        w_rc = f_rc * torch.abs(wo_rc[..., 2])[..., None] / torch.clamp(
            pdf_rc, min=1e-12)[..., None]
        w_rc = torch.where(((wo_rc[..., 2] * ci) > 0.0)[..., None], w_rc,
                           0.0)
        lobes[BSDF_ROUGH_CONDUCTOR] = (wo_rc, w_rc, pdf_rc, no, ones)

    # phong: the cos^n lobe around the mirror direction, or diffuse
    if BSDF_PHONG in kinds:
        lum_d = albedo.mean(-1)
        lum_s = spec.mean(-1)
        w_spec_p = lum_s / torch.clamp(lum_d + lum_s, min=1e-9)
        pick_spec = u0 < w_spec_p
        n_exp = alpha
        cos_a = torch.pow(torch.clamp(u2[..., 0], min=1e-12),
                          1.0 / (n_exp + 1.0))
        sin_a = safe_sqrt(1.0 - cos_a * cos_a)
        phi = 2.0 * math.pi * u2[..., 1]
        lobe = torch.stack([sin_a * torch.cos(phi), sin_a * torch.sin(phi),
                            cos_a], dim=-1)
        s_ax, t_ax = coordinate_system(wo_mir)
        wo_ps = to_world(wo_mir, s_ax, t_ax, lobe)
        wo_ph = torch.where(pick_spec[..., None], wo_ps, wo_diff)
        f_ph, pdf_ph = _phong_eval_pdf(albedo, spec, n_exp, w_spec_p, wi,
                                       wo_ph)
        w_ph = f_ph * torch.abs(wo_ph[..., 2])[..., None] / torch.clamp(
            pdf_ph, min=1e-12)[..., None]
        w_ph = torch.where(((wo_ph[..., 2] * ci) > 0.0)[..., None], w_ph,
                           0.0)
        lobes[BSDF_PHONG] = (wo_ph, w_ph, pdf_ph, no, ones)

    # plastic: specular delta with probability F, diffuse else
    if BSDF_PLASTIC in kinds:
        Fp, _ = fresnel_dielectric(torch.abs(ci), eta)
        pick_s = u0 < Fp
        wo_pl = torch.where(pick_s[..., None], wo_mir, wo_diff)
        w_pl = torch.where(pick_s[..., None], torch.ones_like(albedo),
                           albedo * (1.0 - Fp)[..., None])
        pdf_pl = torch.where(pick_s, 0.0, (1.0 - Fp) * pdf_diff)
        lobes[BSDF_PLASTIC] = (wo_pl, w_pl, pdf_pl, pick_s, ones)

    # rough dielectric (Walter microfacet transmission)
    if BSDF_ROUGH_DIELECTRIC in kinds:
        wo_rd, w_rd, pdf_rd, eta_rd, _ = _rough_dielectric_sample(
            albedo, alpha, eta, wi, u0, u2, transport)
        lobes[BSDF_ROUGH_DIELECTRIC] = (wo_rd, w_rd, pdf_rd, no, eta_rd)

    # null: pass straight through
    if BSDF_NULL in kinds:
        lobes[BSDF_NULL] = (-wi, torch.ones_like(albedo), zero, yes, ones)

    wo, wgt, pdf, is_delta, eta_out = wo_diff, w_diff, pdf_diff, no, ones
    for t, (woi, wgi, pdi, deli, etai) in lobes.items():
        mask = btype == t
        wo = torch.where(mask[..., None], woi, wo)
        wgt = torch.where(mask[..., None], wgi, wgt)
        pdf = torch.where(mask, pdi, pdf)
        is_delta = torch.where(mask, deli, is_delta)
        eta_out = torch.where(mask, etai, eta_out)
    return BSDFSample(wo=_flip_z(wo, flip), weight=wgt, pdf=pdf,
                      is_delta=is_delta, eta=eta_out,
                      valid=wgt.amax(-1) > 0.0)


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
    Fi = fresnel_dielectric(torch.abs(ci), eta1)[0]
    Fo = fresnel_dielectric(torch.abs(co), eta1)[0]
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


def eval_bsdf(scene: Scene, bi, wi, wo, transport="radiance"):
    """f(wi, wo) without cosine and the pdf of sampling wo given wi ->
    (f [N,3], pdf [N]). Delta lobes give 0 (measure mismatch). The
    reflective lobes are those of the gathers (eval_bsdf_pdf_params),
    fed the scene's table rows; the rough dielectric depends on the
    transport."""
    btype = scene.bsdf_type[bi]
    flip = _twosided_flip(btype, wi)
    wi = _flip_z(wi, flip)
    wo = _flip_z(wo, flip)
    albedo = scene.bsdf_albedo[bi]
    params = dict(btype=btype, alb=albedo.unbind(-1),
                  spec=scene.bsdf_k[bi].unbind(-1),
                  eta3=scene.bsdf_eta3[bi].unbind(-1),
                  alpha=scene.bsdf_alpha[bi], eta1=scene.bsdf_eta[bi])
    fr, fg, fb, pdf = eval_bsdf_pdf_params(params, wi.unbind(-1),
                                           wo.unbind(-1))
    f = torch.stack([fr, fg, fb], dim=-1)
    if BSDF_ROUGH_DIELECTRIC not in scene.bsdf_kinds:
        return f, pdf
    is_rd = btype == BSDF_ROUGH_DIELECTRIC
    f_rd, pdf_rd = _rough_dielectric_eval(albedo, params["alpha"],
                                          params["eta1"], wi, wo, transport)
    return (torch.where(is_rd[..., None], f_rd, f),
            torch.where(is_rd, pdf_rd, pdf))


def pdf_bsdf(scene: Scene, bi, wi, wo, transport="radiance"):
    return eval_bsdf(scene, bi, wi, wo, transport)[1]
