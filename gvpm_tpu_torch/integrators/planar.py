"""Planar (structure-of-planes) per-pair math of the photon gathers
(mirrors the helpers of gvpm_tpu/integrators/planar.py that the fused
gather's eval bodies call).

Vectors and spectra are tuples of same-shape tensors ("planes"): one
entry per (query, photon) pair. This is the plain-PyTorch side of the
kernel math; csrc/gather_eval.cuh holds the same formulas per pair.
"""

from __future__ import annotations

import math

import torch

from ..scene.types import (BSDF_DIFFUSE, BSDF_PHONG, BSDF_PLASTIC,
                           BSDF_ROUGH_CONDUCTOR, PHASE_HG, PHASE_RAYLEIGH)

VERT_EMITTER = 0
VERT_SURFACE = 1
VERT_MEDIUM = 2

INV_PI = 1.0 / math.pi
INV_FOURPI = 1.0 / (4.0 * math.pi)


def dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def sub3(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def scale3(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def neg3(a):
    return (-a[0], -a[1], -a[2])


def to_local_planes(n, s, t, w):
    """World planes -> local coords in the frame (s, t, n)."""
    return dot3(s, w), dot3(t, w), dot3(n, w)


def frame_planar(n):
    """Duff et al. branchless ONB on planes (same formulas as
    core.math.coordinate_system)."""
    nx, ny, nz = n
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    s = (1.0 + sign * nx * nx * a, sign * b, -sign * nx)
    t = (b, sign + ny * ny * a, -ny)
    return s, t


def hg_phase(cos_theta, g):
    denom = 1.0 + g * g - 2.0 * g * cos_theta
    return INV_FOURPI * (1.0 - g * g) / torch.clamp(
        denom * torch.sqrt(torch.clamp(denom, min=1e-12)), min=1e-12)


def phase_params(cos_theta, g, ptype):
    """Phase value from the propagation cosine (iso / HG / Rayleigh)."""
    hg = hg_phase(cos_theta, g)
    ray = 3.0 / (16.0 * math.pi) * (1.0 + cos_theta * cos_theta)
    return torch.where(ptype == PHASE_HG, hg,
                       torch.where(ptype == PHASE_RAYLEIGH, ray, INV_FOURPI))


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


def parent_scatter_params(ptype, pwi, pns, bparams, mparams, w_new):
    """Scatter value + direction pdf at a photon's parent toward w_new,
    material parameters supplied as planes -> (sr, sg, sb, pdf, ok)."""
    cos_e = dot3(pns, w_new)
    sc_em = torch.clamp(cos_e, min=0.0)
    pdf_em = sc_em * INV_PI

    nwi = neg3(pwi)
    flip = torch.sign(dot3(pns, nwi))
    flip = torch.where(flip == 0.0, 1.0, flip)
    nsf = scale3(pns, flip)
    s_ax, t_ax = frame_planar(nsf)
    wi_l = to_local_planes(nsf, s_ax, t_ax, nwi)
    wo_l = to_local_planes(nsf, s_ax, t_ax, w_new)
    fr, fg, fb, pdf_b = eval_bsdf_pdf_params(bparams, wi_l, wo_l)
    acos = torch.abs(wo_l[2])

    cos_ph = dot3(nwi, w_new)
    pv = phase_params(-cos_ph, mparams["g"], mparams["ptype"])
    sig = mparams["sigs"]

    is_em = ptype == VERT_EMITTER
    is_md = ptype == VERT_MEDIUM

    def pick(em, md, sf):
        return torch.where(is_em, em, torch.where(is_md, md, sf))

    sr = pick(sc_em, sig[0] * pv, fr * acos)
    sg = pick(sc_em, sig[1] * pv, fg * acos)
    sb = pick(sc_em, sig[2] * pv, fb * acos)
    pdf = pick(pdf_em, pv, pdf_b)
    ok = (~is_em) | (cos_e > 1e-6)
    return sr, sg, sb, pdf, ok
