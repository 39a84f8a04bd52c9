"""Planar (structure-of-planes) per-pair math of the photon gathers
(mirrors gvpm_tpu/integrators/planar.py: the helpers the fused gather's
eval bodies call, and those of the SPPM estimators).

Vectors and spectra are tuples of same-shape tensors ("planes"): one
entry per (query, photon) pair. This is the plain-PyTorch side of the
kernel math; csrc/gather_eval.cuh holds the same formulas per pair. The
BSDF lobe formulas of the gradient shifts live with the materials
(render.bsdf.eval_bsdf_pdf_params); the SPPM surface estimate evaluates
its own approximation (eval_bsdf_gather), as the JAX package does.
"""

from __future__ import annotations

import math

import torch

from ..render.bsdf import eval_bsdf_pdf_params
from ..scene.types import (BSDF_DIFFUSE, BSDF_PHONG, BSDF_PLASTIC,
                           BSDF_ROUGH_CONDUCTOR, PHASE_HG, PHASE_RAYLEIGH,
                           Scene)

VERT_EMITTER = 0
VERT_SURFACE = 1
VERT_MEDIUM = 2

INV_PI = 1.0 / math.pi
INV_FOURPI = 1.0 / (4.0 * math.pi)


def gather3(arr, idx):
    """[P,3] photon field -> three planes shaped like idx."""
    g = arr[idx]
    return g[..., 0], g[..., 1], g[..., 2]


def expand(v):
    """Per-query vector [Q,3] -> planes broadcastable against [Q,M]."""
    return (v[:, 0:1], v[:, 1:2], v[:, 2:3])


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


def to_local_planar(frame_n, frame_s, frame_t, w):
    """World planes -> local coords; frame_*: per-query [Q,3]."""
    return to_local_planes(expand(frame_n), expand(frame_s),
                           expand(frame_t), w)


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


def eval_phase_planar(scene: Scene, mi, cos_theta):
    """Phase value from the propagation-cosine plane; mi: medium indices
    broadcastable against it."""
    idx = torch.clamp(mi, 0, scene.med_g.shape[0] - 1)
    return phase_params(cos_theta, scene.med_g[idx], scene.med_phase[idx])


def eval_bsdf_gather(scene: Scene, bi, wi_loc, wo_loc):
    """Gather-time BSDF value f(wi, wo) (no cosine) of the SPPM surface
    estimate, non-delta lobes only, as the JAX package approximates them
    (Beckmann conductor without the back-facing G term, plastic as a
    constant 0.81 Fresnel-attenuated diffuse): not the gradient shifts'
    eval_bsdf_pdf_params. bi: bsdf ids broadcastable against the planes;
    wi_loc / wo_loc: local-frame planes. Returns (fr, fg, fb)."""
    bic = torch.clamp(bi, 0, scene.bsdf_type.shape[0] - 1)
    btype = scene.bsdf_type[bic]
    alb = scene.bsdf_albedo[bic]
    spec = scene.bsdf_k[bic]
    eta3 = scene.bsdf_eta3[bic]
    alpha = scene.bsdf_alpha[bic]

    ci = wi_loc[2]
    co = wo_loc[2]
    upper = (ci > 0.0) & (co > 0.0)

    # rough conductor (Beckmann, per-channel conductor Fresnel)
    hx, hy, hz = wi_loc[0] + wo_loc[0], wi_loc[1] + wo_loc[1], ci + co
    hl = torch.sqrt(torch.clamp(hx * hx + hy * hy + hz * hz, min=1e-18))
    mz = torch.abs(hz / hl)
    c2 = torch.clamp(mz * mz, 1e-9, 1.0)
    t2 = (1.0 - c2) / c2
    a2 = alpha * alpha
    D = torch.exp(-t2 / torch.clamp(a2, min=1e-9)) \
        / torch.clamp(math.pi * a2 * c2 * c2, min=1e-12)

    def g1(cv):
        tan_t = torch.sqrt(torch.clamp(1.0 - cv * cv, min=0.0)) \
            / torch.clamp(torch.abs(cv), min=1e-9)
        a = rdiv(1.0, torch.clamp(alpha * tan_t, min=1e-9))
        rat = (3.535 * a + 2.181 * a * a) \
            / (1.0 + 2.276 * a + 2.577 * a * a)
        return torch.where(a < 1.6, rat, 1.0)

    f_rc = D * (g1(ci) * g1(co)) / torch.clamp(
        4.0 * torch.abs(ci) * torch.abs(co), min=1e-9)
    cos_im = torch.abs((wi_loc[0] * hx + wi_loc[1] * hy + ci * hz) / hl)

    def fres_c(ch):
        eta = eta3[..., ch]
        k = spec[..., ch]
        ci2 = torch.clamp(cos_im * cos_im, 0.0, 1.0)
        e2k2 = eta * eta + k * k
        t0 = e2k2 * ci2
        two = 2.0 * eta * cos_im
        r_par2 = (t0 - two + 1.0 - ci2 + ci2 * ci2) / torch.clamp(
            t0 + two + 1.0 - ci2 + ci2 * ci2, min=1e-12)
        r_perp2 = (e2k2 - two + ci2) / torch.clamp(e2k2 + two + ci2,
                                                   min=1e-12)
        return torch.clamp(0.5 * (r_par2 + r_perp2), 0.0, 1.0)

    # phong
    cos_r = torch.clamp(dot3((-wi_loc[0], -wi_loc[1], ci), wo_loc),
                        0.0, 1.0)
    ph_spec = (alpha + 2.0) * (0.5 * INV_PI) * torch.pow(cos_r, alpha)

    is_d = btype == BSDF_DIFFUSE
    is_rc = btype == BSDF_ROUGH_CONDUCTOR
    is_ph = btype == BSDF_PHONG
    is_pl = btype == BSDF_PLASTIC

    def chan(ch):
        a = alb[..., ch]
        f = torch.where(is_d, a * INV_PI, 0.0)
        f = torch.where(is_rc, a * f_rc * fres_c(ch), f)
        f = torch.where(is_ph, a * INV_PI + spec[..., ch] * ph_spec, f)
        f = torch.where(is_pl, a * (0.81 * INV_PI), f)
        return torch.where(upper, f, 0.0)

    return chan(0), chan(1), chan(2)


def rdiv(c, x):
    """c / x as a true division (torch's scalar / tensor multiplies by
    the reciprocal, XLA divides)."""
    return x.new_full((), c) / x


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
