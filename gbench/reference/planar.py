"""Per-pair math of the gradient estimators on planes (tuples of
same-shape tensors, one entry per pair), in plain PyTorch: the ball and
plane tests, the base kernel terms, the diffuse-reconnection and
plane-rotation shifts, and pairwise MIS of shift_volume_photon.cpp:489-655
and shift_medium.h:39 of the GVPM code release.

A frozen copy of the formulas the program's gathers compute (the same
formula order, so that float32 results agree to rounding), kept here so
that a change to the program cannot move its own yardstick. Every
function follows the dtype of its inputs: fed bfloat16 planes it computes
in bfloat16, which is the control of the comparison.
"""

from __future__ import annotations

import math

import torch

INV_PI = 1.0 / math.pi
INV_FOURPI = 1.0 / (4.0 * math.pi)

# material and phase ids of the scene description (scene/types.py)
BSDF_DIFFUSE, BSDF_ROUGH_CONDUCTOR, BSDF_PHONG, BSDF_PLASTIC = 0, 3, 6, 7
PHASE_HG, PHASE_RAYLEIGH = 1, 2
# vertex types of the light pass's records
VERT_EMITTER, VERT_SURFACE, VERT_MEDIUM = 0, 1, 2


def dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def sub3(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def scale3(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def neg3(a):
    return (-a[0], -a[1], -a[2])


def madd3(o, d, t):
    return tuple(o[c] + d[c] * t for c in range(3))


def cross3(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def to_local(n, s, t, w):
    """World planes -> local coords in the frame (s, t, n)."""
    return dot3(s, w), dot3(t, w), dot3(n, w)


def frame(n):
    """Duff et al.'s branchless orthonormal basis around n."""
    nx, ny, nz = n
    sign = torch.where(nz >= 0.0, 1.0, -1.0).to(nz.dtype)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    s = (1.0 + sign * nx * nx * a, sign * b, -sign * nx)
    t = (b, sign + ny * ny * a, -ny)
    return s, t


def rdiv(c, x):
    """c / x as a true division."""
    return x.new_full((), c) / x


def phase(cos_theta, g, ptype):
    """Phase function value from the propagation cosine: isotropic,
    Henyey-Greenstein or Rayleigh."""
    denom = 1.0 + g * g - 2.0 * g * cos_theta
    hg = INV_FOURPI * (1.0 - g * g) / torch.clamp(
        denom * torch.sqrt(torch.clamp(denom, min=1e-12)), min=1e-12)
    ray = 3.0 / (16.0 * math.pi) * (1.0 + cos_theta * cos_theta)
    return torch.where(ptype == PHASE_HG, hg,
                       torch.where(ptype == PHASE_RAYLEIGH, ray,
                                   INV_FOURPI).to(hg.dtype))


def _fresnel_dielectric(cos_i, eta):
    rel_eta = torch.where(cos_i > 0.0, eta, 1.0 / eta)
    abs_ci = torch.abs(cos_i)
    sin2_t = (1.0 - abs_ci * abs_ci) / (rel_eta * rel_eta)
    abs_ct = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    r_s = (abs_ci - rel_eta * abs_ct) / torch.clamp(
        abs_ci + rel_eta * abs_ct, min=1e-12)
    r_p = (rel_eta * abs_ci - abs_ct) / torch.clamp(
        rel_eta * abs_ci + abs_ct, min=1e-12)
    return torch.where(sin2_t >= 1.0, 1.0,
                       0.5 * (r_s * r_s + r_p * r_p)).to(cos_i.dtype)


def _smith_g1(cv, v_dot_m, alpha):
    back = (v_dot_m * cv) <= 0.0
    tan_t = torch.sqrt(torch.clamp(1.0 - cv * cv, min=0.0)) \
        / torch.clamp(torch.abs(cv), min=1e-9)
    a = 1.0 / torch.clamp(alpha * tan_t, min=1e-9)
    rational = (3.535 * a + 2.181 * a * a) \
        / (1.0 + 2.276 * a + 2.577 * a * a)
    g = torch.where(a < 1.6, rational, 1.0).to(cv.dtype)
    return torch.where(back, 0.0, g).to(cv.dtype)


def bsdf(params, wi, wo):
    """(f r, f g, f b, pdf) of the reconnectable reflective lobes
    (diffuse, Beckmann rough conductor, Phong, plastic) from parameter
    planes btype, alb, spec, eta3 (three each), alpha, eta1; delta lobes
    give 0."""
    btype, alb, spec = params["btype"], params["alb"], params["spec"]
    alpha, eta1 = params["alpha"], params["eta1"]
    ci, co = wi[2], wo[2]
    upper = (ci > 0.0) & (co > 0.0)
    zero = torch.zeros_like(ci)
    pdf_diff = torch.where((ci * co) > 0.0, torch.abs(co) * INV_PI, zero)

    hx, hy, hz = wi[0] + wo[0], wi[1] + wo[1], ci + co
    hl = torch.sqrt(torch.clamp(hx * hx + hy * hy + hz * hz, min=1e-18))
    sgn = torch.sign(hz / hl)
    sgn = torch.where(sgn == 0.0, 1.0, sgn).to(ci.dtype)
    mx, my, mz = sgn * hx / hl, sgn * hy / hl, sgn * hz / hl
    c2 = torch.clamp(mz * mz, 1e-9, 1.0)
    t2 = (1.0 - c2) / c2
    a2 = alpha * alpha
    D = torch.exp(-t2 / a2) / (math.pi * a2 * c2 * c2)
    wi_m = wi[0] * mx + wi[1] * my + ci * mz
    wo_m = wo[0] * mx + wo[1] * my + co * mz
    G = _smith_g1(ci, wi_m, alpha) * _smith_g1(co, wo_m, alpha)
    f_rc = D * G / (4.0 * torch.clamp(torch.abs(ci) * torch.abs(co),
                                      min=1e-9))
    pdf_rc = D * torch.abs(mz) / torch.clamp(4.0 * torch.abs(wi_m), min=1e-9)

    def fres_c(ch):
        eta, k = params["eta3"][ch], spec[ch]
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

    cos_r = torch.clamp(-wi[0] * wo[0] - wi[1] * wo[1] + ci * co, 0.0, 1.0)
    ph_spec = (alpha + 2.0) * (0.5 * INV_PI) * torch.pow(cos_r, alpha)
    lum_d = (alb[0] + alb[1] + alb[2]) / 3.0
    lum_s = (spec[0] + spec[1] + spec[2]) / 3.0
    w_spec = lum_s / torch.clamp(lum_d + lum_s, min=1e-9)
    pdf_ph = ((1.0 - w_spec) * pdf_diff + w_spec * (alpha + 1.0)
              * (0.5 * INV_PI) * torch.pow(cos_r, alpha))
    Fi = _fresnel_dielectric(torch.abs(ci), eta1)
    Fo = _fresnel_dielectric(torch.abs(co), eta1)
    f_pl = (1.0 - Fi) * (1.0 - Fo) * INV_PI
    pdf_pl = (1.0 - Fi) * pdf_diff

    is_d, is_rc = btype == BSDF_DIFFUSE, btype == BSDF_ROUGH_CONDUCTOR
    is_ph, is_pl = btype == BSDF_PHONG, btype == BSDF_PLASTIC

    def chan(ch):
        f = torch.where(is_d, alb[ch] * INV_PI, zero)
        f = torch.where(is_rc, alb[ch] * f_rc * fres_c(ch), f)
        f = torch.where(is_ph, alb[ch] * INV_PI + spec[ch] * ph_spec, f)
        f = torch.where(is_pl, alb[ch] * f_pl, f)
        return torch.where(upper, f, zero)

    pdf = torch.where(is_d, pdf_diff, zero)
    pdf = torch.where(is_rc, pdf_rc, pdf)
    pdf = torch.where(is_ph, pdf_ph, pdf)
    pdf = torch.where(is_pl, pdf_pl, pdf)
    return chan(0), chan(1), chan(2), torch.where(upper, pdf, zero)


def parent_scatter(ptype, pwi, pns, bparams, mparams, w_new):
    """Scatter value and direction pdf at a photon's parent vertex toward
    w_new -> (sr, sg, sb, pdf, ok)."""
    cos_e = dot3(pns, w_new)
    sc_em = torch.clamp(cos_e, min=0.0)
    pdf_em = sc_em * INV_PI
    nwi = neg3(pwi)
    flip = torch.sign(dot3(pns, nwi))
    flip = torch.where(flip == 0.0, 1.0, flip).to(cos_e.dtype)
    nsf = scale3(pns, flip)
    s_ax, t_ax = frame(nsf)
    fr, fg, fb, pdf_b = bsdf(bparams, to_local(nsf, s_ax, t_ax, nwi),
                             wo_l := to_local(nsf, s_ax, t_ax, w_new))
    acos = torch.abs(wo_l[2])
    pv = phase(-dot3(nwi, w_new), mparams["g"], mparams["ptype"])
    sig = mparams["sigs"]
    is_em, is_md = ptype == VERT_EMITTER, ptype == VERT_MEDIUM

    def pick(em, md, sf):
        return torch.where(is_em, em, torch.where(is_md, md, sf))

    return (pick(sc_em, sig[0] * pv, fr * acos),
            pick(sc_em, sig[1] * pv, fg * acos),
            pick(sc_em, sig[2] * pv, fb * acos),
            pick(pdf_em, pv, pdf_b), (~is_em) | (cos_e > 1e-6))
