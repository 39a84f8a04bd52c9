"""Planar (structure-of-planes) per-pair math of the photon gathers
(mirrors the helpers of gvpm_tpu/integrators/planar.py that the fused
gather's eval bodies call).

Vectors and spectra are tuples of same-shape tensors ("planes"): one
entry per (query, photon) pair. This is the plain-PyTorch side of the
kernel math; csrc/gather_eval.cuh holds the same formulas per pair. The
BSDF lobe formulas live with the materials
(render.bsdf.eval_bsdf_pdf_params).
"""

from __future__ import annotations

import math

import torch

from ..render.bsdf import eval_bsdf_pdf_params
from ..scene.types import PHASE_HG, PHASE_RAYLEIGH

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
