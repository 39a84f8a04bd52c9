"""Homogeneous participating media (mirrors gvpm_tpu/render/medium.py).

The reference's three distance-sampling strategies
(include/mitsuba/render/medium.h:104-148):

  * NORMAL        — free-flight sampling with probability
                    `sampling_weight` (green-channel pick, or a random
                    channel when `u_channel` is given).
  * LONG          — "long beam": march to t = -log(eps)/sigma_g, until
                    the transmittance is negligible.
  * ALWAYS_VALID  — forced interaction on [0, t_max): normalized
                    truncated exponential.

A medium index of -1 denotes vacuum. Heterogeneous (grid) media are not
ported yet: `require_homogeneous` rejects them.
"""

from __future__ import annotations

import dataclasses

import torch

from ..scene.types import NO_MEDIUM, Scene

EPSILON = 1e-4

NORMAL = 0
LONG = 1
ALWAYS_VALID = 2


@dataclasses.dataclass
class MediumSample:
    success: torch.Tensor        # [N] bool — medium interaction happened
    t: torch.Tensor              # [N] sampled distance (== t_max on failure)
    p: torch.Tensor              # [N,3] interaction point
    transmittance: torch.Tensor  # [N,3]
    pdf_success: torch.Tensor    # [N]
    pdf_failure: torch.Tensor    # [N]
    sigma_s: torch.Tensor        # [N,3]


def require_homogeneous(scene: Scene):
    if scene.het_medium >= 0:
        raise NotImplementedError(
            "heterogeneous media: ROADMAP queue 1 item 15")


def _tables(scene: Scene, mi):
    """Per-lane medium coefficients; vacuum (mi<0) becomes all-zero."""
    idx = torch.clamp(mi, 0, scene.med_sigma_a.shape[0] - 1)
    in_med = (mi != NO_MEDIUM)[..., None]
    sa = torch.where(in_med, scene.med_sigma_a[idx], 0.0)
    ss = torch.where(in_med, scene.med_sigma_s[idx], 0.0)
    return sa, ss, sa + ss


def _mean3(a):
    return (a[..., 0] + a[..., 1] + a[..., 2]) / 3.0


def sampling_weight(scene: Scene, mi):
    """max(albedo, 0.5) (Medium::configure); 0 for vacuum."""
    sa, ss, st = _tables(scene, mi)
    albedo = torch.where(st > 0, ss / torch.clamp(st, min=1e-20),
                         0.0).amax(-1)
    w = torch.clamp(albedo, min=0.5)
    return torch.where(mi != NO_MEDIUM, w, 0.0)


def transmittance(scene: Scene, mi, dist):
    """exp(-sigma_t * dist) per channel; 1 for vacuum."""
    _, _, st = _tables(scene, mi)
    tr = torch.exp(-st * torch.clamp(dist, min=0.0)[..., None])
    return torch.where(tr.amax(-1, keepdim=True) < 1e-20, 0.0, tr)


def sample_distance(scene: Scene, mi, o, d, t_max, u, strategy=NORMAL,
                    u_channel=None) -> MediumSample:
    """Sample a free-flight distance along (o, d) within [0, t_max).
    Vacuum lanes always fail with pdf_failure = 1, transmittance = 1."""
    sa, ss, st = _tables(scene, mi)
    if strategy == ALWAYS_VALID:
        u_channel = None
    if u_channel is None:
        sigma_g = st[..., 1]
    else:
        ch = torch.clamp((u_channel * 3.0).to(torch.int64), max=2)
        sigma_g = st.gather(-1, ch[..., None])[..., 0]
    sigma_g_safe = torch.clamp(sigma_g, min=1e-20)
    in_med = (mi != NO_MEDIUM) & (st.amax(-1) > 0.0)

    w = sampling_weight(scene, mi)
    if strategy == ALWAYS_VALID:
        w = torch.where(in_med, 1.0, w)

    take = u < w
    ur = torch.where(take, u / torch.clamp(w, min=1e-20), 0.0)

    if strategy == ALWAYS_VALID:
        max_dist = torch.clamp(t_max - EPSILON, min=0.0)
        norm_g = 1.0 - torch.exp(-sigma_g_safe * max_dist)
        t_sample = -torch.log1p(-ur * norm_g) / sigma_g_safe
    elif strategy == LONG:
        t_sample = -torch.log(torch.full_like(u, EPSILON)) / sigma_g_safe
    else:
        t_sample = -torch.log(torch.clamp(1.0 - ur, min=1e-20)) \
            / sigma_g_safe

    t_sample = torch.where(take & in_med, t_sample, torch.inf)
    success = t_sample < t_max
    t = torch.where(success, t_sample, t_max)

    tr_c = torch.exp(-st * t[..., None])
    if strategy == ALWAYS_VALID:
        norm_g = 1.0 - torch.exp(
            -sigma_g * torch.clamp(t_max - EPSILON, min=0.0))
        pdf_success = torch.where(
            norm_g > 1e-12,
            sigma_g / torch.clamp(norm_g, min=1e-12)
            * torch.exp(-sigma_g * t), 0.0)
        pdf_failure = torch.zeros_like(pdf_success)
    else:
        pdf_failure = _mean3(tr_c)
        pdf_success = _mean3(st * tr_c)

    pdf_success = pdf_success * w
    pdf_failure = w * pdf_failure + (1.0 - w)
    tr = torch.where(tr_c.amax(-1, keepdim=True) < 1e-20, 0.0, tr_c)
    pdf_failure = torch.where(in_med, pdf_failure, 1.0)
    pdf_success = torch.where(in_med, pdf_success, 0.0)
    return MediumSample(
        success=success & in_med, t=t, p=o + d * t[..., None],
        transmittance=torch.where(in_med[..., None], tr, 1.0),
        pdf_success=pdf_success, pdf_failure=pdf_failure, sigma_s=ss)


def pdf_distance_always_valid(scene: Scene, mi, t, t_max):
    """pdf_success(t) of an already-known distance under ALWAYS_VALID
    (Medium::eval analog; its pdf_failure is 0)."""
    _, _, st = _tables(scene, mi)
    in_med = (mi != NO_MEDIUM) & (st.amax(-1) > 0.0)
    sigma_g = st[..., 1]
    norm_g = 1.0 - torch.exp(-sigma_g * torch.clamp(t_max - EPSILON,
                                                    min=0.0))
    ps = torch.where(norm_g > 1e-12,
                     sigma_g / torch.clamp(norm_g, min=1e-12)
                     * torch.exp(-sigma_g * t), 0.0)
    w = torch.where(in_med, 1.0, sampling_weight(scene, mi))
    return torch.where(in_med, ps * w, 0.0)
