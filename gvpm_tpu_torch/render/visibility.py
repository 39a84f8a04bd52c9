"""Media-aware visibility: medium transitions across null boundaries and
transmittance along segments through them (mirrors
gvpm_tpu/render/visibility.py; reference: Scene::evalTransmittance
walking through null BSDFs + attached media, src/librender/scene.cpp).
"""

from __future__ import annotations

import torch

from ..core.math import dot
from ..scene.intersect import intersect
from ..scene.types import BSDF_NULL, Scene
from . import medium as med

MAX_NULL_CROSSINGS = 4
SEG_EPS = 1e-3


def medium_transition(scene: Scene, prim, ng, d):
    """Medium index after crossing `prim` along direction d."""
    entering = dot(d, ng) < 0.0
    return torch.where(entering, scene.prim_med_in(prim),
                       scene.prim_med_out(prim))


def segment_transmittance(scene: Scene, a, b, med_start):
    """Transmittance of the open segment a->b given the medium at a.

    Returns [N,3]; zero where a non-null surface blocks the segment, and
    where it crosses more than MAX_NULL_CROSSINGS null boundaries
    (conservative)."""
    seg = b - a
    dist = torch.sqrt(torch.clamp((seg * seg).sum(-1), min=1e-20))
    d = seg / dist[:, None]
    n = a.shape[0]
    o, remaining = a, dist
    cur_med = med_start.expand(n)
    tr = torch.ones((n, 3), dtype=torch.float32, device=a.device)
    alive = torch.ones((n,), dtype=torch.bool, device=a.device)
    for _ in range(MAX_NULL_CROSSINGS):
        hit = intersect(scene, o + d * SEG_EPS, d,
                        t_max=remaining - 2.0 * SEG_EPS)
        seg_len = torch.where(hit.valid, hit.t + SEG_EPS, remaining)
        tr_new = tr * med.transmittance(scene, cur_med, seg_len,
                                        o=o + d * SEG_EPS, d=d)
        bi = torch.clamp(scene.prim_bsdf(hit.prim), 0,
                         scene.bsdf_type.shape[0] - 1)
        is_null = hit.valid & (scene.bsdf_type[bi] == BSDF_NULL)
        tr_new = torch.where((hit.valid & ~is_null)[:, None], 0.0, tr_new)
        cur_med = torch.where(is_null, medium_transition(
            scene, hit.prim, hit.ng, d), cur_med)
        rem_new = torch.where(hit.valid, remaining - seg_len, 0.0)
        alive_new = alive & is_null & (rem_new > SEG_EPS)
        tr = torch.where(alive[:, None], tr_new, tr)
        o = torch.where(alive[:, None], torch.where(
            hit.valid[:, None], hit.p, o), o)
        remaining = torch.where(alive, rem_new, remaining)
        alive = alive_new
    return torch.where(alive[:, None], 0.0, tr)
