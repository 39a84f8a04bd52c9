"""Shift operations on stored light paths (mirrors the slice of
gvpm_tpu/integrators/shift.py the manifold shifts call).

`parent_scatter` evaluates the scatter value and direction pdf at a
photon's parent vertex toward a new direction, for the three parent
kinds of diffuseReconnection (emitter, surface, medium). The fused
gather's eval bodies compute the same per pair from baked row slots
(planar.parent_scatter_params); here the material parameters come from
the scene tables. `reconnect_photon` and `mis_weight` of the JAX module
have their counterparts inside the gather eval bodies
(gradient_gather._reconnect_planar / _mis_planar).
"""

from __future__ import annotations

import torch

from ..scene.types import Scene
from . import planar as pl

VERT_EMITTER = pl.VERT_EMITTER   # parent_type of first-bounce photons
VERT_SURFACE = pl.VERT_SURFACE
VERT_MEDIUM = pl.VERT_MEDIUM


def parent_scatter(scene: Scene, ph_parent_type, ph_parent_wi,
                   ph_parent_ns, ph_parent_bsdf, ph_parent_med, new_dir):
    """Scatter value + direction pdf at the photon's parent toward
    `new_dir`. Returns (scatter [N,3], pdf_dir [N], ok [N]).
    scatter: emitter -> cos; surface -> f*|cos| (importance); medium ->
    sigma_s * p. Matches what ptracer caches in `scatter_base` for the
    base direction."""
    bi = torch.clamp(ph_parent_bsdf, 0, scene.bsdf_type.shape[0] - 1)
    mi = torch.clamp(ph_parent_med, 0, scene.med_sigma_s.shape[0] - 1)
    bparams = dict(btype=scene.bsdf_type[bi],
                   alb=scene.bsdf_albedo[bi].unbind(-1),
                   spec=scene.bsdf_k[bi].unbind(-1),
                   eta3=scene.bsdf_eta3[bi].unbind(-1),
                   alpha=scene.bsdf_alpha[bi], eta1=scene.bsdf_eta[bi])
    sigs = torch.where((ph_parent_med >= 0)[..., None],
                       scene.med_sigma_s[mi], 0.0)
    mparams = dict(sigs=sigs.unbind(-1), g=scene.med_g[mi],
                   ptype=scene.med_phase[mi])
    sr, sg, sb, pdf, ok = pl.parent_scatter_params(
        ph_parent_type, ph_parent_wi.unbind(-1), ph_parent_ns.unbind(-1),
        bparams, mparams, new_dir.unbind(-1))
    return torch.stack([sr, sg, sb], dim=-1), pdf, ok
