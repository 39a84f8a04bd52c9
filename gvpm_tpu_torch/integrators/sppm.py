"""Photon shooting and the APA radius schedule
(mirrors gvpm_tpu/integrators/sppm.py:38-75)."""

from __future__ import annotations

import torch

from ..core.config import PhotonConfig
from ..render.bsdf import require_ported
from ..render.medium import require_homogeneous
from ..scene.types import Scene
from . import ptracer

# kernel dimension per estimator -> APA radius exponent 1/dim
# (reference: volume_utils.h:23-53 kernel-dimension helpers)
KERNEL_DIM = {"distance": 3, "bre": 2, "beam1d": 1, "beam3d": 3,
              "plane0d": 0}


def radius_ratio(it, alpha):
    """APA per-pass radius ratio after pass `it` (0-based):
    (k+alpha)/(k+1) with k = it+1 (gvpm.cpp:181-215)."""
    k = it + 1
    return (k + alpha) / (k + 1.0)


def base_volume_radius(scene: Scene, cfg: PhotonConfig):
    ext = scene.medium_hi - scene.medium_lo
    diag = float(torch.sqrt((ext * ext).sum()))
    return 0.02 * diag * cfg.initial_scale_volume


def shoot_photons(scene: Scene, cfg: PhotonConfig, n_photons, key):
    """Light pass -> photon dict, flattened [S*P]."""
    require_ported(scene)
    require_homogeneous(scene)
    lv = ptracer.shoot(scene, cfg, n_photons, key)
    pv, _ = ptracer.flatten_vertices(lv)
    return pv.asdict()
