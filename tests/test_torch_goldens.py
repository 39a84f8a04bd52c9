"""End-to-end gate of the port: gvpm:distance on box-medium at the
goldens/ci config (tools/goldens.py:181-182 with use_manifold=False and
without the hash-grid size the port has no use for;
32^2, 12 passes, seed 5) must meet the bar recorded for the JAX package
in goldens/ci/meta.json."""

import json
import os

import numpy as np

from gvpm_tpu.utils import image as imglib
from gvpm_tpu_torch import scenes
from gvpm_tpu_torch.core.config import GradientConfig
from gvpm_tpu_torch.integrators import gvpm

GOLD_CI = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "goldens", "ci")


def test_box_medium_gvpm_distance_meets_ci_golden_bar():
    with open(os.path.join(GOLD_CI, "meta.json")) as f:
        meta = json.load(f)
    size = meta["size"]
    bar = meta["scenes"]["box-medium"]["thresholds"]["gvpm:distance"]
    ref = imglib.read_pfm(os.path.join(GOLD_CI, "box-medium_ref.pfm"))
    cfg = GradientConfig(surface_photons=1 << 15, volume_photons=1 << 15,
                         max_depth=12, use_manifold=False)
    out = gvpm.render(scenes.box_medium(size, size), cfg,
                      volume="distance", seed=5, passes=12)
    img, n_bad = imglib.nan_scrub(out["image"].numpy())
    assert n_bad == 0
    r = imglib.relmse(img, ref)
    assert np.isfinite(r) and r <= bar, (r, bar)
