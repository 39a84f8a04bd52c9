"""End-to-end gate of the port's SPPM primal pass: sppm:distance on
box-medium at the goldens/ci config (tools/goldens.py::_check_kw(32):
2^15 light paths, max_depth 12, hash 2^15; 32^2, 12 passes, seed 5, as
tests/test_goldens.py runs it for the JAX package) must meet the bar
recorded in goldens/ci/meta.json."""

import json
import os

import numpy as np

from gvpm_tpu_torch import scenes
from gvpm_tpu_torch.core.config import PhotonConfig
from gvpm_tpu_torch.integrators import sppm
from gvpm_tpu_torch.utils import image as imglib
from tests.test_torch_common import torch_threads  # noqa: F401

GOLD_CI = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "goldens", "ci")


def test_box_medium_sppm_distance_meets_ci_golden_bar():
    with open(os.path.join(GOLD_CI, "meta.json")) as f:
        meta = json.load(f)
    size = meta["size"]
    bar = meta["scenes"]["box-medium"]["thresholds"]["sppm:distance"]
    ref = imglib.read_pfm(os.path.join(GOLD_CI, "box-medium_ref.pfm"))
    cfg = PhotonConfig(surface_photons=1 << 15, volume_photons=1 << 15,
                       max_depth=12, grid_hash_size=1 << 15)
    out = sppm.render(scenes.box_medium(size, size, device="cpu"), cfg,
                      volume="distance", seed=5, passes=12)
    img, n_bad = imglib.nan_scrub(out["image"].numpy())
    assert n_bad == 0
    r = imglib.relmse(img, ref)
    print(f"sppm:distance 32^2 relMSE {r:.5f} (bar {bar})")
    assert np.isfinite(r) and r <= bar, (r, bar)
