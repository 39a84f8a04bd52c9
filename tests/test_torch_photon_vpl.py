"""The port's photon mapper / PPM (gvpm_tpu_torch/integrators/
photonmapper.py) and VPL (vpl.py) against gvpm_tpu's on 12x12 boxes:
PPM on the surface-only cornell box of tests/test_more_integrators.py,
VPL on the fog box of tests/test_sppm.py, whose light paths store medium
vertices (VPLs in the fog). Bar: rtol 1e-4 / atol 1e-5. The photon
mapper's grid budget is one no stencil exceeds, as
tests/test_torch_sppm.py holds SPPM (its overflow subsample would make
the pass chaotic in the last bit of the radii): 1024 a cell, 2048
candidates a query, where the largest 8-cell stencil of the PPM passes
holds 1388 photons (at 512 a cell pass 0 overflows and 39 of its 432
values differ)."""

import pytest

from gvpm_tpu.core.config import PhotonConfig as JaxPhotonConfig
from gvpm_tpu.integrators import photonmapper as jphotonmapper
from gvpm_tpu.integrators import vpl as jvpl
from gvpm_tpu_torch.core.config import PhotonConfig
from gvpm_tpu_torch.integrators import photonmapper, vpl
from tests.test_more_integrators import _box
from tests.test_sppm import make_box_scene
from tests.test_torch_common import (port_scene_from_jax,  # noqa: F401
                                     torch_threads)
from tests.test_torch_primal_paths import _hold

PHOTON_KW = dict(max_depth=5, null_bounces=3, max_cam_depth=5,
                 surface_photons=1 << 12, volume_photons=1 << 12,
                 grid_hash_size=1 << 13, grid_max_photons_per_cell=1024)
VPL_KW = dict(max_depth=4, null_bounces=2, max_cam_depth=4)


@pytest.fixture(scope="module")
def scenes():
    """(JAX, port) of the surface box and of the fog box."""
    jb = _box()
    jm = make_box_scene(with_medium=True, w=12, h=12)
    return dict(box=(jb, port_scene_from_jax(jb)),
                fog=(jm, port_scene_from_jax(jm)))


def test_photonmapper_and_ppm_match_jax(scenes):
    """A 2-pass PPM render: the classic pass at radius scale 1, then
    one at the APA schedule's smaller radius."""
    js, ts = scenes["box"]
    got = photonmapper.render_ppm(ts, PhotonConfig(**PHOTON_KW), seed=2,
                                  passes=2)
    want = jphotonmapper.render_ppm(js, JaxPhotonConfig(**PHOTON_KW),
                                    seed=2, passes=2)
    assert got["passes"] == want["passes"] == 2
    _hold(got["image"], want["image"])


def test_vpl_pass_matches_jax(scenes):
    """48 light paths a pass: VPL tiles of 128 over the 48 x 6 stored
    vertex slots (max_depth + null_bounces steps), the last tile
    ragged."""
    js, ts = scenes["fog"]
    _hold(vpl.render_pass(ts, PhotonConfig(**VPL_KW), 48, 0, 0,
                          clamp_dist=0.05),
          jvpl.render_pass(js, JaxPhotonConfig(**VPL_KW), 48, 0, 0,
                           clamp_dist=0.05))
