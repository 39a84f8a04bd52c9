"""The port's primal path-space integrators against gvpm_tpu's, one pass
each on a 12x12 box: direct, ao and path (simple.py) on the
surface-only cornell box of tests/test_more_integrators.py, the light
tracer (lighttrace.py) on the fog box of tests/test_sppm.py, whose light
paths store medium vertices; and the camera's project /
importance_weight. Bar: rtol 1e-4 / atol 1e-5 (the splats add in
scatter order). tests/test_torch_photon_vpl.py holds the photon mapper,
PPM and VPL."""

import numpy as np
import pytest
import torch

from gvpm_tpu.core.config import PhotonConfig as JaxPhotonConfig
from gvpm_tpu.integrators import lighttrace as jlighttrace
from gvpm_tpu.integrators import simple as jsimple
from gvpm_tpu_torch.core.config import PhotonConfig, VolPathConfig
from gvpm_tpu_torch.integrators import lighttrace, simple, volpath
from gvpm_tpu_torch.scene import camera
from tests.test_more_integrators import _box
from tests.test_sppm import make_box_scene
from tests.test_torch_common import (port_scene_from_jax,  # noqa: F401
                                     torch_threads)

# tests/test_lighttrace.py's config: the JAX side's compiled pass is
# shared with that test through the persistent compilation cache
# (tests/test_torch_common.py)
LT_KW = dict(max_depth=5, null_bounces=3, surface_photons=1 << 14,
             volume_photons=1 << 14)


@pytest.fixture(scope="module")
def scenes():
    """(JAX, port) of the surface box and of the fog box."""
    jb = _box()
    jm = make_box_scene(with_medium=True, w=12, h=12)
    return dict(box=(jb, port_scene_from_jax(jb)),
                fog=(jm, port_scene_from_jax(jm)))


def _hold(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert got.mean() > 0
    return got


@pytest.mark.parametrize("it", (0, 1))
def test_direct_pass_matches_jax(scenes, it):
    js, ts = scenes["box"]
    _hold(simple._direct_pass(ts, 3, it), jsimple._direct_pass(js, 3, it, 2))


def test_ao_and_direct_renders_match_jax(scenes):
    js, ts = scenes["box"]
    got = _hold(simple.render_ao(ts, spp=2, seed=3),
                jsimple.render_ao(js, spp=2, seed=3))
    assert got.max() <= 1.0
    _hold(simple.render_direct(ts, spp=2, seed=3),
          jsimple.render_direct(js, spp=2, seed=3))


def test_path_is_volpath(scenes):
    """simple.render_path only calls volpath.render, as the JAX package's
    does (tests/test_torch_volpath.py holds volpath against it)."""
    _, ts = scenes["box"]
    kw = dict(spp=2, max_depth=5, null_bounces=2)
    got = simple.render_path(ts, VolPathConfig(**kw), seed=4)
    torch.testing.assert_close(
        got, volpath.render(ts, VolPathConfig(**kw), seed=4), rtol=0,
        atol=0)
    assert bool(torch.isfinite(got).all()) and float(got.mean()) > 0


def test_camera_project_inverts_generate_rays(scenes):
    """project maps a point on each primary ray back to its film
    position; importance_weight is W*H / (film area * cos^3)."""
    _, ts = scenes["box"]
    px, py = torch.meshgrid(torch.arange(12.0), torch.arange(12.0),
                            indexing="xy")
    px, py = px.reshape(-1), py.reshape(-1)
    u = torch.full((144, 2), 0.25)
    o, d, _ = camera.generate_rays(ts, px, py, u)
    qx, qy, inside, dist = camera.project(ts, o + d * 2.0)
    torch.testing.assert_close(qx, px + 0.25, rtol=0, atol=1e-4)
    torch.testing.assert_close(qy, py + 0.25, rtol=0, atol=1e-4)
    assert inside.all()
    torch.testing.assert_close(dist, torch.full_like(dist, 2.0))
    we = camera.importance_weight(ts, d)
    fwd = ts.cam_to_world[:3, 2]
    thf = float(ts.cam_tan_half_fov_x)
    torch.testing.assert_close(we, 144.0 / (4 * thf * thf * (d @ fwd) ** 3))
    assert float(camera.importance_weight(ts, -fwd[None])[0]) == 0.0


def test_lighttrace_pass_matches_jax(scenes):
    js, ts = scenes["fog"]
    _hold(lighttrace.render_pass(ts, PhotonConfig(**LT_KW), 1 << 14, 22, 0),
          jlighttrace.render_pass(js, JaxPhotonConfig(**LT_KW), 1 << 14, 22,
                                  0))
