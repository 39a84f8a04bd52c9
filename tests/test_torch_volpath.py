"""The port's volumetric path tracer (gvpm_tpu_torch/integrators/volpath.py)
and film (render/film.py): the analytic cases of tests/test_volpath.py
(direct radiance, Beer-Lambert through an absorbing slab), every film
filter against gvpm_tpu's film on the same numpy-seeded splats, and a
16^2 box_medium render at 2 spp against gvpm_tpu's volpath (the same
random streams: per-pass keys, per-step splits). Bar for the render:
rtol 1e-4 / atol 1e-5, with at most 2% of the pixels allowed to differ
by a Russian-roulette decision flipped at the last bit (0 measured)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvpm_tpu.core.config import VolPathConfig as JaxVolPathConfig
from gvpm_tpu.integrators import volpath as jvolpath
from gvpm_tpu.render import film as jfilm
from gvpm_tpu_torch.core.config import VolPathConfig
from gvpm_tpu_torch.integrators import volpath
from gvpm_tpu_torch.render import film
from gvpm_tpu_torch.scene import SceneBuilder
from gvpm_tpu_torch.utils import image as imglib
from tests.test_torch_common import (jax_scene, port_scene_from_jax,
                                     torch_threads)  # noqa: F401


def _light_panel_scene(sigma_a=None):
    """tests/test_volpath.py's scene: the camera stares at an emissive
    panel 2 m away, optionally through an absorbing slab."""
    b = SceneBuilder()
    light = b.area_light([5.0, 4.0, 3.0])
    black = b.diffuse([0.0, 0.0, 0.0])
    b.rectangle([-2, -2, 2.0], [0, 4, 0], [4, 0, 0], black, emitter=light)
    if sigma_a is not None:
        m = b.homogeneous(sigma_a=sigma_a, sigma_s=[0, 0, 0])
        b.medium_box([-3, -3, 0.5], [3, 3, 1.5], m)
    b.camera(origin=[0, 0, 0], target=[0, 0, 1], fov=20)
    return b.build(width=16, height=16, device="cpu")


def test_direct_light_radiance():
    img = volpath.render(_light_panel_scene(),
                         VolPathConfig(spp=4, max_depth=3), seed=1)
    np.testing.assert_allclose(img.numpy(), np.broadcast_to(
        [5.0, 4.0, 3.0], img.shape), rtol=1e-3)


def test_absorbing_medium_beer_lambert():
    sa = [0.5, 1.0, 2.0]
    img = volpath.render(_light_panel_scene(sigma_a=sa),
                         VolPathConfig(spp=192, max_depth=6), seed=2)
    center = img[7:9, 7:9].numpy().mean(axis=(0, 1))
    expect = np.array([5.0, 4.0, 3.0]) * np.exp(-np.array(sa) * 1.0)
    np.testing.assert_allclose(center, expect, rtol=0.08)


@pytest.mark.parametrize("rfilter", sorted(film.FILTERS))
def test_film_filters_match_jax(rfilter):
    rng = np.random.default_rng(5)
    H, W, N = 12, 10, 500
    px = rng.uniform(-1.0, W + 1.0, N).astype(np.float32)
    py = rng.uniform(-1.0, H + 1.0, N).astype(np.float32)
    val = rng.uniform(0.0, 2.0, (N, 3)).astype(np.float32)
    mask = rng.random(N) < 0.9
    ref_img, ref_w = jfilm.splat_filtered(
        jfilm.new_film(H, W), jnp.zeros((H, W)), jnp.asarray(px),
        jnp.asarray(py), jnp.asarray(val), rfilter=rfilter,
        mask=jnp.asarray(mask))
    img, w = film.splat_filtered(
        film.new_film(H, W), torch.zeros((H, W)), torch.tensor(px),
        torch.tensor(py), torch.tensor(val), rfilter=rfilter,
        mask=torch.tensor(mask))
    np.testing.assert_allclose(img.numpy(), np.asarray(ref_img), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(w.numpy(), np.asarray(ref_w), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(
        film.develop_filtered(img, w).numpy(),
        np.asarray(jfilm.develop_filtered(ref_img, ref_w)), rtol=1e-4,
        atol=1e-6)
    if rfilter == "box":
        ref = jfilm.splat(jfilm.new_film(H, W), jnp.asarray(px),
                          jnp.asarray(py), jnp.asarray(val),
                          mask=jnp.asarray(mask))
        got = film.splat(film.new_film(H, W), torch.tensor(px),
                         torch.tensor(py), torch.tensor(val),
                         mask=torch.tensor(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)
        ix = np.floor(px).astype(np.int64)
        iy = np.floor(py).astype(np.int64)
        ref = jfilm.splat_pixel(jfilm.new_film(H, W), jnp.asarray(ix),
                                jnp.asarray(iy), jnp.asarray(val))
        got = film.splat_pixel(film.new_film(H, W), torch.tensor(ix),
                               torch.tensor(iy), torch.tensor(val))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)
        assert film.relmse(got, got + 0.1) == pytest.approx(
            jfilm.relmse(np.asarray(ref), np.asarray(ref) + 0.1), rel=1e-5)


@pytest.mark.parametrize("rfilter,max_lanes", [("box", 1 << 20),
                                               ("gaussian", 256)])
def test_render_box_medium_matches_jax(rfilter, max_lanes):
    """max_lanes 256 runs one spp a pass (two pass keys), as the goldens'
    128^2 generation does."""
    js = jax_scene()
    kw = dict(spp=2, max_depth=12, rfilter=rfilter)
    ref = np.asarray(jvolpath.render(js, JaxVolPathConfig(**kw), seed=101,
                                     max_lanes=max_lanes))
    got = volpath.render(port_scene_from_jax(js), VolPathConfig(**kw),
                         seed=101, max_lanes=max_lanes).numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert got.mean() > 0
    bad = ~np.isclose(got, ref, rtol=1e-4, atol=1e-5).all(-1)
    assert bad.mean() <= 0.02, (int(bad.sum()), np.abs(got - ref).max())
    np.testing.assert_allclose(got[~bad], ref[~bad], rtol=1e-4, atol=1e-5)
    assert imglib.relmse(got, ref) < 1e-6


def test_unported_branches_raise():
    """What volpath left to ROADMAP queue 1 item 16 now runs: tile_rngs
    and u_explicit (the G-PT and Metropolis callers; held against the
    JAX package in tests/test_torch_gpt.py and tests/test_torch_mcmc.py)
    and every QMC pixel sampler (tests/test_torch_qmc_numerics.py); an
    unknown sampler raises the JAX package's ValueError. Delta lights
    and environment maps, which raised here before, are parity
    cases of tests/test_torch_lights.py and
    tests/test_torch_scene_passes.py."""
    scene = port_scene_from_jax(jax_scene())
    cfg = VolPathConfig(max_depth=3, null_bounces=1)
    o = torch.full((4, 3), 0.5)
    d = torch.tensor([[0.0, 0.0, 1.0]]).repeat(4, 1)
    key = torch.tensor([0, 7])
    L = volpath.trace_radiance(scene, cfg, o, d, 0, key, tile_rngs=2)
    torch.testing.assert_close(L[:2], L[2:], rtol=0, atol=0)
    u = torch.full((4, 4, volpath.PSS_DIMS_PER_STEP), 0.5)
    L = volpath.trace_radiance(scene, cfg, o, d, 0, None, u_explicit=u)
    assert L.shape == (4, 3) and bool(torch.isfinite(L).all())
    torch.testing.assert_close(L, L[:1].expand(4, 3), rtol=0, atol=0)
    img = volpath.render(scene, VolPathConfig(spp=1, max_depth=3,
                                              sampler="sobol"))
    assert bool(torch.isfinite(img).all())
    with pytest.raises(ValueError, match="unknown sampler"):
        volpath.render(scene, VolPathConfig(spp=1, sampler="none"))
