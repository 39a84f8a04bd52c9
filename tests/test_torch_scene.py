"""The port's scene layer against gvpm_tpu: the tables of every built-in
scene and of the feature scenes (heterogeneous fog, delta and
environment lights, an environment map, every lobe, thinlens,
triangle-free), the camera rays, the exact closest-hit intersection and
the homogeneous medium's three distance-sampling strategies."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvpm_tpu import scenes as jscenes
from gvpm_tpu.render import medium as jmed
from gvpm_tpu.scene import camera as jcam
from gvpm_tpu.scene.intersect import intersect as jax_intersect
from gvpm_tpu.scene.intersect import occluded as jax_occluded
from gvpm_tpu_torch import scenes
from gvpm_tpu_torch.render import medium
from gvpm_tpu_torch.scene import camera, intersect
from tests.test_torch_common import jax_feature_scene, port_scene_from_jax
from tests.test_torch_common import torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def pair():
    js = jscenes.box_medium(width=24, height=16)
    return js, port_scene_from_jax(js)


@pytest.mark.parametrize("name", sorted(jscenes.REGISTRY)
                         + [f"feature:{k}" for k in scenes.FEATURES])
def test_interop_scene_equals_port_box_medium(pair, name):
    """The port's SceneBuilder gives the JAX builder's tables value for
    value: each registry scene (box-medium at the module's 24x16) and
    each feature scene of scenes.feature_box (an 8^3 density grid)."""
    if name == "box-medium":
        _, carried = pair
        own = scenes.box_medium(width=24, height=16, device="cpu")
    elif name.startswith("feature:"):
        kind = name.split(":")[1]
        carried = port_scene_from_jax(jax_feature_scene(kind, 12))
        own = scenes.feature_scene(kind, 12, 12, grid=8, device="cpu")
    else:
        carried = port_scene_from_jax(jscenes.get(name, width=12,
                                                  height=10))
        own = scenes.get(name, width=12, height=10, device="cpu")
    for k, v in own.tensors().items():
        c = getattr(carried, k)
        assert c.dtype == v.dtype and c.shape == v.shape, k
        assert torch.equal(c, v), k
    for k in ("width", "height", "cam_aperture", "cam_focus",
              "het_medium"):
        assert getattr(carried, k) == getattr(own, k), k


def test_scene_floats_are_float32(pair):
    _, sc = pair
    for name, v in sc.tensors().items():
        assert v.dtype in (torch.float32, torch.int64), name


def test_generate_rays(pair):
    js, sc = pair
    rs = np.random.default_rng(0)
    px = rs.integers(0, 24, 500).astype(np.float32)
    py = rs.integers(0, 16, 500).astype(np.float32)
    u = rs.random((500, 2), dtype=np.float32)
    ref = jax.jit(jcam.generate_rays)(js, px, py, u)
    got = camera.generate_rays(sc, torch.from_numpy(px),
                               torch.from_numpy(py), torch.from_numpy(u))
    for a, b in zip(ref, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("bounded", [False, True])
def test_intersect_same_prim_and_t(pair, bounded):
    js, sc = pair
    rs = np.random.default_rng(1)
    o = rs.uniform(-0.2, 1.2, (2000, 3)).astype(np.float32)
    d = rs.normal(size=(2000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = rs.uniform(0.05, 1.5, 2000).astype(np.float32) if bounded \
        else None
    ref = jax.jit(jax_intersect)(js, jnp.asarray(o), jnp.asarray(d), t_max)
    got = intersect.intersect(
        sc, torch.from_numpy(o), torch.from_numpy(d),
        None if t_max is None else torch.from_numpy(t_max))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    v = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.prim.numpy()[v],
                                  np.asarray(ref.prim)[v])
    np.testing.assert_allclose(got.t.numpy()[v], np.asarray(ref.t)[v],
                               rtol=1e-6, atol=1e-7)
    for k in ("p", "ng", "ns"):
        np.testing.assert_allclose(getattr(got, k).numpy()[v],
                                   np.asarray(getattr(ref, k))[v],
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert 0.2 < v.mean() and (bounded or v.mean() > 0.5)


def test_occluded(pair):
    js, sc = pair
    rs = np.random.default_rng(3)
    a = rs.uniform(-0.2, 1.2, (2000, 3)).astype(np.float32)
    b = rs.uniform(-0.2, 1.2, (2000, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(jax_occluded)(js, a, b))
    got = intersect.occluded(sc, torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0 < ref.mean() < 1


@pytest.mark.parametrize("strategy,channel", [
    (medium.NORMAL, False), (medium.NORMAL, True), (medium.LONG, False),
    (medium.ALWAYS_VALID, False)])
def test_sample_distance(pair, strategy, channel):
    js, sc = pair
    rs = np.random.default_rng(2)
    n = 2000
    mi = rs.integers(-1, 1, n)
    o = rs.uniform(0.05, 0.95, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    # a LONG sample lands at -log(1e-4)/sigma_t ~ 20: reach it sometimes
    t_hi = 40.0 if strategy == medium.LONG else 3.0
    t_max = rs.uniform(0.01, t_hi, n).astype(np.float32)
    u = rs.random(n, dtype=np.float32)
    uc = rs.random(n, dtype=np.float32) if channel else None
    ref = jax.jit(jmed.sample_distance, static_argnames=("strategy",))(
        js, jnp.asarray(mi, jnp.int32), o, d, t_max, u, strategy=strategy,
        u_channel=uc)
    got = medium.sample_distance(
        sc, torch.from_numpy(mi), torch.from_numpy(o), torch.from_numpy(d),
        torch.from_numpy(t_max), torch.from_numpy(u), strategy=strategy,
        u_channel=None if uc is None else torch.from_numpy(uc))
    np.testing.assert_array_equal(got.success.numpy(),
                                  np.asarray(ref.success))
    assert 0 < got.success.numpy().mean() < 1
    for k in ("t", "p", "transmittance", "pdf_success", "pdf_failure",
              "sigma_s"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(ref, k)), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
