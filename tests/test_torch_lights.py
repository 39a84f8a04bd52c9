"""The port's emitters (render/emitter.py) and thinlens camera against
gvpm_tpu's on numpy-seeded inputs, in scenes.feature_box's scenes:
"lights" (a point, a spot and a directional light and a constant
environment), "envmap" (a lat-long map alone), "bare" (no area light)
and "materials" (a thinlens): next-event samples over the emitter
groups, photon emission from every group (keyed by position and by lane
id), the environment map's radiance, pdf and importance sampling, and
thinlens primary rays.

Bar: group picks, validity and the discrete fields exactly equal;
floats at rtol 1e-4 / atol 1e-5 (ulp-level trigonometric differences
between XLA and PyTorch; the env map's pdf divides by sin(theta))."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvpm_tpu.render import emitter as jem
from gvpm_tpu.scene import camera as jcam
from gvpm_tpu_torch.core import rng
from gvpm_tpu_torch.render import emitter
from gvpm_tpu_torch.scene import camera
from tests.test_torch_common import jax_feature_scene, port_scene_from_jax
from tests.test_torch_common import torch_threads  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-5)
N = 2048


@pytest.fixture(scope="module", params=["lights", "envmap", "bare"])
def lit(request):
    js = jax_feature_scene(request.param, 12)
    return request.param, js, port_scene_from_jax(js)


def _fields(got, ref, exact, close, mask=None):
    for k in exact:
        g = getattr(got, k) if not isinstance(got, dict) else got[k]
        r = getattr(ref, k) if not isinstance(ref, dict) else ref[k]
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=k)
    for k in close:
        g = getattr(got, k) if not isinstance(got, dict) else got[k]
        r = getattr(ref, k) if not isinstance(ref, dict) else ref[k]
        g, r = g.numpy(), np.asarray(r)
        if mask is not None:
            g, r = g[mask], r[mask]
        np.testing.assert_allclose(g, r, err_msg=k, **TOL)


def test_sample_direct_matches_jax(lit):
    kind, js, sc = lit
    rs = np.random.default_rng(1)
    p = rs.uniform(0.05, 0.95, (N, 3)).astype(np.float32)
    u3 = rs.random((N, 3), dtype=np.float32)
    ref = jax.jit(jem.sample_direct)(js, p, u3)
    got = emitter.sample_direct(sc, torch.from_numpy(p),
                                torch.from_numpy(u3))
    _fields(got, ref, ("valid",), ())
    ok = np.asarray(ref.valid)
    _fields(got, ref, (), ("wl", "p_light", "li_over_pdf", "pdf_sa"), ok)
    np.testing.assert_array_equal(np.asarray(ref.grp),
                                  _groups(sc, u3[:, 0]))
    grp = np.asarray(ref.grp)
    expect = dict(lights=(1, 2), envmap=(2,), bare=(1,))[kind]
    assert set(np.unique(grp[ok])) == set(expect)
    if kind == "lights":
        # delta strategies carry pdf_sa 0; the spot's cone cuts some
        d = grp == 1
        assert (got.pdf_sa.numpy()[d] == 0).all()
        assert 0 < (got.li_over_pdf.numpy()[d].max(-1) == 0).sum() \
            < d.sum()


def _groups(sc, u):
    """The emitter group each pick uniform selects (0 area, 1 delta,
    2 env), as sample_direct and sample_photon pick it."""
    gp = sc.light_group_p.numpy()
    return np.where(u < gp[0], 0, np.where(u < gp[0] + gp[1], 1, 2))


@pytest.mark.parametrize("lanes", [False, True])
def test_sample_photon_matches_jax(lit, lanes):
    kind, js, sc = lit
    ln = np.arange(100, 100 + N, dtype=np.int32) if lanes else None
    ref = jax.jit(jem.sample_photon, static_argnums=2)(
        js, jax.random.fold_in(jax.random.key(3), 1), N,
        lanes=None if ln is None else jnp.asarray(ln))
    got = emitter.sample_photon(
        sc, rng.fold_in(rng.key(3), 1), N,
        lanes=None if ln is None else torch.from_numpy(ln.astype(np.int64)))
    _fields(got, ref, ("valid", "med", "reconnectable", "prim"), ())
    ok = np.asarray(ref["valid"])
    assert ok.mean() > 0.5
    _fields(got, ref, (), ("p", "d", "alpha", "ns", "pdf_dir", "scatter"),
            ok)


def test_env_map_le_pdf_and_sampling():
    js = jax_feature_scene("envmap", 12)
    sc = port_scene_from_jax(js)
    assert sc.env_map.shape == (8, 16, 3)
    rs = np.random.default_rng(2)
    d = rs.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    td = torch.from_numpy(d)
    np.testing.assert_allclose(emitter.env_le(sc, td).numpy(),
                               np.asarray(jax.jit(jem.env_le)(js, d)), **TOL)
    np.testing.assert_allclose(
        emitter.pdf_env_sa(sc, td).numpy(),
        np.asarray(jax.jit(jem.pdf_env_sa)(js, d)), **TOL)
    u2 = rs.random((N, 2), dtype=np.float32)
    d_ref, pdf_ref = jax.jit(jem.sample_env_dir)(js, u2)
    d_got, pdf_got = emitter.sample_env_dir(sc, torch.from_numpy(u2))
    np.testing.assert_allclose(d_got.numpy(), np.asarray(d_ref), **TOL)
    np.testing.assert_allclose(pdf_got.numpy(), np.asarray(pdf_ref), **TOL)
    # the sampled pdf is pdf_env_sa's without the group pick
    np.testing.assert_allclose(
        emitter.pdf_env_sa(sc, d_got).numpy(),
        (pdf_got * sc.light_group_p[2]).numpy(), rtol=2e-3, atol=1e-6)


def test_emitterless_sample_position():
    js = jax_feature_scene("bare", 12)
    sc = port_scene_from_jax(js)
    assert sc.em_prim.shape == (0,) and sc.n_tris == 1
    u3 = np.random.default_rng(4).random((64, 3), dtype=np.float32)
    ref = jem.sample_position(js, u3)
    got = emitter.sample_position(sc, torch.from_numpy(u3))
    _fields(got, ref, ("valid", "prim"), ("p", "n", "radiance", "pdf_area"))
    assert not got.valid.any()
    np.testing.assert_array_equal(
        emitter.pdf_direct_area(sc, torch.arange(4)).numpy(), np.zeros(4))


def test_thinlens_generate_rays():
    js = jax_feature_scene("materials", 12)
    sc = port_scene_from_jax(js)
    assert sc.cam_aperture == 0.05 and sc.cam_focus == 1.6
    rs = np.random.default_rng(6)
    px = rs.integers(0, 12, 500).astype(np.float32)
    py = rs.integers(0, 12, 500).astype(np.float32)
    u = rs.random((500, 2), dtype=np.float32)
    ul = rs.random((500, 2), dtype=np.float32)
    for lens in (ul, None):
        ref = jax.jit(jcam.generate_rays)(js, px, py, u, lens)
        got = camera.generate_rays(
            sc, torch.from_numpy(px), torch.from_numpy(py),
            torch.from_numpy(u), None if lens is None
            else torch.from_numpy(lens))
        for a, b in zip(ref, got):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                       atol=1e-6)
        # the lens moves the origins off the camera's position
        moved = (got[0] - sc.cam_to_world[:3, 3]).abs().amax(-1) > 0
        assert bool(moved.all()) if lens is not None else not moved.any()
