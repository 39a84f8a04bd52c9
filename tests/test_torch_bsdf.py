"""The port's BSDF sampling and evaluation (render/bsdf.py) against
gvpm_tpu's on numpy-seeded inputs: sample_bsdf for all eight lobes
under radiance and importance transport (wo, weight, pdf, eta, is_delta
and valid), and eval_bsdf / pdf_bsdf with the rough dielectric's two
transports, in a scene whose BSDF table holds one row of each type.

Bar: the masks (valid, is_delta) exactly equal; directions, weights,
pdfs and eta at rtol 1e-4 / atol 1e-5 (ulp-level exp / log / pow /
sqrt differences between XLA and PyTorch, amplified by the Beckmann
exponent and phong's power)."""

import jax
import numpy as np
import pytest
import torch

from gvpm_tpu.render import bsdf as jbsdf
from gvpm_tpu.scene import SceneBuilder as JaxSceneBuilder
from gvpm_tpu_torch.render import bsdf
from gvpm_tpu_torch.scene import SceneBuilder
from gvpm_tpu_torch.scene.types import (BSDF_CONDUCTOR, BSDF_DIELECTRIC,
                                        BSDF_DIFFUSE, BSDF_NULL, BSDF_PHONG,
                                        BSDF_PLASTIC, BSDF_ROUGH_CONDUCTOR,
                                        BSDF_ROUGH_DIELECTRIC)
from tests.test_torch_common import port_scene_from_jax
from tests.test_torch_common import torch_threads  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-5)
PER_TYPE = 512
TYPES = (BSDF_DIFFUSE, BSDF_CONDUCTOR, BSDF_DIELECTRIC, BSDF_ROUGH_CONDUCTOR,
         BSDF_ROUGH_DIELECTRIC, BSDF_NULL, BSDF_PHONG, BSDF_PLASTIC)


def _lobe_scene(b):
    """One BSDF row of each type, in type-id order."""
    rows = (b.diffuse([0.7, 0.5, 0.3]), b.conductor(),
            b.dielectric(int_ior=1.5),
            b.rough_conductor(alpha=0.3, reflectance=(0.9, 0.8, 0.7)),
            b.rough_dielectric(alpha=0.25, int_ior=1.4),
            b.null_bsdf(),
            b.phong(diffuse=[0.4, 0.3, 0.3], specular=[0.3, 0.3, 0.4],
                    exponent=12.0),
            b.plastic(diffuse=[0.5, 0.6, 0.4], int_ior=1.49))
    assert rows == TYPES
    b.rectangle([0, 0, 0], [1, 0, 0], [0, 1, 0], rows[0])
    b.camera(origin=[0.5, 0.5, -2], target=[0.5, 0.5, 0])
    kw = {} if isinstance(b, JaxSceneBuilder) else dict(device="cpu")
    return b.build(width=4, height=4, **kw)


def _inputs(seed):
    rs = np.random.default_rng(seed)
    n = PER_TYPE * len(TYPES)
    bi = np.repeat(np.arange(len(TYPES)), PER_TYPE)
    wi = rs.normal(size=(n, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    wo = rs.normal(size=(n, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    return bi, wi, wo, rs.random((n, 3), dtype=np.float32)


@pytest.fixture(scope="module")
def scenes():
    js = _lobe_scene(JaxSceneBuilder())
    sc = port_scene_from_jax(js)
    own = _lobe_scene(SceneBuilder())
    for k, v in own.tensors().items():
        assert torch.equal(v.cpu(), getattr(sc, k)), k
    return js, sc


@pytest.fixture(scope="module", params=["radiance", "importance"])
def samples(request, scenes):
    js, sc = scenes
    bi, wi, _, u3 = _inputs(3)
    ref = jax.jit(jbsdf.sample_bsdf, static_argnames=("transport",))(
        js, bi, wi, u3, transport=request.param)
    got = bsdf.sample_bsdf(sc, torch.from_numpy(bi), torch.from_numpy(wi),
                           torch.from_numpy(u3), transport=request.param)
    return bi, ref, got


@pytest.mark.parametrize("btype", TYPES)
def test_sample_bsdf_matches_jax(samples, btype):
    bi, ref, got = samples
    m = bi == btype
    for k in ("valid", "is_delta"):
        np.testing.assert_array_equal(getattr(got, k).numpy()[m],
                                      np.asarray(getattr(ref, k))[m],
                                      err_msg=k)
    ok = np.asarray(ref.valid)[m]
    assert ok.mean() > 0.3
    for k in ("wo", "weight", "pdf", "eta"):
        np.testing.assert_allclose(getattr(got, k).numpy()[m][ok],
                                   np.asarray(getattr(ref, k))[m][ok],
                                   err_msg=k, **TOL)


@pytest.mark.parametrize("transport", ["radiance", "importance"])
def test_eval_bsdf_matches_jax(scenes, transport):
    """f and pdf of every lobe (delta lobes 0) on random direction
    pairs in both hemispheres; the rough dielectric's refraction lobe
    is the one transport changes."""
    js, sc = scenes
    bi, wi, wo, u3 = _inputs(4)
    # every other pair in the lobe: wo sampled from it
    drawn = bsdf.sample_bsdf(sc, torch.from_numpy(bi), torch.from_numpy(wi),
                             torch.from_numpy(u3), transport=transport)
    wo[1::2] = drawn.wo.numpy()[1::2]
    f_ref, pdf_ref = jax.jit(jbsdf.eval_bsdf,
                             static_argnames=("transport",))(
        js, bi, wi, wo, transport=transport)
    f, pdf = bsdf.eval_bsdf(sc, torch.from_numpy(bi), torch.from_numpy(wi),
                            torch.from_numpy(wo), transport=transport)
    np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), **TOL)
    np.testing.assert_allclose(pdf.numpy(), np.asarray(pdf_ref), **TOL)
    rd = bi == BSDF_ROUGH_DIELECTRIC
    refr = (wi[:, 2] * wo[:, 2] < 0) & rd
    assert (pdf.numpy()[refr] > 1e-3).sum() > 50
    np.testing.assert_allclose(
        bsdf.pdf_bsdf(sc, torch.from_numpy(bi), torch.from_numpy(wi),
                      torch.from_numpy(wo), transport=transport).numpy(),
        pdf.numpy())
