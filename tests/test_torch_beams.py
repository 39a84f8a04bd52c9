"""The port's photon beams and planes (gvpm_tpu_torch: ptracer.LightBeams,
estimators.make_planes, beam_beam_gather, beam_point_gather,
plane_gather, and the plain version of ops/beam_sweep.py they run on the
CPU) against gvpm_tpu's, on tests/test_torch_common.py's 16^2 config
(2^10 light paths, max_depth 4): the beam record of the light pass, the
planes and the three estimators on the JAX package's own inputs
(converted through interop), and one whole SPPM pass per new volume
estimator (bre, beam1d, beam3d, plane0d).

Bars: the light pass's discrete fields exactly, its floats at rtol 1e-4
/ atol 1e-5 (tests/test_torch_stages.py's: ulp-level exp/log
differences of the walk); estimators and passes at rtol 2e-4 / atol
5e-6, the reference kernel test's; the accepted-pair counts against the
segments with a non-zero JAX contribution, differing in at most 0.1% of
the segments (0 at this size: no decision flips)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvpm_tpu.core import rng as jrng
from gvpm_tpu.core.config import PhotonConfig as JaxPhotonConfig
from gvpm_tpu.integrators import estimators as jest
from gvpm_tpu.integrators import gatherpoint as jgp
from gvpm_tpu.integrators import ptracer as jpt
from gvpm_tpu.integrators import sppm as jsppm
from gvpm_tpu_torch import interop
from gvpm_tpu_torch.core import rng
from gvpm_tpu_torch.core.config import PhotonConfig
from gvpm_tpu_torch.integrators import estimators, ptracer, sppm
from gvpm_tpu_torch.ops import beam_sweep
from tests.test_torch_common import (torch_threads,  # noqa: F401
                                     IT, N_PHOTONS, SEED, SIDE, SPPM_KW,
                                     jax_scene, port_scene_from_jax, t,
                                     to_np)

TOL = dict(rtol=2e-4, atol=5e-6)
JAX_PCFG = JaxPhotonConfig(**SPPM_KW)
# the whole-pass tests: a per-cell budget no stencil exceeds (see
# tests/test_torch_sppm.py)
PASS_KW = dict(SPPM_KW, grid_max_photons_per_cell=160)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jax_stages(scene, cfg, r_vol_base):
    """Photons, beams, planes and compacted camera segments of one pass,
    as gvpm_tpu's sppm.gather_images builds them."""
    n = scene.width * scene.height
    k_cam = jrng.pass_key(SEED, IT, jrng.STREAM_CAMERA)
    k_light = jrng.pass_key(SEED, IT, jrng.STREAM_LIGHT)
    k_gather = jrng.pass_key(SEED, IT, jrng.STREAM_GATHER)
    photons, beams = jsppm.shoot_photons(scene, cfg, N_PHOTONS, k_light)
    _, lb = jpt.shoot(scene, cfg, N_PHOTONS, k_light)
    py, px = jnp.mgrid[0:scene.height, 0:scene.width]
    _, cam = jgp.trace(scene, cfg, k_cam,
                       px.reshape(-1).astype(jnp.float32),
                       py.reshape(-1).astype(jnp.float32))
    cb = jax.tree_util.tree_map(lambda a: a.reshape((-1,) + a.shape[2:]),
                                cam)
    lane = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[None, :],
                            cam.valid.shape).reshape(-1)
    cbd = dict(valid=cb.valid, o=cb.o, d=cb.d, length=cb.length,
               med=cb.med, thr=cb.thr, pixel=lane)
    order = jnp.argsort(~cb.valid)[:n * cfg.vol_segments_per_pixel]
    cbd = {k: v[order] for k, v in cbd.items()}
    r_b = jnp.float32(r_vol_base)
    planes = jest.make_planes(scene, beams, k_gather)
    out = dict(
        light_beams=lb, beams=beams, planes=planes, cb=cbd, r_b=r_b,
        k_gather=jax.random.key_data(k_gather),
        beam1d=jest.beam_beam_gather(scene, cbd, beams, N_PHOTONS, r_b,
                                     tile=cfg.beam_tile),
        beam3d=jest.beam_point_gather(scene, cbd, beams, N_PHOTONS, r_b,
                                      k_gather, n_samples=2,
                                      tile=cfg.beam_tile),
        plane0d=jest.plane_gather(scene, cbd, planes, N_PHOTONS,
                                  tile=cfg.beam_tile))
    return out


@pytest.fixture(scope="module")
def stages():
    js = jax_scene()
    ref = to_np(_jax_stages(js, JAX_PCFG,
                            jsppm.base_volume_radius(js, JAX_PCFG)))
    port = {k: interop.tensors_from_arrays(ref[k], device="cpu")
            for k in ("beams", "planes", "cb")}
    return port_scene_from_jax(js), port, ref


def _assert_field(name, ref, got):
    got = got.numpy()
    ref = np.asarray(ref)
    assert ref.shape == got.shape, name
    if ref.dtype.kind == "f":
        fin = np.isfinite(ref)
        assert np.array_equal(fin, np.isfinite(got)), name
        np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    else:
        np.testing.assert_array_equal(got, ref.astype(got.dtype),
                                      err_msg=name)


def test_light_beams_match_jax(stages):
    """ptracer.shoot's LightBeams [S, P], every field, and the flattened
    beam dict of shoot_photons (its shift caches included)."""
    scene, _, ref = stages
    key = rng.pass_key(SEED, IT, rng.STREAM_LIGHT)
    _, lb = ptracer.shoot(scene, PhotonConfig(**SPPM_KW), N_PHOTONS, key)
    jlb = ref["light_beams"]
    for name, v in lb.asdict().items():
        _assert_field(name, getattr(jlb, name), v)
    assert int(lb.valid.sum()) > 100
    _, beams = sppm.shoot_photons(scene, PhotonConfig(**SPPM_KW), N_PHOTONS,
                                  key)
    assert set(beams) == set(ref["beams"]) == set(sppm.BEAM_FIELDS)
    for name, v in beams.items():
        _assert_field(name, ref["beams"][name], v)


def test_light_pass_without_beams(stages):
    """A pass that reads no beam skips the record: the same photons, bit
    for bit, and no beam dict."""
    scene = stages[0]
    key = rng.pass_key(SEED, IT, rng.STREAM_LIGHT)
    cfg = PhotonConfig(**SPPM_KW)
    want, _ = sppm.shoot_photons(scene, cfg, N_PHOTONS, key)
    got, beams = sppm.shoot_photons(scene, cfg, N_PHOTONS, key,
                                    with_beams=False)
    assert beams is None and set(got) == set(want)
    for name, v in got.items():
        assert torch.equal(v, want[name]), name


def test_make_planes_matches_jax(stages):
    scene, port, ref = stages
    got = estimators.make_planes(scene, port["beams"], t(ref["k_gather"]))
    assert set(got) == set(ref["planes"])
    for name, v in got.items():
        _assert_field(name, ref["planes"][name], v)
    assert int(got["valid"].sum()) > 100


@pytest.mark.parametrize("kind", beam_sweep.KINDS)
def test_estimator_matches_jax(stages, kind):
    scene, port, ref = stages
    cb, r_b = port["cb"], t(ref["r_b"])
    stats = {}
    if kind == "beam1d":
        got, pix = estimators.beam_beam_gather(
            scene, cb, port["beams"], N_PHOTONS, r_b, stats=stats)
    elif kind == "beam3d":
        got, pix = estimators.beam_point_gather(
            scene, cb, port["beams"], N_PHOTONS, r_b, t(ref["k_gather"]),
            n_samples=2, stats=stats)
    else:
        got, pix = estimators.plane_gather(scene, cb, port["planes"],
                                           N_PHOTONS, stats=stats)
    want, want_pix = ref[kind]
    np.testing.assert_array_equal(pix.numpy(), want_pix)
    got = got.numpy()
    assert np.isfinite(got).all() and (want > 0).sum() > 20
    np.testing.assert_allclose(got, want, **TOL)
    seen = stats["pairs"].numpy() > 0
    flips = int((seen != (want != 0).any(-1)).sum())
    assert stats["pairs"].dtype == torch.int32
    assert flips <= 0.001 * seen.shape[0], flips
    assert int(stats["pairs"].sum()) > 50


def test_survival_prob_matches_jax(stages):
    scene, port, ref = stages
    js = jax_scene()
    mi = ref["cb"]["med"]
    tt = np.linspace(0.0, 3.0, mi.shape[0], dtype=np.float32)
    want = np.asarray(jest.survival_prob(js, jnp.asarray(mi),
                                         jnp.asarray(tt)))
    got = estimators.survival_prob(scene, t(mi), torch.tensor(tt)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("volume", ["bre", "beam1d", "beam3d", "plane0d"])
def test_sppm_pass_matches_jax(volume):
    js = jax_scene()
    jcfg = JaxPhotonConfig(**PASS_KW)
    ref = np.asarray(jsppm.render_pass(
        js, jcfg, volume, N_PHOTONS, SEED, IT, 0.9, 0.8,
        jsppm.base_volume_radius(js, jcfg)))
    scene = port_scene_from_jax(js)
    cfg = PhotonConfig(**PASS_KW)
    timings = {}
    got = sppm.render_pass(scene, cfg, volume, N_PHOTONS, SEED, IT, 0.9,
                           0.8, sppm.base_volume_radius(scene, cfg),
                           timings=timings).numpy()
    assert got.shape == (SIDE, SIDE, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, **TOL)
    assert "volume_gather" in timings
    # the volume estimator adds light over the surface-only image
    none = sppm.render_pass(scene, cfg, "none", N_PHOTONS, SEED, IT, 0.9,
                            0.8, 0.02).numpy()
    assert got.mean() > none.mean()
