"""The port's SPPM estimators (gvpm_tpu_torch/integrators/estimators.py)
against gvpm_tpu's on the JAX stage inputs of one 16^2 box_medium pass
(the photon SoA, the gather points and the compacted camera segments of
tests/test_torch_common.py's config, converted through interop): the
surface gather and the volume point gather with distance sampling, at
the default per-cell budget and at grid_max_photons_per_cell=4, where
the strided overflow subsample runs. Also the SPPM gather-time BSDF on
all eight BSDF types. Bar: rtol 2e-4 / atol 5e-6, the reference kernel
test's (tests/test_pallas_gather.py)."""

import dataclasses
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
from gvpm_tpu.integrators import planar as jpl
from gvpm_tpu.integrators import sppm as jsppm
from gvpm_tpu.ops import hashgrid as jhg
from gvpm_tpu_torch import interop
from gvpm_tpu_torch.core.config import PhotonConfig
from gvpm_tpu_torch.integrators import estimators, planar, sppm
from gvpm_tpu_torch.ops import hashgrid
from tests.test_torch_common import (torch_threads,  # noqa: F401
                                     IT, N_PHOTONS, SEED, SPPM_KW,
                                     jax_scene, port_scene_from_jax, t,
                                     to_np)

TOL = dict(rtol=2e-4, atol=5e-6)
JAX_PCFG = JaxPhotonConfig(**SPPM_KW)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jax_stages(scene, cfg, r_vol_base):
    """Photons, gather points and compacted camera segments of one pass,
    as gvpm_tpu's sppm.gather_images builds them."""
    n = scene.width * scene.height
    k_cam = jrng.pass_key(SEED, IT, jrng.STREAM_CAMERA)
    k_light = jrng.pass_key(SEED, IT, jrng.STREAM_LIGHT)
    k_gather = jrng.pass_key(SEED, IT, jrng.STREAM_GATHER)
    photons, _ = jsppm.shoot_photons(scene, cfg, N_PHOTONS, k_light)
    py, px = jnp.mgrid[0:scene.height, 0:scene.width]
    gps, cam = jgp.trace(scene, cfg, k_cam,
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
    cell_s = 2.0 * jnp.maximum(
        jnp.max(jnp.where(gps.valid, gps.radius, 0.0)), 1e-5)
    return dict(photons=photons, gps=gps, cb=cbd, cell_s=cell_s,
                r_vol=jnp.float32(r_vol_base),
                k_gather=jax.random.key_data(k_gather))


@functools.partial(jax.jit, static_argnames=("max_per_cell", "hash_size"))
def _jax_surface(scene, st, max_per_cell, hash_size):
    ph = st["photons"]
    grid = jhg.build(ph["p"], ph["vtype"] == 1, scene.world_lo,
                     st["cell_s"], hash_size=hash_size)
    return jest.surface_gather(scene, st["gps"], grid, ph["p"], ph,
                               N_PHOTONS, 1.0, max_per_cell=max_per_cell,
                               stencil=8)


@functools.partial(jax.jit, static_argnames=("max_per_cell", "hash_size",
                                             "n_samples"))
def _jax_volume(scene, st, max_per_cell, hash_size, n_samples):
    ph = st["photons"]
    grid = jhg.build(ph["p"], ph["vtype"] == 2, scene.medium_lo,
                     2.0 * st["r_vol"], hash_size=hash_size)
    return jest.volume_distance_gather(
        scene, st["cb"], grid, ph["p"], ph, N_PHOTONS, st["r_vol"],
        jax.random.wrap_key_data(st["k_gather"]), n_samples=n_samples,
        max_per_cell=max_per_cell, stencil=8)


@pytest.fixture(scope="module")
def stages():
    js = jax_scene()
    st = _jax_stages(js, JAX_PCFG, jsppm.base_volume_radius(js, JAX_PCFG))
    ref = to_np(st)
    port = dict(
        photons=interop.tensors_from_arrays(ref["photons"], device="cpu"),
        gps=interop.gather_points_from_arrays(
            {f.name: getattr(ref["gps"], f.name)
             for f in dataclasses.fields(ref["gps"])}, device="cpu"),
        cb=interop.tensors_from_arrays(ref["cb"], device="cpu"))
    return js, st, port_scene_from_jax(js), port, ref


def _overflowed(grid, x, budget):
    _, count, _ = hashgrid.stencil_ranges(grid, x, 8, dedup_buckets=True)
    return int((count.sum(1) > budget).sum())


@pytest.mark.parametrize("max_per_cell", [32, 4])
def test_surface_gather_matches_jax(stages, max_per_cell):
    js, st, scene, port, ref = stages
    want = np.asarray(_jax_surface(js, st, max_per_cell,
                                   JAX_PCFG.grid_hash_size))
    ph = port["photons"]
    grid = hashgrid.build(ph["p"], ph["vtype"] == 1, scene.world_lo,
                          t(ref["cell_s"]), hash_size=JAX_PCFG.grid_hash_size)
    got = estimators.surface_gather(scene, port["gps"], grid, ph["p"], ph,
                                    N_PHOTONS, 1.0,
                                    max_per_cell=max_per_cell).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    assert (want > 0).sum() > 20
    np.testing.assert_allclose(got, want, **TOL)
    if max_per_cell == 4:
        assert _overflowed(grid, port["gps"].p, 2 * max_per_cell) > 0


@pytest.mark.parametrize("max_per_cell", [32, 4])
def test_volume_distance_gather_matches_jax(stages, max_per_cell):
    js, st, scene, port, ref = stages
    n_samples = SPPM_KW["volume_samples"]
    want, want_pix = _jax_volume(js, st, max_per_cell,
                                 JAX_PCFG.grid_hash_size, n_samples)
    ph = port["photons"]
    r_vol = t(ref["r_vol"])
    grid = hashgrid.build(ph["p"], ph["vtype"] == 2, scene.medium_lo,
                          2.0 * r_vol, hash_size=JAX_PCFG.grid_hash_size)
    got, pix = estimators.volume_distance_gather(
        scene, port["cb"], grid, ph["p"], ph, N_PHOTONS, r_vol,
        t(ref["k_gather"]), n_samples=n_samples, max_per_cell=max_per_cell)
    np.testing.assert_array_equal(pix.numpy(), np.asarray(want_pix))
    got = got.numpy()
    want = np.asarray(want)
    assert np.isfinite(got).all() and (want > 0).sum() > 20
    np.testing.assert_allclose(got, want, **TOL)


def test_eval_bsdf_gather_all_types_matches_jax():
    """Eight BSDF rows, one of each type, on random local directions
    (a quarter below the horizon)."""
    rng = np.random.default_rng(3)
    js = jax_scene()
    nb = 8
    tables = dict(
        bsdf_type=np.arange(nb, dtype=np.int32),
        bsdf_albedo=rng.uniform(0.2, 0.9, (nb, 3)).astype(np.float32),
        bsdf_k=rng.uniform(0.1, 3.0, (nb, 3)).astype(np.float32),
        bsdf_eta3=rng.uniform(0.2, 1.5, (nb, 3)).astype(np.float32),
        bsdf_alpha=np.where(np.arange(nb) == 6, 20.0,
                            rng.uniform(0.05, 0.5, nb)).astype(np.float32),
        bsdf_eta=np.full(nb, 1.5, np.float32))
    js = js.replace(**{k: jnp.asarray(v) for k, v in tables.items()})
    scene = port_scene_from_jax(js)

    def dirs(shape):
        v = rng.normal(size=shape + (3,))
        v /= np.linalg.norm(v, axis=-1, keepdims=True)
        v[..., 2] = np.where(rng.random(shape) < 0.75, np.abs(v[..., 2]),
                             -np.abs(v[..., 2]))
        return v.astype(np.float32)

    Qn, M = 64, 24
    bi = rng.integers(0, nb, (Qn, M))
    wi, wo = dirs((Qn, M)), dirs((Qn, M))
    ref = jpl.eval_bsdf_gather(js, jnp.asarray(bi),
                               tuple(jnp.asarray(wi[..., c]) for c in range(3)),
                               tuple(jnp.asarray(wo[..., c]) for c in range(3)))
    got = planar.eval_bsdf_gather(scene, torch.tensor(bi),
                                  tuple(torch.tensor(wi[..., c])
                                        for c in range(3)),
                                  tuple(torch.tensor(wo[..., c])
                                        for c in range(3)))
    for c in range(3):
        np.testing.assert_allclose(got[c].numpy(), np.asarray(ref[c]), **TOL)
    for b in (0, 3, 6, 7):       # the non-delta lobes give light
        assert float(got[0][torch.tensor(bi) == b].abs().max()) > 0
    for b in (1, 2, 4, 5):       # delta / transmissive lobes give none
        assert float(got[0][torch.tensor(bi) == b].abs().max()) == 0


def test_unported_estimators_raise():
    for fn in (estimators.bre_gather, estimators.knn_radii):
        with pytest.raises(NotImplementedError, match="item 13"):
            fn()
    for fn in (estimators.beam_beam_gather, estimators.beam_point_gather,
               estimators.make_planes, estimators.plane_gather):
        with pytest.raises(NotImplementedError, match="item 14"):
            fn()
    scene = port_scene_from_jax(jax_scene())
    for volume, item in (("bre", "item 13"), ("beam1d", "item 14"),
                         ("beam3d", "item 14"), ("plane0d", "item 14")):
        with pytest.raises(NotImplementedError, match=item):
            sppm.render_pass(scene, PhotonConfig(), volume, 64, 0, 0,
                             1.0, 1.0, 0.02)
