"""The port's beam radiance estimate (BRE) against gvpm_tpu's, on
tests/test_torch_common.py's 16^2 config (2^10 light paths, max_depth
4): the hash grid's per-cell fold (ops/hashgrid.gather), the per-photon
kNN radii, the primal BRE gather with and without them, the gradient
BRE gather with its four reconnection shifts, and a whole G-VPM `bre`
pass.

Inputs are the JAX package's own (converted through interop), so that
ulp-level differences upstream do not compound. Bars: the fold's counts
exactly; the kNN radii at rtol 2.4e-7 (two float32 ulps: torch has no
cbrt, the port takes pow(x, 1/3) in float64 rounded once, jnp.cbrt
differs from it in the last bit of some radii); gathers and the pass at
rtol 2e-4 / atol 5e-6 with visits and shift_ok exactly equal, the
reference kernel test's bar. The whole pass runs at a per-cell budget
no stencil exceeds (ROADMAP.md section 3: the strided overflow subsample
turns last-bit radius differences into other photons), and holds the
JAX package's `dense` surface driver against the port's exact runs."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvpm_tpu.core.config import GradientConfig as JaxGradientConfig
from gvpm_tpu.integrators import estimators as jest
from gvpm_tpu.integrators import gradient_gather as jgg
from gvpm_tpu.integrators import gvpm as jgvpm
from gvpm_tpu.integrators import sppm as jsppm
from gvpm_tpu.ops import hashgrid as jhg
from gvpm_tpu_torch import interop
from gvpm_tpu_torch.core.config import GradientConfig
from gvpm_tpu_torch.integrators import (estimators, gradient_gather, gvpm,
                                        sppm)
from gvpm_tpu_torch.ops import hashgrid
from tests.test_torch_common import (torch_threads,  # noqa: F401
                                     CFG_KW, N_PHOTONS, SEED, IT, SIDE,
                                     jax_scene, jax_stage_inputs,
                                     port_scene_from_jax, t)

TOL = dict(rtol=2e-4, atol=5e-6)
HASH = 1 << 12
K_NN = 2


@pytest.fixture(scope="module")
def stages():
    """The distance pass's stage inputs of test_torch_common (photons,
    compacted base and shifted segments, border lanes, r_vol)."""
    js, ref = jax_stage_inputs()
    port = dict(
        photons=interop.tensors_from_arrays(ref["photons"], device="cpu"),
        cb=interop.tensors_from_arrays(ref["cb"], device="cpu"),
        scb=[interop.tensors_from_arrays(s, device="cpu")
             for s in ref["scb"]])
    return js, port_scene_from_jax(js), ref, port


def _grids(js, scene, ref, port):
    """The BRE volume grid (cell 2 r_vol over medium photons) of both."""
    ph_j, ph_t = ref["photons"], port["photons"]
    r_vol = ref["r_vol"]
    jgrid = jhg.build(jnp.asarray(ph_j["p"]), jnp.asarray(ph_j["vtype"] == 2),
                      js.medium_lo, 2.0 * r_vol, hash_size=HASH)
    grid = hashgrid.build(ph_t["p"], ph_t["vtype"] == 2, scene.medium_lo,
                          2.0 * t(r_vol), hash_size=HASH)
    return jgrid, grid


@functools.partial(jax.jit, static_argnames=("max_per_cell",))
def _jax_fold_count(grid, pp, r0, max_per_cell):
    def fold(carry, idx, ok, scale):
        d2 = jnp.sum((pp[idx] - pp) ** 2, axis=-1)
        return carry + jnp.where(ok & (d2 < r0 * r0), scale, 0.0)
    return jhg.gather(grid, pp, fold, jnp.zeros(pp.shape[0]),
                      max_per_cell=max_per_cell)


@pytest.mark.parametrize("max_per_cell", [32, 2])
def test_hashgrid_fold_matches_jax(stages, max_per_cell):
    """The fold's compensated neighbour counts, exactly (the same order
    of additions); at 2 a cell the overflow scale count/2 runs."""
    js, scene, ref, port = stages
    jgrid, grid = _grids(js, scene, ref, port)
    pp = port["photons"]["p"]
    r0 = t(ref["r_vol"])
    want = np.asarray(_jax_fold_count(jgrid, jnp.asarray(ref["photons"]["p"]),
                                      ref["r_vol"], max_per_cell))

    def fold(carry, idx, ok, scale):
        rel = pp[idx] - pp
        d2 = rel[:, 0] * rel[:, 0] + rel[:, 1] * rel[:, 1] \
            + rel[:, 2] * rel[:, 2]
        return carry + torch.where(ok & (d2 < r0 * r0), scale, 0.0)

    got = hashgrid.gather(grid, pp, fold, torch.zeros(pp.shape[0]),
                          max_per_cell=max_per_cell).numpy()
    med = ref["photons"]["vtype"] == 2
    np.testing.assert_array_equal(got[med], want[med])
    assert got[med].max() > 1
    if max_per_cell == 2:
        assert (got[med] != np.round(got[med])).any()   # scaled counts
    with pytest.raises(ValueError, match="build"):
        hashgrid.gather(grid.replace(identity_order=True), pp, fold,
                        torch.zeros(pp.shape[0]))


@pytest.mark.parametrize("max_per_cell", [32, 2])
def test_knn_radii_match_jax(stages, max_per_cell):
    js, scene, ref, port = stages
    jgrid, grid = _grids(js, scene, ref, port)
    ph = ref["photons"]
    med = ph["vtype"] == 2
    want = np.asarray(jax.jit(jest.knn_radii, static_argnames=(
        "k", "max_per_cell"))(jgrid, jnp.asarray(ph["p"]), jnp.asarray(med),
                              ref["r_vol"], k=K_NN,
                              max_per_cell=max_per_cell))
    got = estimators.knn_radii(grid, port["photons"]["p"], t(med),
                               t(ref["r_vol"]), K_NN,
                               max_per_cell=max_per_cell).numpy()
    np.testing.assert_allclose(got[med], want[med], rtol=2.4e-7, atol=0)
    r = float(ref["r_vol"])
    assert got[med].min() < r < got[med].max()


@pytest.mark.parametrize("knn", [False, True])
def test_primal_bre_gather_matches_jax(stages, knn):
    """estimators.bre_gather on identical inputs; with knn the per-photon
    radii are the JAX package's own, fed to both."""
    js, scene, ref, port = stages
    jgrid, grid = _grids(js, scene, ref, port)
    ph_j = {k: jnp.asarray(v) for k, v in ref["photons"].items()}
    cbd = {k: jnp.asarray(ref["cb"][k])
           for k in ("valid", "o", "d", "length", "med", "thr")}
    cbd["pixel"] = jnp.asarray(np.arange(ref["cb"]["o"].shape[0]))
    pr = None
    if knn:
        pr = jest.knn_radii(jgrid, ph_j["p"], ph_j["vtype"] == 2,
                            ref["r_vol"], K_NN)
    want, want_pix = jax.jit(jest.bre_gather, static_argnames=(
        "n_emitted", "max_per_cell"))(js, cbd, jgrid, ph_j["p"], ph_j,
                                      N_PHOTONS, ref["r_vol"],
                                      max_per_cell=32, pr=pr)
    cb = {k: t(np.asarray(v)) for k, v in cbd.items()}
    got, pix = estimators.bre_gather(
        scene, cb, grid, port["photons"]["p"], port["photons"], N_PHOTONS,
        t(ref["r_vol"]), max_per_cell=32,
        pr=None if pr is None else t(np.asarray(pr)))
    np.testing.assert_array_equal(pix.numpy(), np.asarray(want_pix))
    got, want = got.numpy(), np.asarray(want)
    assert np.isfinite(got).all() and (want > 0).sum() > 20
    np.testing.assert_allclose(got, want, **TOL)


def test_gradient_bre_gather_matches_jax(stages):
    js, scene, ref, port = stages
    ph_j = {k: jnp.asarray(v) for k, v in ref["photons"].items()}
    r_vol = ref["r_vol"]

    @jax.jit
    def jax_side(cb, scb, border_lane):
        packed = jgg.pack_photons(js, ph_j, valid=ph_j["vtype"] != 0)
        grid, rows = jhg.build_sorted(ph_j["p"], ph_j["vtype"] == 2,
                                      js.medium_lo, 2.0 * r_vol, packed,
                                      hash_size=HASH, max_rows=1024)
        return jgg.bre_gather(js, cb, scb, grid, rows, N_PHOTONS, r_vol,
                              border_lane, max_per_cell=32)

    want = [np.asarray(a) for a in jax_side(
        ref["cb"], ref["scb"], ref["border_lane"])]
    ph = port["photons"]
    packed = gradient_gather.pack_photons(scene, ph,
                                          valid=ph["vtype"] != 0)
    grid, rows = hashgrid.build_sorted(ph["p"], ph["vtype"] == 2,
                                       scene.medium_lo, 2.0 * t(r_vol),
                                       dict(rows=packed), hash_size=HASH,
                                       max_rows=1024)
    got = gradient_gather.bre_gather(
        scene, port["cb"], port["scb"], grid, rows["rows"], N_PHOTONS,
        t(r_vol), t(ref["border_lane"]), max_per_cell=32)
    np.testing.assert_array_equal(got[3].numpy(), want[3])      # visits
    np.testing.assert_array_equal(got[4].numpy(), want[4])      # shift_ok
    assert want[3].sum() > 50 and want[4].sum() > 50
    for g, w, name in zip(got[:3], want[:3], ("primal", "S", "W")):
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **TOL)


# the whole pass: the JAX package's hash-grid surface driver at a budget
# (2 x 400 rows) no stencil exceeds and with no row cap (a cap keeps
# other photons of a hash grid than of the port's cell grid), so that it
# visits exactly the pairs of the port's exact runs; ME off (the ME
# stages' own tests hold them)
PASS_KW = dict(CFG_KW, grid_max_photons_per_cell=400, grid_hash_size=HASH,
               grid_surface_rows=0, grid_volume_rows=0)


def test_gvpm_bre_pass_matches_jax():
    js = jax_scene()
    jcfg = JaxGradientConfig(gather_driver="dense", **PASS_KW)
    ref = jgvpm.render_pass(js, jcfg, "bre", N_PHOTONS, SEED, IT, 1.0, 0.9,
                            jsppm.base_volume_radius(js, jcfg))
    scene = port_scene_from_jax(js)
    cfg = GradientConfig(**PASS_KW)
    timings = {}
    got = gvpm.render_pass(scene, cfg, "bre", N_PHOTONS, SEED, IT, 1.0,
                           0.9, sppm.base_volume_radius(scene, cfg),
                           timings=timings)
    for k, name in enumerate(("primal", "gx", "gy")):
        g = got[k].numpy()
        assert g.shape == (SIDE, SIDE, 3) and np.isfinite(g).all(), name
        np.testing.assert_allclose(g, np.asarray(ref[k]), err_msg=name,
                                   **TOL)
    for name in ("visits", "shift_ok"):
        assert int(got[3][name]) == int(ref[3][name]), name
    assert int(got[3]["visits"]) > 100
    assert {"volume_grid", "volume_gather"} <= set(timings)


def test_gvpm_bre_renders_with_defaults_and_camera_sphere():
    """The default use_manifold=True pass (K2-ME on the surface) and the
    camera-sphere cull: finite images, the cull keeps fewer visits; the
    gradient beams and planes render with the camera-sphere cull, with
    use_manifold=True (their ME shifts, ported since ROADMAP item 14c:
    they no longer raise) and False, the same visits either way."""
    scene = port_scene_from_jax(jax_scene())
    cfg = GradientConfig(**dict(CFG_KW, use_manifold=True))
    r = sppm.base_volume_radius(scene, cfg)
    full = gvpm.render_pass(scene, cfg, "bre", N_PHOTONS, SEED, IT, 1.0,
                            1.0, r)
    cull = gvpm.render_pass(
        scene, GradientConfig(**dict(CFG_KW, use_manifold=True,
                                     camera_sphere=1.5)),
        "bre", N_PHOTONS, SEED, IT, 1.0, 1.0, r)
    for out in (full, cull):
        assert all(bool(torch.isfinite(a).all()) for a in out[:3])
    assert 0 < int(cull[3]["visits"]) < int(full[3]["visits"])
    no_me = GradientConfig(**dict(CFG_KW, use_manifold=False,
                                  camera_sphere=1.5))
    me = dataclasses.replace(no_me, use_manifold=True)
    for volume in ("beam1d", "beam3d", "plane0d"):
        with_me = gvpm.render_pass(scene, me, volume, N_PHOTONS, SEED, IT,
                                   1.0, 1.0, r)
        out = gvpm.render_pass(scene, no_me, volume, N_PHOTONS, SEED, IT,
                               1.0, 1.0, r)
        for o in (with_me, out):
            assert all(bool(torch.isfinite(a).all()) for a in o[:3]), volume
        assert int(out[3]["visits"]) > 0, volume
        assert int(with_me[3]["visits"]) == int(out[3]["visits"]), volume
