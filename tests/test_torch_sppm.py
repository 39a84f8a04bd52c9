"""The port's SPPM primal pass (gvpm_tpu_torch/integrators/sppm.py)
against gvpm_tpu's: one whole 16^2 `distance` pass on
tests/test_torch_common.py's config at the reference kernel test's bar
(rtol 2e-4 / atol 5e-6), the port's entry() against the repo's
__graft_entry__.entry(), and progressive rendering with checkpoint and
resume."""

import dataclasses
import os

import numpy as np
import torch

import __graft_entry__ as graft
from gvpm_tpu.core.config import PhotonConfig as JaxPhotonConfig
from gvpm_tpu.integrators import sppm as jsppm
from gvpm_tpu_torch import entry as port_entry
from gvpm_tpu_torch.core.config import PhotonConfig
from gvpm_tpu_torch.integrators import sppm
from tests.test_torch_common import (torch_threads,  # noqa: F401
                                     IT, N_PHOTONS, SEED, SIDE, SPPM_KW,
                                     jax_scene, port_scene_from_jax)

TOL = dict(rtol=2e-4, atol=5e-6)


# a per-cell budget (2 x 160 rows) that no query's stencil exceeds: the
# strided overflow subsample picks other photons when the surface cell
# (2 x the largest gather radius) moves by one ulp, and the camera
# traces of XLA and PyTorch differ in the last bit of some radii
# (ROADMAP.md section 3); test_torch_estimators.py holds the subsample
# itself on identical inputs
PASS_KW = dict(SPPM_KW, grid_max_photons_per_cell=160)


def test_render_pass_matches_jax():
    js = jax_scene()
    jcfg = JaxPhotonConfig(**PASS_KW)
    ref = np.asarray(jsppm.render_pass(
        js, jcfg, "distance", N_PHOTONS, SEED, IT, 0.9, 0.8,
        jsppm.base_volume_radius(js, jcfg)))
    scene = port_scene_from_jax(js)
    cfg = PhotonConfig(**PASS_KW)
    timings = {}
    got = sppm.render_pass(scene, cfg, "distance", N_PHOTONS, SEED, IT,
                           0.9, 0.8, sppm.base_volume_radius(scene, cfg),
                           timings=timings).numpy()
    assert got.shape == (SIDE, SIDE, 3) and np.isfinite(got).all()
    assert got.mean() > 0
    np.testing.assert_allclose(got, ref, **TOL)
    assert set(timings) == {"light_trace", "camera_trace", "surface_grid",
                            "surface_gather", "volume_grid",
                            "volume_gather", "splat"}


def test_entry_matches_graft_entry(monkeypatch):
    """The port's entry() (a 32^2 tiny scene, 4096 light paths) against
    the JAX package's: the same config, scene tables (each package's own
    builder) and example arguments; the pass at the strict bar with a
    per-cell budget no query's stencil exceeds; and at the entry's own
    budget, where the surface subsample sees the last-bit differences of
    the gather radii (PASS_KW above), a finite image whose mean is within
    2% of the JAX one's (0.53% measured)."""
    jfn, jargs = graft.entry()
    jcfg = dict(zip(jfn.__code__.co_freevars,
                    jfn.__closure__))["cfg"].cell_contents
    fn, args = port_entry.entry(device="cpu")
    for f in dataclasses.fields(port_entry.CFG):
        if f.name == "beams":
            # the JAX package reads `beams` nowhere, so every medium edge
            # is a beam there: the port's 0
            assert port_entry.CFG.beams == 0
            continue
        assert getattr(port_entry.CFG, f.name) == getattr(jcfg, f.name), f
    carried = port_scene_from_jax(jargs[0]).tensors()
    for k, v in args[0].tensors().items():
        assert torch.equal(v, carried[k].to(v.dtype)), k
    assert args[1:5] == jargs[1:5]
    np.testing.assert_allclose(args[5], jargs[5], rtol=1e-6)

    got = fn(*args).numpy()
    ref = np.asarray(jfn(*jargs))
    assert got.shape == ref.shape == (32, 32, 3)
    assert np.isfinite(got).all() and got.mean() > 0
    np.testing.assert_allclose(got.mean(), ref.mean(), rtol=0.02)

    wide = dataclasses.replace(jcfg, grid_max_photons_per_cell=400)
    ref = np.asarray(jsppm.render_pass(jargs[0], wide, "distance", 4096,
                                       *jargs[1:]))
    monkeypatch.setattr(port_entry, "CFG", dataclasses.replace(
        port_entry.CFG, grid_max_photons_per_cell=400))
    np.testing.assert_allclose(fn(*args).numpy(), ref, **TOL)


def test_render_checkpoint_resume(tmp_path):
    """Two passes with a checkpoint after the first, resumed: equal to an
    uninterrupted two-pass render (the radius schedule is restored)."""
    scene = port_scene_from_jax(jax_scene())
    cfg = PhotonConfig(**dict(SPPM_KW, surface_photons=256,
                              volume_photons=256))
    full = sppm.render(scene, cfg, volume="distance", seed=3, passes=2)
    ck = str(tmp_path / "ck.npz")
    sppm.render(scene, cfg, volume="distance", seed=3, passes=1,
                checkpoint_path=ck)
    assert os.path.exists(ck)
    seen = []
    resumed = sppm.render(scene, cfg, volume="distance", seed=3, passes=2,
                          checkpoint_path=ck,
                          callback=lambda it, img: seen.append(it))
    assert seen == [1] and resumed["passes"] == 2
    np.testing.assert_array_equal(resumed["image"].numpy(),
                                  full["image"].numpy())
    none = sppm.render(scene, cfg, volume="none", seed=3, passes=1)
    assert float(none["image"].mean()) < float(full["image"].mean())

