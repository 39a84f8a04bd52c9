"""The port's G-VPM distance pass as a whole against gvpm_tpu's (fused
Pallas driver, interpret mode on the CPU), the screened-Poisson solve,
progressive rendering with checkpoint/resume, and float32 throughout.

Bar for the pass: the strict one. Both sides draw the same random
numbers (bit-exact threefry), and on this config every ball test and
shift-validity test decides alike, so visits and shift_ok are equal and
every pixel of primal, gx and gy agrees at the reference kernel test's
rtol 2e-4 / atol 5e-6 (tests/test_pallas_gather.py)."""

import numpy as np
import pytest
import torch

from gvpm_tpu.integrators import gvpm as jgvpm
from gvpm_tpu.integrators import sppm as jsppm
from gvpm_tpu.ops import poisson as jpoisson
from gvpm_tpu_torch.integrators import gvpm, sppm
from gvpm_tpu_torch.ops import poisson
from tests.test_torch_common import (torch_threads,  # noqa: F401
                                     IT, JAX_CFG, N_PHOTONS, SEED,
                                     TORCH_CFG, jax_scene,
                                     port_scene_from_jax)


@pytest.fixture(scope="module")
def passes():
    js = jax_scene()
    ref = jgvpm.render_pass(js, JAX_CFG, "distance", N_PHOTONS, SEED, IT,
                            1.0, 1.0, jsppm.base_volume_radius(js, JAX_CFG))
    scene = port_scene_from_jax(js)
    got = gvpm.render_pass(scene, TORCH_CFG, "distance", N_PHOTONS, SEED,
                           IT, 1.0, 1.0,
                           sppm.base_volume_radius(scene, TORCH_CFG))
    return scene, ref, got


def test_pass_images_match_jax(passes):
    _, ref, got = passes
    for k, name in enumerate(("primal", "gx", "gy")):
        g = got[k].numpy()
        assert g.shape == (16, 16, 3) and np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(ref[k]), rtol=2e-4,
                                   atol=5e-6, err_msg=name)


def test_pass_counts_match_jax(passes):
    _, ref, got = passes
    assert int(got[3]["visits"]) == int(ref[3]["visits"]) > 0
    assert int(got[3]["shift_ok"]) == int(ref[3]["shift_ok"])
    assert int(got[3]["win_dropped"]) == 0


def test_poisson_solve_l2_matches_jax(passes):
    _, ref, _ = passes
    p, gx, gy = (np.asarray(a) for a in ref[:3])
    want = np.asarray(jpoisson.solve(p, gx, gy, l1=False))
    got = poisson.solve(*(torch.tensor(a) for a in (p, gx, gy)),
                        l1=False).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_poisson_solve_l1_as_close_as_jax_to_float64(passes):
    """The L1 preset (IRLS weights 1/(|r|+1e-4) around 50 float32 CG
    steps) amplifies reduction-order rounding, so JAX's and the port's
    float32 solves differ by more than rtol 1e-4 (ROADMAP section 3).
    The bar: the port is no farther from a float64 solve of the same
    problem than twice the JAX solve is, and the image means agree to
    1% (they differ by ~1e-3 on this input)."""
    _, ref, _ = passes
    p, gx, gy = (np.asarray(a) for a in ref[:3])
    want = np.asarray(jpoisson.solve(p, gx, gy))
    got = poisson.solve(*(torch.tensor(a) for a in (p, gx, gy))).numpy()
    exact = poisson.solve(*(torch.tensor(a).double()
                            for a in (p, gx, gy))).numpy()
    err_ref = np.abs(want - exact).max()
    assert np.abs(got - exact).max() <= 2.0 * err_ref + 1e-5
    np.testing.assert_allclose(got.mean(), want.mean(), rtol=1e-2)


def test_render_with_checkpoint_resume(passes, tmp_path):
    scene = passes[0]
    full = gvpm.render(scene, TORCH_CFG, seed=3, passes=2)
    ck = str(tmp_path / "ck.npz")
    gvpm.render(scene, TORCH_CFG, seed=3, passes=1, checkpoint_path=ck)
    # resume: pass 0 comes from the checkpoint, pass 1 is rendered
    seen = []
    resumed = gvpm.render(scene, TORCH_CFG, seed=3, passes=2,
                          checkpoint_path=ck,
                          callback=lambda it, img, st: seen.append(it))
    assert seen == [1]
    for k in ("image", "primal", "gx", "gy"):
        assert torch.isfinite(full[k]).all(), k
        torch.testing.assert_close(resumed[k], full[k], rtol=0, atol=0)
    rel = abs(float(full["image"].mean()) / float(full["primal"].mean()) - 1)
    assert rel < 0.25


def test_everything_is_float32(passes):
    scene, _, got = passes
    from gvpm_tpu_torch.core import rng
    photons = sppm.shoot_photons(scene, TORCH_CFG, N_PHOTONS,
                                 rng.pass_key(SEED, IT, rng.STREAM_LIGHT))
    tensors = list(scene.tensors().items()) + list(photons.items()) \
        + [(f"out{i}", a) for i, a in enumerate(got[:3])]
    for name, v in tensors:
        assert not v.is_floating_point() or v.dtype == torch.float32, name
