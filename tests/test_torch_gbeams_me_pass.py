"""A whole 16^2 G-VPM pass of the port with the gradient beam1d volume
and manifold (ME) shifts — the default use_manifold=True — against the
JAX package's gvpm.render_pass (its default hosted beam dispatch), in
box_medium with tests/test_torch_common.py's BEAM_ME_KW: beams leave the
mirror sphere inside the fog, the pair budget (16) is below the eligible
queries of the surface gather and of each of the three segment chunks
(200 of 512 segments). beam3d's and plane0d's ME gathers are held in
test_torch_gbeams_me3d.py / _me0d.py.

Bar: visits, shift_ok, win_dropped and me_dropped equal; primal, gx and
gy at rtol 2e-4 / atol 5e-6."""

import pytest
import torch

from tests.test_torch_common import (torch_threads,  # noqa: F401
                                     BEAM_ME_JAX_CFG, BEAM_ME_TORCH_CFG, IT,
                                     N_PHOTONS, SEED, assert_pass_matches,
                                     jax_scene, port_scene_from_jax,
                                     render_pass_pair)


@pytest.fixture(scope="module")
def passes():
    return render_pass_pair(jax_scene(), BEAM_ME_JAX_CFG, BEAM_ME_TORCH_CFG,
                            "beam1d")


def test_beam1d_me_pass_matches_jax(passes):
    assert_pass_matches(*passes, rtol=2e-4, atol=5e-6)


def test_beam1d_me_pass_takes_and_drops_pairs(passes):
    _, got = passes
    budget = BEAM_ME_TORCH_CFG.me_pair_budget
    # the surface gather's budget, and some pairs of the beam chunks
    assert int(got[3]["me_pairs"]) > budget
    assert int(got[3]["me_dropped"]) > 0


def test_beam1d_me_pass_timings_split_the_me_stage(passes):
    """With a `timings` dict the pass returns the same images, and the
    beam ME stage is the volume_me phase with its "me:" parts."""
    from gvpm_tpu_torch.integrators import gvpm, sppm
    scene = port_scene_from_jax(jax_scene())
    timings = {}
    timed = gvpm.render_pass(
        scene, BEAM_ME_TORCH_CFG, "beam1d", N_PHOTONS, SEED, IT, 1.0, 1.0,
        sppm.base_volume_radius(scene, BEAM_ME_TORCH_CFG), timings=timings)
    for a, b in zip(timed[:3], passes[1][:3]):
        assert torch.equal(a, b)
    assert {"me:compact", "me:chains", "me:newton", "me:ratios",
            "me:occlusion"} <= set(timings)
    assert {"surface_gather", "surface_me", "volume_gather",
            "volume_me"} <= set(timings)
