"""One whole G-VPM distance pass with manifold (ME) shifts — the JAX
package's default use_manifold=True — of the port against gvpm_tpu's
(fused Pallas gather, interpret mode on the CPU), in the mirror-wall box
of tests/test_manifold.py at 16x16 with a pair budget (16) below the
eligible query counts.

Bar: visits, shift_ok, win_dropped and me_dropped equal (no ME lane
flips on this input); primal, gx and gy at rtol 1e-3 / atol 5e-6 (the
ME gathers' bar: the Newton-solved ratios agree to ~1e-6, the kernel
sums to the no-ME bar of 2e-4)."""

import pytest

from tests.test_torch_common import (torch_threads,  # noqa: F401
                                     ME_JAX_CFG, ME_TORCH_CFG,
                                     assert_pass_matches, jax_mirror_scene,
                                     render_pass_pair)


@pytest.fixture(scope="module")
def passes():
    return render_pass_pair(jax_mirror_scene(), ME_JAX_CFG, ME_TORCH_CFG)


def test_me_pass_matches_jax(passes):
    assert_pass_matches(*passes, rtol=1e-3, atol=5e-6)


def test_me_pass_takes_and_drops_pairs(passes):
    _, got = passes
    # 1 surface + 1 volume gather, each at its budget
    assert int(got[3]["me_pairs"]) == 2 * ME_TORCH_CFG.me_pair_budget
    assert int(got[3]["me_dropped"]) > 0


def test_me_pass_timings_split_the_me_stages(passes):
    """With a `timings` dict the pass returns the same images, the ME
    stages are phases of their own and their parts are listed under
    "me:" keys that the two phases include."""
    import torch

    from gvpm_tpu_torch.integrators import gvpm, sppm
    from tests.test_torch_common import (IT, N_PHOTONS, SEED,
                                         port_scene_from_jax)
    scene = port_scene_from_jax(jax_mirror_scene())
    timings = {}
    timed = gvpm.render_pass(
        scene, ME_TORCH_CFG, "distance", N_PHOTONS, SEED, IT, 1.0, 1.0,
        sppm.base_volume_radius(scene, ME_TORCH_CFG), timings=timings)
    for a, b in zip(timed[:3], passes[1][:3]):
        assert torch.equal(a, b)
    parts = {k: v for k, v in timings.items() if k.startswith("me:")}
    assert set(parts) == {"me:compact", "me:chains", "me:newton",
                          "me:ratios", "me:occlusion"}
    assert {"light_trace", "camera_trace", "surface_gather", "surface_me",
            "volume_gather", "volume_me", "splat"} <= set(timings)
    assert 0.0 < sum(parts.values()) \
        <= timings["surface_me"] + timings["volume_me"]
