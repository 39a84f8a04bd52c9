"""A whole 16^2 G-VPM pass of the port with the gradient beam1d volume
(gvpm_tpu_torch.integrators.gvpm.render_pass, use_manifold=False)
against the JAX package's gvpm.render_pass with its default hosted beam
dispatch, on tests/test_torch_common.py's config (its fused Pallas
surface driver with a window no run exceeds, so the surface gathers see
the same pairs). beam3d's pass is in test_torch_gbeams_pass3d.py and
plane0d's in test_torch_gbeams_pass0d.py: each file is its own xdist
unit, and each pass's JAX side compiles for over a minute.

Bar: visits, shift_ok and the drop counters equal; primal, gx and gy at
rtol 2e-4 / atol 5e-6."""

from tests.test_torch_common import (torch_threads,  # noqa: F401
                                     JAX_CFG, TORCH_CFG, assert_pass_matches,
                                     jax_scene, render_pass_pair)


def test_gradient_beam1d_pass_matches_jax():
    ref, got = render_pass_pair(jax_scene(), JAX_CFG, TORCH_CFG, "beam1d")
    assert_pass_matches(ref, got, rtol=2e-4, atol=5e-6)
    assert int(got[3]["shift_ok"]) > 100
