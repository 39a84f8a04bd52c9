"""A whole 16^2 G-VPM pass of the port with the gradient beam3d volume
against the JAX package's (as tests/test_torch_gbeams_pass.py does for
beam1d). Its random stream follows the JAX package's hosted schedule:
one segment chunk at this size, drawn with fold_in(key, 0).

Bar: visits, shift_ok and the drop counters equal; primal, gx and gy at
rtol 2e-4 / atol 5e-6."""

from tests.test_torch_common import (torch_threads,  # noqa: F401
                                     JAX_CFG, TORCH_CFG, assert_pass_matches,
                                     jax_scene, render_pass_pair)


def test_gradient_beam3d_pass_matches_jax():
    ref, got = render_pass_pair(jax_scene(), JAX_CFG, TORCH_CFG, "beam3d")
    assert_pass_matches(ref, got, rtol=2e-4, atol=5e-6)
    assert int(got[3]["shift_ok"]) > 100
