"""One whole G-VPM distance pass in the nullShift debug mode
(shift_null=True: every photon's reconnectable flag is cleared, so every
light shift falls to the unilateral branch) of the port against
gvpm_tpu's, with ME on, in the mirror-wall box at 16x16.

With no reconnectable vertex left, no chain reaches an anchor: every
pair inside a ball whose parent is a delta surface is ME-eligible, is
taken or dropped by the budget, and fails its shift. Bar as for the ME
pass: counters equal, images at rtol 1e-3 / atol 5e-6."""

import dataclasses

import pytest

from tests.test_torch_common import (torch_threads,  # noqa: F401
                                     ME_JAX_CFG, ME_TORCH_CFG,
                                     assert_pass_matches, jax_mirror_scene,
                                     render_pass_pair)


@pytest.fixture(scope="module")
def passes():
    return render_pass_pair(
        jax_mirror_scene(),
        dataclasses.replace(ME_JAX_CFG, shift_null=True),
        dataclasses.replace(ME_TORCH_CFG, shift_null=True))


def test_null_shift_pass_matches_jax(passes):
    assert_pass_matches(*passes, rtol=1e-3, atol=5e-6)


def test_null_shift_pass_has_no_successful_shift(passes):
    _, got = passes
    assert int(got[3]["shift_ok"]) == 0
    assert int(got[3]["me_pairs"]) > 0
