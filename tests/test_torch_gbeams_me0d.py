"""The port's gradient plane0d gather with manifold (ME) shifts against
gvpm_tpu's, as tests/test_torch_gbeams_me.py holds beam1d's (same
inputs, chunks, budget and bar). The plane's chain is solved through the
offset camera point minus the base extension offset."""

import pytest

from tests.test_torch_common import torch_threads  # noqa: F401
from tests.test_torch_gbeams_me import (check_me_gather, check_me_pairs,
                                        me_gather_case)


@pytest.fixture(scope="module")
def case():
    return me_gather_case("gplane0d")


def test_me_gather_matches_jax(case):
    ref, ref_pairs, got, _ = case
    assert check_me_gather(ref, got, ref_pairs) == 0


def test_me_gather_takes_the_same_pairs(case):
    _, ref_pairs, got, got_pairs = case
    check_me_pairs(ref_pairs, got_pairs, got)
