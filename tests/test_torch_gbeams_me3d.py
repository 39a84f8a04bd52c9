"""The port's gradient beam3d gather with manifold (ME) shifts against
gvpm_tpu's, as tests/test_torch_gbeams_me.py holds beam1d's (same
inputs, chunks, budget and bar). Its ME stage runs once a chunk and
distance sample (2 samples), each with its own budget, on the chord
point the sweep kept."""

import pytest

from tests.test_torch_common import torch_threads  # noqa: F401
from tests.test_torch_gbeams_me import (check_me_gather, check_me_pairs,
                                        me_gather_case)


@pytest.fixture(scope="module")
def case():
    return me_gather_case("gbeam3d")


def test_me_gather_matches_jax(case):
    """The ME pairs' segments are held at rtol 1e-2 (measured: 2.5e-3 at
    most): the new beam's chord in the offset kernel sphere, 2 sqrt(r^2 -
    d^2) near a grazing beam, turns the two packages' beam shifts (new
    directions within ~1e-5, parameters within 3e-6) into chord lengths
    and MIS weights that differ by up to that much. One ME lane flips
    (measured: 1 of the 236 ME shift lanes): a grazing beam whose
    parameter t lies 1.9e-5 before its chord's start in the JAX package
    and 2.2e-5 after it here (ROADMAP section 3)."""
    ref, ref_pairs, got, _ = case
    assert check_me_gather(ref, got, ref_pairs, flips_allowed=True,
                           me_rtol=1e-2) <= 1


def test_me_gather_takes_the_same_pairs(case):
    _, ref_pairs, got, got_pairs = case
    check_me_pairs(ref_pairs, got_pairs, got)
