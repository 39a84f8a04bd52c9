"""The port's gradient beam1d gather with manifold (ME) shifts
(gvpm_tpu_torch.integrators.gradient_gather.beam_gradient_gather,
use_manifold=True, on the plain version of ops/beam_sweep.py's
gbeam1d_me sweep and the ME stage) against gvpm_tpu's, on the JAX
package's own inputs of one 16^2 gvpm pass in box_medium
(tests/test_torch_common.py's BEAM_ME_KW: beams leave its mirror sphere
inside the fog), converted through interop.

Both sides run the camera segments in chunks of 200 of 512, the JAX
side as its hosted dispatch does (one gather a padded chunk), with a
pair budget of 16 a chunk, below the eligible queries, so the
compaction drops pairs. gbeam3d's and gplane0d's ME gathers are in
test_torch_gbeams_me3d.py and test_torch_gbeams_me0d.py: each file is
its own xdist unit, and each JAX side compiles its Newton solves for a
minute or more.

Bar: visits, shift_ok, me_dropped and the pairs each chunk's ME stage
takes equal; primal, S and W at rtol 2e-4 / atol 5e-6, the reference
kernel test's (tests/test_pallas_gather.py:46-65). `check_me_gather`
can hold the segments of ME pairs at a wider rtol and admit lane flips
of the ME shifts, bounded as tests/test_torch_manifold.py bounds them
(2% of the ME shift lanes; each flip may move shift_ok by one and S / W
of its segment beyond any bar): only gbeam3d needs either (ROADMAP
section 3)."""

import numpy as np
import pytest

from tests.test_torch_common import (torch_threads,  # noqa: F401
                                     BEAM_ME_JAX_CFG, jax_beam_inputs,
                                     jax_beam_me_gather, jax_scene,
                                     port_beam_me_gather, port_scene_from_jax)

KIND = "gbeam1d"
SEG_TILE = BEAM_ME_JAX_CFG.beam_seg_tile
BUDGET = BEAM_ME_JAX_CFG.me_pair_budget
TOL = dict(rtol=2e-4, atol=5e-6)


def me_gather_case(kind):
    js = jax_scene()
    inp = jax_beam_inputs(js, BEAM_ME_JAX_CFG)
    assert inp["cb"]["o"].shape[0] > 2 * SEG_TILE      # three chunks
    ref, ref_pairs = jax_beam_me_gather(kind, js, inp, SEG_TILE, BUDGET)
    got, got_pairs = port_beam_me_gather(kind, port_scene_from_jax(js), inp,
                                         SEG_TILE, BUDGET)
    return ref, ref_pairs, got, got_pairs


MAX_FLIPS = 0.02      # of the ME shift lanes (tests/test_torch_manifold.py)


def check_me_gather(ref, got, ref_pairs, flips_allowed=False,
                    me_rtol=TOL["rtol"]):
    """Counts equal and some ME pairs dropped; sums within TOL, on the
    segments of ME pairs within me_rtol. With flips_allowed, shift_ok
    may differ by up to MAX_FLIPS of the ME shift lanes (4 offsets a pair
    taken), and S / W exceed me_rtol only on as many segments of pairs
    taken. Returns the flips seen."""
    me_seg = np.zeros(ref[0].shape[0], bool)
    me_seg[np.concatenate([p[2] for p in ref_pairs])] = True
    bound = int(MAX_FLIPS * 4 * int(me_seg.sum())) if flips_allowed else 0
    assert int(got[3].sum()) == ref[3] > 50, "visits"
    flips = abs(int(got[4].sum()) - ref[4])
    assert ref[4] > 50 and flips <= bound, ("shift_ok", flips, bound)
    assert int(got[5]) == ref[5] > 0, "me_dropped"
    for g, w, name in zip(got[:3], ref[:3], ("primal", "S", "W")):
        g = g.numpy()
        assert g.shape == w.shape and np.isfinite(g).all(), name

        def off_segments(rtol):
            off = ~np.isclose(g, w, rtol=rtol, atol=TOL["atol"])
            return off.reshape(-1, g.shape[-2], 3).any(axis=(0, 2))
        assert not (off_segments(TOL["rtol"]) & ~me_seg).any(), name
        far = np.nonzero(off_segments(me_rtol))[0]
        assert len(far) <= flips, (name, far, flips)
    return flips


def check_me_pairs(ref_pairs, got_pairs, got):
    """The same (segment, beam) pairs in every chunk (and beam3d
    sample), at most BUDGET each, some taken."""
    ref_pairs = [p[:2] for p in ref_pairs if len(p[0])]
    got_pairs = [p for p in got_pairs if len(p[0])]
    assert len(got_pairs) == len(ref_pairs) > 0
    for (gq, gb), (rq, rb) in zip(got_pairs, ref_pairs):
        assert len(gq) <= BUDGET
        np.testing.assert_array_equal(gq, rq)
        np.testing.assert_array_equal(gb, rb)
    assert int(got[6]) == sum(len(p[0]) for p in got_pairs)


@pytest.fixture(scope="module")
def case():
    return me_gather_case(KIND)


def test_me_gather_matches_jax(case):
    ref, ref_pairs, got, _ = case
    assert check_me_gather(ref, got, ref_pairs) == 0


def test_me_gather_takes_the_same_pairs(case):
    _, ref_pairs, got, got_pairs = case
    check_me_pairs(ref_pairs, got_pairs, got)
