"""The ME instantiations of the gradient beam / plane functors
(gvpm_tpu_torch/csrc/beam_eval.cuh: GBeam1DME, GBeam3DME, GPlane0DME),
compiled as host C++ with g++ and driven from ctypes, against the plain
PyTorch version of ops/beam_sweep.py (gsweep_plain with the _me kinds)
on the sweep inputs of one 16x16 gvpm pass of each beam volume with
manifold shifts (tests/test_torch_common.py's BEAM_ME_KW in box_medium,
where beams leave the mirror sphere) and on chip_smoke.
gsweep_stress_inputs. The host loops run the functors' test / base /
shift parts (test_torch_common.QUEUED_HOST_CPP) each query against
every beam in order, its ME key starting at ME_NONE (the plain order),
and in csrc/gsweep.cu's order, where the key is a min over a query's
runs and splits and gbeam3d_me's chord point is recomputed from the
final key (the card's key_points).

Bar: visits, shift_ok, the ME key (the lowest packed index of an
ME-eligible accepted beam), the ME pair count and gbeam3d_me's chord
point bit-equal; sums at rtol 2e-4 / atol 5e-6 (the order of the sums
and the rounding of expf differ)."""

import pytest
import torch

from chip_smoke import gsweep_stress_inputs
from gvpm_tpu_torch import scenes
from gvpm_tpu_torch.integrators import gvpm, sppm
from gvpm_tpu_torch.ops import beam_sweep as bs
from tests.test_torch_common import (torch_threads,  # noqa: F401
                                     BEAM_ME_TORCH_CFG, IT, N_PHOTONS,
                                     QUEUED_HOST_CPP, SEED, SIDE,
                                     build_host_library, gsweep_source_shape,
                                     host_queued_sweep, queued_against_plain)

VOLUMES = dict(gbeam1d_me="beam1d", gbeam3d_me="beam3d",
               gplane0d_me="plane0d")

@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return build_host_library(tmp_path_factory, QUEUED_HOST_CPP)


@pytest.fixture(scope="module")
def gsweep_inputs():
    """The first ME sweep call of one port gvpm pass of each beam volume
    (its first segment chunk; beam3d's first distance sample), by kind."""
    scene = scenes.box_medium(SIDE, SIDE, device="cpu")
    calls = {}
    orig = bs.gsweep

    def record(kind, *args):
        calls.setdefault(kind, args)
        return orig(kind, *args)

    bs.gsweep = record
    try:
        for volume in VOLUMES.values():
            gvpm.render_pass(scene, BEAM_ME_TORCH_CFG, volume, N_PHOTONS,
                             SEED, IT, 1.0, 1.0,
                             sppm.base_volume_radius(scene,
                                                     BEAM_ME_TORCH_CFG))
    finally:
        bs.gsweep = orig
    return calls


@pytest.mark.parametrize("kind", bs.GKINDS_ME)
def test_host_compiled_me_functors_match_plain(host_lib, gsweep_inputs,
                                               kind):
    q, qx, rows, tails, p = gsweep_inputs[kind]
    assert q.shape[0] > 0 and rows.shape[0] > 0 and kind in bs.QUEUED
    # test / base / shift, in the plain order
    got, _ = host_queued_sweep(host_lib, kind, gsweep_inputs[kind], batch=0)
    want = bs.gsweep_plain(kind, q, qx, rows, tails, p)
    assert len(got) == len(want) == 8
    assert int(want[3].sum()) > 50 and int(want[4].sum()) > 50
    me_queries = int((want[5] != bs.ME_NONE).sum())
    assert me_queries > 0 and int(want[6].sum()) > me_queries
    for k, name in ((3, "visits"), (4, "shift_ok"), (5, "ME key"),
                    (6, "ME pairs")):
        assert torch.equal(got[k], want[k]), name
    if kind == "gbeam3d_me":
        assert torch.equal(got[7].view(torch.int32),
                           want[7].view(torch.int32)), "chord point"
        assert bool((want[7][want[5] != bs.ME_NONE] != 0).any(dim=1).all())
    else:
        assert got[7] is None and want[7] is None
    for g, w, name in zip(got[:3], want[:3], ("primal", "S", "W")):
        torch.testing.assert_close(g, w, rtol=2e-4, atol=5e-6, msg=name)


@pytest.mark.parametrize("batch", (32, 8))
@pytest.mark.parametrize("kind", bs.GKINDS_ME)
def test_queued_me_order_matches_plain(host_lib, gsweep_inputs, kind,
                                       batch):
    want = queued_against_plain(host_lib, kind, gsweep_inputs[kind], batch)
    assert int((want[5] != bs.ME_NONE).sum()) > 0


@pytest.mark.parametrize("batch", (32, 8))
@pytest.mark.parametrize("kind", bs.GKINDS_ME)
def test_queued_me_order_on_stress_input(host_lib, kind, batch):
    """The stress input with ME-eligible beams among reconnectable and
    identity ones, some of them the hot query's (gbeam3d_me: its key on
    a grazing beam, its chord point held bit for bit)."""
    *args, hot = gsweep_stress_inputs(kind)
    want = queued_against_plain(host_lib, kind, args, batch)
    elig = args[3][:, bs.TSLOT["reconnectable"]] < -0.5
    n_key = int((want[5] != bs.ME_NONE).sum())
    assert int(want[3][hot]) >= 800 > 3 * gsweep_source_shape()["tile_b"]
    assert int(want[5][hot]) != bs.ME_NONE and bool(elig[int(want[5][hot])])
    assert n_key > (10 if kind == "gbeam3d_me" else 50)
    assert int(want[6].sum()) > n_key
    if kind == "gbeam3d_me":
        assert bool((want[7][want[5] != bs.ME_NONE] != 0).any(dim=1).all())
        assert bool((want[7][want[5] == bs.ME_NONE] == 0).all())


@pytest.mark.parametrize("kind", bs.GKINDS_ME)
def test_plain_me_sweep_in_blocks(gsweep_inputs, kind, monkeypatch):
    """The plain version's ME outputs do not depend on its blocking: with
    blocks of 256 beams and 64 queries (as on the card, where the pairs
    of a 128^2 pass need dozens of blocks) the keys, counts and chord
    points are those of one block, the sums within rounding."""
    args = gsweep_inputs[kind]
    one = bs.gsweep_plain(kind, *args)
    monkeypatch.setattr(bs, "PLAIN_MAX_PAIRS", 1 << 14)
    blocks = bs.gsweep_plain(kind, *args)
    assert args[2].shape[0] > 4 * 256 and args[0].shape[0] > 2 * 64
    for k in (3, 4, 5, 6):
        assert torch.equal(blocks[k], one[k]), k
    if kind == "gbeam3d_me":
        assert torch.equal(blocks[7], one[7])
        assert bool((one[7] != 0).any())
    for k in range(3):
        torch.testing.assert_close(blocks[k], one[k], rtol=1e-6, atol=1e-9)


def test_me_sweep_without_eligible_beams_is_the_sweep(gsweep_inputs):
    """An ME sweep whose tails mark no beam returns the ME-off sweep's
    outputs bit for bit, no key and no ME pair; with the marks, the
    marked beams' pairs lose their identity shifts only."""
    q, qx, rows, tails, p = gsweep_inputs["gbeam1d_me"]
    marked = tails[:, bs.TSLOT["reconnectable"]] < -0.5
    assert bool(marked.any())
    plain = tails.clone()
    plain[marked, bs.TSLOT["reconnectable"]] = 0.0
    off = bs.gsweep("gbeam1d", q, qx, rows, plain, p)
    me = bs.gsweep("gbeam1d_me", q, qx, rows, plain, p)
    for a, b in zip(off, me[:5]):
        assert torch.equal(a, b)
    assert bool((me[5] == bs.ME_NONE).all()) and int(me[6].sum()) == 0
    marked_sweep = bs.gsweep("gbeam1d_me", q, qx, rows, tails, p)
    assert torch.equal(marked_sweep[0], off[0])          # the base terms
    assert torch.equal(marked_sweep[3], off[3])          # visits
    assert torch.equal(marked_sweep[4], off[4])          # reconnections


def test_cpu_tensors_take_the_me_plain_version(gsweep_inputs):
    q, qx, rows, tails, p = gsweep_inputs["gplane0d_me"]
    before = dict(bs.LAUNCHES)
    got = bs.gsweep("gplane0d_me", q, qx, rows, tails, p)
    assert bs.LAUNCHES == before
    want = bs.gsweep_plain("gplane0d_me", q, qx, rows, tails, p)
    assert all(torch.equal(g, w) for g, w in zip(got[:7], want[:7]))
    with pytest.raises(ValueError, match="CUDA"):
        bs.launch_kernel("gplane0d_me", q, rows, p, qx=qx, tails=tails)
