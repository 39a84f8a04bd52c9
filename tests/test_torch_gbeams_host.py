"""The gradient beam / plane functors of the sweep kernel
(gvpm_tpu_torch/csrc/beam_eval.cuh: GBeam1D, GBeam3D, GPlane0D),
compiled as host C++ with g++ and driven from ctypes, against the plain
PyTorch version of ops/beam_sweep.py (gsweep_plain) on the sweep inputs
of one 16x16 gvpm pass of each beam volume (tests/test_torch_common.py's
config, use_manifold=False) and on chip_smoke.gsweep_stress_inputs. The
host loops run the functors' test / base / shift parts in two orders
(test_torch_common.QUEUED_HOST_CPP): each query against every beam in
order (the plain order), and csrc/gsweep.cu's (tiles, a ring per warp,
batches of 32 pairs or of 8 pairs x 4 offsets). This is the only way
the CUDA source's gradient math runs before it reaches the card.
Bar: visits and shift_ok exactly equal; sums at rtol 2e-4 / atol 5e-6
(the order of the sums and the rounding of expf differ)."""

import pytest
import torch

from chip_smoke import gsweep_stats, gsweep_stress_inputs
from gvpm_tpu_torch import scenes
from gvpm_tpu_torch.integrators import gvpm, sppm
from gvpm_tpu_torch.ops import beam_sweep as bs
from tests.test_torch_common import (torch_threads,  # noqa: F401
                                     IT, N_PHOTONS, QUEUED_HOST_CPP, SEED,
                                     SIDE, TORCH_CFG, build_host_library,
                                     gsweep_source_shape, host_queued_sweep,
                                     queued_against_plain)

VOLUMES = dict(gbeam1d="beam1d", gbeam3d="beam3d", gplane0d="plane0d")

@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return build_host_library(tmp_path_factory, QUEUED_HOST_CPP)


@pytest.fixture(scope="module")
def gsweep_inputs():
    """The first gradient sweep call of one port gvpm pass of each beam
    volume (beam3d: its first chunk and distance sample), by kind."""
    scene = scenes.box_medium(SIDE, SIDE, device="cpu")
    calls = {}
    orig = bs.gsweep

    def record(kind, *args):
        calls.setdefault(kind, args)
        return orig(kind, *args)

    bs.gsweep = record
    try:
        for volume in VOLUMES.values():
            gvpm.render_pass(scene, TORCH_CFG, volume, N_PHOTONS, SEED, IT,
                             1.0, 1.0,
                             sppm.base_volume_radius(scene, TORCH_CFG))
    finally:
        bs.gsweep = orig
    return calls


@pytest.mark.parametrize("kind", bs.GKINDS)
def test_host_compiled_gradient_math_matches_plain(host_lib, gsweep_inputs,
                                                   kind):
    q, qx, rows, tails, p = gsweep_inputs[kind]
    M, N = q.shape[0], rows.shape[0]
    for a, w in ((q, bs.QW), (qx, bs.XW), (rows, bs.BW), (tails, bs.TW)):
        assert a.is_contiguous() and a.shape[1] == w
    assert M > 0 and N > 0 and kind in bs.QUEUED
    # test / base / shift, in the plain order
    got, _ = host_queued_sweep(host_lib, kind, gsweep_inputs[kind], batch=0)
    want = bs.gsweep_plain(kind, q, qx, rows, tails, p)
    assert int(want[3].sum()) > 50 and int(want[4].sum()) > 50
    assert torch.equal(got[3], want[3]), "visits"
    assert torch.equal(got[4], want[4]), "shift_ok"
    for g, w, name in zip(got[:3], want[:3], ("primal", "S", "W")):
        torch.testing.assert_close(g, w, rtol=2e-4, atol=5e-6, msg=name)


@pytest.mark.parametrize("batch", (32, 8))
@pytest.mark.parametrize("kind", bs.GKINDS)
def test_queued_order_matches_plain(host_lib, gsweep_inputs, kind, batch):
    want = queued_against_plain(host_lib, kind, gsweep_inputs[kind], batch)
    assert int(want[3].sum()) > 50 and int(want[4].sum()) > 50


@pytest.mark.parametrize("batch", (32, 8))
@pytest.mark.parametrize("kind", bs.GKINDS)
def test_queued_order_on_stress_input(host_lib, kind, batch):
    """A query accepting every beam of six tiles, whose pairs wrap the
    ring many times, ragged query and beam counts, invalid queries, a
    medium mismatch, reconnectable and identity beams; gbeam3d's grazing
    beams give queued pairs that base rejects."""
    *args, hot = gsweep_stress_inputs(kind)
    want = queued_against_plain(host_lib, kind, args, batch)
    assert int(want[3][hot]) >= 800 > 3 * gsweep_source_shape()["tile_b"]
    q, rows = args[0], args[2]
    assert q.shape[0] % gsweep_source_shape()["tq"] != 0
    assert rows.shape[0] % gsweep_source_shape()["tile_b"] != 0
    assert int(want[3][q[:, bs.QSLOT["valid"]] < 0.5].sum()) == 0
    assert int(want[4].sum()) > (500 if kind == "gbeam3d" else 1000)
    if kind == "gbeam3d":
        st = gsweep_stats(kind, q, rows, args[3], args[4])
        assert st["stage2"] > st["accepted"] == int(want[3].sum())


def test_cpu_tensors_take_the_gradient_plain_version(gsweep_inputs):
    q, qx, rows, tails, p = gsweep_inputs["gbeam1d"]
    before = dict(bs.LAUNCHES)
    got = bs.gsweep("gbeam1d", q, qx, rows, tails, p)
    assert bs.LAUNCHES == before
    want = bs.gsweep_plain("gbeam1d", q, qx, rows, tails, p)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="CUDA"):
        bs.launch_kernel("gbeam1d", q, rows, p, qx=qx, tails=tails)
    with pytest.raises(ValueError, match="gradient pair function"):
        bs.gsweep("beam1d", q, qx, rows, tails, p)
