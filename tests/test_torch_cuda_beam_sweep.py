"""The beam/plane sweep CUDA kernel on the card (beam1d, beam3d and
plane0d on csrc/gsweep.cu's queued sweep): built from
gvpm_tpu_torch/csrc, launched by the wrapper for CUDA tensors (never the
plain version; one launch per sweep), and equal to the plain version on
the sweep inputs of one small SPPM pass of each beam estimator, and on
chip_smoke.beam_stress_inputs (beam1d's also moved by
chip_smoke.BEAM1D_FAR_SHIFTS, its pre-test's guard just held and
exceeded) at the split plan and in one split: the accepted-pair counts
exactly, the sums at rtol 2e-4 / atol 5e-6, two launches bitwise equal
(no atomics).

Needs a CUDA card and skips without one. It imports no JAX, so it runs
on a machine without it:

    python -m pytest --noconftest -o addopts="" -m gpu \\
        tests/test_torch_cuda_beam_sweep.py
"""

import pytest
import torch

from chip_smoke import (BEAM1D_FAR_SHIFTS, beams_against_plain,
                         beams_stress_against_plain, capture_sweeps)
from gvpm_tpu_torch import scenes
from gvpm_tpu_torch.core.config import PhotonConfig
from gvpm_tpu_torch.integrators import sppm
from gvpm_tpu_torch.ops import beam_sweep as bs

pytestmark = pytest.mark.gpu

CFG = PhotonConfig(max_depth=6, null_bounces=2, max_cam_depth=4,
                   surface_photons=1 << 12, volume_photons=1 << 12,
                   grid_hash_size=1 << 12)


@pytest.fixture(scope="module")
def captured():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    bs.build()
    scene = scenes.box_medium(32, 32)     # the default device: the card
    before = dict(bs.LAUNCHES)
    calls = capture_sweeps(scene, CFG, dict(
        n_photons=1 << 12, seed=0, it=0, surf_scale=1.0, vol_scale=1.0,
        r_vol_base=sppm.base_volume_radius(scene, CFG)))
    torch.cuda.synchronize()
    return calls, {k: bs.LAUNCHES[k] - before[k] for k in before}


def test_each_pass_launches_its_kernel(captured):
    _, launched = captured
    assert launched == dict(dict.fromkeys(bs.LAUNCHES, 0), beam1d=1,
                            beam3d=CFG.volume_samples, plane0d=1)


@pytest.mark.parametrize("kind", bs.KINDS)
def test_kernel_matches_plain(captured, kind):
    calls, _ = captured
    q, rows, p = calls[kind]
    assert q.is_cuda and rows.is_cuda
    _, counts, _, _ = beams_against_plain(kind, q, rows, p)
    assert int(counts.sum()) > 0


@pytest.mark.parametrize("kind, shift", [
    pytest.param(kind, 0.0, id=kind) for kind in bs.KINDS]
    + [pytest.param("beam1d", s, id=f"beam1d-moved-{s:g}")
       for s in BEAM1D_FAR_SHIFTS])
def test_queued_kernel_on_stress_input(captured, kind, shift):
    want, counts, stats, hot, _ = beams_stress_against_plain(kind, shift)
    assert int(counts[hot]) >= 800
    assert stats["pretest"] > int(counts.sum())
