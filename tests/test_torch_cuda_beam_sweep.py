"""The beam/plane sweep CUDA kernel on the card: built from
gvpm_tpu_torch/csrc, launched by the wrapper for CUDA tensors (never the
plain version; one launch per sweep), and equal to the plain version on
the sweep inputs of one small SPPM pass of each beam estimator: the
accepted-pair counts exactly, the sums at rtol 2e-4 / atol 5e-6, two
launches bitwise equal (no atomics).

Needs a CUDA card and skips without one. It imports no JAX, so it runs
on a machine without it:

    python -m pytest --noconftest -o addopts="" -m gpu \\
        tests/test_torch_cuda_beam_sweep.py
"""

import pytest
import torch

from chip_smoke import beams_against_plain, capture_sweeps
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
