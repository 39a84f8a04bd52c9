"""The gradient beam / plane sweep kernels on the card (beam_sweep.cu's
GBeam1D, GBeam3D, GPlane0D): built from gvpm_tpu_torch/csrc, launched
by the wrapper for CUDA tensors (never the plain version), once per gvpm
pass of beam1d and plane0d and once per segment chunk and distance
sample of beam3d, and equal to the plain version on the sweep inputs of
one small gvpm pass of each beam volume (use_manifold=False): visits and
shift_ok exactly, the sums at rtol 2e-4 / atol 5e-6, two launches
bitwise equal (no atomics).

Needs a CUDA card and skips without one. It imports no JAX, so it runs
on a machine without it:

    python -m pytest --noconftest -o addopts="" -m gpu \\
        tests/test_torch_cuda_gbeams.py
"""

import pytest
import torch

from chip_smoke import GBEAM_VOLUMES, capture_gsweeps, gbeams_against_plain
from gvpm_tpu_torch import scenes
from gvpm_tpu_torch.core.config import GradientConfig
from gvpm_tpu_torch.integrators import sppm
from gvpm_tpu_torch.ops import beam_sweep as bs

pytestmark = pytest.mark.gpu

# two segment chunks of beam3d's random stream at 32^2 (2048 segments)
CFG = GradientConfig(max_depth=6, null_bounces=2, max_cam_depth=4,
                     surface_photons=1 << 12, volume_photons=1 << 12,
                     beam_seg_tile=1024, use_manifold=False)


@pytest.fixture(scope="module")
def captured():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    bs.build()
    scene = scenes.box_medium(32, 32)     # the default device: the card
    before = dict(bs.LAUNCHES)
    calls = capture_gsweeps(scene, CFG, dict(
        n_photons=1 << 12, seed=0, it=0, surf_scale=1.0, vol_scale=1.0,
        r_vol_base=sppm.base_volume_radius(scene, CFG)))
    torch.cuda.synchronize()
    return calls, {k: bs.LAUNCHES[k] - before[k] for k in before}


def test_each_pass_launches_its_kernel(captured):
    _, launched = captured
    assert launched == dict(dict.fromkeys(bs.LAUNCHES, 0), gbeam1d=1,
                            gbeam3d=2 * CFG.volume_samples, gplane0d=1)


@pytest.mark.parametrize("kind", tuple(GBEAM_VOLUMES))
def test_gradient_kernel_matches_plain(captured, kind):
    calls, _ = captured
    args = calls[kind]
    assert all(a.is_cuda for a in args[:4])
    want, stats, _, _ = gbeams_against_plain(kind, args)
    assert int(want[3].sum()) == stats["accepted"] > 0
    assert int(want[4].sum()) > 0
