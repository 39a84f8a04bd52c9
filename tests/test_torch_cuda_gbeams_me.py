"""The ME instantiations of the gradient beam / plane sweep kernels on
the card (GBeam1DME, GBeam3DME and GPlane0DME on csrc/gsweep.cu): built
from gvpm_tpu_torch/csrc, launched by the wrapper for CUDA tensors (never the
plain version) once a segment chunk of a gvpm pass with the default
use_manifold=True (beam3d: once a chunk and distance sample), and equal
to the plain version on the sweep inputs of one small ME pass of each
beam volume, checked on the first quarter of the valid queries: visits,
shift_ok, the
ME key, the ME pair count and gbeam3d_me's chord point exactly, the
sums at rtol 2e-4 / atol 5e-6, two launches bitwise equal (no float
atomics; the key is reduced by min over the beam splits); and the three
on chip_smoke's stress input with ME-eligible beams, at the split plan
and in one split.

Needs a CUDA card and skips without one. It imports no JAX:

    python -m pytest --noconftest -o addopts="" -m gpu \\
        tests/test_torch_cuda_gbeams_me.py
"""

import pytest
import torch

from chip_smoke import (GBEAM_VOLUMES, capture_gsweeps, gbeams_me_against_plain,
                        gsweep_stress_against_plain)
from gvpm_tpu_torch import scenes
from gvpm_tpu_torch.core.config import GradientConfig
from gvpm_tpu_torch.integrators import sppm
from gvpm_tpu_torch.ops import beam_sweep as bs

pytestmark = pytest.mark.gpu

# two segment chunks at 32^2 (2048 segments), a pair budget below the
# eligible queries of a chunk
CFG = GradientConfig(max_depth=6, null_bounces=2, max_cam_depth=4,
                     surface_photons=1 << 12, volume_photons=1 << 12,
                     beam_seg_tile=1024, me_pair_budget=64,
                     use_manifold=True)


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


def test_each_me_pass_launches_its_kernel(captured):
    _, launched = captured
    assert launched == dict(dict.fromkeys(bs.LAUNCHES, 0), gbeam1d_me=2,
                            gbeam3d_me=2 * CFG.volume_samples, gplane0d_me=2)


@pytest.mark.parametrize("kind", [k + "_me" for k in GBEAM_VOLUMES])
def test_me_kernel_matches_plain(captured, kind):
    calls, _ = captured
    args = calls[kind]
    assert all(a.is_cuda for a in args[:4])
    got, _, _, n_rows, me_queries = gbeams_me_against_plain(kind, args)
    assert n_rows > 0 and me_queries > 0
    assert int(got[6].sum()) >= int((got[5] != bs.ME_NONE).sum()) > 0


@pytest.mark.parametrize("kind", bs.GKINDS_ME)
def test_queued_me_kernel_on_stress_input(captured, kind):
    want, hot, _, _ = gsweep_stress_against_plain(kind)
    assert int(want[5][hot]) != bs.ME_NONE and int(want[6].sum()) > 0
