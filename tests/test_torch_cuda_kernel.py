"""The fused-gather CUDA kernel on the card: built from
gvpm_tpu_torch/csrc, launched by the wrapper for CUDA tensors (never the
plain version), and equal to the plain version on one small pass's
inputs — visits and shift_ok exact, sums at rtol 2e-4 / atol 5e-6.

Needs a CUDA card and skips without one. It imports no JAX, so it runs
on a machine without it:

    python -m pytest --noconftest -o addopts="" -m gpu \
        tests/test_torch_cuda_kernel.py
"""

import pytest
import torch

from gvpm_tpu_torch import scenes
from gvpm_tpu_torch.core.config import GradientConfig
from gvpm_tpu_torch.integrators import gvpm, sppm
from gvpm_tpu_torch.ops import fused_gather as fg

pytestmark = pytest.mark.gpu

CFG = GradientConfig(max_depth=4, null_bounces=2, max_cam_depth=4,
                     surface_photons=1 << 12, volume_photons=1 << 12,
                     volume_samples=1, grid_dims=(16, 16, 16),
                     use_manifold=False)


@pytest.fixture(scope="module")
def captured():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    fg.build()
    calls = {}
    launch = fg.fused_gather

    def capture(ev, *args):
        calls.setdefault(ev.name, (ev,) + args)
        return launch(ev, *args)

    scene = scenes.box_medium(32, 32, device="cuda")
    before = dict(fg.LAUNCHES)
    fg.fused_gather = capture
    try:
        out = gvpm.render_pass(scene, CFG, "distance", 1 << 12, 0, 0, 1.0,
                               1.0, sppm.base_volume_radius(scene, CFG))
    finally:
        fg.fused_gather = launch
    torch.cuda.synchronize()
    launched = {k: fg.LAUNCHES[k] - before[k] for k in before}
    return calls, out, launched


def test_main_path_launches_the_kernel(captured):
    _, out, launched = captured
    assert launched == {"surface": 1, "volume": CFG.volume_samples}
    for img in out[:3]:
        assert img.is_cuda and bool(torch.isfinite(img).all())


@pytest.mark.parametrize("which", ["surface", "volume"])
def test_kernel_matches_plain(captured, which):
    ev, plan, tbl, qrows, r2, k3, md = captured[0][which]
    got = fg.launch_kernel(ev, plan, tbl, qrows, r2, k3, md)
    want = fg.fused_gather_plain(ev, plan, tbl, qrows, r2, k3, md)
    torch.cuda.synchronize()
    assert float(want[:, 27].sum()) > 0
    assert torch.equal(got[:, 27:29], want[:, 27:29])
    torch.testing.assert_close(got, want, rtol=2e-4, atol=5e-6)


def test_wrapper_rejects_bad_inputs(captured):
    ev, plan, tbl, qrows, r2, k3, md = captured[0]["volume"]
    with pytest.raises(ValueError):
        fg.launch_kernel(ev, plan, tbl.double(), qrows, r2, k3, md)
