"""The fused-gather CUDA kernel on the card: built from
gvpm_tpu_torch/csrc, launched by the wrapper for CUDA tensors (never the
plain version), and equal to the plain version on one small pass's
inputs and on the stress input of chip_smoke.py — visits and shift_ok
exact, sums at rtol 2e-4 / atol 5e-6, and for the ME variants the int32
row key exactly equal. Two launches on the same inputs give the same
bits: the kernel's sums have a fixed order.

Needs a CUDA card and skips without one. It imports no JAX, so it runs
on a machine without it:

    python -m pytest --noconftest -o addopts="" -m gpu \
        tests/test_torch_cuda_kernel.py
"""

import dataclasses

import pytest
import torch

from chip_smoke import stress_inputs
from gvpm_tpu_torch import scenes
from gvpm_tpu_torch.core.config import GradientConfig
from gvpm_tpu_torch.integrators import gradient_gather, gvpm, sppm
from gvpm_tpu_torch.ops import fused_gather as fg

pytestmark = pytest.mark.gpu

CFG = GradientConfig(max_depth=6, null_bounces=2, max_cam_depth=4,
                     surface_photons=1 << 12, volume_photons=1 << 12,
                     volume_samples=1, grid_dims=(16, 16, 16),
                     use_manifold=False)
ME_CFG = dataclasses.replace(CFG, use_manifold=True, me_pair_budget=64)


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

    scene = scenes.box_medium(32, 32)     # the default device: the card
    before = dict(fg.LAUNCHES)
    fg.fused_gather = capture
    try:
        outs = [gvpm.render_pass(scene, cfg, "distance", 1 << 12, 0, 0, 1.0,
                                 1.0, sppm.base_volume_radius(scene, cfg))
                for cfg in (CFG, ME_CFG)]
    finally:
        fg.fused_gather = launch
    torch.cuda.synchronize()
    launched = {k: fg.LAUNCHES[k] - before[k] for k in before}
    return calls, outs, launched


def test_main_path_launches_the_kernel(captured):
    _, outs, launched = captured
    assert launched == {"surface": 1, "volume": CFG.volume_samples,
                        "surface_me": 1, "volume_me": CFG.volume_samples}
    for out in outs:
        for img in out[:3]:
            assert img.is_cuda and bool(torch.isfinite(img).all())
    no_me, me = outs[0][3], outs[1][3]
    assert int(me["visits"]) == int(no_me["visits"])
    assert int(me["shift_ok"]) > int(no_me["shift_ok"])
    assert int(me["me_pairs"]) > 0 == int(no_me["me_pairs"])


EVALS = ["surface", "volume", "surface_me", "volume_me"]


def _assert_kernel_matches_plain(ev, plan, tbl, qrows, r2, k3, md):
    got, got_me = fg.launch_kernel(ev, plan, tbl, qrows, r2, k3, md)
    again, again_me = fg.launch_kernel(ev, plan, tbl, qrows, r2, k3, md)
    want, want_me = fg.fused_gather_plain(ev, plan, tbl, qrows, r2, k3, md)
    torch.cuda.synchronize()
    assert float(want[:, 27].sum()) > 0
    assert torch.equal(got[:, 27:29], want[:, 27:29])
    torch.testing.assert_close(got, want, rtol=2e-4, atol=5e-6)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    assert (got_me is not None) == ev.me
    if ev.me:
        assert got_me.dtype == torch.int32
        assert int((want_me != fg.ME_NONE).sum()) > 0
        assert torch.equal(got_me, want_me)
        assert torch.equal(got_me, again_me)
    return want


@pytest.mark.parametrize("which", EVALS)
def test_kernel_matches_plain(captured, which):
    _assert_kernel_matches_plain(*captured[0][which])


@pytest.mark.parametrize("which", EVALS)
def test_kernel_matches_plain_on_the_stress_input(captured, which):
    ev = gradient_gather.EVALS[which]
    r0, r1, *rest, hot = stress_inputs(ev, device="cuda")
    plan = fg.Plan(torch.arange(r0.shape[0], device="cuda"), r0, r1)
    want = _assert_kernel_matches_plain(ev, plan, *rest)
    assert int(want[hot, 27]) > 256


def test_row_heads_kernel_copies_the_rows_bits(captured):
    ev, _plan, tbl, *_ = captured[0]["surface"]
    got = fg.row_heads(ev, tbl)
    torch.cuda.synchronize()
    assert got.is_cuda and got.shape == (2, tbl.shape[0], 4)
    assert torch.equal(got.cpu().view(torch.int32),
                       fg.row_heads(ev, tbl.cpu()).view(torch.int32))


def test_wrapper_rejects_bad_inputs(captured):
    ev, plan, tbl, qrows, r2, k3, md = captured[0]["volume"]

    def refused(plan=plan, tbl=tbl, qrows=qrows):
        with pytest.raises(ValueError):
            fg.launch_kernel(ev, plan, tbl, qrows, r2, k3, md)

    refused(tbl=tbl.double())
    # narrower than the slots the eval reads
    refused(tbl=tbl[:, :48].contiguous())
    refused(tbl=tbl[:, :100])                     # not contiguous
    refused(qrows=torch.nn.functional.pad(qrows, (0, 64)))
    refused(plan=fg.Plan(plan.order, plan.r0.t().contiguous().t(), plan.r1))
    refused(plan=fg.Plan(plan.order, plan.r0[:, :8].contiguous(), plan.r1))
    refused(plan=fg.Plan(plan.order, plan.r0.to(torch.int64), plan.r1))
