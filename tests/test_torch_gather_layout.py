"""The fused gather's table layout: the kernel and the plain version
read the row-major [P, 128] table that `pack_photons` makes (no
feature-major copy), and the kernel's ball tests read an 8-float head of
each row, two planes of four floats, copied out of it. On the inputs of a 16x16
pass (captured as tests/test_torch_gather_eval_host.py captures them):
the heads hold the bits of the rows' slots, and the plain version on the
row-major table equals, bit for bit, the same pair function evaluated
over a feature-major [128, P] copy of it, the layout the gather used to
take."""

import pytest
import torch

from gvpm_tpu_torch import scenes
from gvpm_tpu_torch.integrators import gradient_gather, gvpm, sppm
from gvpm_tpu_torch.ops import fused_gather as fg
from tests.test_torch_common import N_PHOTONS, SIDE, TORCH_CFG
from tests.test_torch_common import torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def kernel_inputs():
    calls = {}
    orig = fg.fused_gather

    def record(ev, *args):
        calls.setdefault(ev.name, args)
        return orig(ev, *args)

    fg.fused_gather = record
    try:
        scene = scenes.box_medium(SIDE, SIDE, device="cpu")
        gvpm.render_pass(scene, TORCH_CFG, "distance", N_PHOTONS, 0, 1, 1.0,
                         1.0, sppm.base_volume_radius(scene, TORCH_CFG))
    finally:
        fg.fused_gather = orig
    return calls


class _FeatureMajorCols(fg._Cols):
    """Pair planes out of a feature-major [F, N] table."""

    def col(self, k):
        if k not in self.cache:
            self.cache[k] = self.table[k][self.idx]
        return self.cache[k]


EVALS = ["surface", "volume", "surface_me", "volume_me"]


@pytest.mark.parametrize("which", EVALS)
def test_row_heads_hold_the_rows_bits(kernel_inputs, which):
    ev = gradient_gather.EVALS[which]
    _plan, tbl, *_ = kernel_inputs[which.split("_")[0]]
    assert tbl.shape[1] == gradient_gather.ROW_F and tbl.is_contiguous()
    assert tbl.shape[1] >= fg.ROW_LOAD > max(ev.row_slots.values())
    head = fg.row_heads(ev, tbl)
    assert head.shape == (2, tbl.shape[0], 4) and head.is_contiguous()
    S = ev.row_slots
    want = [S["p"], S["p"] + 1, S["p"] + 2, S["vtype"], S["wi"],
            S["wi"] + 1, S["wi"] + 2, S["depth"]]
    assert torch.equal(
        head.view(torch.int32),
        tbl[:, want].reshape(-1, 2, 4).movedim(1, 0).view(torch.int32))
    # every slot a ball test reads lies in the head
    row_slots, _ = fg.slots_read(ev, 1)
    assert set(want) <= set(row_slots)


@pytest.mark.parametrize("which", EVALS)
def test_plain_on_row_major_table_equals_feature_major(kernel_inputs, which):
    ev = gradient_gather.EVALS[which]
    plan, tbl, qrows, r2, k3, md = kernel_inputs[which.split("_")[0]]
    got, got_me = fg.fused_gather_plain(ev, plan, tbl, qrows, r2, k3, md)
    tbl_T, q_T = tbl.t().contiguous(), qrows.t().contiguous()
    want = torch.zeros_like(got)
    for s, e, run, row in fg.candidate_chunks(plan):
        qi = run // fg.N_RUNS
        planes = ev.pair_fn(_FeatureMajorCols(q_T, s + qi, ev.q_slots),
                            _FeatureMajorCols(tbl_T, row, ev.row_slots),
                            md, r2, k3, ev.me)
        want[s:e, :fg.N_ACC].index_add_(
            0, qi, torch.stack(planes[:fg.N_ACC], dim=1))
    assert float(want[:, 27].sum()) > 0
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert (got_me is not None) == ev.me
