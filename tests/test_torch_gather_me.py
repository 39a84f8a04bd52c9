"""The port's fused gathers with manifold (ME) shifts (plain version on
the CPU) against gvpm_tpu's fused Pallas gathers with `me=True`
(interpret mode on the CPU), on the JAX pass's own stage inputs in the
mirror-wall box of tests/test_manifold.py.

Checked: the per-query ME row key and flag of the kernel (the JAX
side's `me_i` / `me_ok` out of `_unpack_pallas_out`; the port's int32
row key) are equal; the budgeted compaction (me_pair_budget 16, fewer
than the eligible queries) selects the same pairs and drops the same
count; visits and shift_ok are equal (no ME lane flips on these
inputs); primal, S and W agree at rtol 1e-3 / atol 5e-6."""

import jax
import numpy as np
import pytest
import torch

from gvpm_tpu.integrators import gradient_gather as jgg
from gvpm_tpu_torch import interop
from gvpm_tpu_torch.integrators import gradient_gather
from gvpm_tpu_torch.ops import cellgrid
from gvpm_tpu_torch.ops import fused_gather as fg
from tests.test_torch_common import (torch_threads,  # noqa: F401
                                     ME_JAX_CFG, N_PHOTONS, jax_mirror_scene,
                                     jax_stage_inputs, port_scene_from_jax,
                                     split_gather_points, t, to_np)

BUDGET = ME_JAX_CFG.me_pair_budget
GATHER_KW = dict(driver="pallas", pallas_q_tile=ME_JAX_CFG.pallas_q_tile,
                 pallas_window=ME_JAX_CFG.pallas_window, use_manifold=True,
                 me_budget=BUDGET, min_depth=ME_JAX_CFG.min_depth)


def _recording_unpack(stash):
    """gradient_gather._unpack_pallas_out that also stashes the kernel's
    ME outputs (traced values; the jitted caller returns them)."""
    orig = jgg._unpack_pallas_out

    def unpack(planv, out_flat, n_add, me):
        out, dropped = orig(planv, out_flat, n_add, me)
        stash.append((out["me_i"], out["me_ok"]))
        return out, dropped
    return orig, unpack


def _with_me_outputs(gather, *args, **kw):
    stash = []
    orig, jgg._unpack_pallas_out = _recording_unpack(stash)
    try:
        res = gather(*args, **kw)
    finally:
        jgg._unpack_pallas_out = orig
    return res, stash[0]


@jax.jit
def _jax_surface(scene, base, sgps, grid, packed, border, photons):
    return _with_me_outputs(jgg.surface_gather, scene, base, sgps, grid,
                            packed, N_PHOTONS, border, pv_chain=photons,
                            **GATHER_KW)


@jax.jit
def _jax_volume(scene, cb, scb, grid, packed, r_vol, key, border_lane,
                photons):
    return _with_me_outputs(
        jgg.volume_gather, scene, cb, scb, grid, packed, N_PHOTONS, r_vol,
        jax.random.wrap_key_data(key), border_lane, pv_chain=photons,
        n_samples=ME_JAX_CFG.volume_samples, **GATHER_KW)


def _port_grid(g):
    return cellgrid.CellGrid(origin=t(g.origin), cell_size=t(g.cell_size),
                             bucket_start=t(g.bucket_start),
                             sorted_idx=t(g.sorted_idx), dims=tuple(g.dims))


def _port_with_me_rows(gather, *args, **kw):
    """Run a port gather and also return its kernel stage's ME row key
    in original query order."""
    seen = []
    launch = fg.fused_gather

    def record(ev, plan, *rest):
        out, me_row = launch(ev, plan, *rest)
        seen.append(fg.unsort(plan, me_row))
        return out, me_row

    fg.fused_gather = record
    try:
        res = gather(*args, **kw)
    finally:
        fg.fused_gather = launch
    return res, seen[0]


@pytest.fixture(scope="module")
def gathers():
    js, ref = jax_stage_inputs(jax_mirror_scene(), ME_JAX_CFG)
    scene = port_scene_from_jax(js)
    n = ref["base"].p.shape[0]
    jsg = [jax.tree_util.tree_map(lambda a, i=i: a[i * n:(i + 1) * n],
                                  ref["gp5"]) for i in range(1, 5)]
    j_surf = to_np(_jax_surface(js, ref["base"], jsg, ref["grid_s"],
                                ref["packed_s"], ref["border"],
                                ref["photons"]))
    j_vol = to_np(_jax_volume(js, ref["cb"], ref["scb"], ref["grid_v"],
                              ref["packed_v"], ref["r_vol"],
                              ref["k_gather"], ref["border_lane"],
                              ref["photons"]))

    photons = interop.tensors_from_arrays(ref["photons"], "cpu")
    groups = split_gather_points(ref["gp5"])
    base = interop.gather_points_from_arrays(groups[0], "cpu").replace(
        radius=t(ref["base"].radius))
    sgps = [interop.gather_points_from_arrays(g, "cpu") for g in groups[1:]]
    me_kw = dict(use_manifold=True, pv_chain=photons, me_budget=BUDGET)
    surf_args = (scene, base, sgps, _port_grid(ref["grid_s"]),
                 t(ref["packed_s"]), N_PHOTONS, t(ref["border"]))
    vol_args = (scene, interop.tensors_from_arrays(ref["cb"], "cpu"),
                [interop.tensors_from_arrays(s, "cpu") for s in ref["scb"]],
                _port_grid(ref["grid_v"]), t(ref["packed_v"]), N_PHOTONS,
                t(ref["r_vol"]), t(ref["k_gather"]), t(ref["border_lane"]))
    vol_kw = dict(n_samples=ME_JAX_CFG.volume_samples)
    p_surf = _port_with_me_rows(gradient_gather.surface_gather, *surf_args,
                                **me_kw)
    p_vol = _port_with_me_rows(gradient_gather.volume_gather, *vol_args,
                               **vol_kw, **me_kw)
    # the same gathers without the ME stage, for the shift_ok gain
    plain = dict(
        surface=gradient_gather.surface_gather(*surf_args),
        volume=gradient_gather.volume_gather(*vol_args, **vol_kw))
    return dict(surface=(j_surf, p_surf), volume=(j_vol, p_vol),
                plain=plain)


WHICH = pytest.mark.parametrize("which", ["surface", "volume"])


@WHICH
def test_me_row_key_matches_jax_kernel(gathers, which):
    (_, (me_i, me_ok)), (_, me_row) = gathers[which]
    me_row = me_row.numpy()
    assert me_row.dtype == np.int32
    assert int(me_ok.sum()) > BUDGET       # eligible queries: plentiful
    np.testing.assert_array_equal(me_row != fg.ME_NONE, me_ok)
    np.testing.assert_array_equal(me_row[me_ok], me_i[me_ok])


@WHICH
def test_me_compaction_matches_jax(gathers, which):
    """The budget cuts the pair list: the same (query, row) pairs are
    kept, in the same order, and the same count is dropped."""
    (ref, (me_i, me_ok)), (got, me_row) = gathers[which]
    Q = me_ok.shape[0]
    jq, ji, _, jok = to_np(jgg._compact_me(
        dict(me_q=np.arange(Q, dtype=np.int32), me_i=me_i,
             me_scale=np.ones(Q, np.float32), me_ok=me_ok), BUDGET))
    pq, pi, pdrop = gradient_gather._compact_me(me_row, BUDGET)
    assert jok.all() and len(jq) == BUDGET
    np.testing.assert_array_equal(pq.numpy(), jq)
    np.testing.assert_array_equal(pi.numpy(), ji)
    assert int(pdrop) == int(me_ok.sum()) - BUDGET > 0
    assert int(got[6]) == int(ref[5][2]) == int(pdrop)      # me_dropped
    assert int(got[7]) == BUDGET                            # pairs taken


@WHICH
def test_me_gather_counts_match_jax(gathers, which):
    (ref, _), (got, _) = gathers[which]
    np.testing.assert_array_equal(got[3].numpy(), ref[3])   # visits
    np.testing.assert_array_equal(got[4].numpy(), ref[4])   # shift_ok
    assert int(ref[3].sum()) > 0
    assert int(got[5]) == 0 == int(ref[5][0])               # no clipping


@WHICH
def test_me_gather_sums_match_jax(gathers, which):
    (ref, _), (got, _) = gathers[which]
    for k, name in enumerate(("primal", "S", "W")):
        g = got[k].numpy()
        assert g.dtype == np.float32 and np.isfinite(g).all(), name
        np.testing.assert_allclose(g, ref[k], rtol=1e-3, atol=5e-6,
                                   err_msg=name)


@WHICH
def test_me_stage_adds_shifts(gathers, which):
    """The ME stage is not a no-op here: the same gather without it
    sees the same pairs and finds fewer successful shifts."""
    _, (got, _) = gathers[which]
    plain = gathers["plain"][which]
    assert torch.equal(got[3], plain[3])
    assert int(got[4].sum()) > int(plain[4].sum())
    assert int(plain[6]) == int(plain[7]) == 0


def test_compaction_keeps_everything_under_budget():
    me_row = torch.tensor([fg.ME_NONE, 7, fg.ME_NONE, 3, 9],
                          dtype=torch.int32)
    q, i, dropped = gradient_gather._compact_me(me_row, 8)
    assert q.tolist() == [1, 3, 4] and i.tolist() == [7, 3, 9]
    assert int(dropped) == 0
    q, i, dropped = gradient_gather._compact_me(me_row, 2)
    assert q.tolist() == [1, 3] and i.tolist() == [7, 3]
    assert int(dropped) == 1
