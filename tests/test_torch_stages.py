"""Stage-by-stage parity of the port (gvpm_tpu_torch) with gvpm_tpu:
the light pass, the 5-lane camera trace, the cell grids, the gather
query plan and the packed photon rows. Each port stage is fed the JAX
stage's own inputs (tests/test_torch_common.py). Discrete fields must be
equal; floats agree to rtol 1e-4 / atol 1e-5 (XLA's and PyTorch's exp /
log / sin differ in the last bits)."""

import numpy as np
import pytest
import torch

from gvpm_tpu_torch.core import rng
from gvpm_tpu_torch.integrators import gatherpoint, gradient_gather, sppm
from gvpm_tpu_torch.ops import cellgrid, fused_gather
from tests.test_torch_common import (torch_threads,  # noqa: F401
                                     JAX_CFG, N_PHOTONS, SEED, IT, SIDE,
                                     TORCH_CFG, jax_stage_inputs,
                                     port_scene_from_jax, t)


@pytest.fixture(scope="module")
def stages():
    js, ref = jax_stage_inputs()
    return port_scene_from_jax(js), ref


def _assert_field(name, ref, got):
    ref = np.asarray(ref)
    got = got.numpy()
    assert ref.shape == got.shape, name
    if ref.dtype.kind == "f":
        fin = np.isfinite(ref)
        assert np.array_equal(fin, np.isfinite(got)), name
        np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    else:
        np.testing.assert_array_equal(got, ref.astype(got.dtype),
                                      err_msg=name)


def test_shoot_photons(stages):
    scene, ref = stages
    ph, _ = sppm.shoot_photons(scene, TORCH_CFG, N_PHOTONS,
                               rng.pass_key(SEED, IT, rng.STREAM_LIGHT))
    assert set(ph) == set(ref["photons"])
    for k, v in ph.items():
        _assert_field(k, ref["photons"][k], v)


def test_gatherpoint_trace_five_lanes(stages):
    scene, ref = stages
    gp, cb = gatherpoint.trace(scene, TORCH_CFG,
                               rng.pass_key(SEED, IT, rng.STREAM_CAMERA),
                               t(ref["px5"]), t(ref["py5"]), rand_tile=5)
    for k, v in gp.asdict().items():
        _assert_field("gp." + k, getattr(ref["gp5"], k), v)
    for k, v in cb.asdict().items():
        _assert_field("cb." + k, getattr(ref["cb5"], k), v)
    # rand_tile=5: the 5 pixel groups drew the same randoms, so lanes
    # whose offset pixel equals the base pixel's geometry agree exactly
    n = SIDE * SIDE
    assert gp.valid.shape[0] == 5 * n


def _grid(ref_grid):
    return cellgrid.CellGrid(origin=t(ref_grid.origin),
                             cell_size=t(ref_grid.cell_size),
                             bucket_start=t(ref_grid.bucket_start),
                             sorted_idx=t(ref_grid.sorted_idx),
                             dims=tuple(ref_grid.dims))


@pytest.mark.parametrize("which", ["surface", "volume"])
def test_build_cells(stages, which):
    scene, ref = stages
    ph = ref["photons"]
    vt = 1 if which == "surface" else 2
    g = ref["grid_s" if which == "surface" else "grid_v"]
    lo, hi = ((scene.world_lo, scene.world_hi) if which == "surface"
              else (scene.medium_lo, scene.medium_hi))
    rows = (JAX_CFG.grid_surface_rows if which == "surface"
            else JAX_CFG.grid_volume_rows)
    grid, sel = cellgrid.build_cells(
        t(ph["p"]), t(ph["vtype"] == vt), lo, hi,
        torch.tensor(float(np.min(g.cell_size))), JAX_CFG.grid_dims,
        max_rows=rows)
    # the cell size is max(min_cell, extent/dims); min_cell is the
    # smallest axis when the extent term is inactive
    np.testing.assert_array_equal(grid.cell_size.numpy(), g.cell_size)
    np.testing.assert_array_equal(grid.bucket_start.numpy(),
                                  g.bucket_start)
    np.testing.assert_array_equal(grid.sorted_idx.numpy(), g.sorted_idx)
    np.testing.assert_array_equal(sel.numpy(),
                                  ref["sel_s" if which == "surface"
                                      else "sel_v"])


def test_anchor_ids27_and_plan(stages):
    scene, ref = stages
    grid = _grid(ref["grid_s"])
    base = ref["base"]
    aid = cellgrid.anchor_ids27(grid, t(base.p))
    np.testing.assert_array_equal(aid.numpy(), ref["anchors_s"])
    plan = fused_gather.plan_runs(grid, t(base.p), t(base.valid))
    Q = base.p.shape[0]
    np.testing.assert_array_equal(plan.order.numpy(),
                                  ref["plan_s"]["order"][:Q])
    for k in ("r0", "r1"):
        np.testing.assert_array_equal(
            getattr(plan, k).numpy(),
            ref["plan_s"][k].reshape(-1, fused_gather.N_RUNS)[:Q])


@pytest.mark.parametrize("which", ["surface", "volume"])
def test_pack_photons(stages, which):
    scene, ref = stages
    sel = ref["sel_s" if which == "surface" else "sel_v"]
    ph = {k: t(v[sel]) for k, v in ref["photons"].items()}
    packed = gradient_gather.pack_photons(scene, ph,
                                          valid=ph["vtype"] != 0)
    np.testing.assert_array_equal(
        packed.numpy(), ref["packed_s" if which == "surface"
                            else "packed_v"])
