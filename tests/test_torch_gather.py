"""The port's fused gathers (gvpm_tpu_torch, plain version on the CPU)
against gvpm_tpu's fused Pallas gathers (interpret mode on the CPU) on
identical inputs: the JAX pass's own stage inputs, carried over through
gvpm_tpu_torch.interop. The bar is the reference kernel test's
(tests/test_pallas_gather.py): primal, S and W at rtol 2e-4 / atol 5e-6,
visits and shift_ok exactly equal — the window (1024) covers every
capped row, so the JAX kernel clips nothing either."""

import jax
import numpy as np
import pytest

from gvpm_tpu.integrators import gradient_gather as jgg
from gvpm_tpu_torch import interop
from gvpm_tpu_torch.integrators import gradient_gather
from gvpm_tpu_torch.ops import cellgrid
from tests.test_torch_common import (torch_threads,  # noqa: F401
                                     JAX_CFG, N_PHOTONS, jax_stage_inputs,
                                     port_scene_from_jax,
                                     split_gather_points, t, to_np)

GATHER_KW = dict(driver="pallas", pallas_q_tile=JAX_CFG.pallas_q_tile,
                 pallas_window=JAX_CFG.pallas_window, use_manifold=False,
                 min_depth=JAX_CFG.min_depth)


@jax.jit
def _jax_surface(scene, base, sgps, grid, packed, border):
    return jgg.surface_gather(scene, base, sgps, grid, packed, N_PHOTONS,
                              border, **GATHER_KW)


@jax.jit
def _jax_volume(scene, cb, scb, grid, packed, r_vol, key, border_lane):
    return jgg.volume_gather(scene, cb, scb, grid, packed, N_PHOTONS,
                             r_vol, jax.random.wrap_key_data(key),
                             border_lane, n_samples=JAX_CFG.volume_samples,
                             **GATHER_KW)


def _port_grid(g):
    return cellgrid.CellGrid(origin=t(g.origin), cell_size=t(g.cell_size),
                             bucket_start=t(g.bucket_start),
                             sorted_idx=t(g.sorted_idx), dims=tuple(g.dims))


@pytest.fixture(scope="module")
def gathers():
    js, ref = jax_stage_inputs()
    scene = port_scene_from_jax(js)
    jgp5 = jax.tree_util.tree_map(lambda a: a, ref["gp5"])
    n = ref["base"].p.shape[0]
    jsg = [jax.tree_util.tree_map(lambda a, i=i: a[i * n:(i + 1) * n], jgp5)
           for i in range(1, 5)]
    j_surf = to_np(_jax_surface(js, ref["base"], jsg, ref["grid_s"],
                                ref["packed_s"], ref["border"]))
    j_vol = to_np(_jax_volume(js, ref["cb"], ref["scb"], ref["grid_v"],
                              ref["packed_v"], ref["r_vol"],
                              ref["k_gather"], ref["border_lane"]))

    groups = split_gather_points(ref["gp5"])
    base = interop.gather_points_from_arrays(groups[0], "cpu").replace(
        radius=t(ref["base"].radius))
    sgps = [interop.gather_points_from_arrays(g, "cpu") for g in groups[1:]]
    p_surf = gradient_gather.surface_gather(
        scene, base, sgps, _port_grid(ref["grid_s"]), t(ref["packed_s"]),
        N_PHOTONS, t(ref["border"]))
    p_vol = gradient_gather.volume_gather(
        scene, interop.tensors_from_arrays(ref["cb"], "cpu"),
        [interop.tensors_from_arrays(s, "cpu") for s in ref["scb"]],
        _port_grid(ref["grid_v"]), t(ref["packed_v"]), N_PHOTONS,
        t(ref["r_vol"]), t(ref["k_gather"]), t(ref["border_lane"]),
        n_samples=JAX_CFG.volume_samples)
    return dict(surface=(j_surf, p_surf), volume=(j_vol, p_vol))


@pytest.mark.parametrize("which", ["surface", "volume"])
def test_gather_sums_match_jax_kernel(gathers, which):
    ref, got = gathers[which]
    for k, name in enumerate(("primal", "S", "W")):
        g = got[k].numpy()
        assert g.dtype == np.float32 and np.isfinite(g).all(), name
        np.testing.assert_allclose(g, ref[k], rtol=2e-4, atol=5e-6,
                                   err_msg=name)


@pytest.mark.parametrize("which", ["surface", "volume"])
def test_gather_counts_match_jax_kernel(gathers, which):
    ref, got = gathers[which]
    np.testing.assert_array_equal(got[3].numpy(), ref[3])   # visits
    np.testing.assert_array_equal(got[4].numpy(), ref[4])   # shift_ok
    assert int(ref[3].sum()) > 0
    assert int(got[5]) == 0 == int(ref[5][0])               # no clipping

