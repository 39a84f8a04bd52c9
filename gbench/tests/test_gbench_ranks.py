"""The multi-rank cell's path rehearsed on the CPU: two gloo ranks run
the sharded pass (dist.gvpm_render_pass_sharded) through the harness,
agree on the window's end, and check each rank's gathers, its table
against every rank's light pass and its film against every rank's
buffers; with the photon exchange left out the check fails."""

import pytest
import torch

from gbench import capture, check, harness, run

from .conftest import tiny_cell

LIMITS = dict(gather_err=1e-5, count_err=0.0, table_err=0.0, film_err=1e-6,
              solve_err=1e-4, repeat_err=0.0, film_gather_err=0.0,
              light_err=1e-5, light_miss=0.0, camera_err=1e-5,
              camera_miss=0.0, stage_calls=0.0, segment_err=0.0,
              sgather_err=1e-6, sgather_miss=0.0, vgather_err=1e-6,
              vgather_miss=0.0, buffers_err=1e-6)


def _no_exchange(mesh, fields):
    """Every rank's share of the photons replaced by this rank's own."""
    return {k: torch.cat([v] * mesh.size) for k, v in fields.items()}


def _rank(mesh, fault):
    torch.set_num_threads(1)
    cell = tiny_cell(width=16)
    cell["traffic"]["ranks"] = mesh.size
    if fault:
        from gvpm_tpu_torch.parallel import dist
        real = dist.all_gather_rows

        def gather(m, fields):
            return _no_exchange(m, fields) if "vtype" in fields \
                else real(m, fields)

        with capture.patched([(dist, "all_gather_rows", gather)]):
            return harness.run_cell(cell, 123, 0.1, False, 0.0, mesh=mesh,
                                    device=mesh.device)
    return harness.run_cell(cell, 123, 0.1, False, 0.0, mesh=mesh,
                            device=mesh.device)


@pytest.mark.parametrize("fault", [False, True])
def test_two_ranks(fault):
    from gvpm_tpu_torch.parallel.launch import launch
    rec, nums = launch(2, _rank, fault, device="cpu", timeout=900)
    assert "film_gather_err" in nums
    ok, rows = check.judge(nums, LIMITS)
    assert ok != fault, rows


def _plant(mesh):
    import sys
    import types
    if mesh.rank == 1:
        sys.modules["jax"] = types.ModuleType("jax")
    try:
        return run.ranks_forbidden(mesh)
    finally:
        sys.modules.pop("jax", None)


def test_a_rank_that_loads_jax_is_found():
    """A forbidden module loaded by a rank other than 0 reaches rank 0's
    result."""
    from gvpm_tpu_torch.parallel.launch import launch
    assert launch(2, _plant, device="cpu", timeout=300) == ["jax"]
