"""A test-only tiny cell: the benchmark's harness driven on the CPU, where
the program takes its plain PyTorch versions of the kernels."""

import pytest
import torch


def tiny_cell(volume="distance", me=False, width=16, limits=None):
    return dict(
        name="tiny", chips=1,
        config=dict(
            scene=dict(name="box_medium", width=width, height=width),
            volume=volume,
            gradient_config=dict(
                max_depth=4, null_bounces=2, max_cam_depth=4,
                surface_photons=1 << 11, volume_photons=1 << 11,
                volume_samples=2, vol_segments_per_pixel=2,
                initial_scale_volume=2.0, grid_dims=[8, 8, 8],
                rr_depth_photon=10, rr_clamp=0.95, initial_scale=1.0,
                beam_seg_tile=64, recon_iters=10, recon_irls_iters=2)),
        traffic=dict(use_manifold=me, me_pair_budget=16, ranks=1,
                     dump_every=2, scales=[1.0, 1.0]),
        limits=limits or {}, end_to_end=[], per_layer=[])


@pytest.fixture
def cpu():
    torch.set_num_threads(2)
    return torch.device("cpu")
