"""Render configuration dataclasses (mirrors gvpm_tpu/core/config.py).

The TPU-only gather knobs of the JAX package (gather_driver, cull_k,
gather_window, window_q_tile, gather_q_tile, gather_budget,
pallas_q_tile, pallas_window, beam_dispatch) are dropped: the port
always gathers with the fused kernel over each query's exact cell
runs, with no window clipping. So are the fields of parts not ported
yet (beams, BRE, hash grid, camera sphere; see ROADMAP.md): they come
back with the code that reads them.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PathConfig:
    """Shared path-tracing options."""
    max_depth: int = 12
    rr_clamp: float = 0.95
    null_bounces: int = 6


@dataclasses.dataclass(frozen=True)
class PhotonConfig(PathConfig):
    """Photon shooting + progressive estimation (GPMConfig analog)."""
    surface_photons: int = 65536
    volume_photons: int = 65536
    max_passes: int = 16
    alpha: float = 0.7                # radius reduction (gvpm.cpp:181)
    initial_scale: float = 1.0
    initial_scale_volume: float = 1.0
    rr_depth_photon: int = 10
    bounce_roughness: float = 0.05
    volume_samples: int = 2
    min_depth: int = 0
    max_cam_depth: int = 8
    vol_segments_per_pixel: int = 2
    grid_surface_rows: int = 0        # photon-map row cap (0 = all slots)
    grid_volume_rows: int = 0
    grid_dims: tuple = (64, 64, 64)   # static cell-grid dims


@dataclasses.dataclass(frozen=True)
class GradientConfig(PhotonConfig):
    """Gradient-domain options (GPMConfig, gvpm_struct.h:181-333)."""
    recon_alpha: float = 0.2
    recon_l1: bool = True
    recon_iters: int = 50
    recon_irls_iters: int = 4
    shift_null: bool = False          # nullShift MIS debug mode
    use_manifold: bool = True         # ME shift for delta parent chains
    max_manifold_iterations: int = 5  # Newton steps of the ME solve
    me_pair_budget: int = 4096        # compacted (query, photon) ME pairs
                                      # per gather (overflow -> unilateral)
