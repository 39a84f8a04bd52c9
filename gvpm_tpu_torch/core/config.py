"""Render configuration dataclasses (mirrors gvpm_tpu/core/config.py).

The TPU-only gather knobs of the JAX package (gather_driver, cull_k,
gather_window, window_q_tile, gather_q_tile, gather_budget,
pallas_q_tile, pallas_window, beam_dispatch) are dropped: the gradient
pass always gathers with the fused kernel over each query's exact cell
runs, with no window clipping, and the SPPM hash-grid gather chunks its
queries by a module constant (ops/hashgrid.Q_CHUNK). So are the fields
of parts not ported yet (cam_rays_per_pixel; see ROADMAP.md): they
come back with the code that reads them. One field is carried with no
reader: `beams`, read by nothing in either package, so that the
goldens' check configs build. `beam_seg_tile` cuts the camera segments
of a gradient beam3d gather into the chunks its random stream follows
(integrators/gradient_gather.beam3d_gradient_gather).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PathConfig:
    """Shared path-tracing options."""
    max_depth: int = 12
    rr_depth: int = 5                 # Russian roulette from this depth
    rr_clamp: float = 0.95
    null_bounces: int = 6


@dataclasses.dataclass(frozen=True)
class VolPathConfig(PathConfig):
    """Primal volumetric path tracer (reference: integrators/volpath)."""
    spp: int = 16
    nee: bool = True                  # next-event estimation + MIS
    sampler: str = "independent"      # pixel sampler (core/qmc.py)
    rfilter: str = "box"              # reconstruction filter (render/film)


@dataclasses.dataclass(frozen=True)
class PhotonConfig(PathConfig):
    """Photon shooting + progressive estimation (GPMConfig analog)."""
    surface_photons: int = 65536
    volume_photons: int = 65536
    beams: int = 4096                 # carried, read by nothing
    max_passes: int = 16
    alpha: float = 0.7                # radius reduction (gvpm.cpp:181)
    initial_scale: float = 1.0
    initial_scale_volume: float = 1.0
    rr_depth_photon: int = 10
    bounce_roughness: float = 0.05
    camera_sphere: float = 0.0        # photon skip radius near the sensor
    volume_samples: int = 2
    min_depth: int = 0
    max_cam_depth: int = 8
    beam_tile: int = 256              # beam tile of the beam/plane
                                      # sweeps: beam3d's random layout
    beam_seg_tile: int = 32768        # camera segments per chunk of a
                                      # gradient beam3d gather's randoms
    vol_segments_per_pixel: int = 2
    bre_knn: int = 0                  # per-photon BRE radii from local
                                      # density (bre.cpp:29); 0 = global
    grid_max_photons_per_cell: int = 32   # SPPM hash grid: budget 2x this
    grid_hash_size: int = 1 << 18         # SPPM hash grid buckets
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
