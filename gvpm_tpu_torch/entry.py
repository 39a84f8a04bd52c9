"""The single-device entry point: one SPPM photon-mapping pass on a tiny
scene (mirrors `entry()` of the repo's __graft_entry__.py, which drives
the JAX package). The multi-device dry run comes with ROADMAP queue 1
item 18."""

from __future__ import annotations

from .core.config import PhotonConfig
from .integrators import sppm
from .scene.builder import SceneBuilder

CFG = PhotonConfig(max_depth=4, null_bounces=3, max_cam_depth=4,
                   surface_photons=4096, volume_photons=4096,
                   grid_hash_size=1 << 12, volume_samples=1)


def tiny_scene(width=32, height=32, device=None):
    """Open cornell box with a fog box inside. `device`: None means the
    CUDA card (and raises without one)."""
    b = SceneBuilder()
    white = b.diffuse([0.7, 0.7, 0.7])
    light = b.area_light([20.0, 20.0, 20.0])
    m = b.homogeneous(sigma_a=[0.05] * 3, sigma_s=[0.4] * 3, g=0.3)
    # open cornell box (front face missing for the camera)
    b.rectangle([0, 0, 0], [0, 0, 1], [1, 0, 0], white)
    b.rectangle([0, 1, 0], [1, 0, 0], [0, 0, 1], white)
    b.rectangle([0, 0, 1], [0, 1, 0], [1, 0, 0], white)
    b.rectangle([0, 0, 0], [0, 1, 0], [0, 0, 1], white)
    b.rectangle([1, 0, 0], [0, 0, 1], [0, 1, 0], white)
    b.rectangle([0.35, 0.998, 0.35], [0.3, 0, 0], [0, 0, 0.3], white,
                emitter=light)
    b.medium_box([0.02, 0.02, 0.02], [0.98, 0.98, 0.98], m)
    b.camera(origin=[0.5, 0.5, -1.2], target=[0.5, 0.5, 0.5], fov=45)
    return b.build(width=width, height=height, device=device)


def entry(device=None):
    """(fn, example_args): one SPPM `distance` pass, 4096 light paths,
    on a 32x32 tiny scene; fn(*example_args) returns the pass image
    [32,32,3]."""
    scene = tiny_scene(device=device)

    def fn(scene, seed, it, surf_scale, vol_scale, r_vol_base):
        return sppm.render_pass(scene, CFG, "distance", 4096, seed, it,
                                surf_scale, vol_scale, r_vol_base)

    return fn, (scene, 0, 0, 1.0, 1.0, sppm.base_volume_radius(scene, CFG))
