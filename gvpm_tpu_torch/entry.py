"""The entry points of the repo's __graft_entry__.py, which drives the
JAX package: `entry()`, one SPPM photon-mapping pass on a tiny scene,
and `dryrun_multichip(n)`, the sharded SPPM and gradient passes on n
ranks."""

from __future__ import annotations

import torch

from .core.config import GradientConfig, PhotonConfig
from .integrators import sppm
from .parallel import dist
from .parallel.launch import launch
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


# seconds the dry run's ranks may take, start-up included
DRYRUN_TIMEOUT = 600
# the dry run's configs (__graft_entry__.py:95-113)
DRYRUN_CFG = PhotonConfig(max_depth=4, null_bounces=3, max_cam_depth=4,
                          surface_photons=1024, volume_photons=1024,
                          grid_hash_size=1 << 10, volume_samples=1)
DRYRUN_GRADIENT_CFG = GradientConfig(
    max_depth=4, null_bounces=3, max_cam_depth=4, surface_photons=1024,
    volume_photons=1024, grid_hash_size=1 << 10, volume_samples=1,
    use_manifold=True, me_pair_budget=256)


def _dryrun_rank(mesh):
    n = mesh.size
    # a film height the rank count divides
    h = 16 if 16 % n == 0 else 2 * n
    scene = tiny_scene(width=16, height=h, device=mesh.device)
    n_photons = 1024 * n
    img = dist.render_pass_sharded(
        mesh, scene, DRYRUN_CFG, "distance", n_photons, 0, 0, 1.0, 1.0,
        sppm.base_volume_radius(scene, DRYRUN_CFG))
    # the gradient pass with manifold shifts: primal and the S / W shift
    # buffers row-sharded, the photon partitions all-gathered, the stats
    # summed
    p, gx, gy, stats = dist.gvpm_render_pass_sharded(
        mesh, scene, DRYRUN_GRADIENT_CFG, "distance", n_photons, 0, 0, 1.0,
        1.0, sppm.base_volume_radius(scene, DRYRUN_GRADIENT_CFG))
    for name, a in (("sppm", img), ("primal", p), ("gx", gx), ("gy", gy)):
        if a.shape != (h, 16, 3) or not bool(torch.isfinite(a).all()):
            raise RuntimeError(f"dryrun_multichip({n}): {name} of shape "
                               f"{tuple(a.shape)} is not a finite "
                               f"({h}, 16, 3) image")
    return dict(image=img, primal=p, gx=gx, gy=gy, stats=stats)


def dryrun_multichip(n_devices: int, device=None):
    """The sharded photon-mapping step on `n_devices` ranks
    (parallel.launch): light paths sharded for shooting, the photon
    partitions all-gathered, pixel rows sharded for gathering; the SPPM
    pass and the gradient pass with manifold shifts on a 16-wide tiny
    scene, each checked for shape and finite values. `device` None runs
    nccl ranks, one card each; "cpu" runs gloo ranks on the CPU. Returns
    rank 0's images and the gradient pass's summed stats."""
    return launch(n_devices, _dryrun_rank, device=device,
                  timeout=DRYRUN_TIMEOUT)
