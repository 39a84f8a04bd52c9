"""The JAX package's sharded gradient pass with manifold (ME) shifts at
more than one device, against the same pass composed from its own
functions with the provenance made global, on the CPU:

    JAX_PLATFORMS=cpu python tests/torch_parallel_reference.py

gvpm_tpu/parallel/dist.py all-gathers the photon partitions rank-major
([d][S * per]) but keeps `parent_idx` as the shard-local flat id
s * per + i that ptracer.shoot records, so on every shard but the first
the ME chain walk (manifold.pull_chains) reads another photon's parent
in shard 0's rows. This script runs dist.gvpm_render_pass_sharded on a
2-device mesh (ME on, the mirror-wall box of tests/test_torch_common.py,
whose chains are many, 16^2, 2048 paths), composes the pass from
sppm.shoot_photons(path_offset=) per shard, the rank-major concatenation
and gvpm.pass_buffers on each half of the rows, once as dist.py gathers
(to show that the composition is its pass) and once with parent_idx
+ d * S * per and path + d * per (what gvpm_tpu_torch/parallel/dist.py
does), and prints one JSON object: the ME chains (pull_chains' `ok`) of
the whole map and the share of them in shard 1's rows (whose walks
cross into shard 0's rows), how many of those pull_chains still accepts
on the shard-local ids (each then reads another photon's anchor), and
the difference of the images and counts. About 7 minutes on one CPU
process (the JAX package's pass_buffers runs eagerly here). Not a test
module: ROADMAP.md section 3 records its numbers.
"""

import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=2").strip()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
jax.config.update("jax_threefry_partitionable", True)

from gvpm_tpu.core import rng  # noqa: E402
from gvpm_tpu.core.config import GradientConfig  # noqa: E402
from gvpm_tpu.integrators import gvpm, manifold, sppm  # noqa: E402
from gvpm_tpu.parallel import dist, mesh as meshmod  # noqa: E402
from tests.test_torch_common import jax_mirror_scene  # noqa: E402

N, SEED, IT, N_DEV = 2048, 0, 1, 2
# tests/test_parallel.py:115-124's driver knobs (no clipping) with ME on
CFG = GradientConfig(max_depth=5, null_bounces=2, max_cam_depth=4,
                     surface_photons=N, volume_photons=N, volume_samples=1,
                     grid_hash_size=1 << 12, grid_max_photons_per_cell=512,
                     gather_window=1 << 15, cull_k=1024,
                     vol_segments_per_pixel=4, initial_scale_volume=4.0,
                     use_manifold=True, me_pair_budget=256)


def composed(scene, remap):
    """The sharded pass from its parts: (primal, gx, gy, stats, photons)."""
    per = N // N_DEV
    k_light = rng.pass_key(SEED, IT, rng.STREAM_LIGHT)
    k_cam = rng.pass_key(SEED, IT, rng.STREAM_CAMERA)
    k_gather = rng.pass_key(SEED, IT, rng.STREAM_GATHER)
    parts = [sppm.shoot_photons(scene, CFG, per, k_light,
                                path_offset=d * per) for d in range(N_DEV)]
    rows = parts[0][0]["path"].shape[0]

    def gather(k):
        out = {}
        for f in parts[0][k]:
            blocks = []
            for d, part in enumerate(parts):
                a = part[k][f]
                if remap and f == "parent_idx":
                    a = jnp.where(a >= 0, a + d * rows, a)
                elif remap and f == "path":
                    a = a + d * per
                blocks.append(a)
            out[f] = jnp.concatenate(blocks)
        return out

    photons, beams = gather(0), gather(1)
    H, W = scene.height, scene.width
    r_vol = sppm.base_volume_radius(scene, CFG)
    bufs, stats = [], {}
    for d in range(N_DEV):
        py, px = jnp.mgrid[d * H // N_DEV:(d + 1) * H // N_DEV, 0:W]
        px = px.reshape(-1).astype(jnp.float32)
        py = py.reshape(-1).astype(jnp.float32)
        xi, yi = px.astype(jnp.int32), py.astype(jnp.int32)
        border = jnp.stack([xi == W - 1, xi == 0, yi == H - 1, yi == 0])
        p, S, Wb, st = gvpm.pass_buffers(
            scene, CFG, "distance", N, photons, beams, k_cam, k_gather, px,
            py, border, 1.0, 1.0, r_vol)
        bufs.append((p, S, Wb))
        for k, v in st.items():
            stats[k] = stats.get(k, 0) + int(v)
    primal, gx, gy = gvpm.assemble_gradients(
        jnp.concatenate([b[0] for b in bufs]),
        jnp.concatenate([b[1] for b in bufs], 1),
        jnp.concatenate([b[2] for b in bufs], 1), H, W)
    return (np.asarray(primal), np.asarray(gx), np.asarray(gy), stats,
            photons)


def chains(scene, photons):
    """pull_chains' `ok` of every photon of the table."""
    idx = jnp.arange(photons["path"].shape[0], dtype=jnp.int32)
    return np.asarray(manifold.pull_chains(scene, photons, idx)["ok"]
                      & (photons["vtype"] != 0))


def rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def main():
    scene = jax_mirror_scene()
    r_vol = sppm.base_volume_radius(scene, CFG)
    p, gx, gy, st = dist.gvpm_render_pass_sharded(
        meshmod.make_mesh(N_DEV), scene, CFG, "distance", N, SEED, IT, 1.0,
        1.0, r_vol)
    ref = [np.asarray(a) for a in (p, gx, gy)]
    local = composed(scene, remap=False)
    glob = composed(scene, remap=True)
    ok_global = chains(scene, glob[4])
    ok_local = chains(scene, local[4])
    rows = ok_global.shape[0] // N_DEV
    names = ("primal", "gx", "gy")
    print(json.dumps(dict(
        config=dict(scene="mirror-wall box 16x16", paths=N, devices=N_DEV,
                    max_depth=CFG.max_depth,
                    me_pair_budget=CFG.me_pair_budget),
        dist_vs_composed_local_max_abs={
            n: float(np.abs(a - b).max())
            for n, a, b in zip(names, local[:3], ref)},
        me_chains=int(ok_global.sum()),
        me_chains_in_shard_1=int(ok_global[rows:].sum()),
        share_in_shard_1=float(ok_global[rows:].sum()
                               / max(ok_global.sum(), 1)),
        shard_1_chains_still_ok_with_local_ids=int(
            (ok_global[rows:] & ok_local[rows:]).sum()),
        shard_1_chains_with_local_ids=int(ok_local[rows:].sum()),
        stats_dist={k: int(v) for k, v in st.items()},
        stats_local=local[3], stats_global=glob[3],
        local_vs_global_max_abs={
            n: float(np.abs(a - b).max())
            for n, a, b in zip(names, local[:3], glob[:3])},
        local_vs_global_rel_l2={
            n: rel(a, b) for n, a, b in zip(names, local[:3], glob[:3])},
        gx_gy_pixels_differing=int(
            (~np.isclose(local[1], glob[1], rtol=2e-4, atol=5e-6)).sum()
            + (~np.isclose(local[2], glob[2], rtol=2e-4, atol=5e-6)).sum()),
    ), indent=1))


if __name__ == "__main__":
    main()
