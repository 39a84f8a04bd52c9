"""The port's multi-rank render (gvpm_tpu_torch/parallel/) against the
JAX package's gvpm_tpu/parallel/dist.py on a 2-device mesh, at the JAX
parallel tests' sizes: tests/test_sppm.make_box_scene at 16^2, 2048
paths, max_depth 4. The port's ranks are gloo processes on the CPU,
started through parallel.launch (one launch runs every sharded pass of
this file, `ranks`).

- shoot_photons(path_offset=d * per) of every shard of 2 and of 4 equals
  the JAX package's: discrete fields equal, floats at rtol 1e-4 / atol
  1e-5 (the randoms are bit-exact).
- The sharded SPPM pass and the sharded gradient pass (ME off), on 2
  ranks, equal the JAX package's on make_mesh(2) at the pass bar, rtol
  2e-4 / atol 5e-6, visits and shift_ok equal; the ring variants equal
  the all-gather ones at rtol 2e-3 / atol 2e-5 (tests/test_parallel.py's
  bar). The JAX side runs its default `cull` gather driver at the
  config of tests/test_parallel.py:115-124, whose window and candidate
  budget clip nothing; the port's config is the same without those TPU
  knobs. Each per-cell budget holds every stencil (no overflow
  subsample).
- With ME on (the mirror-wall box of tests/test_torch_common.py, whose
  chains are many), after the all-gather every parent_idx >= 0 points
  to a row of the photon's own path, and the sharded pass equals the
  pass composed in this process from per-shard shoot_photons, the
  rank-major concatenation with the remap, and gvpm.pass_buffers on each
  row shard.
- The ring SPPM pass refuses `bre` with bre_knn > 0, and a rank that
  raises fails the launch; nccl refuses more ranks than cards.
"""

import numpy as np
import pytest
import torch

from gvpm_tpu.core import rng as jrng
from gvpm_tpu.core.config import GradientConfig as JaxGradientConfig
from gvpm_tpu.core.config import PhotonConfig as JaxPhotonConfig
from gvpm_tpu.integrators import sppm as jsppm
from gvpm_tpu.parallel import dist as jdist
from gvpm_tpu.parallel import mesh as jmesh
from gvpm_tpu_torch.core import rng
from gvpm_tpu_torch.core.config import GradientConfig, PhotonConfig
from gvpm_tpu_torch.integrators import gvpm, sppm
from gvpm_tpu_torch.parallel import dist
from gvpm_tpu_torch.parallel.launch import RankError, launch
from gvpm_tpu_torch.parallel.mesh import Mesh, check_backend, make_mesh
from tests.test_sppm import make_box_scene
from tests.test_torch_common import (torch_threads,  # noqa: F401
                                     jax_mirror_scene, port_scene_from_jax)

N = 2048
SEED, IT = 0, 1
PASS_TOL = dict(rtol=2e-4, atol=5e-6)
RING_TOL = dict(rtol=2e-3, atol=2e-5)
STAGE_TOL = dict(rtol=1e-4, atol=1e-5)
SPPM_KW = dict(max_depth=4, null_bounces=3, max_cam_depth=4,
               surface_photons=N, volume_photons=N, grid_hash_size=1 << 12,
               volume_samples=1, grid_max_photons_per_cell=512)
# tests/test_parallel.py:115-124 without its TPU knobs: the segment
# budget holds every slot, so that the shard-local compaction drops no
# segment at any rank count
GRAD_KW = dict(SPPM_KW, vol_segments_per_pixel=4, use_manifold=False)
JAX_GRAD_CFG = JaxGradientConfig(gather_window=1 << 15, cull_k=1024,
                                 **GRAD_KW)
GRAD_CFG = GradientConfig(**GRAD_KW)
SPPM_CFG = PhotonConfig(**SPPM_KW)
# ME on: tests/test_torch_common.py's ME_KW in the mirror-wall box (one
# more bounce, a wide volume radius, a pair budget the gathers exceed)
ME_CFG = GradientConfig(max_depth=5, null_bounces=2, max_cam_depth=4,
                        surface_photons=N, volume_photons=N,
                        volume_samples=1, vol_segments_per_pixel=2,
                        grid_dims=(16, 16, 16), initial_scale_volume=4.0,
                        use_manifold=True, me_pair_budget=16)
TIMEOUT = 300


def _rank_job(mesh, scene, me_scene):
    """Every sharded pass of this file, on each rank; rank 0's result
    comes back."""
    r_s = sppm.base_volume_radius(scene, SPPM_CFG)
    args = (N, SEED, IT, 1.0, 1.0, r_s)
    out = dict(
        sppm=dist.render_pass_sharded(mesh, scene, SPPM_CFG, "distance",
                                      *args),
        sppm_ring=dist.render_pass_sharded_ring(mesh, scene, SPPM_CFG,
                                                "distance", *args),
        gvpm=dist.gvpm_render_pass_sharded(mesh, scene, GRAD_CFG,
                                           "distance", *args),
        gvpm_ring=dist.gvpm_render_pass_sharded_ring(mesh, scene, GRAD_CFG,
                                                     "distance", *args))
    r_me = sppm.base_volume_radius(me_scene, ME_CFG)
    out["me"] = dist.gvpm_render_pass_sharded(
        mesh, me_scene, ME_CFG, "distance", N, SEED, IT, 1.0, 1.0, r_me)
    photons, beams = dist.gather_photons(
        mesh, me_scene, ME_CFG, N,
        rng.pass_key(SEED, IT, rng.STREAM_LIGHT, mesh.device), True)
    out["photons"] = {k: photons[k] for k in ("parent_idx", "path")}
    out["beam_parent_idx"] = beams["parent_idx"]
    out["threads"] = torch.get_num_threads()
    return out


@pytest.fixture(scope="module")
def scenes():
    js = make_box_scene(w=16, h=16)
    return js, port_scene_from_jax(js), port_scene_from_jax(
        jax_mirror_scene())


@pytest.fixture(scope="module")
def ranks(scenes):
    _, scene, me_scene = scenes
    return launch(2, _rank_job, scene, me_scene, device="cpu",
                  timeout=TIMEOUT)


def _np(a):
    return a.numpy() if torch.is_tensor(a) else np.asarray(a)


@pytest.mark.parametrize("n_shards", (2, 4))
def test_shoot_photons_per_shard_matches_jax(scenes, n_shards):
    js, scene, _ = scenes
    n, per = 1 << 10, (1 << 10) // n_shards
    jcfg = JaxPhotonConfig(**dict(SPPM_KW, surface_photons=n,
                                  volume_photons=n))
    cfg = PhotonConfig(**dict(SPPM_KW, surface_photons=n, volume_photons=n))
    jk = jrng.pass_key(SEED, IT, jrng.STREAM_LIGHT)
    k = rng.pass_key(SEED, IT, rng.STREAM_LIGHT)
    for d in (0, n_shards - 1):
        jph, jbm = jsppm.shoot_photons(js, jcfg, per, jk,
                                       path_offset=d * per)
        ph, bm = sppm.shoot_photons(scene, cfg, per, k, path_offset=d * per)
        for want, got in ((jph, ph), (jbm, bm)):
            for f, g in got.items():
                w, g = np.asarray(want[f]), g.numpy()
                if np.issubdtype(w.dtype, np.floating):
                    np.testing.assert_allclose(g, w, **STAGE_TOL,
                                               err_msg=f"{f} shard {d}")
                else:
                    np.testing.assert_array_equal(
                        g, w.astype(g.dtype), err_msg=f"{f} shard {d}")
    # the lane-keyed draws are not the positional ones
    assert not torch.equal(sppm.shoot_photons(scene, cfg, per, k)[0]["p"],
                           ph["p"])


def test_sharded_sppm_pass_matches_jax(scenes, ranks):
    js = scenes[0]
    jcfg = JaxPhotonConfig(**SPPM_KW)
    want = np.asarray(jdist.render_pass_sharded(
        jmesh.make_mesh(2), js, jcfg, "distance", N, SEED, IT, 1.0, 1.0,
        jsppm.base_volume_radius(js, jcfg)))
    got = ranks["sppm"].numpy()
    assert got.shape == (16, 16, 3) and np.isfinite(got).all()
    assert got.mean() > 0
    np.testing.assert_allclose(got, want, **PASS_TOL)
    np.testing.assert_allclose(ranks["sppm_ring"].numpy(), got, **RING_TOL)


def test_sharded_gradient_pass_matches_jax(scenes, ranks):
    js = scenes[0]
    jp, jgx, jgy, jst = jdist.gvpm_render_pass_sharded(
        jmesh.make_mesh(2), js, JAX_GRAD_CFG, "distance", N, SEED, IT, 1.0,
        1.0, jsppm.base_volume_radius(js, JAX_GRAD_CFG))
    assert int(jst["win_dropped"]) == int(jst["k_overflow"]) == 0
    p, gx, gy, st = ranks["gvpm"]
    assert int(st["visits"]) == int(jst["visits"]) > 0
    assert int(st["shift_ok"]) == int(jst["shift_ok"])
    for name, g, w in (("primal", p, jp), ("gx", gx, jgx), ("gy", gy, jgy)):
        assert np.isfinite(_np(g)).all()
        np.testing.assert_allclose(_np(g), _np(w), **PASS_TOL, err_msg=name)
    rp, rgx, rgy, rst = ranks["gvpm_ring"]
    assert int(rst["visits"]) == int(st["visits"])
    assert int(rst["shift_ok"]) == int(st["shift_ok"])
    for name, g, w in (("primal", rp, p), ("gx", rgx, gx), ("gy", rgy, gy)):
        np.testing.assert_allclose(_np(g), _np(w), **RING_TOL, err_msg=name)


def test_gathered_provenance_stays_in_its_path(ranks):
    ph = ranks["photons"]
    pi, path = ph["parent_idx"].numpy(), ph["path"].numpy()
    rows = pi.shape[0] // 2                     # S * per, one rank's
    has = pi >= 0
    assert has.sum() > 0
    np.testing.assert_array_equal(path[pi[has]], path[has])
    # rank 1's chains point into rank 1's rows: without the remap they
    # would point into rank 0's
    assert (pi[rows:][has[rows:]] >= rows).all()
    assert (path[rows:] >= N // 2).all() and (path[:rows] < N // 2).all()
    # the ranks ran on the caller's intra-op threads (torch_threads)
    assert ranks["threads"] == torch.get_num_threads()
    bpi = ranks["beam_parent_idx"].numpy()
    assert (bpi >= 0).sum() > 0
    blk = np.arange(bpi.shape[0]) // rows
    np.testing.assert_array_equal(bpi[bpi >= 0] // rows, blk[bpi >= 0])


def test_sharded_me_pass_equals_the_composed_pass(scenes, ranks):
    """The sharded ME pass against one built in this process from its
    parts: per-shard light passes, their rank-major concatenation with the
    provenance made global, and pass_buffers on each half of the rows."""
    scene = scenes[2]
    n_sh, per = 2, N // 2
    k_light = rng.pass_key(SEED, IT, rng.STREAM_LIGHT)
    k_cam = rng.pass_key(SEED, IT, rng.STREAM_CAMERA)
    k_gather = rng.pass_key(SEED, IT, rng.STREAM_GATHER)
    parts = [sppm.shoot_photons(scene, ME_CFG, per, k_light,
                                with_beams=False, path_offset=d * per)[0]
             for d in range(n_sh)]
    rows = parts[0]["path"].shape[0]
    photons = {f: torch.cat([p[f] for p in parts]) for f in parts[0]}
    for d, p in enumerate(parts):
        blk = slice(d * rows, (d + 1) * rows)
        photons["parent_idx"][blk] = torch.where(
            p["parent_idx"] >= 0, p["parent_idx"] + d * rows,
            p["parent_idx"])
        photons["path"][blk] = p["path"] + d * per
    H, W = scene.height, scene.width
    bufs, visits, me_pairs = [], 0, 0
    for d in range(n_sh):
        py, px = torch.meshgrid(
            torch.arange(d * H // n_sh, (d + 1) * H // n_sh,
                         dtype=torch.float32),
            torch.arange(W, dtype=torch.float32), indexing="ij")
        px, py = px.reshape(-1), py.reshape(-1)
        xi, yi = px.long(), py.long()
        border = torch.stack([xi == W - 1, xi == 0, yi == H - 1, yi == 0])
        p, S, Wb, st = gvpm.pass_buffers(
            scene, ME_CFG, "distance", N, photons, None, k_cam, k_gather, px,
            py, border, 1.0, 1.0, sppm.base_volume_radius(scene, ME_CFG))
        bufs.append((p, S, Wb))
        visits += int(st["visits"])
        me_pairs += int(st["me_pairs"])
    want = gvpm.assemble_gradients(
        torch.cat([b[0] for b in bufs]), torch.cat([b[1] for b in bufs], 1),
        torch.cat([b[2] for b in bufs], 1), H, W)
    got = ranks["me"]
    assert me_pairs > 0
    assert int(got[3]["visits"]) == visits
    assert int(got[3]["me_pairs"]) == me_pairs
    for name, g, w in zip(("primal", "gx", "gy"), got[:3], want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), w.numpy(), **PASS_TOL,
                                   err_msg=name)


def test_ring_refuses_bre_knn(scenes):
    """In the rank, before any collective; through the launcher, the
    rank's failure fails the launch."""
    cfg = PhotonConfig(max_depth=4, surface_photons=1024,
                       volume_photons=1024, bre_knn=8)
    args = (scenes[1], cfg, "bre", 1024, 0, 0, 1.0, 1.0, 0.1)
    with pytest.raises(ValueError, match="bre_knn"):
        dist.render_pass_sharded_ring(
            Mesh(0, 2, torch.device("cpu"), "gloo", None), *args)
    with pytest.raises(RankError, match="ValueError: .*bre_knn"):
        launch(2, dist.render_pass_sharded_ring, *args, device="cpu",
               timeout=TIMEOUT)


def test_backend_refusals():
    """nccl needs a card for every rank and refuses the CPU, naming the
    counts; gloo takes any count; a mesh needs a process group; a launch
    needs a rank."""
    cards = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"{cards + 1} nccl ranks need a "
                                         f"CUDA card each and this machine "
                                         f"has {cards}"):
        check_backend(cards + 1, "cuda", "nccl")
    with pytest.raises(ValueError, match="nccl backend runs on CUDA"):
        check_backend(1, "cpu", "nccl")
    check_backend(4, "cpu", "gloo")
    with pytest.raises(RuntimeError, match="no process group"):
        make_mesh(2, "cpu")
    with pytest.raises(ValueError, match="0 ranks"):
        launch(0, dist.render, None, device="cpu")
