"""The port's gradient photon beams and planes (gvpm_tpu_torch.
integrators.gradient_gather: beam_gradient_gather,
beam3d_gradient_gather, plane_gradient_gather, use_manifold=False, on
the plain version of ops/beam_sweep.py's gradient sweeps) against
gvpm_tpu's, on the JAX package's own inputs of one 16^2 gvpm pass
(tests/test_torch_common.py's config: 2^10 light paths, max_depth 4),
converted through interop.

The beams sweep in tiles of 32 (several tiles), and beam3d runs with a
segment chunk of 200 of the 512 camera segments: its random stream
follows the chunks (fold_in of the key per chunk), as the JAX package's
segment_chunked draws them. Bar: visits and shift_ok exactly equal;
primal, S and W at rtol 2e-4 / atol 5e-6, the reference kernel test's
(tests/test_pallas_gather.py:46-65)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvpm_tpu.core import rng as jrng
from gvpm_tpu.integrators import estimators as jest
from gvpm_tpu.integrators import gatherpoint as jgp
from gvpm_tpu.integrators import gradient_gather as jgg
from gvpm_tpu.integrators import gvpm as jgvpm
from gvpm_tpu.integrators import sppm as jsppm
from gvpm_tpu_torch import interop
from gvpm_tpu_torch.core.config import GradientConfig
from gvpm_tpu_torch.integrators import gradient_gather, gvpm, sppm
from tests.test_torch_common import (torch_threads,  # noqa: F401
                                     CFG_KW, IT, JAX_CFG, N_PHOTONS, SEED,
                                     jax_scene, port_scene_from_jax, t,
                                     to_np)

TOL = dict(rtol=2e-4, atol=5e-6)
TILE = 32
SEG_TILE = 200


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jax_gathers(scene, cfg, r_vol_base):
    """The compacted camera segments, beams and planes of one gvpm pass
    (gvpm_tpu's pass_buffers, beam branch) and the three gradient
    gathers on them."""
    W, H = scene.width, scene.height
    n = W * H
    k_cam = jrng.pass_key(SEED, IT, jrng.STREAM_CAMERA)
    k_light = jrng.pass_key(SEED, IT, jrng.STREAM_LIGHT)
    k_gather = jrng.pass_key(SEED, IT, jrng.STREAM_GATHER)
    py, px = jnp.mgrid[0:H, 0:W]
    px = px.reshape(-1).astype(jnp.float32)
    py = py.reshape(-1).astype(jnp.float32)
    xi, yi = px.astype(jnp.int32), py.astype(jnp.int32)
    border = jnp.stack([xi == W - 1, xi == 0, yi == H - 1, yi == 0])
    _, beams = jsppm.shoot_photons(scene, cfg, N_PHOTONS, k_light)
    px5 = jnp.concatenate([px] + [px + dx for dx, _ in jgvpm.OFFSETS])
    py5 = jnp.concatenate([py] + [py + dy for _, dy in jgvpm.OFFSETS])
    _, cb5 = jgp.trace(scene, cfg, k_cam, px5, py5, rand_tile=5)
    pix_id = py.astype(jnp.int32) * W + px.astype(jnp.int32)

    def flat(i):
        c = jax.tree_util.tree_map(lambda a: a[:, i * n:(i + 1) * n], cb5)
        cd = jax.tree_util.tree_map(
            lambda a: a.reshape((-1,) + a.shape[2:]), c)
        gid = (jnp.arange(c.valid.shape[0], dtype=jnp.int32)[:, None]
               * jnp.int32(W * H) + pix_id[None, :]).reshape(-1)
        return dict(valid=cd.valid, o=cd.o, d=cd.d, length=cd.length,
                    med=cd.med, thr=cd.thr, pdf_prod=cd.pdf_prod,
                    depth=cd.depth, gid=gid)

    cb = flat(0)
    lane_full = jnp.tile(jnp.arange(n, dtype=jnp.int32),
                         cb5.valid.shape[0])
    order = jnp.argsort(~cb["valid"])[:n * cfg.vol_segments_per_pixel]
    cb = {k: v[order] for k, v in cb.items()}
    scb = [{k: v[order] for k, v in flat(i).items()} for i in range(1, 5)]
    border_lane = jnp.stack([border[i][lane_full[order]] for i in range(4)])
    r_b = jnp.float32(r_vol_base)
    planes = jest.make_planes(scene, beams, k_gather)
    return dict(
        beams=beams, planes=planes, cb=cb, scb=scb, border_lane=border_lane,
        r_b=r_b, k_gather=jax.random.key_data(k_gather),
        gbeam1d=jgg.beam_gradient_gather(
            scene, cb, scb, beams, N_PHOTONS, r_b, border_lane, tile=TILE),
        gbeam3d=jgg.segment_chunked(
            jgg.beam3d_gradient_gather, scene, cb, scb, border_lane,
            SEG_TILE, key=k_gather, lb=beams, n_emitted=N_PHOTONS,
            r_beam=r_b, n_samples=2, tile=TILE),
        gplane0d=jgg.plane_gradient_gather(
            scene, cb, scb, planes, N_PHOTONS, border_lane, tile=TILE))


@pytest.fixture(scope="module")
def stages():
    js = jax_scene()
    ref = to_np(_jax_gathers(js, JAX_CFG,
                             jsppm.base_volume_radius(js, JAX_CFG)))
    port = {k: interop.tensors_from_arrays(ref[k], device="cpu")
            for k in ("beams", "planes", "cb")}
    port["scb"] = [interop.tensors_from_arrays(s, device="cpu")
                   for s in ref["scb"]]
    return port_scene_from_jax(js), port, ref


def _port_gather(kind, scene, port, ref):
    cb, scb, bl = port["cb"], port["scb"], t(ref["border_lane"])
    r_b = t(ref["r_b"])
    if kind == "gbeam1d":
        return gradient_gather.beam_gradient_gather(
            scene, cb, scb, port["beams"], N_PHOTONS, r_b, bl)
    if kind == "gbeam3d":
        return gradient_gather.beam3d_gradient_gather(
            scene, cb, scb, port["beams"], N_PHOTONS, r_b,
            t(ref["k_gather"]), bl, n_samples=2,
            tile=TILE, seg_tile=SEG_TILE)
    return gradient_gather.plane_gradient_gather(
        scene, cb, scb, port["planes"], N_PHOTONS, bl)


@pytest.mark.parametrize("kind", ("gbeam1d", "gbeam3d", "gplane0d"))
def test_gradient_gather_matches_jax(stages, kind):
    """primal, S, W, visits and shift_ok of one gather; the reconnection
    and the identity branches both run (reconnectable and
    non-reconnectable beams among the pairs)."""
    scene, port, ref = stages
    want = ref[kind]
    got = _port_gather(kind, scene, port, ref)
    assert int(got[3].sum()) == int(want[3]) > 50, "visits"
    assert int(got[4].sum()) == int(want[4]) > 50, "shift_ok"
    assert int(got[5]) == int(want[5]) == 0, "me_dropped"
    for g, w, name in zip(got[:3], want[:3], ("primal", "S", "W")):
        g = g.numpy()
        assert g.shape == w.shape and np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)
    reconn = port["planes" if kind == "gplane0d" else "beams"][
        "reconnectable"]
    assert 0 < int(reconn.sum()) < reconn.numel()


def test_beam_volumes_raise_with_manifold():
    """With use_manifold=True (the default) the beam and plane volumes
    no longer raise naming ROADMAP item 14c: their ME shifts are ported,
    and each volume renders a pass with finite buffers and ME pairs
    taken (their parity with the JAX package is held in
    tests/test_torch_gbeams_me*.py)."""
    scene = port_scene_from_jax(jax_scene())
    cfg = GradientConfig(**dict(CFG_KW, use_manifold=True))
    for volume in sppm.BEAM_VOLUMES:
        out = gvpm.render_pass(scene, cfg, volume, N_PHOTONS, SEED, IT, 1.0,
                               1.0, sppm.base_volume_radius(scene, cfg))
        assert all(bool(torch.isfinite(a).all()) for a in out[:3]), volume
        assert int(out[3]["me_pairs"]) > 0, volume
