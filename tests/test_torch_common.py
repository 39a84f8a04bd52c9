"""Shared set-up of the port's parity tests (gvpm_tpu_torch vs gvpm_tpu).

The JAX side builds every stage input of one G-VPM distance pass the way
gvpm_tpu.integrators.gvpm.pass_buffers does (gvpm.py:329-480), in one
jitted program; the port's stages are then fed these JAX inputs,
converted through gvpm_tpu_torch.interop, so that ulp-level exp/log
differences upstream do not compound. Sizes follow
tests/test_pallas_gather.py: box_medium(16, 16), 2^10 photons,
max_depth 4, 16^3 grid, 1024 grid rows, a window >= rows.

The manifold (ME) tests use the mirror-wall box of tests/test_manifold.py
instead (`jax_mirror_scene`, ME_JAX_CFG / ME_TORCH_CFG): a mirror back
wall makes ME-eligible photons plentiful at 2^10 paths, and the small
pair budget forces the compaction.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvpm_tpu import scenes as jscenes
from gvpm_tpu.core import rng as jrng
from gvpm_tpu.core.config import GradientConfig as JaxConfig
from gvpm_tpu.integrators import estimators as jest
from gvpm_tpu.integrators import gatherpoint as jgp
from gvpm_tpu.integrators import gradient_gather as jgg
from gvpm_tpu.integrators import gvpm as jgvpm
from gvpm_tpu.integrators import ptracer as jpt
from gvpm_tpu.integrators import sppm as jsppm
from gvpm_tpu.ops import cellgrid as jcg
from gvpm_tpu.ops import pallas_gather as jpg
from gvpm_tpu.scene import SceneBuilder as JaxSceneBuilder
from gvpm_tpu_torch import interop, scenes
from gvpm_tpu_torch.core.config import GradientConfig

SIDE = 16
N_PHOTONS = 1 << 10
SEED, IT = 0, 1
CFG_KW = dict(max_depth=4, null_bounces=2, max_cam_depth=4,
              surface_photons=N_PHOTONS, volume_photons=N_PHOTONS,
              volume_samples=1,
              vol_segments_per_pixel=2, grid_dims=(16, 16, 16),
              grid_surface_rows=1024, grid_volume_rows=1024,
              use_manifold=False)
# the JAX package's fused Pallas driver with a window >= the capped row
# count: no clipping, so it must agree with the port pair for pair
JAX_CFG = JaxConfig(gather_driver="pallas", pallas_q_tile=64,
                    pallas_window=1024, **CFG_KW)
TORCH_CFG = GradientConfig(**CFG_KW)
# the SPPM primal pass at the same sizes (PhotonConfig fields only)
SPPM_KW = {k: v for k, v in CFG_KW.items() if k != "use_manifold"}
# ME configs: one more bounce so mirror-reflected photons get stored, a
# wide volume radius so enough distance samples see one, and a pair budget
# below the eligible query counts of both gathers
ME_KW = dict(CFG_KW, max_depth=5, initial_scale_volume=4.0,
             use_manifold=True, me_pair_budget=16)
ME_JAX_CFG = JaxConfig(gather_driver="pallas", pallas_q_tile=64,
                       pallas_window=1024, **ME_KW)
ME_TORCH_CFG = GradientConfig(**ME_KW)
# the beam / plane ME configs: box_medium (`jax_scene`), whose mirror
# sphere lies inside the fog, so beams leave the delta vertex itself
# (121 ME-eligible of 2421 valid beams at 2^10 paths; the mirror-wall box
# has none: its mirror lies outside the medium box, and every beam off it
# starts at the medium's null boundary), the pair budget of ME_KW, and
# segment chunks of 200 of the 512 camera segments
BEAM_ME_KW = dict(CFG_KW, max_depth=5, use_manifold=True, me_pair_budget=16,
                  beam_seg_tile=200)
BEAM_ME_JAX_CFG = JaxConfig(gather_driver="pallas", pallas_q_tile=64,
                            pallas_window=1024, **BEAM_ME_KW)
BEAM_ME_TORCH_CFG = GradientConfig(**BEAM_ME_KW)


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    """The SPPM / volpath parity modules run PyTorch on few threads: the
    tier-1 run puts 6 test processes on the machine's cores, and the
    intra-op thread pools of all of them together oversubscribe it
    (test modules import this fixture to use it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(n)


TORCH_THREADS = 1


def jax_scene():
    return jscenes.box_medium(width=SIDE, height=SIDE)


def jax_mirror_scene(side=SIDE):
    """The mirror-wall fog box of tests/test_manifold.py::mirror_scene."""
    b = JaxSceneBuilder()
    white = b.diffuse([0.7] * 3)
    mirror = b.conductor()
    light = b.area_light([30.0] * 3)
    b.rectangle([0, 0, 0], [0, 0, 1], [1, 0, 0], white)
    b.rectangle([0, 0, 1], [0, 1, 0], [1, 0, 0], mirror)
    b.rectangle([0.35, 0.998, 0.35], [0.3, 0, 0], [0, 0, 0.3], white,
                emitter=light)
    m = b.homogeneous(sigma_a=[0.05] * 3, sigma_s=[0.3] * 3, g=0.0)
    b.medium_box([0.02] * 3, [0.98] * 3, m)
    b.camera(origin=[0.5, 0.5, -1.2], target=[0.5, 0.5, 0.5], fov=42)
    return b.build(width=side, height=side)


def port_scene_from_jax(js):
    """The port's Scene carried over from the JAX Scene's tables."""
    arrays = {k: np.asarray(getattr(js, k))
              for k in scenes.box_medium(8, 8, device="cpu").tensors()}
    return interop.scene_from_arrays(
        arrays, js.width, js.height, cam_aperture=js.cam_aperture,
        cam_focus=js.cam_focus, het_medium=js.het_medium, device="cpu")


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def t(a):
    """numpy -> tensor with the port's dtypes (float32 / int64 / bool)."""
    return interop.tensors_from_arrays({"a": a}, device="cpu")["a"]


@functools.partial(jax.jit, static_argnames=("cfg",))
def _stage_inputs(scene, cfg, surf_scale, vol_scale, r_vol_base):
    """Every input of the two gathers of one pass (pass_buffers on the
    distance branch with the pallas driver), plus the stage outputs."""
    W, H = scene.width, scene.height
    n = W * H
    n_photons = max(cfg.surface_photons, cfg.volume_photons)
    k_cam = jrng.pass_key(SEED, IT, jrng.STREAM_CAMERA)
    k_light = jrng.pass_key(SEED, IT, jrng.STREAM_LIGHT)
    k_gather = jrng.pass_key(SEED, IT, jrng.STREAM_GATHER)
    py, px = jnp.mgrid[0:H, 0:W]
    px = px.reshape(-1).astype(jnp.float32)
    py = py.reshape(-1).astype(jnp.float32)
    xi, yi = px.astype(jnp.int32), py.astype(jnp.int32)
    border = jnp.stack([xi == W - 1, xi == 0, yi == H - 1, yi == 0])
    photons, _ = jsppm.shoot_photons(scene, cfg, n_photons, k_light)

    px5 = jnp.concatenate([px] + [px + dx for dx, _ in jgvpm.OFFSETS])
    py5 = jnp.concatenate([py] + [py + dy for _, dy in jgvpm.OFFSETS])
    gp5, cb5 = jgp.trace(scene, cfg, k_cam, px5, py5, rand_tile=5)
    base = jax.tree_util.tree_map(lambda a: a[:n], gp5)
    pp = photons["p"]
    rowid = jnp.arange(pp.shape[0], dtype=jnp.int32)

    def pack_rows(sel):
        ph = {f: v[sel] for f, v in photons.items()}
        return jgg.pack_photons(scene, ph,
                                valid=ph["vtype"] != jpt.VERT_NONE)

    r_surf = base.radius * surf_scale
    cell = jnp.maximum(jnp.max(jnp.where(base.valid, r_surf, 0.0)), 1e-5)
    grid_s, sel_s = jcg.build_cells(
        pp, photons["vtype"] == jpt.VERT_SURFACE, scene.world_lo,
        scene.world_hi, cell, cfg.grid_dims, rowid,
        max_rows=cfg.grid_surface_rows)
    r_vol = r_vol_base * vol_scale
    grid_v, sel_v = jcg.build_cells(
        pp, photons["vtype"] == jpt.VERT_MEDIUM, scene.medium_lo,
        scene.medium_hi, r_vol, cfg.grid_dims, rowid,
        max_rows=cfg.grid_volume_rows)

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
    n_steps = cb5.valid.shape[0]
    lane_full = jnp.tile(jnp.arange(n, dtype=jnp.int32), n_steps)
    budget = min(cb["valid"].shape[0], n * cfg.vol_segments_per_pixel)
    order = jnp.argsort(~cb["valid"])[:budget]
    cb = {k: v[order] for k, v in cb.items()}
    scb = [{k: v[order] for k, v in flat(i).items()} for i in range(1, 5)]
    lane = lane_full[order]
    border_lane = jnp.stack([border[i][lane] for i in range(4)])
    plan_s = jpg.plan_windows(grid_s, base.p, base.valid, q_tile=64,
                              window=1024)
    return dict(photons=photons, gp5=gp5, cb5=cb5, px5=px5, py5=py5,
                border=border, base=base.replace(radius=r_surf),
                grid_s=grid_s, sel_s=sel_s, packed_s=pack_rows(sel_s),
                grid_v=grid_v, sel_v=sel_v, packed_v=pack_rows(sel_v),
                r_vol=r_vol, cb=cb, scb=scb, lane=lane,
                border_lane=border_lane,
                k_gather=jax.random.key_data(k_gather),
                anchors_s=jcg.anchor_ids27(grid_s, base.p),
                plan_s=dict(order=plan_s["order"], r0=plan_s["r0"],
                            r1=plan_s["r1"]))


def jax_stage_inputs(js=None, cfg=JAX_CFG):
    """(JAX scene, numpy dict of the pass's stage inputs/outputs)."""
    js = jax_scene() if js is None else js
    r_vol_base = jsppm.base_volume_radius(js, cfg)
    out = _stage_inputs(js, cfg, 1.0, 1.0, r_vol_base)
    return js, to_np(out)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _beam_inputs(scene, cfg):
    """The inputs of one gvpm pass's beam / plane gather (gvpm_tpu's
    pass_buffers, beam branch): the light pass's photons and beams, the
    planes, the compacted camera segments and their border lanes."""
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
    photons, beams = jsppm.shoot_photons(scene, cfg, N_PHOTONS, k_light)
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
    return dict(photons=photons, beams=beams,
                planes=jest.make_planes(scene, beams, k_gather), cb=cb,
                scb=scb, border_lane=border_lane,
                k_gather=jax.random.key_data(k_gather))


def jax_beam_inputs(js, cfg):
    """numpy dict of _beam_inputs, plus r_b: the base volume radius."""
    out = to_np(_beam_inputs(js, cfg))
    out["r_b"] = np.float32(jsppm.base_volume_radius(js, cfg))
    return out


def render_pass_pair(js, jax_cfg, torch_cfg, volume="distance"):
    """One whole G-VPM pass of `volume` on both sides (same seed and pass
    index) -> (JAX (primal, gx, gy, stats), the port's)."""
    from gvpm_tpu_torch.integrators import gvpm, sppm
    n_photons = max(jax_cfg.surface_photons, jax_cfg.volume_photons)
    ref = jgvpm.render_pass(js, jax_cfg, volume, n_photons, SEED, IT,
                            1.0, 1.0, jsppm.base_volume_radius(js, jax_cfg))
    scene = port_scene_from_jax(js)
    got = gvpm.render_pass(scene, torch_cfg, volume, n_photons, SEED,
                           IT, 1.0, 1.0,
                           sppm.base_volume_radius(scene, torch_cfg))
    return ref, got


def assert_pass_matches(ref, got, rtol, atol):
    """Images at the given tolerance; every counter of the port's stats
    that the JAX pass also reports equal."""
    for k, name in enumerate(("primal", "gx", "gy")):
        g = got[k].numpy()
        assert g.shape == (SIDE, SIDE, 3) and np.isfinite(g).all(), name
        np.testing.assert_allclose(g, np.asarray(ref[k]), rtol=rtol,
                                   atol=atol, err_msg=name)
    for name in ("visits", "shift_ok", "win_dropped", "me_dropped"):
        assert int(got[3][name]) == int(ref[3][name]), name
    assert int(got[3]["visits"]) > 0


def split_gather_points(gp5):
    """[5n] traced gather points (numpy) -> (base, [4 shifted]) dicts."""
    n = SIDE * SIDE
    fields = {f.name: np.asarray(getattr(gp5, f.name))
              for f in dataclasses.fields(gp5)}
    return [{k: v[i * n:(i + 1) * n] for k, v in fields.items()}
            for i in range(5)]


def test_port_scene_carries_the_jax_tables():
    sc = port_scene_from_jax(jax_scene())
    for name, v in sc.tensors().items():
        assert v.dtype in (torch.float32, torch.int64), name


# ---------------------------------------------------------------------------
# the beam / plane ME gathers on both sides (tests/test_torch_gbeams_me*.py)
# ---------------------------------------------------------------------------

BEAM_TILE = 32          # the JAX gathers' beam tile: several tiles
BEAM_SAMPLES = 2        # beam3d's distance samples: the budget is per sample
# the ME stage of each kind in both packages, and where its arguments
# hold the selected pairs
_ME_STAGES = dict(gbeam1d="_beam_me_stage", gbeam3d="_beam3d_me_stage",
                  gplane0d="_plane_me_stage")


def _jax_selected(kind, a):
    """(segment ids, beam indices, taken) of a JAX ME stage call's
    budgeted pairs (beam3d compacts inside its stage)."""
    if kind == "gbeam1d":
        return a[8], a[9], a[10]
    if kind == "gplane0d":
        return a[12], a[13], a[14]
    me_found, me_beam, budget = a[9], a[10], a[12]
    vals, sq = jax.lax.top_k(me_found.astype(jnp.int32),
                             min(budget, me_found.shape[0]))
    return sq, me_beam[sq], vals > 0


@functools.partial(jax.jit, static_argnames=("kind", "budget"))
def _jax_me_chunk(kind, budget, scene, cbc, scbc, blc, lb, photons, r_b,
                  key):
    """One segment chunk's ME gather (as the hosted dispatch runs it)
    and the pairs its ME stage(s) took."""
    stash, name = [], _ME_STAGES[kind]
    orig = getattr(jgg, name)

    def stage(*a, **k):
        stash.append(_jax_selected(kind, a))
        return orig(*a, **k)

    kw = dict(tile=BEAM_TILE, use_manifold=True, me_budget=budget,
              pv_chain=photons)
    setattr(jgg, name, stage)
    try:
        if kind == "gbeam1d":
            res = jgg.beam_gradient_gather(scene, cbc, scbc, lb, N_PHOTONS,
                                           r_b, blc, **kw)
        elif kind == "gbeam3d":
            res = jgg.beam3d_gradient_gather(
                scene, cbc, scbc, lb, N_PHOTONS, r_b, key, blc,
                n_samples=BEAM_SAMPLES, **kw)
        else:
            res = jgg.plane_gradient_gather(scene, cbc, scbc, lb, N_PHOTONS,
                                            blc, **kw)
    finally:
        setattr(jgg, name, orig)
    return res, stash


def jax_beam_me_gather(kind, js, inp, seg_tile, budget):
    """The JAX package's ME gather `kind` in segment chunks of seg_tile
    (padded, key folded with the chunk, as render_pass_hosted runs them)
    -> ((primal, S, W, visits, shift_ok, me_dropped), [per chunk and
    stage call: (segment ids, beam indices) of the pairs taken, the
    segment ids of the whole gather])."""
    m = inp["cb"]["o"].shape[0]
    n_chunks = -(-m // seg_tile)
    pad = n_chunks * seg_tile - m

    def ck(a, ci):
        a = np.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1))
        return a[ci * seg_tile:(ci + 1) * seg_tile]

    lb = inp["planes" if kind == "gplane0d" else "beams"]
    key = jax.random.wrap_key_data(inp["k_gather"])
    outs, pairs = [], []
    for ci in range(n_chunks):
        cbc = {k: ck(v, ci) for k, v in inp["cb"].items()}
        scbc = [{k: ck(v, ci) for k, v in s.items()} for s in inp["scb"]]
        blc = ck(inp["border_lane"].T, ci).T
        res, stash = _jax_me_chunk(kind, budget, js, cbc, scbc, blc, lb,
                                   inp["photons"], inp["r_b"],
                                   jax.random.fold_in(key, ci))
        outs.append(to_np(res))
        for sq, bq, sel in to_np(stash):
            pairs.append((sq[sel], bq[sel], ci * seg_tile + sq[sel]))
    primal = np.concatenate([o[0] for o in outs])[:m]
    S = np.concatenate([o[1] for o in outs], axis=1)[:, :m]
    W = np.concatenate([o[2] for o in outs], axis=1)[:, :m]
    counts = [sum(int(o[k]) for o in outs) for k in (3, 4, 5)]
    return (primal, S, W, *counts), pairs


def port_beam_me_gather(kind, scene, inp, seg_tile, budget):
    """The port's ME gather `kind` on the same inputs -> (its tuple,
    [per chunk and stage call: (segment ids, beam indices) taken])."""
    from gvpm_tpu_torch.integrators import gradient_gather as gg
    port = {k: interop.tensors_from_arrays(inp[k], device="cpu")
            for k in ("beams", "planes", "cb", "photons")}
    scb = [interop.tensors_from_arrays(s, device="cpu") for s in inp["scb"]]
    bl, r_b = t(inp["border_lane"]), t(inp["r_b"])
    pairs, name = [], _ME_STAGES[kind]
    orig = getattr(gg, name)

    def stage(*a, **k):
        pairs.append((a[5].numpy(), a[6].numpy()) if kind != "gbeam3d"
                     else (a[3].numpy(), a[4].numpy()))
        return orig(*a, **k)

    kw = dict(use_manifold=True, pv_chain=port["photons"], me_budget=budget,
              seg_tile=seg_tile)
    setattr(gg, name, stage)
    try:
        if kind == "gbeam1d":
            res = gg.beam_gradient_gather(scene, port["cb"], scb,
                                          port["beams"], N_PHOTONS, r_b, bl,
                                          **kw)
        elif kind == "gbeam3d":
            res = gg.beam3d_gradient_gather(
                scene, port["cb"], scb, port["beams"], N_PHOTONS, r_b,
                t(inp["k_gather"]), bl, n_samples=BEAM_SAMPLES,
                tile=BEAM_TILE, **kw)
        else:
            res = gg.plane_gradient_gather(scene, port["cb"], scb,
                                           port["planes"], N_PHOTONS, bl,
                                           **kw)
    finally:
        setattr(gg, name, orig)
    return res, pairs
