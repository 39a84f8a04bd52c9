"""The port's BDPT and G-BDPT (gvpm_tpu_torch/integrators/bdpt.py,
gbdpt.py) against gvpm_tpu's, in one file so that one module-scoped JAX
compile serves both.

Set-up: the JAX package's box_medium at 8x8 (fog in a null-bounded
medium box with a mirror sphere inside), max_depth 3, null_bounces 1,
seed 5, carried over to the port with port_scene_from_jax. The JAX side
runs a jitted bdpt.radiance_parts, and gbdpt.render_pass.__wrapped__
eagerly with bdpt.radiance_parts, gbdpt._connect_sweep and
gbdpt._edge_terms swapped for jitted versions of themselves (a whole
jitted G-BDPT pass compiles for minutes on the CPU; its pieces compile
once, in about a minute, and a pass then runs in half a second).

- radiance_parts field by field: the camera and light subpaths, v1 / v2
  / v3, the s=1 emitter endpoint, L and the five shift buckets. Discrete
  fields (vtype, depth, bsdf, med, is_delta, exists, ...) equal on at
  least 98% of lanes (0 differences measured); floats at rtol 1e-4 /
  atol 1e-5 (NaN and inf where the JAX package has them) on the lanes
  whose discrete fields agree; image buffers with the pixels beyond that
  bar counted and held to 2%, as tests/test_torch_gpt.py does.
- _scatter_eval on numpy-seeded surface and medium records of the
  materials box (every lobe), both transports, rtol 1e-4 / atol 1e-6.
- G-BDPT passes 0 and 1 of both shifts: primal / gx / gy at rtol 1e-4 /
  atol 1e-5 (pixels beyond held to 2%), and the count of reconnecting
  lanes of each offset (rc_ok) equal; the port runs the base and the
  offsets as one 5n-lane radiance_parts(rand_tile=5), which equals five
  separate calls; a 2-spp render with the L2 solve at rtol 1e-4, the L1
  one held as tests/test_torch_gvpm.py holds it; a heterogeneous medium
  raises ValueError.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvpm_tpu import scenes as jscenes
from gvpm_tpu.core import rng as jrng
from gvpm_tpu.core.config import VolPathConfig as JaxVolPathConfig
from gvpm_tpu.integrators import bdpt as jbdpt
from gvpm_tpu.integrators import gbdpt as jgbdpt
from gvpm_tpu.ops import poisson as jpoisson
from gvpm_tpu_torch.core import rng
from gvpm_tpu_torch.core.config import VolPathConfig
from gvpm_tpu_torch.integrators import bdpt, gbdpt
from gvpm_tpu_torch.ops import poisson
from gvpm_tpu_torch.scene.camera import pixel_grid
from tests.test_torch_common import (jax_feature_scene,  # noqa: F401
                                     port_scene_from_jax, torch_threads)

SIDE = 8
CFG_KW = dict(max_depth=3, null_bounces=1)
JAX_CFG = JaxVolPathConfig(**CFG_KW)
CFG = VolPathConfig(spp=2, **CFG_KW)
SEED = 5
MAX_BAD = 0.02
RTOL, ATOL = 1e-4, 1e-5
DISCRETE = ("vtype", "depth", "bsdf", "med", "seg_med", "is_delta",
            "exists", "is_emitter", "valid")

_jit_parts = jax.jit(jbdpt.radiance_parts, static_argnames=("cfg",
                                                             "rand_tile"))
_jit_edge = jax.jit(jgbdpt._edge_terms)
_jit_sweep = jax.jit(jgbdpt._connect_sweep, static_argnames=("cfg",
                                                             "n_steps"))


@pytest.fixture(scope="module")
def box():
    js = jscenes.box_medium(SIDE, SIDE)
    return js, port_scene_from_jax(js)


def _grid():
    py, px = np.mgrid[0:SIDE, 0:SIDE]
    return (px.reshape(-1).astype(np.float32),
            py.reshape(-1).astype(np.float32))


@pytest.fixture(scope="module")
def parts(box):
    """radiance_parts of pass 0 at the base pixel grid: (JAX's as numpy,
    the port's)."""
    js, ts = box
    px, py = _grid()
    want = _jit_parts(js, JAX_CFG, jnp.asarray(px), jnp.asarray(py),
                      jrng.pass_key(SEED, 0, jrng.STREAM_CAMERA))
    want = jax.tree_util.tree_map(np.asarray, want)
    got = bdpt.radiance_parts(ts, CFG, torch.tensor(px), torch.tensor(py),
                              rng.pass_key(SEED, 0, rng.STREAM_CAMERA))
    return want, got


@pytest.fixture(scope="module")
def gbdpt_passes(box):
    """Passes 0 and 1 of both shifts: {(shift, it): (JAX buffers, JAX
    rc_ok counts [4], port buffers, port stats)}. The JAX pass runs
    eagerly on jitted pieces; its rc_ok is recomputed from the pieces'
    outputs with the JAX package's own functions."""
    js, ts = box
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for shift in ("reconnect", "pss"):
            for it in (0, 1):
                calls = dict(parts=[], edges=[])

                def parts_rec(*a, **kw):
                    calls["parts"].append(_jit_parts(*a, **kw))
                    return calls["parts"][-1]

                def edge_rec(*a):
                    calls["edges"].append(_jit_edge(*a))
                    return calls["edges"][-1]

                mp.setattr(jbdpt, "radiance_parts", parts_rec)
                mp.setattr(jgbdpt, "_edge_terms", edge_rec)
                mp.setattr(jgbdpt, "_connect_sweep", _jit_sweep)
                want = [np.asarray(a) for a in jgbdpt.render_pass.__wrapped__(
                    js, JAX_CFG, SEED, it, shift=shift)]
                base = calls["parts"][0]
                ev_b, _, oke_b, _ = calls["edges"][0]
                d1_ok = jgbdpt._diffuse_vertex(js, base["v1"]) \
                    & base["v2"]["exists"]
                rc = []
                for op, (_, _, oke_o, _) in zip(calls["parts"][1:],
                                                calls["edges"][1:]):
                    ok = d1_ok & jgbdpt._diffuse_vertex(js, op["v1"]) \
                        & oke_b & oke_o & (jnp.max(ev_b, axis=-1) > 0)
                    rc.append(0 if shift == "pss" else int(ok.sum()))
                st = {}
                got = [a.numpy() for a in gbdpt.render_pass(
                    ts, CFG, SEED, it, shift=shift, stats=st)]
                out[(shift, it)] = (want, rc, got, st)
    return out


def _hold(got, want, name):
    """rtol 1e-4 / atol 1e-5 on every pixel but at most MAX_BAD of them;
    returns the count beyond."""
    assert got.shape == want.shape and np.isfinite(got).all(), name
    bad = ~np.isclose(got, want, rtol=RTOL, atol=ATOL).all(-1)
    assert bad.mean() <= MAX_BAD, (name, int(bad.sum()),
                                   float(np.abs(got - want).max()))
    np.testing.assert_allclose(got[~bad], want[~bad], rtol=RTOL, atol=ATOL,
                               err_msg=name)
    return int(bad.sum())


def _hold_record(got, want, name):
    """A vertex record (dict of [N, ...] or [S, N, ...]): the discrete
    fields equal on at least 98% of lanes, the floats close (NaN / inf
    where JAX has them) on the lanes whose discrete fields agree.
    Returns the count of lanes whose discrete fields differ."""
    assert set(got) == set(want), (name, set(got) ^ set(want))
    lane_dims = want["p"].ndim - 1
    same = np.ones(want["p"].shape[:lane_dims], bool)
    for f in want:
        w = np.asarray(want[f])
        if f in DISCRETE:
            g = got[f].numpy()
            assert g.shape == w.shape, (name, f)
            same &= g == w
    frac = 1.0 - same.mean()
    assert frac <= MAX_BAD, (name, frac)
    for f in want:
        if f in DISCRETE:
            continue
        w = np.asarray(want[f])
        g = got[f].numpy()
        np.testing.assert_allclose(g[same], w[same], rtol=RTOL, atol=ATOL,
                                   equal_nan=True, err_msg=f"{name}.{f}")
    return int((~same).sum())


def test_radiance_parts_match_jax(parts):
    want, got = parts
    flips = {k: _hold(got[k].numpy(), want[k], k)
             for k in ("L",) + bdpt.BUCKETS}
    assert sum(flips.values()) == 0, flips
    diffs = {k: _hold_record(got[k], want[k], k)
             for k in ("cam", "lt", "v1", "v2", "v3", "le_emitter")}
    assert sum(diffs.values()) == 0, diffs
    # vertices in the fog and on surfaces, mirror (delta) vertices, and
    # light in the t=1 and t=2 buckets (at 8x8 and max_depth 3 pass 0
    # puts none in very_direct and rest)
    vt = got["cam"]["vtype"]
    assert (vt == bdpt.VT_MED).any() and (vt == bdpt.VT_SURF).any()
    assert got["cam"]["is_delta"].any() and got["lt"]["is_delta"].any()
    for k in ("t1", "t2c"):
        assert got[k].amax() > 0, k
    assert got["L"].mean() > 0


@pytest.mark.parametrize("transport", ("radiance", "importance"))
def test_scatter_eval_matches_jax(transport):
    """_scatter_eval on numpy-seeded surface and medium records of the
    materials box (plastic, phong, rough conductor, ...)."""
    js = jax_feature_scene("materials", side=4, grid=4)
    ts = port_scene_from_jax(js)
    rs = np.random.default_rng(31)
    n = 512
    n_bsdf, n_med = js.bsdf_type.shape[0], js.med_sigma_s.shape[0]

    def unit(k):
        v = rs.normal(size=(k, 3)).astype(np.float32)
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    rec = dict(vtype=rs.choice([bdpt.VT_SURF, bdpt.VT_MED], n).astype(
                   np.int32),
               bsdf=rs.integers(0, n_bsdf, n).astype(np.int32),
               medidx=rs.integers(-1, n_med, n).astype(np.int32),
               ns=unit(n), wi_prop=unit(n), wo=unit(n))
    want = jax.jit(jbdpt._scatter_eval, static_argnames=("transport",))(
        js, *(jnp.asarray(rec[k]) for k in rec), transport=transport)
    got = bdpt._scatter_eval(ts, *(torch.tensor(rec[k]).long()
                                   if rec[k].dtype == np.int32
                                   else torch.tensor(rec[k])
                                   for k in rec), transport)
    for name, g, w in zip(("value", "pdf", "pdf_rev"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    assert (got[0].amax(-1) > 0).sum() > n // 4


@pytest.mark.parametrize("shift", ("reconnect", "pss"))
@pytest.mark.parametrize("it", (0, 1))
def test_gbdpt_pass_matches_jax(gbdpt_passes, shift, it):
    want, rc, got, st = gbdpt_passes[(shift, it)]
    flips = [_hold(g, w, name)
             for g, w, name in zip(got, want, ("primal", "gx", "gy"))]
    assert flips == [0, 0, 0], flips
    assert st["rc_ok"].tolist() == rc
    if shift == "reconnect":
        assert min(rc) > 0
    assert got[1].any() and got[2].any()


def test_five_calls_against_one_wavefront(box):
    """radiance_parts(rand_tile=5) on the 5n lanes of the base and the
    offset pixel grids equals five separate calls, field by field."""
    _, ts = box
    px, py = pixel_grid(ts)
    k = rng.pass_key(SEED, 1, rng.STREAM_CAMERA)
    grids = [(px, py)] + [(px + dx, py + dy) for dx, dy in gbdpt.OFFSETS]
    one = bdpt.radiance_parts(ts, CFG, torch.cat([g[0] for g in grids]),
                              torch.cat([g[1] for g in grids]), k,
                              rand_tile=5)
    n = px.shape[0]
    for i, (gx_, gy_) in enumerate(grids):
        sep = bdpt.radiance_parts(ts, CFG, gx_, gy_, k)
        for key, val in sep.items():
            if key == "es":
                continue
            if isinstance(val, dict):
                axis = 1 if key in ("cam", "lt") else 0
                for f, a in val.items():
                    b = one[key][f].narrow(axis, i * n, n)
                    torch.testing.assert_close(b, a, rtol=0, atol=0,
                                               equal_nan=True,
                                               msg=f"{i} {key}.{f}")
            else:
                torch.testing.assert_close(one[key][i * n:(i + 1) * n], val,
                                           rtol=0, atol=0, msg=f"{i} {key}")


def test_render_with_l2_solve_matches_jax(box, gbdpt_passes):
    """A 2-spp render with the L2 solve against the JAX render's
    computation on the fixture's JAX passes: their mean, then the
    solve."""
    got = gbdpt.render(box[1], CFG, seed=SEED, recon_l1=False)
    passes = [gbdpt_passes[("reconnect", it)][0] for it in (0, 1)]
    bufs = [(a + b) / 2 for a, b in zip(*passes)]
    img = np.asarray(jpoisson.solve(*bufs, l1=False))
    for k, want in zip(("primal", "gx", "gy", "image"), bufs + [img]):
        np.testing.assert_allclose(got[k].numpy(), want, rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_l1_solve_as_close_as_jax_to_float64(gbdpt_passes):
    """The default L1 reconstruction of the two reconnect passes'
    mean, held as tests/test_torch_gvpm.py holds gvpm's: no farther from
    a float64 solve than twice the JAX solve is, means within 1%."""
    passes = [gbdpt_passes[("reconnect", it)][0] for it in (0, 1)]
    p, gx, gy = ((a + b) / 2 for a, b in zip(*passes))
    ref = np.asarray(jpoisson.solve(p, gx, gy))
    got = poisson.solve(*(torch.tensor(a) for a in (p, gx, gy))).numpy()
    exact = poisson.solve(*(torch.tensor(a).double()
                            for a in (p, gx, gy))).numpy()
    assert np.abs(got - exact).max() <= 2.0 * np.abs(ref - exact).max() \
        + 1e-5
    np.testing.assert_allclose(got.mean(), ref.mean(), rtol=1e-2)


def test_gbdpt_rejects_heterogeneous_media():
    from gvpm_tpu_torch import scenes
    with pytest.raises(ValueError, match="heterogeneous"):
        gbdpt.render_pass(scenes.feature_scene("het", 4, 4, grid=4,
                                               device="cpu"),
                          VolPathConfig(spp=1, max_depth=2), 0, 0)
