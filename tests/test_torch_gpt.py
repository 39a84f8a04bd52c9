"""The port's G-PT (gvpm_tpu_torch/integrators/gpt.py, the primary-sample
identity shift, and gpt_shift.py, the path-space reconnection /
half-vector shifts) against gvpm_tpu's on the fog boxes of
tests/test_gpt.py (16x16) and tests/test_gpt_shift.py (12x12),
max_depth 5, seed 13: two render_passes of each shift, primal / gx / gy
/ direct at rtol 1e-4 / atol 1e-5, with the pixels beyond that bar
counted and held to 2% (a lane whose reconnection or RECENTLY_CONNECTED
decision flips at the last bit moves whole pixels; 0 measured). gpt's
pass is volpath with tile_rngs=5, and tile_rngs repeats the lanes.
2-spp renders of each with the L2 screened-Poisson solve at rtol 1e-4,
and the L1 one as tests/test_torch_gvpm.py holds it."""

import numpy as np
import pytest
import torch

from gvpm_tpu.core.config import VolPathConfig as JaxVolPathConfig
from gvpm_tpu.integrators import gpt as jgpt
from gvpm_tpu.integrators import gpt_shift as jgpt_shift
from gvpm_tpu.ops import poisson as jpoisson
from gvpm_tpu_torch.core import rng
from gvpm_tpu_torch.core.config import VolPathConfig
from gvpm_tpu_torch.integrators import gpt, gpt_shift, volpath
from gvpm_tpu_torch.ops import poisson
from tests.test_sppm import make_box_scene
from tests.test_torch_common import (port_scene_from_jax,  # noqa: F401
                                     torch_threads)

# the JAX side runs at the configs of tests/test_gpt.py:14 (16x16 box)
# and tests/test_gpt_shift.py:32 (12x12 box), whose spp only the JAX
# render loops read: the same compiled passes, shared with those tests
# through the persistent compilation cache (tests/test_torch_common.py)
JAX_PSS_CFG = JaxVolPathConfig(spp=24, max_depth=5)
JAX_SHIFT_CFG = JaxVolPathConfig(spp=64, max_depth=5)
CFG = VolPathConfig(spp=2, max_depth=5)
SEED = 13
MAX_BAD = 0.02


def _passes(js, ts, jax_pass, port_pass, jax_cfg, stats=False):
    """Passes 0 and 1 of both packages: [(JAX buffers, port buffers,
    port lane stats)]."""
    out = []
    for it in range(CFG.spp):
        st = {} if stats else None
        want = [np.asarray(a) for a in jax_pass(js, jax_cfg, SEED, it)]
        got = [a.numpy() for a in (port_pass(ts, CFG, SEED, it, stats=st)
                                   if stats else port_pass(ts, CFG, SEED,
                                                           it))]
        out.append((want, got, st))
    return out


@pytest.fixture(scope="module")
def box12():
    js = make_box_scene(with_medium=True, w=12, h=12)
    return js, port_scene_from_jax(js)


@pytest.fixture(scope="module")
def shift_passes(box12):
    """Both spp of the path-space shift on the 12x12 box."""
    return _passes(*box12, jgpt_shift.render_pass, gpt_shift.render_pass,
                   JAX_SHIFT_CFG, stats=True)


@pytest.fixture(scope="module")
def pss_passes():
    """Both spp of the PSS shift on the 16x16 box, and its port scene."""
    js = make_box_scene(with_medium=True, w=16, h=16)
    ts = port_scene_from_jax(js)
    return ts, _passes(js, ts, jgpt.render_pass, gpt.render_pass,
                       JAX_PSS_CFG)


def _hold(got, want, name):
    """rtol 1e-4 / atol 1e-5 on every pixel but at most MAX_BAD of them
    (the lanes flipped at the last bit); returns the count beyond."""
    assert got.shape == want.shape and np.isfinite(got).all(), name
    bad = ~np.isclose(got, want, rtol=1e-4, atol=1e-5).all(-1)
    assert bad.mean() <= MAX_BAD, (name, int(bad.sum()),
                                   float(np.abs(got - want).max()))
    np.testing.assert_allclose(got[~bad], want[~bad], rtol=1e-4, atol=1e-5,
                               err_msg=name)
    return int(bad.sum())


def _mean_and_l2(passes, direct):
    """The JAX render's buffers from its passes: their mean, and the L2
    screened-Poisson reconstruction (of the indirect part when the passes
    carry a direct buffer, which is added back)."""
    bufs = [sum(p[0][k] for p in passes) / len(passes)
            for k in range(len(passes[0][0]))]
    base = bufs[0] - bufs[3] if direct else bufs[0]
    img = np.asarray(jpoisson.solve(base, bufs[1], bufs[2], l1=False))
    return bufs, img + bufs[3] if direct else img


@pytest.mark.parametrize("it", (0, 1))
def test_gpt_pass_matches_jax(pss_passes, it):
    want, got, _ = pss_passes[1][it]
    flips = [_hold(g, w, name)
             for g, w, name in zip(got, want, ("primal", "gx", "gy"))]
    assert flips == [0, 0, 0], flips
    assert got[0].mean() > 0


@pytest.mark.parametrize("it", (0, 1))
def test_gpt_shift_pass_matches_jax(shift_passes, it):
    want, got, stats = shift_passes[it]
    flips = [_hold(g, w, name) for g, w, name in
             zip(got, want, ("primal", "gx", "gy", "direct"))]
    assert flips == [0, 0, 0, 0], flips
    # the reconnection fires and merges lanes in every offset block
    n = 12 * 12
    for k in ("reconnected", "connected", "dead"):
        assert stats[k].shape == (4,) and int(stats[k].max()) <= n, k
    assert (stats["reconnected"] > 0).all()
    assert (stats["connected"] <= stats["reconnected"]).all()
    assert got[1].any() and got[2].any()


def test_volpath_tile_rngs_repeats_the_lanes(box12):
    """tile_rngs=4 draws each step's (n/4, ...) block and tiles it: lanes
    i and i + j*n/4 trace the same path from equal rays, and the first
    block equals an untiled trace of n/4 lanes (gpt.render_pass above
    holds tile_rngs=5 against the JAX package's)."""
    _, ts = box12
    cfg = VolPathConfig(max_depth=4, null_bounces=2)
    rs = np.random.default_rng(2)
    o = rs.uniform(0.2, 0.8, (24, 3)).astype(np.float32)
    d = rs.normal(size=(24, 3)).astype(np.float32)
    o, d = torch.tensor(o), torch.nn.functional.normalize(torch.tensor(d),
                                                          dim=-1)
    got = volpath.trace_radiance(ts, cfg, o.repeat(4, 1), d.repeat(4, 1), 0,
                                 rng.key(8), tile_rngs=4)
    one = volpath.trace_radiance(ts, cfg, o, d, 0, rng.key(8))
    torch.testing.assert_close(got, one.repeat(4, 1), rtol=0, atol=0)
    assert one.any()


def test_renders_with_l2_solve_match_jax(box12, shift_passes, pss_passes):
    """2-spp renders of each shift with the L2 solve against the JAX
    render's computation on the fixture's JAX passes (their mean, then
    the solve; gpt_shift's of the indirect part, the direct buffer added
    back), at rtol 1e-4."""
    for render, scene, passes, keys in (
            (gpt_shift.render, box12[1], shift_passes,
             ("primal", "gx", "gy", "direct")),
            (gpt.render, pss_passes[0], pss_passes[1],
             ("primal", "gx", "gy"))):
        got = render(scene, CFG, seed=SEED, recon_l1=False)
        bufs, img = _mean_and_l2(passes, "direct" in keys)
        for k, want in zip(keys + ("image",), bufs + [img]):
            np.testing.assert_allclose(got[k].numpy(), want, rtol=1e-4,
                                       atol=1e-5, err_msg=k)


def test_l1_solve_as_close_as_jax_to_float64(shift_passes):
    """The default L1 reconstruction of the gpt_shift indirect buffers
    (two passes averaged), held as tests/test_torch_gvpm.py holds gvpm's:
    no farther from a float64 solve than twice the JAX solve is, means
    within 1%."""
    want, _, _ = shift_passes[0]
    nxt = shift_passes[1][0]
    p, gx, gy, d = ((a + b) / 2 for a, b in zip(want, nxt))
    ind = (p - d).astype(np.float32)
    ref = np.asarray(jpoisson.solve(ind, gx, gy))
    got = poisson.solve(*(torch.tensor(a) for a in (ind, gx, gy))).numpy()
    exact = poisson.solve(*(torch.tensor(a).double()
                            for a in (ind, gx, gy))).numpy()
    assert np.abs(got - exact).max() <= 2.0 * np.abs(ref - exact).max() \
        + 1e-5
    np.testing.assert_allclose(got.mean(), ref.mean(), rtol=1e-2)


def test_gpt_shift_rejects_heterogeneous_media():
    from gvpm_tpu_torch import scenes
    with pytest.raises(ValueError, match="heterogeneous"):
        gpt_shift.render_pass(scenes.feature_scene("het", 4, 4, grid=4,
                                                   device="cpu"),
                              VolPathConfig(spp=1, max_depth=2), 0, 0)
