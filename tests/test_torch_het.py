"""The port's heterogeneous medium (render/medium.py) against gvpm_tpu's
in scenes.feature_box's "het" scene (an 8^3 gamma density, non-gray
sigma_t): the trilinear sigma_t, delta tracking, ratio tracking, the
distance sampling that overrides the medium's lanes with them and the
tracked transmittance, each with the keys given and with the keys the
JAX package derives from the bit pattern of each lane's uniform
(jax.random.key of a uint32 seed, which core/rng.seed_keys makes bit
for bit).

Bar: keys exactly equal; success (real collision / interaction)
exactly equal lane for lane; distances, weights and pdfs at rtol 1e-4 /
atol 1e-5 (64 flights of ulp-level log1p differences)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvpm_tpu.render import medium as jmed
from gvpm_tpu_torch.core import rng
from gvpm_tpu_torch.render import medium
from tests.test_torch_common import jax_feature_scene, port_scene_from_jax
from tests.test_torch_common import torch_threads  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-5)
N = 1024


@pytest.fixture(scope="module")
def het():
    js = jax_feature_scene("het", 8)
    assert js.het_medium >= 0
    return js, port_scene_from_jax(js)


def _rays(seed, het_medium, inf_share=0.0):
    rs = np.random.default_rng(seed)
    o = rs.uniform(0.05, 0.95, (N, 3)).astype(np.float32)
    d = rs.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = rs.uniform(0.05, 1.5, N).astype(np.float32)
    t_max[rs.random(N) < inf_share] = np.inf
    mi = np.where(rs.random(N) < 0.8, het_medium, -1)
    return mi, o, d, t_max, rs.random(N, dtype=np.float32)


def _close(got, ref, names):
    for k in names:
        g = got[k] if isinstance(got, dict) else getattr(got, k)
        r = ref[k] if isinstance(ref, dict) else getattr(ref, k)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=k,
                                   **TOL)


def test_seed_keys_are_jax_keys():
    seeds = np.random.default_rng(0).integers(0, 2**32, 64, dtype=np.uint64)
    seeds = np.concatenate([seeds, [0, 1, 2**31, 2**32 - 1]]).astype(
        np.uint32)
    ref = jax.random.key_data(jax.vmap(jax.random.key)(jnp.asarray(seeds)))
    got = rng.seed_keys(torch.from_numpy(seeds.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    u = np.random.default_rng(1).random(64, dtype=np.float32)
    np.testing.assert_array_equal(
        rng.float_bits(torch.from_numpy(u)).numpy(), u.view(np.uint32))


def test_het_sigma_t(het):
    js, sc = het
    p = np.random.default_rng(2).uniform(-0.1, 1.1, (4096, 3)).astype(
        np.float32)
    ref = np.asarray(jax.jit(jmed.het_sigma_t)(js, p))
    got = medium.het_sigma_t(sc, torch.from_numpy(p)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    assert (ref == 0).all(-1).mean() > 0.05 and (ref > 0).all(-1).mean() > 0.5


@pytest.mark.parametrize("keyed", [True, False])
def test_het_tracking(het, keyed):
    js, sc = het
    _, o, d, t_max, u = _rays(3, js.het_medium)
    jk = jmed._het_keys(jax.random.key(7) if keyed else None, u, N)
    tk = medium._het_keys(rng.key(7) if keyed else None,
                          torch.from_numpy(u), N)
    np.testing.assert_array_equal(tk.numpy(),
                                  np.asarray(jax.random.key_data(jk)))
    ref = jax.jit(jmed.het_track_sample)(js, o, d, t_max, jk)
    got = medium.het_track_sample(sc, torch.from_numpy(o),
                                  torch.from_numpy(d),
                                  torch.from_numpy(t_max), tk)
    np.testing.assert_array_equal(got["success"].numpy(),
                                  np.asarray(ref["success"]))
    assert 0.1 < got["success"].numpy().mean() < 0.9
    _close(got, ref, ("t", "w_null", "pdf_real", "sigma_t_x"))
    ref_tr = jax.jit(jmed.het_transmittance)(js, o, d, t_max, jk)
    got_tr = medium.het_transmittance(sc, torch.from_numpy(o),
                                      torch.from_numpy(d),
                                      torch.from_numpy(t_max), tk)
    np.testing.assert_allclose(got_tr.numpy(), np.asarray(ref_tr), **TOL)
    assert 0.05 < float(got_tr.mean()) < 0.95


@pytest.mark.parametrize("strategy,keyed", [
    (medium.NORMAL, False), (medium.NORMAL, True),
    (medium.ALWAYS_VALID, False), (medium.ALWAYS_VALID, True)])
def test_het_sample_distance(het, strategy, keyed):
    """Lanes in the heterogeneous medium tracked, vacuum lanes by the
    closed form; NORMAL with some unbounded segments (t_max inf)."""
    js, sc = het
    mi, o, d, t_max, u = _rays(4, js.het_medium,
                               0.2 if strategy == medium.NORMAL else 0.0)
    ref = jax.jit(jmed.sample_distance, static_argnames=("strategy",))(
        js, jnp.asarray(mi, jnp.int32), o, d, t_max, u, strategy=strategy,
        key=jax.random.key(9) if keyed else None)
    got = medium.sample_distance(
        sc, torch.from_numpy(mi), torch.from_numpy(o), torch.from_numpy(d),
        torch.from_numpy(t_max), torch.from_numpy(u), strategy=strategy,
        key=rng.key(9) if keyed else None)
    np.testing.assert_array_equal(got.success.numpy(),
                                  np.asarray(ref.success))
    assert 0.1 < got.success.numpy()[mi >= 0].mean()
    _close(got, ref, ("t", "p", "transmittance", "pdf_success",
                      "pdf_failure", "sigma_s"))


@pytest.mark.parametrize("keyed", [True, False])
def test_het_transmittance_branch(het, keyed):
    js, sc = het
    mi, o, d, t_max, _ = _rays(5, js.het_medium)
    ref = jax.jit(jmed.transmittance)(
        js, jnp.asarray(mi, jnp.int32), t_max, o, d,
        jax.random.key(11) if keyed else None)
    got = medium.transmittance(sc, torch.from_numpy(mi),
                               torch.from_numpy(t_max), torch.from_numpy(o),
                               torch.from_numpy(d),
                               rng.key(11) if keyed else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # without o / d the closed form of the medium's table row stands in
    ref = jax.jit(jmed.transmittance)(js, jnp.asarray(mi, jnp.int32), t_max)
    got = medium.transmittance(sc, torch.from_numpy(mi),
                               torch.from_numpy(t_max))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def test_het_segment_transmittance(het):
    """Shadow segments inside the fog (no boundary crossed): the port's
    segment_transmittance against the JAX package's ratio tracking fed
    the port's segment geometry (origin moved by SEG_EPS, length, keys
    from the bit pattern of length + 0.12345, as visibility.py derives
    them). The JAX package's own jitted segment_transmittance fuses the
    length's arithmetic and moves it by an ulp on some lanes, which
    draws another stream there (ROADMAP.md section 3: 6.6% of such
    lanes between its own jitted and eager results), so the whole
    function is not compared lane for lane."""
    from gvpm_tpu_torch.render import visibility
    js, sc = het
    rs = np.random.default_rng(6)
    a = torch.from_numpy(rs.uniform(0.05, 0.95, (N, 3)).astype(np.float32))
    b = torch.from_numpy(rs.uniform(0.05, 0.95, (N, 3)).astype(np.float32))
    mi = torch.full((N,), js.het_medium)
    got = visibility.segment_transmittance(sc, a, b, mi)
    seg = b - a
    dist = torch.sqrt(torch.clamp((seg * seg).sum(-1), min=1e-20))
    d = seg / dist[:, None]
    o = (a + d * visibility.SEG_EPS).numpy()
    keys = jmed._het_keys(None, (dist + 0.12345).numpy(), N)
    ref = jax.jit(jmed.het_transmittance)(js, o, d.numpy(), dist.numpy(),
                                          keys)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert 0.05 < float(got.mean()) < 0.95
