"""The port's Metropolis family (gvpm_tpu_torch/integrators/pssmlt.py,
mlt.py, erpt.py) against gvpm_tpu's on the 12x12 cornell box of
tests/test_more_integrators.py (max_depth 5, null_bounces 2):

- the mutations (Kelemen small step, lens, chain) on the same states and
  keys: every word that takes no transcendental function bit-equal, the
  rest within 2 ulp of the largest operand (XLA's float32 exp / cos /
  sin differ from PyTorch's in the last bit for a few percent of
  arguments, and u - step cancels; ROADMAP section 3), with the
  differing words counted (55 / 6 / 12 of 20224);
- the new rng draws (randint, categorical) bit-equal;
- f(u), volpath driven by an explicit primary sample (u_explicit), at
  volpath's bar, and the bootstrap (b, the initial states) exact;
- the acceptance decisions of one step of 256 chains, the lanes that
  differ counted (0 measured; a last-bit change of f(u) near a
  threshold would flip one);
- the chains of each method from the same initial states, against the
  JAX package's mutations and f(u) in a copy of its chain loops
  (`_jax_chains`, which reuses the jitted f(u) where each method's
  scan would compile for ~10 s): the image's mean at rtol 1e-4, pixels
  beyond rtol 1e-4 / atol 1e-5 counted and held to 5% (0 measured)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvpm_tpu.core.config import VolPathConfig as JaxVolPathConfig
from gvpm_tpu.integrators import mlt as jmlt
from gvpm_tpu.integrators import pssmlt as jpssmlt
from gvpm_tpu_torch.core import rng
from gvpm_tpu_torch.core.config import VolPathConfig
from gvpm_tpu_torch.integrators import erpt, mlt, pssmlt
from tests.test_more_integrators import _box
from tests.test_torch_common import (port_scene_from_jax,  # noqa: F401
                                     torch_threads)

KW = dict(spp=1, max_depth=5, null_bounces=2)
N_STEPS = KW["max_depth"] + KW["null_bounces"]
N_CHAINS = 256     # = N_BOOT: the chains reuse the jitted f(u)
N_BOOT = 256


@pytest.fixture(scope="module")
def box():
    """(JAX scene, port scene, JAX f(u) jitted for N_BOOT lanes)."""
    js = _box()
    jf = jax.jit(lambda u: jpssmlt._f_eval(js, JaxVolPathConfig(**KW), u))
    return js, port_scene_from_jax(js), jf


@pytest.fixture(scope="module")
def boot(box):
    """The bootstrap of both packages from pssmlt.render's keys: the
    primary samples, their luminance and the picked initial states."""
    js, ts, jf = box
    seed = 0 + 0x9E3779B9 % (1 << 30)
    jk_boot, jk_pick, jk_run = jax.random.split(jax.random.key(seed), 3)
    u_boot = jax.random.uniform(jk_boot, (N_BOOT, pssmlt.pss_dim(
        VolPathConfig(**KW))))
    want = [np.asarray(a) for a in jf(u_boot)]
    idx = np.asarray(jax.random.categorical(
        jk_pick, jnp.log(jnp.maximum(want[3], 1e-20)), shape=(N_CHAINS,)))
    k_boot, k_pick, k_run = rng.split(rng.key(seed), 3)
    b, u0 = pssmlt.bootstrap(ts, VolPathConfig(**KW), k_boot, k_pick,
                             N_BOOT, N_CHAINS)
    return dict(u_boot=np.asarray(u_boot), want=want, idx=idx, b=b,
                u0=u0, jk_run=jk_run, k_run=k_run)


def _mutations(u, k, W):
    """(name, JAX mutation, port mutation) of each kernel."""
    ju, tu = jnp.asarray(u), torch.tensor(u)
    jk, tk = jax.random.key(k), rng.key(k)
    return (("small", jpssmlt._mutate_small(ju, jk),
             pssmlt._mutate_small(tu, tk)),
            ("lens", jmlt._mutate_lens(ju, jk, W, W),
             mlt._mutate_lens(tu, tk, W, W)),
            ("chain", jmlt._mutate_chain(ju, jk, N_STEPS),
             mlt._mutate_chain(tu, tk, N_STEPS)))


def test_mutations_match_jax_to_the_last_bit():
    u = np.random.default_rng(4).uniform(
        0, 1, (256, pssmlt.pss_dim(VolPathConfig(**KW)))).astype(np.float32)
    counts = {}
    for name, want, got in _mutations(u, 5, 12):
        want, got = np.asarray(want), got.numpy()
        assert got.shape == want.shape and (got >= 0).all() \
            and (got < 1).all(), name
        # the step's last bit: within 2 ulp of the largest operand
        ulp = np.spacing(np.maximum(np.maximum(want, got), u))
        assert (np.abs(got - want) <= 2 * ulp).all(), name
        counts[name] = int((got != want).sum())
        assert counts[name] <= 0.01 * got.size, (name, counts[name])
        moved = want != u
        if name == "lens":       # only the film dims move
            assert not moved[:, 2:].any()
            np.testing.assert_array_equal(got[:, 2:], u[:, 2:])
        if name == "chain":      # the dims of one step block move
            blocks = moved[:, 2:].reshape(256, N_STEPS, -1).any(-1)
            assert (blocks.sum(-1) == 1).all()
            np.testing.assert_array_equal(got == u, want == u)


def test_randint_and_categorical_bit_equal():
    for lo, hi, shape in ((0, N_STEPS, (1000,)), (3, 40, (17, 9)),
                          (0, 1 << 20, (500,))):
        want = jax.random.randint(jax.random.key(hi), shape, lo, hi)
        got = rng.randint(rng.key(hi), shape, lo, hi)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    logits = np.log(np.random.default_rng(1).uniform(
        0, 1, 700).astype(np.float32) + 1e-3)
    want = jax.random.categorical(jax.random.key(2), jnp.asarray(logits),
                                  shape=(300,))
    got = rng.categorical(rng.key(2), torch.tensor(logits), 300)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_f_eval_and_bootstrap_match_jax(box, boot):
    """f(u) on the bootstrap's primary samples (drawn bit-equal), and the
    bootstrap's b and picked states."""
    _, ts, _ = box
    u_boot = rng.uniform(rng.split(rng.key(0 + 0x9E3779B9 % (1 << 30)),
                                   3)[0], tuple(boot["u_boot"].shape))
    np.testing.assert_array_equal(u_boot.numpy(), boot["u_boot"])
    Y, px, py, lum = pssmlt._f_eval(ts, VolPathConfig(**KW), u_boot)
    want = boot["want"]
    np.testing.assert_array_equal(px.numpy(), want[1])
    np.testing.assert_array_equal(py.numpy(), want[2])
    np.testing.assert_allclose(Y.numpy(), want[0], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(lum.numpy(), want[3], rtol=1e-4, atol=1e-5)
    assert (lum > 0).sum() > N_BOOT // 4
    assert boot["b"] == pytest.approx(float(want[3].mean()), rel=1e-5)
    np.testing.assert_array_equal(boot["u0"].numpy(),
                                  boot["u_boot"][boot["idx"]])


def test_acceptance_of_one_step_matches_jax(box, boot):
    """One pssmlt step of every bootstrap sample as a chain: the small
    mutation, f(u') and the test u < min(1, lum'/lum) on both sides."""
    js, ts, jf = box
    u = boot["u_boot"]
    prop = pssmlt._mutate_small(torch.tensor(u), rng.key(11))
    lum_p = pssmlt._f_eval(ts, VolPathConfig(**KW), prop)[3].numpy()
    want_p = np.asarray(jf(jnp.asarray(prop.numpy()))[3])
    u_acc = rng.uniform(rng.key(12), (N_BOOT,)).numpy()
    lum = boot["want"][3]

    def accept(lum, lum_p):
        a = np.clip(lum_p / np.maximum(lum, 1e-12), 0.0, 1.0)
        return u_acc < np.where(lum <= 0.0, 1.0, a)

    flips = int((accept(lum, lum_p) != accept(lum, want_p)).sum())
    assert flips <= 0.01 * N_BOOT, flips
    assert accept(lum, lum_p).any() and not accept(lum, lum_p).all()


def _jax_chains(jf, u0, key, n_mut, propose, a_dead=1.0, quantum=None):
    """The chain loop of the JAX package's pssmlt._run_chains /
    mlt._run_chains / erpt._redistribute, step for step, on its jitted f(u) (`jf`, already
    compiled for these lanes) instead of a scan compiled per method:
    propose(u, k) -> (k_acc, u'). Returns the image."""
    from gvpm_tpu.render import film as jfilm
    u = u0
    Y, px, py, lum = jf(u)
    img = jfilm.new_film(12, 12)
    for k in jax.random.split(key, n_mut):
        k_acc, u_prop = propose(u, k)
        Yp, pxp, pyp, lump = jf(u_prop)
        a = jnp.clip(lump / jnp.maximum(lum, 1e-12), 0.0, 1.0)
        a = jnp.where(lum <= 0.0, a_dead, a)
        num_cur, num_prop = (1.0 - a, a) if quantum is None \
            else (quantum * (1.0 - a), quantum * a)
        w_cur = num_cur / jnp.maximum(lum, 1e-12)
        w_prop = num_prop / jnp.maximum(lump, 1e-12)
        img = jfilm.splat(img, px, py, Y * w_cur[:, None], mask=lum > 0)
        img = jfilm.splat(img, pxp, pyp, Yp * w_prop[:, None],
                          mask=lump > 0)
        acc = jax.random.uniform(k_acc, (u.shape[0],)) < a
        u = jnp.where(acc[:, None], u_prop, u)
        Y = jnp.where(acc[:, None], Yp, Y)
        px, py = jnp.where(acc, pxp, px), jnp.where(acc, pyp, py)
        lum = jnp.where(acc, lump, lum)
    return img


def _mlt_proposal(u, k):
    """jmlt._run_chains's kernel mixture."""
    k_sel, k_l, k_lens, k_chain, k_small, k_acc = jax.random.split(k, 6)
    sel = jax.random.uniform(k_sel, (u.shape[0],))[:, None]
    u_prop = jnp.where(
        sel < jmlt.P_LARGE, jax.random.uniform(k_l, u.shape),
        jnp.where(sel < jmlt.P_LARGE + jmlt.P_LENS,
                  jmlt._mutate_lens(u, k_lens, 12, 12),
                  jnp.where(sel < jmlt.P_LARGE + jmlt.P_LENS + jmlt.P_CHAIN,
                            jmlt._mutate_chain(u, k_chain, N_STEPS),
                            jpssmlt._mutate_small(u, k_small))))
    return k_acc, u_prop


def _pssmlt_proposal(u, k):
    """jpssmlt._run_chains's large / small mixture (p_large 0.3)."""
    k_sel, k_large, k_small, k_acc = jax.random.split(k, 4)
    large = jax.random.uniform(k_sel, (u.shape[0],)) < 0.3
    return k_acc, jnp.where(large[:, None], jax.random.uniform(k_large,
                                                                u.shape),
                            jpssmlt._mutate_small(u, k_small))


def _erpt_proposal(u, k):
    """jerpt._redistribute's small step."""
    k_small, k_acc = jax.random.split(k)
    return k_acc, jpssmlt._mutate_small(u, k_small)


@pytest.mark.parametrize("method", ("pssmlt", "mlt", "erpt"))
def test_chains_match_jax_by_mean(box, boot, method):
    """6 mutations of the bootstrap's chains from the same states and
    keys, against the JAX package's mutations and f(u) in its chain loop
    (`_jax_chains`); erpt with its equal-deposition quantum b / (chains x
    mutations)."""
    js, ts, jf = box
    n_mut = 6
    u0 = boot["u0"]
    ju0 = jnp.asarray(u0.numpy())
    cfg = VolPathConfig(**KW)
    stats = []
    if method == "pssmlt":
        want = _jax_chains(jf, ju0, boot["jk_run"], n_mut, _pssmlt_proposal)
        got = pssmlt._run_chains(ts, cfg, u0, n_mut, 0.3, boot["k_run"],
                                 stats=stats)
    elif method == "mlt":
        want = _jax_chains(jf, ju0, boot["jk_run"], n_mut, _mlt_proposal)
        got = mlt._run_chains(ts, cfg, u0, n_mut, boot["k_run"],
                              stats=stats)
    else:
        e_d = boot["b"] / (N_CHAINS * n_mut)
        want = _jax_chains(jf, ju0, boot["jk_run"], n_mut, _erpt_proposal,
                           a_dead=0.0, quantum=e_d)
        got = erpt._redistribute(ts, cfg, u0, e_d, n_mut, boot["k_run"],
                                 stats=stats)
    want, got = np.asarray(want), got.numpy()
    assert got.shape == (12, 12, 3) and np.isfinite(got).all()
    assert got.mean() > 0 and len(stats) == n_mut
    assert 0 < sum(int(s) for s in stats) < N_CHAINS * n_mut
    np.testing.assert_allclose(got.mean(), want.mean(), rtol=1e-4)
    bad = ~np.isclose(got, want, rtol=1e-4, atol=1e-5)
    assert bad.mean() <= 0.05, (int(bad.sum()),
                                float(np.abs(got - want).max()))


def test_renders_run_and_normalize(box):
    """The entry points: bootstrap, chains and the b normalization."""
    _, ts, _ = box
    for render in (pssmlt.render, mlt.render, erpt.render):
        img = render(ts, VolPathConfig(**KW), seed=1, n_chains=16,
                     n_mutations=2)
        assert img.shape == (12, 12, 3) and bool(torch.isfinite(img).all())
        assert float(img.mean()) > 0, render
