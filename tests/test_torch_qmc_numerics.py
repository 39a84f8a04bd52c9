"""The port's QMC samplers (gvpm_tpu_torch/core/qmc.py) bit-equal to
gvpm_tpu.core.qmc on the same indices, its numerics
(gvpm_tpu_torch/core/numerics.py) at rtol 1e-6 against
gvpm_tpu.core.numerics on tests/test_numerics.py's cases (vmf_for_peak,
a 40-step Brent inversion, at 1e-5). volpath.render draws its pixel
samples through qmc.pixel_samples (cfg.sampler), as before the samplers
were ported; tests/test_torch_volpath.py renders with the Sobol' one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvpm_tpu.core import numerics as jnm
from gvpm_tpu.core import qmc as jqmc
from gvpm_tpu_torch.core import numerics as nm
from gvpm_tpu_torch.core import qmc, rng
from tests.test_torch_common import torch_threads  # noqa: F401

RNG = np.random.default_rng(13)
PIX = RNG.integers(0, 1 << 20, 512)
SI = RNG.integers(0, 1 << 12, 512)


def _bits(a):
    return np.asarray(a).view(np.uint32)


def _same(got, want):
    """Bit-equal float32 arrays, or equal integer words."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if want.dtype.kind == "f":
        np.testing.assert_array_equal(_bits(got), _bits(want))
    else:
        np.testing.assert_array_equal(got.astype(np.int64) & 0xFFFFFFFF,
                                      want.astype(np.int64) & 0xFFFFFFFF)


@pytest.mark.parametrize("sampler", qmc.SAMPLERS)
def test_pixel_samples_bit_equal(sampler):
    want = jqmc.pixel_samples(sampler, jax.random.key(3),
                              jnp.asarray(PIX, jnp.int32),
                              jnp.asarray(SI, jnp.int32), 64)
    got = qmc.pixel_samples(sampler, rng.key(3), torch.tensor(PIX),
                            torch.tensor(SI), 64)
    _same(got.numpy(), want)


def test_bit_primitives_bit_equal():
    words = RNG.integers(0, 1 << 32, 2048, dtype=np.uint64).astype(np.uint32)
    tw = torch.tensor(words.astype(np.int64))
    _same(qmc.reverse_bits32(tw).numpy(), jqmc.reverse_bits32(words))
    _same(qmc._hash_u32(tw).numpy(), jqmc._hash_u32(words))
    _same(qmc.owen_scramble_bits(tw, tw ^ 0x1234).numpy(),
          jqmc.owen_scramble_bits(words, words ^ np.uint32(0x1234)))
    _same(qmc._bits_to_unit(tw).numpy(), jqmc._bits_to_unit(words))
    assert (qmc._SOBOL_V == jqmc._sobol_matrices().astype(np.int64)).all()


@pytest.mark.parametrize("base", (2, 3, 7, 131))
def test_radical_inverse_and_halton_bit_equal(base):
    i = RNG.integers(0, 1 << 32, 1024, dtype=np.uint64).astype(np.uint32)
    _same(qmc.radical_inverse(base, torch.tensor(i.astype(np.int64))),
          jqmc.radical_inverse(base, i))
    dim = jqmc.PRIMES.index(base)
    off = np.uint32(977)
    _same(qmc.halton(dim, torch.tensor(SI), 977),
          jqmc.halton(dim, jnp.asarray(SI, jnp.int32), off))
    _same(qmc.hammersley(dim, torch.tensor(SI), 4096),
          jqmc.hammersley(dim, jnp.asarray(SI, jnp.int32), 4096))


def test_sobol_every_dimension_bit_equal():
    dims = np.arange(32)[:, None]
    idx = SI[None, :64]
    seed = (PIX[None, :64] * 7 + dims) & 0xFFFFFFFF
    _same(qmc.sobol(torch.tensor(dims), torch.tensor(idx),
                    torch.tensor(seed)),
          jqmc.sobol(jnp.asarray(dims), jnp.asarray(idx, jnp.uint32),
                     jnp.asarray(seed, jnp.uint32)))
    _same(qmc.sobol(torch.tensor(dims), torch.tensor(idx)),
          jqmc.sobol(jnp.asarray(dims), jnp.asarray(idx, jnp.uint32)))
    _same(qmc.ld_2d(torch.tensor(SI), torch.tensor(PIX)),
          jqmc.ld_2d(jnp.asarray(SI, jnp.int32), jnp.asarray(PIX, jnp.int32)))
    _same(qmc.stratified_2d(rng.key(9), torch.tensor(SI), 50),
          jqmc.stratified_2d(jax.random.key(9), jnp.asarray(SI, jnp.int32),
                             50))


# -------------------------------------------------------------- numerics

def _close(got, want):
    """rtol 1e-6; atol 2.5e-7 (2 ulp of 1.0) for the values that cancel
    to near 0 (vmf_sample's 1 + log1p(.)/kappa around cos 0)."""
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6,
                               atol=2.5e-7)


def test_catmull_rom_matches_jax():
    nodes = np.array([0.0, 0.7, 1.5, 2.2, 3.0], np.float32)
    vals = np.array([1.0, -0.5, 2.0, 0.3, 1.2], np.float32)
    x = np.linspace(-0.2, 3.2, 41).astype(np.float32)
    i_w, w_w = jnm.catmull_rom_weights(jnp.asarray(nodes), jnp.asarray(x))
    i_g, w_g = nm.catmull_rom_weights(torch.tensor(nodes), torch.tensor(x))
    np.testing.assert_array_equal(i_g.numpy(), np.asarray(i_w))
    _close(w_g, w_w)
    _close(nm.eval_catmull_rom(torch.tensor(nodes), torch.tensor(vals),
                               torch.tensor(x)),
           jnm.eval_catmull_rom(jnp.asarray(nodes), jnp.asarray(vals),
                                jnp.asarray(x)))
    _close(nm.eval_catmull_rom(torch.tensor(nodes), torch.tensor(vals),
                               torch.tensor(nodes)), vals)


@pytest.mark.parametrize("n", (4, 8, 16))
def test_gauss_legendre_matches_jax(n):
    x_w, w_w = jnm.gauss_legendre(n)
    x_g, w_g = nm.gauss_legendre(n)
    _close(x_g, x_w)
    _close(w_g, w_w)
    assert abs(float((w_g * x_g ** 6).sum()) - 2.0 / 7.0) < 1e-5
    _close(nm.integrate_gl(torch.sin, 0.0, np.pi, n=n),
           jnm.integrate_gl(jnp.sin, 0.0, jnp.pi, n=n))


def test_brent_matches_jax():
    c = np.array([0.25, 2.0, 9.0, 40.0], np.float32)
    x_w, ok_w = jnm.brent(lambda x: x * x - c, jnp.zeros(4),
                          jnp.full((4,), 10.0))
    tc = torch.tensor(c)
    x_g, ok_g = nm.brent(lambda x: x * x - tc, torch.zeros(4),
                         torch.full((4,), 10.0))
    _close(x_g, x_w)
    np.testing.assert_array_equal(ok_g.numpy(), np.asarray(ok_w))
    np.testing.assert_allclose(x_g[:3].numpy(), np.sqrt(c[:3]), rtol=1e-4)


def test_vmf_matches_jax():
    kappa = np.array([0.0, 1e-7, 0.5, 5.0, 40.0], np.float32)[:, None]
    mu = np.linspace(-1.0, 1.0, 33).astype(np.float32)[None, :]
    _close(nm.vmf_pdf(torch.tensor(kappa), torch.tensor(mu)),
           jnm.vmf_pdf(jnp.asarray(kappa), jnp.asarray(mu)))
    u = np.linspace(1e-4, 1.0 - 1e-4, 33).astype(np.float32)[None, :]
    _close(nm.vmf_sample(torch.tensor(kappa), torch.tensor(u)),
           jnm.vmf_sample(jnp.asarray(kappa), jnp.asarray(u)))
    peaks = np.array([0.5, 2.0, 10.0], np.float32)
    k_g = nm.vmf_for_peak(torch.tensor(peaks))
    np.testing.assert_allclose(k_g.numpy(),
                               np.asarray(jnm.vmf_for_peak(
                                   jnp.asarray(peaks))), rtol=1e-5)
    np.testing.assert_allclose(
        nm.vmf_pdf(k_g, torch.ones(3)).numpy(), peaks, rtol=1e-3)
