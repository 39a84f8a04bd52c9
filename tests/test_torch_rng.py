"""Bit equality of the port's threefry2x32 (gvpm_tpu_torch.core.rng)
with jax.random in jax_threefry_partitionable mode (tests/conftest.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvpm_tpu.core import rng as jrng
from gvpm_tpu_torch.core import rng


def _words(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 5, 123456789, -7])
def test_key(seed):
    np.testing.assert_array_equal(rng.key(seed).numpy(),
                                  _words(jax.random.key(seed)))


@pytest.mark.parametrize("data", [0, 1, 77, 2**31 - 1])
def test_fold_in(data):
    k = jax.random.key(11)
    np.testing.assert_array_equal(rng.fold_in(rng.key(11), data).numpy(),
                                  _words(jax.random.fold_in(k, data)))


def test_fold_in_batched_lanes():
    lanes = np.arange(0, 3000, 7, dtype=np.int32)
    k = jax.random.key(3)
    ref = np.stack([_words(jax.random.fold_in(k, int(i))) for i in lanes[:5]])
    got = rng.fold_in(rng.key(3), torch.from_numpy(lanes)).numpy()
    np.testing.assert_array_equal(got[:5], ref)


@pytest.mark.parametrize("num", [2, 3, 18])
def test_split(num):
    k = jax.random.fold_in(jax.random.key(9), 4)
    got = rng.split(rng.fold_in(rng.key(9), 4), num).numpy()
    np.testing.assert_array_equal(got, _words(jax.random.split(k, num)))


@pytest.mark.parametrize("shape", [(), (1,), (1000,), (257, 2), (64, 3)])
def test_uniform(shape):
    k = jax.random.fold_in(jax.random.key(2), 8)
    ref = np.asarray(jax.random.uniform(k, shape))
    got = rng.uniform(rng.fold_in(rng.key(2), 8), shape).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


def test_pass_key():
    for seed, it, stream in ((0, 0, 0), (5, 11, 2), (7, 3, 1)):
        np.testing.assert_array_equal(
            rng.pass_key(seed, it, stream).numpy(),
            _words(jrng.pass_key(seed, it, stream)))


@pytest.mark.parametrize("suffix", [(), (2,), (3,)])
def test_lane_uniform(suffix):
    lanes = np.arange(0, 4096, 13, dtype=np.int32)
    k = jrng.pass_key(1, 2, jrng.STREAM_CAMERA)
    ref = np.asarray(jrng.lane_uniform(k, jnp.asarray(lanes), suffix))
    got = rng.lane_uniform(rng.pass_key(1, 2, rng.STREAM_CAMERA),
                           torch.from_numpy(lanes).long(), suffix).numpy()
    np.testing.assert_array_equal(got, ref)
