"""Deterministic PRNG: a bit-exact threefry2x32 port of ``jax.random``.

Mirrors gvpm_tpu/core/rng.py. Every sample is keyed by (seed, pass,
stream, index) through threefry fold_in, so the port draws the SAME
random numbers as the JAX package (in ``jax_threefry_partitionable``
mode) and every stage can be compared element by element.

A key is an int64 tensor of shape [..., 2] holding two uint32 words.
The arithmetic runs in int64 with ``& 0xFFFFFFFF`` masks (torch's
uint32 coverage is thin). There is no global generator: keys are
passed down the call chain exactly as in JAX.
"""

from __future__ import annotations

import torch

# Stream ids of the consumers ported so far — the same stable namespace
# as gvpm_tpu/core/rng.py, so adding a consumer never perturbs others.
STREAM_CAMERA = 0
STREAM_LIGHT = 1
STREAM_GATHER = 2

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, d):
    return ((x << d) & M32) | (x >> (32 - d))


def threefry2x32(k1, k2, x0, x1):
    """Threefry-2x32 (20 rounds) on broadcastable int64 word tensors."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def key(seed, device="cpu"):
    """jax.random.key(seed) for an int32 seed: words (0, seed)."""
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64,
                        device=device)


def fold_in(k, data):
    """jax.random.fold_in; `data` is an int or an int tensor (batched)."""
    if not torch.is_tensor(data):
        data = torch.tensor(int(data), dtype=torch.int64, device=k.device)
    data = data.to(torch.int64) & M32
    k1, k2 = k[..., 0], k[..., 1]
    if data.dim() > 0:
        k1, k2 = k1[..., None], k2[..., None]
    y0, y1 = threefry2x32(k1, k2, torch.zeros_like(data), data)
    return torch.stack([y0, y1], dim=-1)


def split(k, num=2):
    """jax.random.split (partitionable form) -> [num, 2]."""
    i = torch.arange(num, dtype=torch.int64, device=k.device)
    y0, y1 = threefry2x32(k[0], k[1], torch.zeros_like(i), i)
    return torch.stack([y0, y1], dim=-1)


def _bits(k, shape):
    """32-bit random words of `shape`; k may carry batch dims [..., 2]."""
    n = 1
    for s in shape:
        n *= s
    i = torch.arange(n, dtype=torch.int64, device=k.device)
    k1, k2 = k[..., 0, None], k[..., 1, None]
    b0, b1 = threefry2x32(k1, k2, torch.zeros_like(i), i)
    return (b0 ^ b1).reshape(k.shape[:-1] + tuple(shape))


def _to_unit(bits):
    fb = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return torch.clamp(fb.view(torch.float32) - 1.0, min=0.0)


def uniform(k, shape=()):
    """jax.random.uniform(k, shape) in [0, 1), float32."""
    return _to_unit(_bits(k, shape))


def counter_uniform(k1, k2, ctr):
    """The uniform float that jax.random.uniform(key, shape) draws at
    flat position `ctr` of its shape (< 2^32): words b0 ^ b1 of
    threefry2x32(key, (0, ctr)). k1, k2, ctr: broadcastable int64."""
    b0, b1 = threefry2x32(k1, k2, torch.zeros_like(ctr), ctr)
    return _to_unit(b0 ^ b1)


def pass_key(seed, it, stream, device="cpu"):
    """Key for (global seed, progressive pass index, consumer stream)."""
    return fold_in(fold_in(key(seed, device), it), stream)


def lane_uniform(k, lanes, suffix=()):
    """Uniform draws keyed by (key, lane id) — [len(lanes), *suffix];
    invariant to the lane's position in the batch."""
    return uniform(fold_in(k, lanes), suffix)
