"""The random stream both sides draw from, in plain PyTorch: Threefry-2x32
with 20 rounds (Salmon et al., SC 2011) in the key-splitting scheme of
`jax.random` (partitionable threefry), which is how the program keys
every sample by (seed, pass, stream, index). A key is two uint32 words,
held in int64 with 32-bit masks.

The draws are the input both sides are handed, like a seed: the
reference works out from them again what the program derived.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

# the program's consumer streams (rng.STREAM_*)
STREAM_CAMERA, STREAM_LIGHT, STREAM_GATHER = 0, 1, 2


def _rotl(x, r):
    return ((x << r) & M32) | (x >> (32 - r))


def threefry(k1, k2, x0, x1):
    """Threefry-2x32 of the counter words (x0, x1) under key (k1, k2);
    int64 tensors that broadcast."""
    ks = (k1, k2, (k1 ^ k2 ^ 0x1BD11BDA) & M32)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def key(seed):
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64)


def fold_in(k, data):
    """The key of `k` folded with the int (or int64 tensor) `data`; a
    tensor gives a batch of keys [..., 2]."""
    data = torch.as_tensor(data, dtype=torch.int64) & M32
    y0, y1 = threefry(k[..., 0], k[..., 1], torch.zeros_like(data), data)
    return torch.stack([y0, y1], -1)


def split(k, num):
    """The `num` keys split from `k`, [num, 2]."""
    i = torch.arange(num, dtype=torch.int64, device=k.device)
    y0, y1 = threefry(k[0], k[1], torch.zeros_like(i), i)
    return torch.stack([y0, y1], -1)


def pass_key(seed, it, stream):
    return fold_in(fold_in(key(seed), it), stream)


def to_unit(bits):
    """Uniform float32 in [0, 1) from 32 random bits (the top 23 as the
    mantissa of a float in [1, 2), minus 1)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return torch.clamp(f - 1.0, min=0.0)


def at(k, ctr):
    """The uniform that a draw of any shape under key `k` holds at flat
    position `ctr` (an int64 tensor)."""
    b0, b1 = threefry(k[..., 0], k[..., 1], torch.zeros_like(ctr), ctr)
    return to_unit(b0 ^ b1)


def rows(k, lanes, width, lane_keyed=False):
    """[len(lanes), width] uniforms of the lanes' rows of a [n, width]
    draw under `k` (positional), or of a draw keyed by each lane's id
    (lane_keyed: the key folded with the lane, then a draw of `width`)."""
    lanes = lanes.to(torch.int64)
    j = torch.arange(width, dtype=torch.int64, device=lanes.device)
    if lane_keyed:
        return at(fold_in(k, lanes)[:, None, :], j[None, :])
    return at(k, lanes[:, None] * width + j[None, :])
