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
STREAM_NEE = 5

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k1, k2, x0, x1):
    """Threefry-2x32 (20 rounds) on broadcastable int64 word tensors.
    The rounds update two words tensors in place (a third of the
    temporaries of the plain expressions)."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    shape = torch.broadcast_shapes(k1.shape, k2.shape, x0.shape, x1.shape)
    x0 = ((x0 + ks[0]) & M32).expand(shape).contiguous()
    x1 = ((x1 + ks[1]) & M32).expand(shape).contiguous()
    t = torch.empty_like(x1)
    for i in range(5):
        for r in _ROT[i % 2]:
            x0.add_(x1).bitwise_and_(M32)
            # x1 = rotl(x1, r) ^ x0
            torch.bitwise_left_shift(x1, r, out=t)
            t.bitwise_and_(M32)
            x1.bitwise_right_shift_(32 - r).bitwise_or_(t).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(M32)
        x1.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(M32)
    return x0, x1


def key(seed, device="cpu"):
    """jax.random.key(seed) for an int32 seed: words (0, seed)."""
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64,
                        device=device)


def seed_keys(seeds):
    """jax.random.key(s) for each uint32 seed of a tensor: words
    (0, s) -> [..., 2] (threefry_seed: the high word of a 32-bit seed is
    its logical shift by 32, i.e. 0)."""
    seeds = seeds.to(torch.int64) & M32
    return torch.stack([torch.zeros_like(seeds), seeds], dim=-1)


def float_bits(x):
    """The bit pattern of float32 values as non-negative int64 words
    (lax.bitcast_convert_type(x, uint32))."""
    return x.to(torch.float32).contiguous().view(torch.int32).to(
        torch.int64) & M32


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


def randint(k, shape, minval, maxval):
    """jax.random.randint(k, shape, minval, maxval) for int32 bounds
    (0 <= maxval - minval < 2^31): two words a draw, from the two halves
    of split(k), reduced as the JAX package's _randint does."""
    k1, k2 = split(k, 2)
    hi, lo = _bits(k1, shape), _bits(k2, shape)
    span = max(int(maxval) - int(minval), 1)
    mult = ((2 ** 16 % span) ** 2) % span
    off = (((hi % span) * mult) & M32) + (lo % span)
    return minval + (off & M32) % span


# words a chunk of the [n, L] Gumbel draw of `categorical`: large on the
# card (few launches); on the CPU a chunk whose int64 temporaries stay in
# cache (1 << 16 words draw 8.7x faster than 1 << 22 on one thread)
_CAT_CHUNK = 1 << 22
_CAT_CHUNK_CPU = 1 << 16


def categorical(k, logits, n):
    """jax.random.categorical(k, logits, shape=(n,)) for float32 logits
    [L]: argmax over L of logits + Gumbel noise, the noise drawn as
    jax.random.gumbel(k, (n, L)) (its "low" mode: uniform in [tiny, 1)).
    Rows are drawn in chunks; each word is the one at its flat position
    of the [n, L] draw."""
    L = logits.shape[0]
    tiny = torch.finfo(torch.float32).tiny
    out = []
    chunk = _CAT_CHUNK if logits.is_cuda else _CAT_CHUNK_CPU
    rows = max(1, chunk // max(L, 1))
    col = torch.arange(L, dtype=torch.int64, device=logits.device)
    for r0 in range(0, n, rows):
        r = torch.arange(r0, min(n, r0 + rows), dtype=torch.int64,
                         device=logits.device)
        u = counter_uniform(k[0], k[1], r[:, None] * L + col[None, :])
        g = -torch.log(-torch.log(torch.clamp(u + tiny, min=tiny)))
        out.append(torch.argmax(g + logits[None, :], dim=-1))
    return torch.cat(out)


def pass_key(seed, it, stream, device="cpu"):
    """Key for (global seed, progressive pass index, consumer stream)."""
    return fold_in(fold_in(key(seed, device), it), stream)


def lane_uniform(k, lanes, suffix=()):
    """Uniform draws keyed by (key, lane id) — [len(lanes), *suffix];
    invariant to the lane's position in the batch."""
    return uniform(fold_in(k, lanes), suffix)
