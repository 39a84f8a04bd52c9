"""Quasi-Monte-Carlo sequences (radical inverse, Halton / Hammersley,
Sobol', scrambled (0,2)-sequences) and the pixel samplers built on them
(mirrors gvpm_tpu/core/qmc.py; reference: libcore/qmc.cpp,
samplers/{halton,hammersley,sobol,ldsampler,stratified}.cpp).

Every generator is a pure function (dim, index, scramble) -> u in [0,1)
over whole tensors of indices, and per-pixel decorrelation is hash-based
Owen scrambling (Laine-Karras). The uint32 arithmetic runs in int64
masked to 32 bits, as core/rng.py does for threefry, so every sample is
bit-equal to the JAX package's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import rng

M32 = rng.M32

# first 32 primes: bases of the Halton sequence (qmc.cpp primeBase)
PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53,
          59, 61, 67, 71, 73, 79, 83, 89, 97, 101, 103, 107, 109, 113,
          127, 131)

SAMPLERS = ("independent", "stratified", "ld", "sobol", "halton",
            "hammersley")


def _u32(x):
    """An int tensor (or int) as non-negative int64 words mod 2^32."""
    return torch.as_tensor(x).to(torch.int64) & M32


def _mul32(a, c: int):
    """(a * c) mod 2^32 for words a < 2^32 and a constant c < 2^32, in
    16-bit halves so that no int64 product overflows."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def _bits_to_unit(bits):
    """uint32 bits -> float32 in [0,1) (top 24 bits, exactly
    representable)."""
    return (bits >> 8).to(torch.float32) * (2.0 ** -24)


def radical_inverse(base: int, i):
    """Radical inverse of integer index i in the given base
    (qmc.cpp radicalInverse); the digit loop is a static unroll."""
    i = _u32(i)
    n_digits = int(np.ceil(32.0 / np.log2(base))) + 1
    inv_base = 1.0 / base
    value = torch.zeros(i.shape, dtype=torch.float32, device=i.device)
    inv = torch.full(i.shape, inv_base, dtype=torch.float32,
                     device=i.device)
    for _ in range(n_digits):
        value = value + (i % base).to(torch.float32) * inv
        inv = inv * inv_base
        i = i // base
    return torch.clamp(value, max=1.0 - 1e-7)


def reverse_bits32(v):
    v = _u32(v)
    v = ((v >> 1) & 0x55555555) | ((v & 0x55555555) << 1)
    v = ((v >> 2) & 0x33333333) | ((v & 0x33333333) << 2)
    v = ((v >> 4) & 0x0F0F0F0F) | ((v & 0x0F0F0F0F) << 4)
    v = ((v >> 8) & 0x00FF00FF) | ((v & 0x00FF00FF) << 8)
    return ((v >> 16) | (v << 16)) & M32


def _hash_u32(x):
    """Finalizer-style integer hash (decorrelation for scrambles)."""
    x = _u32(x)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def owen_scramble_bits(bits, seed):
    """Hash-based Owen (nested uniform) scrambling of Sobol' bits
    (Laine-Karras hash)."""
    v = reverse_bits32(bits)
    v = (v + _u32(seed)) & M32
    for c in (0x6C50B47C, 0xB82F1E52, 0xC7AFE638, 0x8D22F6E6):
        v = v ^ _mul32(v, c)
    return reverse_bits32(v)


# Sobol' direction numbers (Joe-Kuo D6, new-joe-kuo-6.21201) for the first
# 32 dimensions: (degree, a, m...) per dimension above 0; dimension 0 is
# van der Corput.
_JOE_KUO = [
    (1, 0, (1,)),
    (2, 1, (1, 3)),
    (3, 1, (1, 3, 1)),
    (3, 2, (1, 1, 1)),
    (4, 1, (1, 1, 3, 3)),
    (4, 4, (1, 3, 5, 13)),
    (5, 2, (1, 1, 5, 5, 17)),
    (5, 4, (1, 1, 5, 5, 5)),
    (5, 7, (1, 1, 7, 11, 19)),
    (5, 11, (1, 1, 5, 1, 1)),
    (5, 13, (1, 1, 1, 3, 11)),
    (5, 14, (1, 3, 5, 5, 31)),
    (6, 1, (1, 3, 3, 9, 7, 49)),
    (6, 13, (1, 1, 1, 15, 21, 21)),
    (6, 16, (1, 3, 1, 13, 27, 49)),
    (6, 19, (1, 1, 1, 15, 7, 5)),
    (6, 22, (1, 3, 1, 15, 13, 25)),
    (6, 25, (1, 1, 5, 5, 19, 61)),
    (7, 1, (1, 3, 7, 11, 23, 15, 103)),
    (7, 4, (1, 3, 7, 13, 13, 15, 69)),
    (7, 7, (1, 1, 3, 13, 7, 35, 63)),
    (7, 8, (1, 3, 5, 9, 1, 25, 53)),
    (7, 14, (1, 3, 1, 13, 9, 35, 107)),
    (7, 19, (1, 3, 1, 5, 27, 61, 31)),
    (7, 21, (1, 1, 5, 11, 19, 41, 61)),
    (7, 28, (1, 3, 5, 3, 3, 13, 69)),
    (7, 31, (1, 1, 7, 13, 1, 19, 1)),
    (7, 32, (1, 3, 7, 5, 13, 19, 59)),
    (7, 37, (1, 1, 3, 9, 25, 29, 41)),
    (7, 41, (1, 3, 5, 13, 23, 1, 55)),
    (7, 42, (1, 3, 7, 3, 13, 59, 17)),
]


def _sobol_matrices(n_dims=32):
    """Direction-number matrix V[dim, bit] (uint32, MSB-aligned)."""
    V = np.zeros((n_dims, 32), np.uint64)
    V[0, :] = [1 << (31 - b) for b in range(32)]  # van der Corput
    for d in range(1, n_dims):
        s, a, m = _JOE_KUO[d - 1]
        v = np.zeros(32, np.uint64)
        for b in range(min(s, 32)):
            v[b] = np.uint64(m[b]) << np.uint64(31 - b)
        for b in range(s, 32):
            v[b] = v[b - s] ^ (v[b - s] >> np.uint64(s))
            for k in range(1, s):
                if (a >> (s - 1 - k)) & 1:
                    v[b] ^= v[b - k]
        V[d, :] = v
    return V.astype(np.uint32)


_SOBOL_V = _sobol_matrices().astype(np.int64)


def sobol_bits(dim, i):
    """Sobol' sample bits for dimension tensor `dim` and index tensor `i`
    (broadcast): the GF(2) matrix-vector product as a 32-step unroll."""
    i = _u32(i)
    dim = torch.as_tensor(dim, device=i.device)
    Vd = torch.as_tensor(_SOBOL_V, device=i.device)[dim.to(torch.int64)]
    res = torch.zeros(torch.broadcast_shapes(i.shape, dim.shape),
                      dtype=torch.int64, device=i.device)
    for b in range(32):
        res = torch.where(((i >> b) & 1) > 0, res ^ Vd[..., b], res)
    return res


def sobol(dim, i, scramble_seed=None):
    """Sobol' value in [0,1); optional per-lane Owen scrambling."""
    bits = sobol_bits(dim, i)
    if scramble_seed is not None:
        bits = owen_scramble_bits(bits, scramble_seed)
    return _bits_to_unit(bits)


def halton(dim: int, i, offset=0):
    """Halton value: the radical inverse in the dim-th prime base of the
    index shifted by `offset` (halton.cpp's per-pixel index offsets)."""
    return radical_inverse(PRIMES[dim % len(PRIMES)], _u32(i) + offset)


def hammersley(dim: int, i, n):
    """Hammersley point set of size n: the first dim is (i + 1/2) / n."""
    if dim == 0:
        return (torch.as_tensor(i).to(torch.float32) + 0.5) / n
    return halton(dim - 1, i)


def ld_2d(i, seed):
    """Scrambled (0,2)-sequence pair (ldsampler.cpp analog): Sobol' dims
    0, 1 with independent Owen scrambles per seed lane."""
    s0 = _hash_u32(seed)
    s1 = _hash_u32(s0 ^ 0x9E3779B9)
    x = _bits_to_unit(owen_scramble_bits(sobol_bits(0, i), s0))
    y = _bits_to_unit(owen_scramble_bits(sobol_bits(1, i), s1))
    return torch.stack([x, y], dim=-1)


def stratified_2d(key, index, n_total):
    """Stratified jittered 2D samples: index in [0, n_total) over an
    sx*sy grid with sx = ceil(sqrt(n)) (stratified.cpp analog). `key`
    is one key [2] or one per lane [..., 2]."""
    sx = int(math.ceil(math.sqrt(n_total)))
    sy = int(math.ceil(n_total / sx))
    ix = (index % sx).to(torch.float32)
    iy = (index // sx).to(torch.float32)
    u = rng.uniform(key, (2,) if key.dim() > 1 else tuple(ix.shape) + (2,))
    return torch.stack([(ix + u[..., 0]) / sx, (iy + u[..., 1]) / sy],
                       dim=-1)


def pixel_samples(sampler: str, key, pixel_index, sample_index, spp):
    """Per-pixel 2D sample in [0,1)^2 for each lane -> [N,2]: the sampler
    surface the integrators consume for pixel antialiasing."""
    if sampler == "independent":
        return rng.uniform(key, tuple(pixel_index.shape) + (2,))
    si = torch.as_tensor(sample_index, device=pixel_index.device) \
        .expand(pixel_index.shape)
    if sampler == "stratified":
        return stratified_2d(rng.fold_in(key, pixel_index), si, spp)
    if sampler == "ld":
        return ld_2d(si, pixel_index)
    if sampler == "sobol":
        seed = _hash_u32(pixel_index)
        x = sobol(torch.zeros_like(pixel_index), si, seed)
        y = sobol(torch.ones_like(pixel_index), si,
                  _hash_u32(seed ^ 0x5BF03635))
        return torch.stack([x, y], dim=-1)
    if sampler == "halton":
        off = _hash_u32(pixel_index) >> 8
        return torch.stack([halton(0, si, off), halton(1, si, off)], dim=-1)
    if sampler == "hammersley":
        return torch.stack([hammersley(0, si, spp), hammersley(1, si, spp)],
                           dim=-1)
    raise ValueError(f"unknown sampler '{sampler}'")
