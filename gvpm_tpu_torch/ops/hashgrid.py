"""Spatial hash grid: the photon index of the SPPM primal estimators
(mirrors gvpm_tpu/ops/hashgrid.py).

Build is one stable sort of the photons by bucket; a range query visits
the 8 (cell >= 2r) or 27 (cell >= r) stencil cells around each query and
enumerates only the rows those cells hold (prefix-compacted, at most a
budget of B rows a query; more are strided-subsampled with compensation
T/B). Hash collisions are resolved by bucket dedup (ball tests) or by an
exact cell fingerprint (`exact_cells`).

The bucket hash wraps in int32 in the JAX package; here it is computed
in int64 and masked with hash_size - 1, which keeps the same low bits.
Order within a bucket is semantics (the overflow subsample visits ranks
k*T//B), so every sort is stable.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.struct import TensorStruct

P1, P2, P3 = 73856093, 19349663, 83492791  # classic spatial-hash primes

NEIGHBOR_OFFSETS = [(ox, oy, oz)
                    for ox in (-1, 0, 1)
                    for oy in (-1, 0, 1)
                    for oz in (-1, 0, 1)]
OFFSETS8 = [(ox, oy, oz) for ox in (0, 1) for oy in (0, 1)
            for oz in (0, 1)]

# queries per gather_dense chunk: bounds the [chunk, B] candidate planes
# (2^16 x 64 lanes = 16 MB a float plane); not semantics
Q_CHUNK = 1 << 16


@dataclasses.dataclass
class HashGrid(TensorStruct):
    origin: torch.Tensor        # [3]
    cell_size: torch.Tensor     # [] float32
    sorted_idx: torch.Tensor    # [P] photon index ordered by bucket
    cell_key: torch.Tensor      # [P] bucket of each *sorted* photon
    cell_of: torch.Tensor       # [P,3] cell coords per photon (unsorted;
                                #       SORTED order when identity_order)
    cell_pack: torch.Tensor     # [P] 10-bit-packed cell coords, SORTED
    bucket_start: torch.Tensor  # [H+1]
    hash_size: int = 1 << 18
    identity_order: bool = False


def _pack_cell(cell):
    """Cell coords -> one fingerprint (10 bits/axis). Two cells share it
    only when >= 1024 cells apart per axis AND hash-colliding."""
    return ((cell[..., 0] & 1023) | ((cell[..., 1] & 1023) << 10)
            | ((cell[..., 2] & 1023) << 20))


def _cell_coords(origin, cell_size, p):
    return torch.floor((p - origin) / cell_size).to(torch.int64)


def _bucket(cell, hash_size):
    h = (cell[..., 0] * P1) ^ (cell[..., 1] * P2) ^ (cell[..., 2] * P3)
    return h & (hash_size - 1)


def build(positions, valid, origin, cell_size, hash_size=1 << 18):
    """positions [P,3]; invalid photons land in an overflow bucket.
    cell_size: a float32 scalar (tensor or number)."""
    cell_size = torch.as_tensor(cell_size, dtype=torch.float32,
                                device=positions.device)
    cell = _cell_coords(origin, cell_size, positions)
    b = torch.where(valid, _bucket(cell, hash_size), hash_size)
    order = torch.argsort(b, stable=True)
    b_sorted = b[order]
    bucket_start = torch.searchsorted(
        b_sorted, torch.arange(hash_size + 1, device=b.device))
    return HashGrid(origin=origin, cell_size=cell_size, sorted_idx=order,
                    cell_key=b_sorted, cell_of=cell,
                    cell_pack=_pack_cell(cell[order]),
                    bucket_start=bucket_start, hash_size=hash_size)


def build_sorted(positions, valid, origin, cell_size, payload,
                 hash_size=1 << 18, max_rows=0):
    """build() + payload permutation into grid order: candidate slots
    index payload rows directly (identity_order). max_rows > 0 keeps the
    first max_rows sorted rows (invalid photons sort last, so only a
    valid count above it drops real photons). payload: dict of [P, ...]
    tensors. Returns (grid, payload_sorted)."""
    g = build(positions, valid, origin, cell_size, hash_size)
    cell_pack, sorted_idx, bucket_start = (g.cell_pack, g.sorted_idx,
                                           g.bucket_start)
    if max_rows and max_rows < positions.shape[0]:
        cell_pack = cell_pack[:max_rows]
        sorted_idx = sorted_idx[:max_rows]
        bucket_start = torch.clamp(bucket_start, max=max_rows)
    payload_sorted = {k: v[sorted_idx] for k, v in payload.items()}
    return g.replace(cell_of=g.cell_of[sorted_idx], cell_pack=cell_pack,
                     sorted_idx=sorted_idx, bucket_start=bucket_start,
                     identity_order=True), payload_sorted


def stencil_ranges(grid: HashGrid, xq, stencil, dedup_buckets=False):
    """Per-query (start, count, pack) row ranges of the stencil cells
    ([Q,S] each) in the grid's SORTED row order; pack is the fingerprint
    each slot expects. dedup_buckets ("ball" mode): a bucket shared by
    several stencil cells keeps only its first slot, so every photon is
    enumerated at most once (far-cell collision photons fail a ball test
    around xq). Otherwise ("exact" mode) the caller compares `pack` with
    each candidate's cell_pack."""
    if stencil == 8:
        g = (xq - grid.origin) / grid.cell_size
        qcell = torch.floor(g - 0.5).to(torch.int64)
    else:
        qcell = _cell_coords(grid.origin, grid.cell_size, xq)
    offs = torch.tensor(NEIGHBOR_OFFSETS if stencil == 27 else OFFSETS8,
                        dtype=torch.int64, device=xq.device)
    ncell = qcell[:, None, :] + offs[None, :, :]               # [Q,S,3]
    nb = _bucket(ncell, grid.hash_size)                        # [Q,S]
    start = grid.bucket_start[nb]
    count = grid.bucket_start[nb + 1] - start
    if dedup_buckets:
        # slot s repeats an earlier slot's bucket: strict lower triangle
        S = nb.shape[1]
        earlier = torch.ones(S, S, dtype=torch.bool,
                             device=xq.device).tril(-1)
        dup = ((nb[:, :, None] == nb[:, None, :]) & earlier).any(-1)
        count = torch.where(dup, 0, count)
    return start, count, _pack_cell(ncell)


def gather_dense(grid: HashGrid, x, eval_fn, max_per_cell=32, stencil=27,
                 budget=None, exact_cells=False):
    """Range query over prefix-compacted candidates.

    Each query's stencil cells' (start, count) ranges are prefix-summed
    and candidate lane k in [0, B) maps through rank -> (cell, offset),
    B = `budget` (default 2 * max_per_cell). A query whose stencil holds
    T > B rows visits the strided subsample rank = k*T//B with scale
    T/B. stencil 27: cell_size >= r; stencil 8: cell_size >= 2r, 2x2x2
    block anchored at floor(g - 0.5). exact_cells also checks each
    candidate's cell fingerprint (needed for non-ball membership tests).

    eval_fn(q_idx [Qc], idx [Qc,B], ok [Qc,B], scale [Qc,B]) -> tensor or
    tuple of tensors with leading dim Qc, already reduced over B; q_idx
    indexes the original queries. Candidates are rows in the SORTED order
    for identity_order grids, else photon indices. Queries run in chunks
    of Q_CHUNK. Returns the eval outputs concatenated over all queries.
    """
    Q = x.shape[0]
    B = budget if budget is not None else 2 * max_per_cell
    P = grid.sorted_idx.shape[0]
    dev = x.device
    ks = torch.arange(B, dtype=torch.int64, device=dev)[None, :]
    outs = []
    for s in range(0, Q, Q_CHUNK):
        qi = torch.arange(s, min(s + Q_CHUNK, Q), device=dev)
        start, count, pack = stencil_ranges(
            grid, x[s:s + Q_CHUNK], stencil, dedup_buckets=not exact_cells)
        off = torch.cumsum(count, dim=1)                       # inclusive
        T = off[:, -1:]                                        # [Qc,1]
        over = T > B
        rank = torch.where(over, (ks * T) // B, ks)
        scale = torch.where(over, T.to(torch.float32) / B,
                            1.0).expand(-1, B)
        ok = ks < torch.clamp(T, max=B)
        # rank -> (cell j, offset): j = #cells whose inclusive cumsum
        # <= rank; row = start[j] + rank - exclusive_cumsum[j]
        j = torch.searchsorted(off[:, :-1].contiguous(),
                               rank.contiguous(), right=True)
        row = (torch.gather(start, 1, j) + rank
               - torch.gather(off - count, 1, j))
        row = torch.clamp(row, 0, P - 1)
        if exact_cells:
            ok = ok & (grid.cell_pack[row] == torch.gather(pack, 1, j))
        idx = row if grid.identity_order else grid.sorted_idx[row]
        outs.append(eval_fn(qi, idx, ok, scale))
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def cell_histogram(grid: HashGrid):
    """Occupancy diagnostics: (max, mean nonzero) photons per bucket."""
    counts = grid.bucket_start[1:] - grid.bucket_start[:-1]
    nz = int((counts > 0).sum())
    return int(counts.max()), float(counts.sum()) / max(nz, 1)
