"""The port's SPPM hash grid (gvpm_tpu_torch/ops/hashgrid.py) against
gvpm_tpu/ops/hashgrid.py on the same numpy-seeded photons: builds,
stencil ranges and the prefix-compacted dense gather, including the
strided overflow subsample. Everything discrete (sorted ids, bucket
starts, cell fingerprints, candidate rows, visit masks, scales) is
exactly equal; sums agree at rtol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvpm_tpu.ops import hashgrid as jhg
from gvpm_tpu_torch.ops import hashgrid
from tests.test_torch_common import torch_threads  # noqa: F401

P, Q, R = 2048, 200, 0.07


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    # positions straddle the origin: negative cell coordinates
    pos = rng.uniform(-0.3, 1.2, (P, 3)).astype(np.float32)
    # a dense clump overflows the per-query budget
    pos[:300] = (0.5 + rng.normal(0, 0.02, (300, 3))).astype(np.float32)
    valid = rng.random(P) > 0.1
    xq = rng.uniform(0.0, 1.0, (Q, 3)).astype(np.float32)
    xq[:20] = 0.5 + rng.normal(0, 0.01, (20, 3)).astype(np.float32)
    payload = dict(w=rng.uniform(0.1, 1.0, P).astype(np.float32))
    return pos, valid, xq, payload


def _builds(data, hash_size, cell, sorted_grid, max_rows=0):
    pos, valid, _, payload = data
    origin = np.zeros(3, np.float32)
    if sorted_grid:
        jg, jpay = jhg.build_sorted(
            jnp.asarray(pos), jnp.asarray(valid), jnp.asarray(origin),
            jnp.float32(cell), {k: jnp.asarray(v) for k, v in payload.items()},
            hash_size=hash_size, max_rows=max_rows)
        tg, tpay = hashgrid.build_sorted(
            torch.tensor(pos), torch.tensor(valid), torch.tensor(origin),
            torch.tensor(cell, dtype=torch.float32),
            {k: torch.tensor(v) for k, v in payload.items()},
            hash_size=hash_size, max_rows=max_rows)
        return jg, tg, jpay, tpay
    jg = jhg.build(jnp.asarray(pos), jnp.asarray(valid), jnp.asarray(origin),
                   jnp.float32(cell), hash_size=hash_size)
    tg = hashgrid.build(torch.tensor(pos), torch.tensor(valid),
                        torch.tensor(origin),
                        torch.tensor(cell, dtype=torch.float32),
                        hash_size=hash_size)
    return jg, tg, None, None


def _eq(a, b, name):
    np.testing.assert_array_equal(b.numpy(), np.asarray(a).astype(np.int64),
                                  err_msg=name)


@pytest.mark.parametrize("hash_size", [1 << 6, 1 << 12])
def test_build_matches_jax(data, hash_size):
    """hash_size 2^6 forces collisions between far cells."""
    jg, tg, _, _ = _builds(data, hash_size, 2 * R, False)
    for f in ("sorted_idx", "cell_key", "cell_of", "cell_pack",
              "bucket_start"):
        _eq(getattr(jg, f), getattr(tg, f), f)
    assert int(tg.cell_of.min()) < 0
    assert hashgrid.cell_histogram(tg)[0] == jhg.cell_histogram(jg)[0]
    np.testing.assert_allclose(hashgrid.cell_histogram(tg)[1],
                               jhg.cell_histogram(jg)[1], rtol=1e-6)


def test_build_sorted_matches_jax(data):
    n_valid = int(data[1].sum())
    jg, tg, jpay, tpay = _builds(data, 1 << 6, 2 * R, True,
                                 max_rows=n_valid - 100)
    assert tg.identity_order and tg.sorted_idx.shape[0] == n_valid - 100
    for f in ("sorted_idx", "cell_of", "cell_pack", "bucket_start"):
        _eq(getattr(jg, f), getattr(tg, f), f)
    np.testing.assert_array_equal(tpay["w"].numpy(), np.asarray(jpay["w"]))


@pytest.mark.parametrize("stencil", [8, 27])
@pytest.mark.parametrize("dedup", [True, False])
def test_stencil_ranges_match_jax(data, stencil, dedup):
    cell = 2 * R if stencil == 8 else R
    jg, tg, _, _ = _builds(data, 1 << 6, cell, False)
    xq = data[2]
    ref = jhg.stencil_ranges(jg, jnp.asarray(xq), stencil,
                             dedup_buckets=dedup)
    got = hashgrid.stencil_ranges(tg, torch.tensor(xq), stencil,
                                  dedup_buckets=dedup)
    for name, a, b in zip(("start", "count", "pack"), ref, got):
        _eq(a, b, name)
    if dedup:      # 2^6 buckets: some stencil cells share one
        full = hashgrid.stencil_ranges(tg, torch.tensor(xq), stencil)[1]
        assert bool(((full > 0) & (got[1] == 0)).any())


@pytest.mark.parametrize("stencil", [8, 27])
@pytest.mark.parametrize("budget", [None, 8])
@pytest.mark.parametrize("sorted_grid", [False, True])
def test_gather_dense_matches_jax(data, monkeypatch, stencil, budget,
                                  sorted_grid):
    """Counting and summing eval functions; the candidates, visit masks
    and scales themselves come back unreduced and must be equal. Budget
    8 overflows (strided subsample with scale T/B); the port runs in
    chunks of 64 queries, the JAX package in lax.map tiles of 48."""
    monkeypatch.setattr(hashgrid, "Q_CHUNK", 64)
    pos, valid, xq, payload = data
    cell = 2 * R if stencil == 8 else R
    jg, tg, jpay, tpay = _builds(data, 1 << 6, cell, sorted_grid)
    w_j = jpay["w"] if sorted_grid else jnp.asarray(payload["w"])
    w_t = tpay["w"] if sorted_grid else torch.tensor(payload["w"])
    pos_j = jnp.asarray(pos)[jg.sorted_idx] if sorted_grid \
        else jnp.asarray(pos)
    pos_t = torch.tensor(pos)[tg.sorted_idx] if sorted_grid \
        else torch.tensor(pos)
    val_j = jnp.asarray(valid)[jg.sorted_idx] if sorted_grid \
        else jnp.asarray(valid)
    val_t = torch.tensor(valid)[tg.sorted_idx] if sorted_grid \
        else torch.tensor(valid)
    xq_j, xq_t = jnp.asarray(xq), torch.tensor(xq)

    def jeval(qi, idx, ok, scale):
        d = pos_j[idx] - xq_j[qi][:, None, :]
        d2 = jnp.sum(d * d, axis=-1)
        inside = ok & val_j[idx] & (d2 < R * R)
        return (jnp.sum(inside, axis=1),
                jnp.sum(jnp.where(inside, w_j[idx] * scale, 0.0), axis=1),
                jnp.where(ok, idx, -1), ok, scale)

    def teval(qi, idx, ok, scale):
        d = pos_t[idx] - xq_t[qi][:, None, :]
        d2 = (d * d).sum(-1)
        inside = ok & val_t[idx] & (d2 < R * R)
        return (inside.sum(1),
                torch.where(inside, w_t[idx] * scale, 0.0).sum(1),
                torch.where(ok, idx, -1), ok, scale)

    kw = dict(max_per_cell=16, stencil=stencil, budget=budget)
    ref = jhg.gather_dense(jg, xq_j, jeval, q_tile=48, **kw)
    got = hashgrid.gather_dense(tg, xq_t, teval, **kw)
    for name, a, b in zip(("count", "sum", "rows", "ok", "scale"), ref, got):
        a = np.asarray(a)
        if name == "sum":
            np.testing.assert_allclose(b.numpy(), a, rtol=1e-5, atol=1e-6)
        elif name == "scale":
            np.testing.assert_array_equal(b.numpy(), a)
        else:
            np.testing.assert_array_equal(b.numpy(), a.astype(b.numpy().dtype),
                                          err_msg=name)
    assert int(got[0].sum()) > 0
    if budget is not None:
        assert float(got[4].max()) > 1.0           # some query overflowed


def test_gather_dense_exact_cells(data):
    """Exact mode (the BRE membership test): every candidate's cell
    fingerprint is checked; far-cell collision photons drop out."""
    pos, valid, xq, _ = data
    jg, tg, _, _ = _builds(data, 1 << 6, R, False)
    xq_j, xq_t = jnp.asarray(xq), torch.tensor(xq)

    def jeval(qi, idx, ok, scale):
        return jnp.where(ok, idx, -1), scale

    def teval(qi, idx, ok, scale):
        return torch.where(ok, idx, -1), scale

    ref = jhg.gather_dense(jg, xq_j, jeval, max_per_cell=16, q_tile=64,
                           stencil=27, exact_cells=True)
    got = hashgrid.gather_dense(tg, xq_t, teval, max_per_cell=16,
                                stencil=27, exact_cells=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    assert int((got[0] >= 0).sum()) > 0
