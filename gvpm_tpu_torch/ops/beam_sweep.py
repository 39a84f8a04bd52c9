"""Pair sweeps of the photon-beam and photon-plane estimators: every
camera query against every photon beam (or plane), one pair function
per estimator, summed per query.

  beam1d  — camera segment x beam closest approach, 1D kernel
            (gvpm_tpu/integrators/estimators.py:481 beam_beam_gather)
  beam3d  — camera distance sample x beam chord, 3D kernel, one
            stochastic chord sample per pair (:262 beam_point_gather)
  plane0d — camera segment x photon plane, Moller-Trumbore, 0D
            (:401 plane_gather)

The JAX package leaves these to XLA as dense lax.scan tile loops over
all beam slots; the TPU has no kernel for them. Here `sweep` launches
one CUDA kernel (csrc/beam_sweep.cu, per-pair math in
csrc/beam_eval.cuh) for CUDA tensors and runs the plain PyTorch version
(`sweep_plain`) only for CPU tensors. Both return per query the summed
contribution [M,3] and the number of accepted pairs [M] (int32). The
work is floating-point (and, for beam3d, integer: a threefry word a
pair inside the chord test) bound: each pair reads a few floats and
does 50-200 operations, and the beams are read once per tile of
queries.

Inputs are packed rows: `pack_queries` (one float32 row a camera query,
QSLOT) and `pack_beams` (the beams or planes that are valid, in stable
order, one float32 row each, BSLOT, and their original flat index).
Invalid slots add exactly 0 in the JAX package, so dropping them
changes nothing. beam3d's chord sample of query m and beam j is the JAX
package's word: position m * tile + j % tile of
uniform(fold_in(k_s, j // tile), [M, tile]); `beam_keys` gives each
kept beam its tile key and lane, and the kernel computes the words.

The kernel is built with nvcc (-fmad=false, no fast math, sm_90a) at
first use into gvpm_tpu_torch/_build/ (ops/nvcc.py).
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import threading

import torch

from . import nvcc
from ..core import rng
from ..core import warp
from ..render.phase import rayleigh_pdf
from ..scene.types import PHASE_HG, PHASE_RAYLEIGH

KINDS = ("beam1d", "beam3d", "plane0d")
# kernel launches per kind, counted by the wrapper where it launches
LAUNCHES = dict.fromkeys(KINDS, 0)

# query-row and beam-row slots (csrc/beam_eval.cuh QSlot / BSlot). A
# beam3d query's "o" is its distance sample x. A beam row's "d" /
# "length" are a plane's w0 / l0; w1, l1 and sig (its extension
# sampler's sigma) are a plane's only.
QSLOT = dict(o=0, d=3, length=6, med=7, valid=8, st=9, ss=12, w=15, g=16,
             pt=17)
QW = 20
BSLOT = dict(o=0, d=3, length=6, med=7, alpha=8, sig=11, w1=12, l1=15)
BW = 16
BLOCK = 128          # queries (threads) a block: csrc/beam_sweep.cu
TILE_B = 128         # beams a shared-memory tile
TARGET_BLOCKS = 1056  # 8 blocks an SM of 132: beam splits fill the card
PLAIN_MAX_PAIRS = 1 << 24   # pairs per chunk of the plain version

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
_BUILD = os.path.join(os.path.dirname(_HERE), "_build")
SOURCES = ("beam_sweep.cu", "beam_eval.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v")


@dataclasses.dataclass
class Params:
    """Scalars of a sweep: r2 = r^2 and k (K1 for beam1d, K3 for beam3d)
    as Python floats holding float32 values (a device scalar would cost
    a synchronize a launch); beam3d's per-beam key rows (`beam_keys`)
    and its tile."""
    r2: float = 0.0
    k: float = 0.0
    keys: torch.Tensor = None
    tile: int = 256


def pack_queries(o, d, length, med, valid, st, ss, w, g, pt):
    """[M, QW] float32 query rows (med and pt as exact small floats)."""
    cols = dict(o=o, d=d, length=length, med=med, valid=valid, st=st, ss=ss,
                w=w, g=g, pt=pt)
    q = torch.zeros((o.shape[0], QW), dtype=torch.float32, device=o.device)
    for name, v in cols.items():
        v = v.to(torch.float32)
        k = QSLOT[name]
        q[:, k:k + (v.shape[1] if v.dim() == 2 else 1)] = \
            v if v.dim() == 2 else v[:, None]
    return q


def pack_beams(o, d, length, med, alpha, valid, w1=None, l1=None, sig=None):
    """The valid slots, in their order, as [N, BW] float32 rows; returns
    (rows, original flat index int64 [N])."""
    keep = torch.nonzero(valid)[:, 0]
    cols = dict(o=o, d=d, length=length, med=med, alpha=alpha, w1=w1, l1=l1,
                sig=sig)
    rows = torch.zeros((keep.shape[0], BW), dtype=torch.float32,
                       device=o.device)
    for name, v in cols.items():
        if v is None:
            continue
        v = v[keep].to(torch.float32)
        k = BSLOT[name]
        rows[:, k:k + (v.shape[1] if v.dim() == 2 else 1)] = \
            v if v.dim() == 2 else v[:, None]
    return rows, keep


def beam_keys(tile_keys, orig, tile):
    """Per kept beam: its tile's key words and its lane in the tile, as
    int32 [N, 4] rows (k1, k2, lane, 0) holding the uint32 bits.
    tile_keys: int64 [n_tiles, 2], fold_in(k_s, tile index)."""
    k = tile_keys[orig // tile]
    cols = torch.stack([k[:, 0], k[:, 1], orig % tile,
                        torch.zeros_like(orig)], dim=1)
    return torch.where(cols >= 2 ** 31, cols - 2 ** 32, cols).to(torch.int32)


class _Cols:
    """Named column planes of packed rows, shaped for broadcasting."""

    def __init__(self, rows, slots, shape):
        self.rows, self.slots, self.shape = rows, slots, shape

    def f1(self, name):
        return self.rows[:, self.slots[name]].reshape(self.shape)

    def f3(self, name):
        k = self.slots[name]
        return tuple(self.rows[:, k + c].reshape(self.shape)
                     for c in range(3))

    def b1(self, name):
        return self.f1(name) > 0.5


def _sub3(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross3(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _phase(cos_t, g, pt):
    """render/phase.eval_phase from the propagation cosine."""
    return torch.where(pt == PHASE_HG, warp.hg_pdf(cos_t, g),
                       torch.where(pt == PHASE_RAYLEIGH, rayleigh_pdf(cos_t),
                                   warp.INV_FOURPI))


def survival(st, w, t):
    """P(a free-flight sample exceeds t) under the walk's distance
    sampler, (1 - w) + w mean_c exp(-sigma_t,c t): st the three sigma_t
    planes, w the sampling weight (render/medium.sampling_weight)."""
    e = [torch.exp(-st[c] * t) for c in range(3)]
    return (1.0 - w) + w * ((e[0] + e[1] + e[2]) / 3.0)


def _survival(q, t):
    return survival(q.f3("st"), q.f1("w"), t)


def _stage(stats, mask):
    """Count the pairs that pass a pair function's first tests (its
    second stage runs for them: csrc/beam_eval.cuh returns earlier for
    the others)."""
    if stats is not None:
        stats["stage2"] = stats.get("stage2", 0) + int(mask.sum())


def _beam1d(q, b, p, m0, stats=None):
    """Closest approach of the camera segment and the beam (estimators
    beam_beam_gather's tile body) -> (ok, contribution planes); stage 2:
    both closest-approach parameters inside their segments."""
    oc, dc, lc = q.f3("o"), q.f3("d"), q.f1("length")
    ob, db, lb = b.f3("o"), b.f3("d"), b.f1("length")
    w0 = _sub3(oc, ob)
    bb = _dot3(dc, db)
    f1 = -_dot3(w0, dc)
    f2 = -_dot3(w0, db)
    denom = 1.0 - bb * bb
    parallel = torch.abs(denom) < 1e-8
    den = torch.where(parallel, 1.0, denom)
    tc = (f1 - bb * f2) / den
    tb = (bb * f1 - f2) / den
    ok = (~parallel & (tc > 1e-5) & (tc < lc) & (tb > 1e-5) & (tb < lb)
          & q.b1("valid") & (q.f1("med") == b.f1("med")))
    _stage(stats, ok)
    delta = _sub3(tuple(oc[c] + dc[c] * tc for c in range(3)),
                  tuple(ob[c] + db[c] * tb for c in range(3)))
    ok = ok & (_dot3(delta, delta) < p.r2)
    sin_t = torch.sqrt(torch.clamp(denom, min=1e-12))
    pf = _phase(-bb, q.f1("g"), q.f1("pt"))
    st, ss, a = q.f3("st"), q.f3("ss"), b.f3("alpha")
    s = pf * p.k / (sin_t * torch.clamp(_survival(q, tb), min=1e-9))
    return ok, tuple(
        a[c] * (s * torch.exp(-st[c] * tc) * torch.exp(-st[c] * tb) * ss[c])
        for c in range(3))


def _beam3d(q, b, p, m0, stats=None):
    """The beam's chord through the kernel sphere around the distance
    sample, one sample on it (estimators beam_point_gather's tile body);
    the threefry word is drawn for the pairs that pass the chord test
    (stage 2)."""
    x, dc = q.f3("o"), q.f3("d")
    ob, db, lb = b.f3("o"), b.f3("d"), b.f1("length")
    rel = _sub3(x, ob)
    s_mid = _dot3(rel, db)
    perp = _sub3(rel, tuple(db[c] * s_mid for c in range(3)))
    half = torch.sqrt(torch.clamp(p.r2 - _dot3(perp, perp), min=0.0))
    s0 = torch.clamp(s_mid - half, min=0.0)
    s1 = torch.minimum(s_mid + half, lb)
    chord = torch.clamp(s1 - s0, min=0.0)
    ok = q.b1("valid") & (chord > 0.0) & (q.f1("med") == b.f1("med"))
    mm, jj = torch.nonzero(ok, as_tuple=True)
    keys = p.keys.to(torch.int64) & rng.M32
    us = torch.zeros_like(chord)
    us[mm, jj] = rng.counter_uniform(keys[jj, 0], keys[jj, 1],
                                     (m0 + mm) * p.tile + keys[jj, 2])
    _stage(stats, ok)
    s = s0 + us * chord
    e = _sub3(x, tuple(ob[c] + db[c] * s for c in range(3)))
    ok = ok & (_dot3(e, e) < p.r2)
    pf = _phase(-_dot3(db, dc), q.f1("g"), q.f1("pt"))
    st, a = q.f3("st"), b.f3("alpha")
    sc = chord * p.k * pf / torch.clamp(_survival(q, s), min=1e-9)
    return ok, tuple(a[c] * torch.exp(-st[c] * s) * sc for c in range(3))


def _plane0d(q, b, p, m0, stats=None):
    """Camera segment x plane parallelogram (estimators plane_gather's
    tile body); stage 2: the determinant test passed."""
    oc, dc, lc = q.f3("o"), q.f3("d"), q.f1("length")
    po, pw0, pl0 = b.f3("o"), b.f3("d"), b.f1("length")
    pw1, pl1 = b.f3("w1"), b.f1("l1")
    e0 = tuple(pw0[c] * pl0 for c in range(3))
    e1 = tuple(pw1[c] * pl1 for c in range(3))
    pv = _cross3(dc, e1)
    det = _dot3(e0, pv)
    ok = torch.abs(det) > 1e-7
    _stage(stats, ok & q.b1("valid") & (q.f1("med") == b.f1("med")))
    inv_det = torch.where(ok, 1.0 / torch.where(det == 0, 1.0, det), 0.0)
    tt = _sub3(oc, po)
    t0 = _dot3(tt, pv) * inv_det
    qq = _cross3(tt, e0)
    t1 = _dot3(dc, qq) * inv_det
    tcam = _dot3(e1, qq) * inv_det
    ok = (ok & (t0 >= 0.0) & (t0 <= 1.0) & (t1 >= 0.0) & (t1 <= 1.0)
          & (tcam > 1e-5) & (tcam < lc) & q.b1("valid")
          & (q.f1("med") == b.f1("med")))
    t0 = t0 * pl0
    t1 = t1 * pl1
    pf = _phase(-_dot3(pw1, dc), q.f1("g"), q.f1("pt"))
    surv1 = torch.exp(-b.f1("sig") * t1)
    jac = torch.abs(_dot3(pw0, _cross3(pw1, dc)))
    sc = pf / (torch.clamp(_survival(q, t0), min=1e-9)
               * torch.clamp(surv1, min=1e-9) * torch.clamp(jac, min=1e-6))
    st, ss, a = q.f3("st"), q.f3("ss"), b.f3("alpha")
    return ok, tuple(
        a[c] * (torch.exp(-st[c] * tcam) * torch.exp(-st[c] * t0)
                * torch.exp(-st[c] * t1) * ss[c] * ss[c] * sc)
        for c in range(3))


PAIRS = dict(beam1d=_beam1d, beam3d=_beam3d, plane0d=_plane0d)


def sweep_plain(kind, q, rows, p: Params, stats=None):
    """The plain PyTorch version: the pair function on [Mc, T] planes,
    queries and beams in chunks of at most PLAIN_MAX_PAIRS pairs, summed
    per query. `stats`, when given, receives the number of pairs that
    reach the pair function's second stage ("stage2"; for beam3d the
    pairs that draw a threefry word). Returns (sums [M,3] float32,
    accepted pairs [M] int32)."""
    M, N = q.shape[0], rows.shape[0]
    dev = q.device
    acc = torch.zeros((M, 3), dtype=torch.float32, device=dev)
    cnt = torch.zeros((M,), dtype=torch.int64, device=dev)
    fn = PAIRS[kind]
    tb = max(1, min(N, max(256, PLAIN_MAX_PAIRS // max(M, 1))))
    mc = max(1, min(M, PLAIN_MAX_PAIRS // tb))
    for m0 in range(0, M, mc):
        qc = _Cols(q[m0:m0 + mc], QSLOT, (-1, 1))
        for j0 in range(0, N, tb):
            bc = _Cols(rows[j0:j0 + tb], BSLOT, (1, -1))
            pp = dataclasses.replace(p, keys=p.keys[j0:j0 + tb]) \
                if p.keys is not None else p
            ok, contrib = fn(qc, bc, pp, m0, stats=stats)
            acc[m0:m0 + mc] += torch.stack(
                [torch.where(ok, c, 0.0).sum(1) for c in contrib], dim=1)
            cnt[m0:m0 + mc] += ok.sum(1)
    return acc, cnt.to(torch.int32)


def sweep(kind, q, rows, p: Params):
    """Sum the pair function `kind` over every (query, beam) pair:
    CUDA tensors launch the kernel, CPU tensors take the plain
    version. Returns (sums [M,3] float32, accepted pairs [M] int32)."""
    if kind not in KINDS:
        raise ValueError(f"beam_sweep: no pair function {kind!r}")
    if q.device.type == "cpu":
        return sweep_plain(kind, q, rows, p)
    return launch_kernel(kind, q, rows, p)


# ---------------------------------------------------------------------------
# the CUDA kernel: build, load, launch
# ---------------------------------------------------------------------------

_LIB = {}
_LOCK = threading.Lock()


def build():
    """Compile csrc/beam_sweep.cu with nvcc into _build/ (once; ops/
    nvcc.py) and load it; returns the ctypes library."""
    with _LOCK:
        if "lib" in _LIB:
            return _LIB["lib"]
        lib = ctypes.CDLL(nvcc.build_library(_CSRC, SOURCES, _BUILD,
                                             NVCC_FLAGS, "beam_sweep"))
        vp, i64, f32, i32 = (ctypes.c_void_p, ctypes.c_longlong,
                             ctypes.c_float, ctypes.c_int)
        for kind in KINDS:
            fn = getattr(lib, f"gvpm_beam_sweep_{kind}")
            fn.argtypes = [vp, i64, vp, vp, i64, i32, f32, f32, i32, i64,
                           vp, vp, vp, vp, vp]
            fn.restype = ctypes.c_int
        _LIB["lib"] = lib
        return lib


def build_report():
    """ptxas's resources of the three sweep_kernel<Pair>
    instantiations: {kind: dict(registers, spill_stores, spill_loads,
    stack, smem)}."""
    build()
    tags = dict(Beam1D="beam1d", Beam3D="beam3d", Plane0D="plane0d")
    return {next(k for t, k in tags.items() if t in name): r
            for name, r in nvcc.build_report(_CSRC, SOURCES, _BUILD,
                                             NVCC_FLAGS).items()
            if "sweep_kernel" in name}


def split_plan(M, N):
    """(splits, beams per split): the beam range is cut into `splits`
    parts of whole shared-memory tiles so that the grid holds about
    TARGET_BLOCKS blocks; a function of the shapes only, so the order of
    the sums is fixed."""
    blocks_x = -(-M // BLOCK)
    tiles = -(-N // TILE_B)
    splits = max(1, min(tiles, -(-TARGET_BLOCKS // blocks_x)))
    chunk = -(-tiles // splits) * TILE_B
    return -(-N // chunk), chunk


def launch_kernel(kind, q, rows, p: Params):
    """Launch the kernel for `kind` on PyTorch's current stream (no
    synchronize); raises on inputs the kernel does not take or a refused
    launch."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"beam_sweep: the kernel runs on CUDA tensors, "
                         f"not on {dev}")
    for name, t, w in (("query rows", q, QW), ("beam rows", rows, BW)):
        if t.device != dev or t.dtype != torch.float32 or t.dim() != 2 \
                or t.shape[1] != w or not t.is_contiguous():
            raise ValueError(f"beam_sweep: {name} must be a contiguous "
                             f"[n, {w}] float32 tensor on {dev}")
    if not isinstance(p.r2, float) or not isinstance(p.k, float):
        raise ValueError("beam_sweep: r2 and k must be Python floats")
    M, N = q.shape[0], rows.shape[0]
    keys = 0
    if kind == "beam3d":
        if p.keys is None or p.keys.shape != (N, 4) \
                or p.keys.dtype != torch.int32 or p.keys.device != dev \
                or not p.keys.is_contiguous():
            raise ValueError("beam_sweep: beam3d needs contiguous int32 "
                             f"[{N}, 4] beam keys on {dev}")
        if M * p.tile >= 2 ** 32:
            raise ValueError("beam_sweep: beam3d's counters m * tile + "
                             "lane must stay below 2^32")
        keys = p.keys.data_ptr()
    out = torch.zeros((M, 3), dtype=torch.float32, device=dev)
    cnt = torch.zeros((M,), dtype=torch.int32, device=dev)
    if M == 0 or N == 0:
        return out, cnt
    splits, chunk = split_plan(M, N)
    part = torch.empty((splits, M, 3), dtype=torch.float32, device=dev)
    part_cnt = torch.empty((splits, M), dtype=torch.int32, device=dev)
    err = getattr(build(), f"gvpm_beam_sweep_{kind}")(
        q.data_ptr(), M, rows.data_ptr(), keys, N, int(p.tile),
        p.r2, p.k, splits, chunk, part.data_ptr(),
        part_cnt.data_ptr(), out.data_ptr(), cnt.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"beam_sweep_{kind} launch failed: CUDA error "
                           f"{err}")
    LAUNCHES[kind] += 1
    return out, cnt
