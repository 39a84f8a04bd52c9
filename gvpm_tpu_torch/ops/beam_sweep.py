"""Pair sweeps of the photon-beam and photon-plane estimators: every
camera query against every photon beam (or plane), one pair function
per estimator, summed per query.

  beam1d  — camera segment x beam closest approach, 1D kernel
            (gvpm_tpu/integrators/estimators.py:481 beam_beam_gather)
  beam3d  — camera distance sample x beam chord, 3D kernel, one
            stochastic chord sample per pair (:262 beam_point_gather)
  plane0d — camera segment x photon plane, Moller-Trumbore, 0D
            (:401 plane_gather)

and their G-VPM gradient versions (gvpm_tpu/integrators/
gradient_gather.py): gbeam1d (:1232 beam_gradient_gather), gbeam3d
(:1580 beam3d_gradient_gather) and gplane0d (:1960
plane_gradient_gather). A gradient pair that passes the base test is
shifted to the four offset pixels: reconnected at the beam's origin when
its lobe allows it (gplane0d: the plane rotated about its origin), else
the same beam or plane against the offset ray, with pairwise MIS. Their
use_manifold=True kinds (gbeam1d_me, gbeam3d_me, gplane0d_me) take no
identity shift for a beam whose origin is an ME-eligible delta vertex
(marked -1 in its tail's reconnectable slot, `pack_tails`) and also
return, per query, the lowest packed index of such a beam among its
accepted pairs (int32, fused_gather.ME_NONE if none), the number of
those pairs, and for gbeam3d_me the chosen pair's chord point [M,3]:
the host's ME stage resolves that pair (integrators/gradient_gather.py).

The JAX package leaves these to XLA as dense lax.scan tile loops over
all beam slots; the TPU has no kernel for them. Here `sweep` / `gsweep`
launch one CUDA kernel (csrc/beam_sweep.cu, per-pair math in
csrc/beam_eval.cuh) for CUDA tensors and run the plain PyTorch version
(`sweep_plain` / `gsweep_plain`) only for CPU tensors. `sweep` returns
per query the summed contribution [M,3] and the number of accepted
pairs [M] (int32); `gsweep` the base sum [M,3], the shifted and the
MIS-weighted base sums of each offset [4,M,3], the accepted pairs and
the successful reconnections [M] (int32), all without the camera
throughputs, which are per query. The work is floating-point (and, for
beam3d, integer: a threefry word a pair inside the chord test) bound:
each pair reads a few floats and does 50-200 operations, and the beams
are read once per tile of queries; a gradient pair that passes the base
test also reads its beam's gradient tail and its query's offset rays.

Inputs are packed rows: `pack_queries` (one float32 row a camera query,
QSLOT) and `pack_beams` (the beams or planes that are valid, in stable
order, one float32 row each, BSLOT, and their original flat index); a
gradient sweep also takes `pack_offsets` (a query's four offset rays,
XSLOT) and `pack_tails` (a kept beam's shift caches and baked parent
material, TSLOT).
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
from .fused_gather import ME_NONE
from ..core import rng
from ..core import warp
from ..integrators import planar as pl
from ..render.phase import rayleigh_pdf
from ..scene.types import PHASE_HG, PHASE_RAYLEIGH

KINDS = ("beam1d", "beam3d", "plane0d")
GKINDS = ("gbeam1d", "gbeam3d", "gplane0d")
GKINDS_ME = tuple(k + "_me" for k in GKINDS)
# kernel launches per kind, counted by the wrapper where it launches
LAUNCHES = dict.fromkeys(KINDS + GKINDS + GKINDS_ME, 0)

# query-row and beam-row slots (csrc/beam_eval.cuh QSlot / BSlot). A
# beam3d query's "o" is its distance sample x. A beam row's "d" /
# "length" are a plane's w0 / l0; w1, l1 and sig (its extension
# sampler's sigma) are a plane's only.
QSLOT = dict(o=0, d=3, length=6, med=7, valid=8, st=9, ss=12, w=15, g=16,
             pt=17)
QW = 20
BSLOT = dict(o=0, d=3, length=6, med=7, alpha=8, sig=11, w1=12, l1=15)
BW = 16
# a gradient query's offset rays (csrc/beam_eval.cuh XSlot): offset i at
# XSTRIDE * i; beam3d's "o" is the offset distance sample, its "ok"
# cam_ok and its "sens" pr_cam
XSLOT = dict(o=0, d=3, length=6, ok=7, sens=8, border=9)
XSTRIDE = 10
XW = 40
# a kept beam's gradient tail (csrc/beam_eval.cuh TSlot): the shift
# caches of the vertex that emits it and its baked material
TSLOT = dict(parent_p=0, parent_wi=3, parent_ns=6, scatter_base=9,
             bp_alb=12, bp_spec=15, bp_eta3=18, bp_sigs=21,
             pdf_dir_base=24, parent_type=25, reconnectable=26,
             bp_btype=27, bp_alpha=28, bp_eta1=29, bp_g=30, bp_ptype=31)
TW = 32
NF_GRAD = 27         # base 3, S 4 x 3, W 4 x 3 floats a gradient query
BLOCK = 128          # queries (threads) a block: csrc/beam_sweep.cu
TILE_B = 128         # beams a shared-memory tile
TARGET_BLOCKS = 1056  # 8 blocks an SM of 132: beam splits fill the card
PLAIN_MAX_PAIRS = 1 << 24   # pairs per chunk of the plain version

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
_BUILD = os.path.join(os.path.dirname(_HERE), "_build")
SOURCES = ("beam_sweep.cu", "beam_eval.cuh", "shift_math.cuh")
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


def pack_offsets(o, d, length, ok, sens, border):
    """[M, XW] float32 rows of a gradient query's offset rays: each
    argument a list of the four offsets' [M,3] or [M] columns."""
    cols = []
    for i in range(4):
        cols += [o[i], d[i], length[i][:, None], ok[i][:, None],
                 sens[i][:, None], border[i][:, None]]
    return torch.cat([c.to(torch.float32) for c in cols], dim=1) \
        .contiguous()


def pack_tails(fields, keep, me_elig=None):
    """[N, TW] float32 gradient tails of the kept beams (`keep`, the
    index pack_beams returns): `fields` holds the TSLOT entries over all
    beam slots. me_elig (an ME sweep's, over all beam slots): the
    ME-eligible beams, whose reconnectable slot holds -1 (eligibility
    implies not reconnectable)."""
    rows = torch.zeros((keep.shape[0], TW), dtype=torch.float32,
                       device=keep.device)
    for name, k in TSLOT.items():
        v = fields[name][keep].to(torch.float32)
        if name == "reconnectable" and me_elig is not None:
            v = torch.where(me_elig[keep], -1.0, v)
        rows[:, k:k + (v.shape[1] if v.dim() == 2 else 1)] = \
            v if v.dim() == 2 else v[:, None]
    return rows


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


def _closest(oc, dc, ob, db):
    """Closest approach of two lines (rayIntersectInternal1D): the
    directions' cosine, 1 - cos^2, the parallel flag and the two line
    parameters."""
    w0 = _sub3(oc, ob)
    bb = _dot3(dc, db)
    f1 = -_dot3(w0, dc)
    f2 = -_dot3(w0, db)
    denom = 1.0 - bb * bb
    parallel = torch.abs(denom) < 1e-8
    den = torch.where(parallel, 1.0, denom)
    return (bb, denom, parallel, (f1 - bb * f2) / den,
            (bb * f1 - f2) / den)


def _madd3(o, d, t):
    return tuple(o[c] + d[c] * t for c in range(3))


def _chord(x, ob, db, lb, r2):
    """A beam's chord through the kernel sphere (squared radius r2)
    around x -> (its start s0, its length)."""
    rel = _sub3(x, ob)
    s_mid = _dot3(rel, db)
    perp = _sub3(rel, tuple(db[c] * s_mid for c in range(3)))
    half = torch.sqrt(torch.clamp(r2 - _dot3(perp, perp), min=0.0))
    s0 = torch.clamp(s_mid - half, min=0.0)
    s1 = torch.minimum(s_mid + half, lb)
    return s0, torch.clamp(s1 - s0, min=0.0)


def _plane_hit(o, d, b):
    """Moller-Trumbore of rays (o, d) against the planes' parallelograms
    (intersectPlane0D): (u0, u1, t, |det| > 1e-7)."""
    e0 = tuple(c * b.f1("length") for c in b.f3("d"))
    e1 = tuple(c * b.f1("l1") for c in b.f3("w1"))
    pv = _cross3(d, e1)
    det = _dot3(e0, pv)
    ok = torch.abs(det) > 1e-7
    inv_det = torch.where(ok, 1.0 / torch.where(det == 0, 1.0, det), 0.0)
    tt = _sub3(o, b.f3("o"))
    qq = _cross3(tt, e0)
    return (_dot3(tt, pv) * inv_det, _dot3(d, qq) * inv_det,
            _dot3(e1, qq) * inv_det, ok)


def _beam1d(q, b, p, m0, stats=None):
    """Closest approach of the camera segment and the beam (estimators
    beam_beam_gather's tile body) -> (ok, contribution planes); stage 2:
    both closest-approach parameters inside their segments."""
    oc, dc, lc = q.f3("o"), q.f3("d"), q.f1("length")
    ob, db, lb = b.f3("o"), b.f3("d"), b.f1("length")
    bb, denom, parallel, tc, tb = _closest(oc, dc, ob, db)
    ok = (~parallel & (tc > 1e-5) & (tc < lc) & (tb > 1e-5) & (tb < lb)
          & q.b1("valid") & (q.f1("med") == b.f1("med")))
    _stage(stats, ok)
    delta = _sub3(_madd3(oc, dc, tc), _madd3(ob, db, tb))
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
    ob, db = b.f3("o"), b.f3("d")
    s0, chord = _chord(x, ob, db, b.f1("length"), p.r2)
    ok = q.b1("valid") & (chord > 0.0) & (q.f1("med") == b.f1("med"))
    mm, jj = torch.nonzero(ok, as_tuple=True)
    keys = p.keys.to(torch.int64) & rng.M32
    us = torch.zeros_like(chord)
    us[mm, jj] = rng.counter_uniform(keys[jj, 0], keys[jj, 1],
                                     (m0 + mm) * p.tile + keys[jj, 2])
    _stage(stats, ok)
    s = s0 + us * chord
    e = _sub3(x, _madd3(ob, db, s))
    ok = ok & (_dot3(e, e) < p.r2)
    pf = _phase(-_dot3(db, dc), q.f1("g"), q.f1("pt"))
    st, a = q.f3("st"), b.f3("alpha")
    sc = chord * p.k * pf / torch.clamp(_survival(q, s), min=1e-9)
    return ok, tuple(a[c] * torch.exp(-st[c] * s) * sc for c in range(3))


def _plane0d(q, b, p, m0, stats=None):
    """Camera segment x plane parallelogram (estimators plane_gather's
    tile body); stage 2: the determinant test passed."""
    oc, dc, lc = q.f3("o"), q.f3("d"), q.f1("length")
    pw0, pl0 = b.f3("d"), b.f1("length")
    pw1, pl1 = b.f3("w1"), b.f1("l1")
    t0, t1, tcam, ok = _plane_hit(oc, dc, b)
    _stage(stats, ok & q.b1("valid") & (q.f1("med") == b.f1("med")))
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
# the gradient sweeps' plain version
# ---------------------------------------------------------------------------
# Two stages per block of pairs: the base test on dense [Mc, T] planes,
# then everything else on the accepted pairs only (every other pair adds
# exactly 0 in the JAX package and counts nothing), as 1-D planes. The
# formulas are csrc/beam_eval.cuh's GBeam1D / GBeam3D / GPlane0D, in the
# same order.

def _gbase_beam1d(q, b, p, m0):
    """Base test of gbeam1d on dense planes -> (okb, None, the pairs
    past the parameter-range tests: the primal sweep's stage 2)."""
    oc, dc, lc = q.f3("o"), q.f3("d"), q.f1("length")
    ob, db, lb = b.f3("o"), b.f3("d"), b.f1("length")
    _, _, parallel, tc, tb = _closest(oc, dc, ob, db)
    delta = _sub3(_madd3(oc, dc, tc), _madd3(ob, db, tb))
    ok = (~parallel & (tc > 1e-5) & (tc < lc) & (tb > 1e-5) & (tb < lb)
          & q.b1("valid") & (q.f1("med") == b.f1("med")))
    return ok & (_dot3(delta, delta) < p.r2), None, ok


def _gbase_beam3d(q, b, p, m0):
    """Base test of gbeam3d on dense planes -> (okb, the chord sample us
    of every pair that draws one, 0 elsewhere, the pairs that draw
    one)."""
    x = q.f3("o")
    ob, db = b.f3("o"), b.f3("d")
    s0, chord = _chord(x, ob, db, b.f1("length"), p.r2)
    ok = q.b1("valid") & (chord > 0.0) & (q.f1("med") == b.f1("med"))
    mm, jj = torch.nonzero(ok, as_tuple=True)
    keys = p.keys.to(torch.int64) & rng.M32
    us = torch.zeros_like(chord)
    us[mm, jj] = rng.counter_uniform(keys[jj, 0], keys[jj, 1],
                                     (m0 + mm) * p.tile + keys[jj, 2])
    e = _sub3(x, _madd3(ob, db, s0 + us * chord))
    return ok & (_dot3(e, e) < p.r2), us, ok


def _gbase_plane0d(q, b, p, m0):
    """Base test of gplane0d on dense planes -> (okb, None, the pairs
    past the determinant test)."""
    u0, u1, tcam, ok = _plane_hit(q.f3("o"), q.f3("d"), b)
    ok = ok & q.b1("valid") & (q.f1("med") == b.f1("med"))
    return (ok & (u0 >= 0.0) & (u0 <= 1.0) & (u1 >= 0.0) & (u1 <= 1.0)
            & (tcam > 1e-5) & (tcam < q.f1("length"))), None, ok


def _parent(t):
    """The beams' origin lobes (TSLOT columns of the pairs' tails) ->
    the arguments of planar.parent_scatter_params, the old values, and
    `me`: the beam is left to the ME stage (pack_tails' -1)."""
    return dict(
        A=t.f3("parent_p"), ptype=t.f1("parent_type"),
        pwi=t.f3("parent_wi"), pns=t.f3("parent_ns"),
        reconn=t.b1("reconnectable"), me=t.f1("reconnectable") < -0.5,
        sc_old=t.f3("scatter_base"),
        pdf_old=t.f1("pdf_dir_base"),
        bparams=dict(btype=t.f1("bp_btype"), alb=t.f3("bp_alb"),
                     spec=t.f3("bp_spec"), eta3=t.f3("bp_eta3"),
                     alpha=t.f1("bp_alpha"), eta1=t.f1("bp_eta1")),
        mparams=dict(sigs=t.f3("bp_sigs"), g=t.f1("bp_g"),
                     ptype=t.f1("bp_ptype")))


def _lobe_ratio(a, w_new):
    """csrc lobe_ratio: (lobe terms of ok_rc, scatter ratio planes,
    pdf_new)."""
    sr, sg, sb, pdf_new, ok_sc = pl.parent_scatter_params(
        a["ptype"], a["pwi"], a["pns"], a["bparams"], a["mparams"], w_new)
    sc_old = a["sc_old"]
    sc_max = torch.maximum(torch.maximum(sc_old[0], sc_old[1]), sc_old[2])
    ok = ok_sc & (sc_max > 0.0) & (a["pdf_old"] > 1e-20) & (pdf_new > 0.0)
    return ok, tuple(s / torch.clamp(sc_old[c], min=1e-20)
                     for c, s in enumerate((sr, sg, sb))), pdf_new


def _offsets(x):
    """The pairs' queries' offset rays: per offset (o, d, length, ok,
    sens, border) planes."""
    for i in range(4):
        k = XSTRIDE * i
        yield i, (tuple(x[:, k + c] for c in range(3)),
                  tuple(x[:, k + 3 + c] for c in range(3)), x[:, k + 6],
                  x[:, k + 7] > 0.5, x[:, k + 8], x[:, k + 9] > 0.5)


def _mis(ok_sh, pr_l, sens, border):
    w = 1.0 / (1.0 + torch.clamp(pr_l * sens, 0.0, 1e12))
    w = torch.clamp(torch.where(ok_sh, w, 1.0), 0.0, 1.0)
    return torch.where(border, 1.0, w)


def _gpair_beam1d(q, b, t, x, p, us):
    """gbeam1d on accepted pairs -> (base, [S_i], [W_i], [ok_rc_i])."""
    oc, dc = q.f3("o"), q.f3("d")
    ob, db, lb = b.f3("o"), b.f3("d"), b.f1("length")
    st, ss, al = q.f3("st"), q.f3("ss"), b.f3("alpha")
    g, pt = q.f1("g"), q.f1("pt")
    bb, denom, _, tc, tb = _closest(oc, dc, ob, db)
    delta = _sub3(_madd3(oc, dc, tc), _madd3(ob, db, tb))
    sin_t = torch.sqrt(torch.clamp(denom, min=1e-12))
    surv_b = _survival(q, tb)
    s_b = pl.phase_params(-bb, g, pt) * p.k \
        / (sin_t * torch.clamp(surv_b, min=1e-9))
    tr_c = [torch.exp(-st[c] * tc) for c in range(3)]
    base = tuple(al[c] * (s_b * tr_c[c] * torch.exp(-st[c] * tb) * ss[c])
                 for c in range(3))
    a = _parent(t)
    S, W, oks = [], [], []
    for i, (so, sd, slen, sval, sens, border) in _offsets(x):
        # reconnection: re-emit the beam through y_i = pc_i - delta
        dv = _sub3(_sub3(_madd3(so, sd, tc), delta), a["A"])
        t_new2 = torch.clamp(_dot3(dv, dv), min=1e-12)
        t_new = torch.sqrt(t_new2)
        w_new = tuple(dv[c] / t_new for c in range(3))
        ok_l, sc_r, pdf_new = _lobe_ratio(a, w_new)
        cos_x = _dot3(w_new, sd)
        sin_n = torch.sqrt(torch.clamp(1.0 - cos_x * cos_x, min=1e-8))
        surv_n = _survival(q, t_new)
        ok_rc = a["reconn"] & ok_l & sval & (tc < slen) & (t_new < lb)
        s_n = pl.phase_params(-cos_x, g, pt) * p.k \
            / (sin_n * torch.clamp(surv_n, min=1e-9))
        c_rc = [al[c] * sc_r[c] * (s_n * tr_c[c] * torch.exp(-st[c] * t_new)
                                   * ss[c]) for c in range(3)]
        pr_rc = pdf_new / torch.clamp(a["pdf_old"], min=1e-20) \
            * (surv_n / torch.clamp(surv_b, min=1e-9)) * (tb * tb / t_new2) \
            * (sin_t / sin_n)
        # identity: the same beam against the offset ray
        bi, deni, pari, tci, tbi = _closest(so, sd, ob, db)
        di = _sub3(_madd3(so, sd, tci), _madd3(ob, db, tbi))
        ok_id = ~a["reconn"] & ~a["me"] & ~pari & sval & (tci > 1e-5) \
            & (tci < slen) & (tbi > 1e-5) & (tbi < lb) \
            & (_dot3(di, di) < p.r2)
        sin_i = torch.sqrt(torch.clamp(deni, min=1e-12))
        s_i = pl.phase_params(-bi, g, pt) * p.k \
            / (sin_i * torch.clamp(_survival(q, tbi), min=1e-9))
        c_id = [al[c] * (s_i * torch.exp(-st[c] * tci)
                         * torch.exp(-st[c] * tbi) * ss[c]) for c in range(3)]
        _shift_terms(a["reconn"], ok_rc, c_rc, pr_rc, ok_id, c_id, sens,
                     border, base, S, W, oks)
    return base, S, W, oks


def _shift_terms(reconn, ok_rc, c_rc, pr_rc, ok_id, c_id, sens, border,
                 base, S, W, oks):
    """Select the branch of each pair, its MIS weight, and append the
    offset's S, W and ok_rc planes."""
    ok_sh = torch.where(reconn, ok_rc, ok_id)
    w = _mis(ok_sh, torch.where(reconn, pr_rc, 1.0), sens, border)
    S.append(tuple(w * torch.where(reconn, torch.where(ok_rc, r, 0.0),
                                   torch.where(ok_id, d, 0.0))
                   for r, d in zip(c_rc, c_id)))
    W.append(tuple(w * c for c in base))
    oks.append(ok_rc)


def _gpair_beam3d(q, b, t, x, p, us):
    """gbeam3d on accepted pairs (us: their chord samples)."""
    xq, dc = q.f3("o"), q.f3("d")
    ob, db, lb = b.f3("o"), b.f3("d"), b.f1("length")
    st, al = q.f3("st"), b.f3("alpha")
    g, pt = q.f1("g"), q.f1("pt")
    s0, chord = _chord(xq, ob, db, lb, p.r2)
    s = s0 + us * chord
    y = _madd3(ob, db, s)
    surv_b = _survival(q, s)
    k_b = chord * p.k * pl.phase_params(-_dot3(db, dc), g, pt) \
        / torch.clamp(surv_b, min=1e-9)
    base = tuple(al[c] * torch.exp(-st[c] * s) * k_b for c in range(3))
    yx = _sub3(y, xq)
    a = _parent(t)
    S, W, oks = [], [], []
    for i, (xs, sd, _, cam_ok, pr_cam, border) in _offsets(x):
        # reconnection: re-emit the beam through y_i = xs_i + (y - x)
        dv = _sub3(tuple(xs[c] + yx[c] for c in range(3)), a["A"])
        t_new2 = torch.clamp(_dot3(dv, dv), min=1e-12)
        t_new = torch.sqrt(t_new2)
        w_new = tuple(dv[c] / t_new for c in range(3))
        ok_l, sc_r, pdf_new = _lobe_ratio(a, w_new)
        rel_n = _sub3(xs, a["A"])
        sm_n = _dot3(rel_n, w_new)
        d2p_n = _dot3(rel_n, rel_n) - sm_n * sm_n
        half_n = torch.sqrt(torch.clamp(p.r2 - d2p_n, min=0.0))
        s0n = torch.clamp(sm_n - half_n, min=0.0)
        s1n = torch.minimum(sm_n + half_n, lb)
        chord_n = torch.clamp(s1n - s0n, min=0.0)
        cos_x = _dot3(w_new, sd)
        surv_n = _survival(q, t_new)
        ok_rc = a["reconn"] & ok_l & cam_ok & (chord_n > 0.0) \
            & (t_new >= s0n) & (t_new <= s1n)
        k_n = chord_n * p.k * pl.phase_params(-cos_x, g, pt) \
            / torch.clamp(surv_n, min=1e-9)
        c_rc = [al[c] * sc_r[c] * torch.exp(-st[c] * t_new) * k_n
                for c in range(3)]
        pr_rc = pdf_new / torch.clamp(a["pdf_old"], min=1e-20) \
            * (surv_n / torch.clamp(surv_b, min=1e-9)) * (s * s / t_new2) \
            * (chord / torch.clamp(chord_n, min=1e-12))
        # identity: the same beam's chord around the offset sample
        s0i, chord_i = _chord(xs, ob, db, lb, p.r2)
        s_id = s0i + us * chord_i
        ei = _sub3(xs, _madd3(ob, db, s_id))
        ok_id = ~a["reconn"] & ~a["me"] & cam_ok & (chord_i > 0.0) \
            & (_dot3(ei, ei) < p.r2)
        k_i = chord_i * p.k * pl.phase_params(-_dot3(db, sd), g, pt) \
            / torch.clamp(_survival(q, s_id), min=1e-9)
        c_id = [al[c] * torch.exp(-st[c] * s_id) * k_i for c in range(3)]
        _shift_terms(a["reconn"], ok_rc, c_rc, pr_rc, ok_id, c_id, pr_cam,
                     border, base, S, W, oks)
    return base, S, W, oks


def _rodrigues(v, k, cos_r, sin_r):
    kdv = k[0] * v[0] + k[1] * v[1] + k[2] * v[2]
    cx = k[1] * v[2] - k[2] * v[1]
    cy = k[2] * v[0] - k[0] * v[2]
    cz = k[0] * v[1] - k[1] * v[0]
    f = kdv * (1.0 - cos_r)
    return (v[0] * cos_r + cx * sin_r + k[0] * f,
            v[1] * cos_r + cy * sin_r + k[1] * f,
            v[2] * cos_r + cz * sin_r + k[2] * f)


def _gpair_plane0d(q, b, t, x, p, us):
    """gplane0d on accepted pairs."""
    oc, dc = q.f3("o"), q.f3("d")
    po, pw0, pw1 = b.f3("o"), b.f3("d"), b.f3("w1")
    pl0, pl1, psig = b.f1("length"), b.f1("l1"), b.f1("sig")
    st, ss, al = q.f3("st"), q.f3("ss"), b.f3("alpha")
    g, pt = q.f1("g"), q.f1("pt")
    u0, u1, tcam, _ = _plane_hit(oc, dc, b)
    t0, t1 = u0 * pl0, u1 * pl1
    surv0 = _survival(q, t0)
    surv1 = torch.exp(-psig * t1)
    jac = torch.abs(_dot3(pw0, _cross3(pw1, dc)))
    k_b = pl.phase_params(-_dot3(pw1, dc), g, pt) \
        / (torch.clamp(surv0, min=1e-9) * torch.clamp(surv1, min=1e-9)
           * torch.clamp(jac, min=1e-6))
    tr_cam = [torch.exp(-st[c] * tcam) for c in range(3)]
    base = tuple(al[c] * (tr_cam[c] * torch.exp(-st[c] * t0)
                          * torch.exp(-st[c] * t1) * ss[c] * ss[c] * k_b)
                 for c in range(3))
    rel_b = _sub3(_madd3(oc, dc, tcam), po)
    lb_r = torch.sqrt(torch.clamp(_dot3(rel_b, rel_b), min=1e-16))
    a_dir = tuple(rel_b[c] / lb_r for c in range(3))
    a = _parent(t)
    S, W, oks = [], [], []
    for i, (so, sd, slen, sval, sens, border) in _offsets(x):
        # rotation about the plane's origin onto the offset point
        rel_o = _sub3(_madd3(so, sd, tcam), po)
        lo_r = torch.sqrt(torch.clamp(_dot3(rel_o, rel_o), min=1e-16))
        b_dir = tuple(rel_o[c] / lo_r for c in range(3))
        cos_r = _dot3(a_dir, b_dir)
        ax = _cross3(a_dir, b_dir)
        sin_r = torch.sqrt(torch.clamp(_dot3(ax, ax), min=0.0))
        safe = sin_r > 1e-7
        sk = torch.clamp(sin_r, min=1e-7)
        k_hat = tuple(ax[c] / sk for c in range(3))
        w0_r = tuple(torch.where(safe, r, v) for r, v in
                     zip(_rodrigues(pw0, k_hat, cos_r, sin_r), pw0))
        w1_r = tuple(torch.where(safe, r, v) for r, v in
                     zip(_rodrigues(pw1, k_hat, cos_r, sin_r), pw1))
        scale = lo_r / lb_r
        t0_n, t1_n = t0 * scale, t1 * scale
        ok_geo = (safe | (cos_r > 0.0)) & (t0_n <= pl0) & (t1_n <= pl1)
        ok_l, sc_r, pdf_new = _lobe_ratio(a, w0_r)
        cos_ci = _dot3(w1_r, sd)
        surv0n = _survival(q, t0_n)
        surv1n = torch.exp(-psig * t1_n)
        jac_n = torch.abs(_dot3(w0_r, _cross3(w1_r, sd)))
        ok_rc = a["reconn"] & ok_l & sval & ok_geo & (tcam < slen) \
            & (jac_n > 1e-6)
        k_n = pl.phase_params(-cos_ci, g, pt) \
            / (torch.clamp(surv0n, min=1e-9) * torch.clamp(surv1n, min=1e-9)
               * torch.clamp(jac_n, min=1e-6))
        c_rc = [al[c] * sc_r[c] * (tr_cam[c] * torch.exp(-st[c] * t0_n)
                                   * torch.exp(-st[c] * t1_n) * ss[c] * ss[c]
                                   * k_n) for c in range(3)]
        pr_rc = pdf_new / torch.clamp(a["pdf_old"], min=1e-20) \
            * (surv0n / torch.clamp(surv0, min=1e-9)) \
            * (surv1n / torch.clamp(surv1, min=1e-9)) \
            * (jac / torch.clamp(jac_n, min=1e-6)) \
            / torch.clamp(scale * scale, min=1e-12)
        # identity: the same plane against the offset ray
        u0i, u1i, tci, oki = _plane_hit(so, sd, b)
        ok_id = ~a["reconn"] & ~a["me"] & oki & sval & (u0i >= 0.0) \
            & (u0i <= 1.0) & (u1i >= 0.0) & (u1i <= 1.0) & (tci > 1e-5) \
            & (tci < slen)
        t0i, t1i = u0i * pl0, u1i * pl1
        jaci = torch.abs(_dot3(pw0, _cross3(pw1, sd)))
        k_i = pl.phase_params(-_dot3(pw1, sd), g, pt) \
            / (torch.clamp(_survival(q, t0i), min=1e-9)
               * torch.clamp(torch.exp(-psig * t1i), min=1e-9)
               * torch.clamp(jaci, min=1e-6))
        c_id = [al[c] * (torch.exp(-st[c] * tci) * torch.exp(-st[c] * t0i)
                         * torch.exp(-st[c] * t1i) * ss[c] * ss[c] * k_i)
                for c in range(3)]
        _shift_terms(a["reconn"], ok_rc, c_rc, pr_rc, ok_id, c_id, sens,
                     border, base, S, W, oks)
    return base, S, W, oks


GPAIRS = dict(gbeam1d=(_gbase_beam1d, _gpair_beam1d),
              gbeam3d=(_gbase_beam3d, _gpair_beam3d),
              gplane0d=(_gbase_plane0d, _gpair_plane0d))


def _grad_out(out, cnt):
    """[M, NF] sums and [M, NC] counts of a gradient sweep -> (primal
    [M,3], S [4,M,3], W [4,M,3], visits [M], shift_ok [M]) and, for an ME
    kind (NC 4), (ME key [M], ME pairs [M], gbeam3d_me's chord point
    [M,3] or None)."""
    M = out.shape[0]
    res = (out[:, :3], out[:, 3:15].reshape(M, 4, 3).movedim(1, 0),
           out[:, 15:27].reshape(M, 4, 3).movedim(1, 0), cnt[:, 0],
           cnt[:, 1])
    if cnt.shape[1] == 2:
        return res
    return res + (cnt[:, 2], cnt[:, 3],
                  out[:, NF_GRAD:] if out.shape[1] > NF_GRAD else None)


def _widths(kind):
    """(float, int) accumulators a query of gradient sweep `kind`."""
    if kind not in GKINDS_ME:
        return NF_GRAD, 2
    return NF_GRAD + (3 if kind == "gbeam3d_me" else 0), 4


def _chord_point(q, b, p, us):
    """gbeam3d's chord sample y on pair planes (its base test's point)."""
    ob, db = b.f3("o"), b.f3("d")
    s0, chord = _chord(q.f3("o"), ob, db, b.f1("length"), p.r2)
    return _madd3(ob, db, s0 + us * chord)


def gsweep_plain(kind, q, qx, rows, tails, p: Params, stats=None):
    """The gradient sweeps' plain PyTorch version: the base test on
    [Mc, T] planes (chunks of at most PLAIN_MAX_PAIRS pairs), the shifts
    on its accepted pairs, summed per query; an ME kind's key, ME pair
    count and chord point from the same planes. `stats`, when given,
    receives the pairs past the primal sweep's first tests ("stage2":
    for gbeam3d those that draw a threefry word), the accepted pairs
    ("accepted") and those of them on a reconnectable beam ("reconn") or
    on an ME-eligible one ("me"). Returns gsweep's tuple."""
    M, N = q.shape[0], rows.shape[0]
    dev = q.device
    nf, nc = _widths(kind)
    me = nc == 4
    out = torch.zeros((M, nf), dtype=torch.float32, device=dev)
    cnt = torch.zeros((M, 2), dtype=torch.int64, device=dev)
    me_key = torch.full((M,), ME_NONE, dtype=torch.int64, device=dev)
    me_cnt = torch.zeros((M,), dtype=torch.int64, device=dev)
    gkind = kind.removesuffix("_me")
    base_fn, pair_fn = GPAIRS[gkind]
    tb = max(1, min(N, max(256, PLAIN_MAX_PAIRS // max(M, 1))))
    mc = max(1, min(M, PLAIN_MAX_PAIRS // tb))
    for m0 in range(0, M, mc):
        qc = _Cols(q[m0:m0 + mc], QSLOT, (-1, 1))
        for j0 in range(0, N, tb):
            pp = dataclasses.replace(p, keys=p.keys[j0:j0 + tb]) \
                if p.keys is not None else p
            okb, us, stage2 = base_fn(
                qc, _Cols(rows[j0:j0 + tb], BSLOT, (1, -1)), pp, m0)
            if me:
                # the lowest eligible beam of each query's accepted pairs
                elig = okb & (tails[j0:j0 + tb, TSLOT["reconnectable"]]
                              < -0.5)[None]
                sl = slice(m0, m0 + okb.shape[0])
                me_cnt[sl] += elig.sum(1)
                js = torch.arange(j0, j0 + okb.shape[1], device=dev)
                first = torch.where(elig, js[None], ME_NONE).amin(1)
                new = first < me_key[sl]
                me_key[sl] = torch.where(new, first, me_key[sl])
                if gkind == "gbeam3d" and bool(new.any()):
                    qn = torch.nonzero(new)[:, 0]
                    bn = first[qn]
                    y = _chord_point(_Cols(q[m0 + qn], QSLOT, (-1,)),
                                     _Cols(rows[bn], BSLOT, (-1,)), pp,
                                     us[qn, bn - j0])
                    out[m0 + qn, NF_GRAD:] = torch.stack(y, dim=1)
            mm, jj = torch.nonzero(okb, as_tuple=True)
            if stats is not None:
                rc = tails[j0 + jj, TSLOT["reconnectable"]]
                for k, v in (("stage2", int(stage2.sum())),
                             ("accepted", int(mm.numel())),
                             ("reconn", int((rc > 0.5).sum())),
                             ("me", int((rc < -0.5).sum()))):
                    stats[k] = stats.get(k, 0) + v
            if mm.numel() == 0:
                continue
            qi, bj = m0 + mm, j0 + jj
            base, S, W, oks = pair_fn(
                _Cols(q[qi], QSLOT, (-1,)), _Cols(rows[bj], BSLOT, (-1,)),
                _Cols(tails[bj], TSLOT, (-1,)), qx[qi], pp,
                None if us is None else us[mm, jj])
            cols = list(base) + [c for s in S for c in s] \
                + [c for w in W for c in w]
            out[:, :NF_GRAD].index_add_(0, qi, torch.stack(cols, dim=1))
            cnt.index_add_(0, qi, torch.stack(
                [torch.ones_like(mm), sum(o.to(torch.int64) for o in oks)],
                dim=1))
    if me:
        cnt = torch.cat([cnt, me_key[:, None], me_cnt[:, None]], dim=1)
    return _grad_out(out, cnt.to(torch.int32))


def gsweep(kind, q, qx, rows, tails, p: Params):
    """The gradient sweep `kind` (GKINDS or GKINDS_ME) over every
    (query, beam) pair: CUDA tensors launch the kernel, CPU tensors take
    the plain version. q: pack_queries rows (beam3d: the distance
    samples); qx: pack_offsets rows; rows / tails: pack_beams /
    pack_tails of the kept beams (an ME kind's with me_elig). Returns
    (primal [M,3], S [4,M,3], W [4,M,3], visits [M], shift_ok [M]), the
    counts int32, without the camera throughputs; an ME kind also (ME
    key [M], ME pairs [M], both int32, and gbeam3d_me's chord point
    [M,3], else None)."""
    if kind not in GKINDS + GKINDS_ME:
        raise ValueError(f"beam_sweep: no gradient pair function {kind!r}")
    if q.device.type == "cpu":
        return gsweep_plain(kind, q, qx, rows, tails, p)
    return _grad_out(*launch_kernel(kind, q, rows, p, qx=qx, tails=tails))


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
        for kind in LAUNCHES:
            fn = getattr(lib, f"gvpm_beam_sweep_{kind}")
            fn.argtypes = [vp, i64, vp, vp, vp, vp, i64, i32, f32, f32, i32,
                           i64, vp, vp, vp, vp, vp]
            fn.restype = ctypes.c_int
        _LIB["lib"] = lib
        return lib


def build_report():
    """ptxas's resources of the nine sweep_kernel<Pair>
    instantiations: {kind: dict(registers, spill_stores, spill_loads,
    stack, smem)}."""
    build()
    # mangled names: the primal ones as Primal<Beam1D>, the gradient ones
    # as GBeam1DT<false> ("ILb0E") and GBeam1DT<true> ("ILb1E") etc.
    tags = {f"{t}TILb{int(me)}E": k + ("_me" if me else "")
            for t, k in (("GBeam1D", "gbeam1d"), ("GBeam3D", "gbeam3d"),
                         ("GPlane0D", "gplane0d")) for me in (True, False)}
    tags.update(Beam1D="beam1d", Beam3D="beam3d", Plane0D="plane0d")
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


def launch_kernel(kind, q, rows, p: Params, qx=None, tails=None):
    """Launch the kernel for `kind` on PyTorch's current stream (no
    synchronize); raises on inputs the kernel does not take or a refused
    launch. Returns the [M, NF] sums and [M, NC] counts (a primal kind:
    [M, 3] and [M]; a gradient one, which also takes the offset rows qx
    and the beams' tails: [M, 27] and [M, 2], an ME kind [M, 27 or 30]
    and [M, 4])."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"beam_sweep: the kernel runs on CUDA tensors, "
                         f"not on {dev}")
    grad = kind in GKINDS + GKINDS_ME
    checks = [("query rows", q, QW), ("beam rows", rows, BW)]
    if grad:
        checks += [("offset rows", qx, XW), ("beam tails", tails, TW)]
    for name, t, w in checks:
        if t is None or t.device != dev or t.dtype != torch.float32 \
                or t.dim() != 2 or t.shape[1] != w or not t.is_contiguous():
            raise ValueError(f"beam_sweep: {name} must be a contiguous "
                             f"[n, {w}] float32 tensor on {dev}")
    if not isinstance(p.r2, float) or not isinstance(p.k, float):
        raise ValueError("beam_sweep: r2 and k must be Python floats")
    M, N = q.shape[0], rows.shape[0]
    if grad and (qx.shape[0] != M or tails.shape[0] != N):
        raise ValueError("beam_sweep: one offset row a query and one tail "
                         "a beam")
    keys = None
    if kind in ("beam3d", "gbeam3d", "gbeam3d_me"):
        if p.keys is None or p.keys.shape != (N, 4) \
                or p.keys.dtype != torch.int32 or p.keys.device != dev \
                or not p.keys.is_contiguous():
            raise ValueError("beam_sweep: beam3d needs contiguous int32 "
                             f"[{N}, 4] beam keys on {dev}")
        if M * p.tile >= 2 ** 32:
            raise ValueError("beam_sweep: beam3d's counters m * tile + "
                             "lane must stay below 2^32")
        keys = p.keys.data_ptr()
    nf, nc = _widths(kind) if grad else (3, 1)
    out = torch.zeros((M, nf), dtype=torch.float32, device=dev)
    cnt = torch.zeros((M, nc), dtype=torch.int32, device=dev)
    if M == 0 or N == 0:
        if nc == 4:
            cnt[:, 2] = ME_NONE
        return out, cnt if grad else cnt[:, 0]
    splits, chunk = split_plan(M, N)
    part = torch.empty((splits, M, nf), dtype=torch.float32, device=dev)
    part_cnt = torch.empty((splits, M, nc), dtype=torch.int32, device=dev)
    err = getattr(build(), f"gvpm_beam_sweep_{kind}")(
        q.data_ptr(), M, rows.data_ptr(), keys,
        tails.data_ptr() if grad else None,
        qx.data_ptr() if grad else None, N,
        int(p.tile), p.r2, p.k, splits, chunk, part.data_ptr(),
        part_cnt.data_ptr(), out.data_ptr(), cnt.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"beam_sweep_{kind} launch failed: CUDA error "
                           f"{err}")
    LAUNCHES[kind] += 1
    return out, cnt if grad else cnt[:, 0]
