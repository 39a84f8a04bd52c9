"""Plain reference of the gradient photon-plane sweep (the program's
GPlane0D kernel): each sampled camera segment against every photon
plane, Moller-Trumbore base test, the plane rotated about its origin onto
each offset pixel's ray (or the same plane against the offset ray where
the origin cannot reconnect), pairwise MIS, summed per query in float64
(mediumRotationShift, shift_medium.h:39 of the GVPM code release).

It reads the packed query, offset, plane and tail rows that the timed
pass built; the row layouts below are the format the program's sweeps
read.
"""

from __future__ import annotations

import torch

from . import planar as pl

QSLOT = dict(o=0, d=3, length=6, med=7, valid=8, st=9, ss=12, w=15, g=16,
             pt=17)
BSLOT = dict(o=0, d=3, length=6, med=7, alpha=8, sig=11, w1=12, l1=15)
XSTRIDE = 10
TSLOT = dict(parent_p=0, parent_wi=3, parent_ns=6, scatter_base=9,
             bp_alb=12, bp_spec=15, bp_eta3=18, bp_sigs=21,
             pdf_dir_base=24, parent_type=25, reconnectable=26,
             bp_btype=27, bp_alpha=28, bp_eta1=29, bp_g=30, bp_ptype=31)
N_OUT = 27          # base 3, S 4 x 3, W 4 x 3
MAX_PAIRS = 1 << 24


class Cols:
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


def _survival(q, t):
    st, w = q.f3("st"), q.f1("w")
    e = [torch.exp(-st[c] * t) for c in range(3)]
    return (1.0 - w) + w * ((e[0] + e[1] + e[2]) / 3.0)


def _plane_hit(o, d, b):
    """Moller-Trumbore of rays (o, d) against the planes'
    parallelograms -> (u0, u1, t, |det| > 1e-7)."""
    e0 = tuple(c * b.f1("length") for c in b.f3("d"))
    e1 = tuple(c * b.f1("l1") for c in b.f3("w1"))
    pv = pl.cross3(d, e1)
    det = pl.dot3(e0, pv)
    ok = torch.abs(det) > 1e-7
    one = torch.ones_like(det)
    inv_det = torch.where(ok, 1.0 / torch.where(det == 0, one, det),
                          torch.zeros_like(det))
    tt = pl.sub3(o, b.f3("o"))
    qq = pl.cross3(tt, e0)
    return (pl.dot3(tt, pv) * inv_det, pl.dot3(d, qq) * inv_det,
            pl.dot3(e1, qq) * inv_det, ok)


def base_test(q, b):
    """Pairs past the base test of a segment and a plane."""
    u0, u1, tcam, ok = _plane_hit(q.f3("o"), q.f3("d"), b)
    ok = ok & q.b1("valid") & (q.f1("med") == b.f1("med"))
    return (ok & (u0 >= 0.0) & (u0 <= 1.0) & (u1 >= 0.0) & (u1 <= 1.0)
            & (tcam > 1e-5) & (tcam < q.f1("length")))


def _rodrigues(v, k, cos_r, sin_r):
    kdv = pl.dot3(k, v)
    cx, cy, cz = pl.cross3(k, v)
    f = kdv * (1.0 - cos_r)
    return (v[0] * cos_r + cx * sin_r + k[0] * f,
            v[1] * cos_r + cy * sin_r + k[1] * f,
            v[2] * cos_r + cz * sin_r + k[2] * f)


def _lobe_ratio(t, w_new):
    sr, sg, sb, pdf_new, ok_sc = pl.parent_scatter(
        t.f1("parent_type"), t.f3("parent_wi"), t.f3("parent_ns"),
        dict(btype=t.f1("bp_btype"), alb=t.f3("bp_alb"),
             spec=t.f3("bp_spec"), eta3=t.f3("bp_eta3"),
             alpha=t.f1("bp_alpha"), eta1=t.f1("bp_eta1")),
        dict(sigs=t.f3("bp_sigs"), g=t.f1("bp_g"), ptype=t.f1("bp_ptype")),
        w_new)
    sc_old = t.f3("scatter_base")
    sc_max = torch.maximum(torch.maximum(sc_old[0], sc_old[1]), sc_old[2])
    ok = ok_sc & (sc_max > 0.0) & (t.f1("pdf_dir_base") > 1e-20) \
        & (pdf_new > 0.0)
    return ok, tuple(s / torch.clamp(sc_old[c], min=1e-20)
                     for c, s in enumerate((sr, sg, sb))), pdf_new


def pair_terms(q, b, t, x):
    """The accepted pairs' base planes and, per offset, S, W and the
    successful shift."""
    oc, dc = q.f3("o"), q.f3("d")
    po, pw0, pw1 = b.f3("o"), b.f3("d"), b.f3("w1")
    pl0, pl1, psig = b.f1("length"), b.f1("l1"), b.f1("sig")
    st, ss, al = q.f3("st"), q.f3("ss"), b.f3("alpha")
    g, pt = q.f1("g"), q.f1("pt")
    reconn = t.b1("reconnectable")
    me = t.f1("reconnectable") < -0.5
    pdf_old = t.f1("pdf_dir_base")
    u0, u1, tcam, _ = _plane_hit(oc, dc, b)
    t0, t1 = u0 * pl0, u1 * pl1
    surv0, surv1 = _survival(q, t0), torch.exp(-psig * t1)
    jac = torch.abs(pl.dot3(pw0, pl.cross3(pw1, dc)))
    k_b = pl.phase(-pl.dot3(pw1, dc), g, pt) \
        / (torch.clamp(surv0, min=1e-9) * torch.clamp(surv1, min=1e-9)
           * torch.clamp(jac, min=1e-6))
    tr_cam = [torch.exp(-st[c] * tcam) for c in range(3)]
    base = tuple(al[c] * (tr_cam[c] * torch.exp(-st[c] * t0)
                          * torch.exp(-st[c] * t1) * ss[c] * ss[c] * k_b)
                 for c in range(3))
    rel_b = pl.sub3(pl.madd3(oc, dc, tcam), po)
    lb_r = torch.sqrt(torch.clamp(pl.dot3(rel_b, rel_b), min=1e-16))
    a_dir = tuple(rel_b[c] / lb_r for c in range(3))
    S, W, oks = [], [], []
    for i in range(4):
        k = XSTRIDE * i
        so = tuple(x[:, k + c] for c in range(3))
        sd = tuple(x[:, k + 3 + c] for c in range(3))
        slen, sval = x[:, k + 6], x[:, k + 7] > 0.5
        sens, border = x[:, k + 8], x[:, k + 9] > 0.5
        rel_o = pl.sub3(pl.madd3(so, sd, tcam), po)
        lo_r = torch.sqrt(torch.clamp(pl.dot3(rel_o, rel_o), min=1e-16))
        b_dir = tuple(rel_o[c] / lo_r for c in range(3))
        cos_r = pl.dot3(a_dir, b_dir)
        ax = pl.cross3(a_dir, b_dir)
        sin_r = torch.sqrt(torch.clamp(pl.dot3(ax, ax), min=0.0))
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
        ok_l, sc_r, pdf_new = _lobe_ratio(t, w0_r)
        surv0n, surv1n = _survival(q, t0_n), torch.exp(-psig * t1_n)
        jac_n = torch.abs(pl.dot3(w0_r, pl.cross3(w1_r, sd)))
        ok_rc = reconn & ok_l & sval & ok_geo & (tcam < slen) \
            & (jac_n > 1e-6)
        k_n = pl.phase(-pl.dot3(w1_r, sd), g, pt) \
            / (torch.clamp(surv0n, min=1e-9) * torch.clamp(surv1n, min=1e-9)
               * torch.clamp(jac_n, min=1e-6))
        c_rc = [al[c] * sc_r[c] * (tr_cam[c] * torch.exp(-st[c] * t0_n)
                                   * torch.exp(-st[c] * t1_n) * ss[c] * ss[c]
                                   * k_n) for c in range(3)]
        pr_rc = pdf_new / torch.clamp(pdf_old, min=1e-20) \
            * (surv0n / torch.clamp(surv0, min=1e-9)) \
            * (surv1n / torch.clamp(surv1, min=1e-9)) \
            * (jac / torch.clamp(jac_n, min=1e-6)) \
            / torch.clamp(scale * scale, min=1e-12)
        u0i, u1i, tci, oki = _plane_hit(so, sd, b)
        ok_id = ~reconn & ~me & oki & sval & (u0i >= 0.0) & (u0i <= 1.0) \
            & (u1i >= 0.0) & (u1i <= 1.0) & (tci > 1e-5) & (tci < slen)
        t0i, t1i = u0i * pl0, u1i * pl1
        jaci = torch.abs(pl.dot3(pw0, pl.cross3(pw1, sd)))
        k_i = pl.phase(-pl.dot3(pw1, sd), g, pt) \
            / (torch.clamp(_survival(q, t0i), min=1e-9)
               * torch.clamp(torch.exp(-psig * t1i), min=1e-9)
               * torch.clamp(jaci, min=1e-6))
        c_id = [al[c] * (torch.exp(-st[c] * tci) * torch.exp(-st[c] * t0i)
                         * torch.exp(-st[c] * t1i) * ss[c] * ss[c] * k_i)
                for c in range(3)]
        ok_sh = torch.where(reconn, ok_rc, ok_id)
        one = torch.ones_like(pr_rc)
        w = 1.0 / (1.0 + torch.clamp(torch.where(reconn, pr_rc, one) * sens,
                                     0.0, 1e12))
        w = torch.clamp(torch.where(ok_sh, w, one), 0.0, 1.0)
        w = torch.where(border, one, w)
        zero = torch.zeros_like(w)
        S.append(tuple(w * torch.where(reconn, torch.where(ok_rc, r, zero),
                                       torch.where(ok_id, d, zero))
                       for r, d in zip(c_rc, c_id)))
        W.append(tuple(w * c for c in base))
        oks.append(ok_rc)
    return base, S, W, oks


def sweep(q, qx, rows, tails, sample, dtype=torch.float32):
    """The reference of one gradient plane sweep over the sampled
    queries `sample` [n] (indices into q): returns (sums [n, 27] float64
    before the camera throughputs, accepted pairs [n], successful
    reconnections [n], both int64)."""
    n, N, dev = sample.shape[0], rows.shape[0], q.device
    out = torch.zeros((n, N_OUT), dtype=torch.float64, device=dev)
    cnt = torch.zeros((n, 2), dtype=torch.int64, device=dev)
    qs, xs = q[sample].to(dtype), qx[sample].to(dtype)
    rows, tails = rows.to(dtype), tails.to(dtype)
    tb = max(1, min(N, MAX_PAIRS // max(n, 1)))
    for j0 in range(0, N, tb):
        okb = base_test(Cols(qs, QSLOT, (-1, 1)),
                        Cols(rows[j0:j0 + tb], BSLOT, (1, -1)))
        mm, jj = torch.nonzero(okb, as_tuple=True)
        if mm.numel() == 0:
            continue
        bj = j0 + jj
        base, S, W, oks = pair_terms(
            Cols(qs[mm], QSLOT, (-1,)), Cols(rows[bj], BSLOT, (-1,)),
            Cols(tails[bj], TSLOT, (-1,)), xs[mm])
        cols = list(base) + [c for s in S for c in s] \
            + [c for w in W for c in w]
        out.index_add_(0, mm, torch.stack(cols, 1).to(torch.float64))
        cnt.index_add_(0, mm, torch.stack(
            [torch.ones_like(mm), sum(o.to(torch.int64) for o in oks)], 1))
    return out, cnt[:, 0], cnt[:, 1]
