"""Plain reference of the stages between the camera pass and the film:
the camera segments compacted to the pass's budget, the surface and the
volume (distance-sampled) gathers as whole functions (their query rows
built from the camera pass's gather points and segments, the per-pair
sums of reference/gather.py, the scaling into per-query estimates and,
with ME, the budgeted ME pairs' shifted and base terms), and the splat
of the gathers' estimates and the seen emission into the pass buffers.

It reads the camera pass's output, the light pass's records and the
photon table (each checked by itself), and works the rest out again.
"""

from __future__ import annotations

import math

import torch

from . import gather as rg
from . import me as rme
from . import planar as pl
from . import rng
from . import scene as rs
from .scene import dot, frame, normalize, to_local

OFFSETS = 4
CAMERA_FIELDS = ("valid", "o", "d", "length", "med", "thr", "pdf_prod",
                 "depth")
EPSILON = 1e-4              # the free-flight sampler's end margin
# the material ids the per-pair formulas (reference/planar.py) read
PAIR_ID = {rs.DIFFUSE: 0, rs.CONDUCTOR: 1, rs.NULL: 5}


def segments(cbs, pix, width, height, per_pixel):
    """The camera pass's segments [S, 5n] of the n pixels `pix` (flat
    ids) -> (base dict, 4 offset dicts, pixel lane of each) of the valid
    segments first, in step-major order, cut to per_pixel a pixel on
    average (the pass's budget); `gid` keys a segment's draws by its
    step and pixel."""
    steps, n = cbs.valid.shape[0], pix.shape[0]
    gid = (torch.arange(steps, device=pix.device)[:, None] * (width * height)
           + pix[None]).reshape(-1)

    def group(g):
        d = {f: getattr(cbs, f)[:, g * n:(g + 1) * n].reshape(
            (steps * n,) + getattr(cbs, f).shape[2:]) for f in CAMERA_FIELDS}
        d["gid"] = gid
        return d

    base = group(0)
    budget = min(base["valid"].shape[0], n * per_pixel)
    order = torch.argsort((~base["valid"]).to(torch.int8), stable=True)
    order = order[:budget]
    pick = [{k: v[order] for k, v in group(g).items()}
            for g in range(1 + OFFSETS)]
    lane = torch.arange(n, device=pix.device).repeat(steps)
    return pick[0], pick[1:], lane[order]


def _tables(sc, med):
    inm = med >= 0
    st = torch.where(inm[:, None], sc["sigma_t"], 0.0)
    ss = torch.where(inm[:, None], sc["sigma_s"], 0.0)
    return inm, st, ss


def _always_valid(sc, med, t_max, u):
    """Distance sampled inside the segment (never failing where there is
    fog), on the green channel: (t, success, transmittance, pdf, sigma_s)."""
    inm, st, ss = _tables(sc, med)
    inm = inm & (st.amax(-1) > 0)
    sig = torch.clamp(st[:, 1], min=1e-20)
    norm = 1.0 - torch.exp(-sig * torch.clamp(t_max - EPSILON, min=0.0))
    ts = -torch.log1p(-u * norm) / sig
    ts = torch.where(inm, ts, torch.inf)
    success = (ts < t_max) & inm
    t = torch.where(ts < t_max, ts, t_max)
    tr = torch.exp(-st * t[:, None])
    tr = torch.where(tr.amax(-1, keepdim=True) < 1e-20, 0.0, tr)
    pdf = pdf_at(sc, med, t, t_max)
    return t, success, torch.where(inm[:, None], tr, 1.0), pdf, ss


def pdf_at(sc, med, t, t_max):
    """The density of that sampler at a known distance t."""
    inm, st, _ = _tables(sc, med)
    inm = inm & (st.amax(-1) > 0)
    sig = st[:, 1]
    norm = 1.0 - torch.exp(-sig * torch.clamp(t_max - EPSILON, min=0.0))
    ps = torch.where(norm > 1e-12, sig / torch.clamp(norm, min=1e-12)
                     * torch.exp(-sig * t), 0.0)
    return torch.where(inm, ps, 0.0)


def _phase(sc, cos):
    return pl.phase(cos, torch.full_like(cos, sc["g"]),
                    torch.full_like(cos, sc["phase"], dtype=torch.int64))


def _f(sc, mat, wi, wo):
    """The diffuse lobe f(wi, wo) (no cosine) in a local frame, the back
    side mirrored; [N, 3]."""
    flip = torch.where(wi[:, 2] < 0, -1.0, 1.0).to(wi.dtype)
    wi = torch.stack([wi[:, 0], wi[:, 1], wi[:, 2] * flip], -1)
    wo = torch.stack([wo[:, 0], wo[:, 1], wo[:, 2] * flip], -1)
    params = _params(sc, mat)
    fr, fg, fb, _ = pl.bsdf(params, wi.unbind(-1), wo.unbind(-1))
    return torch.stack([fr, fg, fb], -1)


def _params(sc, mat):
    zero = torch.zeros(mat.shape, dtype=sc["mat_albedo"].dtype,
                       device=mat.device)
    btype = torch.tensor([PAIR_ID[int(k)] for k in sc["mat_kind"]],
                         device=mat.device)[mat]
    return dict(btype=btype, alb=sc["mat_albedo"][mat].unbind(-1),
                spec=sc["mat_k"][mat].unbind(-1),
                eta3=sc["mat_eta3"][mat].unbind(-1), alpha=zero + 0.1,
                eta1=zero + 1.5)


def _pair_dtype(dtype):
    """The pair terms in float32 (the per-pair formulas' own precision,
    summed in float64), or in a lower precision for the control."""
    return torch.float32 if dtype == torch.float64 else dtype


def _me_pairs(key, budget):
    has = torch.nonzero(key != rg.ME_NONE)[:, 0]
    return has[:budget], has.shape[0] - min(has.shape[0], budget)


def _add_me(S, W, shift_ok, q, ok4, w4, c_sh4, c_base):
    B = q.shape[0]
    w4, c_sh4, c_base = (a.to(S.dtype) for a in (w4, c_sh4, c_base))
    for i in range(OFFSETS):
        sl = slice(i * B, (i + 1) * B)
        ok = ok4[sl, None]
        S[i].index_add_(0, q, torch.where(ok, w4[sl, None] * c_sh4[sl], 0.0))
        W[i].index_add_(0, q, torch.where(ok, (w4[sl, None] - 1.0) * c_base,
                                          0.0))
        shift_ok.index_add_(0, q, ok4[sl].to(shift_ok.dtype))


def _rows(cols3, cols1):
    q = torch.cat([c.to(torch.float32) for c in cols3]
                  + [c.to(torch.float32)[:, None] for c in cols1], 1)
    return torch.nn.functional.pad(q, (0, rg.ROW_F - q.shape[1]))


def _shift(sc, pv, io, c_t, kind, photon=None):
    ch = rme.pull(sc, pv, io.repeat(OFFSETS))
    return rme.shift(sc, ch, c_t, kind, photon)


def volume_gather(sc, cb, scb, table, src, pv, n_emitted, r_vol, key,
                  border, n_samples, min_depth, me, budget,
                  dtype=torch.float64):
    """The volume gather of the base segments `cb` with their offset
    segments `scb` against photon rows `table` (row j the record
    src[j] of `pv`), its distance samples drawn from `key`: (primal
    [M, 3], S [4, M, 3], W [4, M, 3], visits, shift_ok, ME pairs dropped,
    ME pairs taken) in `dtype`."""
    f64 = dtype
    M = cb["valid"].shape[0]
    o, d = cb["o"].to(f64), cb["d"].to(f64)
    length, mi = cb["length"].to(f64), cb["med"]
    r2 = float(r_vol) ** 2
    k3 = 3.0 / (4.0 * math.pi * max(float(r_vol) ** 3, 1e-18))
    svalid = [s["valid"] & (s["med"] == mi) for s in scb]
    sens = [torch.clamp(s["pdf_prod"].to(f64) / torch.clamp(
        cb["pdf_prod"].to(f64), min=1e-20), 1e-4, 1e4) for s in scb]
    tot = [torch.zeros(M, 3, dtype=f64, device=o.device),
           torch.zeros(OFFSETS, M, 3, dtype=f64, device=o.device),
           torch.zeros(OFFSETS, M, 3, dtype=f64, device=o.device),
           torch.zeros(M, dtype=f64, device=o.device),
           torch.zeros(M, dtype=f64, device=o.device), 0, 0]
    for k in rng.split(key, n_samples):
        u = rng.rows(k.to(o.device), cb["gid"], 1, lane_keyed=True)[:, 0]
        t, ok, tr, pdf, ss = _always_valid(sc, mi, length, u.to(f64))
        x = o + d * t[:, None]
        sok = cb["valid"] & ok
        pdf_b = torch.clamp(pdf, min=1e-20)
        w_cam = cb["thr"].to(f64) * tr * ss / pdf_b[:, None]
        xs, cam_ok, prc, thr_s = [], [], [], []
        for i, s in enumerate(scb):
            cam_ok.append(sok & svalid[i] & (s["length"].to(f64) >= t))
            xs.append(s["o"].to(f64) + s["d"].to(f64) * t[:, None])
            prc.append(pdf_at(sc, mi, t, s["length"].to(f64)) / pdf_b
                       * sens[i])
            thr_s.append(s["thr"].to(f64) * tr * ss / pdf_b[:, None])
        g = torch.full_like(t, sc["g"])
        pt = torch.full_like(t, sc["phase"])
        rows = _rows([x, d] + xs + [s["d"] for s in scb],
                     [g, pt, sok, cb["depth"]] + cam_ok + prc
                     + [border[i] for i in range(OFFSETS)])
        out, keys, _ = rg.gather("volume", table, rows, r2, k3, min_depth,
                                 _pair_dtype(dtype))
        out = out.to(f64)
        p_ = w_cam * out[:, 0:3]
        S_ = torch.stack([thr_s[i] * out[:, 3 + 3 * i:6 + 3 * i]
                          for i in range(OFFSETS)])
        W_ = torch.stack([out[:, 15 + 3 * i:18 + 3 * i] * w_cam
                          for i in range(OFFSETS)])
        so = out[:, 28].clone()
        drop = taken = 0
        if me:
            q, drop = _me_pairs(keys, budget)
            taken = q.shape[0]
            if taken:
                io = src[keys[q]]
                a_i = pv["alpha"][io].to(f64)
                ph_p, ph_wi = pv["p"][io].to(f64), pv["wi"][io].to(f64)
                pf_b = _phase(sc, dot(ph_wi, -d[q]))
                c_base = w_cam[q] * a_i * (pf_b * k3)[:, None]
                c_t = torch.cat([xs[i][q] + (ph_p - x[q])
                                 for i in range(OFFSETS)])
                ar, pr, okm, wi_new = _shift(sc, pv, io, c_t, "volume")
                sd = torch.cat([s["d"][q].to(f64) for s in scb])
                pf_s = _phase(sc, dot(wi_new, -sd))
                ok4 = okm & torch.cat([cam_ok[i][q] & ~border[i][q]
                                       for i in range(OFFSETS)])
                w4 = torch.where(ok4, 1.0 / (1.0 + pr * torch.cat(
                    [prc[i][q] for i in range(OFFSETS)])), 1.0)
                c_sh = torch.cat([thr_s[i][q] for i in range(OFFSETS)]) \
                    * (a_i.repeat(OFFSETS, 1) * ar) \
                    * (pf_s * k3)[:, None]
                _add_me(S_, W_, so, q, ok4, w4, c_sh, c_base)
        for j, v in enumerate((p_, S_, W_, out[:, 27], so, drop, taken)):
            tot[j] = tot[j] + v
    inv = 1.0 / (n_samples * n_emitted)
    return (tot[0] * inv, tot[1] * inv, tot[2] * inv) + tuple(tot[3:])


def surface_gather(sc, base, sgps, table, src, pv, n_emitted, border,
                   min_depth, me, budget, dtype=torch.float64):
    """The surface gather of gather points `base` (radius scaled) with
    their offset points `sgps`; the return as volume_gather's."""
    f64 = dtype
    bp, bns = base.p.to(f64), base.ns.to(f64)
    s_ax, t_ax = frame(bns)
    wo_l = to_local(bns, s_ax, t_ax, base.wo.to(f64))
    mat = torch.clamp(base.bsdf, 0, sc["mat_kind"].shape[0] - 1)
    par = _params(sc, mat)
    comp = [s.valid & base.valid & (s.depth == base.depth)
            & (s.bsdf == base.bsdf) for s in sgps]
    sens = [torch.clamp(s.pdf_prod.to(f64) / torch.clamp(
        base.pdf_prod.to(f64), min=1e-20), 1e-4, 1e4) for s in sgps]
    frames = []
    for s in sgps:
        ns = s.ns.to(f64)
        a, b = frame(ns)
        frames.append((ns, a, b, to_local(ns, a, b, s.wo.to(f64))))
    r2 = base.radius.to(f64) ** 2
    cols3 = [bp, bns, s_ax, t_ax, wo_l, sc["mat_albedo"][mat],
             sc["mat_k"][mat], sc["mat_eta3"][mat]]
    for i, s in enumerate(sgps):
        cols3 += [s.p, frames[i][0], frames[i][1], frames[i][2],
                  frames[i][3]]
    cols1 = [par["btype"], par["alpha"], par["eta1"], r2, base.valid,
             base.depth] + comp + sens + [border[i] for i in range(OFFSETS)]
    out, keys, _ = rg.gather("surface", table, _rows(cols3, cols1), 0.0,
                             0.0, min_depth, _pair_dtype(dtype))
    out = out.to(f64)
    inv = 1.0 / n_emitted
    thr = base.thr.to(f64)
    primal = thr * out[:, 0:3] * inv
    S = torch.stack([sgps[i].thr.to(f64) * out[:, 3 + 3 * i:6 + 3 * i] * inv
                     for i in range(OFFSETS)])
    W = torch.stack([out[:, 15 + 3 * i:18 + 3 * i] * thr * inv
                     for i in range(OFFSETS)])
    so = out[:, 28].clone()
    drop = taken = 0
    if me:
        q, drop = _me_pairs(keys, budget)
        taken = q.shape[0]
        if taken:
            io = src[keys[q]]
            a_i = pv["alpha"][io].to(f64)
            ph_p, ph_wi = pv["p"][io].to(f64), pv["wi"][io].to(f64)
            ph_ns = pv["ns"][io].to(f64)
            k2 = (1.0 / math.pi) / torch.clamp(r2[q], min=1e-12)
            f_b = _f(sc, mat[q], wo_l[q],
                     to_local(bns[q], s_ax[q], t_ax[q], -ph_wi))
            c_base = thr[q] * a_i * f_b * (k2 * inv)[:, None]
            c_t = torch.cat([sgps[i].p[q].to(f64) + (ph_p - bp[q])
                             for i in range(OFFSETS)])
            photon = dict(prim=pv["prim"][io].repeat(OFFSETS),
                          ns=ph_ns.repeat(OFFSETS, 1),
                          enter=(dot(ph_wi, ph_ns) < 0).repeat(OFFSETS))
            ar, pr, okm, wi_new = _shift(sc, pv, io, c_t, "surface", photon)

            def cat(fn):
                return torch.cat([fn(i) for i in range(OFFSETS)])
            wi_ls = to_local(cat(lambda i: frames[i][0][q]),
                             cat(lambda i: frames[i][1][q]),
                             cat(lambda i: frames[i][2][q]),
                             -normalize(wi_new))
            smat = cat(lambda i: torch.clamp(sgps[i].bsdf[q], 0,
                                             sc["mat_kind"].shape[0] - 1))
            f_s = _f(sc, smat, cat(lambda i: frames[i][3][q]), wi_ls)
            ok4 = okm & cat(lambda i: comp[i][q] & ~border[i][q])
            w4 = torch.where(ok4, 1.0 / (1.0 + pr), 1.0)
            c_sh = cat(lambda i: sgps[i].thr[q].to(f64)) \
                * (a_i.repeat(OFFSETS, 1) * ar) * f_s \
                * (k2 * inv).repeat(OFFSETS)[:, None]
            _add_me(S, W, so, q, ok4, w4, c_sh, c_base)
    return primal, S, W, out[:, 27], so, drop, taken


def buffers(n, gp5, surf, vol, lane, border, dtype=torch.float64):
    """The pass buffers (primal [n, 3], S [4, n, 3], W [4, n, 3]) from
    the gathers' estimates (vol per segment, splat to its pixel lane)
    and the seen emission of the base and offset paths."""
    f64 = dtype
    em = gp5.emission.to(f64)
    base_em, off_em = em[:n], [em[(i + 1) * n:(i + 2) * n]
                               for i in range(OFFSETS)]

    def to_px(a):
        return torch.zeros(n, 3, dtype=f64, device=a.device).index_add_(
            0, lane, a.to(f64))

    p = surf[0].to(f64) + to_px(vol[0]) + base_em
    S = torch.stack([surf[1][i].to(f64) + to_px(vol[1][i]) + torch.where(
        border[i], 1.0, 0.5)[:, None] * off_em[i] for i in range(OFFSETS)])
    W = torch.stack([surf[2][i].to(f64) + to_px(vol[2][i]) + torch.where(
        border[i], 1.0, 0.5)[:, None] * base_em for i in range(OFFSETS)])
    return p, S, W
