"""Plain reference of the gradient photon gathers (the program's K1 / K2
kernels and their ME instantiations): every (query, photon row) pair
within the kernel radius, found by this file's own uniform grid over the
rows, evaluated with the per-pair formulas (base kernel term, four
diffuse-reconnection shifts, pairwise MIS) and summed per query in
float64.

It reads the packed photon rows and query rows that the timed pass built
(the program's state at the gather's entry) and works out the rows again
from the light pass's records (`pack_rows`), so that the packing and the
cell grid are checked by themselves (check.py). The slot layouts below
are the row format the program's gathers read.
"""

from __future__ import annotations

import math

import torch

from . import planar as pl

# photon rows: three-float fields, then one-float fields, padded to 128
ROW3 = ("p", "wi", "alpha", "parent_p", "parent_wi", "parent_ns",
        "scatter_base", "ns", "st", "pm_alb", "pm_spec", "pm_eta3",
        "pm_sigs")
ROW1 = ("pdf_dir_base", "parent_type", "parent_bsdf", "parent_med",
        "reconnectable", "vtype", "bsdf", "prim", "depth", "pm_btype",
        "pm_alpha", "pm_eta1", "pm_g", "pm_ptype", "pm_delta", "own_delta")
ROW_F = 128
VOL_Q3 = ("x", "d", "xs0", "xs1", "xs2", "xs3", "sd0", "sd1", "sd2", "sd3")
VOL_Q1 = ("g", "pt", "sok", "depth", "cam_ok0", "cam_ok1", "cam_ok2",
          "cam_ok3", "prc0", "prc1", "prc2", "prc3", "border0", "border1",
          "border2", "border3")
SUR_Q3 = ("p", "ns", "s", "t", "wo", "alb", "spec", "eta3",
          "p0", "ns0", "s0", "t0", "wo0", "p1", "ns1", "s1", "t1", "wo1",
          "p2", "ns2", "s2", "t2", "wo2", "p3", "ns3", "s3", "t3", "wo3")
SUR_Q1 = ("btype", "alpha_b", "eta1", "r2", "valid", "depth",
          "comp0", "comp1", "comp2", "comp3", "sens0", "sens1", "sens2",
          "sens3", "border0", "border1", "border2", "border3")
N_ACC = 29          # primal 3, S 4 x 3, W 4 x 3, visits, shift_ok
ME_NONE = 2 ** 31 - 1
VERT_NONE = 0
BSDF_CONDUCTOR, BSDF_DIELECTRIC, BSDF_NULL = 1, 2, 5
MAX_PAIRS = 1 << 21  # candidate pairs evaluated at once


def _slots(f3, f1):
    slots, k = {}, 0
    for n in f3:
        slots[n], k = k, k + 3
    for n in f1:
        slots[n], k = k, k + 1
    return slots, k


ROW_SLOT, N_ROW_SLOTS = _slots(ROW3, ROW1)
VOL_QSLOT, _ = _slots(VOL_Q3, VOL_Q1)
SUR_QSLOT, _ = _slots(SUR_Q3, SUR_Q1)


class Cols:
    """Named planes of packed rows `table` gathered at rows `idx`."""

    def __init__(self, table, idx, slots):
        self.table, self.idx, self.slots, self.cache = table, idx, slots, {}

    def col(self, k):
        if k not in self.cache:
            self.cache[k] = self.table[self.idx, k]
        return self.cache[k]

    def f3(self, name):
        k = self.slots[name]
        return (self.col(k), self.col(k + 1), self.col(k + 2))

    def f1(self, name):
        return self.col(self.slots[name])

    def i1(self, name):
        return self.f1(name).to(torch.int64)

    def b1(self, name):
        return self.f1(name) > 0.5


def pack_rows(scene, pv):
    """The light pass's photon records -> [P, 128] float32 rows: the
    records' fields, sigma_t of the photon's medium and its parent's
    material parameters from the scene's tables; dead lanes' non-finite
    values scrubbed to 0."""
    nm, nb = scene.med_sigma_a.shape[0], scene.bsdf_type.shape[0]
    mi = torch.clamp(pv["med"], 0, nm - 1)
    bic = torch.clamp(pv["parent_bsdf"], 0, nb - 1)
    pmi = torch.clamp(pv["parent_med"], 0, nm - 1)
    pbt = scene.bsdf_type[bic]
    obt = scene.bsdf_type[torch.clamp(pv["bsdf"], 0, nb - 1)]
    delta = (BSDF_CONDUCTOR, BSDF_DIELECTRIC)
    derived = dict(
        st=torch.where((pv["med"] >= 0)[..., None],
                       scene.med_sigma_a[mi] + scene.med_sigma_s[mi], 0.0),
        pm_alb=scene.bsdf_albedo[bic], pm_spec=scene.bsdf_k[bic],
        pm_eta3=scene.bsdf_eta3[bic],
        pm_sigs=torch.where((pv["parent_med"] >= 0)[..., None],
                            scene.med_sigma_s[pmi], 0.0),
        pm_btype=pbt, pm_alpha=scene.bsdf_alpha[bic],
        pm_eta1=scene.bsdf_eta[bic], pm_g=scene.med_g[pmi],
        pm_ptype=scene.med_phase[pmi],
        pm_delta=(pbt == delta[0]) | (pbt == delta[1]),
        own_delta=(obt == delta[0]) | (obt == delta[1]) | (obt == BSDF_NULL))
    cols = [derived.get(n, pv.get(n)).to(torch.float32) for n in ROW3]
    cols += [derived.get(n, pv.get(n)).to(torch.float32)[..., None]
             for n in ROW1]
    rows = torch.cat(cols, dim=-1)
    live = (pv["vtype"] != VERT_NONE)[:, None]
    rows = torch.where(torch.isfinite(rows) | live, rows, 0.0)
    return torch.nn.functional.pad(rows, (0, ROW_F - N_ROW_SLOTS))


# ---------------------------------------------------------------------------
# per-pair terms
# ---------------------------------------------------------------------------

def _shift_caches(v, surface_target):
    ph_p = v.f3("p")
    pre = dict(
        bp=v.f3("parent_p"), ptype=v.i1("parent_type"),
        pwi=v.f3("parent_wi"), pns=v.f3("parent_ns"),
        sc_old=v.f3("scatter_base"), pdf_old=v.f1("pdf_dir_base"),
        alpha=v.f3("alpha"), reconn=v.b1("reconnectable"), st=v.f3("st"),
        bparams=dict(btype=v.i1("pm_btype"), alb=v.f3("pm_alb"),
                     spec=v.f3("pm_spec"), eta3=v.f3("pm_eta3"),
                     alpha=v.f1("pm_alpha"), eta1=v.f1("pm_eta1")),
        mparams=dict(sigs=v.f3("pm_sigs"), g=v.f1("pm_g"),
                     ptype=v.i1("pm_ptype")))
    d_old = pl.sub3(ph_p, pre["bp"])
    d2_old = torch.clamp(pl.dot3(d_old, d_old), min=1e-12)
    l_old = torch.sqrt(d2_old)
    pre.update(d2_old=d2_old, l_old=l_old, w_old=pl.scale3(d_old, 1.0 / l_old))
    if surface_target:
        pre["ns_p"] = v.f3("ns")
    return pre


def _reconnect(pre, new_p, target_is_volume):
    """Diffuse reconnection of a photon's last segment to new_p ->
    (shifted alpha planes, light pdf ratio, ok, new direction)."""
    d_new = pl.sub3(new_p, pre["bp"])
    d2_new = torch.clamp(pl.dot3(d_new, d_new), min=1e-12)
    l_new = torch.sqrt(d2_new)
    w_new = pl.scale3(d_new, 1.0 / l_new)
    sr, sg, sb, pdf_new, ok_sc = pl.parent_scatter(
        pre["ptype"], pre["pwi"], pre["pns"], pre["bparams"],
        pre["mparams"], w_new)
    st, l_old = pre["st"], pre["l_old"]
    tr_ratio = tuple(torch.exp(-st[c] * (l_new - l_old)) for c in range(3))
    one = torch.ones_like(l_new)
    if target_is_volume:
        def dens(l):
            return (st[0] * torch.exp(-st[0] * l) + st[1] * torch.exp(
                -st[1] * l) + st[2] * torch.exp(-st[2] * l)) / 3.0
        dn, do = dens(l_new), dens(l_old)
        pdf_dist_ratio = torch.where(do > 1e-20,
                                     dn / torch.clamp(do, min=1e-20), one)
        cos_ratio = pdf_cos_ratio = 1.0
    else:
        def surv(l):
            return (torch.exp(-st[0] * l) + torch.exp(-st[1] * l)
                    + torch.exp(-st[2] * l)) / 3.0
        fn, fo = surv(l_new), surv(l_old)
        pdf_dist_ratio = torch.where(fo > 1e-20,
                                     fn / torch.clamp(fo, min=1e-20), one)
        cos_new = torch.abs(pl.dot3(pre["ns_p"], w_new))
        cos_old = torch.clamp(torch.abs(pl.dot3(pre["ns_p"], pre["w_old"])),
                              min=1e-6)
        cos_ratio = pdf_cos_ratio = cos_new / cos_old
        sign_ok = pl.dot3(pre["pns"], w_new) \
            * pl.dot3(pre["pns"], pre["w_old"]) > 0.0
        ok_sc = ok_sc & ((pre["ptype"] != pl.VERT_SURFACE) | sign_ok)
    geo = pre["d2_old"] / d2_new * cos_ratio
    sc_old = pre["sc_old"]
    a_sh = tuple(pre["alpha"][c] * (s / torch.clamp(sc_old[c], min=1e-20))
                 * tr_ratio[c] * geo for c, s in enumerate((sr, sg, sb)))
    pdf_ratio = (pdf_new / torch.clamp(pre["pdf_old"], min=1e-20)
                 * pdf_dist_ratio * (pre["d2_old"] / d2_new) * pdf_cos_ratio)
    sc_max = torch.maximum(torch.maximum(sc_old[0], sc_old[1]), sc_old[2])
    ok = (ok_sc & pre["reconn"] & (sc_max > 0.0) & (pre["pdf_old"] > 1e-20)
          & (pdf_new > 0.0))
    zero = torch.zeros_like(l_new)
    return (tuple(torch.where(ok, a, zero) for a in a_sh),
            torch.where(ok, pdf_ratio, zero), ok, w_new)


def _mis(pdf_ratio_light, pdf_ratio_cam, ok):
    w = 1.0 / (1.0 + pdf_ratio_light * pdf_ratio_cam)
    return torch.clamp(torch.where(ok, w, torch.ones_like(w)), 0.0, 1.0)


def _me_eligible(inside, pre, r):
    return (inside & ~pre["reconn"] & (pre["ptype"] == pl.VERT_SURFACE)
            & r.b1("pm_delta"))


def volume_pairs(q, r, min_depth, r2, k3):
    """3D-kernel base term and four shifts to the offset distance
    samples of each (query, photon) pair -> N_ACC planes and the ME
    eligibility plane."""
    xq, dq = q.f3("x"), q.f3("d")
    rel = pl.sub3(r.f3("p"), xq)
    d2 = pl.dot3(rel, rel)
    inside = (r.f1("vtype") == 2.0) & (d2 < r2) & q.b1("sok")
    if min_depth > 0:
        inside = inside & (r.f1("depth") + q.f1("depth") + 1.0
                           >= float(min_depth))
    pf = pl.phase(-pl.dot3(r.f3("wi"), dq), q.f1("g"), q.i1("pt"))
    zero = torch.zeros_like(pf)
    kw = torch.where(inside, pf * k3, zero)
    a = r.f3("alpha")
    cb = (a[0] * kw, a[1] * kw, a[2] * kw)
    pre = _shift_caches(r, surface_target=False)
    s_cols, w_cols, okc = [], [], zero
    for i in range(4):
        sp = q.f3(f"xs{i}")
        a_sh, pr_l, ok_s, w_new = _reconnect(
            pre, (sp[0] + rel[0], sp[1] + rel[1], sp[2] + rel[2]), True)
        pf_s = pl.phase(-pl.dot3(w_new, q.f3(f"sd{i}")), q.f1("g"),
                        q.i1("pt"))
        ok_i = ok_s & q.b1(f"cam_ok{i}") & inside
        w = _mis(pr_l, q.f1(f"prc{i}"), ok_i)
        w = torch.where(q.b1(f"border{i}"), torch.ones_like(w), w)
        kwi = torch.where(ok_i, pf_s * k3, zero) * w
        s_cols += [a_sh[c] * kwi for c in range(3)]
        w_cols += [w * c for c in cb]
        okc = okc + ok_i.to(okc.dtype)
    return list(cb) + s_cols + w_cols + [inside.to(okc.dtype), okc], \
        _me_eligible(inside, pre, r)


def surface_pairs(q, r, min_depth, r2_unused, k3_unused):
    """2D-kernel base term and four shifts of each (gather point,
    photon) pair -> N_ACC planes and the ME eligibility plane."""
    r2 = q.f1("r2")
    ns = q.f3("ns")
    rel = pl.sub3(r.f3("p"), q.f3("p"))
    d2 = pl.dot3(rel, rel)
    nwi = pl.neg3(r.f3("wi"))
    inside = ((r.f1("vtype") == 1.0) & (d2 < r2)
              & (pl.dot3(ns, nwi) > 1e-4) & q.b1("valid"))
    if min_depth > 0:
        inside = inside & (r.f1("depth") + q.f1("depth")
                           >= float(min_depth))
    bparams = dict(btype=q.i1("btype"), alb=q.f3("alb"), spec=q.f3("spec"),
                   eta3=q.f3("eta3"), alpha=q.f1("alpha_b"),
                   eta1=q.f1("eta1"))
    fr, fg, fb, _ = pl.bsdf(bparams, q.f3("wo"),
                            pl.to_local(ns, q.f3("s"), q.f3("t"), nwi))
    k2 = pl.rdiv(1.0 / math.pi, torch.clamp(r2, min=1e-12))
    zero = torch.zeros_like(k2)
    kw = torch.where(inside, k2, zero)
    a = r.f3("alpha")
    cb = (a[0] * fr * kw, a[1] * fg * kw, a[2] * fb * kw)
    pre = _shift_caches(r, surface_target=True)
    s_cols, w_cols, okc = [], [], zero
    for i in range(4):
        sp = q.f3(f"p{i}")
        a_sh, pr_l, ok_s, w_new = _reconnect(
            pre, (sp[0] + rel[0], sp[1] + rel[1], sp[2] + rel[2]), False)
        fs = pl.bsdf(bparams, q.f3(f"wo{i}"),
                     pl.to_local(q.f3(f"ns{i}"), q.f3(f"s{i}"),
                                 q.f3(f"t{i}"), pl.neg3(w_new)))
        ok_i = ok_s & q.b1(f"comp{i}") & inside
        w = _mis(pr_l, q.f1(f"sens{i}"), ok_i)
        w = torch.where(q.b1(f"border{i}"), torch.ones_like(w), w)
        kwi = torch.where(ok_i, k2, zero) * w
        s_cols += [a_sh[c] * fs[c] * kwi for c in range(3)]
        w_cols += [w * c for c in cb]
        okc = okc + ok_i.to(okc.dtype)
    return list(cb) + s_cols + w_cols + [inside.to(okc.dtype), okc], \
        _me_eligible(inside, pre, r) & ~r.b1("own_delta")


# ---------------------------------------------------------------------------
# pair enumeration: a uniform grid of cells no smaller than the radius
# ---------------------------------------------------------------------------

OFFS27 = [(dx, dy, dz) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
          for dx in (-1, 0, 1)]


def neighbour_pairs(xq, qvalid, pp, cell, max_pairs=MAX_PAIRS):
    """Every (query, point) pair whose point lies in the 27 cells around
    the query's cell, cells of side `cell` (at least the radius): yields
    (q index [n], point index [n]) in chunks of whole queries."""
    dev = xq.device
    lo = pp.min(0).values - cell
    ip = torch.floor((pp - lo) / cell).to(torch.int64)
    dims = ip.max(0).values + 2
    key = (ip[:, 2] * dims[1] + ip[:, 1]) * dims[0] + ip[:, 0]
    order = torch.argsort(key)
    ks = key[order]
    g = torch.floor((xq - lo) / cell)
    g = torch.nan_to_num(g, nan=-4.0, posinf=-4.0, neginf=-4.0)
    iq = torch.clamp(g, -4.0, float(dims.max()) + 4.0).to(torch.int64)
    off = torch.tensor(OFFS27, device=dev)
    c = iq[:, None, :] + off[None]                          # [Q, 27, 3]
    inb = ((c >= 0) & (c < dims)).all(-1) & qvalid[:, None]
    ck = (c[..., 2] * dims[1] + c[..., 1]) * dims[0] + c[..., 0]
    start = torch.searchsorted(ks, ck)
    lens = torch.where(inb, torch.searchsorted(ks, ck, right=True) - start,
                       0)
    cum = torch.cumsum(lens.sum(1), 0)
    Q, s = xq.shape[0], 0
    while s < Q:
        base = int(cum[s - 1]) if s else 0
        e = int(torch.searchsorted(cum, base + max_pairs, right=True))
        e = min(max(e, s + 1), Q)
        ln = lens[s:e].reshape(-1)
        run = torch.repeat_interleave(torch.arange(ln.shape[0], device=dev),
                                      ln)
        if run.numel():
            first = torch.cumsum(ln, 0) - ln
            pos = torch.arange(run.shape[0], device=dev) - first[run]
            yield s + run // 27, order[start[s:e].reshape(-1)[run] + pos]
        s = e


def gather(kind, table, qrows, r2, k3, min_depth, dtype=torch.float32):
    """The reference of one gather call: `kind` "volume" or "surface";
    table [P, 128] photon rows; qrows [Q, F] query rows. Returns (sums
    [Q, N_ACC] float64, ME key [Q] int64: the lowest row of a query's
    ME-eligible pairs, ME_NONE where it has none, and the number of
    photon rows that some pair within the radius reads). `dtype` is the
    precision the pair terms are computed in (the sums are float64)."""
    surface = kind == "surface"
    qslot = SUR_QSLOT if surface else VOL_QSLOT
    vt = 1.0 if surface else 2.0
    rows = torch.nonzero(table[:, ROW_SLOT["vtype"]] == vt)[:, 0]
    Q, dev = qrows.shape[0], qrows.device
    out = torch.zeros((Q, N_ACC), dtype=torch.float64, device=dev)
    key = torch.full((Q,), ME_NONE, dtype=torch.int64, device=dev)
    hit = torch.zeros((table.shape[0],), dtype=torch.bool, device=dev)
    if rows.numel() == 0:
        return out, key, 0
    k = qslot["p" if surface else "x"]
    xq = qrows[:, k:k + 3]
    qvalid = qrows[:, qslot["valid" if surface else "sok"]] > 0.5
    if not bool(qvalid.any()):
        return out, key, 0
    r2max = float(qrows[qvalid, qslot["r2"]].max()) if surface else r2
    cell = max(math.sqrt(r2max), 1e-6)
    tq, tr = qrows.to(dtype), table.to(dtype)
    pair = surface_pairs if surface else volume_pairs
    pts = table[rows, ROW_SLOT["p"]:ROW_SLOT["p"] + 3]
    for qi, pi in neighbour_pairs(xq, qvalid, pts, cell):
        row = rows[pi]
        planes, me = pair(Cols(tq, qi, qslot), Cols(tr, row, ROW_SLOT),
                          min_depth, r2, k3)
        out.index_add_(0, qi, torch.stack(planes, 1).to(torch.float64))
        key.scatter_reduce_(0, qi, torch.where(me, row, ME_NONE), "amin")
        hit[row[planes[N_ACC - 2] > 0]] = True
    return out, key, int(hit.sum())
