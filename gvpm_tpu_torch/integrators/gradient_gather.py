"""Gradient photon gathers — the G-VPM hot loop (mirrors the fused-kernel
driver of gvpm_tpu/integrators/gradient_gather.py).

Every per-photon field the shift evaluation touches is packed into one
[P, 128] float32 row table (`pack_photons`, the SLOT layout of the JAX
package), permuted into cell order. The surface and volume gathers run
ops/fused_gather over each query's exact cell runs with the eval bodies
below: the ball test, the base kernel term and four diffuse-reconnection
shifts with pairwise MIS (shift_volume_photon.cpp:489-655).

With `use_manifold` the gather kernel also reports, per query, the
lowest row of a pair whose photon cannot reconnect because its parent
is a delta surface. The ME stage then compacts at most `me_budget` such
(query, photon) pairs, walks each photon's parent chain, Newton-solves
the 4 offset targets (integrators/manifold.py) and adds the shifted
contributions; pairs beyond the budget keep the unilateral gradient and
are counted as `me_dropped`.
"""

from __future__ import annotations

import math

import torch

from ..core import rng
from ..core.math import coordinate_system, dot, normalize, to_local
from ..ops import fused_gather as fg
from ..render import medium as med
from ..render import phase as ph
from ..render.bsdf import eval_bsdf, eval_bsdf_pdf_params
from ..scene.types import (BSDF_CONDUCTOR, BSDF_DIELECTRIC, BSDF_NULL,
                           Scene)
from . import manifold
from . import planar as pl

INV_PI = 1.0 / math.pi

# ---------------------------------------------------------------------------
# packed photon rows
# ---------------------------------------------------------------------------

_SLOT3 = ("p", "wi", "alpha", "parent_p", "parent_wi", "parent_ns",
          "scatter_base", "ns", "st",
          "pm_alb", "pm_spec", "pm_eta3", "pm_sigs")
_SLOT1 = ("pdf_dir_base", "parent_type", "parent_bsdf", "parent_med",
          "reconnectable", "vtype", "bsdf", "prim", "depth",
          "pm_btype", "pm_alpha", "pm_eta1", "pm_g", "pm_ptype",
          "pm_delta", "own_delta")


def _mk_slots(f3names, f1names):
    slots, k = {}, 0
    for n in f3names:
        slots[n] = k
        k += 3
    for n in f1names:
        slots[n] = k
        k += 1
    return slots, k


SLOT, N_SLOTS = _mk_slots(_SLOT3, _SLOT1)
ROW_F = 128


def pack_photons(scene: Scene, pv, valid=None):
    """Photon SoA dict -> one [P, 128] float32 row table.

    Integer fields are stored as float32 (exact below 2^24); sigma_t of
    the photon's medium and the parent's material parameters are baked
    in. Dead rows (`valid` False) may hold inf/NaN from dead lanes: they
    are scrubbed to 0, since a masked pair still turns 0*inf into NaN;
    a non-finite value in a live row stays visible."""
    nm = scene.med_sigma_a.shape[0]
    nb = scene.bsdf_type.shape[0]
    mi = torch.clamp(pv["med"], 0, nm - 1)
    st = torch.where((pv["med"] >= 0)[..., None],
                     scene.med_sigma_a[mi] + scene.med_sigma_s[mi], 0.0)
    bic = torch.clamp(pv["parent_bsdf"], 0, nb - 1)
    pmi = torch.clamp(pv["parent_med"], 0, nm - 1)
    pbt = scene.bsdf_type[bic]
    obt = scene.bsdf_type[torch.clamp(pv["bsdf"], 0, nb - 1)]
    derived = dict(
        st=st,
        pm_alb=scene.bsdf_albedo[bic],
        pm_spec=scene.bsdf_k[bic],
        pm_eta3=scene.bsdf_eta3[bic],
        pm_sigs=torch.where((pv["parent_med"] >= 0)[..., None],
                            scene.med_sigma_s[pmi], 0.0),
        pm_btype=pbt,
        pm_alpha=scene.bsdf_alpha[bic],
        pm_eta1=scene.bsdf_eta[bic],
        pm_g=scene.med_g[pmi],
        pm_ptype=scene.med_phase[pmi],
        pm_delta=(pbt == BSDF_CONDUCTOR) | (pbt == BSDF_DIELECTRIC),
        own_delta=(obt == BSDF_CONDUCTOR) | (obt == BSDF_DIELECTRIC)
        | (obt == BSDF_NULL))
    cols = [(derived[n] if n in derived else pv[n]).to(torch.float32)
            for n in _SLOT3]
    cols += [(derived[n] if n in derived else pv[n]).to(torch.float32)
             [..., None] for n in _SLOT1]
    packed = torch.cat(cols, dim=-1)
    scrub = torch.where(torch.isfinite(packed), packed, 0.0)
    packed = scrub if valid is None else torch.where(valid[:, None],
                                                     packed, scrub)
    return torch.nn.functional.pad(packed, (0, ROW_F - N_SLOTS))


def _gp_compatible(base, sgp):
    """Camera-subpath structure compatibility of a shifted gather point
    (ShiftGatherPoint::generate validity, shift_cameraPath.h:29-170)."""
    return (sgp.valid & base.valid & (sgp.depth == base.depth)
            & (sgp.bsdf == base.bsdf))


def _rdiv(c, x):
    """c / x as a true division (torch's scalar / tensor multiplies by
    the reciprocal)."""
    return x.new_full((), c) / x


# ---------------------------------------------------------------------------
# planar reconnection shift on pair planes
# ---------------------------------------------------------------------------

def _shift_caches(v, surface_target):
    """Shift-cache planes shared by all 4 shifts."""
    ph_p = v.f3("p")
    pre = dict(
        bp=v.f3("parent_p"), ptype=v.i1("parent_type"),
        pwi=v.f3("parent_wi"), pns=v.f3("parent_ns"),
        sc_old=v.f3("scatter_base"), pdf_old=v.f1("pdf_dir_base"),
        alpha=v.f3("alpha"), reconn=v.b1("reconnectable"),
        st=v.f3("st"),
        bparams=dict(btype=v.i1("pm_btype"), alb=v.f3("pm_alb"),
                     spec=v.f3("pm_spec"), eta3=v.f3("pm_eta3"),
                     alpha=v.f1("pm_alpha"), eta1=v.f1("pm_eta1")),
        mparams=dict(sigs=v.f3("pm_sigs"), g=v.f1("pm_g"),
                     ptype=v.i1("pm_ptype")),
    )
    d_old = pl.sub3(ph_p, pre["bp"])
    d2_old = torch.clamp(pl.dot3(d_old, d_old), min=1e-12)
    l_old = torch.sqrt(d2_old)
    pre["d2_old"] = d2_old
    pre["l_old"] = l_old
    pre["w_old"] = pl.scale3(d_old, 1.0 / l_old)
    if surface_target:
        pre["ns_p"] = v.f3("ns")
    return pre


def _reconnect_planar(pre, new_p, target_is_volume):
    """Planar diffuse-reconnection shift of a photon's last segment to
    new_p -> (alpha_shift planes (r,g,b), pdf_ratio, ok, w_new)."""
    d_new = pl.sub3(new_p, pre["bp"])
    d2_new = torch.clamp(pl.dot3(d_new, d_new), min=1e-12)
    l_new = torch.sqrt(d2_new)
    w_new = pl.scale3(d_new, 1.0 / l_new)

    sr, sg, sb, pdf_new, ok_sc = pl.parent_scatter_params(
        pre["ptype"], pre["pwi"], pre["pns"], pre["bparams"],
        pre["mparams"], w_new)

    st = pre["st"]
    l_old = pre["l_old"]
    dd = l_new - l_old
    tr_ratio = tuple(torch.exp(-st[c] * dd) for c in range(3))
    if target_is_volume:
        dens_new = (st[0] * torch.exp(-st[0] * l_new)
                    + st[1] * torch.exp(-st[1] * l_new)
                    + st[2] * torch.exp(-st[2] * l_new)) / 3.0
        dens_old = (st[0] * torch.exp(-st[0] * l_old)
                    + st[1] * torch.exp(-st[1] * l_old)
                    + st[2] * torch.exp(-st[2] * l_old)) / 3.0
        pdf_dist_ratio = torch.where(
            dens_old > 1e-20, dens_new / torch.clamp(dens_old, min=1e-20),
            1.0)
        cos_ratio = 1.0
        pdf_cos_ratio = 1.0
    else:
        f_new = (torch.exp(-st[0] * l_new) + torch.exp(-st[1] * l_new)
                 + torch.exp(-st[2] * l_new)) / 3.0
        f_old = (torch.exp(-st[0] * l_old) + torch.exp(-st[1] * l_old)
                 + torch.exp(-st[2] * l_old)) / 3.0
        pdf_dist_ratio = torch.where(
            f_old > 1e-20, f_new / torch.clamp(f_old, min=1e-20), 1.0)
        ns_p = pre["ns_p"]
        cos_new = torch.abs(pl.dot3(ns_p, w_new))
        cos_old = torch.clamp(torch.abs(pl.dot3(ns_p, pre["w_old"])),
                              min=1e-6)
        cos_ratio = cos_new / cos_old
        pdf_cos_ratio = cos_ratio
        par_sf = pre["ptype"] == pl.VERT_SURFACE
        sign_ok = pl.dot3(pre["pns"], w_new) \
            * pl.dot3(pre["pns"], pre["w_old"]) > 0.0
        ok_sc = ok_sc & ((~par_sf) | sign_ok)

    geo = pre["d2_old"] / d2_new * cos_ratio
    sc_old = pre["sc_old"]
    a_sh = tuple(
        pre["alpha"][c] * (s / torch.clamp(sc_old[c], min=1e-20))
        * tr_ratio[c] * geo
        for c, s in enumerate((sr, sg, sb)))
    pdf_ratio = (pdf_new / torch.clamp(pre["pdf_old"], min=1e-20)
                 * pdf_dist_ratio * (pre["d2_old"] / d2_new)
                 * pdf_cos_ratio)
    sc_old_max = torch.maximum(torch.maximum(sc_old[0], sc_old[1]),
                               sc_old[2])
    ok = (ok_sc & pre["reconn"] & (sc_old_max > 0.0)
          & (pre["pdf_old"] > 1e-20) & (pdf_new > 0.0))
    a_sh = tuple(torch.where(ok, a, 0.0) for a in a_sh)
    return a_sh, torch.where(ok, pdf_ratio, 0.0), ok, w_new


def _mis_planar(pdf_ratio_light, pdf_ratio_cam, ok):
    w = 1.0 / (1.0 + pdf_ratio_light * pdf_ratio_cam)
    return torch.clamp(torch.where(ok, w, 1.0), 0.0, 1.0)


# ---------------------------------------------------------------------------
# the two eval bodies of the fused gather (per pair planes; the CUDA
# kernel's csrc/gather_eval.cuh computes the same per pair)
# ---------------------------------------------------------------------------

_VOL_Q3 = ("x", "d", "xs0", "xs1", "xs2", "xs3",
           "sd0", "sd1", "sd2", "sd3")
_VOL_Q1 = ("g", "pt", "sok", "depth",
           "cam_ok0", "cam_ok1", "cam_ok2", "cam_ok3",
           "prc0", "prc1", "prc2", "prc3",
           "border0", "border1", "border2", "border3")
VOL_QSLOTS, _VOL_NQ = _mk_slots(_VOL_Q3, _VOL_Q1)
VOL_QROW_F = 64
VOL_N_OUT = 30   # primal 3 + S 12 + W 12 + visits + shift_ok + dropped


def _me_eligible(inside, pre, r):
    """Pairs that take the ME shift instead of the reconnection: inside
    the ball, not reconnectable, parent a delta surface."""
    return (inside & ~pre["reconn"] & (pre["ptype"] == pl.VERT_SURFACE)
            & r.b1("pm_delta"))


def _volume_pairs(q, r, min_depth, r2, k3, me=False):
    """Volume eval: 3D-kernel primal + 4 reconnection shifts to the
    offset distance samples, per (query, photon) pair; with `me` the
    last plane is the pair's ME eligibility."""
    xq = q.f3("x")
    dq = q.f3("d")
    rel = pl.sub3(r.f3("p"), xq)
    d2 = pl.dot3(rel, rel)
    inside = (r.f1("vtype") == 2.0) & (d2 < r2) & q.b1("sok")
    if min_depth > 0:
        inside = inside & (r.f1("depth") + q.f1("depth") + 1.0
                           >= float(min_depth))
    cos_t = -pl.dot3(r.f3("wi"), dq)
    pf = pl.phase_params(cos_t, q.f1("g"), q.i1("pt"))
    kw = torch.where(inside, pf * k3, 0.0)
    a = r.f3("alpha")
    cb = (a[0] * kw, a[1] * kw, a[2] * kw)
    pre = _shift_caches(r, surface_target=False)
    s_cols, w_cols = [], []
    okc = torch.zeros_like(kw)
    for i in range(4):
        sp = q.f3(f"xs{i}")
        new_p = (sp[0] + rel[0], sp[1] + rel[1], sp[2] + rel[2])
        a_sh, pr_l, ok_s, w_new = _reconnect_planar(
            pre, new_p, target_is_volume=True)
        cos_s = -pl.dot3(w_new, q.f3(f"sd{i}"))
        pf_s = pl.phase_params(cos_s, q.f1("g"), q.i1("pt"))
        ok_i = ok_s & q.b1(f"cam_ok{i}") & inside
        w = _mis_planar(pr_l, q.f1(f"prc{i}"), ok_i)
        w = torch.where(q.b1(f"border{i}"), 1.0, w)
        kwi = torch.where(ok_i, pf_s * k3, 0.0) * w
        s_cols += [a_sh[c] * kwi for c in range(3)]
        w_cols += [w * c for c in cb]
        okc = okc + ok_i.to(torch.float32)
    planes = list(cb) + s_cols + w_cols + [inside.to(torch.float32), okc]
    return planes + [_me_eligible(inside, pre, r)] if me else planes


_SUR_Q3 = ("p", "ns", "s", "t", "wo", "alb", "spec", "eta3",
           "p0", "ns0", "s0", "t0", "wo0",
           "p1", "ns1", "s1", "t1", "wo1",
           "p2", "ns2", "s2", "t2", "wo2",
           "p3", "ns3", "s3", "t3", "wo3")
_SUR_Q1 = ("btype", "alpha_b", "eta1", "r2", "valid", "depth",
           "comp0", "comp1", "comp2", "comp3",
           "sens0", "sens1", "sens2", "sens3",
           "border0", "border1", "border2", "border3")
SUR_QSLOTS, _SUR_NQ = _mk_slots(_SUR_Q3, _SUR_Q1)
SUR_QROW_F = 128
SUR_N_OUT = 30   # primal 3 + S 12 + W 12 + visits + shift_ok + dropped


def _surface_pairs(q, r, min_depth, r2_unused, k3_unused, me=False):
    """Surface eval: 2D-kernel primal + 4 reconnection shifts. The
    shifted gather point's BSDF equals the base's whenever comp[i]
    holds, so the base's baked BSDF parameters serve both. With `me` the
    last plane is the pair's ME eligibility (a photon on a delta BSDF
    itself contributes nothing here and is excluded)."""
    gp_p = q.f3("p")
    r2 = q.f1("r2")
    ns = q.f3("ns")
    rel = pl.sub3(r.f3("p"), gp_p)
    d2 = pl.dot3(rel, rel)
    nwi = pl.neg3(r.f3("wi"))
    front = pl.dot3(ns, nwi) > 1e-4
    inside = ((r.f1("vtype") == 1.0) & (d2 < r2) & front
              & q.b1("valid"))
    if min_depth > 0:
        inside = inside & (r.f1("depth") + q.f1("depth")
                           >= float(min_depth))
    wi_l = pl.to_local_planes(ns, q.f3("s"), q.f3("t"), nwi)
    bparams = dict(btype=q.i1("btype"), alb=q.f3("alb"),
                   spec=q.f3("spec"), eta3=q.f3("eta3"),
                   alpha=q.f1("alpha_b"), eta1=q.f1("eta1"))
    fr, fg, fb, _ = eval_bsdf_pdf_params(bparams, q.f3("wo"), wi_l)
    k2 = _rdiv(INV_PI, torch.clamp(r2, min=1e-12))
    kw = torch.where(inside, k2, 0.0)
    a = r.f3("alpha")
    cb = (a[0] * fr * kw, a[1] * fg * kw, a[2] * fb * kw)
    pre = _shift_caches(r, surface_target=True)
    s_cols, w_cols = [], []
    okc = torch.zeros_like(kw)
    for i in range(4):
        sp = q.f3(f"p{i}")
        new_p = (sp[0] + rel[0], sp[1] + rel[1], sp[2] + rel[2])
        a_sh, pr_l, ok_s, w_new = _reconnect_planar(
            pre, new_p, target_is_volume=False)
        wi_ls = pl.to_local_planes(q.f3(f"ns{i}"), q.f3(f"s{i}"),
                                   q.f3(f"t{i}"), pl.neg3(w_new))
        fs = eval_bsdf_pdf_params(bparams, q.f3(f"wo{i}"), wi_ls)
        ok_i = ok_s & q.b1(f"comp{i}") & inside
        w = _mis_planar(pr_l, q.f1(f"sens{i}"), ok_i)
        w = torch.where(q.b1(f"border{i}"), 1.0, w)
        kwi = torch.where(ok_i, k2, 0.0) * w
        s_cols += [a_sh[c] * fs[c] * kwi for c in range(3)]
        w_cols += [w * c for c in cb]
        okc = okc + ok_i.to(torch.float32)
    planes = list(cb) + s_cols + w_cols + [inside.to(torch.float32), okc]
    return planes + [_me_eligible(inside, pre, r) & ~r.b1("own_delta")] \
        if me else planes


VOLUME_EVAL = fg.GatherEval("volume", VOL_QSLOTS, VOL_QROW_F, SLOT,
                            VOL_N_OUT, _volume_pairs)
SURFACE_EVAL = fg.GatherEval("surface", SUR_QSLOTS, SUR_QROW_F, SLOT,
                             SUR_N_OUT, _surface_pairs)
VOLUME_ME_EVAL = fg.GatherEval("volume_me", VOL_QSLOTS, VOL_QROW_F, SLOT,
                               VOL_N_OUT, _volume_pairs, me=True)
SURFACE_ME_EVAL = fg.GatherEval("surface_me", SUR_QSLOTS, SUR_QROW_F, SLOT,
                                SUR_N_OUT, _surface_pairs, me=True)
EVALS = {ev.name: ev for ev in (SURFACE_EVAL, VOLUME_EVAL, SURFACE_ME_EVAL,
                                VOLUME_ME_EVAL)}


def _qrows(cols3, cols1, width, order):
    """Per-query rows [Q, width] in sorted order."""
    q = torch.cat([c.to(torch.float32) for c in cols3]
                  + [c.to(torch.float32)[:, None] for c in cols1], dim=1)
    q = torch.nn.functional.pad(q, (0, width - q.shape[1]))
    return q[order].contiguous()


def _unpack(plan, out_sorted):
    res = fg.unsort(plan, out_sorted)
    Q = res.shape[0]
    return (res[:, 0:3], res[:, 3:15].reshape(Q, 4, 3).movedim(1, 0),
            res[:, 15:27].reshape(Q, 4, 3).movedim(1, 0),
            res[:, 27].to(torch.int64), res[:, 28].to(torch.int64),
            res[:, 29].sum().to(torch.int64))


def _compact_me(me_row, budget):
    """The ME pairs of one gather, cut to a budget: the first `budget`
    queries (original order) that have an ME pair, as the reference's
    top_k over the 0/1 flags selects them. me_row [Q]: per-query row key
    in original query order. Returns (me_q [B] query ids, me_i [B] table
    rows, dropped pair count); B <= budget. `nonzero` synchronizes with
    the device: B sizes everything downstream."""
    has = torch.nonzero(me_row != fg.ME_NONE)[:, 0]
    me_q = has[:budget]
    return me_q, me_row[me_q].to(torch.int64), \
        torch.tensor(has.shape[0] - me_q.shape[0], device=me_row.device)


def _per_offset(fn):
    """fn(i) of the 4 offsets, concatenated offset-major."""
    return torch.cat([fn(i) for i in range(4)])


def _add_me(S, W, shift_ok, me_q, ok4, w4, c_sh4, c_base_pair):
    """Add the ME pairs' shifted and base terms for the 4 offsets (rows
    i*B..(i+1)*B of the *4 tensors). me_q is unique (one pair per
    query), so the index_add_ is deterministic."""
    B = me_q.shape[0]
    for i in range(4):
        sl = slice(i * B, (i + 1) * B)
        ok_i, w = ok4[sl, None], w4[sl, None]
        S[i].index_add_(0, me_q, torch.where(ok_i, w * c_sh4[sl], 0.0))
        W[i].index_add_(0, me_q, torch.where(ok_i, (w - 1.0) * c_base_pair,
                                             0.0))
        shift_ok.index_add_(0, me_q, ok4[sl].to(shift_ok.dtype))


# ---------------------------------------------------------------------------
# surface photons
# ---------------------------------------------------------------------------

def surface_gather(scene: Scene, base, sgps, grid, packed, n_emitted,
                   border, min_depth=0, use_manifold=False, pv_chain=None,
                   me_budget=4096, me_iters=5, lap=None):
    """Surface photon gather with 4-direction shifts.

    base: GatherPoints (radius already scaled); sgps: the 4 shifted
    GatherPoints; packed: pack_photons rows in `grid` order; border
    [4,N]. With use_manifold, pv_chain is the ORIGINAL-order photon dict
    for the ME chain walks (grid.sorted_idx maps table rows back) and at
    most me_budget ME pairs are shifted, with me_iters Newton steps.
    `lap(name, part=False)`, when given, is called at the end of the
    kernel stage ("surface_gather") and of the ME stage ("surface_me"),
    and with part=True after the ME stage's parts ("me:compact",
    "me:chains" and, inside the shift, "me:newton", "me:ratios",
    "me:occlusion").
    Returns (primal [N,3], S [4,N,3], W [4,N,3], visits [N],
    shift_ok [N], dropped rows (0: the runs are exact), me_dropped
    pairs, me_pairs taken)."""
    r_all = base.radius
    s_ax_all, t_ax_all = coordinate_system(base.ns)
    wo_loc_all = to_local(base.ns, s_ax_all, t_ax_all, base.wo)
    comp = [_gp_compatible(base, sgps[i]) for i in range(4)]
    sens = [torch.clamp(sgps[i].pdf_prod
                        / torch.clamp(base.pdf_prod, min=1e-20), 1e-4, 1e4)
            for i in range(4)]
    sgp_frames = []
    for i in range(4):
        ss, tt = coordinate_system(sgps[i].ns)
        sgp_frames.append((ss, tt, to_local(sgps[i].ns, ss, tt, sgps[i].wo)))
    plan = fg.plan_runs(grid, base.p, base.valid)
    nb = scene.bsdf_type.shape[0]
    bic = torch.clamp(base.bsdf, 0, nb - 1)
    cols3 = [base.p, base.ns, s_ax_all, t_ax_all, wo_loc_all,
             scene.bsdf_albedo[bic], scene.bsdf_k[bic], scene.bsdf_eta3[bic]]
    for i in range(4):
        cols3 += [sgps[i].p, sgps[i].ns, *sgp_frames[i]]
    cols1 = [scene.bsdf_type[bic], scene.bsdf_alpha[bic],
             scene.bsdf_eta[bic], r_all * r_all, base.valid,
             base.depth] + comp + sens + [border[i] for i in range(4)]
    qrows = _qrows(cols3, cols1, SUR_QROW_F, plan.order)
    out, me_sorted = fg.fused_gather(
        SURFACE_ME_EVAL if use_manifold else SURFACE_EVAL, plan,
        packed, qrows, 0.0, 0.0, min_depth)
    primal, S, W, visits, shift_ok, dropped = _unpack(plan, out)
    inv = 1.0 / n_emitted
    primal = base.thr * primal * inv
    S = torch.stack([sgps[i].thr * S[i] * inv for i in range(4)])
    W = W * (base.thr * inv)[None]
    me_drop = me_pairs = torch.zeros((), dtype=torch.int64,
                                     device=primal.device)
    if not use_manifold:
        return primal, S, W, visits, shift_ok, dropped, me_drop, me_pairs

    if lap is not None:
        lap("surface_gather")
    me_q, me_i, me_drop = _compact_me(fg.unsort(plan, me_sorted), me_budget)
    if lap is not None:
        lap("me:compact", part=True)
    B = me_q.shape[0]
    if B:
        me_pairs = me_pairs + B
        wscale = torch.linalg.norm(scene.world_hi - scene.world_lo)
        # chain walks follow parent links in the ORIGINAL photon order
        me_io = grid.sorted_idx[me_i]
        ch4 = manifold.tile_chains(
            manifold.pull_chains(scene, pv_chain, me_io), 4)
        if lap is not None:
            lap("me:chains", part=True)
        a_i = pv_chain["alpha"][me_io]
        ph_p = pv_chain["p"][me_io]
        ph_wi = pv_chain["wi"][me_io]
        ph_ns = pv_chain["ns"][me_io]
        k2 = INV_PI / torch.clamp(r_all[me_q] ** 2, min=1e-12)
        # base pair contribution (for the W weight correction)
        wi_lb = to_local(base.ns[me_q], s_ax_all[me_q], t_ax_all[me_q],
                         -ph_wi)
        f_b, _ = eval_bsdf(scene, bic[me_q], wo_loc_all[me_q], wi_lb)
        c_base_pair = base.thr[me_q] * a_i * f_b * (k2 * inv)[..., None]
        # sphere-root selector at the photon: the base segment arrived
        # from outside iff wi points against the outward normal
        ph_enter = dot(ph_wi, ph_ns) < 0.0
        # the 4 offset targets of every pair in one solve, offset-major
        c_t = torch.cat([sgps[i].p[me_q] + (ph_p - base.p[me_q])
                         for i in range(4)])
        ar, pr, okm, wi_new = manifold.me_shift_surface(
            scene, ch4, pv_chain["prim"][me_io].repeat(4),
            ph_ns.repeat(4, 1), ph_enter.repeat(4), c_t, n_iters=me_iters,
            scene_scale=wscale, lap=lap)

        wi_ls = to_local(_per_offset(lambda i: sgps[i].ns[me_q]),
                         _per_offset(lambda i: sgp_frames[i][0][me_q]),
                         _per_offset(lambda i: sgp_frames[i][1][me_q]),
                         -normalize(wi_new))
        f_s, _ = eval_bsdf(
            scene, _per_offset(lambda i: torch.clamp(sgps[i].bsdf[me_q], 0,
                                                    nb - 1)),
            _per_offset(lambda i: sgp_frames[i][2][me_q]), wi_ls)
        ok4 = okm & _per_offset(lambda i: comp[i][me_q] & ~border[i][me_q])
        w4 = torch.where(ok4, 1.0 / (1.0 + pr), 1.0)
        c_sh4 = _per_offset(lambda i: sgps[i].thr[me_q]) \
            * (a_i.repeat(4, 1) * ar) * f_s * (k2 * inv).repeat(4)[..., None]
        _add_me(S, W, shift_ok, me_q, ok4, w4, c_sh4, c_base_pair)
    if lap is not None:
        lap("surface_me")
    return primal, S, W, visits, shift_ok, dropped, me_drop, me_pairs


# ---------------------------------------------------------------------------
# volume photon points (VPM distance sampling, 3D kernel)
# ---------------------------------------------------------------------------

def volume_gather(scene: Scene, cb, scb_list, grid, packed, n_emitted,
                  r_vol, key, border_lane, n_samples=2, min_depth=0,
                  use_manifold=False, pv_chain=None, me_budget=4096,
                  me_iters=5, lap=None):
    """VPM/distance gather with 4-direction shifts.

    cb: base camera-segment dict (flattened [M], with the lane ids `gid`
    that key the distance randoms); scb_list: the 4 shifted segment
    dicts; r_vol: float32 scalar tensor; use_manifold / pv_chain /
    me_budget / me_iters / lap as in surface_gather (phases
    "volume_gather" and "volume_me", once per distance sample; the
    budget is per sample). Returns (primal [M,3], S [4,M,3], W [4,M,3],
    visits [M], shift_ok [M], dropped rows, me_dropped pairs, me_pairs
    taken)."""
    o, d, length, mi = cb["o"], cb["d"], cb["length"], cb["med"]
    r2 = float(r_vol * r_vol)
    k3 = float(_rdiv(3.0, 4.0 * math.pi * torch.clamp(
        r_vol * r_vol * r_vol, min=1e-18)))
    svalid = [scb_list[i]["valid"] & (scb_list[i]["med"] == mi)
              for i in range(4)]
    sens = [torch.clamp(scb_list[i]["pdf_prod"]
                        / torch.clamp(cb["pdf_prod"], min=1e-20), 1e-4, 1e4)
            for i in range(4)]
    mic = torch.clamp(mi, 0, scene.med_g.shape[0] - 1)
    ev = VOLUME_ME_EVAL if use_manifold else VOLUME_EVAL

    tot = None
    for k in rng.split(key, n_samples):
        u = rng.lane_uniform(k, cb["gid"])
        ms = med.sample_distance(scene, mi, o, d, length, u,
                                 strategy=med.ALWAYS_VALID)
        x, t = ms.p, ms.t
        sok = cb["valid"] & ms.success
        pdf_base_ray = torch.clamp(ms.pdf_success, min=1e-20)
        w_cam = cb["thr"] * ms.transmittance * ms.sigma_s \
            / pdf_base_ray[..., None]
        xs, cam_ok, prc, thr_s = [], [], [], []
        for i in range(4):
            s = scb_list[i]
            cam_ok.append(sok & svalid[i] & (s["length"] >= t))
            xs.append(s["o"] + s["d"] * t[..., None])
            ps_i = med.pdf_distance_always_valid(scene, mi, t, s["length"])
            prc.append(ps_i / pdf_base_ray * sens[i])
            thr_s.append(s["thr"] * ms.transmittance * ms.sigma_s
                         / pdf_base_ray[..., None])
        plan = fg.plan_runs(grid, x, sok)
        cols3 = [x, d] + xs + [scb_list[i]["d"] for i in range(4)]
        cols1 = [scene.med_g[mic], scene.med_phase[mic], sok,
                 cb["depth"]] + cam_ok + prc \
            + [border_lane[i] for i in range(4)]
        qrows = _qrows(cols3, cols1, VOL_QROW_F, plan.order)
        out, me_sorted = fg.fused_gather(ev, plan, packed, qrows, r2, k3,
                                         min_depth)
        p_, S_, W_, v_, so_, dr_ = _unpack(plan, out)
        p_ = w_cam * p_
        S_ = torch.stack([thr_s[i] * S_[i] for i in range(4)])
        W_ = W_ * w_cam[None]
        me_drop = me_pairs = torch.zeros((), dtype=torch.int64,
                                         device=p_.device)
        if use_manifold:
            if lap is not None:
                lap("volume_gather")
            me_q, me_i, me_drop = _compact_me(fg.unsort(plan, me_sorted),
                                              me_budget)
            if lap is not None:
                lap("me:compact", part=True)
            B = me_q.shape[0]
            if B:
                me_pairs = me_pairs + B
                wscale = torch.linalg.norm(scene.world_hi - scene.world_lo)
                me_io = grid.sorted_idx[me_i]
                ch4 = manifold.tile_chains(
                    manifold.pull_chains(scene, pv_chain, me_io), 4)
                if lap is not None:
                    lap("me:chains", part=True)
                a_i = pv_chain["alpha"][me_io]
                ph_p = pv_chain["p"][me_io]
                ph_wi = pv_chain["wi"][me_io]
                mi_q = mi[me_q]
                pf_b = ph.eval_phase(scene, mi_q, -ph_wi, -d[me_q])
                c_base_pair = w_cam[me_q] * a_i * (pf_b * k3)[..., None]
                c_t = torch.cat([xs[i][me_q] + (ph_p - x[me_q])
                                 for i in range(4)])
                ar, pr, okm, wi_new = manifold.me_shift_volume(
                    scene, ch4, c_t, n_iters=me_iters, scene_scale=wscale,
                    lap=lap)

                pf_s = ph.eval_phase(
                    scene, mi_q.repeat(4), -wi_new,
                    _per_offset(lambda i: -scb_list[i]["d"][me_q]))
                ok4 = okm & _per_offset(
                    lambda i: cam_ok[i][me_q] & ~border_lane[i][me_q])
                w4 = torch.where(
                    ok4, 1.0 / (1.0 + pr * _per_offset(
                        lambda i: prc[i][me_q])), 1.0)
                c_sh4 = _per_offset(lambda i: thr_s[i][me_q]) \
                    * (a_i.repeat(4, 1) * ar) * (pf_s * k3)[..., None]
                _add_me(S_, W_, so_, me_q, ok4, w4, c_sh4, c_base_pair)
            if lap is not None:
                lap("volume_me")
        res = [p_, S_, W_, v_, so_, dr_, me_drop, me_pairs]
        tot = res if tot is None else [a + b for a, b in zip(tot, res)]
    primal, S, W, visits, shift_ok, dropped, me_drop, me_pairs = tot
    inv = 1.0 / (n_samples * n_emitted)
    return (primal * inv, S * inv, W * inv, visits, shift_ok, dropped,
            me_drop, me_pairs)
