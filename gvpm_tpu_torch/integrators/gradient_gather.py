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

The gradient photon beams and planes (beam1d, beam3d, plane0d) pair
every camera segment with every beam or plane in the pair sweeps of
ops/beam_sweep.py (a CUDA kernel on the card): the base estimate, and a
light-side shift to each offset pixel (a reconnection at the beam's
origin, or the identity for a beam that leaves a non-reconnectable
vertex), with pairwise MIS. With `use_manifold` a beam that leaves a
delta vertex it cannot reconnect takes no identity shift: the sweep
reports each segment's first such beam, and an ME stage like the
photons' (budgeted per segment chunk) chain-solves the beam through the
offset points (manifold.me_shift_beam).
"""

from __future__ import annotations

import math

import torch

from ..core import rng
from ..core.math import coordinate_system, cross, dot, normalize, to_local
from ..ops import beam_sweep as bs
from ..ops import fused_gather as fg
from ..ops import hashgrid
from ..render import medium as med
from ..render import phase as ph
from ..render.bsdf import eval_bsdf, eval_bsdf_pdf_params
from ..scene.types import (BSDF_CONDUCTOR, BSDF_DIELECTRIC, BSDF_NULL,
                           Scene)
from . import estimators as est
from . import manifold
from . import planar as pl

INV_PI = 1.0 / math.pi
# gradient BRE march: steps of 2 r_vol per camera segment (the JAX
# package's max_steps)
BRE_STEPS = 24

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
    k2 = pl.rdiv(INV_PI, torch.clamp(r2, min=1e-12))
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
    k3 = float(pl.rdiv(3.0, 4.0 * math.pi * torch.clamp(
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


# ---------------------------------------------------------------------------
# gradient BRE (2D kernel, deterministic foot point)
# ---------------------------------------------------------------------------

def bre_gather(scene: Scene, cb, scb_list, grid, packed, n_emitted, r_vol,
               border_lane, max_per_cell=16, min_depth=0):
    """Gradient BRE with 4-direction shifts (gvpm_tpu's
    gradient_gather.bre_gather, as plain PyTorch on the hash grid).

    The camera segments are marched in BRE_STEPS steps of 2 r_vol; grid:
    hashgrid.build_sorted of pack_photons rows with cell 2 r_vol, so the
    27-stencil around a step's midpoint covers every photon whose foot
    point lies in the step (exact cell fingerprints: the step test is no
    ball). A photon's disc term is the base; each shift moves the foot
    point to the offset segment at the same t and reconnects the
    photon's last segment to keep its offset (_reconnect_planar), with
    pairwise MIS; the camera-side pdf ratio is 1. Returns (primal [M,3],
    S [4,M,3], W [4,M,3], visits [M], shift_ok [M])."""
    o, d, length, mi = cb["o"], cb["d"], cb["length"], cb["med"]
    valid = cb["valid"]
    m = o.shape[0]
    dev = o.device
    _, sigma_s, st_cam = med._tables(scene, mi)
    step = 2.0 * r_vol
    k2 = pl.rdiv(INV_PI, torch.clamp(r_vol * r_vol, min=1e-12))
    r2 = r_vol * r_vol
    svalid = [scb_list[i]["valid"] & (scb_list[i]["med"] == mi)
              for i in range(4)]
    # sensorMIS: offset / base camera-subpath pdf ratio
    # (gvpm_struct.h:608-631)
    sens = [torch.clamp(scb_list[i]["pdf_prod"]
                        / torch.clamp(cb["pdf_prod"], min=1e-20), 1e-4, 1e4)
            for i in range(4)]
    f32 = dict(dtype=torch.float32, device=dev)
    primal = torch.zeros((m, 3), **f32)
    S = torch.zeros((4, m, 3), **f32)
    W = torch.zeros((4, m, 3), **f32)
    visits = torch.zeros((m,), dtype=torch.int64, device=dev)
    shift_ok = torch.zeros((m,), dtype=torch.int64, device=dev)
    for kstep in range(BRE_STEPS):
        t_mid = step * (kstep + 0.5)
        x = o + d * t_mid
        live = valid & (t_mid - 0.5 * step < length)
        t_lo, t_hi = step * float(kstep), step * float(kstep + 1)

        def eval_fn(qi, idx, ok, scale):
            oq, dq = pl.expand(o[qi]), pl.expand(d[qi])
            v = fg._Cols(packed, idx, SLOT)
            ph_p = v.f3("p")
            t_proj = pl.dot3(pl.sub3(ph_p, oq), dq)
            in_step = (t_proj >= t_lo) & (t_proj < t_hi) & (t_proj >= 0.0) \
                & (t_proj <= length[qi][:, None])
            rel = pl.sub3(ph_p, oq)
            perp = tuple(rel[c] - dq[c] * t_proj for c in range(3))
            inside = ok & (v.i1("vtype") == pl.VERT_MEDIUM) & in_step \
                & (pl.dot3(perp, perp) < r2) & live[qi][:, None]
            if min_depth > 0:
                inside = inside & (v.i1("depth") + cb["depth"][qi][:, None]
                                   + 1 >= min_depth)
            miq = mi[qi][:, None]
            pf = pl.eval_phase_planar(scene, miq, -pl.dot3(v.f3("wi"), dq))
            stq, ssq = st_cam[qi], sigma_s[qi]
            a = v.f3("alpha")
            kw = torch.where(inside, pf * k2 * scale, 0.0)
            cb_pl = tuple(a[c] * ssq[:, c:c + 1]
                          * torch.exp(-stq[:, c:c + 1] * t_proj) * kw
                          for c in range(3))
            foot = tuple(oq[c] + dq[c] * t_proj for c in range(3))
            pre = _shift_caches(v, surface_target=False)
            S_, W_ = [], []
            ok_count = torch.zeros(idx.shape[0], dtype=torch.int64,
                                   device=idx.device)
            for i in range(4):
                s = scb_list[i]
                soq, sdq = pl.expand(s["o"][qi]), pl.expand(s["d"][qi])
                ok_cam = svalid[i][qi][:, None] \
                    & (s["length"][qi][:, None] >= t_proj)
                new_p = tuple(soq[c] + sdq[c] * t_proj + ph_p[c] - foot[c]
                              for c in range(3))
                a_sh, pr_l, ok_s, w_new = _reconnect_planar(
                    pre, new_p, target_is_volume=True)
                pf_s = pl.eval_phase_planar(scene, miq,
                                            -pl.dot3(w_new, sdq))
                ok_i = inside & ok_cam & ok_s
                w = _mis_planar(pr_l, sens[i][qi][:, None], ok_i)
                w = torch.where(border_lane[i][qi][:, None], 1.0, w)
                kwi = torch.where(ok_i, pf_s * k2 * scale, 0.0) * w
                sthr = s["thr"][qi]
                S_.append(torch.stack(
                    [(a_sh[c] * ssq[:, c:c + 1]
                      * torch.exp(-stq[:, c:c + 1] * t_proj) * kwi).sum(1)
                     * sthr[:, c] for c in range(3)], dim=-1))
                W_.append(torch.stack([(w * c).sum(1) for c in cb_pl],
                                      dim=-1))
                ok_count = ok_count + ok_i.sum(1)
            return (torch.stack([c.sum(1) for c in cb_pl], dim=-1),
                    torch.stack(S_, dim=1), torch.stack(W_, dim=1),
                    inside.sum(1), ok_count)

        p_, S_, W_, v_, so_ = hashgrid.gather_dense(
            grid, x, eval_fn, max_per_cell=max_per_cell, stencil=27,
            exact_cells=True)
        primal = primal + cb["thr"] * p_
        S = S + S_.movedim(1, 0)
        W = W + W_.movedim(1, 0) * cb["thr"][None]
        visits = visits + v_
        shift_ok = shift_ok + so_
    inv = 1.0 / n_emitted
    return primal * inv, S * inv, W * inv, visits, shift_ok


# ---------------------------------------------------------------------------
# gradient photon beams (1D, 3D) and planes (0D)
# ---------------------------------------------------------------------------

def _bake_beam_params(scene: Scene, lb):
    """Per-beam [B] material of the vertex that emits the beam: its
    BSDF's parameters and the sigma_s / g / phase type of the medium it
    scatters in (the pair sweeps read them from the beam's tail)."""
    nb, nm = scene.bsdf_type.shape[0], scene.med_sigma_s.shape[0]
    bic = torch.clamp(lb["parent_bsdf"], 0, nb - 1)
    pmi = torch.clamp(lb["parent_med"], 0, nm - 1)
    return dict(
        bp_btype=scene.bsdf_type[bic], bp_alb=scene.bsdf_albedo[bic],
        bp_spec=scene.bsdf_k[bic], bp_eta3=scene.bsdf_eta3[bic],
        bp_alpha=scene.bsdf_alpha[bic], bp_eta1=scene.bsdf_eta[bic],
        bp_sigs=torch.where((lb["parent_med"] >= 0)[..., None],
                            scene.med_sigma_s[pmi], 0.0),
        bp_g=scene.med_g[pmi], bp_ptype=scene.med_phase[pmi])


def _beam_me_elig(scene: Scene, lb):
    """Per beam (or plane): ME-eligible — its origin lobe is a DELTA
    surface scatter, the segment leaves that vertex itself and no diffuse
    reconnection exists (gvpm_tpu's _beam_me_elig; shiftBeamME dispatch,
    shift_volume_beams.h:440)."""
    bt = scene.bsdf_type[torch.clamp(lb["parent_bsdf"], 0,
                                     scene.bsdf_type.shape[0] - 1)]
    par_delta = (bt == BSDF_CONDUCTOR) | (bt == BSDF_DIELECTRIC)
    return lb["valid"] & lb["at_origin"] & ~lb["reconnectable"] \
        & (lb["parent_type"] == pl.VERT_SURFACE) & par_delta


def _sweep_beams(scene: Scene, lb, planes=False, me=False):
    """The valid beams (or planes), in stable order, as sweep rows and
    gradient tails (with `me`, the ME-eligible ones marked); returns
    (rows, tails, their flat indices)."""
    if planes:
        rows, keep = bs.pack_beams(lb["o"], lb["w0"], lb["l0"], lb["med"],
                                   lb["alpha"], lb["valid"], w1=lb["w1"],
                                   l1=lb["l1"], sig=lb["surv1_sigma"])
    else:
        rows, keep = bs.pack_beams(lb["o"], lb["d"], lb["length"],
                                   lb["med"], lb["alpha"], lb["valid"])
    fields = dict(lb, **_bake_beam_params(scene, lb))
    return rows, bs.pack_tails(fields, keep, _beam_me_elig(scene, lb)
                               if me else None), keep


def _offset_terms(cb, scb_list):
    """Per offset: its segment is valid, in the base's medium and the
    base is valid; sensorMIS's camera-subpath pdf ratio
    (gvpm_struct.h:608-631)."""
    mi = cb["med"]
    svalid = [s["valid"] & (s["med"] == mi) & cb["valid"] for s in scb_list]
    sens = [torch.clamp(s["pdf_prod"] / torch.clamp(cb["pdf_prod"],
                                                    min=1e-20), 1e-4, 1e4)
            for s in scb_list]
    return svalid, sens


def _segment_sweep(kind, scene, cb, scb_list, rows, tails, border_lane,
                   params):
    """The sweep of whole camera segments (gbeam1d, gplane0d and their
    _me kinds) with the camera throughputs applied: (primal, S, W,
    visits, shift_ok[, ME key, ME pairs, None])."""
    svalid, sens = _offset_terms(cb, scb_list)
    q = est._camera_queries(scene, cb["med"], cb["o"], cb["d"],
                            cb["length"], cb["valid"])
    qx = bs.pack_offsets([s["o"] for s in scb_list],
                         [s["d"] for s in scb_list],
                         [s["length"] for s in scb_list], svalid, sens,
                         list(border_lane))
    pr, S, W, visits, shift_ok, *me = bs.gsweep(kind, q, qx, rows, tails,
                                                 params)
    thr = cb["thr"]
    return (thr * pr, torch.stack([scb_list[i]["thr"] * S[i]
                                   for i in range(4)]),
            W * thr[None], visits, shift_ok, *me)


def _scaled(res, inv):
    primal, S, W, visits, shift_ok, *me = res
    zero = torch.zeros((), dtype=torch.int64, device=primal.device)
    return (primal * inv, S * inv, W * inv, visits, shift_ok) \
        + (tuple(me) if me else (zero, zero))


def _chunks(m, seg_tile):
    """Slices of the camera segments in chunks of seg_tile (all of them
    when 0 or more), as the JAX package's hosted dispatch cuts them."""
    st = max(1, min(seg_tile or m, m))
    return [slice(c0, c0 + st) for c0 in range(0, m, st)]


def _me_pairs(me_key, me_cnt, keep, me_budget):
    """A sweep's ME pairs cut to the budget: (segment ids [B], beam flat
    indices [B], eligible accepted pairs in all). The key is an index of
    the packed (valid, stable-order) beams, so `keep` maps it back and
    the lowest key is the reference's first eligible beam."""
    me_q, me_j, _ = _compact_me(me_key, me_budget)
    return me_q, keep[me_j], me_cnt.sum().to(torch.int64)


def _virtual_chains(scene, pv_chain, lb, me_b, p):
    """The chains of the ME pairs' beams (or planes), each started at a
    virtual photon at p [B,3] on the beam whose parent is the beam's
    origin vertex, tiled for the 4 offsets."""
    virt = dict(p=p, seg_med=lb["med"][me_b],
                parent_idx=lb["parent_idx"][me_b],
                reconnectable=torch.zeros_like(me_b, dtype=torch.bool),
                parent_type=lb["parent_type"][me_b],
                parent_bsdf=lb["parent_bsdf"][me_b])
    return manifold.tile_chains(
        manifold.pull_chains(scene, pv_chain, virt=virt), 4)


def _query_medium(scene, mi):
    """(sigma_s [B,3], sigma_t [B,3], g [B], phase type [B]) of the
    queries' medium."""
    _, ss, st = med._tables(scene, mi)
    gi = torch.clamp(mi, 0, scene.med_g.shape[0] - 1)
    return ss, st, scene.med_g[gi], scene.med_phase[gi]


def _rep4(*ts):
    """Each tensor repeated 4 times along lanes (offset-major)."""
    return [t.repeat((4,) + (1,) * (t.dim() - 1)) for t in ts]


def _beam_me_stage(scene, cb, scb_list, lb, pv_chain, me_q, me_b, r2, k1,
                   border_lane, S, W, shift_ok, me_iters, lap):
    """beam1d's ME stage (gvpm_tpu's _beam_me_stage; shiftBeamME,
    shift_volume_beams.cpp:748): the base closest approach of each
    (segment me_q, beam me_b) pair again, the beam's delta chain
    Newton-solved so that the new beam passes through each offset's
    point (the offset segment at the same camera distance, minus the
    kernel offset), its 1D kernel term on the new geometry, pairwise
    MIS; adds into S / W / shift_ok. Returns the attempted pairs."""
    svalid, sens = _offset_terms(cb, scb_list)
    oq, dq, lq = cb["o"][me_q], cb["d"][me_q], cb["length"][me_q]
    miq = cb["med"][me_q]
    sg_q, st_q, g_q, pt_q = _query_medium(scene, miq)
    bo, bd, bL = lb["o"][me_b], lb["d"][me_b], lb["length"][me_b]
    ba, bmed = lb["alpha"][me_b], lb["med"][me_b]

    # base closest approach (the sweep's math, pair lanes)
    w0 = oq - bo
    b = dot(dq, bd)
    f1 = -dot(w0, dq)
    f2 = -dot(w0, bd)
    denom = 1.0 - b * b
    parallel = torch.abs(denom) < 1e-8
    den = torch.where(parallel, 1.0, denom)
    tc = (f1 - b * f2) / den
    tb = (b * f1 - f2) / den
    pb = bo + bd * tb[..., None]
    delta = oq + dq * tc[..., None] - pb
    okp = (~parallel & (tc > 1e-5) & (tc < lq) & (tb > 1e-5) & (tb < bL)
           & (dot(delta, delta) < r2) & (miq == bmed))
    sin_t = torch.sqrt(torch.clamp(denom, min=1e-12))
    surv_b = est.survival_prob(scene, miq, tb)
    pf_b = pl.phase_params(-b, g_q, pt_q)
    tr_c = torch.exp(-st_q * tc[..., None])
    tr_b = torch.exp(-st_q * tb[..., None])
    wgt_b = (pf_b * k1 / (sin_t * torch.clamp(surv_b, min=1e-9)))[..., None] \
        * tr_c * tr_b * sg_q
    c_base_pair = torch.where(okp[..., None], ba * wgt_b, 0.0) \
        * cb["thr"][me_q]
    # the virtual photon is the base beam point pb
    ch4 = _virtual_chains(scene, pv_chain, lb, me_b, pb)
    if lap is not None:
        lap("me:chains", part=True)
    y_t = _per_offset(lambda i: scb_list[i]["o"][me_q]
                      + scb_list[i]["d"][me_q] * tc[..., None] - delta)
    wscale = torch.linalg.norm(scene.world_hi - scene.world_lo)
    _, dir_n, t_n, ar, pr_ch, okm = manifold.me_shift_beam(
        scene, ch4, y_t, n_iters=me_iters, scene_scale=wscale, lap=lap)

    sd4 = _per_offset(lambda i: scb_list[i]["d"][me_q])
    miq4, g4, pt4, tb4, bL4, sin_t4, surv_b4 = _rep4(
        miq, g_q, pt_q, tb, bL, sin_t, surv_b)
    sg4, st4, tr_c4, ba4 = _rep4(sg_q, st_q, tr_c, ba)
    cos_x = dot(dir_n, sd4)
    sin_n = torch.sqrt(torch.clamp(1.0 - cos_x * cos_x, min=1e-8))
    pf_n = pl.phase_params(-cos_x, g4, pt4)
    surv_n = est.survival_prob(scene, miq4, t_n)
    tr_bn = torch.exp(-st4 * t_n[..., None])
    ok4 = okm & okp.repeat(4) & (t_n < bL4) & _per_offset(
        lambda i: svalid[i][me_q] & (tc < scb_list[i]["length"][me_q])
        & ~border_lane[i][me_q])
    wgt_n = (pf_n * k1 / (sin_n * torch.clamp(surv_n, min=1e-9)))[..., None] \
        * tr_c4 * tr_bn * sg4
    c_me = ba4 * ar * wgt_n * _per_offset(lambda i: scb_list[i]["thr"][me_q])
    pr_me = (pr_ch * (surv_n / torch.clamp(surv_b4, min=1e-9))
             * (tb4 * tb4 / torch.clamp(t_n * t_n, min=1e-12))
             * (sin_t4 / sin_n))
    w4 = torch.where(ok4, 1.0 / (1.0 + torch.clamp(
        pr_me * _per_offset(lambda i: sens[i][me_q]), 0.0, 1e12)), 1.0)
    _add_me(S, W, shift_ok, me_q, ok4, w4, c_me, c_base_pair)
    return okp.sum()


def _plane_me_stage(scene, cb, scb_list, planes, pv_chain, me_q, me_p,
                    border_lane, S, W, shift_ok, me_iters, lap):
    """plane0d's ME stage (gvpm_tpu's _plane_me_stage; the delta-origin
    branch of PlaneGradRadianceQuery, shift_volume_planes.h:57): the
    plane's generating beam origin ends a pure-delta chain, which is
    Newton-solved so that the shifted AXIS passes through the offset
    camera point minus the base extension offset t1 w1. The shifted
    plane keeps its lengths, takes the chain's exit direction as w0' and
    w1 turned by the minimal rotation w0 -> w0', and is intersected
    exactly with the offset ray; plane-estimator factors on the shifted
    geometry, pairwise MIS. Returns the attempted pairs."""
    svalid, sens = _offset_terms(cb, scb_list)
    oq, dq, lq = cb["o"][me_q], cb["d"][me_q], cb["length"][me_q]
    miq = cb["med"][me_q]
    sg_q, st_q, g_q, pt_q = _query_medium(scene, miq)
    po, pw0, pl0 = planes["o"][me_p], planes["w0"][me_p], planes["l0"][me_p]
    pw1, pl1 = planes["w1"][me_p], planes["l1"][me_p]
    pal, pmed = planes["alpha"][me_p], planes["med"][me_p]
    psig = planes["surv1_sigma"][me_p]

    # base Moller-Trumbore (pair lanes)
    e0 = pw0 * pl0[..., None]
    e1 = pw1 * pl1[..., None]
    Pv = cross(dq, e1)
    det = dot(e0, Pv)
    okb = torch.abs(det) > 1e-7
    inv_det = torch.where(okb, 1.0 / torch.where(det == 0, 1.0, det), 0.0)
    T_ = oq - po
    u0 = dot(T_, Pv) * inv_det
    Q = cross(T_, e0)
    u1 = dot(dq, Q) * inv_det
    tcam = dot(e1, Q) * inv_det
    okb = (okb & (u0 >= 0.0) & (u0 <= 1.0) & (u1 >= 0.0) & (u1 <= 1.0)
           & (tcam > 1e-5) & (tcam < lq) & (miq == pmed))
    t0 = u0 * pl0
    t1 = u1 * pl1
    tr_cam = torch.exp(-st_q * tcam[..., None])
    pf_b = pl.phase_params(-dot(pw1, dq), g_q, pt_q)
    tr0 = torch.exp(-st_q * t0[..., None])
    tr1 = torch.exp(-st_q * t1[..., None])
    surv0 = est.survival_prob(scene, miq, t0)
    surv1 = torch.exp(-psig * t1)
    jac = torch.abs(dot(pw0, cross(pw1, dq)))
    wgt_b = (tr_cam * tr0 * tr1 * sg_q * sg_q
             * (pf_b / (torch.clamp(surv0, min=1e-9)
                        * torch.clamp(surv1, min=1e-9)
                        * torch.clamp(jac, min=1e-6)))[..., None])
    c_base_pair = torch.where(okb[..., None], pal * wgt_b, 0.0) \
        * cb["thr"][me_q]
    # the virtual photon is the base axis point A + t0 w0
    q_axis = po + pw0 * t0[..., None]
    ch4 = _virtual_chains(scene, pv_chain, planes, me_p, q_axis)
    if lap is not None:
        lap("me:chains", part=True)
    y_base = oq + dq * tcam[..., None]
    so4 = _per_offset(lambda i: scb_list[i]["o"][me_q])
    sd4 = _per_offset(lambda i: scb_list[i]["d"][me_q])
    tcam4, y_base4, q_axis4 = _rep4(tcam, y_base, q_axis)
    # keep the extension offset: the axis through y'_i - (y - q_axis)
    q_t = so4 + sd4 * tcam4[..., None] - (y_base4 - q_axis4)
    wscale = torch.linalg.norm(scene.world_hi - scene.world_lo)
    org_n, w0n, _, ar, pr_ch, okm = manifold.me_shift_beam(
        scene, ch4, q_t, n_iters=me_iters, scene_scale=wscale, lap=lap)

    pw0_4, pw1_4, pl0_4, pl1_4, psig4, pal4 = _rep4(pw0, pw1, pl0, pl1, psig,
                                                    pal)
    miq4, g4, pt4, sg4, st4 = _rep4(miq, g_q, pt_q, sg_q, st_q)
    surv0_4, surv1_4, jac4, t0_4, t1_4 = _rep4(surv0, surv1, jac, t0, t1)
    # minimal rotation w0 -> w0' applied to w1
    cos_r = dot(pw0_4, w0n)
    axis = cross(pw0_4, w0n)
    sin_r = torch.sqrt(torch.clamp(dot(axis, axis), min=0.0))
    safe = sin_r > 1e-7
    k_hat = axis / torch.clamp(sin_r, min=1e-7)[..., None]
    kdv = dot(k_hat, pw1_4)
    cx = cross(k_hat, pw1_4)
    w1n = torch.where(
        safe[..., None],
        pw1_4 * cos_r[..., None] + cx * sin_r[..., None]
        + k_hat * (kdv * (1.0 - cos_r))[..., None], pw1_4)
    # the shifted plane against the offset ray
    e0n = w0n * pl0_4[..., None]
    e1n = w1n * pl1_4[..., None]
    Pvn = cross(sd4, e1n)
    detn = dot(e0n, Pvn)
    okn = torch.abs(detn) > 1e-7
    invn = torch.where(okn, 1.0 / torch.where(detn == 0, 1.0, detn), 0.0)
    Tn = so4 - org_n
    u0n = dot(Tn, Pvn) * invn
    Qn = cross(Tn, e0n)
    u1n = dot(sd4, Qn) * invn
    tcn = dot(e1n, Qn) * invn
    ok4 = (okm & okb.repeat(4) & okn & (u0n >= 0.0) & (u0n <= 1.0)
           & (u1n >= 0.0) & (u1n <= 1.0) & (tcn > 1e-5)
           & _per_offset(lambda i: svalid[i][me_q] & ~border_lane[i][me_q])
           & (tcn < _per_offset(lambda i: scb_list[i]["length"][me_q])))
    t0i = u0n * pl0_4
    t1i = u1n * pl1_4
    tr_cn = torch.exp(-st4 * tcn[..., None])
    pf_n = pl.phase_params(-dot(w1n, sd4), g4, pt4)
    tr0n = torch.exp(-st4 * t0i[..., None])
    tr1n = torch.exp(-st4 * t1i[..., None])
    surv0n = est.survival_prob(scene, miq4, t0i)
    surv1n = torch.exp(-psig4 * t1i)
    jac_n = torch.abs(dot(w0n, cross(w1n, sd4)))
    wgt_n = (tr_cn * tr0n * tr1n * sg4 * sg4
             * (pf_n / (torch.clamp(surv0n, min=1e-9)
                        * torch.clamp(surv1n, min=1e-9)
                        * torch.clamp(jac_n, min=1e-6)))[..., None])
    c_me = pal4 * ar * wgt_n * _per_offset(lambda i: scb_list[i]["thr"][me_q])
    pr_me = (pr_ch * (surv0n / torch.clamp(surv0_4, min=1e-9))
             * (surv1n / torch.clamp(surv1_4, min=1e-9))
             * (jac4 / torch.clamp(jac_n, min=1e-6))
             * (t0_4 * t1_4) / torch.clamp(t0i * t1i, min=1e-12))
    w4 = torch.where(ok4, 1.0 / (1.0 + torch.clamp(
        pr_me * _per_offset(lambda i: sens[i][me_q]), 0.0, 1e12)), 1.0)
    _add_me(S, W, shift_ok, me_q, ok4, w4, c_me, c_base_pair)
    return okb.sum()


def _segment_gather_me(kind, stage, scene, cb, scb_list, lb, border_lane,
                       params, pv_chain, me_budget, seg_tile, lap, **kw):
    """gbeam1d / gplane0d with use_manifold: the camera segments in
    chunks of seg_tile, one ME sweep each, then its ME stage on at most
    me_budget pairs (the first queries with an eligible pair, as the
    JAX package's hosted dispatch budgets each chunk). Returns (primal,
    S, W, visits, shift_ok, me_dropped, me_pairs), before 1/n_emitted."""
    rows, tails, keep = _sweep_beams(scene, lb, planes=kind == "gplane0d_me",
                                     me=True)
    parts, me_drop, me_pairs = [], 0, 0
    for sl in _chunks(cb["o"].shape[0], seg_tile):
        cbc = {k: v[sl] for k, v in cb.items()}
        scbc = [{k: v[sl] for k, v in s.items()} for s in scb_list]
        blc = border_lane[:, sl]
        pr, S, W, visits, shift_ok, me_key, me_cnt, _ = _segment_sweep(
            kind, scene, cbc, scbc, rows, tails, blc, params)
        if lap is not None:
            lap("volume_gather")
        me_q, me_b, total = _me_pairs(me_key, me_cnt, keep, me_budget)
        if lap is not None:
            lap("me:compact", part=True)
        att = 0
        if me_q.shape[0]:
            att = stage(scene, cbc, scbc, lb, pv_chain, me_q, me_b,
                        border_lane=blc, S=S, W=W, shift_ok=shift_ok,
                        lap=lap, **kw)
        me_drop = me_drop + total - att
        me_pairs += me_q.shape[0]
        if lap is not None:
            lap("volume_me")
        parts.append((pr, S, W, visits, shift_ok))
    pr, S, W, visits, shift_ok = (torch.cat([p[k] for p in parts],
                                            dim=1 if k in (1, 2) else 0)
                                  for k in range(5))
    dev = pr.device
    return (pr, S, W, visits, shift_ok,
            torch.as_tensor(me_drop, dtype=torch.int64, device=dev),
            torch.tensor(me_pairs, dtype=torch.int64, device=dev))


def beam_gradient_gather(scene: Scene, cb, scb_list, lb, n_emitted, r_beam,
                         border_lane, use_manifold=False, pv_chain=None,
                         me_budget=4096, me_iters=5, seg_tile=0, lap=None):
    """1D beam x beam gradient gather (gvpm_tpu's beam_gradient_gather):
    each (camera segment, beam) closest approach within r_beam is the
    base pair; its shift to an offset keeps the beam's origin A, maps
    the base point to the offset segment at the same camera distance
    with the same kernel offset, and re-emits the beam from A through it
    (lobe ratio at A, survival and 1/sin of the new crossing;
    shiftBeamDiffuse, shift_volume_beams.h:408-457), or, for a beam that
    leaves a non-reconnectable vertex, re-intersects the same beam with
    the offset segment (shiftNull3D). Pairwise MIS of the two
    intersection densities, 1 on the image border.

    With use_manifold a beam that leaves a delta surface vertex it can
    not reconnect takes the MANIFOLD shift instead (shiftBeamME): each
    segment keeps its first such pair, at most me_budget of them per
    chunk of seg_tile segments are chain-solved with me_iters Newton
    steps (`_beam_me_stage`; pv_chain: the light pass's photon dict), the
    others stay unilateral and are counted in me_dropped. `lap(name,
    part=False)`, when given, is called at the end of each chunk's sweep
    ("volume_gather") and ME stage ("volume_me"), and with part=True
    after its parts ("me:compact", "me:chains" and the shift's
    "me:newton", "me:ratios", "me:occlusion"). Without ME the segments
    sweep in one launch.

    cb / scb_list: the compacted base and 4 offset camera-segment dicts
    [M]; lb: the flattened beam dict; r_beam: float32 scalar tensor;
    border_lane: [4, M] bool. Returns (primal [M,3], S [4,M,3],
    W [4,M,3], visits [M], shift_ok [M], me_dropped, me_pairs)."""
    r2, k1 = torch.stack([r_beam * r_beam,
                          pl.rdiv(1.0, 2.0 * r_beam)]).tolist()
    params = bs.Params(r2=r2, k=k1)
    if use_manifold:
        return _scaled(_segment_gather_me(
            "gbeam1d_me", _beam_me_stage, scene, cb, scb_list, lb,
            border_lane, params, pv_chain, me_budget, seg_tile, lap, r2=r2,
            k1=k1, me_iters=me_iters), 1.0 / n_emitted)
    rows, tails, _ = _sweep_beams(scene, lb)
    return _scaled(_segment_sweep("gbeam1d", scene, cb, scb_list, rows,
                                  tails, border_lane, params),
                   1.0 / n_emitted)


def plane_gradient_gather(scene: Scene, cb, scb_list, planes, n_emitted,
                          border_lane, use_manifold=False, pv_chain=None,
                          me_budget=4096, me_iters=5, seg_tile=0, lap=None):
    """0D photon-plane gradient gather (gvpm_tpu's plane_gradient_gather):
    camera segment x plane by Moller-Trumbore; the shift rotates the
    plane about its origin by the minimal rotation that takes the base
    point's direction to the offset point's (same camera distance), with
    the analytic offset intersection at the scaled plane parameters
    (mediumRotationShift, shift_medium.h:39), or the identity (the same
    plane against the offset ray) for a non-reconnectable origin; with
    use_manifold, the manifold shift for a delta origin
    (`_plane_me_stage`), budgeted and timed as in beam_gradient_gather.
    planes: estimators.make_planes' dict. Returns beam_gradient_gather's
    tuple."""
    if use_manifold:
        return _scaled(_segment_gather_me(
            "gplane0d_me", _plane_me_stage, scene, cb, scb_list, planes,
            border_lane, bs.Params(), pv_chain, me_budget, seg_tile, lap,
            me_iters=me_iters), 1.0 / n_emitted)
    rows, tails, _ = _sweep_beams(scene, planes, planes=True)
    return _scaled(_segment_sweep("gplane0d", scene, cb, scb_list, rows,
                                  tails, border_lane, bs.Params()),
                   1.0 / n_emitted)


def _beam3d_me_stage(scene, lb, pv_chain, me_q, me_b, yq, x, xs, sd, dc,
                     mi, cam_ok, pr_cam, thr_c, w_cam, border_lane, r2, k3,
                     S, W, shift_ok, me_iters, lap):
    """beam3d's ME stage for one chunk and distance sample (gvpm_tpu's
    _beam3d_me_stage): the stored base chord point yq (the kernel's)
    maps to each offset frame (xs_i + (y - x)) and the delta-origin beam
    is chain-solved through it; the new beam's chord in the offset kernel
    sphere, pairwise MIS; adds into S / W / shift_ok. Returns the
    attempted pairs."""
    bo, bd, bL = lb["o"][me_b], lb["d"][me_b], lb["length"][me_b]
    ba, bmed = lb["alpha"][me_b], lb["med"][me_b]
    xq, miq = x[me_q], mi[me_q]
    _, st_q, g_q, pt_q = _query_medium(scene, miq)

    # base pair terms at the stored chord point
    s_b = torch.linalg.norm(yq - bo, dim=-1)
    rel = xq - bo
    sm = dot(rel, bd)
    d2p = dot(rel, rel) - sm * sm
    half = torch.sqrt(torch.clamp(r2 - d2p, min=0.0))
    s0 = torch.clamp(sm - half, min=0.0)
    s1 = torch.minimum(sm + half, bL)
    chord = torch.clamp(s1 - s0, min=0.0)
    e = xq - yq
    okp = (chord > 0.0) & (miq == bmed) \
        & (e[:, 0] * e[:, 0] + e[:, 1] * e[:, 1] + e[:, 2] * e[:, 2] < r2)
    surv_b = est.survival_prob(scene, miq, s_b)
    ch4 = _virtual_chains(scene, pv_chain, lb, me_b, yq)
    if lap is not None:
        lap("me:chains", part=True)
    xs4 = _per_offset(lambda i: xs[i][me_q])
    yx4, = _rep4(yq - xq)
    wscale = torch.linalg.norm(scene.world_hi - scene.world_lo)
    org_n, dir_n, t_n, ar, pr_ch, okm = manifold.me_shift_beam(
        scene, ch4, xs4 + yx4, n_iters=me_iters, scene_scale=wscale, lap=lap)

    miq4, g4, pt4, st4, bL4, ba4 = _rep4(miq, g_q, pt_q, st_q, bL, ba)
    s_b4, surv_b4, chord4 = _rep4(s_b, surv_b, chord)
    sd4 = _per_offset(lambda i: sd[i][me_q])
    # the new beam's chord in the offset kernel sphere
    rel_n = xs4 - org_n
    sm_n = dot(rel_n, dir_n)
    d2p_n = dot(rel_n, rel_n) - sm_n * sm_n
    half_n = torch.sqrt(torch.clamp(r2 - d2p_n, min=0.0))
    s0n = torch.clamp(sm_n - half_n, min=0.0)
    s1n = torch.minimum(sm_n + half_n, bL4)
    chord_n = torch.clamp(s1n - s0n, min=0.0)
    pf_n = pl.phase_params(-dot(dir_n, sd4), g4, pt4)
    surv_n = est.survival_prob(scene, miq4, t_n)
    tr_bn = torch.exp(-st4 * t_n[..., None])
    ok4 = (okm & okp.repeat(4) & (chord_n > 0.0) & (t_n >= s0n)
           & (t_n <= s1n) & (t_n < bL4)
           & _per_offset(lambda i: cam_ok[i][me_q] & ~border_lane[i][me_q]))
    c_me = ba4 * ar * tr_bn \
        * (chord_n * k3 * pf_n / torch.clamp(surv_n, min=1e-9))[..., None] \
        * _per_offset(lambda i: thr_c[i][me_q])
    pr_me = (pr_ch * (surv_n / torch.clamp(surv_b4, min=1e-9))
             * (s_b4 * s_b4 / torch.clamp(t_n * t_n, min=1e-12))
             * (chord4 / torch.clamp(chord_n, min=1e-12)))
    # the base pair's term (base beam direction vs the base camera's)
    pf_b = pl.phase_params(-dot(bd, dc[me_q]), g_q, pt_q)
    c_base_pair = ba * torch.exp(-st_q * s_b[..., None]) \
        * (chord * k3 * pf_b / torch.clamp(surv_b, min=1e-9))[..., None] \
        * w_cam[me_q]
    w4 = torch.where(ok4, 1.0 / (1.0 + torch.clamp(
        pr_me * _per_offset(lambda i: pr_cam[i][me_q]), 0.0, 1e12)), 1.0)
    _add_me(S, W, shift_ok, me_q, ok4, w4, c_me, c_base_pair)
    return okp.sum()


def beam3d_gradient_gather(scene: Scene, cb, scb_list, lb, n_emitted,
                           r_beam, key, border_lane, n_samples=2, tile=256,
                           seg_tile=0, use_manifold=False, pv_chain=None,
                           me_budget=4096, me_iters=5, lap=None):
    """3D beam x point gradient gather (gvpm_tpu's beam3d_gradient_gather):
    a camera distance sample x per segment and sample; the base pair is
    one stratified chord sample y on the beam's chord through the kernel
    sphere around x. The shift maps y to the offset frame keeping the
    camera distance and y - x, and re-emits the beam from its origin
    through it (MIS density: direction pdf, t^2, survival and the chord),
    or, for a non-reconnectable origin, takes the same beam's chord
    around the offset sample at the base's chord fraction (identity);
    with use_manifold, the manifold shift of a delta origin through the
    kernel's chord point (`_beam3d_me_stage`), budgeted per chunk and
    sample and timed as in beam_gradient_gather.

    The random stream follows the JAX package's gvpm.render schedule
    (render_pass_hosted, gvpm.py:690-747): the segments are cut into
    chunks of `seg_tile` (all of them when 0 or more), chunk ci draws
    with fold_in(key, ci) (one chunk too), each of its n_samples keys
    splits into (k_t, k_s): the distance sample is lane_uniform(k_t,
    gid), the chord sample of the chunk's query m and beam j the word
    m * tile + j % tile of uniform(fold_in(k_s, j // tile), [chunk,
    tile]) (ops/beam_sweep.beam_keys). One sweep launch per chunk and
    sample. Returns beam_gradient_gather's tuple."""
    mi, o, d, length = cb["med"], cb["o"], cb["d"], cb["length"]
    m = o.shape[0]
    dev = o.device
    r2, k3 = torch.stack([r_beam * r_beam, pl.rdiv(
        3.0, 4.0 * math.pi * torch.clamp(r_beam * r_beam * r_beam,
                                         min=1e-18))]).tolist()
    rows, tails, keep = _sweep_beams(scene, lb, me=use_manifold)
    kind = "gbeam3d_me" if use_manifold else "gbeam3d"
    tiles = torch.arange(-(-lb["o"].shape[0] // tile), device=dev)
    svalid, sens = _offset_terms(cb, scb_list)
    f32 = dict(dtype=torch.float32, device=dev)
    primal = torch.zeros((m, 3), **f32)
    S = torch.zeros((4, m, 3), **f32)
    W = torch.zeros((4, m, 3), **f32)
    visits = torch.zeros((m,), dtype=torch.int64, device=dev)
    shift_ok = torch.zeros((m,), dtype=torch.int64, device=dev)
    me_drop = me_pairs = 0
    for ci, sl in enumerate(_chunks(m, seg_tile)):
        mic = mi[sl]
        scs = [{k: v[sl] for k, v in s.items()} for s in scb_list]
        for k in rng.split(rng.fold_in(key, ci), n_samples):
            k_t, k_s = rng.split(k)
            ms = med.sample_distance(
                scene, mic, o[sl], d[sl], length[sl],
                rng.lane_uniform(k_t, cb["gid"][sl]),
                strategy=med.ALWAYS_VALID)
            t_cam = ms.t
            sok = cb["valid"][sl] & ms.success
            pdf_ray = torch.clamp(ms.pdf_success, min=1e-20)
            cam_ok = [sok & svalid[i][sl] & (scs[i]["length"] >= t_cam)
                      for i in range(4)]
            pr_cam = [med.pdf_distance_always_valid(
                scene, mic, t_cam, scs[i]["length"]) / pdf_ray * sens[i][sl]
                for i in range(4)]
            xs = [s["o"] + s["d"] * t_cam[..., None] for s in scs]
            q = est._camera_queries(scene, mic, ms.p, d[sl], length[sl],
                                    sok)
            qx = bs.pack_offsets(xs, [s["d"] for s in scs],
                                 [s["length"] for s in scs], cam_ok,
                                 pr_cam, list(border_lane[:, sl]))
            keys = bs.beam_keys(rng.fold_in(k_s, tiles), keep, tile)
            pr, S_, W_, v_, so_, *me = bs.gsweep(
                kind, q, qx, rows, tails,
                bs.Params(r2=r2, k=k3, keys=keys, tile=tile))
            w_cam = cb["thr"][sl] * ms.transmittance * ms.sigma_s \
                / pdf_ray[..., None]
            thr_c = [scs[i]["thr"] * ms.transmittance * ms.sigma_s
                     / pdf_ray[..., None] for i in range(4)]
            S_ = torch.stack([thr_c[i] * S_[i] for i in range(4)])
            W_ = W_ * w_cam
            so_ = so_.to(torch.int64)
            if use_manifold:
                if lap is not None:
                    lap("volume_gather")
                me_key, me_cnt, me_y = me
                me_q, me_b, total = _me_pairs(me_key, me_cnt, keep,
                                              me_budget)
                if lap is not None:
                    lap("me:compact", part=True)
                att = 0
                if me_q.shape[0]:
                    att = _beam3d_me_stage(
                        scene, lb, pv_chain, me_q, me_b, me_y[me_q], ms.p,
                        xs, [s["d"] for s in scs], d[sl], mic, cam_ok,
                        pr_cam, thr_c, w_cam, border_lane[:, sl], r2, k3,
                        S_, W_, so_, me_iters, lap)
                me_drop = me_drop + total - att
                me_pairs += me_q.shape[0]
                if lap is not None:
                    lap("volume_me")
            primal[sl] += w_cam * pr
            S[:, sl] += S_
            W[:, sl] += W_
            visits[sl] += v_
            shift_ok[sl] += so_
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    return _scaled((primal, S, W, visits, shift_ok, zero + me_drop,
                    zero + me_pairs), 1.0 / (n_samples * n_emitted))
