"""Plain reference of the light pass: photon paths traced from the
configuration's scene (reference/scene.py) with the same random stream
(reference/rng.py), for a sample of the pass's lanes, one record a step
and lane as the light pass stores them.

The rules it follows are the light pass's: the area light sampled by
flux, then a point on its triangle and a cosine-weighted direction;
free flights in the fog sampled on a channel picked at random, with
probability max(albedo, 0.5); an isotropic phase function; diffuse
surfaces sampled by cosine, the mirror by reflection with a conductor's
Fresnel weight, null boundaries crossed as they are; Russian roulette
from `rr_depth_photon` on; each record keeps the power arriving at it and
the caches of its parent vertex that the gradient shifts read.
"""

from __future__ import annotations

import math

import torch

from . import rng
from . import scene as rs
from .scene import dot, frame, to_local, to_world

VERT_NONE, VERT_SURFACE, VERT_MEDIUM = 0, 1, 2

# fields compared exactly, and to rounding
EXACT = ("vtype", "depth", "med", "seg_med", "bsdf", "prim", "path",
         "parent_type", "parent_bsdf", "parent_med", "reconnectable",
         "parent_idx")
FLOAT = ("p", "wi", "alpha", "ns", "parent_p", "parent_wi", "parent_ns",
         "scatter_base", "seg_tr", "pdf_dir_base", "pdf_dist_base")


def concentric_disk(u):
    x, y = 2.0 * u[:, 0] - 1.0, 2.0 * u[:, 1] - 1.0
    use_x = x.abs() > y.abs()
    r = torch.where(use_x, x, y)
    phi = torch.where(
        use_x,
        (math.pi / 4) * torch.where(x.abs() > 1e-12,
                                    y / torch.where(x == 0, 1.0, x), 0.0),
        math.pi / 2 - (math.pi / 4) * torch.where(
            y.abs() > 1e-12, x / torch.where(y == 0, 1.0, y), 0.0))
    r = torch.where((x == 0) & (y == 0), 0.0, r)
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], -1)


def cosine_hemisphere(u):
    d = concentric_disk(u)
    z = torch.sqrt(torch.clamp(1.0 - (d * d).sum(-1), min=0.0))
    return torch.cat([d, z[:, None]], -1)


def fresnel_conductor(cos_i, eta, k):
    """Unpolarized conductor reflectance, per channel."""
    c2 = torch.clamp(cos_i * cos_i, 0.0, 1.0)[:, None]
    e2k2 = eta * eta + k * k
    two_e_c = 2.0 * eta * torch.sqrt(c2)
    r_par = (e2k2 * c2 - two_e_c + 1.0 - c2 + c2 * c2) / torch.clamp(
        e2k2 * c2 + two_e_c + 1.0 - c2 + c2 * c2, min=1e-12)
    r_perp = (e2k2 - two_e_c + c2) / torch.clamp(e2k2 + two_e_c + c2,
                                                 min=1e-12)
    return torch.clamp(0.5 * (r_par + r_perp), 0.0, 1.0)


def sample_surface(sc, mat, ns, d, u3):
    """Scatter at a surface hit along d: (wo, weight [N,3], pdf, valid,
    delta), the material's own lobe (diffuse, mirror, or straight on)."""
    kind = sc["mat_kind"][mat]
    s, t = frame(ns)
    wi = to_local(ns, s, t, -d)
    flip = torch.where((wi[:, 2] < 0) & (kind != rs.NULL), -1.0, 1.0).to(
        wi.dtype)
    wi = torch.stack([wi[:, 0], wi[:, 1], wi[:, 2] * flip], -1)
    ci = wi[:, 2]
    wd = cosine_hemisphere(u3[:, 1:3])
    wo_diff = torch.stack([wd[:, 0], wd[:, 1], wd[:, 2] * torch.sign(ci)],
                          -1)
    wo_mir = torch.stack([-wi[:, 0], -wi[:, 1], wi[:, 2]], -1)
    alb = sc["mat_albedo"][mat]
    w_mir = alb * fresnel_conductor(ci.abs(), sc["mat_eta3"][mat],
                                    sc["mat_k"][mat])
    is_d, is_c = kind == rs.DIFFUSE, kind == rs.CONDUCTOR
    wo = torch.where(is_d[:, None], wo_diff,
                     torch.where(is_c[:, None], wo_mir, -wi))
    weight = torch.where(is_d[:, None], alb,
                         torch.where(is_c[:, None], w_mir, 1.0))
    pdf = torch.where(is_d, torch.clamp(wd[:, 2], min=0.0) / math.pi, 0.0)
    wo = torch.stack([wo[:, 0], wo[:, 1], wo[:, 2] * flip], -1)
    return (to_world(ns, s, t, wo), weight, pdf, weight.amax(-1) > 0,
            ~is_d)


def free_flight(sc, med, o, d, t_far, u):
    """Free-flight sampling in the fog: (success, t, transmittance [N,3],
    pdf_success, pdf_failure, sigma_s [N,3])."""
    inm = med >= 0
    st = torch.where(inm[:, None], sc["sigma_t"], 0.0)
    ss = torch.where(inm[:, None], sc["sigma_s"], 0.0)
    alb = torch.where(st > 0, ss / torch.clamp(st, min=1e-20), 0.0).amax(-1)
    w = torch.where(inm, torch.clamp(alb, min=0.5), 0.0)
    ch = torch.clamp((u[:, 1] * 3.0).to(torch.int64), max=2)
    sig = torch.clamp(st.gather(1, ch[:, None])[:, 0], min=1e-20)
    take = u[:, 0] < w
    ur = torch.where(take, u[:, 0] / torch.clamp(w, min=1e-20), 0.0)
    ts = -torch.log(torch.clamp(1.0 - ur, min=1e-20)) / sig
    ts = torch.where(take & inm, ts, torch.inf)
    success = (ts < t_far) & inm
    t = torch.where(ts < t_far, ts, t_far)
    tr = torch.exp(-st * t[:, None])
    pdf_s = w * (st * tr).mean(-1)
    pdf_f = w * tr.mean(-1) + (1.0 - w)
    tr = torch.where(tr.amax(-1, keepdim=True) < 1e-20, 0.0, tr)
    return (success, t, torch.where(inm[:, None], tr, 1.0),
            torch.where(inm, pdf_s, 0.0), torch.where(inm, pdf_f, 1.0), ss)


def crossing(hit, d):
    """The medium past a surface along d."""
    return torch.where(dot(d, hit["ng"]) < 0, hit["med_in"],
                       hit["med_out"])


def emit(sc, u3, u2):
    """The area light's photons: (p, d, alpha, med, valid, n, cos, pdf)."""
    cdf = sc["em_cdf"]
    k = torch.clamp(torch.searchsorted(cdf, u3[:, 0].contiguous(),
                                       right=True), max=cdf.shape[0] - 1)
    pmf = cdf[k] - torch.where(k > 0, cdf[torch.clamp(k - 1, min=0)], 0.0)
    prim = sc["em_prim"][k]
    su = torch.sqrt(u3[:, 1])
    p = sc["tri_p0"][prim] + (1.0 - su)[:, None] * sc["tri_e1"][prim] \
        + (u3[:, 2] * su)[:, None] * sc["tri_e2"][prim]
    n = sc["tri_ng"][prim]
    dl = cosine_hemisphere(u2)
    s, t = frame(n)
    d = to_world(n, s, t, dl)
    pdf = torch.clamp(dl[:, 2], min=0.0) / math.pi
    cos_e = torch.clamp(dot(n, d), min=0.0)
    alpha = sc["tri_radiance"][prim] * (cos_e / torch.clamp(
        pmf / sc["em_area"][k] * pdf, min=1e-20))[:, None]
    hit = dict(ng=n, med_in=sc["tri_med_in"][prim],
               med_out=sc["tri_med_out"][prim])
    return (p + n * 1e-4, d, alpha, crossing(hit, d), (pmf > 0) & (cos_e > 0),
            n, cos_e, pdf)


def trace(sc, cfg, seed, it, n_paths, lanes, path_offset=None,
          dtype=torch.float64):
    """The records of `lanes` of a light pass of `n_paths` paths at pass
    `it`: a dict of [steps, len(lanes), ...] tensors. `cfg`: max_depth,
    null_bounces, rr_depth_photon, rr_clamp. path_offset: the draws keyed
    by lane id (path_offset + lane) instead of by position."""
    dev = lanes.device
    f = dict(dtype=dtype, device=dev)
    keyed = path_offset is not None
    ids = lanes + path_offset if keyed else lanes

    def draw(k, width):
        return rng.rows(k.to(dev), ids, width, keyed).to(dtype)

    n_steps = cfg["max_depth"] + cfg["null_bounces"]
    k_emit, k_walk = rng.split(rng.pass_key(seed, it, rng.STREAM_LIGHT), 2)
    _k_pick, k_pos, k_dir, _k_disk = rng.split(k_emit, 4)
    o, d, alpha, med, active, n_e, cos_e, pdf_e = emit(
        sc, draw(k_pos, 3), draw(k_dir, 2))
    alpha = torch.where(active[:, None], alpha, 0.0)
    L = lanes.shape[0]
    depth = torch.zeros(L, dtype=torch.int64, device=dev)
    par = dict(p=o, type=torch.zeros_like(depth), wi=n_e, ns=n_e,
               bsdf=torch.full_like(depth, -1), med=med,
               scatter=cos_e[:, None].expand(L, 3), pdf_dir=pdf_e,
               reconn=torch.ones(L, dtype=torch.bool, device=dev),
               idx=torch.full_like(depth, -1))
    seg_tr, seg_pdff = torch.ones(L, 3, **f), torch.ones(L, **f)
    recs = []
    for step, ks in enumerate(rng.split(k_walk, n_steps)):
        k_med, k_scat, k_rr = rng.split(ks, 3)
        hit = rs.intersect(sc, o, d)
        t_far = torch.where(hit["valid"], hit["t"], torch.inf)
        ok, t, tr, pdf_s, pdf_f, ss = free_flight(sc, med, o, d, t_far,
                                                  draw(k_med, 2))
        mevt = active & ok
        sevt = active & ~ok & hit["valid"]
        a_med = alpha * tr / torch.clamp(pdf_s, min=1e-20)[:, None]
        a_surf = alpha * tr / torch.clamp(pdf_f, min=1e-20)[:, None]
        kind = sc["mat_kind"][hit["mat"]]
        is_null = kind == rs.NULL
        store = sevt & ~is_null
        vtype = torch.where(mevt, VERT_MEDIUM,
                            torch.where(store, VERT_SURFACE, VERT_NONE))
        p_med = o + d * t[:, None]
        rec = dict(
            vtype=vtype, p=torch.where(mevt[:, None], p_med, hit["p"]),
            wi=d, alpha=torch.where(mevt[:, None], a_med, a_surf),
            med=torch.where(mevt, med, -1), seg_med=med,
            bsdf=torch.where(store, hit["mat"], -1), ns=hit["ng"],
            prim=torch.where(store, hit["prim"], -1), path=lanes,
            depth=depth + 1, parent_p=par["p"], parent_type=par["type"],
            parent_wi=par["wi"], parent_ns=par["ns"],
            parent_bsdf=par["bsdf"], parent_med=par["med"],
            scatter_base=par["scatter"], seg_tr=seg_tr * tr,
            pdf_dir_base=par["pdf_dir"],
            pdf_dist_base=seg_pdff * torch.where(mevt, pdf_s, pdf_f),
            reconnectable=par["reconn"], parent_idx=par["idx"])
        recs.append(rec)

        # the walk goes on: the phase function in the fog (isotropic:
        # a uniform direction), the material's lobe on a surface
        u2 = draw(k_scat, 2)
        z = 1.0 - 2.0 * u2[:, 0]
        r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
        phi = 2.0 * math.pi * u2[:, 1]
        wo_med = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)
        pdf_ph = torch.full_like(z, 1.0 / (4.0 * math.pi))
        wo_s, wgt, pdf_b, b_ok, delta = sample_surface(
            sc, hit["mat"], hit["ng"], d, draw(k_scat, 3))
        m3, s3 = mevt[:, None], sevt[:, None]
        new_alpha = torch.where(m3, a_med * ss,
                                torch.where(s3, a_surf * wgt, alpha))
        side = torch.sign(dot(hit["ng"], wo_s))[:, None]
        new_o = torch.where(m3, p_med, torch.where(
            s3, hit["p"] + hit["ng"] * side * rs.RAY_EPS, o))
        new_d = torch.where(m3, wo_med, torch.where(s3, wo_s, d))
        crossed = sevt & (dot(wo_s, hit["ng"]) * dot(-d, hit["ng"]) < 0)
        new_med = torch.where(crossed & ~mevt, crossing(hit, wo_s), med)
        advances = mevt | store
        new_depth = depth + advances.to(torch.int64)
        dead = (~hit["valid"] & ~ok) | (new_depth >= cfg["max_depth"]) \
            | (new_alpha.amax(-1) <= 0) | (sevt & ~b_ok)
        q = torch.clamp(new_alpha.amax(-1) / torch.clamp(
            alpha.amax(-1), min=1e-20), max=cfg["rr_clamp"])
        do_rr = (new_depth >= cfg["rr_depth_photon"]) & active & advances
        kill = do_rr & (draw(k_rr, 1)[:, 0] >= q)
        new_alpha = torch.where((do_rr & ~kill)[:, None],
                                new_alpha / torch.clamp(q, min=1e-6)[:, None],
                                new_alpha)
        null_cross = sevt & is_null
        stored = advances
        reconn_s = (kind == rs.DIFFUSE) & ~delta

        def upd(old, new):
            m = stored[:, None] if new.dim() > 1 else stored
            return torch.where(m, new, old)

        par = dict(
            p=upd(par["p"], rec["p"]), type=upd(par["type"], vtype),
            wi=upd(par["wi"], d), ns=upd(par["ns"], hit["ng"]),
            bsdf=upd(par["bsdf"], rec["bsdf"]),
            med=upd(par["med"], torch.where(mevt, med, -1)),
            scatter=upd(par["scatter"], torch.where(
                m3, ss * pdf_ph[:, None], wgt * pdf_b[:, None])),
            pdf_dir=upd(par["pdf_dir"], torch.where(mevt, pdf_ph, pdf_b)),
            reconn=upd(par["reconn"], mevt | reconn_s),
            idx=upd(par["idx"], step * n_paths + lanes))
        seg_tr = torch.where(stored[:, None], 1.0, torch.where(
            null_cross[:, None], seg_tr * tr, seg_tr))
        seg_pdff = torch.where(stored, 1.0, torch.where(
            null_cross, seg_pdff * pdf_f, seg_pdff))
        o, d, med, alpha, depth = new_o, new_d, new_med, new_alpha, new_depth
        active = active & ~dead & ~kill
    return {k: torch.stack([r[k] for r in recs]) for k in recs[0]}


def _per_record(a, b):
    """|a - b|_1 over |b|_1 + the median |b|_1 of the rows, a row each."""
    a, b = a.double().reshape(a.shape[0], -1), b.double().reshape(
        b.shape[0], -1)
    mag = b.abs().sum(1)
    m = mag.median() if mag.numel() else mag.new_zeros(())
    return (a - b).abs().sum(1) / torch.clamp(mag + m, min=1e-300)


def compare(prog, ref, fields_exact=EXACT, fields_float=FLOAT, only=None):
    """(mean error, share of lanes that differ) of records [S, L, ...]:
    a lane differs where an exact field of a record differs that either
    side holds (vtype != NONE); the error is the mean over the records of
    the other lanes of the largest per-field error. `only` maps a float
    field to a mask [S, L] of the records where it is read."""
    live = (prog["vtype"] != VERT_NONE) | (ref["vtype"] != VERT_NONE)
    bad = torch.zeros_like(live)
    for k in fields_exact:
        bad |= live & (prog[k].to(torch.int64) != ref[k].to(torch.int64))
    lane_bad = bad.any(0)
    keep = live & ~lane_bad[None]
    errs = torch.zeros(keep.shape, dtype=torch.float64, device=keep.device)
    for k in fields_float:
        m = keep & (only[k] if only and k in only else True)
        if bool(m.any()):
            e = _per_record(prog[k][m], ref[k][m])
            errs[m] = torch.maximum(errs[m], e)
    n_keep = int(keep.sum())
    err = float(errs[keep].sum() / n_keep) if n_keep else 0.0
    return err, float(lane_bad.double().mean())


def read_masks(ref):
    """Where each float field is read: a record's shading normal only on
    a surface, its parent's normal only at a surface or the light."""
    return dict(ns=ref["vtype"] == VERT_SURFACE,
                parent_ns=ref["parent_type"] != VERT_MEDIUM)
