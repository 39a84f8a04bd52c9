"""Plain reference of the manifold (ME) shifts: for a sample of the pairs
a shift call took, the photon's specular chain walked up from the light
pass's records, the anchor direction (and for a volume photon the final
distance) solved by Newton's method so that the chain, re-traced
through the same primitives with the same reflections, lands on the
shifted target, and the shifted photon's power ratio and pdf ratio:
the anchor's scatter ratio, the chain's transmittance ratio and the
ratio of the geometric terms |dc/du| at the base and the shifted chain
(the Jacobian of the shift). Float64, the Jacobians by central
differences, one lane at a time in spirit (every operation is per
lane). The chains here meet conductors only (the scene's mirror): a
dielectric's Fresnel branch is not modelled.
"""

from __future__ import annotations

import torch

from . import planar as pl
from . import scene as rs
from .light import VERT_SURFACE
from .scene import dot, frame, normalize

K_MAX = 3           # the longest specular chain the shift follows
NEWTON_EPS = 1e-4   # residual, relative to the scene's diagonal
MAX_STEP = 0.15     # trust region of a Newton step (tangent units)
FOLD_EPS = 3e-3     # the least geometric term, over the distance squared
MAX_DEV = 0.35      # the largest deviation of the anchor direction
H = 1e-6            # the step of the central differences
PLANAR_DIFFUSE = 0  # the diffuse material of reference/planar.bsdf


def pull(sc, pv, idx):
    """The chains of photons `idx` from the records `pv` (flattened
    light pass): a dict of [L] (or [L, K]) float64 tensors."""
    f64 = torch.float64
    n = pv["p"].shape[0]
    delta = sc["mat_kind"] == rs.CONDUCTOR

    def field(name, j):
        return pv[name][torch.clamp(j, 0, n - 1)]

    cur = idx.clone()
    L = idx.shape[0]
    alive = torch.ones(L, dtype=torch.bool, device=idx.device)
    done = torch.zeros_like(alive)
    walked = []
    for _ in range(K_MAX):
        par = field("parent_idx", cur)
        pb = torch.clamp(field("parent_bsdf", cur), 0, delta.shape[0] - 1)
        ok = alive & ~done & ~field("reconnectable", cur).bool() \
            & (field("parent_type", cur) == VERT_SURFACE) & delta[pb] \
            & (par >= 0)
        walked.append(torch.where(ok, par, -1))
        done = done | (ok & field("reconnectable", par).bool())
        alive = alive & ok
        cur = torch.where(ok, par, cur)
    k = sum((w >= 0).to(torch.int64) for w in walked)
    # slot j counts from the anchor: the vertex k-1-j steps above the photon
    slots = torch.stack([
        torch.where(j < k, torch.stack(walked, 1).gather(
            1, torch.clamp(k - 1 - j, 0, K_MAX - 1)[:, None])[:, 0], -1)
        for j in range(K_MAX)], 1)
    live = slots >= 0
    first = torch.clamp(slots[:, 0], 0, n - 1)
    pos = field("p", slots).to(f64)
    ph_p = pv["p"][idx].to(f64)
    wi = field("wi", slots).to(f64)
    ns = field("ns", slots).to(f64)
    seg = torch.cat([field("seg_med", slots), pv["seg_med"][idx][:, None]],
                    1)
    seg = torch.where(torch.cat([live, torch.ones_like(live[:, :1])], 1),
                      seg, -1)
    lastpos = pos.gather(1, torch.clamp(k - 1, 0)[:, None, None].expand(
        L, 1, 3))[:, 0]
    return dict(
        ok=done & (k >= 1), k=k, prim=torch.where(live, field("prim", slots),
                                                  -1),
        enter=dot(wi, ns) < 0, seg_med=seg,
        anchor_p=field("parent_p", first).to(f64),
        anchor_ns=field("parent_ns", first).to(f64),
        anchor_wi=field("parent_wi", first).to(f64),
        anchor_type=field("parent_type", first),
        anchor_bsdf=field("parent_bsdf", first),
        anchor_med=field("parent_med", first),
        sc_base=field("scatter_base", first).to(f64),
        pdf_dir_base=field("pdf_dir_base", first).to(f64),
        w1_base=normalize(pos[:, 0] - field("parent_p", first).to(f64)),
        t_last=torch.linalg.vector_norm(ph_p - lastpos, dim=-1))


def _hit_prim(sc, prim, p, d, enter):
    """(t, normal, ok) of rays against one known primitive each: a
    triangle's plane, or a sphere's root on the side the base chain took
    (the other where that one lies behind)."""
    T = sc["n_tris"]
    is_tri = prim < T
    ti = torch.clamp(prim, 0, T - 1)
    si = torch.clamp(prim - T, 0, sc["sph_radius"].shape[0] - 1)
    n_t = sc["tri_ng"][ti]
    den = dot(d, n_t)
    t_t = dot(sc["tri_p0"][ti] - p, n_t) / torch.where(den.abs() > 1e-9,
                                                       den, 1e-9)
    ok_t = (den.abs() > 1e-9) & (t_t > 1e-5)
    c, r = sc["sph_center"][si], sc["sph_radius"][si]
    oc = p - c
    b = dot(oc, d)
    disc = b * b - (dot(oc, oc) - r * r)
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    near, far = -b - sq, -b + sq
    t_s = torch.where(enter, near, far)
    other = torch.where(enter, far, near)
    t_s = torch.where(t_s > 1e-5, t_s, torch.where(other > 1e-5, other,
                                                  -1.0))
    ok_s = (disc > 0) & (t_s > 1e-5)
    n_s = (p + d * t_s[:, None] - c) / r[:, None]
    return (torch.where(is_tri, t_t, t_s),
            torch.where(is_tri[:, None], n_t, n_s),
            torch.where(is_tri, ok_t, ok_s))


def retrace(sc, ch, w1):
    """The chain from its anchor along w1, reflected at each of its k
    primitives -> (exit point, exit direction, ok, lengths [L, K],
    vertices: the anchor, then the k hit points [L, K + 1, 3], the
    last repeated past k)."""
    p, d = ch["anchor_p"], w1
    ok = torch.ones_like(ch["ok"])
    lens, pts = [], [p]
    for j in range(K_MAX):
        live = j < ch["k"]
        t, nrm, hok = _hit_prim(sc, ch["prim"][:, j], p, d, ch["enter"][:, j])
        d_new = d - 2.0 * dot(d, nrm)[:, None] * nrm
        ok = ok & (hok | ~live)
        lens.append(torch.where(live, t, 0.0))
        p = torch.where(live[:, None], p + d * t[:, None], p)
        d = torch.where(live[:, None], d_new, d)
        pts.append(p)
    return p, d, ok, torch.stack(lens, 1), torch.stack(pts, 1)


def _w1(ch, sa, ta, u):
    return normalize(ch["w1_base"] + u[:, 0:1] * sa + u[:, 1:2] * ta)


def _jacobian(fn, u):
    """fn(u) [L, m] and its Jacobian [L, m, n] by central differences."""
    val = fn(u)
    cols = []
    for j in range(u.shape[1]):
        e = torch.zeros_like(u)
        e[:, j] = H
        cols.append((fn(u + e) - fn(u - e)) / (2 * H))
    return val, torch.stack(cols, -1)


def _det(J):
    if J.shape[-1] == 2:
        return J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]
    c = torch.stack([J[:, 1, 1] * J[:, 2, 2] - J[:, 1, 2] * J[:, 2, 1],
                     J[:, 1, 2] * J[:, 2, 0] - J[:, 1, 0] * J[:, 2, 2],
                     J[:, 1, 0] * J[:, 2, 1] - J[:, 1, 1] * J[:, 2, 0]], -1)
    return (J[:, 0] * c).sum(-1)


def _solve(J, det, r):
    """J^-1 r by Cramer's rule (2 or 3 unknowns)."""
    cols = []
    for j in range(J.shape[-1]):
        Jj = J.clone()
        Jj[:, :, j] = r
        cols.append(_det(Jj) / det)
    return torch.stack(cols, -1)


def _newton(fn, u, n_iters):
    """Newton on residual fn(u) with the trust region on the direction;
    returns (u, residual, J at u, J at the start)."""
    r, J = _jacobian(fn, u)
    J0 = J
    for _ in range(n_iters):
        det = _det(J)
        step_ok = det.abs() > 1e-18
        du = _solve(J, torch.where(step_ok, det, 1.0), r)
        dn = torch.linalg.vector_norm(du[:, :2], dim=-1)
        lim = torch.clamp(MAX_STEP / torch.clamp(dn, min=1e-12), max=1.0)
        du = torch.cat([du[:, :2] * lim[:, None], du[:, 2:]], 1)
        u = torch.where(step_ok[:, None], u - du, u)
        r, J = _jacobian(fn, u)
    return u, r, J, J0


def _blocked(sc, a, b, eps=2e-3):
    """Whether a non-null surface lies on the open segment a -> b."""
    seg = b - a
    dist = torch.linalg.vector_norm(seg, dim=-1)
    d = seg / torch.clamp(dist, min=1e-20)[:, None]
    hit = rs.intersect_all(sc, a, d)
    solid = sc["mat_kind"][hit["mat"]] != rs.NULL
    inside = (hit["t"] > eps * dist[:, None]) \
        & (hit["t"] < dist[:, None] * (1 - eps))
    return (solid & inside).any(1)


def shift(sc, ch, target, kind, photon=None, n_iters=5):
    """(alpha ratio [L, 3], pdf ratio [L], ok [L], incident direction at
    the shifted photon [L, 3]) of the chains `ch` shifted to `target`
    [L, 3]. kind "volume": the unknowns are the anchor direction and the
    final distance; "surface": the direction, the chain's exit ray meeting
    the photon's primitive (`photon`: dict prim, ns, enter)."""
    scale = sc["world_diag"]
    sa, ta = frame(ch["w1_base"])
    if kind == "volume":
        def fn(u):
            ep, ed = retrace(sc, ch, _w1(ch, sa, ta, u))[:2]
            return ep + ed * u[:, 2:3] - target
        u0 = torch.cat([torch.zeros_like(target[:, :2]),
                        ch["t_last"][:, None]], 1)
    else:
        ts, tt = frame(photon["ns"])

        def end(u):
            ep, ed = retrace(sc, ch, _w1(ch, sa, ta, u))[:2]
            t, _, _ = _hit_prim(sc, photon["prim"], ep, ed, photon["enter"])
            return ep + ed * t[:, None]

        def fn(u):
            v = end(u) - target
            return torch.stack([dot(v, ts), dot(v, tt)], -1)
        u0 = torch.zeros_like(target[:, :2])
    u, r, J, J0 = _newton(fn, u0, n_iters)
    w1 = _w1(ch, sa, ta, u)
    ep, ed, ok_tr, len_off, pts = retrace(sc, ch, w1)
    if kind == "volume":
        t_off = u[:, 2]
    else:
        t_off, _, hok = _hit_prim(sc, photon["prim"], ep, ed, photon["enter"])
        ok_tr = ok_tr & hok
    conv = (torch.linalg.vector_norm(r, dim=-1) < NEWTON_EPS * scale) \
        & (torch.linalg.vector_norm(u[:, :2], dim=-1) < MAX_DEV)
    s_off = (1.0 + u[:, 0] ** 2 + u[:, 1] ** 2) ** -1.5
    rho_off = _det(J).abs() / torch.clamp(s_off, min=1e-12)
    rho_base = _det(J0).abs()
    _, _, ok_b, len_base, _ = retrace(sc, ch, ch["w1_base"])

    # the anchor's scatter toward the new direction
    bi = torch.clamp(ch["anchor_bsdf"], 0, sc["mat_kind"].shape[0] - 1)
    mi = ch["anchor_med"]
    zero = torch.zeros_like(t_off)
    bparams = dict(
        btype=torch.where(sc["mat_kind"][bi] == rs.DIFFUSE, PLANAR_DIFFUSE,
                          -1),
        alb=sc["mat_albedo"][bi].unbind(-1), spec=(zero,) * 3,
        eta3=(zero + 1,) * 3, alpha=zero + 0.1, eta1=zero + 1.5)
    sigs = torch.where((mi >= 0)[:, None], sc["sigma_s"], 0.0)
    mparams = dict(sigs=sigs.unbind(-1), g=zero + sc["g"],
                   ptype=torch.full_like(mi, sc["phase"]))
    sr, sg, sb, pdf_new, ok_an = pl.parent_scatter(
        ch["anchor_type"], ch["anchor_wi"].unbind(-1),
        ch["anchor_ns"].unbind(-1), bparams, mparams, w1.unbind(-1))
    sc_new = torch.stack([sr, sg, sb], -1)
    sc_ratio = sc_new / torch.clamp(ch["sc_base"], min=1e-20)
    pdf_ratio = pdf_new / torch.clamp(ch["pdf_dir_base"], min=1e-20)

    def sigma_t(m):
        return torch.where((m >= 0)[..., None], sc["sigma_t"], 0.0)

    dlen = torch.cat([len_off - len_base, (t_off - ch["t_last"])[:, None]], 1)
    tr_ratio = torch.exp(-(sigma_t(ch["seg_med"]) * dlen[..., None]).sum(1))
    rho_ratio = rho_base / torch.clamp(rho_off, min=1e-20)
    alpha_ratio = sc_ratio * tr_ratio * rho_ratio[:, None]
    stl = sigma_t(ch["seg_med"][:, -1])
    e_new = torch.exp(-stl * t_off[:, None])
    e_old = torch.exp(-stl * ch["t_last"][:, None])
    if kind == "surface":
        dn, do = e_new.mean(-1), e_old.mean(-1)
    else:
        dn, do = (stl * e_new).mean(-1), (stl * e_old).mean(-1)
    pdf_ratio = pdf_ratio * torch.where(do > 1e-20, dn / torch.clamp(
        do, min=1e-20), 1.0) * rho_ratio
    t2 = torch.clamp(t_off, min=1e-3) ** 2
    t2b = torch.clamp(ch["t_last"], min=1e-3) ** 2
    ok = ch["ok"] & conv & ok_tr & ok_b & ok_an \
        & (ch["pdf_dir_base"] > 1e-20) & (pdf_new > 0) \
        & (rho_off > FOLD_EPS * t2) & (rho_base > FOLD_EPS * t2b)
    # the shifted chain, anchor to target, must be clear of surfaces
    blocked = torch.zeros_like(ok)
    for j in range(K_MAX + 1):
        b = torch.where((j == ch["k"])[:, None], target,
                        pts[:, min(j + 1, K_MAX)])
        blocked |= (j <= ch["k"]) & _blocked(sc, pts[:, j], b)
    ok = ok & ~blocked
    return (torch.where(ok[:, None], alpha_ratio, 0.0),
            torch.where(ok, pdf_ratio, 0.0), ok, ed)


def compare(prog, ref):
    """(error, share of lanes whose decision differs) of (alpha ratio, pdf
    ratio, ok, direction) tuples: the error is the mean, over the lanes
    the reference shifts, of the largest relative error of the ratios (a
    lane the program does not shift reads 0 there, so 1) and of the
    direction where both shift."""
    from .light import _per_record
    ar_p, pr_p, ok_p, wi_p = prog
    ar_r, pr_r, ok_r, wi_r = ref
    ok_p = ok_p.bool()
    if not bool(ok_r.any()):
        return 0.0, float((ok_p != ok_r).double().mean()) if ok_r.numel() \
            else 0.0
    miss = float((ok_p != ok_r).double().mean())
    e = torch.stack([_per_record(ar_p[ok_r], ar_r[ok_r]),
                     _per_record(pr_p[ok_r][:, None], pr_r[ok_r][:, None])]
                    ).amax(0)
    both = ok_p[ok_r]
    if bool(both.any()):
        e[both] = torch.maximum(e[both], _per_record(
            normalize(wi_p[ok_r][both].double()), wi_r[ok_r][both]))
    return float(e.mean()), miss
