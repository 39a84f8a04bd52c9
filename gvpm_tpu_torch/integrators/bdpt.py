"""Bidirectional path tracer with recursive MIS (mirrors
gvpm_tpu/integrators/bdpt.py; reference: src/integrators/bdpt/bdpt.cpp:133
and libbidir's PathSampler).

Per pixel lane one camera subpath and one light subpath are traced by
lockstep loops that carry the SmallVCM-style recursive MIS quantities
(dVCM / dVC, vertex connection only); then every connection strategy is
evaluated with masked lanes. Strategies per lane: s=0 unidirectional hits
(read off the camera walk), s=1 direct connection to the light subpath's
emitter vertex, s>=2, t>=2 inner connections. The t=1 light-tracing
strategy (splats to other pixels) is excluded and the camera-side dVCM
starts at zero so the MIS partition stays consistent.

Medium vertices are connection endpoints of their own: their "cosine"
factors are 1 and their scatter values sigma_s * phase. Balance
heuristic throughout.

Random draws follow the JAX package's keys exactly (per subpath: split
into one key a step, each split into a medium and a scatter key; the
phase and the BSDF samples both draw from the scatter key). The
connections of one camera vertex with every light vertex its depth
admits run as one batch of lanes (CONNECT_LANES at most) and are summed
in the JAX package's order.
"""

from __future__ import annotations

import math

import torch

from ..core import rng
from ..core.config import VolPathConfig
from ..core.math import coordinate_system, dot, to_local, to_world
from ..render import medium as med
from ..render import phase as ph
from ..render.bsdf import eval_bsdf, sample_bsdf
from ..render.emitter import (eval_radiance, pdf_direct_area,
                              sample_direction, sample_position)
from ..render.visibility import medium_transition, segment_transmittance
from ..scene.camera import generate_rays, pixel_grid
from ..scene.intersect import intersect
from ..scene.types import BSDF_NULL, Scene

RAY_EPS = 1e-4

VT_NONE, VT_SURF, VT_MED = 0, 1, 2

# the fields of a connection endpoint on the light side
LE_FIELDS = ("p", "is_emitter", "vtype", "ns", "bsdf", "med", "wi",
             "alpha", "radiance", "dvcm", "dvc", "valid")
# the fields of a camera vertex that _connect reads
CV_FIELDS = ("p", "vtype", "bsdf", "med", "ns", "wi", "alpha", "dvcm",
             "dvc", "seg_med", "is_delta")
# lanes of one _connect call (a batch of endpoints): its intersection
# temporaries take ~12 bytes a lane and a triangle of a tile
CONNECT_LANES = 1 << 22


def _scatter_eval(scene, vtype, bsdf, medidx, ns, wi_prop, wo, transport):
    """(value, pdf_fwd, pdf_rev) of scattering at a subpath vertex.

    wi_prop: arriving propagation direction (prev -> vertex); wo:
    outgoing direction (vertex -> next). The value has no cosine at
    medium vertices and |cos_out| at surfaces."""
    s_ax, t_ax = coordinate_system(ns)
    wi_loc = to_local(ns, s_ax, t_ax, -wi_prop)
    wo_loc = to_local(ns, s_ax, t_ax, wo)
    f_s, pdf_s = eval_bsdf(scene, bsdf, wi_loc, wo_loc, transport=transport)
    _, pdf_s_rev = eval_bsdf(scene, bsdf, wo_loc, wi_loc,
                             transport=transport)
    val_s = f_s * torch.abs(wo_loc[..., 2:3])
    mi = torch.clamp(medidx, 0, scene.med_sigma_s.shape[0] - 1)
    pv = ph.eval_phase(scene, mi, -wi_prop, wo)
    pv_rev = ph.eval_phase(scene, mi, wo, -wi_prop)
    sigma_s = torch.where((medidx >= 0)[..., None], scene.med_sigma_s[mi],
                          0.0)
    val_m = sigma_s * pv[..., None]
    is_med = vtype == VT_MED
    val = torch.where(is_med[..., None], val_m, val_s)
    pdf = torch.where(is_med, pv, pdf_s)
    pdf_rev = torch.where(is_med, pv_rev, pdf_s_rev)
    return val, pdf, pdf_rev


def _cos_at(vtype, ns, w):
    """|cos| at a vertex toward w (1 at medium vertices)."""
    return torch.where(vtype == VT_MED, 1.0, torch.abs(dot(ns, w)))


def _draws(k, g, rand_tile, *tail):
    """jax.random.uniform(k, (g, *tail)) tiled rand_tile times along the
    lanes: lane i of every group of g lanes sees the same numbers."""
    u = rng.uniform(k, (g,) + tail)
    return u if rand_tile == 1 else u.repeat((rand_tile,) + (1,) * len(tail))


def _trace_subpath(scene: Scene, cfg, o, d, med0, alpha0, dvcm0, dvc0, key,
                   transport, n_steps, rand_tile=1):
    """Shared subpath walk; returns the per-step vertex records, each a
    tensor [steps, N, ...].

    rand_tile > 1: the N lanes hold `rand_tile` equal groups and every
    random draw is tiled, so lane i of each group sees the same randoms
    (the base and offset camera subpaths of G-BDPT in one wavefront)."""
    n = o.shape[0]
    g = n // rand_tile
    dev = o.device
    f32 = dict(dtype=torch.float32, device=dev)
    cur_med = med0.expand(n)
    alpha = alpha0
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    dvcm, dvc = dvcm0, dvc0
    null_dist = torch.zeros((n,), **f32)
    depth = torch.zeros((n,), dtype=torch.int64, device=dev)
    recs = []
    for k in rng.split(key, n_steps):
        k_med, k_scat = rng.split(k, 2)
        hit = intersect(scene, o, d)
        t_far = torch.where(hit.valid, hit.t, torch.inf)
        u_med = _draws(k_med, g, rand_tile, 2)
        ms = med.sample_distance(scene, cur_med, o, d, t_far, u_med[:, 0],
                                 u_channel=u_med[:, 1])
        mevt = active & ms.success
        bi = torch.clamp(scene.prim_bsdf(hit.prim), 0,
                         scene.bsdf_type.shape[0] - 1)
        is_null = scene.bsdf_type[bi] == BSDF_NULL
        sevt = active & ~ms.success & hit.valid
        store = mevt | (sevt & ~is_null)

        alpha_med = alpha * ms.transmittance / torch.clamp(
            ms.pdf_success, min=1e-20)[..., None]
        alpha_srf = alpha * ms.transmittance / torch.clamp(
            ms.pdf_failure, min=1e-20)[..., None]

        # MIS propagation over the segment (SmallVCM): dVCM *= d^2;
        # dVCM, dVC /= cos at the new vertex. The distance sums the
        # segment across null boundary crossings
        seg_len = null_dist + torch.where(mevt, ms.t, t_far)
        cos_new = torch.where(mevt, 1.0, torch.abs(dot(hit.ns, d)))
        cos_new = torch.clamp(cos_new, min=1e-6)
        dvcm_at = dvcm * seg_len * seg_len / cos_new
        dvc_at = dvc / cos_new

        vtype = torch.where(mevt, VT_MED, torch.where(sevt & ~is_null,
                                                      VT_SURF, VT_NONE))
        m3 = mevt[..., None]
        vert = dict(
            vtype=torch.where(active, vtype, VT_NONE),
            p=torch.where(m3, ms.p, hit.p), wi=d,
            alpha=torch.where(m3, alpha_med, alpha_srf),
            med=torch.where(mevt, cur_med, -1),
            bsdf=torch.where(sevt, bi, -1),
            ns=torch.where(m3, d, hit.ns),
            dvcm=dvcm_at, dvc=dvc_at, seg_med=cur_med,
            # emitter data at surface hits (the s=0 strategy)
            Le=eval_radiance(scene, hit.prim, hit.ng, -d),
            pdf_light_a=pdf_direct_area(scene, hit.prim),
            depth=depth + 1)   # scatter count (null crossings excluded)

        # ---- scatter: phase and BSDF both draw from k_scat ----
        wo_med, pdf_phase = ph.sample_phase(
            scene, cur_med, -d, _draws(k_scat, g, rand_tile, 2))
        nsf = hit.ns           # true normal: dielectrics need the side
        s_ax, t_ax = coordinate_system(nsf)
        wi_loc = to_local(nsf, s_ax, t_ax, -d)
        bs = sample_bsdf(scene, bi, wi_loc, _draws(k_scat, g, rand_tile, 3),
                         transport=transport)
        wo_srf = to_world(nsf, s_ax, t_ax, bs.wo)
        is_delta = torch.where(mevt, False, bs.is_delta)
        vert["is_delta"] = is_delta

        wo = torch.where(m3, wo_med, wo_srf)
        pdf_fwd = torch.where(mevt, pdf_phase, bs.pdf)
        # reverse pdf of sampling back toward the previous vertex
        _, _, pdf_rev = _scatter_eval(
            scene, vtype, bi, torch.where(mevt, cur_med, -1), hit.ns, d, wo,
            transport)
        cos_out = torch.where(mevt, 1.0, torch.abs(dot(nsf, wo)))

        # SmallVCM recursion after scattering (balance heuristic); delta
        # scatters drop the connection strategies; null crossings keep
        # the MIS state
        pdf_fwd_s = torch.clamp(pdf_fwd, min=1e-20)
        new_dvc = (cos_out / pdf_fwd_s) * (dvc_at * pdf_rev + dvcm_at)
        new_dvcm = 1.0 / pdf_fwd_s
        new_dvc = torch.where(is_delta, (cos_out / pdf_fwd_s) * dvc_at
                              * pdf_rev, new_dvc)
        new_dvcm = torch.where(is_delta, 0.0, new_dvcm)
        passthrough = sevt & is_null
        new_dvcm = torch.where(passthrough, dvcm, new_dvcm)
        new_dvc = torch.where(passthrough, dvc, new_dvc)

        alpha_out = torch.where(m3, alpha_med * ms.sigma_s,
                                alpha_srf * bs.weight)
        crossed = sevt & (dot(wo_srf, hit.ng) * dot(-d, hit.ng) < 0.0)
        new_med = torch.where(mevt, cur_med, torch.where(
            crossed, medium_transition(scene, hit.prim, hit.ng, wo_srf),
            cur_med))
        new_o = torch.where(m3, ms.p, hit.p + hit.ng * torch.sign(
            dot(hit.ng, wo, keepdims=True)) * RAY_EPS)
        new_depth = depth + store.to(torch.int64)
        dead = (~mevt & ~sevt) | (new_depth >= cfg.max_depth) \
            | (alpha_out.amax(-1) <= 0.0)
        recs.append(vert)
        o, d, cur_med = new_o, wo, new_med
        alpha = torch.where(active[..., None], alpha_out, alpha)
        active = active & ~dead
        dvcm, dvc = new_dvcm, new_dvc
        null_dist = torch.where(passthrough, seg_len, 0.0)
        depth = new_depth
    return {f: torch.stack([r[f] for r in recs]) for f in recs[0]}


def _connect(scene: Scene, cv, le):
    """Camera vertex cv x light endpoint le (module level so that G-BDPT
    re-runs connection sweeps on shifted camera vertices,
    gbdpt_proc.cpp:606). le: dict of LE_FIELDS. Returns the MIS-weighted
    contribution [N,3]."""
    seg = le["p"] - cv["p"]
    d2 = torch.clamp(dot(seg, seg), min=1e-12)
    dist = torch.sqrt(d2)
    wl = seg / dist[..., None]

    cv_val, cv_pdf, cv_pdf_rev = _scatter_eval(
        scene, cv["vtype"], cv["bsdf"], cv["med"], cv["ns"], cv["wi"], wl,
        "radiance")

    # light endpoint value / pdfs toward the camera vertex
    cos_le = torch.clamp(dot(le["ns"], -wl), min=0.0)
    em_val = torch.where((cos_le > 0)[..., None], le["radiance"], 0.0)
    em_pdf = cos_le / math.pi
    sc_val, sc_pdf, _ = _scatter_eval(
        scene, le["vtype"], le["bsdf"], le["med"], le["ns"], le["wi"], -wl,
        "importance")
    # reverse pdf at the light vertex: resample its own incoming edge
    # given arrival from the camera side
    _, sc_pdf_rev, _ = _scatter_eval(
        scene, le["vtype"], le["bsdf"], le["med"], le["ns"], wl, -le["wi"],
        "importance")
    is_em = le["is_emitter"]
    le_val = torch.where(is_em[..., None], em_val, sc_val)
    le_pdf = torch.where(is_em, em_pdf, sc_pdf)

    cos_l = torch.where(is_em | (le["vtype"] == VT_SURF),
                        torch.abs(dot(le["ns"], wl)), 1.0)
    cos_c = _cos_at(cv["vtype"], cv["ns"], wl)
    G = cos_l / d2     # the camera-side cosine is in cv_val

    p_start = cv["p"] + torch.where(
        (cv["vtype"] == VT_SURF)[..., None],
        cv["ns"] * torch.sign(dot(cv["ns"], wl, keepdims=True)) * RAY_EPS,
        0.0)
    tr = segment_transmittance(
        scene, p_start, le["p"],
        torch.where(cv["vtype"] == VT_MED, cv["med"], cv["seg_med"]))

    contrib = cv["alpha"] * cv_val * le["alpha"] * le_val * tr * G[..., None]

    pdf_cam_to_l_area = cv_pdf * cos_l / d2
    pdf_l_to_cam_area = le_pdf * cos_c / d2
    w_light = torch.where(
        is_em, pdf_cam_to_l_area * le["dvcm"],       # = pdfA / pdf_area
        pdf_cam_to_l_area * (le["dvcm"] + sc_pdf_rev * le["dvc"]))
    w_cam = pdf_l_to_cam_area * (cv["dvcm"] + cv_pdf_rev * cv["dvc"])
    w = 1.0 / (1.0 + w_light + w_cam)

    ok = le["valid"] & (cv["vtype"] != VT_NONE) & ~cv["is_delta"] \
        & (contrib.amax(-1) > 0) & (cos_l > 1e-6)
    return torch.where(ok[..., None], contrib * w[..., None], 0.0)


def _light_endpoints(lt, steps, conn_ok):
    """The light-subpath endpoints of `steps` as one lane batch:
    LE_FIELDS [len(steps) * N, ...]; conn_ok [len(steps), N] gates
    each."""
    lv = {f: lt[f][steps] for f in lt}
    return dict(
        p=lv["p"], is_emitter=torch.zeros_like(conn_ok),
        vtype=lv["vtype"], ns=lv["ns"], bsdf=lv["bsdf"], med=lv["med"],
        wi=lv["wi"], alpha=lv["alpha"],
        radiance=torch.zeros_like(lv["alpha"]), dvcm=lv["dvcm"],
        dvc=lv["dvc"],
        valid=(lv["vtype"] != VT_NONE) & ~lv["is_delta"] & conn_ok)


def connect_batch(scene: Scene, cv, cv_emitter_vtype, le_emitter, lt, steps,
                  conn_ok):
    """cv (with vtype `cv_emitter_vtype` against the emitter endpoint)
    connected to the s=1 endpoint and then to the light vertices of
    `steps` (conn_ok [len(steps), N]), as batches of lanes of whole
    endpoints, at most CONNECT_LANES lanes (or one endpoint) a batch.
    Returns the contributions [1 + len(steps), N, 3] in that order."""
    n = cv["p"].shape[0]
    k = len(steps)
    lv = _light_endpoints(lt, steps, conn_ok) if k else None
    le = {}
    for f in LE_FIELDS:
        first = le_emitter[f][None]
        le[f] = (first if lv is None else torch.cat([first, lv[f]])).flatten(
            0, 1)
    cvb = {f: cv[f].expand((k + 1,) + cv[f].shape).flatten(0, 1)
           for f in CV_FIELDS}
    vt = torch.cat([cv_emitter_vtype[None], cv["vtype"].expand(k, n)])
    cvb["vtype"] = vt.flatten(0, 1)
    chunk = max(1, CONNECT_LANES // max(n, 1)) * n
    return torch.cat([
        _connect(scene, {f: a[i:i + chunk] for f, a in cvb.items()},
                 {f: a[i:i + chunk] for f, a in le.items()})
        for i in range(0, (k + 1) * n, chunk)]).reshape(k + 1, n, 3)


def _select_depth(verts, kdep):
    """Per-lane record of the kdep-th stored vertex of a [S, N] subpath
    (depth is unique per stored record; null crossings store nothing).
    Adds 'exists' [N]."""
    take = (verts["vtype"] != VT_NONE) & (verts["depth"] == kdep)

    def pick(a):
        w = take.reshape(take.shape + (1,) * (a.dim() - take.dim()))
        if a.dtype == torch.bool:
            return (w & a).any(0)
        return torch.where(w, a, 0).sum(0)

    out = {f: pick(a) for f, a in verts.items()}
    out["exists"] = take.any(0)
    return out


def radiance(scene: Scene, cfg: VolPathConfig, px, py, k):
    """Full BDPT estimate for pixel coords (px, py) with key k; [n,3].

    All randomness derives from k and the lane index only: evaluated at
    offset pixel grids with the same k it replays identical camera and
    light subpath random sequences (the PSS fallback shift of
    gbdpt.py)."""
    return radiance_parts(scene, cfg, px, py, k)["L"]


BUCKETS = ("very_direct", "t1", "t2c", "s0d2", "rest")


def radiance_parts(scene: Scene, cfg: VolPathConfig, px, py, k,
                   rand_tile=1):
    """BDPT estimate split into the buckets the G-BDPT path-space shift
    needs (gbdpt_proc.cpp:606 createShiftedLightPath: here the camera
    subpath is shifted and the light subpath shared):

      very_direct — s=0 at camera depth 1 (left out of the gradients,
                    like gpt's -direct buffer)
      t1   — connections whose camera vertex is v1 (re-evaluated at the
             offset's own first vertex)
      t2c  — connections whose camera vertex is v2 (re-evaluated with
             the offset incoming direction after reconnection)
      s0d2 — s=0 at depth 2 (offset ratio = reconnection ratio only)
      rest — everything deeper (ratio = reconnection x at-v2 scatter)

    plus the v1 / v2 / v3 per-lane records (_select_depth), the subpath
    records `cam` and `lt`, the emitter sample `es` and the s=1 emitter
    endpoint, so that gbdpt runs offset connection sweeps without
    retracing. rand_tile: as _trace_subpath's, for every draw."""
    n = px.shape[0]
    g = n // rand_tile
    dev = px.device
    f32 = dict(dtype=torch.float32, device=dev)
    k_pix, k_cam, k_le, k_lw = rng.split(k, 4)
    n_steps = cfg.max_depth + cfg.null_bounces

    # ---- camera subpath ----
    o, d, _ = generate_rays(scene, px, py, _draws(k_pix, g, rand_tile, 2))
    zeros = torch.zeros((n,), **f32)
    cam = _trace_subpath(scene, cfg, o, d, scene.cam_medium.expand(n),
                         torch.ones((n, 3), **f32), zeros, zeros, k_cam,
                         "radiance", n_steps, rand_tile=rand_tile)

    # ---- light subpath (equal in every lane group: G-BDPT's shared
    # light subpath) ----
    es = sample_position(scene, _draws(k_le, g, rand_tile, 3))
    d0, pdf_dir0 = sample_direction(scene, es, _draws(k_le, g, rand_tile, 2))
    cos_e = torch.clamp(dot(es.n, d0), min=1e-6)
    emission_pdf = torch.clamp(es.pdf_area * pdf_dir0, min=1e-20)
    alpha_l0 = es.radiance * (cos_e / emission_pdf)[..., None]
    alpha_l0 = torch.where(es.valid[..., None], alpha_l0, 0.0)
    lt = _trace_subpath(scene, cfg, es.p + es.n * RAY_EPS, d0,
                        medium_transition(scene, es.prim, es.n, d0),
                        alpha_l0, es.pdf_area / emission_pdf,
                        cos_e / emission_pdf, k_lw, "importance", n_steps,
                        rand_tile=rand_tile)

    L = torch.zeros((n, 3), **f32)
    buckets = {b: torch.zeros((n, 3), **f32) for b in BUCKETS}

    def bucket_of(depth_arr, c, s0=False):
        """Route a contribution to its shift bucket by camera depth."""
        d1 = (depth_arr == 1)[..., None]
        d2 = (depth_arr == 2)[..., None]
        first, second = ("very_direct", "s0d2") if s0 else ("t1", "t2c")
        buckets[first] += torch.where(d1, c, 0.0)
        buckets[second] += torch.where(d2, c, 0.0)
        buckets["rest"] += torch.where(~d1 & ~d2, c, 0.0)

    # ---- s = 0: the camera path hits an emitter, weight
    # 1 / (1 + directPdfA * dVCM + emissionPdfW * dVC), 1 at step 0 ----
    hit_light = (cam["vtype"] == VT_SURF) & (cam["Le"].amax(-1) > 0)
    cos_l = torch.clamp(torch.abs(dot(cam["ns"], cam["wi"])), min=1e-6)
    em_pdf_w = cam["pdf_light_a"] * (cos_l / math.pi)
    w0 = 1.0 / (1.0 + cam["pdf_light_a"] * cam["dvcm"]
                + em_pdf_w * cam["dvc"])
    w0[0] = 1.0
    c0 = torch.where(hit_light[..., None],
                     cam["alpha"] * cam["Le"] * w0[..., None], 0.0)
    for tci in range(n_steps):
        L = L + c0[tci]
        bucket_of(cam["depth"][tci], c0[tci], s0=True)

    # the s=1 endpoint: the emitter sample itself
    inv_pa = 1.0 / torch.clamp(es.pdf_area, min=1e-20)
    le_emitter = dict(
        p=es.p, is_emitter=torch.ones((n,), dtype=torch.bool, device=dev),
        vtype=torch.full((n,), VT_SURF, dtype=torch.int64, device=dev),
        ns=es.n, bsdf=torch.zeros((n,), dtype=torch.int64, device=dev),
        med=torch.full((n,), -1, dtype=torch.int64, device=dev), wi=es.n,
        alpha=inv_pa[..., None] * torch.ones((n, 3), **f32),
        radiance=es.radiance, dvcm=inv_pa, dvc=torch.zeros((n,), **f32),
        valid=es.valid)

    # ---- connections: camera vertex (t) x light vertex (s) ----
    # Strategy gating is per lane on scatter depth, not on the step
    # index: null boundary crossings take steps without adding a vertex.
    # The static skips only prune (tci, sli) pairs whose least possible
    # depths already exceed max_depth.
    nb = cfg.null_bounces
    for tci in range(n_steps):
        if max(1, tci + 1 - nb) + 1 > cfg.max_depth + 1:
            continue
        cv = {f: cam[f][tci] for f in CV_FIELDS}
        dep = cam["depth"][tci]
        steps = [sli for sli in range(n_steps)
                 if max(1, tci + 1 - nb) + max(1, sli + 1 - nb)
                 <= cfg.max_depth]
        conn_ok = dep + lt["depth"][steps] <= cfg.max_depth
        vt_em = torch.where(dep + 1 <= cfg.max_depth + 1, cv["vtype"],
                            VT_NONE)
        cc = connect_batch(scene, cv, vt_em, le_emitter, lt, steps, conn_ok)
        for c in cc:
            L = L + c
            bucket_of(dep, c)

    return dict(L=L, cam=cam, lt=lt, es=es, le_emitter=le_emitter,
                v1=_select_depth(cam, 1), v2=_select_depth(cam, 2),
                v3=_select_depth(cam, 3), **buckets)


def render_pass(scene: Scene, cfg: VolPathConfig, seed, it):
    """One spp of every pixel -> [H,W,3]."""
    k = rng.pass_key(seed, it, rng.STREAM_CAMERA, scene.device)
    px, py = pixel_grid(scene)
    return radiance(scene, cfg, px, py, k).reshape(scene.height,
                                                   scene.width, 3)


def render(scene: Scene, cfg: VolPathConfig = VolPathConfig(), seed=0):
    img = torch.zeros((scene.height, scene.width, 3), dtype=torch.float32,
                      device=scene.device)
    for it in range(cfg.spp):
        img = img + render_pass(scene, cfg, seed, it)
    return img / cfg.spp
