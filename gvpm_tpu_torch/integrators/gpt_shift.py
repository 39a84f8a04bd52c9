"""G-PT path-space shift machine: reconnection + half-vector shifts
(mirrors gvpm_tpu/integrators/gpt_shift.py; reference: gpt/gpt.cpp:502
`evaluate`, the RayState / VertexType classification gpt.cpp:125-187,
the reconnection shift gpt.cpp:298 and the half-vector shift
gpt.cpp:216 with its volume variant gpt.cpp:196).

n base lanes and 4n offset lanes advance in lockstep, one loop step a
bounce. Each bounce composes, per offset lane:

- a parallel bounce before reconnection: the offset replays the base's
  primary samples at its own vertex (sample_bsdf / sample_phase with the
  same uniforms): the half-vector shift for microfacets, the mirror /
  refraction copy for delta lobes; value ratio weight'/weight, pdf
  ratio 1;
- a medium copy: the offset scatters at the base's distance t along its
  own ray; value ratio sigma_s'Tr'/sigma_s Tr, pdf ratio from the
  distance-sampling densities;
- the reconnection: once the previous base and offset vertices and the
  new base vertex are diffuse-classified (is_diffuse_like), the offset
  connects its vertex straight to the new base vertex (area-measure
  Jacobian 1; scatter value x geometry x transmittance, pdfs converted
  to the shared measure);
- after it, the next scatter applies f(wi'->wo)/f(wi->wo)
  (RECENTLY_CONNECTED) and the paths merge (CONNECTED): every later
  contribution is the base's times fr.

Each contribution carries the balance weight 1/(1 + pr) of the pair of
shift-mapped strategies; a failed shift contributes with weight 1 and a
zero shifted value. Light seen straight from the camera is kept out of
the gradients in the -direct buffer, as in the reference. The known
deviations of the JAX module hold here too (the offset NEE segment and
the reconnection distance pdf use the medium at the offset vertex; the
spot falloff change at a shifted NEE vertex is taken as 1).
"""

from __future__ import annotations

import torch

from ..core import rng
from ..core.config import VolPathConfig
from ..core.math import coordinate_system, dot, normalize, to_local, to_world
from ..ops import poisson
from ..render import medium as med
from ..render import phase as ph
from ..render.bsdf import eval_bsdf, is_diffuse_like, sample_bsdf
from ..render.emitter import (env_le, eval_radiance, pdf_env_sa,
                              sample_direct)
from ..render.visibility import medium_transition, segment_transmittance
from ..scene.camera import generate_rays, pixel_grid
from ..scene.intersect import intersect
from ..scene.types import BSDF_NULL, Scene
from .gpt import OFFSETS, RIGHT, LEFT, DOWN, UP
from .gvpm import reject_heterogeneous
from .volpath import RAY_EPS, _light_pdf_sa, _mis, _offset_ray

# offset lane states
ALIVE, CONNECTED, DEAD = 0, 1, 2


def _t4(x):
    """Tile a base tensor [n,...] to the 4 offset blocks [4n,...]."""
    return x.repeat((4,) + (1,) * (x.dim() - 1))


def _safe_div(a, b, eps=1e-20):
    return a / torch.clamp(b, min=eps)


def _sigma_s(scene: Scene, mi):
    """The table's sigma_s of medium `mi` [N,3] (0 outside media)."""
    s = scene.med_sigma_s[torch.clamp(mi, 0,
                                       scene.med_sigma_s.shape[0] - 1)]
    return torch.where((mi >= 0)[..., None], s, 0.0)


def _vertex_scatter(scene: Scene, is_med, med_idx, bi, ns, wi, wo):
    """Radiance-transport scatter value f (x |cos| for surfaces, x sigma_s
    for media) and solid-angle pdf at a camera-subpath vertex. wi points
    away from the vertex toward the previous one, wo toward the next.
    Returns (value [..,3], pdf [..])."""
    s_ax, t_ax = coordinate_system(ns)
    wi_loc = to_local(ns, s_ax, t_ax, wi)
    wo_loc = to_local(ns, s_ax, t_ax, wo)
    bi_c = torch.clamp(bi, 0, scene.bsdf_type.shape[0] - 1)
    f_s, pdf_s = eval_bsdf(scene, bi_c, wi_loc, wo_loc)
    val_s = f_s * torch.abs(wo_loc[..., 2:3])
    mi = torch.clamp(med_idx, 0, scene.med_sigma_s.shape[0] - 1)
    pv = ph.eval_phase(scene, mi, wi, wo)
    val_m = _sigma_s(scene, med_idx) * pv[..., None]
    return (torch.where(is_med[..., None], val_m, val_s),
            torch.where(is_med, pv, pdf_s))


def _bsdf_index(scene: Scene, prim):
    return torch.clamp(scene.prim_bsdf(prim), 0,
                       scene.bsdf_type.shape[0] - 1)


def render_pass(scene: Scene, cfg: VolPathConfig, seed, it, stats=None):
    """One spp of the path-space-shift G-PT. Returns (primal [H,W,3] with
    the very-direct light, gx, gy, direct); the gradient buffers carry
    the per-contribution MIS weights. A `stats` dict receives, per
    offset block, the lanes that reconnected (`reconnected`) and that
    ended CONNECTED / DEAD (`connected`, `dead`)."""
    reject_heterogeneous(scene)
    H, W = scene.height, scene.width
    n = H * W
    m = 4 * n
    dev = scene.device
    f32 = dict(dtype=torch.float32, device=dev)
    n_steps = cfg.max_depth + cfg.null_bounces
    k_pix, k_path = rng.split(rng.pass_key(seed, it, rng.STREAM_CAMERA,
                                           dev), 2)

    px, py = pixel_grid(scene)
    u_pix = rng.uniform(k_pix, (n, 2))
    o_b, d_b, _ = generate_rays(scene, px, py, u_pix)
    off_px = torch.cat([px + dx for dx, dy in OFFSETS])
    off_py = torch.cat([py + dy for dx, dy in OFFSETS])
    o_o, d_o, _ = generate_rays(scene, off_px, off_py, u_pix.repeat(4, 1))

    def full(shape, v, dtype=torch.float32):
        return torch.full(shape, v, dtype=dtype, device=dev)

    b = dict(
        o=o_b, d=d_b, med=scene.cam_medium.expand(n),
        thr=full((n, 3), 1.0), L=full((n, 3), 0.0), Ld=full((n, 3), 0.0),
        active=full((n,), True, torch.bool),
        spec=full((n,), True, torch.bool),
        last_pdf=full((n,), 0.0), scatter_p=o_b,
        f_cos=full((n, 3), 1.0),            # scatter value at y_i -> d
        tr_seg=full((n, 3), 1.0),           # Tr since the last scatter
        pdfdist_seg=full((n,), 1.0),        # dist-pdf since the last one
        depth=full((n,), 0, torch.int64))
    s = dict(
        st=full((m,), ALIVE, torch.int64),
        o=o_o, d=d_o, med=scene.cam_medium.expand(m),
        fr=full((m, 3), 1.0), pr=full((m,), 1.0),
        can_connect=full((m,), False, torch.bool),
        zp_p=o_o, zp_ns=full((m, 3), 0.0), zp_wi=-d_o,
        zp_bsdf=full((m,), 0, torch.int64), zp_med=full((m,), 0,
                                                        torch.int64),
        zp_is_med=full((m,), False, torch.bool),
        # fr / pr at the reconnection parent, taken when the vertex was
        # made (before that bounce's scatter / replay ratio and later
        # null-hop factors): the reconnection replaces the parent's
        # direction choice and the whole following segment
        zp_fr=full((m, 3), 1.0), zp_pr=full((m,), 1.0),
        last_pdf=full((m,), 0.0), scatter_p=o_o,
        spec=full((m,), True, torch.bool), G=full((m, 3), 0.0))
    n_reconnected = torch.zeros(4, dtype=torch.int64, device=dev)

    for k_step in rng.split(k_path, n_steps):
        k_med, k_nee, k_scat, k_rr = rng.split(k_step, 4)
        u_med = rng.uniform(k_med, (n, 2))
        u_nee3 = rng.uniform(k_nee, (n, 3))
        u_ph2 = rng.uniform(k_scat, (n, 2))
        u_bs3 = rng.uniform(k_scat, (n, 3))
        u_rr = rng.uniform(k_rr, (n,))

        active = b["active"]
        thr, cur_med = b["thr"], b["med"]
        first = b["depth"] == 0

        # ----------------- base segment (volpath semantics) -------------
        hit = intersect(scene, b["o"], b["d"])
        t_far = torch.where(hit.valid, hit.t, torch.inf)
        ms = med.sample_distance(scene, cur_med, b["o"], b["d"], t_far,
                                 u_med[:, 0], u_channel=u_med[:, 1])
        mevt = active & ms.success
        sevt = active & ~ms.success & hit.valid
        esc = active & ~ms.success & ~hit.valid
        bi = _bsdf_index(scene, hit.prim)
        is_null = scene.bsdf_type[bi] == BSDF_NULL
        nullx = sevt & is_null
        scat_s = sevt & ~is_null

        thr_med = thr * ms.sigma_s * ms.transmittance \
            * _safe_div(1.0, ms.pdf_success)[..., None]
        thr_surf = thr * ms.transmittance \
            * _safe_div(1.0, ms.pdf_failure)[..., None]

        # base vertex y1 (event position) and its classification
        y1 = torch.where(mevt[..., None], ms.p, hit.p)
        y1_diffuse = mevt | (scat_s & is_diffuse_like(scene, bi))
        ns_b = hit.ns  # true normal: dielectrics need the side's sign
        s_axb, t_axb = coordinate_system(ns_b)
        wi_locb = to_local(ns_b, s_axb, t_axb, -b["d"])

        # base segment totals since the last real scatter (null hops in)
        seg_b = y1 - b["scatter_p"]
        d2_b = torch.clamp(dot(seg_b, seg_b), min=1e-12)
        tr_b_tot = b["tr_seg"] * ms.transmittance
        pdfdist_b = b["pdfdist_seg"] * torch.where(mevt, ms.pdf_success,
                                                   ms.pdf_failure)
        cosT_b = torch.where(mevt, 1.0, torch.abs(dot(hit.ng, b["d"])))

        # ----------------- offsets: advance (a') -------------------------
        alive = s["st"] == ALIVE
        conn = s["st"] == CONNECTED
        hit_o = intersect(scene, s["o"], s["d"])
        t_far_o = torch.where(hit_o.valid, hit_o.t, torch.inf)
        bi_o = _bsdf_index(scene, hit_o.prim)
        null_o = scene.bsdf_type[bi_o] == BSDF_NULL

        evt_scatter = mevt | scat_s                  # base has a vertex
        do_recon = alive & s["can_connect"] & _t4(evt_scatter & y1_diffuse)

        # --- reconnection to the shared base vertex y1 ---
        y1_t = _t4(y1)
        seg_o = y1_t - s["zp_p"]
        d2_o = torch.clamp(dot(seg_o, seg_o), min=1e-12)
        wl_rc = seg_o / torch.sqrt(d2_o)[..., None]
        f_rc, pdf_rc = _vertex_scatter(scene, s["zp_is_med"], s["zp_med"],
                                       s["zp_bsdf"], s["zp_ns"], s["zp_wi"],
                                       wl_rc)
        zp_off = torch.where(s["zp_is_med"][..., None], s["zp_p"],
                             _offset_ray(s["zp_p"], s["zp_ns"], wl_rc))
        tr_rc = segment_transmittance(scene, zp_off, y1_t, s["zp_med"])
        dist_rc = torch.sqrt(d2_o)
        ps_rc, pf_rc = med.pdf_distance(scene, s["zp_med"], dist_rc,
                                        dist_rc + RAY_EPS, True)
        pdfdist_rc = torch.where(_t4(mevt), ps_rc, pf_rc)
        cosT_rc = torch.where(_t4(mevt), 1.0,
                              torch.abs(dot(_t4(hit.ng), wl_rc)))
        # reject reconnections that flip to the other side of the parent
        # surface against the offset's own outgoing direction (signDot,
        # shift_volume_photon.cpp:404-411)
        side_ok = s["zp_is_med"] \
            | (dot(s["zp_ns"], wl_rc) * dot(s["zp_ns"], s["d"]) > 0.0)
        f_cos_b4 = _t4(b["f_cos"])
        rc_ok = do_recon & side_ok \
            & (f_rc.amax(-1) > 0.0) & (pdf_rc > 0.0) \
            & (tr_rc.amax(-1) > 0.0) & (f_cos_b4.amax(-1) > 1e-20) \
            & (_t4(b["last_pdf"]) > 1e-20) & (_t4(pdfdist_b) > 1e-20)
        fr_rc = s["zp_fr"] * _safe_div(f_rc, f_cos_b4) \
            * _safe_div(tr_rc, _t4(tr_b_tot)) \
            * (_safe_div(cosT_rc, _t4(cosT_b), 1e-6)
               * _t4(d2_b) / d2_o)[..., None]
        pr_rc = s["zp_pr"] * _safe_div(pdf_rc, _t4(b["last_pdf"])) \
            * _safe_div(pdfdist_rc, _t4(pdfdist_b)) \
            * _safe_div(cosT_rc, _t4(cosT_b), 1e-6) * _t4(d2_b) / d2_o

        # --- parallel advance (no reconnection this step) ---
        par = alive & ~do_recon
        in_med_o = s["med"] >= 0
        # medium copy: the same distance t_b along the offset ray
        t_b4 = _t4(ms.t)
        z_med = s["o"] + s["d"] * t_b4[..., None]
        tr_om = med.transmittance(scene, s["med"], t_b4, o=s["o"],
                                  d=s["d"])
        ps_o, _ = med.pdf_distance(scene, s["med"], t_b4, t_far_o, False)
        sig_s_o = _sigma_s(scene, s["med"])
        ok_med = par & _t4(mevt) & in_med_o & (t_b4 < t_far_o)
        fr_med = s["fr"] * _safe_div(sig_s_o * tr_om,
                                     _t4(ms.sigma_s * ms.transmittance))
        pr_med = s["pr"] * _safe_div(ps_o, _t4(ms.pdf_success))
        # surface advance: its own hit, of the same event class (null-ness)
        tr_os = med.transmittance(scene, s["med"], hit_o.t, o=s["o"],
                                  d=s["d"])
        _, pf_o = med.pdf_distance(scene, s["med"], hit_o.t, hit_o.t, True)
        ok_surf = par & _t4(sevt) & hit_o.valid & (null_o == _t4(is_null))
        fr_sf = s["fr"] * _safe_div(tr_os, _t4(ms.transmittance))
        pr_sf = s["pr"] * _safe_div(pf_o, _t4(ms.pdf_failure))
        ok_esc = par & _t4(esc) & ~hit_o.valid

        adv_ok = do_recon & rc_ok
        n_reconnected += adv_ok.reshape(4, n).sum(1)
        new_fr = torch.where(adv_ok[..., None], fr_rc,
                             torch.where(ok_med[..., None], fr_med,
                                         torch.where(ok_surf[..., None],
                                                     fr_sf, s["fr"])))
        new_pr = torch.where(adv_ok, pr_rc, torch.where(
            ok_med, pr_med, torch.where(ok_surf, pr_sf, s["pr"])))
        died = alive & _t4(active) & ~(adv_ok | ok_med | ok_surf | ok_esc)
        st1 = torch.where(died, DEAD, s["st"])
        live_o = (st1 == ALIVE) & _t4(active)

        # the offset's current vertex z1 and its local frame
        a3 = adv_ok[..., None]
        z1 = torch.where(a3, y1_t, torch.where(ok_med[..., None], z_med,
                                               hit_o.p))
        z_is_med = ok_med | (adv_ok & _t4(mevt))
        z_ns = torch.where(a3, _t4(hit.ns), hit_o.ns)
        z_wi = torch.where(a3, -wl_rc, -s["d"])
        z_bi = torch.where(adv_ok, _t4(bi), bi_o)
        z_med_idx = s["med"]
        z_diffuse = z_is_med | (~z_is_med & is_diffuse_like(scene, z_bi)
                                & ~(null_o & ~adv_ok))
        s_axo, t_axo = coordinate_system(z_ns)
        wi_loco = to_local(z_ns, s_axo, t_axo, z_wi)

        # ----------------- contributions at y1 / z1 (b) -----------------
        # emitter hit (into the -direct buffer at depth 0)
        Le_b = eval_radiance(scene, hit.prim, hit.ng, -b["d"])
        pdf_l_b = _light_pdf_sa(scene, hit.prim, hit.p, hit.ng,
                                b["scatter_p"])
        w_hit_b = torch.where(b["spec"] | (not cfg.nee), 1.0,
                              _mis(b["last_pdf"], pdf_l_b))
        C_hit_b = torch.where(scat_s[..., None],
                              thr_surf * Le_b * w_hit_b[..., None], 0.0)
        w_env_b = torch.where(b["spec"] | (not cfg.nee), 1.0, _mis(
            b["last_pdf"], pdf_env_sa(scene, b["d"])))
        C_env_b = torch.where(esc[..., None], thr_surf
                              * env_le(scene, b["d"]) * w_env_b[..., None],
                              0.0)

        # offset-side emitter hit / environment
        hito_p = torch.where(a3, _t4(hit.p), hit_o.p)
        hito_ng = torch.where(a3, _t4(hit.ng), hit_o.ng)
        hito_prim = torch.where(adv_ok, _t4(hit.prim), hit_o.prim)
        wi_hit_o = torch.where(a3, wl_rc, s["d"])
        Le_o = eval_radiance(scene, hito_prim, hito_ng, -wi_hit_o)
        lp_o = torch.where(adv_ok, pdf_rc, s["last_pdf"])
        sp_o = torch.where(a3, s["zp_p"], s["scatter_p"])
        pdf_l_o = _light_pdf_sa(scene, hito_prim, hito_p, hito_ng, sp_o)
        spec_o_now = torch.where(adv_ok, False, s["spec"])
        w_hit_o = torch.where(spec_o_now | (not cfg.nee), 1.0,
                              _mis(lp_o, pdf_l_o))
        C_hit_o = torch.where((live_o & _t4(scat_s))[..., None],
                              _t4(thr_surf) * new_fr * Le_o
                              * w_hit_o[..., None], 0.0)
        w_env_o = torch.where(spec_o_now | (not cfg.nee), 1.0, _mis(
            s["last_pdf"], pdf_env_sa(scene, s["d"])))
        C_env_o = torch.where((live_o & _t4(esc))[..., None],
                              _t4(thr_surf) * new_fr * env_le(scene, s["d"])
                              * w_env_o[..., None], 0.0)
        C_hit_base4 = _t4(C_hit_b + C_env_b)
        C_hit_o = C_hit_o + C_env_o \
            + torch.where((conn & _t4(active))[..., None],
                          C_hit_base4 * s["fr"], 0.0)

        # ----------------- NEE at the base vertex -----------------------
        if cfg.nee:
            p_nee_b = torch.where(mevt[..., None], ms.p,
                                  _offset_ray(hit.p, hit.ng, -b["d"]))
            ds = sample_direct(scene, p_nee_b, u_nee3)
            f_b_nee, pdf_dir_b = _vertex_scatter(
                scene, mevt, cur_med, bi, hit.ns, -b["d"], ds.wl)
            # _vertex_scatter folds the TABLE sigma_s for media; thr_med
            # already holds the (local) sigma_s: divide the table's out
            sig_b = torch.where(mevt[..., None], torch.clamp(
                _sigma_s(scene, cur_med), min=1e-20), 1.0)
            f_b_nee = f_b_nee / sig_b
            tr_b_nee = segment_transmittance(scene, p_nee_b, ds.p_light,
                                             cur_med)
            w_b_nee = torch.where(ds.pdf_sa > 0,
                                  _mis(ds.pdf_sa, pdf_dir_b), 1.0)
            thr_evt = torch.where(mevt[..., None], thr_med, thr_surf)
            C_nee_b = torch.where(
                (ds.valid & (mevt | scat_s))[..., None],
                thr_evt * f_b_nee * tr_b_nee * ds.li_over_pdf
                * w_b_nee[..., None], 0.0)

            # offset NEE to the SAME light point
            pl4 = _t4(ds.p_light)
            seg_lo = pl4 - z1
            d2_lo = torch.clamp(dot(seg_lo, seg_lo), min=1e-12)
            wl_o = seg_lo / torch.sqrt(d2_lo)[..., None]
            seg_lb = ds.p_light - torch.where(mevt[..., None], ms.p, hit.p)
            d2_lb = torch.clamp(dot(seg_lb, seg_lb), min=1e-12)
            f_o_nee, pdf_dir_o = _vertex_scatter(
                scene, z_is_med, z_med_idx, z_bi, z_ns, z_wi, wl_o)
            sig_o = torch.where(
                z_is_med[..., None],
                torch.clamp(torch.where(in_med_o[..., None],
                                        _sigma_s(scene, z_med_idx), 0.0),
                            min=1e-20), 1.0)
            f_o_nee = f_o_nee / sig_o
            p_nee_o = torch.where(z_is_med[..., None], z1,
                                  _offset_ray(z1, z_ns, wl_o))
            tr_o_nee = segment_transmittance(scene, p_nee_o, pl4, z_med_idx)
            cosl_b = torch.clamp(torch.abs(dot(ds.n_light,
                                               -normalize(seg_lb))),
                                 min=1e-6)
            cosl_o = torch.abs(dot(_t4(ds.n_light), -wl_o))
            grp4 = _t4(ds.grp)
            # the d^2 falloff ratio only for lights whose Li falls off
            # with distance (area, point / spot); directional and env
            # samples have none -> ratio 1
            f2_4 = _t4(ds.falloff2)
            geom_ratio = torch.where(
                grp4 == 0, _safe_div(cosl_o, _t4(cosl_b), 1e-6)
                * _t4(d2_lb) / d2_lo,
                torch.where((grp4 == 1) & f2_4, _t4(d2_lb) / d2_lo, 1.0))
            pdf_sa_o = _t4(ds.pdf_sa) * torch.where(
                grp4 == 0,
                _safe_div(_t4(cosl_b), cosl_o, 1e-6) * d2_lo / _t4(d2_lb),
                1.0)
            w_o_nee = torch.where(pdf_sa_o > 0, _mis(pdf_sa_o, pdf_dir_o),
                                  1.0)
            C_nee_o_own = _t4(thr_evt) * new_fr * f_o_nee * tr_o_nee \
                * _t4(ds.li_over_pdf) * (geom_ratio * w_o_nee)[..., None]
            live_nee = live_o & _t4(ds.valid & (mevt | scat_s))
            C_nee_o = torch.where(live_nee[..., None], C_nee_o_own, 0.0) \
                + torch.where((conn & _t4(active))[..., None],
                              _t4(C_nee_b) * s["fr"], 0.0)
        else:
            C_nee_b = torch.zeros((n, 3), **f32)
            C_nee_o = torch.zeros((m, 3), **f32)

        # ----------------- scatter at the vertex (c) --------------------
        bs = sample_bsdf(scene, bi, wi_locb, u_bs3)
        wo_surf = to_world(ns_b, s_axb, t_axb, bs.wo)
        wo_med, pdf_med = ph.sample_phase(scene, cur_med, -b["d"], u_ph2)

        # the base's value of this bounce (kept for later reconnections)
        f_b2, pdf_b2 = eval_bsdf(scene, bi, wi_locb, bs.wo)
        fcos_b2 = f_b2 * torch.abs(bs.wo[..., 2:3])
        p_b2 = ph.eval_phase(scene, cur_med, -b["d"], wo_med)
        sig_b2 = torch.where(mevt[..., None], ms.sigma_s, 1.0)
        # (delta vertices are never reconnection parents: store 1 there
        # to keep the ratio guards quiet)
        new_f_cos = torch.where(
            mevt[..., None], sig_b2 * p_b2[..., None],
            torch.where(bs.is_delta[..., None], 1.0, fcos_b2))

        # offsets at (c): a lane that just reconnected evaluates the
        # shared vertex with its own wi
        wo_loco_b = to_local(z_ns, s_axo, t_axo, _t4(wo_surf))
        f_rc2, pdf_rc2 = eval_bsdf(scene, _t4(bi), wi_loco, wo_loco_b)
        p_rc2 = ph.eval_phase(scene, _t4(cur_med), z_wi, _t4(wo_med))
        ones3 = torch.ones((1, 3), **f32)
        pb2_4 = _t4(torch.where(mevt[..., None], p_b2[..., None] * ones3,
                                fcos_b2))
        frc2 = torch.where(_t4(mevt)[..., None], p_rc2[..., None] * ones3,
                           f_rc2 * torch.abs(wo_loco_b[..., 2:3]))
        prc2 = torch.where(_t4(mevt), p_rc2, pdf_rc2)
        prc2_b = _t4(torch.where(mevt, p_b2, pdf_b2))
        rc2_ok = adv_ok & ~_t4(bs.is_delta & scat_s) \
            & (pb2_4.amax(-1) > 1e-20) & (prc2_b > 1e-20)
        fr_rc2 = new_fr * _safe_div(frc2, pb2_4)
        pr_rc2 = new_pr * _safe_div(prc2, prc2_b)

        # the parallel replay at the offset's own vertex, same uniforms
        bs_o = sample_bsdf(scene, z_bi, wi_loco, _t4(u_bs3))
        wo_o_surf = to_world(z_ns, s_axo, t_axo, bs_o.wo)
        wo_o_med, pdf_o_med = ph.sample_phase(scene, z_med_idx, z_wi,
                                              _t4(u_ph2))
        rep_surf = live_o & ~adv_ok & _t4(scat_s) & bs_o.valid \
            & _t4(bs.valid) & (bs_o.is_delta == _t4(bs.is_delta)) \
            & (_t4(bs.weight).amax(-1) > 1e-20)
        rep_med = live_o & ~adv_ok & _t4(mevt)
        fr_rep = new_fr * _safe_div(bs_o.weight, _t4(bs.weight))

        fr2 = torch.where(rc2_ok[..., None], fr_rc2,
                          torch.where(rep_surf[..., None], fr_rep, new_fr))
        pr2 = torch.where(rc2_ok, pr_rc2, new_pr)
        # state transitions: reconnected lanes merge, replay lanes stay
        scatter_step = _t4(mevt | scat_s)
        died2 = live_o & scatter_step \
            & ~(rc2_ok | rep_surf | rep_med | _t4(nullx))
        st2 = torch.where(died2, DEAD, torch.where(rc2_ok, CONNECTED, st1))

        # new offset rays (replay lanes only; null hops pass through)
        null_pass = live_o & ~adv_ok & _t4(nullx)
        d_o_new = torch.where(rep_med[..., None], wo_o_med,
                              torch.where(rep_surf[..., None], wo_o_surf,
                                          s["d"]))
        o_o_new = torch.where(
            rep_med[..., None], z1,
            torch.where((rep_surf | null_pass)[..., None],
                        _offset_ray(hito_p, hito_ng, d_o_new), s["o"]))
        crossed_o = live_o & ~adv_ok & _t4(sevt) \
            & (dot(d_o_new, hito_ng) * dot(-s["d"], hito_ng) < 0.0)
        med_o_new = torch.where(crossed_o, medium_transition(
            scene, hito_prim, hito_ng, d_o_new), s["med"])
        last_pdf_o = torch.where(rep_med, pdf_o_med, torch.where(
            rep_surf, bs_o.pdf, s["last_pdf"]))
        spec_o2 = torch.where(rep_med, False, torch.where(
            rep_surf, bs_o.is_delta, torch.where(rc2_ok, _t4(bs.is_delta),
                                                 s["spec"])))
        scatter_p_o = torch.where((rep_med | rep_surf)[..., None], z1,
                                  s["scatter_p"])

        # can_connect for the NEXT bounce: both current vertices diffuse;
        # null hops keep the previous flag
        can2 = (st2 == ALIVE) & scatter_step & _t4(y1_diffuse) & z_diffuse
        can2 = torch.where(null_pass, s["can_connect"], can2)

        # remember z1 as the reconnection parent of the next bounce
        keep = scatter_step & live_o
        k3 = keep[..., None]

        # ----------------- accumulate gradients -------------------------
        # shift MIS weight per contribution 1/(1+pr); failed lanes w = 1
        lc = live_o | conn
        pr_c = torch.where(conn, s["pr"], new_pr)
        w_sh = torch.where(lc, 1.0 / (1.0 + pr_c), 1.0)
        C_s_hit = torch.where(lc[..., None], C_hit_o, 0.0)
        C_s_nee = torch.where(lc[..., None], C_nee_o, 0.0)
        dG = torch.where(~_t4(first)[..., None],
                         w_sh[..., None] * (C_s_hit - C_hit_base4), 0.0) \
            + w_sh[..., None] * (C_s_nee - _t4(C_nee_b))

        s = dict(
            st=st2, o=o_o_new, d=d_o_new, med=med_o_new, fr=fr2, pr=pr2,
            can_connect=can2,
            zp_p=torch.where(k3, z1, s["zp_p"]),
            zp_ns=torch.where(k3, z_ns, s["zp_ns"]),
            zp_wi=torch.where(k3, z_wi, s["zp_wi"]),
            zp_bsdf=torch.where(keep, z_bi, s["zp_bsdf"]),
            zp_med=torch.where(keep, z_med_idx, s["zp_med"]),
            zp_is_med=torch.where(keep, z_is_med, s["zp_is_med"]),
            zp_fr=torch.where(k3, new_fr, s["zp_fr"]),
            zp_pr=torch.where(keep, new_pr, s["zp_pr"]),
            last_pdf=last_pdf_o, scatter_p=scatter_p_o, spec=spec_o2,
            G=s["G"] + dG)

        # ----------------- base state update ----------------------------
        # base radiance: the very-direct split
        C_hit_env_b = C_hit_b + C_env_b
        L2 = b["L"] + C_nee_b + torch.where(first[..., None], 0.0,
                                            C_hit_env_b)
        Ld2 = b["Ld"] + torch.where(first[..., None], C_hit_env_b, 0.0)
        m3, s3 = mevt[..., None], sevt[..., None]
        new_d = torch.where(m3, wo_med, torch.where(s3, wo_surf, b["d"]))
        new_o = torch.where(m3, ms.p, torch.where(
            s3, _offset_ray(hit.p, hit.ng, wo_surf), b["o"]))
        new_thr = torch.where(m3, thr_med,
                              torch.where(s3, thr_surf * bs.weight, thr))
        crossed = sevt & (dot(wo_surf, hit.ng) * dot(-b["d"], hit.ng) < 0.0)
        new_med = torch.where(crossed, medium_transition(
            scene, hit.prim, hit.ng, wo_surf), cur_med)
        scat = mevt | scat_s
        new_depth = b["depth"] + scat.to(torch.int64)
        dead = (~hit.valid & ~ms.success) | (new_depth >= cfg.max_depth) \
            | (new_thr.amax(-1) <= 0.0) | (~bs.valid & sevt)
        q = torch.clamp(new_thr.amax(-1), max=cfg.rr_clamp)
        do_rr = (new_depth >= cfg.rr_depth) & active
        rr_kill = do_rr & (u_rr >= q)
        new_thr = torch.where((do_rr & ~rr_kill)[..., None],
                              new_thr * _safe_div(1.0, q, 1e-6)[..., None],
                              new_thr)
        b = dict(
            o=new_o, d=new_d, med=new_med, thr=new_thr, L=L2, Ld=Ld2,
            active=active & ~dead & ~rr_kill,
            spec=torch.where(mevt, False,
                             torch.where(scat_s, bs.is_delta, b["spec"])),
            last_pdf=torch.where(mevt, pdf_med,
                                 torch.where(scat_s, bs.pdf,
                                             b["last_pdf"])),
            scatter_p=torch.where(scat[..., None], y1, b["scatter_p"]),
            f_cos=torch.where(scat[..., None], new_f_cos, b["f_cos"]),
            tr_seg=torch.where(scat[..., None], 1.0,
                               b["tr_seg"] * ms.transmittance),
            pdfdist_seg=torch.where(scat, 1.0,
                                    b["pdfdist_seg"] * ms.pdf_failure),
            depth=new_depth)

    if stats is not None:
        st = s["st"].reshape(4, n)
        stats["reconnected"] = n_reconnected
        stats["connected"] = (st == CONNECTED).sum(1)
        stats["dead"] = (st == DEAD).sum(1)
    L_ind = b["L"].reshape(H, W, 3)
    L_dir = b["Ld"].reshape(H, W, 3)
    G = s["G"].reshape(4, H, W, 3)
    # each edge (x, x+1) is sampled by the forward shift from x (RIGHT)
    # and the backward shift from x+1 (LEFT), whose balance weights
    # already make the pairwise MIS: the assembly is a plain sum
    gx = G[RIGHT].clone()
    gx[:, :-1] += -G[LEFT][:, 1:]
    gy = G[DOWN].clone()
    gy[:-1, :] += -G[UP][1:, :]
    return L_ind + L_dir, gx, gy, L_dir


def render(scene: Scene, cfg: VolPathConfig = VolPathConfig(), seed=0,
           callback=None, recon_alpha=0.2, recon_l1=True, recon_iters=50):
    """Progressive path-space-shift G-PT: average primal / gradients over
    spp, screened-Poisson reconstruction of the indirect component, then
    the very-direct buffer added back (gpt.cpp:2775-2900). Returns
    dict(image, primal, gx, gy, direct)."""
    acc = None
    for it in range(cfg.spp):
        out = render_pass(scene, cfg, seed, it)
        acc = list(out) if acc is None else [a + b for a, b in zip(acc, out)]
        if callback is not None:
            callback(it, acc[0] / (it + 1))
    primal, gx, gy, direct = [a / cfg.spp for a in acc]
    recon = poisson.solve(primal - direct, gx, gy, alpha=recon_alpha,
                          iters=recon_iters, l1=recon_l1) + direct
    return dict(image=recon, primal=primal, gx=gx, gy=gy, direct=direct)
