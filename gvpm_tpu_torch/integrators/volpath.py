"""Volumetric path tracer with NEE + MIS (mirrors
gvpm_tpu/integrators/volpath.py; reference: integrators/volpath).

A wavefront of W*H*spp lanes advances in lockstep over bounces; medium
vs surface events, null crossings and Russian roulette are masked lane
updates. It generated the committed goldens (tools/goldens.py) and is
the primal baseline. Random numbers follow the JAX package's key
derivations exactly (per pass: split in two for the pixel samples and in
three for the path; per step: split in four), so the port draws the same
streams.
"""

from __future__ import annotations

import torch

from ..core import qmc, rng
from ..core.config import VolPathConfig
from ..core.math import coordinate_system, dot, to_local, to_world
from ..render import film
from ..render import medium as med
from ..render import phase as ph
from ..render.bsdf import eval_bsdf, sample_bsdf
from ..render.emitter import (env_le, eval_radiance, pdf_direct_area,
                              pdf_env_sa, sample_direct)
from ..render.visibility import medium_transition, segment_transmittance
from ..scene.camera import generate_rays, pixel_grid
from ..scene.intersect import intersect
from ..scene.types import BSDF_NULL, Scene

RAY_EPS = 1e-4


def _offset_ray(p, n, d):
    """Offset origin along the geometric normal toward the outgoing side."""
    return p + n * torch.sign(dot(n, d, keepdims=True)) * RAY_EPS


def _mis(pdf_a, pdf_b):
    """Balance heuristic weight for strategy a."""
    return pdf_a / torch.clamp(pdf_a + pdf_b, min=1e-20)


def _light_pdf_sa(scene, prim, p_light, n_light, p_from):
    """Solid-angle pdf at p_from of NEE sampling the point p_light."""
    seg = p_light - p_from
    d2 = torch.clamp(dot(seg, seg), min=1e-12)
    wl = seg / torch.sqrt(d2)[..., None]
    cos_l = torch.clamp(dot(n_light, -wl), min=0.0)
    pdf_a = pdf_direct_area(scene, prim)
    return torch.where(cos_l > 1e-6,
                       pdf_a * d2 / torch.clamp(cos_l, min=1e-6), 0.0)


def _nee(scene, u3, p, med_idx, throughput, f_of_dir):
    """Next-event estimation from vertices p over the emitter groups.
    f_of_dir(wl) -> (f [N,3], pdf_dir [N]). Returns radiance [N,3]."""
    ds = sample_direct(scene, p, u3)
    f, pdf_dir = f_of_dir(ds.wl)
    tr = segment_transmittance(scene, p, ds.p_light, med_idx)
    w = torch.where(ds.pdf_sa > 0, _mis(ds.pdf_sa, pdf_dir), 1.0)
    contrib = throughput * f * tr * ds.li_over_pdf * w[..., None]
    return torch.where(ds.valid[..., None], contrib, 0.0)


# uniforms consumed per path step in explicit primary-sample-space mode:
# medium 2 + NEE 3 + phase 2 + bsdf 3 + RR 1
PSS_DIMS_PER_STEP = 11


def _step_uniforms(step_key, n_rng, tile_rngs):
    """One step's uniforms from its key: (u_med [n,2], u_nee3 [n,3],
    u_ph2 [n,2], u_bs3 [n,3], u_rr [n]). Each block is drawn for n_rng
    lanes and tiled tile_rngs times, so lane i and lane i + j * n_rng
    consume the same numbers."""
    k_med, k_nee, k_scat, k_rr = rng.split(step_key, 4)

    def U(k, *tail):
        u = rng.uniform(k, (n_rng,) + tail)
        return u if tile_rngs == 1 else u.repeat(
            (tile_rngs,) + (1,) * len(tail))

    return U(k_med, 2), U(k_nee, 3), U(k_scat, 2), U(k_scat, 3), U(k_rr)


def trace_radiance(scene: Scene, cfg: VolPathConfig, o, d, med_idx, key,
                   tile_rngs=1, u_explicit=None):
    """Estimate incident radiance along rays (o, d). Returns [N,3].

    tile_rngs=k makes the per-lane random sequence repeat every n/k
    lanes (lane i and lane i + j*n/k consume identical uniforms): the
    primary-sample-space replay of the G-PT shift (gpt.py).

    u_explicit ([n, n_steps, PSS_DIMS_PER_STEP] or None) drives the walk
    from an explicit primary-sample-space vector instead of the key: the
    deterministic map f(u) that PSSMLT mutates (pssmlt.py)."""
    n = o.shape[0]
    dev = o.device
    f32 = dict(dtype=torch.float32, device=dev)
    cur_med = torch.as_tensor(med_idx, device=dev).expand(n)
    thr = torch.ones((n, 3), **f32)
    L = torch.zeros((n, 3), **f32)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    spec = torch.ones((n,), dtype=torch.bool, device=dev)  # camera: delta
    last_pdf = torch.zeros((n,), **f32)
    scatter_p = o                                 # last real scatter vertex
    depth = torch.zeros((n,), dtype=torch.int64, device=dev)

    n_steps = cfg.max_depth + cfg.null_bounces
    steps = rng.split(key, n_steps) if u_explicit is None \
        else u_explicit.unbind(1)
    for step_in in steps:
        if u_explicit is None:
            u_med, u_nee3, u_ph2, u_bs3, u_rr = _step_uniforms(
                step_in, n // tile_rngs, tile_rngs)
        else:
            u_med, u_nee3, u_ph2, u_bs3, u_rr = (
                step_in[:, 0:2], step_in[:, 2:5], step_in[:, 5:7],
                step_in[:, 7:10], step_in[:, 10])

        hit = intersect(scene, o, d)
        t_far = torch.where(hit.valid, hit.t, torch.inf)
        ms = med.sample_distance(scene, cur_med, o, d, t_far, u_med[:, 0],
                                 u_channel=u_med[:, 1])

        # ---------------- medium event ----------------
        mevt = active & ms.success
        thr_med = thr * ms.sigma_s * ms.transmittance \
            / torch.clamp(ms.pdf_success, min=1e-20)[..., None]
        wo_med, pdf_med = ph.sample_phase(scene, cur_med, -d, u_ph2)

        # ---------------- surface event ----------------
        sevt = active & ~ms.success & hit.valid
        thr_surf = thr * ms.transmittance \
            / torch.clamp(ms.pdf_failure, min=1e-20)[..., None]

        # emitter hit: MIS against NEE, pdf from the last REAL scatter
        # vertex (not a null crossing)
        Le = eval_radiance(scene, hit.prim, hit.ng, -d)
        pdf_l_sa = _light_pdf_sa(scene, hit.prim, hit.p, hit.ng, scatter_p)
        w_hit = torch.where(spec | (not cfg.nee), 1.0,
                            _mis(last_pdf, pdf_l_sa))
        L_hit = thr_surf * Le * w_hit[..., None]

        # TRUE shading normal (no viewer-facing flip): the BSDF routines
        # are sign-aware
        ns = hit.ns
        s_ax, t_ax = coordinate_system(ns)
        wi_loc = to_local(ns, s_ax, t_ax, -d)
        bi = torch.clamp(scene.prim_bsdf(hit.prim), 0,
                         scene.bsdf_type.shape[0] - 1)
        is_null = scene.bsdf_type[bi] == BSDF_NULL
        bs = sample_bsdf(scene, bi, wi_loc, u_bs3)
        wo_surf = to_world(ns, s_ax, t_ax, bs.wo)

        # ---------------- merged NEE (one shadow batch per bounce) -------
        if cfg.nee:
            def scatter_f(wl):
                # medium lanes: phase; surface lanes: bsdf * |cos|
                f_ph = ph.eval_phase(scene, cur_med, -d, wl)
                wl_loc = to_local(ns, s_ax, t_ax, wl)
                f_b, pdf_b = eval_bsdf(scene, bi, wi_loc, wl_loc)
                f_b = f_b * torch.abs(wl_loc[..., 2:3])
                f = torch.where(mevt[..., None],
                                f_ph[..., None] * torch.ones((1, 3), **f32),
                                f_b)
                return f, torch.where(mevt, f_ph, pdf_b)

            p_nee = torch.where(mevt[..., None], ms.p,
                                _offset_ray(hit.p, hit.ng, -d))
            thr_nee = torch.where(mevt[..., None], thr_med, thr_surf)
            L_nee = _nee(scene, u_nee3, p_nee, cur_med, thr_nee, scatter_f)
            L_nee = torch.where((mevt | (sevt & ~is_null))[..., None],
                                L_nee, 0.0)
        else:
            L_nee = torch.zeros((n, 3), **f32)

        # escaped rays: the environment, MIS vs the NEE env strategy
        esc = active & ~ms.success & ~hit.valid
        w_env = torch.where(spec | (not cfg.nee), 1.0,
                            _mis(last_pdf, pdf_env_sa(scene, d)))
        L_env = thr_surf * env_le(scene, d) * w_env[..., None]

        # ---------------- merge events ----------------
        L = L + L_nee + torch.where(sevt[..., None], L_hit, 0.0) \
            + torch.where(esc[..., None], L_env, 0.0)

        m3, s3 = mevt[..., None], sevt[..., None]
        new_d = torch.where(m3, wo_med, torch.where(s3, wo_surf, d))
        new_o = torch.where(m3, ms.p, torch.where(
            s3, _offset_ray(hit.p, hit.ng, wo_surf), o))
        new_thr = torch.where(m3, thr_med,
                              torch.where(s3, thr_surf * bs.weight, thr))
        # medium transition on transmission through the surface
        crossed = sevt & (dot(wo_surf, hit.ng) * dot(-d, hit.ng) < 0.0)
        new_med = torch.where(crossed, medium_transition(
            scene, hit.prim, hit.ng, wo_surf), cur_med)

        # null crossings are passthrough: they leave the MIS state alone
        scat = sevt & ~is_null
        new_spec = torch.where(mevt, False,
                               torch.where(scat, bs.is_delta, spec))
        new_pdf = torch.where(mevt, pdf_med,
                              torch.where(scat, bs.pdf, last_pdf))
        scatter_p = torch.where(m3, ms.p, torch.where(
            scat[..., None], hit.p, scatter_p))

        # depth bookkeeping: null passthrough does not advance depth
        depth = depth + (mevt | scat).to(torch.int64)
        dead = (~hit.valid & ~ms.success) | (depth >= cfg.max_depth) \
            | (new_thr.amax(-1) <= 0.0) | (~bs.valid & sevt)
        # Russian roulette
        q = torch.clamp(new_thr.amax(-1), max=cfg.rr_clamp)
        do_rr = (depth >= cfg.rr_depth) & active
        rr_kill = do_rr & (u_rr >= q)
        new_thr = torch.where((do_rr & ~rr_kill)[..., None],
                              new_thr / torch.clamp(q, min=1e-6)[..., None],
                              new_thr)
        active = active & ~dead & ~rr_kill
        o, d, cur_med, thr = new_o, new_d, new_med, new_thr
        spec, last_pdf = new_spec, new_pdf
    return L


def render(scene: Scene, cfg: VolPathConfig = VolPathConfig(), seed=0,
           max_lanes=1 << 20):
    """Render the full frame; returns [H,W,3].

    As many spp as fit into `max_lanes` wavefront lanes run per pass:
    that decides which pass key each sample draws from (the JAX
    package's streams) and bounds the memory of a pass."""
    dev = scene.device
    H, W = scene.height, scene.width
    spp_per_pass = max(1, min(cfg.spp, max_lanes // (H * W)))
    px0, py0 = pixel_grid(scene)
    img = torch.zeros((H, W, 3), dtype=torch.float32, device=dev)
    wsum = torch.zeros((H, W), dtype=torch.float32, device=dev)
    done = it = 0
    while done < cfg.spp:
        nspp = min(spp_per_pass, cfg.spp - done)
        key = rng.pass_key(seed, it, rng.STREAM_CAMERA, dev)
        k_pix = rng.split(key, 2)[0]
        pix = torch.arange(H * W, device=dev).repeat(nspp)
        si = torch.repeat_interleave(
            it * nspp + torch.arange(nspp, device=dev), H * W)
        u = qmc.pixel_samples(cfg.sampler, k_pix, pix, si, cfg.spp)
        _, k_lens, k_path = rng.split(key, 3)
        px, py = px0.repeat(nspp), py0.repeat(nspp)
        u_lens = rng.uniform(k_lens, tuple(u.shape)) \
            if scene.cam_aperture > 0 else None
        o, d, _ = generate_rays(scene, px, py, u, u_lens=u_lens)
        L = trace_radiance(scene, cfg, o, d, scene.cam_medium, k_path)
        if cfg.rfilter == "box":
            img = img + L.reshape(nspp, H, W, 3).mean(0) * nspp
            wsum = wsum + float(nspp)
        else:
            di, dw = film.splat_filtered(
                film.new_film(H, W, device=dev),
                torch.zeros((H, W), dtype=torch.float32, device=dev),
                px + u[..., 0], py + u[..., 1], L, rfilter=cfg.rfilter)
            img, wsum = img + di, wsum + dw
        done += nspp
        it += 1
    return film.develop_filtered(img, wsum)
