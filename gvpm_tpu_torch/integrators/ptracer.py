"""Batched light-path tracing (mirrors gvpm_tpu/integrators/ptracer.py).

P paths advance in lockstep through a Python loop over steps; every
step emits one vertex record per lane (possibly invalid), so the
result is a dense [S, P] vertex tensor that doubles as path storage
for the gradient shifts. `alpha` stored at a vertex is the power
arriving there; the local sigma_s / BSDF is applied at gather time.
Every step also records the medium segment it traversed (a photon
beam, `LightBeams`) with the shift caches of the vertex it leaves.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import rng
from ..core.config import PhotonConfig
from ..core.math import coordinate_system, dot, to_local, to_world
from ..core.struct import TensorStruct
from ..render import medium as med
from ..render import phase as ph
from ..render.bsdf import is_diffuse_like, sample_bsdf
from ..render.emitter import sample_photon
from ..render.visibility import medium_transition
from ..scene.intersect import intersect
from ..scene.types import BSDF_NULL, Scene

RAY_EPS = 1e-4

VERT_NONE = 0
VERT_SURFACE = 1
VERT_MEDIUM = 2


@dataclasses.dataclass
class LightVertices(TensorStruct):
    """Per-step vertex records, shape [S, P, ...]; the parent_* / *_base
    fields are the gradient-shift caches (see the JAX package)."""
    vtype: torch.Tensor
    p: torch.Tensor
    wi: torch.Tensor
    alpha: torch.Tensor
    med: torch.Tensor
    seg_med: torch.Tensor
    bsdf: torch.Tensor
    ns: torch.Tensor
    prim: torch.Tensor
    path: torch.Tensor
    depth: torch.Tensor
    parent_p: torch.Tensor
    parent_type: torch.Tensor
    parent_wi: torch.Tensor
    parent_ns: torch.Tensor
    parent_bsdf: torch.Tensor
    parent_med: torch.Tensor
    scatter_base: torch.Tensor
    seg_tr: torch.Tensor
    pdf_dir_base: torch.Tensor
    pdf_dist_base: torch.Tensor
    reconnectable: torch.Tensor
    parent_idx: torch.Tensor


@dataclasses.dataclass
class LightBeams(TensorStruct):
    """Medium-traversing segments of light paths (photon beams), [S, P]:
    one record per step (LTBeamMap::tryAppendLT, gvpm_beams.h:54-84).
    alpha is the power at the segment start; the shift caches are those
    of the vertex that emits the segment (shift_volume_beams.h:408-457).
    `reconnectable` also requires that the segment leaves that vertex
    itself (false after a null-boundary crossing); `parent_idx` is the
    flat index of the vertex's own record (-1: the emitter)."""
    valid: torch.Tensor
    o: torch.Tensor
    d: torch.Tensor
    length: torch.Tensor
    alpha: torch.Tensor
    med: torch.Tensor
    path: torch.Tensor
    depth: torch.Tensor
    parent_p: torch.Tensor
    parent_type: torch.Tensor
    parent_wi: torch.Tensor
    parent_ns: torch.Tensor
    parent_bsdf: torch.Tensor
    parent_med: torch.Tensor
    scatter_base: torch.Tensor
    pdf_dir_base: torch.Tensor
    reconnectable: torch.Tensor
    parent_idx: torch.Tensor
    at_origin: torch.Tensor


def shoot(scene: Scene, cfg: PhotonConfig, n_paths: int, key,
          with_beams=True, path_offset=None):
    """Trace n_paths light paths; returns (LightVertices, LightBeams),
    both [S, P], or (LightVertices, None) when with_beams is false: a
    pass that reads no beam skips recording them. Estimators divide by
    n_paths (per-emitted-path scaling).

    path_offset (optional int): every random becomes a function of (key,
    path_offset + lane) instead of the lane's position, so shards that
    pass the same key and their global path offsets shoot, together, the
    photons of one shoot of every path at offset 0 (rng.lane_uniform).
    `path` and `parent_idx` stay shard-local either way. None keeps the
    positional draws."""
    n = n_paths
    dev = scene.device
    n_steps = cfg.max_depth + cfg.null_bounces
    k_emit, k_walk = rng.split(key, 2)
    lane = torch.arange(n, device=dev)
    lanes = None if path_offset is None else path_offset + lane

    def draw(k, shape):
        if lanes is None:
            return rng.uniform(k, shape)
        return rng.lane_uniform(k, lanes, shape[1:])

    em = sample_photon(scene, k_emit, n, lanes=lanes)
    alpha0 = torch.where(em["valid"][..., None], em["alpha"], 0.0)
    st = dict(
        o=em["p"], d=em["d"], med=em["med"], alpha=alpha0,
        active=em["valid"], depth=torch.zeros_like(lane),
        pp_p=em["p"], pp_type=torch.zeros_like(lane), pp_wi=em["ns"],
        pp_ns=em["ns"], pp_bsdf=torch.full_like(lane, -1),
        pp_med=em["med"], pp_scatter=em["scatter"],
        pp_pdf_dir=em["pdf_dir"], pp_reconn=em["reconnectable"],
        pp_idx=torch.full_like(lane, -1),
        pp_at_origin=torch.ones(n, dtype=torch.bool, device=dev),
        seg_tr=torch.ones((n, 3), dtype=torch.float32, device=dev),
        seg_pdffail=torch.ones((n,), dtype=torch.float32, device=dev))
    step_keys = rng.split(k_walk, n_steps)
    verts, beams = [], []
    for step_i in range(n_steps):
        k_med, k_scat, k_rr = rng.split(step_keys[step_i], 3)
        o, d, cur_med = st["o"], st["d"], st["med"]
        alpha, active = st["alpha"], st["active"]

        hit = intersect(scene, o, d)
        t_far = torch.where(hit.valid, hit.t, torch.inf)
        u_med = draw(k_med, (n, 2))
        ms = med.sample_distance(scene, cur_med, o, d, t_far, u_med[:, 0],
                                 u_channel=u_med[:, 1])
        mevt = active & ms.success
        sevt = active & ~ms.success & hit.valid

        # beam record: the medium segment traversed this step
        if with_beams:
            seg_len = torch.where(ms.success, ms.t, t_far)
            finite = torch.isfinite(seg_len)
            beams.append(dict(
                valid=active & (cur_med >= 0) & finite & (seg_len > 1e-6),
                o=o, d=d, length=torch.where(finite, seg_len, 0.0),
                alpha=alpha, med=cur_med, path=lane, depth=st["depth"],
                parent_p=st["pp_p"], parent_type=st["pp_type"],
                parent_wi=st["pp_wi"], parent_ns=st["pp_ns"],
                parent_bsdf=st["pp_bsdf"], parent_med=st["pp_med"],
                scatter_base=st["pp_scatter"], pdf_dir_base=st["pp_pdf_dir"],
                reconnectable=st["pp_reconn"] & st["pp_at_origin"],
                parent_idx=st["pp_idx"], at_origin=st["pp_at_origin"]))

        alpha_in_med = alpha * ms.transmittance / torch.clamp(
            ms.pdf_success, min=1e-20)[..., None]
        alpha_in_surf = alpha * ms.transmittance / torch.clamp(
            ms.pdf_failure, min=1e-20)[..., None]
        bi = torch.clamp(scene.prim_bsdf(hit.prim), 0,
                         scene.bsdf_type.shape[0] - 1)
        is_null = scene.bsdf_type[bi] == BSDF_NULL
        store_surf = sevt & ~is_null
        vtype = torch.where(mevt, VERT_MEDIUM,
                            torch.where(store_surf, VERT_SURFACE, VERT_NONE))
        seg_tr_full = st["seg_tr"] * ms.transmittance
        vert = dict(
            vtype=vtype,
            p=torch.where(mevt[..., None], ms.p, hit.p),
            wi=d,
            alpha=torch.where(mevt[..., None], alpha_in_med, alpha_in_surf),
            med=torch.where(mevt, cur_med, -1),
            seg_med=cur_med,
            bsdf=torch.where(store_surf, bi, -1),
            ns=hit.ns,
            prim=torch.where(store_surf, hit.prim, -1),
            path=lane,
            depth=st["depth"] + 1,
            parent_p=st["pp_p"], parent_type=st["pp_type"],
            parent_wi=st["pp_wi"], parent_ns=st["pp_ns"],
            parent_bsdf=st["pp_bsdf"], parent_med=st["pp_med"],
            scatter_base=st["pp_scatter"], seg_tr=seg_tr_full,
            pdf_dir_base=st["pp_pdf_dir"],
            pdf_dist_base=st["seg_pdffail"] * torch.where(
                mevt, ms.pdf_success, ms.pdf_failure),
            reconnectable=st["pp_reconn"],
            parent_idx=st["pp_idx"])
        verts.append(vert)

        # --- continue the walk: phase in media, BSDF (importance) on
        # surfaces ---
        u2 = draw(k_scat, (n, 2))
        wo_med, pdf_phase = ph.sample_phase(scene, cur_med, -d, u2)
        alpha_med_out = alpha_in_med * ms.sigma_s

        ns = hit.ns
        s_ax, t_ax = coordinate_system(ns)
        wi_loc = to_local(ns, s_ax, t_ax, -d)
        u3 = draw(k_scat, (n, 3))
        bs = sample_bsdf(scene, bi, wi_loc, u3, transport="importance")
        wo_surf = to_world(ns, s_ax, t_ax, bs.wo)
        alpha_surf_out = alpha_in_surf * bs.weight

        m3, s3 = mevt[..., None], sevt[..., None]
        new_d = torch.where(m3, wo_med, torch.where(s3, wo_surf, d))
        new_o = torch.where(m3, ms.p, torch.where(
            s3, hit.p + hit.ng * torch.sign(
                dot(hit.ng, wo_surf, keepdims=True)) * RAY_EPS, o))
        new_alpha = torch.where(m3, alpha_med_out,
                                torch.where(s3, alpha_surf_out, alpha))
        crossed = sevt & (dot(wo_surf, hit.ng) * dot(-d, hit.ng) < 0.0)
        new_med = torch.where(mevt, cur_med, torch.where(
            crossed, medium_transition(scene, hit.prim, hit.ng, wo_surf),
            cur_med))
        advances = mevt | store_surf
        new_depth = st["depth"] + advances.to(torch.int64)

        dead = (~hit.valid & ~ms.success) | (new_depth >= cfg.max_depth) \
            | (new_alpha.amax(-1) <= 0.0) | (sevt & ~bs.valid)
        q = torch.clamp(new_alpha.amax(-1) / torch.clamp(
            alpha.amax(-1), min=1e-20), max=cfg.rr_clamp)
        do_rr = (new_depth >= cfg.rr_depth_photon) & active & advances
        u_rr = draw(k_rr, (n,))
        rr_kill = do_rr & (u_rr >= q)
        new_alpha = torch.where(
            (do_rr & ~rr_kill)[..., None],
            new_alpha / torch.clamp(q, min=1e-6)[..., None], new_alpha)
        new_active = active & ~dead & ~rr_kill

        # --- parent-cache carries for the NEXT segment ---
        stored = mevt | store_surf
        scatter_med_new = ms.sigma_s * pdf_phase[..., None]
        scatter_surf_new = bs.weight * bs.pdf[..., None]
        reconn_surf = is_diffuse_like(scene, bi, cfg.bounce_roughness) \
            & ~bs.is_delta

        def upd(old, new):
            m = stored[..., None] if new.dim() > stored.dim() else stored
            return torch.where(m, new, old)

        null_cross = sevt & is_null
        st = dict(
            o=new_o, d=new_d, med=new_med, alpha=new_alpha,
            active=new_active, depth=new_depth,
            pp_p=upd(st["pp_p"], vert["p"]),
            pp_type=upd(st["pp_type"], vtype),
            pp_wi=upd(st["pp_wi"], d),
            pp_ns=upd(st["pp_ns"], hit.ns),
            pp_bsdf=upd(st["pp_bsdf"], vert["bsdf"]),
            pp_med=upd(st["pp_med"], torch.where(mevt, cur_med, -1)),
            pp_scatter=upd(st["pp_scatter"], torch.where(
                m3, scatter_med_new, scatter_surf_new)),
            pp_pdf_dir=upd(st["pp_pdf_dir"],
                           torch.where(mevt, pdf_phase, bs.pdf)),
            pp_reconn=upd(st["pp_reconn"],
                          torch.where(mevt, True, reconn_surf)),
            pp_idx=upd(st["pp_idx"], step_i * n + lane),
            pp_at_origin=torch.where(stored, True, torch.where(
                null_cross, False, st["pp_at_origin"])),
            seg_tr=torch.where(stored[..., None], 1.0, torch.where(
                null_cross[..., None], seg_tr_full, st["seg_tr"])),
            seg_pdffail=torch.where(stored, 1.0, torch.where(
                null_cross, st["seg_pdffail"] * ms.pdf_failure,
                st["seg_pdffail"])))
    def stack(records, cls):
        return cls(**{f: torch.stack([r[f] for r in records])
                      for f in records[0]})
    return (stack(verts, LightVertices),
            stack(beams, LightBeams) if with_beams else None)


def flatten_vertices(lv: LightVertices):
    """[S,P,...] -> [S*P,...] with a validity mask."""
    flat = lv.map(lambda a: a.reshape((-1,) + a.shape[2:]))
    return flat, flat.vtype != VERT_NONE
