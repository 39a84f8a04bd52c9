"""G-BDPT: gradient-domain bidirectional path tracing with media (mirrors
gvpm_tpu/integrators/gbdpt.py; reference: src/integrators/gbdpt/,
GBDPTRenderer gbdpt_proc.cpp:48: a base BDPT path per pixel and 4 offset
paths made by shifting the camera subpath, the 4-neighbour set
gbdpt_proc.cpp:103,276, per-strategy Jacobians, screened-Poisson
reconstruction in gbdpt.cpp).

The light subpath is shared between base and offsets (the same key).
The offset camera subpath is the base's shifted by reconnection at the
first vertex: the offset pixel ray finds its own first vertex v1', then
reconnects straight to the base's second vertex v2; from v2 on the
vertices are shared, so the strategies split into

  t=1  — connections re-run at v1' (bdpt._connect over the shared light
         subpath; the s=0 'very direct' light is left out of the
         gradients, like gpt's -direct buffer)
  t=2  — connections re-run at v2 with the offset incoming direction and
         the camera throughput scaled by the reconnection ratio
         R = [f1' G' Tr'] / [f1 G Tr] (area-measure Jacobian 1: v2 is
         shared)
  t>=3 — base contributions x R x f2(wi'->wo2)/f2(wi->wo2) (wo2 from the
         stored v3)

The pair carries the balance weight 1/(1 + pr), pr = pdfA(v1'->v2) /
pdfA(v1->v2). Lanes whose first-vertex pair is not diffuse-classified
(specular or delta v1 or v1', or no v2) fall back to the PSS identity
replay with weight 1/2.

The base and the 4 offset camera subpaths run as one 5n-lane wavefront
(bdpt.radiance_parts with rand_tile=5: every draw repeats every n lanes,
so each group of n lanes traces what one call at its pixel grid traces),
and the 4 offsets' connection sweeps at v1' and at v2 as one batch.
"""

from __future__ import annotations

import torch

from ..core import rng
from ..core.config import VolPathConfig
from ..core.math import dot
from ..ops import poisson
from ..render.bsdf import is_diffuse_like
from ..render.visibility import segment_transmittance
from ..scene.camera import pixel_grid
from ..scene.types import Scene
from . import bdpt
from .bdpt import VT_MED, VT_NONE, VT_SURF, _scatter_eval
from .gpt import DOWN, LEFT, OFFSETS, RIGHT, UP
from .gvpm import reject_heterogeneous


def _edge_terms(scene, v_from, v2):
    """Area-measure edge factors v_from -> v2: (value [n,3] = f*|cos| at
    v_from x G x Tr, pdfA [n], ok [n], direction [n,3])."""
    seg = v2["p"] - v_from["p"]
    d2 = torch.clamp(dot(seg, seg), min=1e-12)
    dist = torch.sqrt(d2)
    w = seg / dist[..., None]
    fval, fpdf, _ = _scatter_eval(
        scene, v_from["vtype"], v_from["bsdf"], v_from["med"], v_from["ns"],
        v_from["wi"], w, "radiance")
    cos2 = torch.where(v2["vtype"] == VT_MED, 1.0,
                       torch.abs(dot(v2["ns"], w)))
    G = cos2 / d2
    tr = segment_transmittance(
        scene, v_from["p"] + torch.where(
            (v_from["vtype"] == VT_SURF)[..., None],
            v_from["ns"] * torch.sign(dot(v_from["ns"], w, keepdims=True))
            * 1e-4, 0.0),
        v2["p"],
        torch.where(v_from["vtype"] == VT_MED, v_from["med"],
                    v2["seg_med"]))
    val = fval * G[..., None] * tr
    pdfA = fpdf * G
    ok = (val.amax(-1) >= 0) & (cos2 > 1e-6)
    return val, pdfA, ok, w


def _connect_sweep(scene, cfg, cv, parts, n_steps, depth_at):
    """Every connection strategy with the camera vertex pinned to cv
    (camera depth depth_at [N]): the s=1 endpoint parts["le_emitter"]
    and the light-subpath vertices parts["lt"], with the per-lane depth
    gating of bdpt.radiance_parts, in one batch. Returns [N,3]."""
    lt = parts["lt"]
    steps = list(range(n_steps))
    conn_ok = depth_at + lt["depth"] <= cfg.max_depth
    vt_em = torch.where(depth_at + 1 <= cfg.max_depth + 1, cv["vtype"],
                        VT_NONE)
    L = torch.zeros_like(cv["alpha"])
    for c in bdpt.connect_batch(scene, cv, vt_em, parts["le_emitter"], lt,
                                steps, conn_ok):
        L = L + c
    return L


def _diffuse_vertex(scene, v):
    """VertexClassifier: the vertex admits reconnection (medium, or a
    surface with a non-delta BSDF of roughness above the threshold)."""
    bi = torch.clamp(v["bsdf"], 0, scene.bsdf_type.shape[0] - 1)
    return v["exists"] & ((v["vtype"] == VT_MED)
                          | ((v["vtype"] == VT_SURF)
                             & is_diffuse_like(scene, bi)))


def _lanes(rec, lo, hi=None, axis=0):
    """The lanes [lo, hi) of every tensor of a record dict (`axis` is the
    lane axis: 1 for per-step subpath records)."""
    return {f: a.narrow(axis, lo, (a.shape[axis] if hi is None else hi) - lo)
            for f, a in rec.items()}


def _tile(rec, k):
    """Each tensor of a per-lane record repeated k times along lanes."""
    return {f: a.repeat((k,) + (1,) * (a.dim() - 1)) for f, a in rec.items()}


def render_pass(scene: Scene, cfg: VolPathConfig, seed, it,
                shift="reconnect", stats=None):
    """One spp of base + 4 offsets. Returns (primal, gx, gy) [H,W,3].
    shift="pss" forces the identity-replay fallback on every lane (kept
    for the variance A/B test). A `stats` dict receives `rc_ok` [4], the
    lanes of each offset that reconnected, and `very_direct` [H,W,3],
    the light the base sees straight from the camera (in the primal, not
    in the gradients)."""
    reject_heterogeneous(scene)
    H, W = scene.height, scene.width
    n = H * W
    k = rng.pass_key(seed, it, rng.STREAM_CAMERA, scene.device)
    px, py = pixel_grid(scene)

    # base and the 4 offsets, each with the same randoms: lanes
    # [i * n, (i + 1) * n) of group i (0 the base)
    parts = bdpt.radiance_parts(
        scene, cfg, torch.cat([px] + [px + dx for dx, _ in OFFSETS]),
        torch.cat([py] + [py + dy for _, dy in OFFSETS]), k, rand_tile=5)
    base = parts["L"][:n]
    base_grad = base - parts["very_direct"][:n]
    v1, v2, v3 = (_lanes(parts[v], 0, n) for v in ("v1", "v2", "v3"))
    v1p = _lanes(parts["v1"], n)                   # [4n]: the offsets' v1'
    lt = _lanes(parts["lt"], n, axis=1)            # their light subpaths
    le_em = _lanes(parts["le_emitter"], n)

    # base reconnection edge v1 -> v2
    ev_b, pdfA_b, oke_b, _ = _edge_terms(scene, v1, v2)
    d1_ok = _diffuse_vertex(scene, v1) & v2["exists"]
    # the outgoing direction at v2 (toward v3) for the t>=3 scatter ratio
    wo2 = v3["p"] - v2["p"]
    wo2 = wo2 / torch.clamp(torch.linalg.vector_norm(wo2, dim=-1,
                                                     keepdim=True),
                            min=1e-12)
    f2_b, _, _ = _scatter_eval(scene, v2["vtype"], v2["bsdf"], v2["med"],
                               v2["ns"], v2["wi"], wo2, "radiance")

    # the 4 offsets as one batch of 4n lanes
    v2r = _tile(v2, 4)
    ev_b, pdfA_b, oke_b, d1_ok, wo2, f2_b = (
        a.repeat((4,) + (1,) * (a.dim() - 1))
        for a in (ev_b, pdfA_b, oke_b, d1_ok, wo2, f2_b))
    rc_ok = d1_ok & _diffuse_vertex(scene, v1p) & oke_b
    if shift == "pss":
        rc_ok = torch.zeros_like(rc_ok)
    # offset reconnection edge v1' -> v2 (shared target: Jacobian 1)
    ev_o, pdfA_o, oke_o, w_o = _edge_terms(scene, v1p, v2r)
    rc_ok = rc_ok & oke_o & (ev_b.amax(-1) > 0)
    R = torch.where(rc_ok[..., None], ev_o / torch.clamp(ev_b, min=1e-20),
                    0.0)
    R = torch.clamp(R, 0.0, 1e6)
    pr = torch.where(rc_ok, torch.clamp(
        pdfA_o / torch.clamp(pdfA_b, min=1e-20), 1e-4, 1e4), 1.0)

    # t=1: connections at the offset's own first vertex; t=2: at v2 with
    # the offset incoming direction; both sweeps in one batch
    cv2p = dict(v2r, wi=w_o, alpha=v2r["alpha"] * R)
    cv = {f: torch.cat([v1p[f], cv2p[f]]) for f in bdpt.CV_FIELDS}
    L_t = _connect_sweep(
        scene, cfg, cv, dict(le_emitter=_tile(le_em, 2), lt={
            f: a.repeat((1, 2) + (1,) * (a.dim() - 2))
            for f, a in lt.items()}),
        cfg.max_depth + cfg.null_bounces,
        torch.cat([v1p["depth"], v2r["depth"]]))
    L_t1p, L_t2p = L_t[:4 * n], L_t[4 * n:]
    # t>=3: base bucket x R x at-v2 scatter ratio
    f2_o, _, _ = _scatter_eval(scene, v2r["vtype"], v2r["bsdf"], v2r["med"],
                               v2r["ns"], w_o, wo2, "radiance")
    r2s = torch.where(rc_ok[..., None], f2_o / torch.clamp(f2_b, min=1e-20),
                      0.0)
    r2s = torch.clamp(r2s, 0.0, 1e6)
    s0d2, rest = (parts[b][:n].repeat(4, 1) for b in ("s0d2", "rest"))
    L_rc = L_t1p + L_t2p + s0d2 * R + rest * R * r2s
    L_off_grad = torch.where(rc_ok[..., None], L_rc,
                             parts["L"][n:] - parts["very_direct"][n:])

    xi, yi = px.to(torch.int64), py.to(torch.int64)
    border = torch.cat([xi == W - 1, xi == 0, yi == H - 1, yi == 0])
    w = torch.where(rc_ok, 1.0 / (1.0 + pr), 0.5)
    w = torch.where(border, 1.0, w)[..., None]
    S = (w * L_off_grad).reshape(4, H, W, 3)
    Wb = (w * base_grad.repeat(4, 1)).reshape(4, H, W, 3)
    if stats is not None:
        stats["rc_ok"] = rc_ok.reshape(4, n).sum(1)
        stats["very_direct"] = parts["very_direct"][:n].reshape(H, W, 3)

    gx = S[RIGHT] - Wb[RIGHT]
    gx[:, :-1] += (Wb[LEFT] - S[LEFT])[:, 1:]
    gy = S[DOWN] - Wb[DOWN]
    gy[:-1, :] += (Wb[UP] - S[UP])[1:, :]
    return base.reshape(H, W, 3), gx, gy


def render(scene: Scene, cfg: VolPathConfig = VolPathConfig(), seed=0,
           callback=None, recon_alpha=0.2, recon_l1=True, recon_iters=50):
    """Progressive G-BDPT: average primal / gradients over spp, then
    reconstruct. Returns dict(image, primal, gx, gy)."""
    acc = None
    for it in range(cfg.spp):
        out = render_pass(scene, cfg, seed, it)
        acc = list(out) if acc is None else [a + b for a, b in zip(acc, out)]
        if callback is not None:
            callback(it, acc[0] / (it + 1))
    primal, gx, gy = [a / cfg.spp for a in acc]
    recon = poisson.solve(primal, gx, gy, alpha=recon_alpha,
                          iters=recon_iters, l1=recon_l1)
    return dict(image=recon, primal=primal, gx=gx, gy=gy)
