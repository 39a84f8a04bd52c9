"""Photon-density estimators of the SPPM primal pass (mirrors
gvpm_tpu/integrators/estimators.py).

reference call sites:
  surface          — PhotonMap::estimateRadianceGP (sppm.cpp:547)
  VPM / distance   — volumePhotonPassDistance (sppm.cpp:1003)
  BRE              — volumePhotonPassBRE (sppm.cpp:882, bre.h:32)
  photon beams 1D  — volumePhotonBeamPass (sppm.cpp:765, beams_struct.h:250)
  beams 3D, planes — beams.h:18-230, plane_struct.h:140-227

Point gathers ride the hash grid (ops/hashgrid.py). The beam and plane
estimators sweep every camera segment against every photon beam or
plane: ops/beam_sweep.py runs that pair sweep (a CUDA kernel on the
card, its plain PyTorch version on the CPU). Every estimator divides by
n_emitted light paths (a beam estimator with a beam map by the map's
paths, sppm.select_beams: an int or a device tensor); the constant
kernels are K1 = 1/(2r), K2 = 1/(pi r^2) and K3 = 3/(4 pi r^3).
"""

from __future__ import annotations

import math

import torch

from ..core import rng
from ..core.math import coordinate_system, dot, to_local
from ..ops import beam_sweep as bs
from ..ops import hashgrid
from ..render import medium as med
from ..render import phase as ph
from ..scene.types import Scene
from . import planar as pl
from .gatherpoint import GatherPoints

INV_PI = 1.0 / math.pi
# BRE march: steps of r_vol per camera segment (the JAX package's
# max_steps)
BRE_STEPS = 48


def _sum3(ar, ag, ab, w):
    return torch.stack([(ar * w).sum(1), (ag * w).sum(1),
                        (ab * w).sum(1)], dim=-1)


def surface_gather(scene: Scene, gps: GatherPoints, grid, pp, pv, n_emitted,
                   radius_scale, max_per_cell=32, stencil=8):
    """Radiance at gather points from surface photons. pp: [P,3]; pv:
    dict of flattened light-vertex fields; returns [N,3] premultiplied by
    gps.thr."""
    r_all = gps.radius * radius_scale
    s_ax_all, t_ax_all = coordinate_system(gps.ns)
    wo_loc_all = to_local(gps.ns, s_ax_all, t_ax_all, gps.wo)

    def eval_fn(qi, idx, ok, scale):
        r = r_all[qi][:, None]
        ns = gps.ns[qi]
        wo_l = wo_loc_all[qi]
        rel = pl.sub3(pl.gather3(pp, idx), pl.expand(gps.p[qi]))
        d2 = pl.dot3(rel, rel)
        is_surf = pv["vtype"][idx] == pl.VERT_SURFACE
        nwi = pl.neg3(pl.gather3(pv["wi"], idx))
        front = pl.dot3(pl.expand(ns), nwi) > 1e-4
        inside = ok & is_surf & (d2 < r * r) & front \
            & gps.valid[qi][:, None]
        wi_l = pl.to_local_planar(ns, s_ax_all[qi], t_ax_all[qi], nwi)
        # the gather point's wo goes first, the photon's -wi second
        fr, fg, fb = pl.eval_bsdf_gather(
            scene, gps.bsdf[qi][:, None],
            (wo_l[:, 0:1], wo_l[:, 1:2], wo_l[:, 2:3]), wi_l)
        k2 = torch.full_like(r, INV_PI) / torch.clamp(r * r, min=1e-12)
        w = torch.where(inside, k2 * scale, 0.0)
        a = pv["alpha"][idx]
        return _sum3(a[..., 0] * fr, a[..., 1] * fg, a[..., 2] * fb, w)

    acc = hashgrid.gather_dense(grid, gps.p, eval_fn,
                                max_per_cell=max_per_cell, stencil=stencil)
    return gps.thr * acc / n_emitted


def volume_distance_gather(scene: Scene, beams_cam, grid, pp, pv,
                           n_emitted, r_vol, key, n_samples=2,
                           max_per_cell=32, stencil=8):
    """VPM: for each camera segment, sample forced-interaction distances
    and gather medium photons with the 3D kernel at each point. r_vol: a
    float32 scalar tensor. Returns (contribution [M,3], beams_cam's
    "pixel" lane ids)."""
    o, d = beams_cam["o"], beams_cam["d"]
    length, mi, valid = beams_cam["length"], beams_cam["med"], \
        beams_cam["valid"]
    m = o.shape[0]
    k3 = r_vol.new_full((), 3.0) / (4.0 * math.pi * torch.clamp(
        r_vol * r_vol * r_vol, min=1e-18))
    r2 = r_vol * r_vol

    contrib = torch.zeros((m, 3), dtype=torch.float32, device=o.device)
    for k in rng.split(key, n_samples):
        u = rng.uniform(k, (m,))
        ms = med.sample_distance(scene, mi, o, d, length, u,
                                 strategy=med.ALWAYS_VALID)
        x = ms.p
        sok = valid & ms.success

        def eval_fn(qi, idx, ok, scale):
            rel = pl.sub3(pl.gather3(pp, idx), pl.expand(x[qi]))
            d2 = pl.dot3(rel, rel)
            is_med = pv["vtype"][idx] == pl.VERT_MEDIUM
            inside = ok & is_med & (d2 < r2) & sok[qi][:, None]
            # cos between photon propagation and the way to the camera
            cos_t = -pl.dot3(pl.gather3(pv["wi"], idx), pl.expand(d[qi]))
            pf = pl.eval_phase_planar(scene, mi[qi][:, None], cos_t)
            w = torch.where(inside, pf * k3 * scale, 0.0)
            a = pv["alpha"][idx]
            return _sum3(a[..., 0], a[..., 1], a[..., 2], w)

        Li = hashgrid.gather_dense(grid, x, eval_fn,
                                   max_per_cell=max_per_cell,
                                   stencil=stencil)
        w = ms.transmittance * ms.sigma_s / torch.clamp(
            ms.pdf_success, min=1e-20)[..., None]
        contrib = contrib + torch.where(sok[..., None],
                                        beams_cam["thr"] * w * Li, 0.0)
    return contrib / (n_samples * n_emitted), beams_cam["pixel"]


# --------------------------------------------------------------------------
# beam radiance estimate (camera segment x photon points, 2D kernel)
# --------------------------------------------------------------------------

def _cbrt(x):
    """Cube root of x >= 0 (torch has none): pow in float64, rounded once
    to float32, within an ulp of the JAX package's jnp.cbrt."""
    return torch.pow(x.to(torch.float64), 1.0 / 3.0).to(torch.float32)


def knn_radii(grid, pp, valid, r0, k, max_per_cell=32):
    """Per-photon BRE radii from the local photon density (bre.cpp:29-93
    sizes each disc by its k-th neighbour): one fixed-radius count per
    photon over the hash grid's fold (ops/hashgrid.gather), inverted
    through r_k = r0 (k / count)^(1/3), clamped to [0.25, 2] r0. The grid
    must be built with cell_size >= r0. valid [P]: the photons whose
    count matters (the others count nothing and get 2 r0 for k >= 8)."""
    r02 = r0 * r0

    def fold(carry, idx, ok, scale):
        rel = pp[idx] - pp
        d2 = dot(rel, rel)
        inside = ok & (d2 < r02) & valid
        return carry + torch.where(inside, scale, 0.0)

    cnt = hashgrid.gather(grid, pp, fold,
                          torch.zeros(pp.shape[0], dtype=torch.float32,
                                      device=pp.device),
                          max_per_cell=max_per_cell)
    ratio = _cbrt(pl.rdiv(float(k), torch.clamp(cnt, min=1.0)))
    return r0 * torch.clamp(ratio, 0.25, 2.0)


def bre_gather(scene: Scene, beams_cam, grid, pp, pv, n_emitted, r_vol,
               max_per_cell=16, pr=None):
    """BRE: deterministic integral of photon discs along camera segments.

    The grid is built with cell_size = 2 r_vol; each segment is marched
    in BRE_STEPS steps of r_vol, and a medium photon contributes at the
    step whose t-interval holds its foot point on the segment, so it is
    visited once (27-stencil with exact cell fingerprints: the step test
    is no ball). pr: optional per-photon radii [P] (knn_radii), each
    <= 2 r_vol; None = the global r_vol. Returns (contribution [M,3],
    beams_cam's "pixel" lane ids)."""
    o, d = beams_cam["o"], beams_cam["d"]
    length, mi, valid = beams_cam["length"], beams_cam["med"], \
        beams_cam["valid"]
    _, sigma_s, st = med._tables(scene, mi)
    step = r_vol
    k2 = pl.rdiv(INV_PI, torch.clamp(r_vol * r_vol, min=1e-12))
    acc = torch.zeros((o.shape[0], 3), dtype=torch.float32, device=o.device)
    for kstep in range(BRE_STEPS):
        t_mid = step * (kstep + 0.5)
        x = o + d * t_mid
        live = valid & (t_mid - 0.5 * step < length)
        t_lo, t_hi = step * float(kstep), step * float(kstep + 1)

        def eval_fn(qi, idx, ok, scale):
            dq = d[qi][:, None, :]
            rel = pp[idx] - o[qi][:, None, :]
            t_proj = dot(rel, dq)
            in_step = (t_proj >= t_lo) & (t_proj < t_hi) & (t_proj >= 0.0) \
                & (t_proj <= length[qi][:, None])
            perp = rel - dq * t_proj[..., None]
            d2 = dot(perp, perp)
            is_med = pv["vtype"][idx] == pl.VERT_MEDIUM
            if pr is None:
                r2_ph, k2_ph = r_vol * r_vol, k2
            else:
                r_ph = pr[idx]
                r2_ph = r_ph * r_ph
                k2_ph = pl.rdiv(INV_PI, torch.clamp(r2_ph, min=1e-12))
            inside = ok & is_med & in_step & (d2 < r2_ph) \
                & live[qi][:, None]
            pf = ph.eval_phase(scene, mi[qi][:, None].expand(idx.shape),
                               -pv["wi"][idx], -dq.expand(rel.shape))
            tr = torch.exp(-st[qi][:, None, :] * t_proj[..., None])
            contrib = pv["alpha"][idx] * sigma_s[qi][:, None, :] * tr \
                * (pf * k2_ph * scale)[..., None]
            return torch.where(inside[..., None], contrib, 0.0).sum(1)

        acc = acc + hashgrid.gather_dense(grid, x, eval_fn,
                                          max_per_cell=max_per_cell,
                                          stencil=27, exact_cells=True)
    return beams_cam["thr"] * acc / n_emitted, beams_cam["pixel"]


# --------------------------------------------------------------------------
# photon beams and planes: the pair sweeps of ops/beam_sweep.py
# --------------------------------------------------------------------------

def survival_prob(scene: Scene, mi, t):
    """P(a free-flight sample exceeds t) in medium mi (ops/beam_sweep's
    `survival`, which the sweeps evaluate per pair)."""
    _, _, st = med._tables(scene, mi)
    return bs.survival(st.unbind(-1), med.sampling_weight(scene, mi), t)


def _camera_queries(scene: Scene, mi, o, d, length, valid):
    """The per-segment fields of a beam sweep (ops/beam_sweep.QSLOT)."""
    _, sigma_s, st = med._tables(scene, mi)
    idx = torch.clamp(mi, 0, scene.med_g.shape[0] - 1)
    return bs.pack_queries(o=o, d=d, length=length, med=mi, valid=valid,
                           st=st, ss=sigma_s,
                           w=med.sampling_weight(scene, mi),
                           g=scene.med_g[idx], pt=scene.med_phase[idx])


def beam_beam_gather(scene: Scene, beams_cam, lb, n_emitted, r_beam,
                     stats=None):
    """1D beam x beam estimator (rayIntersectInternal1D,
    beams_struct.h:250; BeamRadianceQuery beams.h:18-230): for each
    (camera segment, photon beam) closest approach within r_beam and
    inside both segments, alpha_b Tr_b(tb) Tr_c(tc) sigma_s p K1 /
    (sin theta surv(tb)), K1 = 1/(2 r). lb: the beam dict of
    shoot_photons; r_beam: float32 scalar tensor. `stats`, when given,
    receives the accepted pairs of each segment (int32 [M], "pairs").
    Returns (contribution [M,3], beams_cam's "pixel")."""
    q = _camera_queries(scene, beams_cam["med"], beams_cam["o"],
                        beams_cam["d"], beams_cam["length"],
                        beams_cam["valid"])
    rows, _ = bs.pack_beams(lb["o"], lb["d"], lb["length"], lb["med"],
                            lb["alpha"], lb["valid"])
    # the float32 scalars, read back once a call (not once a launch)
    r2, k1 = torch.stack([r_beam * r_beam,
                          pl.rdiv(1.0, 2.0 * r_beam)]).tolist()
    acc, cnt = bs.sweep("beam1d", q, rows, bs.Params(r2=r2, k=k1))
    if stats is not None:
        stats["pairs"] = cnt
    return beams_cam["thr"] * acc / n_emitted, beams_cam["pixel"]


def beam_point_gather(scene: Scene, beams_cam, lb, n_emitted, r_beam, key,
                      n_samples=2, tile=256, stats=None):
    """3D beam x point estimator (BeamRadianceQuery 3D variants,
    beams.h:18-230): sample camera distances, then integrate the 3D
    kernel along each beam's chord through the kernel sphere with one
    sample per (point, beam):

      L_i(x,w) = sum_b flux_b chord K3(|x-y(s)|) Tr_b(s) p(w_b->w) / surv(s)

    The chord sample of query m and beam j is the JAX package's: word
    m * tile + j % tile of fold_in(k_s, j // tile) (ops/beam_sweep), so
    `tile` is part of the random layout. `stats` as in
    beam_beam_gather, summed over the samples."""
    oc, dc = beams_cam["o"], beams_cam["d"]
    mi, cvalid = beams_cam["med"], beams_cam["valid"]
    m = oc.shape[0]
    r2, k3 = torch.stack([r_beam * r_beam, pl.rdiv(
        3.0, 4.0 * math.pi * torch.clamp(r_beam * r_beam * r_beam,
                                         min=1e-18))]).tolist()
    rows, orig = bs.pack_beams(lb["o"], lb["d"], lb["length"], lb["med"],
                               lb["alpha"], lb["valid"])
    n_tiles = -(-lb["o"].shape[0] // tile)
    acc = torch.zeros((m, 3), dtype=torch.float32, device=oc.device)
    pairs = torch.zeros((m,), dtype=torch.int32, device=oc.device)
    for k in rng.split(key, n_samples):
        k_t, k_s = rng.split(k)
        u = rng.uniform(k_t, (m,))
        ms = med.sample_distance(scene, mi, oc, dc, beams_cam["length"], u,
                                 strategy=med.ALWAYS_VALID)
        sok = cvalid & ms.success
        w_cam = beams_cam["thr"] * ms.transmittance * ms.sigma_s \
            / torch.clamp(ms.pdf_success, min=1e-20)[..., None]
        q = _camera_queries(scene, mi, ms.p, dc, beams_cam["length"], sok)
        keys = bs.beam_keys(rng.fold_in(k_s, torch.arange(
            n_tiles, device=oc.device)), orig, tile)
        Li, cnt = bs.sweep("beam3d", q, rows,
                           bs.Params(r2=r2, k=k3, keys=keys, tile=tile))
        acc = acc + torch.where(sok[..., None], w_cam * Li, 0.0)
        pairs = pairs + cnt
    if stats is not None:
        stats["pairs"] = pairs
    return acc / (n_samples * n_emitted), beams_cam["pixel"]


def make_planes(scene: Scene, lb, key):
    """Photon beams -> photon planes (PhotonPlane::transformBeam,
    plane_struct.h:73-93): extend each beam by a phase-sampled direction
    w1 with an exponentially sampled length (no visibility). Draws one
    row a beam slot it is given: every slot of the light pass's beam
    array, as the JAX package does, or the kept beams of the beam map
    (sppm.select_beams), whose k-th beam takes the k-th draw. Returns the
    plane dict (o, w0, l0, w1, l1, alpha, med, valid, surv1_sigma, and
    the generating beam's shift caches)."""
    nb = lb["o"].shape[0]
    k_dir, k_len = rng.split(key)
    mi = lb["med"]
    w1, _ = ph.sample_phase(scene, mi, -lb["d"], rng.uniform(k_dir, (nb, 2)))
    _, _, st = med._tables(scene, mi)
    sigma_g = torch.clamp(st[..., 1], min=1e-20)
    u = rng.uniform(k_len, (nb,))
    l1 = -torch.log(torch.clamp(1.0 - u, min=1e-20)) / sigma_g
    # degenerate when w1 ~ parallel to the beam (transformBeam's loop)
    ok = lb["valid"] & (torch.abs(dot(w1, lb["d"])) < 1.0 - 1e-6) \
        & (l1 > 1e-6) & torch.isfinite(l1)
    out = dict(o=lb["o"], w0=lb["d"], l0=lb["length"], w1=w1, l1=l1,
               alpha=lb["alpha"], med=mi, valid=ok,
               # survival of the plane-extension sampler: w=1, green
               surv1_sigma=sigma_g)
    for k in ("parent_p", "parent_type", "parent_wi", "parent_ns",
              "parent_bsdf", "parent_med", "scatter_base", "pdf_dir_base",
              "reconnectable", "parent_idx", "at_origin"):
        if k in lb:
            out[k] = lb[k]
    return out


def plane_gather(scene: Scene, beams_cam, planes, n_emitted, stats=None):
    """0D photon-plane estimator (PhotonPlaneQuery, plane_struct.h:227;
    getContrib0D plane_struct.h:140-192): camera ray x parallelogram by
    Moller-Trumbore (intersectPlane0D, plane_struct.h:104),

      Tr_cam(t) sigma_s^2 flux p(w1 -> -d) Tr_w0(t0)/P(len0 > t0)
        Tr_w1(t1)/P(len1 > t1) / |w0 . (w1 x d)|.

    `stats` as in beam_beam_gather."""
    q = _camera_queries(scene, beams_cam["med"], beams_cam["o"],
                        beams_cam["d"], beams_cam["length"],
                        beams_cam["valid"])
    rows, _ = bs.pack_beams(planes["o"], planes["w0"], planes["l0"],
                            planes["med"], planes["alpha"], planes["valid"],
                            w1=planes["w1"], l1=planes["l1"],
                            sig=planes["surv1_sigma"])
    acc, cnt = bs.sweep("plane0d", q, rows, bs.Params())
    if stats is not None:
        stats["pairs"] = cnt
    return beams_cam["thr"] * acc / n_emitted, beams_cam["pixel"]
