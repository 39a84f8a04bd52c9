"""Photon-density estimators of the SPPM primal pass (mirrors
gvpm_tpu/integrators/estimators.py: the surface gather and the volume
point gather with distance sampling).

reference call sites:
  surface          — PhotonMap::estimateRadianceGP (sppm.cpp:547)
  VPM / distance   — volumePhotonPassDistance (sppm.cpp:1003)

Point gathers ride the hash grid (ops/hashgrid.py). Every estimator
divides by n_emitted light paths; the constant kernels are
K2 = 1/(pi r^2) and K3 = 3/(4 pi r^3).
"""

from __future__ import annotations

import math

import torch

from ..core import rng
from ..core.math import coordinate_system, to_local
from ..ops import hashgrid
from ..render import medium as med
from ..scene.types import Scene
from . import planar as pl
from .gatherpoint import GatherPoints

INV_PI = 1.0 / math.pi


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


def bre_gather(*args, **kwargs):
    raise NotImplementedError("beam radiance estimate (BRE): ROADMAP "
                              "queue 1 item 13")


def knn_radii(*args, **kwargs):
    raise NotImplementedError("BRE kNN radii: ROADMAP queue 1 item 13")


def beam_beam_gather(*args, **kwargs):
    raise NotImplementedError("photon beams (beam1d): ROADMAP queue 1 "
                              "item 14")


def beam_point_gather(*args, **kwargs):
    raise NotImplementedError("photon beams (beam3d): ROADMAP queue 1 "
                              "item 14")


def make_planes(*args, **kwargs):
    raise NotImplementedError("photon planes: ROADMAP queue 1 item 14")


def plane_gather(*args, **kwargs):
    raise NotImplementedError("photon planes (plane0d): ROADMAP queue 1 "
                              "item 14")
