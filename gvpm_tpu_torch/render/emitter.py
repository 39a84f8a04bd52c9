"""Emitters: flux-weighted sampling, emitted radiance, next-event
sampling and photon emission (mirrors gvpm_tpu/render/emitter.py;
reference: src/emitters/{area,point,spot,directional,constant,
envmap}.cpp and Scene::weightEmitterFlux, src/librender/scene.cpp:322).

Emitters group as (area | delta | env) with a static group-probability
table (scene.light_group_p), so every sampling routine is one
branch-free three-way select. Area lights remain the only kind the
gradient shifts reconnect to (gvpm.cpp:148-158).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..core import rng, warp
from ..core.math import coordinate_system, cross, dot, normalize, to_world
from ..core.spectrum import luminance
from ..scene.types import DE_DIRECTIONAL, DE_POINT, DE_SPOT, Scene
from .visibility import medium_transition


@dataclasses.dataclass
class EmitterSample:
    p: torch.Tensor          # [N,3] position on the light
    n: torch.Tensor          # [N,3] light normal
    radiance: torch.Tensor   # [N,3]
    pdf_area: torch.Tensor   # [N] incl. prim pick
    prim: torch.Tensor       # [N] global prim id
    valid: torch.Tensor      # [N] bool


def _pick(cdf, u):
    """(index, pmf) of the inclusive CDF's bucket holding each u."""
    k = torch.clamp(torch.searchsorted(cdf, u.contiguous(), right=True),
                    0, cdf.shape[0] - 1)
    prev = cdf[torch.clamp(k - 1, min=0)]
    return k, cdf[k] - torch.where(k > 0, prev, 0.0)


def _prim_geom(scene: Scene, prim, u2):
    """Uniform point+normal on emissive prim (tri or sphere)."""
    ti = torch.clamp(prim, 0, scene.n_tris - 1)
    b = warp.square_to_uniform_triangle(u2)
    p_tri = (scene.tri_p0[ti] + b[..., 0:1] * scene.tri_e1[ti]
             + b[..., 1:2] * scene.tri_e2[ti])
    n_tri = normalize(cross(scene.tri_e1[ti], scene.tri_e2[ti]))
    if scene.n_spheres == 0:
        return p_tri, n_tri
    is_tri = (prim < scene.n_tris)[..., None]
    si = torch.clamp(prim - scene.n_tris, 0, scene.n_spheres - 1)
    d = warp.square_to_uniform_sphere(u2)
    p_sph = scene.sph_center[si] + scene.sph_radius[si][..., None] * d
    return torch.where(is_tri, p_tri, p_sph), torch.where(is_tri, n_tri, d)


def sample_position(scene: Scene, u3) -> EmitterSample:
    """Flux-weighted position sample. u3: [N,3] (prim pick + 2D). A
    scene with no area light gives invalid zero samples."""
    n_em = scene.em_prim.shape[0]
    shape = u3.shape[:-1]
    if n_em == 0:
        z3 = torch.zeros(shape + (3,), dtype=torch.float32, device=u3.device)
        zi = torch.zeros(shape, dtype=torch.int64, device=u3.device)
        return EmitterSample(p=z3, n=z3, radiance=z3, pdf_area=z3[..., 0],
                             prim=zi, valid=zi > 0)
    k, pmf = _pick(scene.em_cdf, u3[..., 0])
    prim = scene.em_prim[k]
    p, n = _prim_geom(scene, prim, u3[..., 1:3])
    em = scene.prim_emitter(prim)
    rad = scene.em_radiance[torch.clamp(em, 0,
                                        scene.em_radiance.shape[0] - 1)]
    pdf_area = pmf / torch.clamp(scene.em_prim_area[k], min=1e-20)
    return EmitterSample(p=p, n=n, radiance=rad, pdf_area=pdf_area,
                         prim=prim, valid=pmf > 0)


def sample_direction(scene: Scene, es: EmitterSample, u2):
    """Cosine-weighted emission direction -> (d_world, pdf_sa)."""
    d_local = warp.square_to_cosine_hemisphere(u2)
    s, t = coordinate_system(es.n)
    return (to_world(es.n, s, t, d_local),
            warp.square_to_cosine_hemisphere_pdf(d_local))


def eval_radiance(scene: Scene, prim, n, wo):
    """Radiance leaving prim toward wo (front side only); [N,3]."""
    em = scene.prim_emitter(prim)
    rad = scene.em_radiance[torch.clamp(em, 0,
                                        scene.em_radiance.shape[0] - 1)]
    ok = (em >= 0) & (dot(n, wo) > 0.0)
    return torch.where(ok[..., None], rad, 0.0)


def pdf_direct_area(scene: Scene, prim):
    """Area pdf that NEE (`sample_direct`) lands on this specific prim
    point, including the area-group pick probability."""
    if scene.em_prim.shape[0] == 0:
        return torch.zeros(prim.shape, dtype=torch.float32,
                           device=prim.device)
    match = scene.em_prim[None, :] == prim[..., None]
    k = torch.argmax(match.to(torch.int8), dim=-1)
    prev = scene.em_cdf[torch.clamp(k - 1, min=0)]
    pmf = scene.em_cdf[k] - torch.where(k > 0, prev, 0.0)
    pdf = pmf / torch.clamp(scene.em_prim_area[k], min=1e-20)
    return torch.where(match.any(-1), pdf * scene.light_group_p[0], 0.0)


# --------------------------------------------------------------------------
# environment: constant or lat-long map


def world_center_radius(scene: Scene):
    c = 0.5 * (scene.world_lo + scene.world_hi)
    r = torch.linalg.vector_norm(scene.world_hi - c) + 1e-6
    return c, r


def _env_is_map(scene: Scene):
    """Static: the scene carries a real lat-long map (not a constant)."""
    return scene.env_map.shape[0] * scene.env_map.shape[1] > 1


def _env_texel(scene: Scene, d):
    """(row, col) texel of direction d (toward the environment) in the
    y-up lat-long parameterization (emitters/envmap.cpp)."""
    He, We = scene.env_map.shape[:2]
    theta = torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0))
    phi = torch.atan2(d[..., 2], d[..., 0])
    u = torch.remainder(phi * (0.5 / math.pi) + 0.5, 1.0)
    v = theta / math.pi
    yi = torch.clamp((v * He).to(torch.int64), 0, He - 1)
    xi = torch.clamp((u * We).to(torch.int64), 0, We - 1)
    return yi, xi


def env_le(scene: Scene, d):
    """Environment radiance for escaped rays in direction d [N,3]."""
    base = scene.env_radiance.expand(d.shape[:-1] + (3,))
    if not _env_is_map(scene):
        return base
    yi, xi = _env_texel(scene, d)
    return base * scene.env_map[yi, xi]


def pdf_env_sa(scene: Scene, d=None):
    """Solid-angle NEE pdf of the environment strategy, including the
    env-group pick probability. A constant env samples the uniform
    sphere; a map picks a texel by sin-weighted luminance, uniform in
    (theta, phi) inside it: pdf(d) = lum(L(d)) sin(theta_row) /
    (4 pi mean_lum sin(theta))."""
    gp = scene.light_group_p[2]
    if d is None or not _env_is_map(scene):
        return gp * warp.INV_FOURPI
    He = scene.env_map.shape[0]
    yi, xi = _env_texel(scene, d)
    lum_t = luminance(scene.env_radiance * scene.env_map[yi, xi])
    sin_row = torch.sin((yi.to(torch.float32) + 0.5) / He * math.pi)
    sin_d = torch.clamp(torch.sqrt(torch.clamp(1.0 - d[..., 1] ** 2,
                                               min=0.0)), min=1e-4)
    return gp * lum_t * sin_row / (4.0 * math.pi * sin_d * torch.clamp(
        scene.env_mean_lum, min=1e-20))


def sample_env_dir(scene: Scene, u2):
    """Sample a direction TOWARD the environment -> (d, pdf_sa); pdf_sa
    excludes the group pick probability."""
    if not _env_is_map(scene):
        d = warp.square_to_uniform_sphere(u2)
        return d, torch.full(u2.shape[:-1], warp.INV_FOURPI,
                             dtype=torch.float32, device=u2.device)
    He, We = scene.env_map.shape[:2]
    i, _ = _pick(scene.env_row_cdf, u2[..., 0])
    c_lo = torch.where(i > 0, scene.env_row_cdf[torch.clamp(i - 1, min=0)],
                       0.0)
    seg = torch.clamp(scene.env_row_cdf[i] - c_lo, min=1e-12)
    vf = torch.clamp((u2[..., 0] - c_lo) / seg, 0.0, 1.0 - 1e-6)
    rows = scene.env_cond_cdf[i]                              # [N,We]
    j = torch.clamp(torch.searchsorted(
        rows, u2[..., 1:2].contiguous(), right=True)[..., 0], 0, We - 1)
    cc_lo = torch.where(j > 0, rows.gather(
        -1, torch.clamp(j - 1, min=0)[..., None])[..., 0], 0.0)
    cseg = torch.clamp(rows.gather(-1, j[..., None])[..., 0] - cc_lo,
                       min=1e-12)
    uf = torch.clamp((u2[..., 1] - cc_lo) / cseg, 0.0, 1.0 - 1e-6)
    v = (i.to(torch.float32) + vf) / He
    u = (j.to(torch.float32) + uf) / We
    theta = v * math.pi
    phi = (u - 0.5) * (2.0 * math.pi)
    sin_t = torch.sin(theta)
    d = torch.stack([sin_t * torch.cos(phi), torch.cos(theta),
                     sin_t * torch.sin(phi)], dim=-1)
    lum_t = luminance(scene.env_radiance * scene.env_map[i, j])
    sin_row = torch.sin((i.to(torch.float32) + 0.5) / He * math.pi)
    pdf = lum_t * sin_row / (4.0 * math.pi * torch.clamp(sin_t, min=1e-4)
                             * torch.clamp(scene.env_mean_lum, min=1e-20))
    return d, pdf


# --------------------------------------------------------------------------
# unified NEE sampling (area | delta | env)


@dataclasses.dataclass
class DirectSample:
    """One next-event sample toward a light: contribution at the shading
    point = throughput * f(wl) * Tr * li_over_pdf * mis_weight, the MIS
    weight from pdf_sa (0 for the delta strategies: weight 1, no
    competing BSDF strategy)."""
    wl: torch.Tensor           # [N,3] unit direction to the light
    p_light: torch.Tensor      # [N,3] shadow-ray target
    li_over_pdf: torch.Tensor  # [N,3] radiance / pdf, all factors folded
    pdf_sa: torch.Tensor       # [N] solid-angle pdf (0: delta strategy)
    valid: torch.Tensor        # [N] bool
    n_light: torch.Tensor      # [N,3] light normal (area group; else 0)
    grp: torch.Tensor          # [N] emitter group: 0 area, 1 delta, 2 env
    falloff2: torch.Tensor     # [N] bool: li carries a 1/d^2 falloff
                               #     (point / spot yes, directional / env no)


def _spot_falloff(scene: Scene, k, d_emit):
    """Spot falloff curve (spot.cpp) for an emission direction d_emit."""
    cos_t = dot(scene.de_dir[k], d_emit)
    cc = scene.de_cos_cutoff[k]
    cf = scene.de_cos_falloff[k]
    lin = (cos_t - cc) / torch.clamp(cf - cc, min=1e-6)
    return torch.where(cos_t <= cc, 0.0, torch.where(cos_t >= cf, 1.0, lin))


def _sample_direct_delta(scene: Scene, p_from, u):
    """NEE sample of the delta-light group (point / spot / directional)
    -> (wl, p_light, li_over_pdf, valid, falloff2)."""
    k, pmf = _pick(scene.de_cdf, u)
    _, wr = world_center_radius(scene)
    is_dir = scene.de_type[k] == DE_DIRECTIONAL
    seg = scene.de_p[k] - p_from
    d2 = torch.clamp(dot(seg, seg), min=1e-12)
    dist_pt = torch.sqrt(d2)
    wl = torch.where(is_dir[..., None], -scene.de_dir[k],
                     seg / dist_pt[..., None])
    p_light = torch.where(is_dir[..., None], p_from + wl * (2.0 * wr),
                          scene.de_p[k])
    # point / spot: I * falloff / d^2; directional: irradiance E
    fall = torch.where(scene.de_type[k] == DE_SPOT,
                       _spot_falloff(scene, k, -wl), 1.0)
    li = scene.de_intensity[k] * fall[..., None]
    li = torch.where(is_dir[..., None], li, li / d2[..., None])
    pick_p = scene.light_group_p[1] * pmf
    li_over_pdf = li / torch.clamp(pick_p, min=1e-20)[..., None]
    return wl, p_light, li_over_pdf, pmf > 0, ~is_dir


def sample_direct(scene: Scene, p_from, u3) -> DirectSample:
    """NEE sample from points p_from [N,3]; u3: [N,3] uniforms. Picks the
    emitter group by power (light_group_p), then an emitter within it;
    li_over_pdf folds every pdf factor except the scatter function and
    the transmittance at the shading point."""
    gp = scene.light_group_p
    n = p_from.shape[0]
    grp = torch.where(u3[..., 0] < gp[0], 0,
                      torch.where(u3[..., 0] < gp[0] + gp[1], 1, 2))
    # re-stretch the pick uniform within its group
    u_area = torch.clamp(u3[..., 0] / torch.clamp(gp[0], min=1e-12),
                         0.0, 1.0)
    u_delta = torch.clamp((u3[..., 0] - gp[0]) / torch.clamp(gp[1],
                                                             min=1e-12),
                          0.0, 1.0)

    # --- area branch (cosine-emitting prim sample) ---
    es = sample_position(
        scene, torch.stack([u_area, u3[..., 1], u3[..., 2]], dim=-1))
    seg = es.p - p_from
    d2 = torch.clamp(dot(seg, seg), min=1e-12)
    wl_a = seg / torch.sqrt(d2)[..., None]
    cos_l = dot(es.n, -wl_a)
    pdf_a_sa = es.pdf_area * gp[0] * d2 / torch.clamp(cos_l, min=1e-6)
    ok_a = es.valid & (cos_l > 1e-6) & (es.pdf_area > 0) & (gp[0] > 0)
    li_a = es.radiance / torch.clamp(pdf_a_sa, min=1e-20)[..., None]

    # --- delta branch ---
    if scene.de_type.shape[0] > 0:
        wl_d, pl_d, li_d, ok_d, f2_d = _sample_direct_delta(scene, p_from,
                                                            u_delta)
    else:
        wl_d = pl_d = li_d = torch.zeros_like(wl_a)
        ok_d = f2_d = torch.zeros_like(ok_a)

    # --- env branch (constant: uniform sphere; map: luminance CDF) ---
    _, wr = world_center_radius(scene)
    wl_e, pdf_e = sample_env_dir(scene, u3[..., 1:3])
    dist_e = torch.full((n,), 2.0, dtype=torch.float32,
                        device=p_from.device) * wr
    pdf_e_sa = gp[2] * pdf_e
    li_e = env_le(scene, wl_e) / torch.clamp(pdf_e_sa, min=1e-20)[..., None]

    is_a = (grp == 0)[..., None]
    is_d = (grp == 1)[..., None]
    return DirectSample(
        wl=torch.where(is_a, wl_a, torch.where(is_d, wl_d, wl_e)),
        p_light=torch.where(is_a, es.p, torch.where(
            is_d, pl_d, p_from + wl_e * dist_e[..., None])),
        li_over_pdf=torch.where(is_a, li_a, torch.where(is_d, li_d, li_e)),
        pdf_sa=torch.where(grp == 0, pdf_a_sa,
                           torch.where(grp == 1, 0.0, pdf_e_sa)),
        valid=torch.where(grp == 0, ok_a,
                          torch.where(grp == 1, ok_d, gp[2] > 0)),
        n_light=torch.where(is_a, es.n, 0.0), grp=grp,
        falloff2=torch.where(grp == 1, f2_d, grp == 0))


# --------------------------------------------------------------------------
# photon emission (all emitter kinds)


def sample_photon(scene: Scene, key, n, lanes=None):
    """Sample n photon-emission rays across the emitter groups by power.

    Returns a dict: p, d, alpha (power/pdf), med, valid, plus the shift
    caches the particle tracer stores for first-bounce photons (ns,
    scatter, pdf_dir: meaningful for area lights only; reconnectable
    only for them, the reference's restriction, gvpm.cpp:148-158).
    lanes [n]: global path ids — randoms become functions of (key, lane
    id)."""
    k_pick, k_pos, k_dir, k_disk = rng.split(key, 4)
    if lanes is None:
        u3 = rng.uniform(k_pos, (n, 3))
        u2 = rng.uniform(k_dir, (n, 2))
        u_disk = rng.uniform(k_disk, (n, 2))
        u_pick = rng.uniform(k_pick, (n,))
    else:
        u3 = rng.lane_uniform(k_pos, lanes, (3,))
        u2 = rng.lane_uniform(k_dir, lanes, (2,))
        u_disk = rng.lane_uniform(k_disk, lanes, (2,))
        u_pick = rng.lane_uniform(k_pick, lanes)
    gp = scene.light_group_p
    grp = torch.where(u_pick < gp[0], 0,
                      torch.where(u_pick < gp[0] + gp[1], 1, 2))
    wc, wr = world_center_radius(scene)

    # --- area: flux-weighted prim + cosine direction ---
    es = sample_position(scene, u3)
    d_a, pdf_dir_a = sample_direction(scene, es, u2)
    cos_e = torch.clamp(dot(es.n, d_a), min=0.0)
    alpha_a = es.radiance * (cos_e / torch.clamp(
        es.pdf_area * pdf_dir_a * gp[0], min=1e-20))[..., None]
    ok_a = es.valid & (cos_e > 0)

    # --- delta: point / spot / directional ---
    if scene.de_type.shape[0] > 0:
        k, pmf = _pick(scene.de_cdf, u3[..., 0])
        det = scene.de_type[k]
        axis = scene.de_dir[k]
        # point: uniform sphere; spot: uniform cone of the cutoff angle
        d_sph = warp.square_to_uniform_sphere(u2)
        d_cone, pdf_cone = warp.square_to_uniform_cone(
            u2, scene.de_cos_cutoff[k])
        s_ax, t_ax = coordinate_system(axis)
        d_cone = to_world(axis, s_ax, t_ax, d_cone)
        fall = _spot_falloff(scene, k, d_cone)
        # directional: offset over the bounding disk, shoot along axis
        disk = warp.square_to_uniform_disk(u_disk) * wr
        p_dir = wc - axis * wr + s_ax * disk[..., 0:1] \
            + t_ax * disk[..., 1:2]
        pdf_pos_dir = 1.0 / (math.pi * wr * wr)
        d_de = torch.where((det == DE_POINT)[..., None], d_sph, torch.where(
            (det == DE_SPOT)[..., None], d_cone, axis))
        p_de = torch.where((det == DE_DIRECTIONAL)[..., None], p_dir,
                           scene.de_p[k])
        w_de = torch.where(
            det == DE_POINT, warp.FOURPI * torch.ones_like(pmf),
            torch.where(det == DE_SPOT,
                        fall / torch.clamp(pdf_cone, min=1e-20),
                        (1.0 / pdf_pos_dir) * torch.ones_like(pmf)))
        alpha_de = scene.de_intensity[k] * (
            w_de / torch.clamp(pmf * gp[1], min=1e-20))[..., None]
        med_de = scene.de_medium[k]
        ok_de = pmf > 0
    else:
        p_de = d_de = alpha_de = torch.zeros_like(d_a)
        med_de = torch.full_like(es.prim, -1)
        ok_de = torch.zeros_like(ok_a)

    # --- env: inward direction from the bounding disk (constant: uniform
    # sphere; map: luminance-CDF importance sample) ---
    d_env_out, pdf_env_dir = sample_env_dir(scene, u2)    # TO the env
    d_env = -d_env_out
    disk_e = warp.square_to_uniform_disk(u_disk) * wr
    se, te = coordinate_system(d_env)
    p_env = wc + d_env_out * wr + se * disk_e[..., 0:1] \
        + te * disk_e[..., 1:2]
    # alpha = L(d) / (pdf_dir * pdf_pos * group_p), pdf_pos = 1/(pi R^2)
    alpha_env = env_le(scene, d_env_out) * (
        math.pi * wr * wr
        / torch.clamp(pdf_env_dir * gp[2], min=1e-20))[..., None]

    is_a = (grp == 0)[..., None]
    is_d = (grp == 1)[..., None]
    med_a = medium_transition(scene, es.prim, es.n, d_a)
    return dict(
        p=torch.where(is_a, es.p + es.n * 1e-4,
                      torch.where(is_d, p_de, p_env)),
        d=torch.where(is_a, d_a, torch.where(is_d, d_de, d_env)),
        alpha=torch.where(is_a, alpha_a,
                          torch.where(is_d, alpha_de, alpha_env)),
        med=torch.where(grp == 0, med_a, torch.where(grp == 1, med_de, -1)),
        valid=torch.where(grp == 0, ok_a & (gp[0] > 0),
                          torch.where(grp == 1, ok_de, gp[2] > 0)),
        ns=torch.where(is_a, es.n, torch.where(is_d, d_de, d_env)),
        pdf_dir=torch.where(grp == 0, pdf_dir_a, 1.0),
        scatter=torch.where(is_a, cos_e[..., None], torch.ones_like(d_a)),
        reconnectable=grp == 0,
        prim=es.prim,
    )
