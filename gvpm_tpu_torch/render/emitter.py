"""Emitters: flux-weighted photon emission, emitted radiance and
next-event sampling (mirrors gvpm_tpu/render/emitter.py: sample_photon,
eval_radiance, pdf_direct_area, env_le, pdf_env_sa, sample_env_dir,
sample_direct).

Emitters group as (area | delta | env) with a static group-probability
table (scene.light_group_p). The port emits from and samples area lights
and a constant environment; delta lights and environment maps are
rejected (ROADMAP queue 1 item 16).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..core import rng, warp
from ..core.math import coordinate_system, cross, dot, normalize, to_world
from ..scene.types import Scene
from .visibility import medium_transition


@dataclasses.dataclass
class EmitterSample:
    p: torch.Tensor          # [N,3] position on the light
    n: torch.Tensor          # [N,3] light normal
    radiance: torch.Tensor   # [N,3]
    pdf_area: torch.Tensor   # [N] incl. prim pick
    prim: torch.Tensor       # [N] global prim id
    valid: torch.Tensor      # [N] bool


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
    """Flux-weighted position sample. u3: [N,3] (prim pick + 2D)."""
    n_em = scene.em_prim.shape[0]
    if n_em == 0:
        raise NotImplementedError(
            "emitterless scenes: ROADMAP queue 1 item 16")
    k = torch.searchsorted(scene.em_cdf, u3[..., 0].contiguous(),
                           right=True)
    k = torch.clamp(k, 0, n_em - 1)
    prim = scene.em_prim[k]
    prev = scene.em_cdf[torch.clamp(k - 1, min=0)]
    pmf = scene.em_cdf[k] - torch.where(k > 0, prev, 0.0)
    p, n = _prim_geom(scene, prim, u3[..., 1:3])
    em = scene.prim_emitter(prim)
    rad = scene.em_radiance[torch.clamp(em, 0,
                                        scene.em_radiance.shape[0] - 1)]
    pdf_area = pmf / torch.clamp(scene.em_prim_area[k], min=1e-20)
    return EmitterSample(p=p, n=n, radiance=rad, pdf_area=pdf_area,
                         prim=prim, valid=pmf > 0)


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
    match = scene.em_prim[None, :] == prim[..., None]
    k = torch.argmax(match.to(torch.int8), dim=-1)
    prev = scene.em_cdf[torch.clamp(k - 1, min=0)]
    pmf = scene.em_cdf[k] - torch.where(k > 0, prev, 0.0)
    pdf = pmf / torch.clamp(scene.em_prim_area[k], min=1e-20)
    return torch.where(match.any(-1), pdf * scene.light_group_p[0], 0.0)


def world_center_radius(scene: Scene):
    c = 0.5 * (scene.world_lo + scene.world_hi)
    r = torch.linalg.vector_norm(scene.world_hi - c) + 1e-6
    return c, r


def _require_constant_env(scene: Scene):
    if scene.env_map.shape[0] * scene.env_map.shape[1] > 1:
        raise NotImplementedError(
            "environment-map emitters: ROADMAP queue 1 item 16")


def env_le(scene: Scene, d):
    """Environment radiance for escaped rays in direction d [N,3]."""
    _require_constant_env(scene)
    return scene.env_radiance.expand(d.shape[:-1] + (3,))


def pdf_env_sa(scene: Scene, d=None):
    """Solid-angle NEE pdf of the (constant, uniform-sphere) environment
    strategy, including the env-group pick probability."""
    _require_constant_env(scene)
    return scene.light_group_p[2] * warp.INV_FOURPI


def sample_env_dir(scene: Scene, u2):
    """Sample a direction TOWARD the environment; returns (d, pdf_sa)
    where pdf_sa excludes the group pick probability."""
    _require_constant_env(scene)
    d = warp.square_to_uniform_sphere(u2)
    return d, torch.full(u2.shape[:-1], warp.INV_FOURPI,
                         dtype=torch.float32, device=u2.device)


@dataclasses.dataclass
class DirectSample:
    """One next-event sample toward a light: contribution at the shading
    point = throughput * f(wl) * Tr * li_over_pdf * mis_weight, the MIS
    weight from pdf_sa."""
    wl: torch.Tensor           # [N,3] unit direction to the light
    p_light: torch.Tensor      # [N,3] shadow-ray target
    li_over_pdf: torch.Tensor  # [N,3] radiance / pdf, all factors folded
    pdf_sa: torch.Tensor       # [N] solid-angle pdf
    valid: torch.Tensor        # [N] bool


def sample_direct(scene: Scene, p_from, u3) -> DirectSample:
    """NEE sample from points p_from [N,3]; u3: [N,3] uniforms. Picks the
    emitter group by power (light_group_p), then an emitter within it;
    li_over_pdf folds every pdf factor except the scatter function and
    the transmittance at the shading point."""
    if scene.de_type.shape[0] > 0:
        raise NotImplementedError(
            "delta (point/spot/directional) emitters: ROADMAP queue 1 "
            "item 16")
    gp = scene.light_group_p
    n = p_from.shape[0]
    grp = torch.where(u3[..., 0] < gp[0], 0,
                      torch.where(u3[..., 0] < gp[0] + gp[1], 1, 2))
    # re-stretch the pick uniform within its group
    u_area = torch.clamp(u3[..., 0] / torch.clamp(gp[0], min=1e-12),
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

    # --- env branch (constant: uniform sphere) ---
    _, wr = world_center_radius(scene)
    wl_e, pdf_e = sample_env_dir(scene, u3[..., 1:3])
    dist_e = torch.full((n,), 2.0, dtype=torch.float32,
                        device=p_from.device) * wr
    pdf_e_sa = gp[2] * pdf_e
    li_e = env_le(scene, wl_e) / torch.clamp(pdf_e_sa, min=1e-20)[..., None]

    # the delta group (grp 1) is empty: zero sample, invalid
    is_a = (grp == 0)[..., None]
    is_d = (grp == 1)[..., None]
    zero3 = torch.zeros_like(wl_a)
    return DirectSample(
        wl=torch.where(is_a, wl_a, torch.where(is_d, zero3, wl_e)),
        p_light=torch.where(is_a, es.p, torch.where(
            is_d, zero3, p_from + wl_e * dist_e[..., None])),
        li_over_pdf=torch.where(is_a, li_a, torch.where(is_d, zero3, li_e)),
        pdf_sa=torch.where(grp == 0, pdf_a_sa,
                           torch.where(grp == 1, 0.0, pdf_e_sa)),
        valid=torch.where(grp == 0, ok_a,
                          torch.where(grp == 1, False, gp[2] > 0)))


def sample_photon(scene: Scene, key, n, lanes=None):
    """Sample n photon-emission rays across the emitter groups by power.

    Returns a dict: p, d, alpha (power/pdf), med, valid, plus the shift
    caches the particle tracer stores for first-bounce photons (ns,
    scatter, pdf_dir; reconnectable only for area lights, the
    reference's restriction, gvpm.cpp:148-158). lanes [n]: global path
    ids — randoms become functions of (key, lane id)."""
    if scene.de_type.shape[0] > 0:
        raise NotImplementedError(
            "delta (point/spot/directional) emitters: ROADMAP queue 1 "
            "item 16")
    if scene.env_map.shape[0] * scene.env_map.shape[1] > 1:
        raise NotImplementedError(
            "environment-map emitters: ROADMAP queue 1 item 16")
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
    d_local = warp.square_to_cosine_hemisphere(u2)
    s, t = coordinate_system(es.n)
    d_a = to_world(es.n, s, t, d_local)
    pdf_dir_a = warp.square_to_cosine_hemisphere_pdf(d_local)
    cos_e = torch.clamp(dot(es.n, d_a), min=0.0)
    alpha_a = es.radiance * (cos_e / torch.clamp(
        es.pdf_area * pdf_dir_a * gp[0], min=1e-20))[..., None]
    ok_a = es.valid & (cos_e > 0)

    # --- env (constant): inward direction from the bounding disk ---
    d_env_out = warp.square_to_uniform_sphere(u2)
    d_env = -d_env_out
    r_disk = torch.sqrt(torch.clamp(u_disk[..., 0], min=0.0))
    phi = 2.0 * math.pi * u_disk[..., 1]
    disk_e = torch.stack([r_disk * torch.cos(phi),
                          r_disk * torch.sin(phi)], dim=-1) * wr
    se, te = coordinate_system(d_env)
    p_env = wc + d_env_out * wr + se * disk_e[..., 0:1] \
        + te * disk_e[..., 1:2]
    alpha_env = scene.env_radiance.expand(d_env.shape) * (
        math.pi * wr * wr
        / torch.clamp(warp.INV_FOURPI * gp[2], min=1e-20))[..., None]

    is_a = (grp == 0)[..., None]
    z3 = torch.zeros_like(d_a)
    p = torch.where(is_a, es.p + es.n * 1e-4, torch.where(
        (grp == 1)[..., None], z3, p_env))
    d = torch.where(is_a, d_a, torch.where((grp == 1)[..., None], z3,
                                           d_env))
    alpha = torch.where(is_a, alpha_a, torch.where((grp == 1)[..., None],
                                                   z3, alpha_env))
    valid = torch.where(grp == 0, ok_a & (gp[0] > 0),
                        torch.where(grp == 1, False, gp[2] > 0))
    med_a = medium_transition(scene, es.prim, es.n, d_a)
    med0 = torch.where(grp == 0, med_a, -1)
    return dict(
        p=p, d=d, alpha=alpha, med=med0, valid=valid,
        ns=torch.where(is_a, es.n, d),
        pdf_dir=torch.where(grp == 0, pdf_dir_a, 1.0),
        scatter=torch.where(is_a, cos_e[..., None], torch.ones_like(d)),
        reconnectable=grp == 0,
        prim=es.prim,
    )
