"""Emitters: flux-weighted photon emission and emitted radiance
(mirrors gvpm_tpu/render/emitter.py::sample_photon / eval_radiance).

Emitters group as (area | delta | env) with a static group-probability
table (scene.light_group_p). The port emits from area lights and a
constant environment; delta lights and environment maps are rejected.
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


def _world_center_radius(scene: Scene):
    c = 0.5 * (scene.world_lo + scene.world_hi)
    r = torch.linalg.vector_norm(scene.world_hi - c) + 1e-6
    return c, r


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
    wc, wr = _world_center_radius(scene)

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
