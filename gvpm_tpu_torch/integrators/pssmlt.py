"""Primary-sample-space Metropolis light transport, Kelemen-style
(mirrors gvpm_tpu/integrators/pssmlt.py; reference:
src/integrators/pssmlt/{pssmlt.cpp,pssmlt_sampler.cpp}).

A Markov chain over the unit hypercube of the path tracer's random
numbers with small (exponential) and large (independent) mutations,
expected-value splatting of the current and the proposed state, and a
normalization b estimated from the bootstrap's large steps. n_chains
chains advance in lockstep: each mutation evaluates the deterministic map
f(u) (volpath.trace_radiance with u_explicit) for the whole population in
one wavefront. A luminance-weighted resample of the bootstrap picks the
initial states. The chain step is shared with mlt.py and erpt.py.
"""

from __future__ import annotations

import math

import torch

from ..core import rng
from ..core.config import VolPathConfig
from ..core.spectrum import luminance
from ..render import film
from ..scene.camera import generate_rays
from ..scene.types import Scene
from .volpath import PSS_DIMS_PER_STEP, trace_radiance

# Kelemen mutation sizes (pssmlt_sampler.cpp defaults)
S1 = 1.0 / 1024.0
S2 = 1.0 / 64.0


def pss_dim(cfg: VolPathConfig):
    """Dimensions of a primary sample: 2 for the pixel, then one block of
    PSS_DIMS_PER_STEP per path step."""
    return 2 + (cfg.max_depth + cfg.null_bounces) * PSS_DIMS_PER_STEP


def _f_eval(scene: Scene, cfg: VolPathConfig, u):
    """Deterministic map u in [0,1)^D -> (Y [N,3], px, py, lum [N]), with
    Y = H*W * L so that E_large[Y * 1{pix=j}] / N = I_j."""
    H, W = scene.height, scene.width
    n = u.shape[0]
    px = torch.clamp(u[:, 0], 0.0, 1.0 - 1e-6) * W
    py = torch.clamp(u[:, 1], 0.0, 1.0 - 1e-6) * H
    fx, fy = torch.floor(px), torch.floor(py)
    o, d, _ = generate_rays(scene, fx, fy, torch.stack([px - fx, py - fy],
                                                       dim=-1))
    ue = u[:, 2:].reshape(n, cfg.max_depth + cfg.null_bounces,
                          PSS_DIMS_PER_STEP)
    L = trace_radiance(scene, cfg, o, d, scene.cam_medium, None,
                       u_explicit=ue)
    Y = L * (H * W)
    return Y, px, py, torch.clamp(luminance(Y), min=0.0)


def _exp_step(r, s1, s2):
    """The Kelemen step size s2 * exp(-log(s2 / s1) * r) for uniforms r."""
    return s2 * torch.exp(-math.log(s2 / s1) * r)


def _mutate_small(u, key):
    """Kelemen exponential mutation with wrap-around
    (pssmlt_sampler.cpp mutate())."""
    k1, k2 = rng.split(key, 2)
    r = rng.uniform(k1, tuple(u.shape))
    sign = torch.where(rng.uniform(k2, tuple(u.shape)) < 0.5, -1.0, 1.0)
    v = u + sign * _exp_step(r, S1, S2)
    return v - torch.floor(v)  # wrap to [0,1)


def chain_step(scene: Scene, cfg: VolPathConfig, chain, img, u_prop, k_acc,
               a_dead=1.0, quantum=None):
    """One Metropolis step of every chain toward the proposals u_prop:
    both states splatted with their expected-value weights (scaled by
    `quantum` when given: erpt's equal deposition), then accepted with
    probability min(1, lum'/lum) (`a_dead` where lum <= 0). chain: (u, Y,
    px, py, lum). Returns the new chain and the accepted mask."""
    u, Y, px, py, lum = chain
    Yp, pxp, pyp, lump = _f_eval(scene, cfg, u_prop)
    a = torch.clamp(lump / torch.clamp(lum, min=1e-12), 0.0, 1.0)
    a = torch.where(lum <= 0.0, a_dead, a)
    num_cur, num_prop = (1.0 - a, a) if quantum is None \
        else (quantum * (1.0 - a), quantum * a)
    w_cur = num_cur / torch.clamp(lum, min=1e-12)
    w_prop = num_prop / torch.clamp(lump, min=1e-12)
    film.splat(img, px, py, Y * w_cur[:, None], mask=lum > 0)
    film.splat(img, pxp, pyp, Yp * w_prop[:, None], mask=lump > 0)
    acc = rng.uniform(k_acc, (u.shape[0],)) < a
    a1 = acc[:, None]
    return (torch.where(a1, u_prop, u), torch.where(a1, Yp, Y),
            torch.where(acc, pxp, px), torch.where(acc, pyp, py),
            torch.where(acc, lump, lum)), acc


def _run_chains(scene: Scene, cfg: VolPathConfig, u0, n_mutations,
                p_large, key, stats=None):
    """Advance all chains n_mutations steps, expected-value splatting.
    A `stats` list receives each step's count of accepted proposals."""
    n = u0.shape[0]
    chain = (u0,) + _f_eval(scene, cfg, u0)
    img = film.new_film(scene.height, scene.width, device=u0.device)
    for k in rng.split(key, n_mutations):
        k_sel, k_large, k_small, k_acc = rng.split(k, 4)
        large = rng.uniform(k_sel, (n,)) < p_large
        u_prop = torch.where(large[:, None],
                             rng.uniform(k_large, tuple(u0.shape)),
                             _mutate_small(chain[0], k_small))
        chain, acc = chain_step(scene, cfg, chain, img, u_prop, k_acc)
        if stats is not None:
            stats.append(acc.sum())
    return img


def bootstrap(scene: Scene, cfg: VolPathConfig, k_boot, k_pick, n_boot,
              n_chains, u_boot=None):
    """Normalization b (the mean luminance of n_boot independent primary
    samples) and n_chains initial states drawn from them in proportion
    to their luminance -> (b, u0); u0 is None when b <= 0. `u_boot`
    replaces the uniform draw (erpt's stratified seeds)."""
    if u_boot is None:
        u_boot = rng.uniform(k_boot, (n_boot, pss_dim(cfg)))
    lum_boot = _f_eval(scene, cfg, u_boot)[3]
    b = float(lum_boot.mean())
    if b <= 0.0:
        return b, None
    idx = rng.categorical(k_pick, torch.log(torch.clamp(lum_boot,
                                                        min=1e-20)),
                          n_chains)
    return b, u_boot[idx]


def render(scene: Scene, cfg: VolPathConfig = VolPathConfig(), seed=0,
           n_chains=4096, n_mutations=64, p_large=0.3,
           bootstrap_factor=4):
    """PSSMLT render; n_chains * n_mutations samples plus the bootstrap.
    Returns [H,W,3]."""
    k_boot, k_pick, k_run = rng.split(
        rng.key(seed + 0x9E3779B9 % (1 << 30), scene.device), 3)
    b, u0 = bootstrap(scene, cfg, k_boot, k_pick,
                      bootstrap_factor * n_chains, n_chains)
    if u0 is None:
        return film.new_film(scene.height, scene.width, device=scene.device)
    img = _run_chains(scene, cfg, u0, n_mutations, p_large, k_run)
    # each mutation deposits ~1 unit of (f/lum) mass per chain
    return img * (b / (n_chains * n_mutations))
