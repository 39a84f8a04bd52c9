"""Metropolis light transport with structured (path-aware) mutations
(mirrors gvpm_tpu/integrators/mlt.py; reference:
src/integrators/mlt/mlt.cpp + src/libbidir/mut_lens.cpp,
mut_caustic.cpp, mut_mchain.cpp).

n_chains lockstep chains mutate the primary sample vector u with kernels
whose support mirrors the path-space perturbations, and f(u)
(volpath.trace_radiance) re-traces the whole population in one
wavefront:

  * lens: only the image dims u[0:2] move, by an exponentially
    distributed pixel radius (mut_lens.cpp:73-88's [r1, r2] ladder);
  * chain (caustic / multi-chain): the dims of ONE randomly chosen path
    step move by a small exponential step;
  * small: the Kelemen step over the whole vector (keeps the mixture
    ergodic);
  * large: an independent restart (and the normalization's source).

Every kernel is symmetric in u and the kernel choice does not depend on
the state, so the acceptance is min(1, lum'/lum); splatting and the
normalization follow pssmlt.py.
"""

from __future__ import annotations

import math

import torch

from ..core import rng
from ..core.config import VolPathConfig
from ..render import film
from ..scene.types import Scene
from .pssmlt import _exp_step, _f_eval, _mutate_small, bootstrap, chain_step
from .volpath import PSS_DIMS_PER_STEP

# kernel mixture (mlt.cpp defaults give lens / caustic / mchain equal play)
P_LARGE = 0.2
P_LENS = 0.3
P_CHAIN = 0.3
# lens perturbation pixel-radius ladder (mut_lens.cpp r1 / r2)
LENS_R1 = 0.1
LENS_R2_FRAC = 0.05
# chain perturbation scale (mut_caustic.cpp theta ladder, PSS analog)
CHAIN_S1 = 1.0 / 1024.0
CHAIN_S2 = 1.0 / 16.0


def _mutate_lens(u, key, width, height):
    """Perturb only the image dims by an exponential pixel radius."""
    k_r, k_phi = rng.split(key, 2)
    n = u.shape[0]
    r = _exp_step(rng.uniform(k_r, (n,)), LENS_R1, LENS_R2_FRAC * width)
    phi = 2.0 * math.pi * rng.uniform(k_phi, (n,))
    ux = u[:, 0] + r * torch.cos(phi) / width
    uy = u[:, 1] + r * torch.sin(phi) / height
    return torch.cat([(ux - torch.floor(ux))[:, None],
                      (uy - torch.floor(uy))[:, None], u[:, 2:]], dim=1)


def _mutate_chain(u, key, n_steps):
    """Exponential perturbation of ONE path step's dims."""
    k_pick, k_r, k_sign = rng.split(key, 3)
    n, dim = u.shape
    step = rng.randint(k_pick, (n,), 0, n_steps)
    d_idx = torch.arange(dim, device=u.device)[None, :]
    lo = 2 + step[:, None] * PSS_DIMS_PER_STEP
    in_block = (d_idx >= lo) & (d_idx < lo + PSS_DIMS_PER_STEP)
    r = rng.uniform(k_r, (n, dim))
    sign = torch.where(rng.uniform(k_sign, (n, dim)) < 0.5, -1.0, 1.0)
    v = u + torch.where(in_block, sign * _exp_step(r, CHAIN_S1, CHAIN_S2),
                        0.0)
    return v - torch.floor(v)


def _run_chains(scene: Scene, cfg: VolPathConfig, u0, n_mutations, key,
                stats=None):
    """Advance all chains n_mutations steps through the kernel mixture. A
    `stats` list receives each step's count of accepted proposals."""
    H, W = scene.height, scene.width
    n = u0.shape[0]
    n_steps = cfg.max_depth + cfg.null_bounces
    chain = (u0,) + _f_eval(scene, cfg, u0)
    img = film.new_film(H, W, device=u0.device)
    for k in rng.split(key, n_mutations):
        k_sel, k_l, k_lens, k_chain, k_small, k_acc = rng.split(k, 6)
        u = chain[0]
        sel = rng.uniform(k_sel, (n,))[:, None]
        u_prop = torch.where(
            sel < P_LARGE, rng.uniform(k_l, tuple(u.shape)),
            torch.where(sel < P_LARGE + P_LENS, _mutate_lens(u, k_lens, W, H),
                        torch.where(sel < P_LARGE + P_LENS + P_CHAIN,
                                    _mutate_chain(u, k_chain, n_steps),
                                    _mutate_small(u, k_small))))
        chain, acc = chain_step(scene, cfg, chain, img, u_prop, k_acc)
        if stats is not None:
            stats.append(acc.sum())
    return img


def render(scene: Scene, cfg: VolPathConfig = VolPathConfig(), seed=0,
           n_chains=4096, n_mutations=64, bootstrap_factor=4):
    """MLT render (lens + chain + small + large kernel mixture); the
    normalization b from the bootstrap (mlt.cpp's luminance pass).
    Returns [H,W,3]."""
    k_boot, k_pick, k_run = rng.split(
        rng.key((seed + 0x51ED270) % (1 << 30), scene.device), 3)
    b, u0 = bootstrap(scene, cfg, k_boot, k_pick,
                      bootstrap_factor * n_chains, n_chains)
    if u0 is None:
        return film.new_film(scene.height, scene.width, device=scene.device)
    img = _run_chains(scene, cfg, u0, n_mutations, k_run)
    return img * (b / (n_chains * n_mutations))
