"""ERPT: energy redistribution path tracing, Cline et al. 2005 (mirrors
gvpm_tpu/integrators/erpt.py; reference:
src/integrators/erpt/{erpt.cpp,erpt_proc.cpp}).

A stratified path-tracing pass seeds many short Metropolis chains that
redistribute the seeds' energy to nearby paths with local (small)
mutations only, each mutation depositing a fixed quantum e_d, so the
image equals the path-tracing estimate in expectation. The chains live
in primary sample space (pssmlt.py's Kelemen small step, no large
steps) and advance in lockstep. Chain spawning in proportion to the seed
luminance is a categorical resample of the seed pool: the same
expectation as the paper's stochastic floor(lum/(e_d k) + u) count, with
a fixed chain total.
"""

from __future__ import annotations

import torch

from ..core import rng
from ..core.config import VolPathConfig
from ..render import film
from ..scene.types import Scene
from .pssmlt import _f_eval, _mutate_small, bootstrap, chain_step, pss_dim


def _redistribute(scene: Scene, cfg: VolPathConfig, u0, e_d, n_mutations,
                  key, stats=None):
    """Equal-deposition chains from the seed states u0: each mutation
    deposits e_d worth of luminance split between the current and the
    proposed state by the acceptance probability, each with its own
    chromaticity Y/lum (erpt_proc.cpp's deposition). A `stats` list
    receives each step's count of accepted proposals."""
    chain = (u0,) + _f_eval(scene, cfg, u0)
    img = film.new_film(scene.height, scene.width, device=u0.device)
    for k in rng.split(key, n_mutations):
        k_small, k_acc = rng.split(k, 2)
        chain, acc = chain_step(scene, cfg, chain, img,
                                _mutate_small(chain[0], k_small), k_acc,
                                a_dead=0.0, quantum=e_d)
        if stats is not None:
            stats.append(acc.sum())
    return img


def render(scene: Scene, cfg: VolPathConfig = VolPathConfig(), seed=0,
           n_chains=4096, n_mutations=32, seeds_per_pixel=1):
    """ERPT render; returns [H,W,3]. The redistributed energy is
    normalized so that the image equals the seeding path-tracing pass in
    expectation (erpt.cpp's e_d calibration)."""
    H, W = scene.height, scene.width
    dev = scene.device
    k_seed, k_pick, k_run = rng.split(rng.key(seed ^ 0x45525054, dev), 3)

    # the stratified seed pass: seeds_per_pixel path-tracing samples a
    # pixel, the pixel position stratified over the film
    u_seed = rng.uniform(k_seed, (H * W * seeds_per_pixel, pss_dim(cfg)))
    pix = torch.arange(H * W, dtype=torch.float32,
                       device=dev).repeat(seeds_per_pixel)
    u_seed[:, 0] = (torch.remainder(pix, W) + u_seed[:, 0]) / W
    u_seed[:, 1] = (torch.div(pix, W, rounding_mode="floor")
                    + u_seed[:, 1]) / H
    b, u0 = bootstrap(scene, cfg, None, k_pick, None, n_chains,
                      u_boot=u_seed)
    if u0 is None:
        return film.new_film(H, W, device=dev)
    # the per-mutation quantum: the n_chains * n_mutations deposits sum
    # to b, erpt.cpp's mean-energy e_d for a fixed chain population
    e_d = b / (n_chains * n_mutations)
    return _redistribute(scene, cfg, u0, e_d, n_mutations, k_run)
