"""G-PT: gradient-domain path tracing with participating media, with the
identity shift in primary sample space (mirrors
gvpm_tpu/integrators/gpt.py; reference: integrators/gpt/gpt.cpp).

Per pixel one base path and 4 offset paths (the neighbours right, left,
down, up) are traced in one 5n-lane wavefront that consumes the same
random sequence through each offset pixel (volpath's tile_rngs=5). The
Jacobian of that shift is 1 and the two strategies of an edge are
exchangeable, so each carries the weight 1/2 (1 at the film border) and
E_u[f_j(u) - f_i(u)] = I_j - I_i is unbiased. The gradients feed the
screened-Poisson reconstruction (gpt.cpp:2684-2900).
"""

from __future__ import annotations

import torch

from ..core import rng
from ..core.config import VolPathConfig
from ..ops import poisson
from ..scene.camera import generate_rays, pixel_grid
from ..scene.types import Scene
from .volpath import trace_radiance

OFFSETS = ((1, 0), (-1, 0), (0, 1), (0, -1))
RIGHT, LEFT, DOWN, UP = 0, 1, 2, 3


def render_pass(scene: Scene, cfg: VolPathConfig, seed, it):
    """One spp of base + 4 offsets. Returns (primal, gx, gy) [H,W,3]."""
    H, W = scene.height, scene.width
    n = H * W
    k_pix, k_path = rng.split(rng.pass_key(seed, it, rng.STREAM_CAMERA,
                                           scene.device), 2)
    px, py = pixel_grid(scene)
    u = rng.uniform(k_pix, (n, 2))

    # ONE wavefront of 5n lanes whose random sequence repeats every n
    # lanes: identical primary samples across the 5 variants
    all_px = torch.cat([px] + [px + dx for dx, dy in OFFSETS])
    all_py = torch.cat([py] + [py + dy for dx, dy in OFFSETS])
    o, d, _ = generate_rays(scene, all_px, all_py, u.repeat(5, 1))
    L = trace_radiance(scene, cfg, o, d, scene.cam_medium, k_path,
                       tile_rngs=5).reshape(5, n, 3)
    base = L[0]

    xi, yi = px.to(torch.int64), py.to(torch.int64)
    border = (xi == W - 1, xi == 0, yi == H - 1, yi == 0)
    S, Wb = [], []
    for i in range(4):
        w = torch.where(border[i], 1.0, 0.5)[..., None]
        S.append((w * L[1 + i]).reshape(H, W, 3))
        Wb.append((w * base).reshape(H, W, 3))

    gx = S[RIGHT] - Wb[RIGHT]
    gx[:, :-1] += (Wb[LEFT] - S[LEFT])[:, 1:]
    gy = S[DOWN] - Wb[DOWN]
    gy[:-1, :] += (Wb[UP] - S[UP])[1:, :]
    return base.reshape(H, W, 3), gx, gy


def render(scene: Scene, cfg: VolPathConfig = VolPathConfig(), seed=0,
           callback=None, recon_alpha=0.2, recon_l1=True, recon_iters=50):
    """Progressive G-PT: average primal / gradients over spp, then
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
