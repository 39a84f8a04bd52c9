"""Plain reference of the beam map and of the photon planes made from it.

The beam map (the reference's LTBeamMap::tryAppendLT, gvpm_beams.h:54-84,
of the size its `beams` setting gives, photon_proc.h:17): the light
paths are taken in shooting order, path by path, each with its medium
edges in depth order; whole paths are kept from the start of the pass
while the running count of their edges stays at most the size. The
beam and plane estimators divide by the kept paths.

A plane (LTPhotonPlane::transformBeam, plane_struct.h:73-93): the beam
extended by a direction w1 drawn from the medium's (isotropic) phase
function and a length l1 drawn from exp(-sigma_t l), sigma_t the
medium's second channel; the k-th kept beam takes the k-th draw of the
pass's gather key (reference/rng.py). A plane whose w1 lies along the
beam, or whose l1 is not a positive finite length, is degenerate.

It reads the light pass's beam records (one a step and path, step-major,
as the pass stores them) and works the rest out again.
"""

from __future__ import annotations

import math

import torch

from . import rng
from .scene import ISOTROPIC


def select(valid, n_paths, budget, dtype=torch.float64):
    """(the flat indices of the kept beams among the light pass's records
    [steps * n_paths], path by path and each path's in depth order; the
    kept paths, at least 1). The running count of the paths' edges is
    computed in `dtype` (the control: a precision below float32)."""
    v = valid.reshape(-1, n_paths).cpu()
    count = torch.cumsum(v.to(dtype).sum(0), 0)
    within = (count <= budget).to(torch.int64)
    n_kept = int(torch.cumprod(within, 0).sum())     # from the start only
    p, s = torch.nonzero(v[:, :n_kept].t(), as_tuple=True)
    return (s * n_paths + p).to(valid.device), max(n_kept, 1)


def phase_sample(sc, u2):
    """A direction drawn from the medium's isotropic phase function
    (uniform on the sphere) from the uniforms u2 [n, 2], as the shared
    light reference (reference/light.py) models the medium."""
    if sc["phase"] != ISOTROPIC:
        raise NotImplementedError("the reference models an isotropic "
                                  "medium only")
    z = 1.0 - 2.0 * u2[:, 0]
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * math.pi * u2[:, 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)


def planes(sc, d, key, dtype=torch.float64):
    """(w1 [n, 3], l1 [n], not degenerate [n]) of the planes of n kept
    beams of directions d, in their order, from the pass's gather key."""
    n, dev = d.shape[0], d.device
    k_dir, k_len = rng.split(key.to(dev), 2)
    lanes = torch.arange(n, device=dev)
    d = d.to(dtype)
    w1 = phase_sample(sc, rng.rows(k_dir, lanes, 2).to(dtype))
    u = rng.rows(k_len, lanes, 1)[:, 0].to(dtype)
    sigma = torch.clamp(sc["sigma_t"][1].to(dtype), min=1e-20)
    l1 = -torch.log(torch.clamp(1.0 - u, min=1e-20)) / sigma
    ok = ((w1 * d).sum(-1).abs() < 1.0 - 1e-6) & (l1 > 1e-6) \
        & torch.isfinite(l1)
    return w1, l1, ok
