"""Participating media (mirrors gvpm_tpu/render/medium.py): homogeneous
closed forms and a heterogeneous grid medium tracked by null collisions
(src/medium/heterogeneous.cpp re-designed as fixed-step delta / ratio
tracking, MAX_TRACK_STEPS flights a segment).

The reference's three distance-sampling strategies
(include/mitsuba/render/medium.h:104-148):

  * NORMAL        — free-flight sampling with probability
                    `sampling_weight` (green-channel pick, or a random
                    channel when `u_channel` is given).
  * LONG          — "long beam": march to t = -log(eps)/sigma_g, until
                    the transmittance is negligible.
  * ALWAYS_VALID  — forced interaction on [0, t_max): normalized
                    truncated exponential.

A medium index of -1 denotes vacuum. Lanes in the heterogeneous medium
(scene.het_medium) are overridden with tracking results. Tracking draws
its randoms from per-lane threefry keys: given a key, fold_in(key, lane);
without one, jax.random.key of the bit pattern of the lane's uniform, as
the JAX package does.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import rng
from ..scene.types import NO_MEDIUM, Scene

EPSILON = 1e-4

NORMAL = 0
LONG = 1
ALWAYS_VALID = 2

MAX_TRACK_STEPS = 64  # delta / ratio-tracking flight budget per segment


@dataclasses.dataclass
class MediumSample:
    success: torch.Tensor        # [N] bool — medium interaction happened
    t: torch.Tensor              # [N] sampled distance (== t_max on failure)
    p: torch.Tensor              # [N,3] interaction point
    transmittance: torch.Tensor  # [N,3]
    pdf_success: torch.Tensor    # [N]
    pdf_failure: torch.Tensor    # [N]
    sigma_s: torch.Tensor        # [N,3]


def _tables(scene: Scene, mi):
    """Per-lane medium coefficients; vacuum (mi<0) becomes all-zero."""
    idx = torch.clamp(mi, 0, scene.med_sigma_a.shape[0] - 1)
    in_med = (mi != NO_MEDIUM)[..., None]
    sa = torch.where(in_med, scene.med_sigma_a[idx], 0.0)
    ss = torch.where(in_med, scene.med_sigma_s[idx], 0.0)
    return sa, ss, sa + ss


def _mean3(a):
    return (a[..., 0] + a[..., 1] + a[..., 2]) / 3.0


def sampling_weight(scene: Scene, mi):
    """max(albedo, 0.5) (Medium::configure); 0 for vacuum."""
    sa, ss, st = _tables(scene, mi)
    albedo = torch.where(st > 0, ss / torch.clamp(st, min=1e-20),
                         0.0).amax(-1)
    w = torch.clamp(albedo, min=0.5)
    return torch.where(mi != NO_MEDIUM, w, 0.0)


# --------------------------------------------------------------------------
# heterogeneous grid medium: trilinear density + null-collision tracking


def het_sigma_t(scene: Scene, p):
    """sigma_t(p) of the heterogeneous grid: trilinear density * scale,
    zero outside the grid's box. p: [N,3] -> [N,3]."""
    g = scene.het_density
    Gx, Gy, Gz = g.shape
    ext = torch.clamp(scene.het_hi - scene.het_lo, min=1e-12)
    rel = (p - scene.het_lo) / ext
    inside = ((rel >= 0.0) & (rel <= 1.0)).all(-1)
    res = torch.tensor([Gx - 1, Gy - 1, Gz - 1], dtype=torch.float32,
                       device=p.device)
    f = torch.clamp(rel, 0.0, 1.0) * res
    hi = torch.tensor([max(Gx - 2, 0), max(Gy - 2, 0), max(Gz - 2, 0)],
                      device=p.device)
    i0 = torch.minimum(torch.clamp(torch.floor(f).to(torch.int64), min=0),
                       hi)
    w = f - i0
    ix, iy, iz = i0.unbind(-1)
    wx, wy, wz = w.unbind(-1)

    def corner(dx, dy, dz):
        return g[torch.clamp(ix + dx, max=Gx - 1),
                 torch.clamp(iy + dy, max=Gy - 1),
                 torch.clamp(iz + dz, max=Gz - 1)]

    c00 = corner(0, 0, 0) * (1 - wx) + corner(1, 0, 0) * wx
    c10 = corner(0, 1, 0) * (1 - wx) + corner(1, 1, 0) * wx
    c01 = corner(0, 0, 1) * (1 - wx) + corner(1, 0, 1) * wx
    c11 = corner(0, 1, 1) * (1 - wx) + corner(1, 1, 1) * wx
    c0 = c00 * (1 - wy) + c10 * wy
    c1 = c01 * (1 - wy) + c11 * wy
    dens = torch.where(inside, c0 * (1 - wz) + c1 * wz, 0.0)
    return dens[..., None] * scene.het_sigma_scale


def _het_keys(key, u, n):
    """Per-lane tracking keys [n, 2]: fold_in(key, lane) when a key is
    given, else jax.random.key of the bit pattern of the lane's uniform
    (distinct per lane and step)."""
    if key is not None:
        return rng.fold_in(key, torch.arange(n, device=u.device))
    return rng.seed_keys(rng.float_bits(u))


def het_track_sample(scene: Scene, o, d, t_max, keys):
    """Analog delta tracking (Woodcock, RGB null-collision weights) ->
    dict(success, t, w_null [N,3], pdf_real [N], sigma_t_x [N,3]), with
    E[w_null 1{success} f(x)/pdf_real] = int Tr(t) f(x_t) dt and
    E[w_null 1{escape}] = Tr(t_max). Lanes still flying after the
    budget count as escaped. The flights stop once no lane flies: the
    JAX package's remaining steps change nothing then."""
    n = o.shape[0]
    maj = scene.het_majorant
    t = torch.zeros((n,), dtype=torch.float32, device=o.device)
    w = torch.ones((n, 3), dtype=torch.float32, device=o.device)
    status = torch.zeros((n,), dtype=torch.int64, device=o.device)
    for k in range(MAX_TRACK_STEPS):       # status 0 flying, 1 hit, 2 out
        flying = status == 0
        if not bool(flying.any()):
            break
        u = rng.uniform(rng.fold_in(keys, k), (2,))
        t_new = t - torch.log1p(-u[:, 0] * (1 - 1e-7)) / maj
        esc = t_new >= t_max
        st = het_sigma_t(scene, o + d * t_new[..., None])
        p_real = torch.clamp(_mean3(st) / maj, 0.0, 1.0)
        real = u[:, 1] < p_real
        # null collision: spectral correction (maj - st)/(maj (1-p_real))
        w_null_fac = (maj - st) / torch.clamp(
            maj * (1.0 - p_real)[..., None], min=1e-20)
        status = torch.where(flying, torch.where(
            esc, 2, torch.where(real, 1, 0)), status)
        w = torch.where((flying & ~esc & ~real)[..., None], w * w_null_fac, w)
        t = torch.where(flying & ~esc, t_new, t)
    st_x = het_sigma_t(scene, o + d * t[..., None])
    p_real = torch.clamp(_mean3(st_x) / maj, 1e-20, 1.0)
    return dict(success=status == 1, t=t, w_null=w, pdf_real=maj * p_real,
                sigma_t_x=st_x)


def het_transmittance(scene: Scene, o, d, t_max, keys):
    """Ratio-tracking transmittance estimate along [0, t_max) -> [N,3];
    the flights stop once no lane flies."""
    n = o.shape[0]
    maj = scene.het_majorant
    t = torch.zeros((n,), dtype=torch.float32, device=o.device)
    w = torch.ones((n, 3), dtype=torch.float32, device=o.device)
    flying = torch.ones((n,), dtype=torch.bool, device=o.device)
    for k in range(MAX_TRACK_STEPS):
        if not bool(flying.any()):
            break
        u = rng.uniform(rng.fold_in(keys, k))
        t_new = t - torch.log1p(-u * (1 - 1e-7)) / maj
        esc = t_new >= t_max
        st = het_sigma_t(scene, o + d * t_new[..., None])
        fac = torch.clamp(1.0 - st / maj, 0.0, 1.0)
        go = flying & ~esc
        w = torch.where(go[..., None], w * fac, w)
        t = torch.where(go, t_new, t)
        flying = go
    return w


def _het_lanes(scene: Scene, mi):
    """Indices of the lanes in the heterogeneous medium: tracking runs on
    them only (every lane's randoms depend on its own key alone)."""
    return torch.nonzero(mi == scene.het_medium).squeeze(-1)


def transmittance(scene: Scene, mi, dist, o=None, d=None, key=None):
    """exp(-sigma_t * dist) per channel; 1 for vacuum. Lanes in the
    heterogeneous medium get a ratio-tracking estimate when o / d are
    given; without them the closed form of its majorant-level table row
    stands in, as in the JAX package."""
    _, _, st = _tables(scene, mi)
    tr = torch.exp(-st * torch.clamp(dist, min=0.0)[..., None])
    tr = torch.where(tr.amax(-1, keepdim=True) < 1e-20, 0.0, tr)
    if scene.het_medium >= 0 and o is not None:
        keys = _het_keys(key, dist + 0.12345, o.shape[0])
        h = _het_lanes(scene, mi)
        tr = tr.index_put((h,), het_transmittance(scene, o[h], d[h],
                                                  dist[h], keys[h]))
    return tr


def sample_distance(scene: Scene, mi, o, d, t_max, u, strategy=NORMAL,
                    u_channel=None, key=None) -> MediumSample:
    """Sample a free-flight distance along (o, d) within [0, t_max).
    Vacuum lanes always fail with pdf_failure = 1, transmittance = 1.
    The green channel samples (the reference's EBalance pick) unless
    `u_channel` picks one at random."""
    sa, ss, st = _tables(scene, mi)
    if strategy == ALWAYS_VALID:
        u_channel = None
    if u_channel is None:
        sigma_g = st[..., 1]
    else:
        ch = torch.clamp((u_channel * 3.0).to(torch.int64), max=2)
        sigma_g = st.gather(-1, ch[..., None])[..., 0]
    sigma_g_safe = torch.clamp(sigma_g, min=1e-20)
    in_med = (mi != NO_MEDIUM) & (st.amax(-1) > 0.0)

    w = sampling_weight(scene, mi)
    if strategy == ALWAYS_VALID:
        w = torch.where(in_med, 1.0, w)

    take = u < w
    ur = torch.where(take, u / torch.clamp(w, min=1e-20), 0.0)

    if strategy == ALWAYS_VALID:
        max_dist = torch.clamp(t_max - EPSILON, min=0.0)
        norm_g = 1.0 - torch.exp(-sigma_g_safe * max_dist)
        t_sample = -torch.log1p(-ur * norm_g) / sigma_g_safe
    elif strategy == LONG:
        t_sample = -torch.log(torch.full_like(u, EPSILON)) / sigma_g_safe
    else:
        t_sample = -torch.log(torch.clamp(1.0 - ur, min=1e-20)) \
            / sigma_g_safe

    t_sample = torch.where(take & in_med, t_sample, torch.inf)
    success = t_sample < t_max
    t = torch.where(success, t_sample, t_max)

    tr_c = torch.exp(-st * t[..., None])
    if strategy == ALWAYS_VALID:
        norm_g = 1.0 - torch.exp(
            -sigma_g * torch.clamp(t_max - EPSILON, min=0.0))
        pdf_success = torch.where(
            norm_g > 1e-12,
            sigma_g / torch.clamp(norm_g, min=1e-12)
            * torch.exp(-sigma_g * t), 0.0)
        pdf_failure = torch.zeros_like(pdf_success)
    else:
        pdf_failure = _mean3(tr_c)
        pdf_success = _mean3(st * tr_c)

    pdf_success = pdf_success * w
    pdf_failure = w * pdf_failure + (1.0 - w)
    tr = torch.where(tr_c.amax(-1, keepdim=True) < 1e-20, 0.0, tr_c)
    pdf_failure = torch.where(in_med, pdf_failure, 1.0)
    pdf_success = torch.where(in_med, pdf_success, 0.0)
    ms = MediumSample(
        success=success & in_med, t=t, p=o + d * t[..., None],
        transmittance=torch.where(in_med[..., None], tr, 1.0),
        pdf_success=pdf_success, pdf_failure=pdf_failure, sigma_s=ss)
    if scene.het_medium >= 0:
        _het_override(scene, ms, mi, o, d, t_max, u, strategy, key)
    return ms


def _het_override(scene: Scene, ms: MediumSample, mi, o, d, t_max, u,
                  strategy, key):
    """Overwrite (in place) the lanes inside the heterogeneous medium with
    null-collision tracking results, so that every estimator downstream
    stays unchanged (analog delta tracking):
      success: Tr/pdf_success = w_null/(maj*p_real), sigma_s local;
      failure: Tr/pdf_failure = w_null (pdf_failure = 1)."""
    keys = _het_keys(key, u + 0.7071, o.shape[0])
    h = _het_lanes(scene, mi)
    o, d, t_max, u, keys = o[h], d[h], t_max[h], u[h], keys[h]
    if strategy == ALWAYS_VALID:
        md = torch.clamp(t_max - EPSILON, min=1e-12)
        finite = torch.isfinite(t_max) & (t_max > EPSILON)
        mds = torch.where(finite, md, 1.0)
        t_h = torch.clamp(u, 0.0, 1.0 - 1e-6) * mds
        tr_h = het_transmittance(scene, o, d, t_h, keys)
        ps_h = torch.where(finite, 1.0 / mds, 0.0)
        pf_h = torch.zeros_like(ps_h)
        succ_h = finite
        stx = het_sigma_t(scene, o + d * t_h[..., None])
    else:                               # NORMAL / LONG: delta tracking
        tk = het_track_sample(scene, o, d, t_max, keys)
        t_h, tr_h = tk["t"], tk["w_null"]
        ps_h, succ_h = tk["pdf_real"], tk["success"]
        pf_h = torch.ones_like(ps_h)
        stx = tk["sigma_t_x"]
    for name, v in (("success", succ_h), ("t", t_h),
                    ("p", o + d * t_h[..., None]), ("transmittance", tr_h),
                    ("pdf_success", ps_h), ("pdf_failure", pf_h),
                    ("sigma_s", stx * scene.het_albedo)):
        setattr(ms, name, getattr(ms, name).index_put((h,), v))


def pdf_distance_always_valid(scene: Scene, mi, t, t_max):
    """pdf_success(t) of an already-known distance under ALWAYS_VALID
    (Medium::eval analog; its pdf_failure is 0)."""
    _, _, st = _tables(scene, mi)
    in_med = (mi != NO_MEDIUM) & (st.amax(-1) > 0.0)
    sigma_g = st[..., 1]
    norm_g = 1.0 - torch.exp(-sigma_g * torch.clamp(t_max - EPSILON,
                                                    min=0.0))
    ps = torch.where(norm_g > 1e-12,
                     sigma_g / torch.clamp(norm_g, min=1e-12)
                     * torch.exp(-sigma_g * t), 0.0)
    w = torch.where(in_med, 1.0, sampling_weight(scene, mi))
    return torch.where(in_med, ps * w, 0.0)


def pdf_distance(scene: Scene, mi, t, t_max, hit_surface):
    """pdf of an already-known distance outcome under the NORMAL strategy
    (Medium::eval analog) -> (pdf_success(t), pdf_failure(t_max)); where
    `hit_surface` (a bool or a bool tensor) holds, both are evaluated at
    t_max. pdf_distance_always_valid covers ALWAYS_VALID."""
    _, _, st = _tables(scene, mi)
    in_med = (mi != NO_MEDIUM) & (st.amax(-1) > 0.0)
    w = sampling_weight(scene, mi)
    tq = torch.where(torch.as_tensor(hit_surface, device=t.device), t_max, t)
    tr_c = torch.exp(-st * tq[..., None])
    ps = _mean3(st * tr_c) * w
    pf = w * _mean3(tr_c) + (1.0 - w)
    return torch.where(in_med, ps, 0.0), torch.where(in_med, pf, 1.0)
