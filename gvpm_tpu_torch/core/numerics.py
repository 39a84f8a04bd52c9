"""Misc numerics: splines, quadrature, root finding, von Mises-Fisher
(mirrors gvpm_tpu/core/numerics.py; reference: src/libcore/{spline.cpp,
quad.cpp,brent.cpp,vmf.cpp}).

Everything is batched over whole tensors: the reference's scalar
Newton / Brent loops become fixed-iteration loops over every lane, each
lane's convergence masked.
"""

from __future__ import annotations

import math

import torch

# ---------------------------------------------------------------------------
# Catmull-Rom splines (spline.cpp evalCubicInterp1D / sampleCatmullRom)


def catmull_rom_weights(nodes, x):
    """Cubic Catmull-Rom basis at x over non-uniform `nodes` [K].

    Returns (idx [N], w [N,4]) such that f(x) ~= sum_j w[:,j] *
    values[idx + j - 1] (spline.cpp:catmullRomWeights)."""
    x = torch.as_tensor(x, dtype=nodes.dtype, device=nodes.device)
    K = nodes.shape[0]
    i = torch.clamp(torch.searchsorted(nodes, x, right=True) - 1, 0, K - 2)
    x0 = nodes[i]
    x1 = nodes[i + 1]
    width = x1 - x0
    t = torch.clamp((x - x0) / torch.clamp(width, min=1e-20), 0.0, 1.0)
    t2 = t * t
    t3 = t2 * t

    w0 = torch.zeros_like(t)
    w1 = 2 * t3 - 3 * t2 + 1
    w2 = -2 * t3 + 3 * t2
    w3 = torch.zeros_like(t)

    # derivative terms with one-sided differences at the boundary
    has_prev = i > 0
    has_next = i + 2 < K
    xm1 = nodes[torch.clamp(i - 1, min=0)]
    xp2 = nodes[torch.clamp(i + 2, max=K - 1)]

    d0 = t3 - 2 * t2 + t
    d1 = t3 - t2
    # left derivative
    fac_l = width / torch.clamp(x1 - xm1, min=1e-20)
    w0 = w0 + torch.where(has_prev, -d0 * fac_l, 0.0)
    w2 = w2 + torch.where(has_prev, d0 * fac_l, 0.0)
    w1 = w1 + torch.where(has_prev, 0.0, -d0)
    w2 = w2 + torch.where(has_prev, 0.0, d0)
    # right derivative
    fac_r = width / torch.clamp(xp2 - x0, min=1e-20)
    w1 = w1 + torch.where(has_next, -d1 * fac_r, -d1)
    w3 = w3 + torch.where(has_next, d1 * fac_r, 0.0)
    w2 = w2 + torch.where(has_next, 0.0, d1)
    return i, torch.stack([w0, w1, w2, w3], dim=-1)


def eval_catmull_rom(nodes, values, x):
    """Evaluate the Catmull-Rom interpolant through (nodes, values) at x
    (spline.cpp:evalCubicInterp1D, non-uniform variant)."""
    i, w = catmull_rom_weights(nodes, x)
    K = nodes.shape[0]
    idx = torch.stack([torch.clamp(i - 1, min=0), i, i + 1,
                       torch.clamp(i + 2, max=K - 1)], dim=-1)
    return (w * values[idx]).sum(-1)


# ---------------------------------------------------------------------------
# Gauss-Legendre quadrature (quad.cpp gaussLegendre)


def gauss_legendre(n: int, device="cpu"):
    """Nodes + weights of n-point Gauss-Legendre on [-1, 1]
    (quad.cpp:gaussLegendre: Newton iteration on the roots of P_n)."""
    k = torch.arange(1, n + 1, dtype=torch.float32, device=device)
    # Tricomi initial guess
    x = torch.cos(math.pi * (k - 0.25) / (n + 0.5))

    def legendre(x):
        # (P_n(x), P_n'(x)) by upward recurrence
        p0, p1 = torch.ones_like(x), x
        for i in range(1, n):
            p0, p1 = p1, ((2 * i + 1) * x * p1 - i * p0) / (i + 1)
        dp = n * (x * p1 - p0) / torch.clamp(x * x - 1.0, min=-1.0 + 1e-12)
        return p1, dp

    for _ in range(8):
        p, dp = legendre(x)
        x = x - p / dp
    _, dp = legendre(x)
    return x, 2.0 / ((1.0 - x * x) * dp * dp)


def integrate_gl(f, a, b, n: int = 16):
    """Integral of f over [a, b] by n-point Gauss-Legendre; f must be
    vectorized."""
    x, w = gauss_legendre(n)
    xm = 0.5 * (a + b)
    xr = 0.5 * (b - a)
    return xr * (w * f(xm + xr * x)).sum()


# ---------------------------------------------------------------------------
# Brent root finding (brent.cpp BrentSolver): batched bisection / secant


def brent(f, lo, hi, iters: int = 64):
    """Roots of f on bracketing intervals [lo, hi] (batched): a
    fixed-iteration hybrid secant / bisection (Dekker form of Brent);
    every lane runs `iters` steps. Returns (x, converged)."""
    a = torch.as_tensor(lo, dtype=torch.float32)
    b = torch.as_tensor(hi, dtype=torch.float32, device=a.device) \
        .expand(a.shape).clone()
    fa, fb = f(a), f(b)
    for i in range(iters):
        # secant proposal, bisection when out of bracket; a bisection
        # every other step so that false-position stalls (one endpoint
        # pinned) still halve the bracket
        denom = fb - fa
        x_sec = b - fb * (b - a) / torch.where(denom.abs() > 1e-30, denom,
                                               1e-30)
        x_bis = 0.5 * (a + b)
        use_sec = (x_sec > torch.minimum(a, b)) \
            & (x_sec < torch.maximum(a, b)) & (i % 2 == 1)
        x = torch.where(use_sec, x_sec, x_bis)
        fx = f(x)
        left = fa * fx <= 0.0
        a, fa, b, fb = (torch.where(left, a, x), torch.where(left, fa, fx),
                        torch.where(left, x, b), torch.where(left, fx, fb))
    x = 0.5 * (a + b)
    return x, f(x).abs() < 1e-5


# ---------------------------------------------------------------------------
# von Mises-Fisher (vmf.cpp VonMisesFisherDistr)


def vmf_pdf(kappa, cos_theta):
    """vMF density on S^2 with respect to solid angle (vmf.cpp:eval)."""
    kappa = torch.as_tensor(kappa, dtype=torch.float32)
    cos_theta = torch.as_tensor(cos_theta, dtype=torch.float32,
                                device=kappa.device)
    c = kappa / (2 * math.pi * (1.0 - torch.exp(-2.0 * kappa)))
    pdf = c * torch.exp(kappa * (cos_theta - 1.0))
    return torch.where(kappa < 1e-6, 1.0 / (4 * math.pi), pdf)


def vmf_sample(kappa, u):
    """Sample cos_theta ~ vMF(kappa) from uniforms u (vmf.cpp:sample, in
    the numerically stable log1p form)."""
    kappa = torch.as_tensor(kappa, dtype=torch.float32)
    u = torch.as_tensor(u, dtype=torch.float32, device=kappa.device)
    ct = 1.0 + torch.log1p(torch.expm1(-2.0 * kappa) * u) \
        / torch.clamp(kappa, min=1e-20)
    return torch.where(kappa < 1e-6, 1.0 - 2.0 * u,
                       torch.clamp(ct, -1.0, 1.0))


def vmf_for_peak(peak_value, iters: int = 40):
    """kappa whose vMF peak density equals `peak_value`
    (vmf.cpp:forPeakValue: a Brent inversion)."""
    peak_value = torch.as_tensor(peak_value, dtype=torch.float32)
    k, _ = brent(lambda kappa: vmf_pdf(kappa, torch.ones_like(kappa))
                 - peak_value, torch.full_like(peak_value, 1e-5),
                 torch.full_like(peak_value, 1e5), iters=iters)
    return k
