"""Screened-Poisson image reconstruction: CG with IRLS for L1
(mirrors gvpm_tpu/ops/poisson.py; reference poisson_solver/Solver.cpp).

Problem:  min_I  alpha * w0 |I - I0|^p  +  |Dx I - Gx|^p + |Dy I - Gy|^p
with p=2 (L2D) or p=1 via IRLS reweighting (L1D); alpha is
`reconstructAlpha` = 0.2 in the paper configs (gvpm.cpp:610-615).
"""

from __future__ import annotations

import torch

from ..core.logging import span


def dx(img):
    """Forward difference along x; output [H, W-1, C]."""
    return img[:, 1:] - img[:, :-1]


def dy(img):
    return img[1:, :] - img[:-1, :]


def dxT(gx):
    """Adjoint of dx: negative divergence, output [H, W, C]."""
    z = torch.zeros_like(gx[:, :1])
    return torch.cat([-gx, z], dim=1) + torch.cat([z, gx], dim=1)


def dyT(gy):
    z = torch.zeros_like(gy[:1, :])
    return torch.cat([-gy, z], dim=0) + torch.cat([z, gy], dim=0)


def _vdot(a, b):
    return (a * b).sum()


def _cg(A, b, x0, iters):
    """Conjugate gradient with a fixed iteration count; the guards are
    tensor selects, so the loop never waits on the device."""
    r = b - A(x0)
    p = r
    rz = _vdot(r, r)
    x = x0
    for _ in range(iters):
        Ap = A(p)
        denom = _vdot(p, Ap)
        alpha = torch.where(torch.abs(denom) > 1e-30, rz / denom, 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        rz_new = _vdot(r, r)
        beta = torch.where(rz > 1e-30, rz_new / rz, 0.0)
        p = r + beta * p
        rz = rz_new
    return x


def solve(primal, gx, gy, alpha=0.2, iters=50, irls_iters=4, l1=True,
          irls_eps=1e-4):
    """Reconstruct an image from throughput + gradients.

    primal: [H,W,C]; gx: x-gradients (I[x+1]-I[x], stored full-size with
    the last column ignored); gy likewise. Returns [H,W,C]. The call is
    the span `solve` (core.logging.span)."""
    with span("solve"):
        H, W, _ = primal.shape
        gx_in = gx[:, :W - 1]
        gy_in = gy[:H - 1, :]
        alpha2 = alpha * alpha
        I = primal
        for _ in range(irls_iters if l1 else 1):
            if l1:
                wx = 1.0 / (torch.abs(dx(I) - gx_in) + irls_eps)
                wy = 1.0 / (torch.abs(dy(I) - gy_in) + irls_eps)
                w0 = 1.0 / (torch.abs(I - primal) + irls_eps)
            else:
                wx, wy, w0 = (torch.ones_like(gx_in),
                              torch.ones_like(gy_in),
                              torch.ones_like(primal))

            def A(v, wx=wx, wy=wy, w0=w0):
                return alpha2 * w0 * v + dxT(wx * dx(v)) + dyT(wy * dy(v))

            rhs = alpha2 * w0 * primal + dxT(wx * gx_in) + dyT(wy * gy_in)
            I = _cg(A, rhs, I, iters)
    return I
