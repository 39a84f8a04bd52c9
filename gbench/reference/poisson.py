"""Plain reference of the screened-Poisson reconstruction: L1 by
iteratively reweighted least squares, each reweighting a fixed number of
conjugate-gradient steps from the last image (poisson_solver/Solver.cpp
of the GVPM code release):

  min_I  alpha^2 w0 |I - I0|^2 + wx |Dx I - Gx|^2 + wy |Dy I - Gy|^2

with w = 1 / (|residual| + eps) from the previous image. Computed in the
dtype of its inputs (float64 for the reference).
"""

from __future__ import annotations

import torch


def _dx(a):
    return a[:, 1:] - a[:, :-1]


def _dy(a):
    return a[1:] - a[:-1]


def _dxT(g):
    z = torch.zeros_like(g[:, :1])
    return torch.cat([-g, z], 1) + torch.cat([z, g], 1)


def _dyT(g):
    z = torch.zeros_like(g[:1])
    return torch.cat([-g, z], 0) + torch.cat([z, g], 0)


def solve(primal, gx, gy, alpha, iters, irls_iters, l1=True, eps=1e-4):
    """[H, W, C] image from the primal and the forward-difference
    gradients (gx's last column and gy's last row are not read)."""
    H, W, _ = primal.shape
    gx, gy = gx[:, :W - 1], gy[:H - 1]
    a2 = alpha * alpha
    img = primal
    for _ in range(irls_iters if l1 else 1):
        if l1:
            wx = 1.0 / (torch.abs(_dx(img) - gx) + eps)
            wy = 1.0 / (torch.abs(_dy(img) - gy) + eps)
            w0 = 1.0 / (torch.abs(img - primal) + eps)
        else:
            wx, wy, w0 = (torch.ones_like(gx), torch.ones_like(gy),
                          torch.ones_like(primal))

        def A(v, wx=wx, wy=wy, w0=w0):
            return a2 * w0 * v + _dxT(wx * _dx(v)) + _dyT(wy * _dy(v))

        b = a2 * w0 * primal + _dxT(wx * gx) + _dyT(wy * gy)
        r = b - A(img)
        p, rz, x = r, (r * r).sum(), img
        for _ in range(iters):
            Ap = A(p)
            den = (p * Ap).sum()
            step = torch.where(den.abs() > 1e-30, rz / den,
                               torch.zeros_like(den))
            x = x + step * p
            r = r - step * Ap
            rz_new = (r * r).sum()
            beta = torch.where(rz > 1e-30, rz_new / rz, torch.zeros_like(rz))
            p, rz = r + beta * p, rz_new
        img = x
    return img
