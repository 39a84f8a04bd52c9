"""Film accumulation: masked scatter-add splatting + reconstruction
filters (mirrors gvpm_tpu/render/film.py).

The film is a dense [H,W,3] tensor and every splat is a batched
`index_put_(..., accumulate=True)`. Indices are clipped into the film
first and out-of-film samples carry weight 0, so nothing is dropped.
Filtered splats are a static (2R)^2-tap stencil per sample with a
separate weight plane for normalization (the ImageBlock weight
channel)."""

from __future__ import annotations

import math

import torch


def _add(image, yi, xi, v):
    return image.index_put_((yi, xi), v, accumulate=True)


def splat(image, px, py, value, mask=None):
    """Accumulate value [N,3] at pixel centers (px, py) floats; box filter.
    Adds into `image` in place and returns it."""
    H, W = image.shape[0], image.shape[1]
    xi = torch.clamp(torch.floor(px).to(torch.int64), 0, W - 1)
    yi = torch.clamp(torch.floor(py).to(torch.int64), 0, H - 1)
    ok = (px >= 0) & (px < W) & (py >= 0) & (py < H)
    if mask is not None:
        ok = ok & mask
    return _add(image, yi, xi, torch.where(ok[..., None], value, 0.0))


def splat_pixel(image, pix_x, pix_y, value, mask=None):
    """Accumulate at integer pixel coords (already per-pixel buffers)."""
    H, W = image.shape[0], image.shape[1]
    ok = (pix_x >= 0) & (pix_x < W) & (pix_y >= 0) & (pix_y < H)
    if mask is not None:
        ok = ok & mask
    return _add(image, torch.clamp(pix_y, 0, H - 1),
                torch.clamp(pix_x, 0, W - 1),
                torch.where(ok[..., None], value, 0.0))


def new_film(height, width, channels=3, device=None):
    return torch.zeros((height, width, channels), dtype=torch.float32,
                       device=device)


# --------------------------------------------------------------------------
# reconstruction filters (src/rfilters/*)

def _gaussian(x, stddev=0.5, radius=2.0):
    a = torch.exp(-0.5 * (x / stddev) ** 2)
    b = math.exp(-0.5 * (radius / stddev) ** 2)
    return torch.clamp(a - b, min=0.0)


def _tent(x, radius=1.0):
    return torch.clamp(1.0 - torch.abs(x) / radius, min=0.0)


def _mitchell_1d(x, B, C):
    x = torch.abs(x)
    x2, x3 = x * x, x * x * x
    inner = ((12 - 9 * B - 6 * C) * x3 + (-18 + 12 * B + 6 * C) * x2
             + (6 - 2 * B)) / 6.0
    outer = ((-B - 6 * C) * x3 + (6 * B + 30 * C) * x2
             + (-12 * B - 48 * C) * x + (8 * B + 24 * C)) / 6.0
    return torch.where(x < 1.0, inner, torch.where(x < 2.0, outer, 0.0))


def _lanczos(x, tau=3.0):
    x = torch.abs(x)
    px = math.pi * torch.clamp(x, min=1e-6)
    val = (torch.sin(px) / px) * (torch.sin(px / tau) / (px / tau))
    return torch.where(x < 1e-6, 1.0, torch.where(x < tau, val, 0.0))


# filter name -> (radius in pixels, weight fn of |x| <= radius)
FILTERS = {
    "box": (0.5, lambda x: torch.where(torch.abs(x) <= 0.5, 1.0, 0.0)),
    "tent": (1.0, _tent),
    "gaussian": (2.0, _gaussian),
    "mitchell": (2.0, lambda x: _mitchell_1d(x, 1 / 3, 1 / 3)),
    "catmullrom": (2.0, lambda x: _mitchell_1d(x, 0.0, 0.5)),
    "lanczos": (3.0, _lanczos),
}


def splat_filtered(image, wsum, px, py, value, rfilter="gaussian",
                   mask=None):
    """Filtered splat at continuous film positions (px, py).

    image: [H,W,3]; wsum: [H,W] filter-weight accumulator, both added
    into in place. Returns (image, wsum). Final image =
    image / max(wsum, eps)[..., None]. Separable 2D filter evaluated on a
    static (2R)^2 tap stencil.
    """
    radius, fw = FILTERS[rfilter]
    H, W = image.shape[0], image.shape[1]
    r_int = int(math.ceil(radius - 0.5))
    ok = (px >= 0) & (px < W) & (py >= 0) & (py < H)
    if mask is not None:
        ok = ok & mask
    xi0 = torch.floor(px - 0.5).to(torch.int64)
    yi0 = torch.floor(py - 0.5).to(torch.int64)
    for oy in range(-r_int, r_int + 1):
        for ox in range(-r_int, r_int + 1):
            xt = xi0 + ox
            yt = yi0 + oy
            wx = fw(xt.to(torch.float32) + 0.5 - px)
            wy = fw(yt.to(torch.float32) + 0.5 - py)
            inb = ok & (xt >= 0) & (xt < W) & (yt >= 0) & (yt < H)
            w = torch.where(inb, wx * wy, 0.0)
            yc = torch.clamp(yt, 0, H - 1)
            xc = torch.clamp(xt, 0, W - 1)
            _add(image, yc, xc, w[..., None] * value)
            _add(wsum, yc, xc, w)
    return image, wsum


def develop_filtered(image, wsum, eps=1e-8):
    return image / torch.clamp(wsum, min=eps)[..., None]


def relmse(img, ref, eps=1e-3):
    """Relative MSE as used by the reference's comparison scripts
    (scripts/results/msetools.py): mean((a-b)^2 / (ref^2 + eps))."""
    d = img - ref
    return float(torch.mean(d * d / (ref * ref + eps)))
