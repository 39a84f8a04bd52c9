"""Image I/O and metrics (the port's own copy of gvpm_tpu/utils/image.py;
numpy only).

PFM (lossless float), PNG via a tiny pure-python writer (tonemapped
previews). Metrics mirror scripts/results/msetools.py (relMSE) and
mtsutil addimages.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


# ----------------------------- PFM ----------------------------------------

def write_pfm(path, img):
    """img: [H,W,3] float32; PFM stores bottom-up."""
    img = np.asarray(img, np.float32)
    H, W, C = img.shape
    assert C == 3
    with open(path, "wb") as f:
        f.write(b"PF\n")
        f.write(f"{W} {H}\n".encode())
        f.write(b"-1.0\n")  # little endian
        f.write(np.flipud(img).tobytes())


def read_pfm(path):
    with open(path, "rb") as f:
        head = f.readline().strip()
        assert head in (b"PF", b"Pf"), head
        dims = f.readline().split()
        W, H = int(dims[0]), int(dims[1])
        scale = float(f.readline())
        count = W * H * (3 if head == b"PF" else 1)
        data = np.frombuffer(f.read(count * 4),
                             dtype="<f4" if scale < 0 else ">f4")
        img = data.reshape(H, W, -1)
        return np.flipud(img).copy()


# ----------------------------- PNG ----------------------------------------

def tonemap(img, exposure=1.0, gamma=2.2):
    """Simple gamma tonemap to uint8 (reference: mtsutil tonemap)."""
    x = np.clip(np.asarray(img, np.float32) * exposure, 0.0, None)
    x = np.clip(x ** (1.0 / gamma), 0.0, 1.0)
    return (x * 255.0 + 0.5).astype(np.uint8)


def write_png(path, rgb8):
    """Minimal PNG writer (8-bit RGB), no deps."""
    rgb8 = np.asarray(rgb8, np.uint8)
    H, W, C = rgb8.shape
    assert C == 3

    def chunk(tag, data):
        out = struct.pack(">I", len(data)) + tag + data
        crc = zlib.crc32(tag + data) & 0xFFFFFFFF
        return out + struct.pack(">I", crc)

    raw = b"".join(b"\x00" + rgb8[r].tobytes() for r in range(H))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


# ----------------------------- metrics ------------------------------------

def relmse(img, ref, eps=1e-3):
    """mean((a-b)^2/(ref^2+eps)) — scripts/results/msetools.py."""
    a = np.asarray(img, np.float64)
    b = np.asarray(ref, np.float64)
    d = a - b
    return float(np.mean(d * d / (b * b + eps)))


def mse(img, ref):
    d = np.asarray(img, np.float64) - np.asarray(ref, np.float64)
    return float(np.mean(d * d))


def nan_scrub(img):
    """Replace NaN/Inf with zeros (gvpm.cpp:580-607 nanCheck analog).

    Returns (clean image, count of scrubbed entries)."""
    arr = np.asarray(img)
    bad = ~np.isfinite(arr)
    out = np.where(bad, 0.0, arr)
    return out, int(bad.sum())
