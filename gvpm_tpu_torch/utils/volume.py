"""Mitsuba .vol grid-volume binary format I/O (mirrors
gvpm_tpu/utils/volume.py and writes the same bytes).

reference: src/volume/gridvolume.cpp (format: 'VOL' magic, version 3,
encoding int32 (1 = float32), xres/yres/zres int32, channels int32,
bbox 6 floats, then xres*yres*zres*channels float32 data in x-fastest
order)."""

from __future__ import annotations

import struct

import numpy as np


def read_vol(path):
    """Read a .vol file -> (density [Gx,Gy,Gz] float32, lo [3], hi [3]).

    Multi-channel volumes are collapsed to their channel mean (the
    renderer's heterogeneous medium is scalar density x RGB scale)."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:3] != b"VOL":
        raise ValueError("not a .vol file")
    version = buf[3]
    if version != 3:
        raise NotImplementedError(f".vol version {version}")
    enc, xr, yr, zr, ch = struct.unpack_from("<iiiii", buf, 4)
    if enc != 1:
        raise NotImplementedError(f".vol encoding {enc} (want float32)")
    lo = np.array(struct.unpack_from("<fff", buf, 24), np.float32)
    hi = np.array(struct.unpack_from("<fff", buf, 36), np.float32)
    data = np.frombuffer(buf, "<f4", count=xr * yr * zr * ch, offset=48)
    grid = data.reshape(zr, yr, xr, ch).mean(axis=-1)
    # -> [Gx,Gy,Gz] indexing
    return np.ascontiguousarray(grid.transpose(2, 1, 0)), lo, hi


def write_vol(path, density, lo, hi):
    """Write density [Gx,Gy,Gz] as a single-channel .vol file."""
    density = np.asarray(density, np.float32)
    gx, gy, gz = density.shape
    with open(path, "wb") as f:
        f.write(b"VOL" + bytes([3]))
        f.write(struct.pack("<iiiii", 1, gx, gy, gz, 1))
        f.write(struct.pack("<ffffff", *np.asarray(lo, np.float32),
                            *np.asarray(hi, np.float32)))
        f.write(np.ascontiguousarray(
            density.transpose(2, 1, 0)).tobytes())
