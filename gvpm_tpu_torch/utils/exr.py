"""Minimal OpenEXR 2.0 scanline I/O (uncompressed, float32 RGB; mirrors
gvpm_tpu/utils/exr.py and writes the same bytes).

The reference links the full OpenEXR library for Bitmap EXR I/O
(src/libcore/bitmap.cpp). The port depends on no OpenEXR package, so
this module implements the subset the renderer needs — single-part scanline
images, NO_COMPRESSION, FLOAT or HALF channels — directly against the
file format spec. Round-trips float32 exactly; reads HALF files by
widening.
"""

from __future__ import annotations

import struct

import numpy as np

_MAGIC = 20000630
_PIXELTYPE_HALF = 1
_PIXELTYPE_FLOAT = 2


def _attr(name: str, type_: str, data: bytes) -> bytes:
    return (name.encode() + b"\x00" + type_.encode() + b"\x00"
            + struct.pack("<i", len(data)) + data)


def _channel_list(names, pixel_type):
    out = b""
    for n in names:
        out += (n.encode() + b"\x00"
                + struct.pack("<i", pixel_type)   # pixel type
                + struct.pack("<i", 0)            # pLinear + reserved
                + struct.pack("<ii", 1, 1))       # x/y sampling
    return out + b"\x00"


def write_exr(path, img):
    """Write [H,W,3] float32 RGB as an uncompressed scanline EXR."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    H, W, _ = img.shape
    # channels are stored alphabetically: B, G, R
    header = b""
    header += _attr("channels", "chlist",
                    _channel_list(["B", "G", "R"], _PIXELTYPE_FLOAT))
    header += _attr("compression", "compression", struct.pack("<B", 0))
    dw = struct.pack("<iiii", 0, 0, W - 1, H - 1)
    header += _attr("dataWindow", "box2i", dw)
    header += _attr("displayWindow", "box2i", dw)
    header += _attr("lineOrder", "lineOrder", struct.pack("<B", 0))
    header += _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += _attr("screenWindowCenter", "v2f",
                    struct.pack("<ff", 0.0, 0.0))
    header += _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\x00"  # end of header

    preamble = struct.pack("<ii", _MAGIC, 2)  # magic + version 2
    offset_table_pos = len(preamble) + len(header)
    data_start = offset_table_pos + 8 * H
    line_bytes = 8 + 3 * 4 * W  # y + size + BGR float rows
    offsets = [data_start + y * line_bytes for y in range(H)]

    with open(path, "wb") as f:
        f.write(preamble)
        f.write(header)
        f.write(struct.pack(f"<{H}Q", *offsets))
        for y in range(H):
            f.write(struct.pack("<ii", y, 3 * 4 * W))
            # scanline layout: all B, then all G, then all R
            f.write(img[y, :, 2].tobytes())
            f.write(img[y, :, 1].tobytes())
            f.write(img[y, :, 0].tobytes())


def _read_attrs(buf, pos):
    attrs = {}
    while buf[pos] != 0:
        e = buf.index(b"\x00", pos)
        name = buf[pos:e].decode()
        pos = e + 1
        e = buf.index(b"\x00", pos)
        type_ = buf[pos:e].decode()
        pos = e + 1
        (size,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        attrs[name] = (type_, buf[pos:pos + size])
        pos += size
    return attrs, pos + 1


def read_exr(path):
    """Read an uncompressed scanline EXR -> [H,W,3] float32 (channels
    R,G,B; missing channels zero-filled; HALF widened to float)."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _MAGIC:
        raise ValueError("not an EXR file")
    if version & 0x200:
        raise NotImplementedError("tiled EXR not supported")
    attrs, pos = _read_attrs(buf, 8)

    ctype, cdata = attrs["channels"]
    channels = []  # (name, pixel_type) in file (alphabetical) order
    cpos = 0
    while cdata[cpos] != 0:
        e = cdata.index(b"\x00", cpos)
        name = cdata[cpos:e].decode()
        (ptype,) = struct.unpack_from("<i", cdata, e + 1)
        channels.append((name, ptype))
        cpos = e + 1 + 16
    (comp,) = struct.unpack_from("<B", attrs["compression"][1], 0)
    if comp != 0:
        raise NotImplementedError(f"compression {comp} not supported "
                                  "(write with NO_COMPRESSION)")
    x0, y0, x1, y1 = struct.unpack_from("<iiii", attrs["dataWindow"][1], 0)
    W, H = x1 - x0 + 1, y1 - y0 + 1

    pos += 8 * H  # skip the offset table (we read sequentially)
    per_px = {1: 2, 2: 4, 0: 4}
    out = {name: np.zeros((H, W), np.float32) for name, _ in channels}
    for _ in range(H):
        y, size = struct.unpack_from("<ii", buf, pos)
        pos += 8
        for name, ptype in channels:
            nb = per_px[ptype] * W
            raw = buf[pos:pos + nb]
            pos += nb
            if ptype == _PIXELTYPE_FLOAT:
                row = np.frombuffer(raw, "<f4")
            elif ptype == _PIXELTYPE_HALF:
                row = np.frombuffer(raw, "<f2").astype(np.float32)
            else:  # UINT
                row = np.frombuffer(raw, "<u4").astype(np.float32)
            out[name][y - y0] = row
    img = np.zeros((H, W, 3), np.float32)
    for i, ch in enumerate("RGB"):
        if ch in out:
            img[..., i] = out[ch]
        elif "Y" in out:  # luminance-only file
            img[..., i] = out["Y"]
    return img
