"""Mesh loaders: OBJ, PLY, Mitsuba .serialized (mirrors
gvpm_tpu/utils/meshio.py).

Replaces the reference's mesh ingestion (src/shapes/{obj,ply,serialized}
.cpp) for scene loading. OBJ files go through the native C++ parser
(gvpm_tpu_torch/native, built with g++ at first use; a failed build
raises), as the JAX package's do where its library builds; PLY and
.serialized are parsed in numpy.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def load_obj(path):
    """Wavefront OBJ -> (vertices [V,3], faces [F,3] int, normals|None).

    Supports v/vn/f with polygon fan triangulation and negative indices.
    """
    from ..native import bind
    return bind.load_obj(path)


def load_ply(path):
    """Binary/ascii PLY -> (vertices, faces, normals|None)."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError("not a PLY file")
        fmt = None
        n_vert = n_face = 0
        vert_props = []
        in_vertex = False
        while True:
            line = f.readline().strip()
            if line == b"end_header":
                break
            t = line.split()
            if t[0] == b"format":
                fmt = t[1].decode()
            elif t[0] == b"element":
                in_vertex = t[1] == b"vertex"
                if in_vertex:
                    n_vert = int(t[2])
                elif t[1] == b"face":
                    n_face = int(t[2])
            elif t[0] == b"property" and in_vertex:
                vert_props.append((t[-1].decode(), t[1].decode()))

        tmap = {"float": "f4", "float32": "f4", "double": "f8",
                "uchar": "u1", "uint8": "u1", "int": "i4", "uint": "u4",
                "short": "i2", "ushort": "u2", "char": "i1"}
        if fmt == "ascii":
            rows = [f.readline().split() for _ in range(n_vert)]
            names = [p[0] for p in vert_props]
            arr = np.array(rows, np.float64)
            data = {n: arr[:, i] for i, n in enumerate(names)}
            faces = []
            for _ in range(n_face):
                t = f.readline().split()
                idx = [int(x) for x in t[1:1 + int(t[0])]]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
        else:
            endian = "<" if "little" in fmt else ">"
            dt = np.dtype([(n, endian + tmap[t]) for n, t in vert_props])
            raw = np.frombuffer(f.read(dt.itemsize * n_vert), dt)
            data = {n: raw[n].astype(np.float64) for n, _ in vert_props}
            faces = []
            for _ in range(n_face):
                cnt = struct.unpack(endian + "B", f.read(1))[0]
                idx = struct.unpack(endian + "i" * cnt, f.read(4 * cnt))
                for k in range(1, cnt - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
        v = np.stack([data["x"], data["y"], data["z"]], -1).astype(np.float32)
        vn = None
        if "nx" in data:
            vn = np.stack([data["nx"], data["ny"], data["nz"]],
                          -1).astype(np.float32)
        return v, np.asarray(faces, np.int64), vn


# Mitsuba .serialized flags (reference: src/shapes/serialized.cpp)
MTS_HAS_NORMALS = 0x0001
MTS_HAS_TEXCOORDS = 0x0002
MTS_HAS_COLORS = 0x0008
MTS_FACE_NORMALS = 0x0010
MTS_SINGLE_PRECISION = 0x1000
MTS_DOUBLE_PRECISION = 0x2000


def load_serialized(path, shape_index=0):
    """Mitsuba .serialized mesh -> (vertices [V,3], faces [F,3])."""
    with open(path, "rb") as f:
        blob = f.read()
    magic, version = struct.unpack("<HH", blob[:4])
    if magic != 0x041C:
        raise ValueError("not a Mitsuba serialized mesh")
    # locate shape offsets: trailing uint32 count + offset table
    (count,) = struct.unpack("<I", blob[-4:])
    if shape_index >= count:
        raise IndexError(shape_index)
    off_size = 8 if version >= 4 else 4
    table = blob[-4 - off_size * count:-4]
    fmtc = "<" + ("Q" if off_size == 8 else "I") * count
    offsets = struct.unpack(fmtc, table)
    start = offsets[shape_index] + 4  # skip per-shape magic+version
    end = offsets[shape_index + 1] if shape_index + 1 < count \
        else len(blob) - 4 - off_size * count
    data = zlib.decompress(blob[start:end])
    pos = 0

    def take(fmt):
        nonlocal pos
        size = struct.calcsize(fmt)
        out = struct.unpack_from("<" + fmt, data, pos)
        pos += size
        return out

    (flags,) = take("I")
    if version >= 4:  # null-terminated name
        z = data.index(b"\x00", pos)
        pos = z + 1
    n_vert, n_tri = take("QQ")
    fdt = np.float64 if flags & MTS_DOUBLE_PRECISION else np.float32
    fsz = 8 if flags & MTS_DOUBLE_PRECISION else 4
    v = np.frombuffer(data, fdt, n_vert * 3, pos).reshape(-1, 3)
    pos += n_vert * 3 * fsz
    if flags & MTS_HAS_NORMALS:
        pos += n_vert * 3 * fsz
    if flags & MTS_HAS_TEXCOORDS:
        pos += n_vert * 2 * fsz
    if flags & MTS_HAS_COLORS:
        pos += n_vert * 3 * fsz
    idt = np.uint64 if n_vert > 0xFFFFFFFF else np.uint32
    fcs = np.frombuffer(data, idt, n_tri * 3, pos).reshape(-1, 3)
    return (np.ascontiguousarray(v, np.float32),
            np.ascontiguousarray(fcs, np.int64))
