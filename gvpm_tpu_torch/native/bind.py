"""ctypes bindings for the native host library (host_ops.cpp; mirrors
gvpm_tpu/native/bind.py).

g++ builds libgvpmhost.so at first use under
gvpm_tpu_torch/_build/<hash of the flags and the source>/, never in the
package directory. A failed build raises: nothing carries on on another
path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time

import numpy as np

from ..core.logging import count_build, span

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "host_ops.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_LIB = None


class _ObjMesh(ctypes.Structure):
    _fields_ = [("verts", ctypes.POINTER(ctypes.c_float)),
                ("normals", ctypes.POINTER(ctypes.c_float)),
                ("faces", ctypes.POINTER(ctypes.c_int64)),
                ("n_verts", ctypes.c_int64),
                ("n_faces", ctypes.c_int64),
                ("has_normals", ctypes.c_int)]


class _BvhNode(ctypes.Structure):
    _fields_ = [("lo", ctypes.c_float * 3), ("hi", ctypes.c_float * 3),
                ("left", ctypes.c_int32), ("right", ctypes.c_int32),
                ("first", ctypes.c_int32), ("count", ctypes.c_int32)]


class _Bvh(ctypes.Structure):
    _fields_ = [("nodes", ctypes.POINTER(_BvhNode)),
                ("order", ctypes.POINTER(ctypes.c_int32)),
                ("n_nodes", ctypes.c_int32), ("n_prims", ctypes.c_int32)]


def library_path():
    """Where the build of the current source and flags lives."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, h.hexdigest()[:16], "libgvpmhost.so")


def build():
    """Compile host_ops.cpp unless its build exists; returns the path.
    Raises RuntimeError with g++'s messages if the build fails. The span
    `build`; counted in the build/* counters (core.logging.count_build)."""
    with span("build"):
        t0 = time.perf_counter()
        so = library_path()
        compile_it = not os.path.exists(so)
        if compile_it:
            os.makedirs(os.path.dirname(so), exist_ok=True)
            tmp = so + f".{os.getpid()}.tmp"
            res = subprocess.run(["g++", *FLAGS, _SRC, "-o", tmp],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError("g++ failed to build host_ops.cpp:\n"
                                   + res.stderr)
            os.replace(tmp, so)
        count_build(compile_it, time.perf_counter() - t0)
    return so


def _load():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        lib.gv_load_obj.restype = ctypes.POINTER(_ObjMesh)
        lib.gv_load_obj.argtypes = [ctypes.c_char_p]
        lib.gv_free_obj.argtypes = [ctypes.POINTER(_ObjMesh)]
        lib.gv_build_bvh.restype = ctypes.POINTER(_Bvh)
        lib.gv_build_bvh.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int32, ctypes.c_int32]
        lib.gv_free_bvh.argtypes = [ctypes.POINTER(_Bvh)]
        lib.gv_morton_sort.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32)]
        _LIB = lib
    return _LIB


def load_obj(path):
    """Fast OBJ parse -> (verts [V,3] f32, faces [F,3] i64, vn|None)."""
    lib = _load()
    m = lib.gv_load_obj(os.fsencode(path))
    if not m:
        raise IOError(f"cannot open {path}")
    try:
        mm = m.contents
        v = np.ctypeslib.as_array(mm.verts, (mm.n_verts, 3)).copy()
        f = np.ctypeslib.as_array(mm.faces, (mm.n_faces, 3)).copy()
        vn = None
        if mm.has_normals:
            vn = np.ctypeslib.as_array(mm.normals, (mm.n_verts, 3)).copy()
        return v, f, vn
    finally:
        lib.gv_free_obj(m)


def build_bvh(tri_lo, tri_hi, leaf_size=4):
    """Binned-SAH BVH -> dict of flat numpy arrays.

    Returns {node_lo [N,3], node_hi [N,3], left [N], right [N],
    first [N], count [N], order [P]} with left-child indices, -1 = leaf.
    """
    lib = _load()
    lo = np.ascontiguousarray(tri_lo, np.float32)
    hi = np.ascontiguousarray(tri_hi, np.float32)
    b = lib.gv_build_bvh(
        lo.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        hi.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        lo.shape[0], leaf_size)
    try:
        bb = b.contents
        nn = bb.n_nodes
        raw = np.ctypeslib.as_array(
            ctypes.cast(bb.nodes, ctypes.POINTER(ctypes.c_float)),
            (nn, 10)).copy()
        as_int = raw.view(np.int32)
        return dict(
            node_lo=raw[:, 0:3].copy(), node_hi=raw[:, 3:6].copy(),
            left=as_int[:, 6].copy(), right=as_int[:, 7].copy(),
            first=as_int[:, 8].copy(), count=as_int[:, 9].copy(),
            order=np.ctypeslib.as_array(bb.order, (bb.n_prims,)).copy())
    finally:
        lib.gv_free_bvh(b)


def morton_order(points, lo, hi):
    """Morton-code permutation of points [P,3]."""
    lib = _load()
    p = np.ascontiguousarray(points, np.float32)
    lo = np.ascontiguousarray(lo, np.float32)
    hi = np.ascontiguousarray(hi, np.float32)
    out = np.empty(p.shape[0], np.int32)
    lib.gv_morton_sort(
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), p.shape[0],
        lo.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        hi.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out
