"""The Newton solve of the manifold (ME) shifts as one CUDA kernel launch
a shift call (csrc/me_newton.cu): integrators/manifold.py's `_newton3`
(volume and beam targets) and `_newton2` (surface target) call `solve`
for CUDA tensors and keep their plain PyTorch version for CPU ones.

  u, conv, rho_off, rho_base, aux = solve(target, scene, ch, c_target,
                                          n_iters, scene_scale, photon)

returns what the plain version returns (`manifold._newton3_plain` /
`_newton2_plain`). One thread solves one lane, its Jacobians carried as
forward-mode dual numbers in registers (csrc/me_newton.cuh). The kernel
reads the chain dict of `manifold.pull_chains` in place (slot-major
[K, L] int64 / bool / float32 entries) and writes tensors allocated
here; it adds no host synchronisation. The library is built with nvcc
at the first CUDA call into gvpm_tpu_torch/_build/ (ops/nvcc.py), with
the gather's flags (-fmad=false), and ptxas's report is kept beside it
(`build_report`).

Counters: LAUNCHES (launches a target, as fused_gather.LAUNCHES counts
its variants) and the StatsCounter `me/newton_lanes` (lanes the kernel
solved; manifold counts `me/newton_plain_lanes`, the plain version's).
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from ..core.logging import StatsCounter
from . import nvcc
from .fused_gather import NVCC_FLAGS

TARGETS = {"volume": 0, "beam": 1, "surface": 2}    # me::TARGET_*
LAUNCHES = dict.fromkeys(TARGETS, 0)
K_MAX = 3           # chain slots: me::K_MAX, integrators/manifold.K_MAX

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
_BUILD = os.path.join(os.path.dirname(_HERE), "_build")
SOURCES = ("me_newton.cu", "me_newton.cuh", "shift_math.cuh")

_P = ctypes.c_void_p


class In(ctypes.Structure):
    """gvpm::me::In (csrc/me_newton.cuh), field for field."""
    _fields_ = [("L", ctypes.c_longlong), ("target", ctypes.c_int),
                ("n_iters", ctypes.c_int)] + [
        (name, _P) for name in (
            "scale", "k", "prim", "enter", "refl", "eta", "diel",
            "anchor_p", "w1_base", "t_last", "c_target", "ph_prim",
            "ph_ns", "ph_enter", "tri_p0", "tri_e1", "tri_e2", "sph_c",
            "sph_r")] + [("n_tris", ctypes.c_longlong),
                         ("n_sph", ctypes.c_longlong)]


class Out(ctypes.Structure):
    """gvpm::me::Out (csrc/me_newton.cuh), field for field."""
    _fields_ = [(name, _P) for name in (
        "u", "conv", "rho_off", "rho_base", "ok_tr", "F", "len", "w1",
        "exit_d", "exit_p", "t_end", "jac0", "steps")]


def _ptr(t):
    return None if t is None else t.data_ptr()


def kernel_inputs(target, scene, ch, c_target, photon=None):
    """(name, tensor, dtype, shape) of everything the kernel reads."""
    K, L = ch["prim"].shape
    f32, i64, b = torch.float32, torch.int64, torch.bool
    T, S = scene.n_tris, scene.n_spheres
    rows = [("k", ch["k"], i64, (L,))]
    rows += [(n, ch[n], dt, (K, L)) for n, dt in (
        ("prim", i64), ("enter", b), ("branch_refl", b), ("eta", f32),
        ("is_diel", b))]
    rows += [("anchor_p", ch["anchor_p"], f32, (L, 3)),
             ("w1_base", ch["w1_base"], f32, (L, 3)),
             ("t_last", ch["t_last"], f32, (L,)),
             ("c_target", c_target, f32, (L, 3))]
    if target == "surface":
        prim, ns, enter = photon
        rows += [("photon_prim", prim, i64, (L,)),
                 ("photon_ns", ns, f32, (L, 3)),
                 ("photon_enter", enter, b, (L,))]
    rows += [("tri_p0", scene.tri_p0, f32, (T, 3)),
             ("tri_e1", scene.tri_e1, f32, (T, 3)),
             ("tri_e2", scene.tri_e2, f32, (T, 3)),
             ("sph_center", scene.sph_center, f32, (S, 3)),
             ("sph_radius", scene.sph_radius, f32, (S,))]
    return rows


def launch_args(target, scene, ch, c_target, n_iters, scale, photon=None,
                trace=False):
    """The kernel's argument structs for the tensors as they are, on
    whatever device they live (the CPU tests drive the same structs
    through a host build of csrc/me_newton.cuh), and the output tensors,
    allocated with torch.empty on c_target's device. `scale`: a float32
    tensor of one element; `trace` also asks for the first Jacobian
    (`jac0`, [L, N, N]) and the steps taken (`steps`, int32 bits).
    Returns (In, Out, outputs dict, kept tensors)."""
    K, L = ch["prim"].shape
    rows = {name: t for name, t, _, _ in kernel_inputs(target, scene, ch,
                                                       c_target, photon)}
    n = 2 if target == "surface" else 3
    dev = c_target.device

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = dict(u=empty(L, n), conv=empty(L, dtype=torch.bool),
               rho_off=empty(L), rho_base=empty(L),
               ok_tr=empty(L, dtype=torch.bool), F=empty(K, L),
               len=empty(K, L), w1=empty(L, 3), exit_d=empty(L, 3),
               exit_p=empty(L, 3) if target == "beam" else None,
               t_end=empty(L) if target == "surface" else None,
               jac0=empty(L, n, n) if trace else None,
               steps=empty(L, dtype=torch.int32) if trace else None)
    inp = In(L=L, target=TARGETS[target], n_iters=int(n_iters),
             scale=scale.data_ptr(), k=_ptr(rows["k"]),
             prim=_ptr(rows["prim"]), enter=_ptr(rows["enter"]),
             refl=_ptr(rows["branch_refl"]), eta=_ptr(rows["eta"]),
             diel=_ptr(rows["is_diel"]), anchor_p=_ptr(rows["anchor_p"]),
             w1_base=_ptr(rows["w1_base"]), t_last=_ptr(rows["t_last"]),
             c_target=_ptr(rows["c_target"]),
             ph_prim=_ptr(rows.get("photon_prim")),
             ph_ns=_ptr(rows.get("photon_ns")),
             ph_enter=_ptr(rows.get("photon_enter")),
             tri_p0=_ptr(rows["tri_p0"]), tri_e1=_ptr(rows["tri_e1"]),
             tri_e2=_ptr(rows["tri_e2"]), sph_c=_ptr(rows["sph_center"]),
             sph_r=_ptr(rows["sph_radius"]), n_tris=scene.n_tris,
             n_sph=scene.n_spheres)
    res = Out(**{name: _ptr(t) for name, t in out.items()})
    return inp, res, out, (scale, rows)


def results(target, out):
    """The outputs as the plain version returns them: (u, conv, rho_off,
    rho_base, aux), aux (ok_tr, F_off [L, K], len_off [L, K], w1_new
    [, exit point for the beam][, t_end for the surface], exit
    direction)."""
    mid = {"volume": (), "beam": (out["exit_p"],),
           "surface": (out["t_end"],)}[target]
    aux = (out["ok_tr"], out["F"].t(), out["len"].t(), out["w1"]) + mid \
        + (out["exit_d"],)
    return out["u"], out["conv"], out["rho_off"], out["rho_base"], aux


def check_inputs(target, scene, ch, c_target, photon=None):
    """Raises unless every input is a contiguous tensor of the kernel's
    dtype and shape on c_target's device."""
    dev = c_target.device
    if target not in TARGETS:
        raise ValueError(f"me_newton: no target {target!r}")
    if (target == "surface") != (photon is not None):
        raise ValueError("me_newton: the surface target, and only it, "
                         "takes the photon's (prim, ns, enter)")
    if ch["prim"].dim() != 2 or ch["prim"].shape[0] != K_MAX:
        raise ValueError(f"me_newton: the chain's prim must be "
                         f"[{K_MAX}, L]")
    for name, t, dt, shape in kernel_inputs(target, scene, ch, c_target,
                                            photon):
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"me_newton: {name} must be a contiguous "
                             f"{dt} tensor of shape {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def solve(target, scene, ch, c_target, n_iters, scene_scale, photon=None):
    """Launch the Newton solve of `target` ("volume", "beam" or
    "surface") for the lanes of chain dict `ch` toward c_target [L, 3] on
    PyTorch's current stream (no synchronize). scene_scale: a float or a
    tensor (the gathers pass the world diagonal as a float32 tensor on
    the card); photon: (prim [L], ns [L, 3], enter [L]) of the surface
    target. Raises on inputs the kernel does not take or a refused
    launch."""
    dev = c_target.device
    if dev.type != "cuda":
        raise ValueError(f"me_newton: the kernel runs on CUDA tensors, "
                         f"not on {dev}")
    check_inputs(target, scene, ch, c_target, photon)
    scale = torch.as_tensor(scene_scale, dtype=torch.float32,
                            device=dev).reshape(1)
    inp, res, out, _keep = launch_args(target, scene, ch, c_target, n_iters,
                                       scale, photon)
    L = inp.L
    if L:
        err = build().gvpm_me_newton(
            ctypes.byref(inp), ctypes.byref(res),
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"me_newton launch failed: CUDA error {err}")
        LAUNCHES[target] += 1
        StatsCounter.get("me/newton_lanes").add(L)
    return results(target, out)


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------

_LIB = {}
_LOCK = threading.Lock()


def build():
    """Compile csrc/me_newton.cu with nvcc into _build/ (once; ops/
    nvcc.py) and load it; returns the ctypes library."""
    with _LOCK:
        if "lib" not in _LIB:
            lib = ctypes.CDLL(nvcc.build_library(_CSRC, SOURCES, _BUILD,
                                                 NVCC_FLAGS, "me_newton"))
            lib.gvpm_me_newton.argtypes = [ctypes.POINTER(In),
                                           ctypes.POINTER(Out), _P]
            lib.gvpm_me_newton.restype = ctypes.c_int
            _LIB["lib"] = lib
        return _LIB["lib"]


def build_report():
    """ptxas's resources of the two instantiations: {"volume" (3
    unknowns, also the beam's), "surface" (2): dict(registers,
    spill_stores, spill_loads, stack, smem)}, bytes but for the
    registers per thread."""
    build()
    return {("surface" if "ILi2E" in name else "volume"): r
            for name, r in nvcc.build_report(_CSRC, SOURCES, _BUILD,
                                             NVCC_FLAGS).items()
            if "me_newton_kernel" in name}
