"""Fused photon gather over exact cell runs — the counterpart of
gvpm_tpu/ops/pallas_gather.py.

Queries (gather points or camera-medium distance samples) are sorted by
their 3x3x3-stencil anchor cell. Each query's stencil is nine
contiguous row runs [r0, r1) of the cell-sorted photon row table; every
(query, row) pair of those runs goes through an eval body (the ball
test, the base kernel term and the four reconnection shifts) and the
per-pair terms are summed per query. Unlike the TPU kernel there is no
window and no clipping: `scale` is 1 and `dropped` is 0.

  plan = plan_runs(grid, x, q_valid)
  out  = fused_gather(ev, plan, table_T, qrows, r2, k3, min_depth)
  res  = unsort(plan, out)

`fused_gather` launches the CUDA kernel (csrc/fused_gather.cu) for CUDA
tensors and takes the plain PyTorch version (`fused_gather_plain`) only
for CPU tensors. The kernel is built with nvcc at first use into
gvpm_tpu_torch/_build/, keyed by a hash of its sources.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import subprocess
import threading

import torch

from .cellgrid import CellGrid, anchor_ids27

N_RUNS = 9
# 27-stencil: nine (dy, dz) runs of three x-consecutive cells each
RUN_OFFS_27 = [(dy, dz) for dz in range(3) for dy in range(3)]
N_ACC = 29      # accumulated columns: primal 3, S 12, W 12, visits, ok
PLAIN_MAX_PAIRS = 1 << 20   # candidate pairs per chunk of the plain version
# kernel launches per eval, counted by the wrapper where it launches
LAUNCHES = {"surface": 0, "volume": 0}

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
_BUILD = os.path.join(os.path.dirname(_HERE), "_build")
SOURCES = ("fused_gather.cu", "gather_eval.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false")


@dataclasses.dataclass
class GatherEval:
    """One eval body of the fused gather: its name (the launch-counter
    key and the C launcher's suffix), its query-row and photon-row slot
    layouts, its query-row width, its output width and its plain
    per-pair function."""
    name: str
    q_slots: dict
    q_width: int
    row_slots: dict
    n_out: int
    pair_fn: object    # (q, r, min_depth, r2, k3) -> N_ACC pair planes


@dataclasses.dataclass
class Plan:
    order: torch.Tensor   # [Q] original query index of each sorted slot
    r0: torch.Tensor      # [Q, 9] int32 run starts (sorted order)
    r1: torch.Tensor      # [Q, 9] int32 run ends


def plan_runs(grid: CellGrid, x, q_valid):
    """Sort queries by 27-stencil anchor and derive each query's nine
    exact run bounds; invalid queries sort last with empty runs
    (pallas_gather.py:111-144 without the tile windows)."""
    Nx, Ny, Nz = grid.dims
    n_cells = Nx * Ny * Nz
    aid = torch.where(q_valid, anchor_ids27(grid, x), n_cells)
    order = torch.argsort(aid, stable=True)
    vq = q_valid[order]
    run_off = torch.tensor([(dz * Ny + dy) * Nx for dy, dz in RUN_OFFS_27],
                           device=x.device)
    s = torch.clamp(aid[order][:, None] + run_off[None, :], 0, n_cells - 3)
    r0 = grid.bucket_start[s]
    r1 = grid.bucket_start[s + 3]
    r0 = torch.where(vq[:, None], r0, 0)
    r1 = torch.where(vq[:, None], torch.maximum(r1, r0), 0)
    return Plan(order=order, r0=r0.to(torch.int32).contiguous(),
                r1=r1.to(torch.int32).contiguous())


def unsort(plan: Plan, flat):
    """[Q, k] sorted-order output -> original query order."""
    out = torch.zeros_like(flat)
    out[plan.order] = flat
    return out


class _Cols:
    """Named pair-plane access: column `slot + j` of `table` (an
    [F, ...] feature-major tensor) gathered at `idx`, memoised."""

    def __init__(self, table, idx, slots):
        self.table, self.idx, self.slots = table, idx, slots
        self.cache = {}

    def col(self, k):
        if k not in self.cache:
            self.cache[k] = self.table[k][self.idx]
        return self.cache[k]

    def f3(self, name):
        k = self.slots[name]
        return (self.col(k), self.col(k + 1), self.col(k + 2))

    def f1(self, name):
        return self.col(self.slots[name])

    def i1(self, name):
        return self.f1(name).to(torch.int64)

    def b1(self, name):
        return self.f1(name) > 0.5


def fused_gather_plain(ev: GatherEval, plan: Plan, table_T, qrows, r2, k3,
                       min_depth):
    """The plain PyTorch version: flatten the (query, row) candidate
    pairs of each query chunk with repeat_interleave over run lengths,
    evaluate them with the planar helpers and index_add_ into [Q, n_out]
    (sorted order). Chunks hold at most ~PLAIN_MAX_PAIRS pairs."""
    Q = qrows.shape[0]
    dev = qrows.device
    out = torch.zeros((Q, ev.n_out), dtype=torch.float32, device=dev)
    if Q == 0:
        return out
    lens = (plan.r1 - plan.r0).to(torch.int64)             # [Q, 9]
    cum = torch.cumsum(lens.sum(1), 0)
    qT = qrows.t()
    s = 0
    while s < Q:
        base = int(cum[s - 1]) if s else 0
        e = int(torch.searchsorted(cum, base + PLAIN_MAX_PAIRS,
                                   right=True))
        e = min(max(e, s + 1), Q)
        ln = lens[s:e].reshape(-1)
        run = torch.repeat_interleave(
            torch.arange(ln.shape[0], device=dev), ln)
        if run.numel():
            first = torch.cumsum(ln, 0) - ln
            pos = torch.arange(run.shape[0], device=dev) - first[run]
            row = plan.r0[s:e].reshape(-1).to(torch.int64)[run] + pos
            qi = run // N_RUNS
            q = _Cols(qT, s + qi, ev.q_slots)
            r = _Cols(table_T, row, ev.row_slots)
            acc = torch.stack(ev.pair_fn(q, r, min_depth, r2, k3), dim=1)
            out[s:e, :N_ACC].index_add_(0, qi, acc)
        s = e
    return out


def fused_gather(ev: GatherEval, plan: Plan, table_T, qrows, r2, k3,
                 min_depth):
    """Run eval `ev` over every (query, row) pair of the planned runs.

    table_T [F, P] float32 feature-major photon rows; qrows [Q, FQ]
    float32 per-query fields IN SORTED ORDER; r2/k3: float scalars (the
    volume eval's ball radius^2 and 3D kernel norm). Returns [Q, n_out]
    in sorted order: primal 3, S 4x3, W 4x3, visits, shift_ok, dropped.
    CUDA tensors launch the kernel; CPU tensors take the plain version.
    """
    if table_T.device.type == "cpu":
        return fused_gather_plain(ev, plan, table_T, qrows, r2, k3,
                                  min_depth)
    return launch_kernel(ev, plan, table_T, qrows, r2, k3, min_depth)


# ---------------------------------------------------------------------------
# the CUDA kernel: build, load, launch
# ---------------------------------------------------------------------------

_LIB = {}
_LOCK = threading.Lock()


def build():
    """Compile csrc/ with nvcc into _build/<source hash>/ (once) and load
    it; returns the ctypes library."""
    with _LOCK:
        if "lib" in _LIB:
            return _LIB["lib"]
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for name in SOURCES:
            with open(os.path.join(_CSRC, name), "rb") as f:
                h.update(f.read())
        out_dir = os.path.join(_BUILD, h.hexdigest()[:16])
        so = os.path.join(out_dir, "libfused_gather.so")
        if not os.path.exists(so):
            os.makedirs(out_dir, exist_ok=True)
            nvcc = os.path.join(os.environ.get("CUDA_HOME",
                                               "/usr/local/cuda"),
                                "bin", "nvcc")
            tmp = so + f".{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
                   os.path.join(_CSRC, "fused_gather.cu")]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError("nvcc failed:\n" + res.stderr)
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        vp, i64, f32, i32 = (ctypes.c_void_p, ctypes.c_longlong,
                             ctypes.c_float, ctypes.c_int)
        for name in ("volume", "surface"):
            fn = getattr(lib, f"gvpm_fused_gather_{name}")
            fn.argtypes = [vp, i64, vp, vp, vp, i64, f32, f32, i32, vp, vp]
            fn.restype = ctypes.c_int
        _LIB["lib"] = lib
        return lib


def launch_kernel(ev: GatherEval, plan: Plan, table_T, qrows, r2, k3,
                  min_depth):
    """Launch the CUDA kernel for eval `ev` on PyTorch's current stream;
    raises on bad inputs or a refused launch."""
    dev = table_T.device
    if dev.type != "cuda":
        raise ValueError(f"fused_gather: the kernel runs on CUDA tensors, "
                         f"not on {dev}")
    Q = qrows.shape[0]
    for name, t, dt in (("table_T", table_T, torch.float32),
                        ("qrows", qrows, torch.float32),
                        ("r0", plan.r0, torch.int32),
                        ("r1", plan.r1, torch.int32)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"fused_gather: {name} must be a contiguous "
                             f"{dt} tensor on {dev}")
    if qrows.shape[1] != ev.q_width or plan.r0.shape != (Q, N_RUNS):
        raise ValueError("fused_gather: query rows / plan shape mismatch")
    out = torch.empty((Q, ev.n_out), dtype=torch.float32, device=dev)
    if Q == 0:
        return out
    lib = build()
    fn = getattr(lib, f"gvpm_fused_gather_{ev.name}")
    err = fn(table_T.data_ptr(), table_T.shape[1], qrows.data_ptr(),
             plan.r0.data_ptr(), plan.r1.data_ptr(), Q, float(r2),
             float(k3), int(min_depth), out.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_gather_{ev.name} launch failed: "
                           f"CUDA error {err}")
    LAUNCHES[ev.name] += 1
    return out
