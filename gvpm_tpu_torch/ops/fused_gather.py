"""Fused photon gather over exact cell runs — the counterpart of
gvpm_tpu/ops/pallas_gather.py.

Queries (gather points or camera-medium distance samples) are sorted by
their 3x3x3-stencil anchor cell. Each query's stencil is nine
contiguous row runs [r0, r1) of the cell-sorted photon row table; every
(query, row) pair of those runs goes through an eval body (the ball
test, the base kernel term and the four reconnection shifts) and the
per-pair terms are summed per query. Unlike the TPU kernel there is no
window and no clipping: `scale` is 1 and `dropped` is 0. An eval with
`me` set also reports, per query, the lowest table row of a pair that is
eligible for a manifold (ME) shift, as an int32 key (ME_NONE: no such
pair).

  plan = plan_runs(grid, x, q_valid)
  out, me_row = fused_gather(ev, plan, table, qrows, r2, k3, min_depth)
  res = unsort(plan, out)

`table` is the row-major [P, F] row table as `pack_photons` makes it.
`fused_gather` launches the CUDA kernel (csrc/fused_gather.cu) for CUDA
tensors and takes the plain PyTorch version (`fused_gather_plain`) only
for CPU tensors. The kernel's ball tests read an 8-float head of each
row (`row_heads`), which each launch first copies out of the table; its
shift bodies read the rows themselves. The kernel is built
with nvcc at first use into gvpm_tpu_torch/_build/ (ops/nvcc.py), and
ptxas's resource report is kept beside it (`build_report`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import threading

import torch

from . import nvcc
from .cellgrid import CellGrid, anchor_ids27

N_RUNS = 9
# 27-stencil: nine (dy, dz) runs of three x-consecutive cells each
RUN_OFFS_27 = [(dy, dz) for dz in range(3) for dy in range(3)]
N_ACC = 29      # accumulated columns: primal 3, S 12, W 12, visits, ok
ROW_LOAD = 56   # floats of each table row the kernel loads (R_LOAD)
TILE_Q = 8      # sorted queries per warp tile of the kernel (Shape::TQ)
# a row's head: (field, floats, slot the kernel's row_heads_kernel reads)
HEAD_FIELDS = (("p", 3, 0), ("vtype", 1, 44), ("wi", 3, 3), ("depth", 1, 47))
ME_NONE = 2 ** 31 - 1       # ME row key of a query without an ME pair
PLAIN_MAX_PAIRS = 1 << 20   # candidate pairs per chunk of the plain version
# kernel launches per eval, counted by the wrapper where it launches
LAUNCHES = {"surface": 0, "volume": 0, "surface_me": 0, "volume_me": 0}

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
_BUILD = os.path.join(os.path.dirname(_HERE), "_build")
SOURCES = ("fused_gather.cu", "gather_eval.cuh", "shift_math.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v")


@dataclasses.dataclass
class GatherEval:
    """One eval body of the fused gather: its name (the launch-counter
    key and the C launcher's suffix), its query-row and photon-row slot
    layouts, its query-row width, its output width, its plain per-pair
    function and whether it also reports the ME row key."""
    name: str
    q_slots: dict
    q_width: int
    row_slots: dict
    n_out: int
    pair_fn: object    # (q, r, min_depth, r2, k3, me) -> N_ACC pair
                       # planes (+ the bool ME-eligibility plane if me)
    me: bool = False


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
    """Named pair-plane access: column `slot + j` of `table` (a row-major
    [N, F] tensor) gathered at rows `idx`, memoised."""

    def __init__(self, table, idx, slots):
        self.table, self.idx, self.slots = table, idx, slots
        self.cache = {}

    def col(self, k):
        if k not in self.cache:
            self.cache[k] = self.table[self.idx, k]
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


def fused_gather_plain(ev: GatherEval, plan: Plan, table, qrows, r2, k3,
                       min_depth):
    """The plain PyTorch version: flatten the (query, row) candidate
    pairs of each query chunk with repeat_interleave over run lengths,
    evaluate them with the planar helpers and index_add_ into [Q, n_out]
    (sorted order); an ME eval's row key is an amin scatter-reduce of the
    eligible pairs' rows. Chunks hold whole queries and at most
    ~PLAIN_MAX_PAIRS pairs. Returns (out, me_row or None)."""
    Q = qrows.shape[0]
    dev = qrows.device
    out = torch.zeros((Q, ev.n_out), dtype=torch.float32, device=dev)
    me_row = torch.full((Q,), ME_NONE, dtype=torch.int64, device=dev) \
        if ev.me else None
    for s, e, run, row in candidate_chunks(plan):
        qi = run // N_RUNS
        q = _Cols(qrows, s + qi, ev.q_slots)
        r = _Cols(table, row, ev.row_slots)
        planes = ev.pair_fn(q, r, min_depth, r2, k3, ev.me)
        out[s:e, :N_ACC].index_add_(
            0, qi, torch.stack(planes[:N_ACC], dim=1))
        if ev.me:
            me_row[s:e].scatter_reduce_(
                0, qi, torch.where(planes[N_ACC], row, ME_NONE), "amin")
    return out, _me_key(me_row)


def candidate_chunks(plan: Plan):
    """The candidate (query, row) pairs of a plan, in chunks of whole
    queries that hold at most ~PLAIN_MAX_PAIRS pairs: yields (s, e, run,
    row) with [s, e) the chunk's sorted queries, run [n] each pair's run
    counted from run 0 of query s (so its query is s + run // 9) and
    row [n] its table row, run by run in row order."""
    Q = plan.r0.shape[0]
    dev = plan.r0.device
    lens = (plan.r1 - plan.r0).to(torch.int64)             # [Q, 9]
    cum = torch.cumsum(lens.sum(1), 0)
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
            yield s, e, run, row
        s = e


def _me_key(me_row):
    return None if me_row is None else me_row.to(torch.int32)


def slots_read(ev: GatherEval, min_depth):
    """The (photon-row slots, query-row slots) that eval `ev` reads, as
    two sorted lists of column indices: its pair function is run on one
    dummy pair and the columns it touched are collected. They follow the
    body (its `me` tail and the min_depth test included), not the padded
    row widths; csrc/gather_eval.cuh reads the same slots."""
    one = torch.zeros((1,), dtype=torch.int64)
    q = _Cols(torch.zeros((1, ev.q_width)), one, ev.q_slots)
    r = _Cols(torch.zeros((1, max(ev.row_slots.values()) + 1)), one,
              ev.row_slots)
    ev.pair_fn(q, r, min_depth, 1.0, 1.0, ev.me)
    return sorted(r.cache), sorted(q.cache)


def row_heads(ev: GatherEval, table):
    """[2, P, 4] float32: what the kernel's ball tests read of each row,
    bit for bit the table's slots, as two planes: (position, vertex
    type) and (incoming direction, depth) -- HeadSlot in
    csrc/gather_eval.cuh. Every kernel launch fills its own copy on the
    card; this function is that step alone (the plain version for CPU
    tensors, the launch's row_heads_kernel for CUDA tensors)."""
    if table.device.type == "cpu":
        cols = [table[:, ev.row_slots[n]:ev.row_slots[n] + w]
                for n, w, _ in HEAD_FIELDS]
        return torch.stack((torch.cat(cols[:2], 1), torch.cat(cols[2:], 1)))
    _check_table(ev, table)
    head = torch.empty((2, table.shape[0], 4), dtype=torch.float32,
                       device=table.device)
    err = build().gvpm_row_heads(
        table.data_ptr(), head.data_ptr(), *table.shape,
        torch.cuda.current_stream(table.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"row_heads launch failed: CUDA error {err}")
    return head


def fused_gather(ev: GatherEval, plan: Plan, table, qrows, r2, k3,
                 min_depth):
    """Run eval `ev` over every (query, row) pair of the planned runs.

    table [P, F] float32 row-major photon rows; qrows [Q, FQ] float32
    per-query fields IN SORTED ORDER; r2/k3: float scalars (the volume
    eval's ball radius^2 and 3D kernel norm). Returns (out, me_row) in
    sorted order: out [Q, n_out] holds primal 3, S 4x3, W 4x3, visits,
    shift_ok, dropped; me_row is None unless `ev.me`, then int32 [Q]: the
    lowest row of `table` among the query's ME-eligible pairs, ME_NONE
    where it has none. CUDA tensors launch the kernel; CPU tensors take
    the plain version.
    """
    if table.device.type == "cpu":
        return fused_gather_plain(ev, plan, table, qrows, r2, k3, min_depth)
    return launch_kernel(ev, plan, table, qrows, r2, k3, min_depth)


# ---------------------------------------------------------------------------
# the CUDA kernel: build, load, launch
# ---------------------------------------------------------------------------

_LIB = {}
_LOCK = threading.Lock()


def build():
    """Compile csrc/fused_gather.cu with nvcc into _build/ (once; ops/
    nvcc.py) and load it; returns the ctypes library."""
    with _LOCK:
        if "lib" in _LIB:
            return _LIB["lib"]
        lib = ctypes.CDLL(nvcc.build_library(_CSRC, SOURCES, _BUILD,
                                             NVCC_FLAGS, "fused_gather"))
        vp, i64, f32, i32 = (ctypes.c_void_p, ctypes.c_longlong,
                             ctypes.c_float, ctypes.c_int)
        for name in LAUNCHES:
            fn = getattr(lib, f"gvpm_fused_gather_{name}")
            fn.argtypes = [vp, vp, i64, i64, vp, vp, vp, i64, f32, f32, i32,
                           vp] + [vp] * (1 + name.endswith("_me"))
            fn.restype = ctypes.c_int
        lib.gvpm_row_heads.argtypes = [vp, vp, i64, i64, vp]
        lib.gvpm_row_heads.restype = ctypes.c_int
        _LIB["lib"] = lib
        return lib


def build_report():
    """ptxas's resources of the four fused_gather_kernel<Eval, ME>
    instantiations of the built library: {eval name: dict(registers,
    spill_stores, spill_loads, stack, smem)}, bytes but for the
    registers per thread."""
    build()
    return {("volume" if "VolumeEval" in name else "surface")
            + ("_me" if "Lb1" in name else ""): r
            for name, r in nvcc.build_report(_CSRC, SOURCES, _BUILD,
                                             NVCC_FLAGS).items()
            if "fused_gather_kernel" in name}


def _check_table(ev: GatherEval, table):
    """Raises unless `table` is what the kernels index: contiguous 2-d
    float32 on a CUDA device, rows of at least ROW_LOAD floats (the body
    loads that many as float4s, and the eval's highest slot lies below
    it), a multiple of 4 wide and 16-byte aligned."""
    if table.device.type != "cuda" or table.dtype != torch.float32 \
            or table.dim() != 2 or not table.is_contiguous():
        raise ValueError("fused_gather: table must be a contiguous 2-d "
                         "float32 tensor on a CUDA device")
    if table.shape[1] < ROW_LOAD or table.shape[1] % 4 \
            or table.data_ptr() % 16 \
            or max(ev.row_slots.values()) >= ROW_LOAD:
        raise ValueError(f"fused_gather: table rows must hold at least "
                         f"{ROW_LOAD} floats, a multiple of 4, 16-byte "
                         f"aligned; got width {table.shape[1]}")
    if any(ev.row_slots[n] != k for n, _, k in HEAD_FIELDS):
        raise ValueError("fused_gather: the kernel reads the row heads at "
                         "the slots of csrc/gather_eval.cuh")


def launch_kernel(ev: GatherEval, plan: Plan, table, qrows, r2, k3,
                  min_depth):
    """Launch the CUDA kernel for eval `ev` on PyTorch's current stream
    (no synchronize); raises on inputs the kernel does not take or a
    refused launch."""
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"fused_gather: the kernel runs on CUDA tensors, "
                         f"not on {dev}")
    if ev.name not in LAUNCHES or ev.me != ev.name.endswith("_me"):
        raise ValueError(f"fused_gather: no kernel for eval {ev.name!r}")
    _check_table(ev, table)
    for name, t, dt in (("qrows", qrows, torch.float32),
                        ("r0", plan.r0, torch.int32),
                        ("r1", plan.r1, torch.int32)):
        if t.device != dev or t.dtype != dt or t.dim() != 2 \
                or not t.is_contiguous():
            raise ValueError(f"fused_gather: {name} must be a contiguous "
                             f"2-d {dt} tensor on {dev}")
    P, row_w = table.shape
    Q = qrows.shape[0]
    if qrows.shape[1] != ev.q_width:
        raise ValueError(f"fused_gather: query rows must be {ev.q_width} "
                         f"wide for eval {ev.name!r}, got {qrows.shape[1]}")
    if plan.r0.shape != (Q, N_RUNS) or plan.r1.shape != (Q, N_RUNS):
        raise ValueError(f"fused_gather: run bounds must be [{Q}, {N_RUNS}]")
    if P >= ME_NONE or Q >= ME_NONE:
        raise ValueError("fused_gather: row and query ids must fit int32")
    out = torch.empty((Q, ev.n_out), dtype=torch.float32, device=dev)
    me_row = torch.empty((Q,), dtype=torch.int32, device=dev) \
        if ev.me else None
    if Q == 0:
        return out, me_row
    lib = build()
    fn = getattr(lib, f"gvpm_fused_gather_{ev.name}")
    head = torch.empty((2, P, 4), dtype=torch.float32, device=dev)
    outs = (out.data_ptr(), me_row.data_ptr()) if ev.me \
        else (out.data_ptr(),)
    err = fn(table.data_ptr(), head.data_ptr(), P, row_w, qrows.data_ptr(),
             plan.r0.data_ptr(), plan.r1.data_ptr(), Q, float(r2),
             float(k3), int(min_depth), *outs,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_gather_{ev.name} launch failed: "
                           f"CUDA error {err}")
    LAUNCHES[ev.name] += 1
    return out, me_row
