"""Smoke run of the PyTorch + CUDA port (gvpm_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the exit code is non-zero:

  1. device   — a CUDA card is required (never falls back to the CPU);
                prints its name and power limit from nvidia-smi.
  2. build    — compiles the fused-gather kernels from the sources in
                gvpm_tpu_torch/csrc into gvpm_tpu_torch/_build/.
  3. kernels  — captures the gather inputs of one headline pass with
                manifold (ME) shifts and runs each kernel variant
                (surface, volume, surface_me, volume_me) through the CUDA
                kernel and through its plain PyTorch version on the same
                tensors: visits and shift_ok must be equal, the sums
                agree at rtol 2e-4 / atol 5e-6, the ME row keys must be
                exactly equal with at least one ME query; prints
                candidates, visits, ME queries, both times and the
                kernel's bound (see `kernel_bound`), the time of the row
                heads each call first copies out of the table, whether two
                launches on the same inputs give the same bits (they
                must: the kernel's sums have a fixed order), and the lane
                use of a lane-per-row loop and of this kernel's batches
                on these inputs (`lane_use`).
  3b. stress  — the four variants against their plain versions on a small
                seeded input the headline cannot give (`stress_inputs`):
                a query with more visits than a tile's ring holds, runs
                longer than 32 x a few and empty ones, a ragged last
                tile, invalid queries, a lowest ME row in a late run.
  4. main     — gvpm.render at the bench headline size (512^2 box_medium,
                2^18 light paths, bench.py:347-362 without the TPU knobs):
                first 3 passes with the default use_manifold=True
                (bench.py's distance_me; 1 surface_me + 2 volume_me
                launches per pass), then the use_manifold=False path
                (a warm-up pass and a timed one; 1 surface + 2 volume
                launches per pass). Per-pass seconds, visits/s, phase
                split (the ME stages as phases of their own, and their
                parts: compaction, chain walk, Newton solve, ratios,
                occlusion sweep), shift_ok, ME pairs taken / dropped and
                the launch counts; images finite, reconstruction mean
                within 25% of the primal mean, and shift_ok with ME above
                shift_ok without at the same seed and pass. Last, the
                device kernel launches of one pass of each kind.
  4b. sppm    — the SPPM primal pass (sppm.render_pass, `distance`) at
                the same size (SPPM_KW: bench.py's base_kw without its TPU
                knobs): a warm-up pass, then 3 timed passes with their
                phase split; both hash grids' occupancy (cell_histogram);
                one profiled pass: device kernel launches, device-busy
                share and the share of device time inside the hash-grid
                gather (gather_dense). The image must be finite with a
                mean above 0.
  5. goldens  — box-medium gvpm:distance relMSE against the committed
                goldens at the goldens/ci (32^2) and goldens (128^2)
                configs with ME off, and at 32^2 with ME on, and
                sppm:distance at both (SPPM_GOLD), under the bars
                recorded in their meta.json; the 32^2 gvpm render once
                more with the gathers' plain version, to show how far a
                different order of the sums moves the relMSE.
  6. entry    — the port's entry() (one SPPM pass of a 32^2 tiny scene)
                on the card: a finite image.
     volpath  — volpath.render of box-medium at each golden's generation
                config (1024 spp, max_depth 12, seed 101; 32^2 and 128^2):
                seconds, and relMSE against the golden under the
                agreement bar it was accepted at (agree_relmse).

The line before the last is a JSON object describing each kernel; the
last line is {"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
TOL = dict(rtol=2e-4, atol=5e-6)
HEADLINE_KW = dict(
    max_depth=12, null_bounces=6, max_cam_depth=6,
    surface_photons=1 << 18, volume_photons=1 << 18, volume_samples=2,
    initial_scale_volume=0.8, vol_segments_per_pixel=2,
    grid_dims=(64, 64, 64), grid_surface_rows=1 << 20,
    grid_volume_rows=1 << 20, use_manifold=False)
HEADLINE_ME_KW = dict(HEADLINE_KW, use_manifold=True, me_pair_budget=4096)
# the SPPM primal pass at the same size: bench.py:347-362's base_kw
# without its TPU knobs (the hash grid's budget and size are the JAX
# package's own)
SPPM_KW = dict(
    max_depth=12, null_bounces=6, max_cam_depth=6,
    surface_photons=1 << 18, volume_photons=1 << 18, volume_samples=2,
    initial_scale_volume=0.8, vol_segments_per_pixel=2,
    grid_max_photons_per_cell=32, grid_hash_size=1 << 20)
# the goldens' SPPM check configs (tools/goldens.py::_check_kw; the 128^2
# one without its beam count), passes as tests/test_goldens.py and
# tools/goldens.py run them
SPPM_GOLD = (
    ("ci", dict(surface_photons=1 << 15, volume_photons=1 << 15,
                max_depth=12, grid_hash_size=1 << 15), 12),
    (".", dict(max_depth=12, null_bounces=6, max_cam_depth=6,
               surface_photons=1 << 16, volume_photons=1 << 16,
               grid_hash_size=1 << 18, initial_scale_volume=0.5,
               volume_samples=2, vol_segments_per_pixel=2,
               grid_dims=(64, 64, 64)), 10))

# Published peaks of one H100 SXM at its full 700 W power limit (NVIDIA's
# data sheet): device memory rate and float32 rate outside the tensor
# cores. The kernels' bounds are stated against these.
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
# The same units without fused multiply-adds (the kernels are built with
# -fmad=false and BODY_OPS counts an add and a multiply as one each):
# 132 SMs x 128 lanes x 1.98 GHz, one operation a lane a clock.
PEAK_FP32_UNFUSED_S = 132 * 128 * 1.98e9
# float operations per pair, counted from csrc/gather_eval.cuh on the path
# box_medium takes (diffuse parents and gather points; phase_params
# always evaluates its HG and Rayleigh branches), one operation per add,
# multiply, divide, compare, clamp, sqrtf and expf:
#   ball test  — volume: sub3 3, dot3 5, 3 compares; surface: the same
#                plus neg3 3, dot3 5 and 2 more compares.
#   shift body — per visit: base term and shift_caches (volume 46,
#                surface 51) plus 4 shifts of reconnect (parent_scatter
#                112, distances / transmittance / pdf ratios 86 volume,
#                104 surface) and the shifted phase or BSDF, MIS and the
#                27 accumulations (volume 49, surface 56).
BALL_OPS = {"volume": 11, "surface": 20}
BODY_OPS = {"volume": 46 + 4 * (112 + 86 + 49),
            "surface": 51 + 4 * (112 + 104 + 56)}
ME_OPS = 4          # per visit: three mask terms and the integer min


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def profile_pass(run):
    """One call of `run` under torch.profiler (CPU + CUDA): returns
    (device kernel launches, device-busy share of the profiled wall
    time, share of device kernel time inside record_function ranges named
    "gather_dense" or None where none was attributed, how it was
    attributed, profiled wall seconds). Busy time is the union of the
    kernels' intervals; the profiler slows the host, so the busy share
    reads low against an unprofiled pass."""
    act = torch.profiler.ProfilerActivity
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    launches = sum(1 for e in events if e.name == "cudaLaunchKernel")
    cuda = torch.autograd.DeviceType.CUDA
    on_card = [e for e in events if e.device_type == cuda]
    # device-side ranges of the "gather_dense" annotation, where the
    # profiler reports them; every other device event is work
    ann = [(e.time_range.start, e.time_range.end) for e in on_card
           if e.name == "gather_dense"]
    kernels = sorted((e.time_range.start, e.time_range.end) for e in on_card
                     if e.name != "gather_dense"
                     and not getattr(e, "is_user_annotation", False))
    total = sum(b - a for a, b in kernels)
    busy, lo, hi = 0.0, None, None
    for a, b in kernels:
        if hi is None or a > hi:
            busy += 0.0 if hi is None else hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    if hi is not None:
        busy += hi - lo
    if ann:
        in_gather = sum(max(0.0, min(b, d) - max(a, c))
                        for a, b in kernels for c, d in ann)
        how = "device annotation ranges"
    else:
        in_gather = sum(e.device_time_total if hasattr(e, "device_time_total")
                        else e.cuda_time_total for e in events
                        if e.name == "gather_dense" and e.device_type != cuda)
        how = "kernels launched inside the host ranges"
    share = in_gather / total if total and in_gather else None
    return launches, busy * 1e-6 / wall, share, how, wall


def cuda_ms(fn, reps, warm=1):
    """Mean milliseconds of `fn` over `reps` runs after `warm` untimed
    ones, by CUDA events."""
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def covered_rows(plan, n_rows):
    """Table rows that lie in at least one query's runs."""
    delta = torch.zeros(n_rows + 1, dtype=torch.int64, device=plan.r0.device)
    one = torch.ones(plan.r0.numel(), dtype=torch.int64,
                     device=plan.r0.device)
    delta.index_add_(0, plan.r0.reshape(-1).to(torch.int64), one)
    delta.index_add_(0, plan.r1.reshape(-1).to(torch.int64), -one)
    return int((torch.cumsum(delta, 0)[:n_rows] > 0).sum())


def stress_inputs(ev, seed=7, device="cpu"):
    """A small seeded input of the fused gather that a render cannot be
    relied on to give. ev: a GatherEval (its slot layouts are used).
    Returns (r0, r1, table, qrows, r2, k3, min_depth, hot): 777 sorted
    queries (not a multiple of a tile) over 4096 rows in a 0.25-wide
    cluster; nine disjoint runs a query, a third of them empty, some
    over 128 rows; a tenth of the queries invalid but with runs; query
    `hot` covers 3200 rows from the cluster's centre and visits hundreds
    of them (more than a tile's ring holds), its run 4 is empty and its
    lowest ME-eligible row lies in run 7; min_depth 3 cuts some pairs.
    Parents are emitters, surfaces (diffuse, Phong, plastic) and medium
    vertices; surface queries also carry rough conductors."""
    rng = np.random.default_rng(seed)
    surface = ev.name.startswith("surface")
    P, Q, side = 4096, 777, 0.25
    hot, hot_len, me_from = Q // 2, 400, 2800
    centre = np.full(3, side / 2)

    def unit(n):
        v = rng.normal(size=(n, 3))
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    def frame(n3):
        a = np.where(np.abs(n3[:, :1]) < 0.9, [[1.0, 0, 0]], [[0, 1.0, 0]])
        s_ax = np.cross(n3, a)
        s_ax /= np.linalg.norm(s_ax, axis=1, keepdims=True)
        return s_ax, np.cross(n3, s_ax)

    def upper(n):
        v = unit(n)
        v[:, 2] = np.abs(v[:, 2]) + 0.05
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    def fill(width, slots, fields):
        n = len(next(iter(fields.values())))
        a = np.zeros((n, width), np.float32)
        for name, v in fields.items():
            v = np.asarray(v, np.float32).reshape(n, -1)
            a[:, slots[name]:slots[name] + v.shape[1]] = v
        return a

    def gloss(btype, n):
        return np.where(btype == 6, rng.uniform(5, 40, n),
                        rng.uniform(0.1, 0.5, n))

    # ---- photon rows
    p = rng.uniform(0, side, (P, 3))
    me = (np.arange(P) >= me_from) & (rng.random(P) < 0.04)
    me_forced = me_from + 100
    me[me_forced] = True
    p[me_forced] = centre + 1e-3
    wi = unit(P)
    btype = rng.choice([0, 6, 7], P)
    rows = dict(
        p=p, wi=wi, alpha=rng.uniform(0.1, 1, (P, 3)),
        parent_p=p + unit(P) * rng.uniform(0.3, 1.0, (P, 1)),
        parent_wi=unit(P), parent_ns=unit(P),
        scatter_base=rng.uniform(0.05, 1, (P, 3))
        * (rng.random((P, 1)) > 0.05),
        ns=unit(P), st=rng.uniform(0.2, 2, (P, 3)),
        pm_alb=rng.uniform(0.2, 0.9, (P, 3)),
        pm_spec=rng.uniform(0.1, 0.5, (P, 3)),
        pm_eta3=rng.uniform(0.2, 1.5, (P, 3)),
        pm_sigs=rng.uniform(0.1, 1, (P, 3)),
        pdf_dir_base=rng.uniform(0.05, 1, P),
        parent_type=np.where(me, 1, rng.choice([0, 1, 2], P)),
        reconnectable=~me & (rng.random(P) < 0.85),
        vtype=np.where(rng.random(P) < 0.9, 1 if surface else 2, 0),
        depth=rng.integers(1, 5, P), pm_btype=btype,
        pm_alpha=gloss(btype, P), pm_eta1=np.full(P, 1.5),
        pm_g=rng.uniform(-0.6, 0.6, P), pm_ptype=rng.choice([0, 1, 2], P),
        pm_delta=me, own_delta=~me & (rng.random(P) < 0.05))
    rows["vtype"][me_forced] = 1 if surface else 2
    rows["depth"][me_forced] = 4

    # ---- queries
    x = rng.uniform(0, side, (Q, 3))
    x[hot] = centre
    valid = rng.random(Q) < 0.9
    valid[hot] = True
    depth = rng.integers(0, 3, Q)
    depth[hot] = 2
    flags = {f"{n}{i}": rng.random(Q) < pr for i in range(4)
             for n, pr in (("cam_ok" if not surface else "comp", 0.85),
                           ("border", 0.1))}
    ratios = {f"{'sens' if surface else 'prc'}{i}": rng.uniform(0.2, 3, Q)
              for i in range(4)}
    if surface:
        ns = unit(Q)
        ns[hot] = -wi[me_forced]          # the forced ME row faces it
        s_ax, t_ax = frame(ns)
        qb = rng.choice([0, 3, 6, 7], Q)
        r2q = rng.uniform(0.05, 0.09, Q) ** 2
        r2q[hot] = 0.11 ** 2
        q = dict(p=x, ns=ns, s=s_ax, t=t_ax, wo=upper(Q),
                 alb=rng.uniform(0.2, 0.9, (Q, 3)),
                 spec=rng.uniform(0.1, 0.5, (Q, 3)),
                 eta3=rng.uniform(0.2, 1.5, (Q, 3)), btype=qb,
                 alpha_b=gloss(qb, Q), eta1=np.full(Q, 1.5), r2=r2q,
                 valid=valid, depth=depth, **flags, **ratios)
        for i in range(4):
            ns_i = ns + 0.05 * unit(Q)
            ns_i /= np.linalg.norm(ns_i, axis=1, keepdims=True)
            s_i, t_i = frame(ns_i)
            q.update({f"p{i}": x + 0.01 * unit(Q), f"ns{i}": ns_i,
                      f"s{i}": s_i, f"t{i}": t_i, f"wo{i}": upper(Q)})
        r2, k3 = 0.0, 0.0
    else:
        d = unit(Q)
        q = dict(x=x, d=d, g=rng.uniform(-0.5, 0.5, Q),
                 pt=rng.choice([0, 1, 2], Q), sok=valid, depth=depth,
                 **flags, **ratios)
        for i in range(4):
            sd = d + 0.05 * unit(Q)
            q.update({f"xs{i}": x + 0.01 * unit(Q),
                      f"sd{i}": sd / np.linalg.norm(sd, axis=1,
                                                    keepdims=True)})
        r2 = 0.08 ** 2
        k3 = 3.0 / (4.0 * np.pi * 0.08 ** 3)

    # ---- runs: disjoint and ascending within a query
    lens = rng.integers(1, 41, (Q, 9))
    long_q = rng.random(Q) < 0.05
    lens[long_q] = rng.integers(100, 201, (int(long_q.sum()), 9))
    lens[rng.random((Q, 9)) < 0.35] = 0
    gaps = rng.integers(0, 8, (Q, 9))
    gaps[:, 0] = rng.integers(0, P - (lens + gaps).sum(1))
    r1 = np.cumsum(lens + gaps, axis=1)
    r0 = r1 - lens
    r0[hot] = np.arange(9) * hot_len
    r1[hot] = r0[hot] + hot_len
    r1[hot, 4] = r0[hot, 4]
    assert r0.min() >= 0 and r1.max() <= P and me_from == r0[hot, 7]

    def t(a, dtype):
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype,
                            device=device)
    return (t(r0, torch.int32), t(r1, torch.int32),
            t(fill(128, ev.row_slots, rows), torch.float32),
            t(fill(ev.q_width, ev.q_slots, q), torch.float32),
            r2, k3, 3, hot)


def lane_use(ev, plan, tbl, qrows, r2, k3, md):
    """Measured lane use on these inputs, in tensor code. A lane-per-row
    loop (one warp a query, 32 lanes striding over each run) makes
    `trips` = sum over queries and runs of ceil(len / 32) trips; those
    with a visit run the shift body with only the visiting lanes busy.
    The queued kernel runs the body in batches of 32 pairs per tile of
    fused_gather.TILE_Q queries, so `batches` = sum over tiles of
    ceil(visits / 32), and sweeps ceil(candidates of a tile / 32) slots
    a tile."""
    from gvpm_tpu_torch.ops import fused_gather as fg
    tile_q = fg.TILE_Q
    lens = (plan.r1 - plan.r0).to(torch.int64)
    trips = int(((lens + 31) // 32).sum())
    per_q = torch.zeros(qrows.shape[0], dtype=torch.int64,
                        device=qrows.device)
    trips_hit = 0
    for s, e, run, row in fg.candidate_chunks(plan):
        q = fg._Cols(qrows, s + run // fg.N_RUNS, ev.q_slots)
        r = fg._Cols(tbl, row, ev.row_slots)
        inside = ev.pair_fn(q, r, md, r2, k3, False)[27] > 0.5
        pos = row - plan.r0[s:e].reshape(-1).to(torch.int64)[run]
        trips_hit += int(torch.unique(
            (run * (1 << 26) + pos // 32)[inside]).numel())
        per_q[s:e].index_add_(0, run // fg.N_RUNS, inside.to(torch.int64))
    visits = int(per_q.sum())
    def per_tile(a):
        pad = (-a.numel()) % tile_q
        return torch.nn.functional.pad(a, (0, pad)).reshape(
            -1, tile_q).sum(1)
    batches = int(((per_tile(per_q) + 31) // 32).sum())
    slots = int(((per_tile(lens.sum(1)) + 31) // 32).sum())
    return dict(trips=trips, trips_with_visit=trips_hit,
                visits_per_such_trip=visits / max(trips_hit, 1),
                lanes_busy_in_such_trip=visits / max(trips_hit, 1) / 32,
                batches=batches,
                lanes_busy_in_batch=visits / max(batches, 1) / 32,
                sweep_slots=slots,
                lanes_busy_in_sweep=int(lens.sum()) / max(slots, 1) / 32)


def kernel_bound(ev, slots, plan, tbl, qrows, candidates, visits):
    """The least time the card could take for this launch: the larger of
    the bytes that must move over the memory rate (once each: the slots
    the eval reads, `slots` = fused_gather.slots_read, of each table row
    that some run covers and of each query row, not the rows' padded
    widths; the run bounds; the outputs) and the float operations these
    inputs need (every candidate's ball test, every visit's shift body)
    over the float32 rate (67 TFLOP/s, which counts a fused multiply-add
    as two; `operations_unfused_ms` in the detail is the same count over
    the rate the card reaches without fusing, the second reading).
    Returns (ms, "bytes" | "operations", detail)."""
    Q = qrows.shape[0]
    rows = covered_rows(plan, tbl.shape[0])
    row_slots, q_slots = (len(s) for s in slots)
    n_bytes = 4 * (rows * row_slots + Q * q_slots + 2 * plan.r0.numel()
                   + Q * ev.n_out + (Q if ev.me else 0))
    kind = ev.name.split("_")[0]
    ops = candidates * BALL_OPS[kind] \
        + visits * (BODY_OPS[kind] + (ME_OPS if ev.me else 0))
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_FP32_S * 1e3
    detail = dict(covered_rows=rows, row_slots=row_slots, q_slots=q_slots,
                  bytes=n_bytes, operations=ops,
                  bytes_ms=t_bytes, operations_ms=t_ops,
                  operations_unfused_ms=ops / PEAK_FP32_UNFUSED_S * 1e3)
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", detail)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device — this smoke run "
                         "needs a GPU and does not fall back to the CPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    sys.path.insert(0, ROOT)
    from gvpm_tpu_torch import scenes
    from gvpm_tpu_torch.core.config import GradientConfig
    from gvpm_tpu_torch.integrators import gradient_gather, gvpm, sppm
    from gvpm_tpu_torch.ops import fused_gather as fg
    from gvpm_tpu_torch.utils import image as imglib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi, flush=True)
    phase("device", f"torch {torch.__version__} cuda {torch.version.cuda}, "
                    f"{torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    fg.build()
    phase("build", f"fused_gather kernels built in "
                   f"{time.perf_counter() - t0:.2f} s; ptxas per "
                   f"instantiation (registers a thread, bytes): "
                   f"{json.dumps(fg.build_report())}")

    # ---- 3. kernel vs plain on one headline ME pass's inputs ----
    scene = scenes.box_medium(512, 512)          # default device: the card
    cfg_me = GradientConfig(**HEADLINE_ME_KW)
    cfg = GradientConfig(**HEADLINE_KW)
    n_photons = max(cfg.surface_photons, cfg.volume_photons)
    r_vol_base = sppm.base_volume_radius(scene, cfg)
    captured = {}
    launch = fg.fused_gather

    def capture(ev, *args):
        captured.setdefault(ev.name, args)
        return launch(ev, *args)

    fg.fused_gather = capture
    try:
        gvpm.render_pass(scene, cfg_me, "distance", n_photons, 5, 0, 1.0,
                         1.0, r_vol_base)
    finally:
        fg.fused_gather = launch
    def against_plain(name, ev, args):
        """The kernel twice and the plain version once on `args`:
        visits, shift_ok and ME keys equal, sums within TOL, the two
        launches bitwise equal. Returns (plain out, ME queries, err)."""
        got, got_me = fg.fused_gather(ev, *args)
        again, again_me = fg.fused_gather(ev, *args)
        want, want_me = fg.fused_gather_plain(ev, *args)
        torch.cuda.synchronize()
        if not torch.equal(got[:, 27:29], want[:, 27:29]):
            raise AssertionError(f"{name}: visits/shift_ok differ from the "
                                 "plain version")
        torch.testing.assert_close(got, want, **TOL)
        me_queries = None
        if ev.me:
            if got_me.dtype != torch.int32 or not torch.equal(got_me,
                                                              want_me):
                raise AssertionError(f"{name}: ME row keys differ from the "
                                     "plain version")
            me_queries = int((got_me != fg.ME_NONE).sum())
            if not me_queries > 0:
                raise AssertionError(f"{name}: no query has an ME pair")
        elif got_me is not None or want_me is not None:
            raise AssertionError(f"{name}: unexpected ME output")
        # the sums' order is fixed (segmented warp reductions, no atomics)
        if not (torch.equal(got.view(torch.int32), again.view(torch.int32))
                and (not ev.me or torch.equal(got_me, again_me))):
            raise AssertionError(f"{name}: two launches on the same inputs "
                                 "differ")
        return want, me_queries, float((got - want).abs().max())

    kernels = {}
    for name, ev in gradient_gather.EVALS.items():
        inputs = name if name.endswith("_me") else name + "_me"
        plan, tbl, qrows, r2, k3, md = args = captured[inputs]
        want, me_queries, err = against_plain(name, ev, args)
        candidates = int((plan.r1 - plan.r0).sum())
        visits = int(want[:, 27].sum())
        bound_ms, bound_by, detail = kernel_bound(
            ev, fg.slots_read(ev, md), plan, tbl, qrows, candidates, visits)
        # with one warm-up run the first kernel timed read up to 10%
        # apart between calls (0.84 and 0.94 ms): warm up longer
        ms = cuda_ms(lambda: fg.fused_gather(ev, *args), 20, warm=20)
        plain_ms = cuda_ms(lambda: fg.fused_gather_plain(ev, *args), 1)
        head_ms = cuda_ms(lambda: fg.row_heads(ev, tbl), 10)
        kernels[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by)
        phase("kernels", f"{name}: {qrows.shape[0]} queries x "
                         f"{tbl.shape[0]} rows, candidates {candidates}, "
                         f"visits {visits} equal, ME queries {me_queries}"
                         f"{' (row keys equal)' if ev.me else ''}, max|err| "
                         f"{err:.3g} (rtol 2e-4 atol 5e-6), two launches "
                         f"bitwise equal, kernel {ms:.3f} ms (of which "
                         f"row heads {head_ms:.3f} ms), plain "
                         f"{plain_ms:.1f} ms, bound {bound_ms:.4f} ms by "
                         f"{bound_by} {json.dumps(detail)}")
        if not ev.me:
            phase("kernels", f"{name} lane use: "
                             f"{json.dumps(lane_use(ev, *args))}")
    del captured, args, plan, tbl, qrows, want

    # ---- 3b. the stress input ----
    for name, ev in gradient_gather.EVALS.items():
        r0, r1, *rest, hot = stress_inputs(ev, device="cuda")
        plan = fg.Plan(torch.arange(r0.shape[0], device="cuda"), r0, r1)
        want, me_queries, err = against_plain(name, ev, (plan, *rest))
        if not int(want[hot, 27]) > 256:
            raise AssertionError(f"{name}: the stress input's hot query "
                                 f"has {int(want[hot, 27])} visits")
        phase("stress", f"{name}: {r0.shape[0]} queries, candidates "
                        f"{int((r1 - r0).sum())}, visits "
                        f"{int(want[:, 27].sum())} equal ({int(want[hot, 27])}"
                        f" of them one query's), shift_ok "
                        f"{int(want[:, 28].sum())} equal, ME queries "
                        f"{me_queries}, max|err| {err:.3g}, two launches "
                        f"bitwise equal")

    # ---- 4. the main paths at the headline size ----
    def drive(label, cfg, passes, expect):
        marks, timings = [], {}

        def on_pass(it, _img, stats):
            torch.cuda.synchronize()
            marks.append((time.perf_counter(),
                          {k: int(v) for k, v in stats.items()}))

        for k in fg.LAUNCHES:
            fg.LAUNCHES[k] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = gvpm.render(scene, cfg, volume="distance", seed=5,
                          passes=passes, callback=on_pass, timings=timings)
        torch.cuda.synchronize()
        t_all = time.perf_counter() - t0
        launches = dict(fg.LAUNCHES)
        starts = [t0] + [m[0] for m in marks[:-1]]
        pass_s = [m[0] - s for m, s in zip(marks, starts)]
        stats = [m[1] for m in marks]
        visits = [s["visits"] for s in stats]
        phase(label, f"512x512, {n_photons} paths, {passes} passes: pass s "
                     f"{[round(s, 4) for s in pass_s]}, visits/pass "
                     f"{visits}, visits/s (after pass 1) "
                     f"{sum(visits[1:]) / sum(pass_s[1:]):.4g}, total "
                     f"{t_all:.2f} s incl. Poisson")
        phase(label, f"phase split s ({passes} passes): " + json.dumps(
            {k: round(v, 4) for k, v in timings.items()
             if not k.startswith("me:")}))
        if cfg.use_manifold:
            phase(label, "parts of surface_me + volume_me, s: " + json.dumps(
                {k[3:]: round(v, 4) for k, v in timings.items()
                 if k.startswith("me:")})
                + f"; {passes * 3} shift calls of "
                f"{cfg.max_manifold_iterations + 1} Jacobian evaluations "
                "each in newton")
        phase(label, "per pass: shift_ok "
                     f"{[s['shift_ok'] for s in stats]}, ME pairs taken "
                     f"{[s['me_pairs'] for s in stats]}, me_dropped "
                     f"{[s['me_dropped'] for s in stats]}")
        phase(label, f"launches {launches}")
        if launches != expect:
            raise AssertionError(f"kernel launch counts {launches}, "
                                 f"expected {expect}")
        for k in ("primal", "gx", "gy", "image"):
            if out[k].shape != (512, 512, 3) or out[k].dtype != torch.float32:
                raise AssertionError(
                    f"{k}: {out[k].dtype} {tuple(out[k].shape)}")
            if not bool(torch.isfinite(out[k]).all()):
                raise AssertionError(f"non-finite {k}")
        mp, mr = float(out["primal"].mean()), float(out["image"].mean())
        if not abs(mr / mp - 1.0) < 0.25:
            raise AssertionError(f"recon mean {mr} vs primal mean {mp}")
        phase(label, f"finite; primal mean {mp:.5g}, recon mean {mr:.5g}")
        return launches, stats

    none = dict.fromkeys(fg.LAUNCHES, 0)
    launches_me, stats_me = drive(
        "main-me", cfg_me, 3, dict(none, surface_me=3, volume_me=6))
    launches, stats = drive(
        "main", cfg, 2, dict(none, surface=2, volume=4))
    for it, (s_me, s) in enumerate(zip(stats_me, stats)):
        if s_me["visits"] != s["visits"]:
            raise AssertionError(f"pass {it}: visits with ME "
                                 f"{s_me['visits']} vs without {s['visits']}")
        if not s_me["shift_ok"] > s["shift_ok"]:
            raise AssertionError(f"pass {it}: shift_ok with ME "
                                 f"{s_me['shift_ok']} not above "
                                 f"{s['shift_ok']} without")
        if not s_me["me_pairs"] > 0 == s["me_pairs"]:
            raise AssertionError(f"pass {it}: ME pairs {s_me['me_pairs']} "
                                 f"/ {s['me_pairs']}")
    phase("main", "shift_ok with ME above shift_ok without, pass by pass: "
                  f"{[(a['shift_ok'], b['shift_ok']) for a, b in zip(stats_me, stats)]}")
    launches = {k: launches[k] + launches_me[k] for k in launches}

    # device kernel launches of one pass, with and without ME (the host
    # launches them one by one; printed, not asserted)
    def count_launches(c):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            gvpm.render_pass(scene, c, "distance", n_photons, 5, 0, 1.0, 1.0,
                             r_vol_base)
            torch.cuda.synchronize()
        return sum(e.count for e in prof.key_averages()
                   if e.key == "cudaLaunchKernel")
    phase("main", f"device kernel launches in one pass (torch.profiler): "
                  f"{count_launches(cfg_me)} with ME, "
                  f"{count_launches(cfg)} without")

    # ---- 4b. the SPPM primal pass at the headline size ----
    from gvpm_tpu_torch.core.config import PhotonConfig
    from gvpm_tpu_torch.ops import hashgrid
    scfg = PhotonConfig(**SPPM_KW)
    s_r_vol = sppm.base_volume_radius(scene, scfg)
    s_photons = max(scfg.surface_photons, scfg.volume_photons)
    grids, build = [], hashgrid.build

    def keep_build(*a, **k):
        grids.append(build(*a, **k))
        return grids[-1]

    hashgrid.build = keep_build
    try:                                            # the warm-up pass
        sppm.render_pass(scene, scfg, "distance", s_photons, 5, 0, 1.0, 1.0,
                         s_r_vol)
    finally:
        hashgrid.build = build
    hists = [hashgrid.cell_histogram(g) for g in grids]
    del grids
    phase("sppm", f"hash grids (max, mean nonzero) photons per bucket: "
                  f"surface {hists[0]}, volume {hists[1]} "
                  f"(grid_max_photons_per_cell {scfg.grid_max_photons_per_cell}"
                  f", budget {2 * scfg.grid_max_photons_per_cell} rows)")
    marks, timings = [], {}

    def on_sppm_pass(it, _img):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sppm.render(scene, scfg, volume="distance", seed=5, passes=3,
                      callback=on_sppm_pass, timings=timings)
    pass_s = [b - a for a, b in zip([t0] + marks[:-1], marks)]
    img = out["image"]
    if img.shape != (512, 512, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"sppm: image {tuple(img.shape)} not finite")
    if not float(img.mean()) > 0:
        raise AssertionError("sppm: image mean not above 0")
    phase("sppm", f"512x512, {s_photons} paths, 3 passes after a warm-up: "
                  f"pass s {[round(x, 4) for x in pass_s]}, image mean "
                  f"{float(img.mean()):.5g}, finite")
    phase("sppm", "phase split s per pass: " + json.dumps(
        {k: round(v / 3, 4) for k, v in timings.items()}))
    gd = hashgrid.gather_dense

    def traced_gather_dense(*a, **k):
        with torch.profiler.record_function("gather_dense"):
            return gd(*a, **k)

    hashgrid.gather_dense = traced_gather_dense
    try:
        n_launch, busy, gd_share, how, wall = profile_pass(
            lambda: sppm.render_pass(scene, scfg, "distance", s_photons, 5,
                                     3, 1.0, 1.0, s_r_vol))
    finally:
        hashgrid.gather_dense = gd
    phase("sppm", f"one profiled pass (torch.profiler, {wall:.4f} s): "
                  f"{n_launch} device kernel launches, device busy "
                  f"{busy:.1%} of the pass, gather_dense "
                  + (f"{gd_share:.1%} of device kernel time ({how})"
                     if gd_share is not None else "not measured (no device "
                     "time attributed to it)"))
    del scene, out, img

    # ---- 5. golden bars ----
    ci = dict(surface_photons=1 << 15, volume_photons=1 << 15, max_depth=12,
              use_manifold=False, passes=12)
    gold_cfgs = [
        ("ci", "ME off", ci),
        ("ci", "ME on", dict(ci, use_manifold=True)),
        (".", "ME off", dict(
            max_depth=12, null_bounces=6, max_cam_depth=6,
            surface_photons=1 << 16, volume_photons=1 << 16,
            initial_scale_volume=0.5, volume_samples=2,
            vol_segments_per_pixel=2, grid_dims=(64, 64, 64),
            grid_surface_rows=1 << 19, grid_volume_rows=1 << 19,
            use_manifold=False, passes=10))]
    seen = {}
    for sub, label, kw in gold_cfgs:
        gdir = os.path.normpath(os.path.join(ROOT, "goldens", sub))
        with open(os.path.join(gdir, "meta.json")) as f:
            meta = json.load(f)
        size = meta["size"]
        bar = meta["scenes"]["box-medium"]["thresholds"]["gvpm:distance"]
        kw = dict(kw)
        passes = kw.pop("passes")
        t0 = time.perf_counter()
        res = gvpm.render(scenes.box_medium(size, size),
                          GradientConfig(**kw), volume="distance", seed=5,
                          passes=passes)
        img = res["image"].cpu().numpy()
        if not np.isfinite(img).all():
            raise AssertionError(f"golden {size} {label}: non-finite image")
        r = imglib.relmse(img, imglib.read_pfm(
            os.path.join(gdir, "box-medium_ref.pfm")))
        seen[(size, label)] = r
        phase("goldens", f"box-medium gvpm:distance {size}^2 {passes} "
                         f"passes, {label}: relMSE {r:.5f} (bar {bar}) in "
                         f"{time.perf_counter() - t0:.2f} s")
        if not r <= bar:
            raise AssertionError(f"golden {size} {label}: relMSE {r} > "
                                 f"{bar}")
    for sub, kw, passes in SPPM_GOLD:
        gdir = os.path.normpath(os.path.join(ROOT, "goldens", sub))
        with open(os.path.join(gdir, "meta.json")) as f:
            meta = json.load(f)
        size = meta["size"]
        bar = meta["scenes"]["box-medium"]["thresholds"]["sppm:distance"]
        t0 = time.perf_counter()
        res = sppm.render(scenes.box_medium(size, size), PhotonConfig(**kw),
                          volume="distance", seed=5, passes=passes)
        img = res["image"].cpu().numpy()
        if not np.isfinite(img).all():
            raise AssertionError(f"sppm golden {size}: non-finite image")
        r = imglib.relmse(img, imglib.read_pfm(
            os.path.join(gdir, "box-medium_ref.pfm")))
        phase("goldens", f"box-medium sppm:distance {size}^2 {passes} "
                         f"passes: relMSE {r:.5f} (bar {bar}) in "
                         f"{time.perf_counter() - t0:.2f} s")
        if not r <= bar:
            raise AssertionError(f"sppm golden {size}: relMSE {r} > {bar}")
    phase("goldens", "32^2 relMSE ME off / ME on: "
                     f"{seen[(32, 'ME off')]:.5f} / "
                     f"{seen[(32, 'ME on')]:.5f}")
    # how far rounding alone moves a golden: the same 32^2 render with
    # the gathers' plain version (same pairs, sums in another order)
    kw = dict(ci)
    passes = kw.pop("passes")
    kernel = gvpm.render(scenes.box_medium(32, 32), GradientConfig(**kw),
                         volume="distance", seed=5, passes=passes)
    fg.fused_gather = fg.fused_gather_plain
    try:
        plain = gvpm.render(scenes.box_medium(32, 32), GradientConfig(**kw),
                            volume="distance", seed=5, passes=passes)
    finally:
        fg.fused_gather = launch
    ref = imglib.read_pfm(os.path.join(ROOT, "goldens", "ci",
                                       "box-medium_ref.pfm"))
    phase("goldens", "32^2 ME off, gathers through the plain version on the "
                     "card: relMSE "
                     f"{imglib.relmse(plain['image'].cpu().numpy(), ref):.5f} "
                     "against the kernel's "
                     f"{imglib.relmse(kernel['image'].cpu().numpy(), ref):.5f}; "
                     "kernel vs plain max relative difference, primal "
                     f"{float(((kernel['primal'] - plain['primal']).abs() / plain['primal'].abs().clamp(min=1e-3)).max()):.3g}"
                     ", reconstruction "
                     f"{float(((kernel['image'] - plain['image']).abs() / plain['image'].abs().clamp(min=1e-3)).max()):.3g}")

    # ---- 6. the single-device entry point, and the goldens' integrator ----
    from gvpm_tpu_torch import entry
    from gvpm_tpu_torch.core.config import VolPathConfig
    from gvpm_tpu_torch.integrators import volpath
    fn, args = entry.entry()                       # default device: the card
    t0 = time.perf_counter()
    img = fn(*args)
    torch.cuda.synchronize()
    if img.shape != (32, 32, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"entry: image {tuple(img.shape)} not finite")
    phase("entry", f"entry() fn on {img.device}: one SPPM pass of the "
                   f"32x32 tiny scene in {time.perf_counter() - t0:.3f} s, "
                   f"image mean {float(img.mean()):.5g}, finite")
    for sub in ("ci", "."):
        gdir = os.path.normpath(os.path.join(ROOT, "goldens", sub))
        with open(os.path.join(gdir, "meta.json")) as f:
            meta = json.load(f)
        size, spp = meta["size"], meta["gen_spp"]
        agree = meta["scenes"]["box-medium"]["agree_relmse"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = volpath.render(scenes.box_medium(size, size),
                             VolPathConfig(spp=spp, max_depth=12), seed=101)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        img = img.cpu().numpy()
        if not np.isfinite(img).all():
            raise AssertionError(f"volpath {size}: non-finite image")
        r = imglib.relmse(img, imglib.read_pfm(
            os.path.join(gdir, "box-medium_ref.pfm")))
        phase("volpath", f"box-medium {size}^2, {spp} spp, max_depth 12, "
                         f"seed 101 (the golden's generation config): "
                         f"{secs:.2f} s, relMSE against the golden {r:.5f} "
                         f"(agree_relmse {agree})")
        if not r < agree:
            raise AssertionError(f"volpath {size}: relMSE {r} >= {agree}")

    src = "gvpm_tpu_torch/csrc/fused_gather.cu"
    print(json.dumps({"kernels": [
        dict(name=f"fused_gather_{n}", route="cuda", source=src,
             replaces="gvpm_tpu/ops/pallas_gather.py:262",
             launches=launches[n], max_abs_err=k["max_abs_err"],
             ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
             bound_by=k["bound_by"],
             # no single PyTorch call computes a stencil-restricted
             # pairwise gather with the shift body
             library_ms=None)
        for n, k in kernels.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
