"""Smoke run of the PyTorch + CUDA port (gvpm_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the exit code is non-zero:

  1. device   — a CUDA card is required (never falls back to the CPU);
                prints its name and power limit from nvidia-smi.
  2. build    — compiles the fused-gather and the beam-sweep kernels
                from the sources in gvpm_tpu_torch/csrc into
                gvpm_tpu_torch/_build/, one nvcc for each, started
                together.
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
  3c. beams  — the beam / plane pair sweeps (ops/beam_sweep.py: beam1d,
                beam3d, plane0d) on the inputs of one pass of each at the
                goldens' 128^2 check config: the kernel twice and the
                plain version once, accepted-pair counts exactly equal,
                sums at rtol 2e-4 / atol 5e-6, two launches bitwise equal;
                kernel and plain ms and the bound (`beam_bound`).
  3d. gbeams — the gradient sweeps of the gvpm beam volumes (gbeam1d,
                gbeam3d, gplane0d; use_manifold=False) on the inputs of
                one gvpm pass of each at the goldens' 128^2 check config:
                the kernel twice and the plain version once (its base
                test on dense planes, its shifts on the accepted pairs
                only), visits and shift_ok exactly equal, sums at rtol
                2e-4 / atol 5e-6, two launches bitwise equal; kernel and
                plain ms and the bound (`gbeam_bound`).
  3e. gbeams-me — the same three sweeps' ME instantiations (gbeam1d_me,
                gbeam3d_me, gplane0d_me) on the inputs of one gvpm pass
                of each with the default use_manifold=True: the kernel
                twice on every query, the plain version once on the
                first quarter of the valid queries (a prefix, so beam3d's
                randoms keep their query index): visits,
                shift_ok, the ME key, the ME pair count and gbeam3d_me's
                chord point exactly equal on those rows, sums at rtol
                2e-4 / atol 5e-6, two launches bitwise equal; kernel and
                plain ms and the bound (its counts from a dense base test
                over every pair, `gsweep_stats`).
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
  4c. sppm-128 — one SPPM pass of bre, beam1d, beam3d and plane0d at the
                128^2 check config (after the warm-up of 3c): seconds,
                phase split, and the sweep launches (1, 2, 1 a pass),
                counted from 0.
  4e. gvpm-128 — one gvpm pass of beam1d, beam3d and plane0d at the
                128^2 check config, ME off: seconds, phase split and the
                gradient sweep launches (1, 2, 1 a pass), counted from 0;
                then one warm pass of each at bench.py's full beam config
                (bench.py:262-292: 128^2, 2^18 paths, 2 segments a pixel,
                2 chord samples, beam_seg_tile 8192: beam3d launches 4
                chunks x 2 samples), which the TPU never finished.
  4f. gvpm-128-me, gvpm-full-me — the same passes with the default
                use_manifold=True: the surface gather through K2-ME (1
                launch), the ME sweeps (one a segment chunk, beam3d's
                one a chunk and sample), the ME stage of each sweep as
                the volume_me phase with its me: parts, the beam ME pairs
                taken (> 0) and dropped, and the launch counts.
  4d. bre     — one gvpm `bre` pass at the headline size with the
                default ME (the surface through K2-ME, launches counted
                from 0): seconds and phase split. Its profile (the plain
                gradient bre_gather's share of device time) is
                gvpm_tpu_torch/tools/profile_bre.py: the profiler's
                processing of the pass's ~600k launches takes minutes.
  5. goldens  — box-medium gvpm:distance relMSE against the committed
                goldens at the goldens/ci (32^2) and goldens (128^2)
                configs with ME off, and at 32^2 with ME on, and
                sppm:distance at both (SPPM_GOLD), sppm:beam1d at 32^2
                and sppm:bre / beam1d / beam3d / plane0d at 128^2
                (SPPM_BEAM_GOLD), under the bars recorded in their
                meta.json; gvpm:bre at 128^2 (no bar: relMSE, finite,
                reconstruction mean within 25% of the primal's);
                gvpm:beam1d / beam3d / plane0d at 128^2 (10 / 10 / 30
                passes, ME off; no bar: relMSE, finite, reconstruction
                mean within 2% of the primal's, and the correlation of gx
                with the golden's finite differences above 0.5 as
                tools/goldens.py:237-255 holds gvpm:distance), and the
                same three with ME on (their relMSE beside ME off's,
                the same bars); the 32^2
                gvpm render once
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

import dataclasses
import json
import os
import subprocess
import sys
import threading
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

# the gvpm goldens' 128^2 check config, ME off (tools/goldens.py::
# _run_check: _check_kw(128) with the gradient gather's row caps)
GVPM_GOLD_KW = dict(
    max_depth=12, null_bounces=6, max_cam_depth=6,
    surface_photons=1 << 16, volume_photons=1 << 16,
    initial_scale_volume=0.5, volume_samples=2, vol_segments_per_pixel=2,
    grid_dims=(64, 64, 64), grid_surface_rows=1 << 19,
    grid_volume_rows=1 << 19, use_manifold=False)
# bench.py's full beam config (bench.py:262-292, _beam_child without its
# TPU knobs): 128^2, 2^18 paths, 2 segments a pixel, 2 chord samples,
# segment chunks of 8192
GBEAM_FULL_KW = dict(
    max_depth=12, null_bounces=6, max_cam_depth=6,
    surface_photons=1 << 18, volume_photons=1 << 18, grid_hash_size=1 << 20,
    volume_samples=2, initial_scale_volume=0.8,
    grid_max_photons_per_cell=32, vol_segments_per_pixel=2,
    grid_dims=(64, 64, 64), grid_surface_rows=1 << 20,
    grid_volume_rows=1 << 20, beam_seg_tile=8192, beams=1 << 14,
    use_manifold=False)

# the beam estimators' golden bars (tools/goldens.py CHECKS: 10 passes,
# 30 for plane0d; the 32^2 artifact records sppm:beam1d only)
SPPM_BEAM_GOLD = (("ci", "beam1d", 10), (".", "bre", 10), (".", "beam1d", 10),
                  (".", "beam3d", 10), (".", "plane0d", 30))

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
# the beam / plane sweeps (ops/beam_sweep.py): their main path is the
# SPPM pass at the goldens' 128^2 check config (tools/goldens.py::
# _check_kw(128), beams=1 << 12 as it sets them), one pass of each beam
# estimator; the 32^2 check config (_check_kw(32)) for sppm:beam1d
BEAM_GOLD_KW = dict(SPPM_GOLD[1][1], beams=1 << 12)
BEAM_REPLACES = {"beam1d": "gvpm_tpu/integrators/estimators.py:481",
                 "beam3d": "gvpm_tpu/integrators/estimators.py:262",
                 "plane0d": "gvpm_tpu/integrators/estimators.py:401"}
# launches of each sweep kernel per SPPM pass (beam3d: one per distance
# sample, volume_samples = 2)
BEAM_LAUNCHES = {"beam1d": 1, "beam3d": 2, "plane0d": 1}
# operations per pair counted from csrc/beam_eval.cuh, one per add,
# multiply, divide, compare, select, clamp, sqrtf and expf: (every pair
# of a valid query and a beam in its medium; each pair of the second
# stage; each accepted pair, its accumulation included). Stage 2: beam1d
# past the parameter-range tests (12 of the closest points, their
# distance and test 21); beam3d past the chord test (the sample and its
# distance test 17, floats); plane0d past the determinant test (32).
BEAM_OPS = {"beam1d": (36, 21, 68), "beam3d": (30, 17, 57),
            "plane0d": (23, 32, 109)}
# beam3d's integer operations per drawn word: threefry2x32's 20 rounds of
# add, two shifts, or and xor, its 5 key injections of 3 adds, the key
# schedule's 2 xors and 2 adds, and the float conversion's 4
BEAM_INT_OPS = 20 * 5 + 5 * 3 + 4 + 4
# 132 SMs x 64 INT32 lanes x 1.98 GHz (the Hopper SM holds half as many
# INT32 as FP32 units; NVIDIA's Hopper architecture white paper)
PEAK_INT32_S = 132 * 64 * 1.98e9
# the gvpm beam volumes' gradient sweeps (ops/beam_sweep.GKINDS): their
# main path is the gvpm pass at the goldens' 128^2 check config with ME
# off (tools/goldens.py::_run_check's gradient config; gold_cfgs below)
GBEAM_VOLUMES = {"gbeam1d": "beam1d", "gbeam3d": "beam3d",
                 "gplane0d": "plane0d"}
GBEAM_REPLACES = {
    "gbeam1d": "gvpm_tpu/integrators/gradient_gather.py:1232",
    "gbeam3d": "gvpm_tpu/integrators/gradient_gather.py:1580",
    "gplane0d": "gvpm_tpu/integrators/gradient_gather.py:1960"}
# launches per gvpm pass at the check config (beam3d: one segment chunk
# x volume_samples = 2); the ME instantiations' the same
GBEAM_LAUNCHES = {"gbeam1d": 1, "gbeam3d": 2, "gplane0d": 1}
# the ME instantiations replace the ME pair collection of the same loops
GBEAM_ME_REPLACES = {
    "gbeam1d_me": "gvpm_tpu/integrators/gradient_gather.py:1346",
    "gbeam3d_me": "gvpm_tpu/integrators/gradient_gather.py:1710",
    "gplane0d_me": "gvpm_tpu/integrators/gradient_gather.py:2091"}
# the plain version checks the first 1 / PLAIN_EVERY of an ME sweep's
# valid queries
PLAIN_EVERY = 4
GBEAM_GOLD_PASSES = {"beam1d": 10, "beam3d": 10, "plane0d": 30}
# operations counted from csrc/beam_eval.cuh's gradient functors, one
# per add, multiply, divide, compare, select, clamp, sqrtf and expf, on
# box_medium's path (diffuse and medium parents; parent_lobe 112 as in
# BODY_OPS; phase_params evaluates its HG and Rayleigh branches): (every
# pair of a valid query and a beam in its medium and the pairs of the
# second stage, as BEAM_OPS; each accepted pair's base term, its
# accumulation and the tail's load; each shift of an accepted pair on a
# reconnectable beam: the re-emitted beam, parent_lobe and the ratios,
# MIS and the six accumulations; each identity shift).
GBEAM_OPS = {"gbeam1d": (36, 21, 58, 241, 150),
             "gbeam3d": (30, 17, 50, 265, 120),
             "gplane0d": (23, 32, 110, 375, 165)}
# an ME sweep's accepted pair on an ME-eligible beam: the key and count
# (2), and per offset no shift, only the MIS weight and the six
# accumulations (ME_OPS_OFFSET)
ME_OPS_PAIR = 2
ME_OPS_OFFSET = 20
BALL_OPS = {"volume": 11, "surface": 20}
BODY_OPS = {"volume": 46 + 4 * (112 + 86 + 49),
            "surface": 51 + 4 * (112 + 104 + 56)}
ME_OPS = 4          # per visit: three mask terms and the integer min


START = time.perf_counter()


def phase(name, msg):
    """One result line, with the seconds since the script started."""
    print(f"[{name}] (t={time.perf_counter() - START:.0f} s) {msg}",
          flush=True)


def profile_pass(run, name="gather_dense"):
    """One call of `run` under torch.profiler (CPU + CUDA): returns
    (device kernel launches, device-busy share of the profiled wall
    time, share of device kernel time inside record_function ranges named
    `name` or None where none was attributed, how it was attributed,
    profiled wall seconds). Busy time is the union of the kernels'
    intervals; the profiler slows the host, so the busy share reads low
    against an unprofiled pass."""
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
    # device-side ranges of the `name` annotation, where the profiler
    # reports them; every other device event is work
    ann = [(e.time_range.start, e.time_range.end) for e in on_card
           if e.name == name]
    kernels = sorted((e.time_range.start, e.time_range.end) for e in on_card
                     if e.name != name
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
                        if e.name == name and e.device_type != cuda)
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


def beam_bound(kind, q, rows, stats, accepted):
    """The least time the card could take for one sweep on these inputs:
    the larger of the bytes that must move over the memory rate (each
    query row, beam row, beam key and output once) and the operations
    these inputs need (BEAM_OPS: every pair of a valid query and a beam
    in its medium, the pairs of the second stage, the accepted pairs) at
    the float32 rate, beam3d's threefry words at the INT32 rate.
    Returns (ms, "bytes" | "operations", detail)."""
    from gvpm_tpu_torch.ops import beam_sweep as bs
    M, N = q.shape[0], rows.shape[0]
    valid = q[:, bs.QSLOT["valid"]] > 0.5
    q_med = q[valid, bs.QSLOT["med"]].to(torch.int64)
    b_med = rows[:, bs.BSLOT["med"]].to(torch.int64)
    n_med = int(max(q_med.max(), b_med.max())) + 1 if q_med.numel() else 1
    pairs = int(torch.bincount(b_med, minlength=n_med)[q_med].sum())
    n_bytes = 4 * (M * bs.QW + N * bs.BW + M * 4) \
        + (16 * N if kind == "beam3d" else 0)
    a, b, c = BEAM_OPS[kind]
    fops = pairs * a + stats["stage2"] * b + accepted * c
    iops = stats["stage2"] * BEAM_INT_OPS if kind == "beam3d" else 0
    t = dict(bytes=n_bytes / PEAK_BYTES_S * 1e3,
             operations=max(fops / PEAK_FP32_S, iops / PEAK_INT32_S) * 1e3)
    by = max(t, key=t.get)
    return t[by], by, dict(
        queries=M, valid_queries=int(valid.sum()), beams=N, pairs=pairs,
        stage2=stats["stage2"], accepted=accepted, bytes=n_bytes,
        float_ops=fops, int_ops=iops, float_ms=fops / PEAK_FP32_S * 1e3,
        int_ms=iops / PEAK_INT32_S * 1e3,
        float_unfused_ms=fops / PEAK_FP32_UNFUSED_S * 1e3)


def gbeam_bound(kind, q, rows, stats):
    """beam_bound for a gradient sweep (GBEAM_OPS): the bytes of the
    query, offset, beam, tail, key and output rows once; the operations
    of every pair, of the second stage, of the accepted pairs' base
    terms and of their four shifts by branch (an ME sweep's pairs on
    ME-eligible beams: ME_OPS_PAIR and ME_OPS_OFFSET). Returns (ms,
    "bytes" | "operations", detail)."""
    from gvpm_tpu_torch.ops import beam_sweep as bs
    M, N = q.shape[0], rows.shape[0]
    valid = q[:, bs.QSLOT["valid"]] > 0.5
    q_med = q[valid, bs.QSLOT["med"]].to(torch.int64)
    b_med = rows[:, bs.BSLOT["med"]].to(torch.int64)
    n_med = int(max(q_med.max(), b_med.max())) + 1 if q_med.numel() else 1
    pairs = int(torch.bincount(b_med, minlength=n_med)[q_med].sum())
    nf, nc = bs._widths(kind)
    base = kind.removesuffix("_me")
    n_bytes = 4 * (M * (bs.QW + bs.XW + nf + nc) + N * (bs.BW + bs.TW)) \
        + (16 * N if base == "gbeam3d" else 0)
    a, b, c, d, e = GBEAM_OPS[base]
    acc, rc, me = stats["accepted"], stats["reconn"], stats.get("me", 0)
    fops = pairs * a + stats["stage2"] * b + acc * c + me * ME_OPS_PAIR \
        + 4 * (rc * d + (acc - rc - me) * e + me * ME_OPS_OFFSET)
    iops = stats["stage2"] * BEAM_INT_OPS if base == "gbeam3d" else 0
    t = dict(bytes=n_bytes / PEAK_BYTES_S * 1e3,
             operations=max(fops / PEAK_FP32_S, iops / PEAK_INT32_S) * 1e3)
    by = max(t, key=t.get)
    return t[by], by, dict(
        queries=M, valid_queries=int(valid.sum()), beams=N, pairs=pairs,
        stage2=stats["stage2"], accepted=acc, reconnectable=rc,
        me_eligible=me, bytes=n_bytes, float_ops=fops, int_ops=iops,
        float_ms=fops / PEAK_FP32_S * 1e3, int_ms=iops / PEAK_INT32_S * 1e3,
        float_unfused_ms=fops / PEAK_FP32_UNFUSED_S * 1e3)


def capture_gsweeps(scene, cfg, passes_kw):
    """One gvpm pass of each beam volume on `scene`; returns {kind: the
    (q, qx, rows, tails, params) of its first gradient sweep call} (the
    _me kinds with cfg.use_manifold)."""
    from gvpm_tpu_torch.integrators import gvpm
    from gvpm_tpu_torch.ops import beam_sweep as bs
    calls, orig = {}, bs.gsweep

    def record(kind, *args):
        calls.setdefault(kind, args)
        return orig(kind, *args)

    bs.gsweep = record
    try:
        for volume in GBEAM_VOLUMES.values():
            gvpm.render_pass(scene, cfg, volume, **passes_kw)
    finally:
        bs.gsweep = orig
    return calls


def gbeams_against_plain(kind, args):
    """The gradient sweep kernel twice and its plain version once on the
    same inputs: visits and shift_ok exactly equal, sums within TOL, the
    two launches bitwise equal. Returns (plain outputs, plain stats, max
    abs error, plain ms by CUDA events)."""
    from gvpm_tpu_torch.ops import beam_sweep as bs
    got = bs.gsweep(kind, *args)
    again = bs.gsweep(kind, *args)
    stats = {}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = bs.gsweep_plain(kind, *args, stats=stats)
    end.record()
    torch.cuda.synchronize()
    for g, w, name in zip(got[3:], want[3:], ("visits", "shift_ok")):
        if g.dtype != torch.int32 or not torch.equal(g, w):
            raise AssertionError(f"beam_sweep_{kind}: {name} differ from "
                                 "the plain version")
    for g, w in zip(got[:3], want[:3]):
        torch.testing.assert_close(g, w, **TOL)
    if not all(torch.equal(g.view(torch.int32), a.view(torch.int32))
               for g, a in zip(got, again)):
        raise AssertionError(f"beam_sweep_{kind}: two launches on the same "
                             "inputs differ")
    err = max(float((g - w).abs().max()) for g, w in zip(got[:3], want[:3]))
    return want, stats, err, start.elapsed_time(end)


def gsweep_stats(kind, q, rows, tails, p):
    """gsweep_plain's stats (stage2, accepted, reconn, me) of every pair
    from its dense base test alone, without the shifts."""
    from gvpm_tpu_torch.ops import beam_sweep as bs
    M, N = q.shape[0], rows.shape[0]
    base_fn, _ = bs.GPAIRS[kind.removesuffix("_me")]
    tb = max(1, min(N, max(256, bs.PLAIN_MAX_PAIRS // max(M, 1))))
    mc = max(1, min(M, bs.PLAIN_MAX_PAIRS // tb))
    rc = tails[:, bs.TSLOT["reconnectable"]]
    stats = dict(stage2=0, accepted=0, reconn=0, me=0)
    for m0 in range(0, M, mc):
        qc = bs._Cols(q[m0:m0 + mc], bs.QSLOT, (-1, 1))
        for j0 in range(0, N, tb):
            pp = dataclasses.replace(p, keys=p.keys[j0:j0 + tb]) \
                if p.keys is not None else p
            okb, _, stage2 = base_fn(
                qc, bs._Cols(rows[j0:j0 + tb], bs.BSLOT, (1, -1)), pp, m0)
            r = rc[j0:j0 + tb][None]
            stats["stage2"] += int(stage2.sum())
            stats["accepted"] += int(okb.sum())
            stats["reconn"] += int((okb & (r > 0.5)).sum())
            stats["me"] += int((okb & (r < -0.5)).sum())
    return stats


def gbeams_me_against_plain(kind, args):
    """An ME sweep's kernel twice on every query and its plain version
    once on the first 1 / PLAIN_EVERY of the valid queries (the segment
    compaction puts the valid ones first; a prefix keeps beam3d's words,
    which are indexed by the query's row): visits, shift_ok, ME key, ME
    pairs and gbeam3d_me's chord point exactly equal on those rows, sums
    within TOL, the two launches bitwise equal. Returns (kernel outputs,
    plain ms, max abs error, rows compared, ME queries among them)."""
    from gvpm_tpu_torch.ops import beam_sweep as bs
    q, qx, rows, tails, p = args
    got = bs.gsweep(kind, *args)
    again = bs.gsweep(kind, *args)
    valid = q[:, bs.QSLOT["valid"]] > 0.5
    n = max(1, int(valid.sum()) // PLAIN_EVERY)
    if not bool(valid[:n].all()):
        raise AssertionError(f"beam_sweep_{kind}: the first {n} queries "
                             "are not all valid")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = bs.gsweep_plain(kind, q[:n], qx[:n], rows, tails, p)
    end.record()
    torch.cuda.synchronize()
    for k, name in ((3, "visits"), (4, "shift_ok"), (5, "ME key"),
                    (6, "ME pairs")):
        if got[k].dtype != torch.int32 or not torch.equal(got[k][:n],
                                                          want[k]):
            raise AssertionError(f"beam_sweep_{kind}: {name} differ from "
                                 "the plain version")
    if (got[7] is None) != (kind != "gbeam3d_me") or (
            got[7] is not None and not torch.equal(
                got[7][:n].view(torch.int32), want[7].view(torch.int32))):
        raise AssertionError(f"beam_sweep_{kind}: chord points differ from "
                             "the plain version")
    me_queries = int((want[5] != bs.ME_NONE).sum())
    if not me_queries > 0:
        raise AssertionError(f"beam_sweep_{kind}: no ME pair on the rows "
                             "compared")
    pairs = [(got[0][:n], want[0])] + [(got[k][:, :n], want[k])
                                       for k in (1, 2)]
    for g, w in pairs:
        torch.testing.assert_close(g, w, **TOL)
    if not all(torch.equal(g.view(torch.int32), a.view(torch.int32))
               for g, a in zip(got, again) if g is not None):
        raise AssertionError(f"beam_sweep_{kind}: two launches on the same "
                             "inputs differ")
    err = max(float((g - w).abs().max()) for g, w in pairs)
    return got, start.elapsed_time(end), err, n, me_queries


def capture_sweeps(scene, cfg, passes_kw):
    """One SPPM pass of each beam estimator on `scene`; returns {kind:
    the (q, rows, params) of its first sweep call}."""
    from gvpm_tpu_torch.integrators import sppm
    from gvpm_tpu_torch.ops import beam_sweep as bs
    calls, orig = {}, bs.sweep

    def record(kind, *args):
        calls.setdefault(kind, args)
        return orig(kind, *args)

    bs.sweep = record
    try:
        for kind in bs.KINDS:
            sppm.render_pass(scene, cfg, kind, **passes_kw)
    finally:
        bs.sweep = orig
    return calls


def beams_against_plain(kind, q, rows, p):
    """The sweep kernel twice and its plain version once on the same
    inputs: accepted-pair counts exactly equal, sums within TOL, the two
    launches bitwise equal. Returns (plain sums, plain counts, plain
    stats, max abs error)."""
    from gvpm_tpu_torch.ops import beam_sweep as bs
    got, got_n = bs.sweep(kind, q, rows, p)
    again, again_n = bs.sweep(kind, q, rows, p)
    stats = {}
    want, want_n = bs.sweep_plain(kind, q, rows, p, stats=stats)
    torch.cuda.synchronize()
    if got_n.dtype != torch.int32 or not torch.equal(got_n, want_n):
        raise AssertionError(f"beam_sweep_{kind}: accepted-pair counts "
                             "differ from the plain version")
    torch.testing.assert_close(got, want, **TOL)
    if not (torch.equal(got.view(torch.int32), again.view(torch.int32))
            and torch.equal(got_n, again_n)):
        raise AssertionError(f"beam_sweep_{kind}: two launches on the same "
                             "inputs differ")
    return want, want_n, stats, float((got - want).abs().max())


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
    from gvpm_tpu_torch.core.config import GradientConfig, PhotonConfig
    from gvpm_tpu_torch.integrators import gradient_gather, gvpm, sppm
    from gvpm_tpu_torch.ops import fused_gather as fg
    from gvpm_tpu_torch.utils import image as imglib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi, flush=True)
    phase("device", f"torch {torch.__version__} cuda {torch.version.cuda}, "
                    f"{torch.cuda.device_count()} device(s)")

    from gvpm_tpu_torch.ops import beam_sweep as bs
    t0 = time.perf_counter()
    # one nvcc for each kernel source, started together
    errors = []

    def build(lib):
        try:
            lib.build()
        except Exception as e:              # noqa: BLE001 -- raised below
            errors.append(e)

    threads = [threading.Thread(target=build, args=(lib,))
               for lib in (fg, bs)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    phase("build", f"fused_gather and beam_sweep kernels built in "
                   f"{time.perf_counter() - t0:.2f} s; ptxas per "
                   f"instantiation (registers a thread, bytes): "
                   f"{json.dumps(fg.build_report())}; beam_sweep "
                   f"{json.dumps(bs.build_report())}")

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
        # against_plain's call of the plain version was its warm-up
        plain_ms = cuda_ms(lambda: fg.fused_gather_plain(ev, *args), 1,
                           warm=0)
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

    # ---- 3c. the beam / plane sweeps on one 128^2 check-config pass ----
    bscene = scenes.box_medium(128, 128)
    bcfg = PhotonConfig(**BEAM_GOLD_KW)
    b_pass = dict(n_photons=max(bcfg.surface_photons, bcfg.volume_photons),
                  seed=5, it=0, surf_scale=1.0, vol_scale=1.0,
                  r_vol_base=sppm.base_volume_radius(bscene, bcfg))
    beam_kernels = {}
    for kind, (q, rows, p) in capture_sweeps(bscene, bcfg, b_pass).items():
        want, n_acc, st, err = beams_against_plain(kind, q, rows, p)
        accepted = int(n_acc.sum())
        bound_ms, bound_by, detail = beam_bound(kind, q, rows, st, accepted)
        ms = cuda_ms(lambda: bs.sweep(kind, q, rows, p), 5)
        plain_ms = cuda_ms(lambda: bs.sweep_plain(kind, q, rows, p), 1,
                           warm=0)
        beam_kernels[kind] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  bound_ms=bound_ms, bound_by=bound_by)
        phase("beams", f"{kind}: {q.shape[0]} camera queries x "
                       f"{rows.shape[0]} beams (valid of "
                       f"{bscene.width}^2 x {BEAM_GOLD_KW['surface_photons']}"
                       f" paths), accepted pairs {accepted} equal, max|err| "
                       f"{err:.3g} (rtol 2e-4 atol 5e-6), two launches "
                       f"bitwise equal, kernel {ms:.3f} ms, plain "
                       f"{plain_ms:.1f} ms, bound {bound_ms:.4f} ms by "
                       f"{bound_by} {json.dumps(detail)}")
    del q, rows, p, want, n_acc

    # ---- 3d. the gradient sweeps on one 128^2 check-config gvpm pass ----
    gcfg = GradientConfig(**GVPM_GOLD_KW)
    g_pass = dict(n_photons=max(gcfg.surface_photons, gcfg.volume_photons),
                  seed=5, it=0, surf_scale=1.0, vol_scale=1.0,
                  r_vol_base=sppm.base_volume_radius(bscene, gcfg))
    for kind, args in capture_gsweeps(bscene, gcfg, g_pass).items():
        q, qx, rows, tails, p = args
        want, st, err, plain_ms = gbeams_against_plain(kind, args)
        bound_ms, bound_by, detail = gbeam_bound(kind, q, rows, st)
        ms = cuda_ms(lambda: bs.gsweep(kind, *args), 3)
        beam_kernels[kind] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  bound_ms=bound_ms, bound_by=bound_by)
        phase("gbeams", f"{kind}: {q.shape[0]} camera queries x "
                        f"{rows.shape[0]} beams, visits "
                        f"{int(want[3].sum())} and shift_ok "
                        f"{int(want[4].sum())} equal, max|err| {err:.3g} "
                        f"(rtol 2e-4 atol 5e-6), two launches bitwise "
                        f"equal, kernel {ms:.3f} ms, plain {plain_ms:.1f} "
                        f"ms (shifts on the accepted pairs only), bound "
                        f"{bound_ms:.4f} ms by {bound_by} "
                        f"{json.dumps(detail)}")
    del q, qx, rows, tails, p, args, want

    # ---- 3e. their ME instantiations on one 128^2 gvpm ME pass ----
    gcfg_me = GradientConfig(**dict(GVPM_GOLD_KW, use_manifold=True))
    for kind, args in capture_gsweeps(bscene, gcfg_me, g_pass).items():
        q, qx, rows, tails, p = args
        got, plain_ms, err, n_rows, me_q = gbeams_me_against_plain(kind,
                                                                   args)
        st = gsweep_stats(kind, q, rows, tails, p)
        if st["accepted"] != int(got[3].sum()):
            raise AssertionError(f"beam_sweep_{kind}: the dense base test "
                                 "counts other pairs than the kernel")
        bound_ms, bound_by, detail = gbeam_bound(kind, q, rows, st)
        ms = cuda_ms(lambda: bs.gsweep(kind, *args), 3)
        beam_kernels[kind] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  bound_ms=bound_ms, bound_by=bound_by)
        n_elig = int((tails[:, bs.TSLOT["reconnectable"]] < -0.5).sum())
        chords = " and chord points" if got[7] is not None else ""
        phase("gbeams-me", f"{kind}: {q.shape[0]} camera queries x "
                           f"{rows.shape[0]} beams ({n_elig} ME-eligible), "
                           f"visits {int(got[3].sum())}, "
                           f"shift_ok {int(got[4].sum())}, ME queries "
                           f"{int((got[5] != bs.ME_NONE).sum())} with "
                           f"{int(got[6].sum())} ME pairs; on the first "
                           f"{n_rows} rows (1/{PLAIN_EVERY} of the valid "
                           f"queries, {me_q} with an ME pair) visits, "
                           f"shift_ok, ME keys, counts{chords} equal, "
                           f"max|err| {err:.3g} (rtol 2e-4 atol 5e-6), two "
                           f"launches bitwise equal, kernel "
                           f"{ms:.3f} ms, plain {plain_ms:.1f} ms on those "
                           f"rows, bound {bound_ms:.4f} ms by {bound_by} "
                           f"{json.dumps(detail)}")
    del q, qx, rows, tails, p, args, got

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
    # ---- 4c. the SPPM pass of each new volume estimator at 128^2 ----
    main_launches = {}
    for volume in ("bre", "beam1d", "beam3d", "plane0d"):
        for k in bs.LAUNCHES:
            bs.LAUNCHES[k] = 0
        timings = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = sppm.render_pass(bscene, bcfg, volume, **dict(b_pass, it=1),
                               timings=timings)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        swept = dict(bs.LAUNCHES)
        expect = dict.fromkeys(bs.LAUNCHES, 0)
        expect.update({volume: BEAM_LAUNCHES[volume]}
                      if volume in BEAM_LAUNCHES else {})
        if swept != expect:
            raise AssertionError(f"sppm {volume}: beam_sweep launches "
                                 f"{swept}, expected {expect}")
        main_launches.update({volume: swept[volume]}
                             if volume in BEAM_LAUNCHES else {})
        if not (bool(torch.isfinite(img).all()) and float(img.mean()) > 0):
            raise AssertionError(f"sppm {volume}: image not finite / dark")
        phase("sppm-128", f"{volume}: one pass of 128x128, "
                          f"{b_pass['n_photons']} paths (after a warm-up "
                          f"pass) {secs:.4f} s, image mean "
                          f"{float(img.mean()):.5g}; phase split s "
                          + json.dumps({k: round(v, 4)
                                        for k, v in timings.items()})
                          + f"; beam_sweep launches {swept}")

    # ---- 4e. the gvpm beam volumes at 128^2 and at the bench's full
    # beam config ----
    def gvpm_beam_pass(volume, cfg_, pass_kw, label, expect):
        """One gvpm beam pass, its sweep launches (and with ME the
        surface gather's) counted from 0; with ME the beam ME pairs
        taken (counted where the beam gathers compact them) must be
        above 0."""
        beam_pairs, me_pairs = [0], gradient_gather._me_pairs

        def count_pairs(*a, **k):
            out = me_pairs(*a, **k)
            beam_pairs[0] += out[0].shape[0]
            return out

        for k in bs.LAUNCHES:
            bs.LAUNCHES[k] = 0
        for k in fg.LAUNCHES:
            fg.LAUNCHES[k] = 0
        timings = {}
        gradient_gather._me_pairs = count_pairs
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = gvpm.render_pass(bscene, cfg_, volume, **pass_kw,
                                   timings=timings)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            gradient_gather._me_pairs = me_pairs
        swept, gathered = dict(bs.LAUNCHES), dict(fg.LAUNCHES)
        if swept != dict(dict.fromkeys(bs.LAUNCHES, 0), **expect):
            raise AssertionError(f"gvpm {volume}: beam_sweep launches "
                                 f"{swept}, expected {expect}")
        surf = "surface_me" if cfg_.use_manifold else "surface"
        if gathered != dict(dict.fromkeys(fg.LAUNCHES, 0), **{surf: 1}):
            raise AssertionError(f"gvpm {volume}: fused_gather launches "
                                 f"{gathered}")
        if not all(bool(torch.isfinite(a).all()) for a in out[:3]):
            raise AssertionError(f"gvpm {volume}: non-finite pass buffers")
        if cfg_.use_manifold and not beam_pairs[0] > 0:
            raise AssertionError(f"gvpm {volume}: no beam ME pair taken")
        me = (f", ME pairs {int(out[3]['me_pairs'])} (of the beams "
              f"{beam_pairs[0]}), me_dropped {int(out[3]['me_dropped'])}"
              if cfg_.use_manifold else "")
        phase(label, f"gvpm {volume}: one pass {secs:.4f} s, visits "
                     f"{int(out[3]['visits'])}, shift_ok "
                     f"{int(out[3]['shift_ok'])}{me}; phase split s "
                     + json.dumps({k: round(v, 4)
                                   for k, v in timings.items()
                                   if not k.startswith("me:")})
                     + (("; me: parts s " + json.dumps(
                         {k[3:]: round(v, 4) for k, v in timings.items()
                          if k.startswith("me:")}))
                        if cfg_.use_manifold else "")
                     + f"; beam_sweep launches {swept}, fused_gather "
                       f"launches {gathered}")
        return swept

    for kind, volume in GBEAM_VOLUMES.items():
        swept = gvpm_beam_pass(volume, gcfg, dict(g_pass, it=1), "gvpm-128",
                               {kind: GBEAM_LAUNCHES[kind]})
        main_launches[kind] = swept[kind]
    fcfg = GradientConfig(**GBEAM_FULL_KW)
    f_pass = dict(n_photons=max(fcfg.surface_photons, fcfg.volume_photons),
                  seed=5, it=0, surf_scale=1.0, vol_scale=1.0,
                  r_vol_base=sppm.base_volume_radius(bscene, fcfg))
    n_seg = bscene.width * bscene.height * fcfg.vol_segments_per_pixel
    for kind, volume in GBEAM_VOLUMES.items():
        expect = {kind: (-(-n_seg // fcfg.beam_seg_tile)
                         * fcfg.volume_samples if kind == "gbeam3d" else 1)}
        gvpm_beam_pass(volume, fcfg, f_pass, "gvpm-full", expect)  # warm
        gvpm_beam_pass(volume, fcfg, dict(f_pass, it=1), "gvpm-full",
                       expect)
    # ---- 4f. the same with the default use_manifold=True ----
    for kind, volume in GBEAM_VOLUMES.items():
        swept = gvpm_beam_pass(volume, gcfg_me, dict(g_pass, it=1),
                               "gvpm-128-me",
                               {kind + "_me": GBEAM_LAUNCHES[kind]})
        main_launches[kind + "_me"] = swept[kind + "_me"]
    fcfg_me = GradientConfig(**dict(GBEAM_FULL_KW, use_manifold=True))
    n_chunks = -(-n_seg // fcfg_me.beam_seg_tile)
    for kind, volume in GBEAM_VOLUMES.items():
        expect = {kind + "_me": n_chunks * (fcfg_me.volume_samples
                                            if kind == "gbeam3d" else 1)}
        gvpm_beam_pass(volume, fcfg_me, f_pass, "gvpm-full-me", expect)
        gvpm_beam_pass(volume, fcfg_me, dict(f_pass, it=1), "gvpm-full-me",
                       expect)

    # ---- 4d. the G-VPM bre pass at the headline size (default ME) ----
    for k in fg.LAUNCHES:
        fg.LAUNCHES[k] = 0
    timings = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_bre, gx_bre, gy_bre, st_bre = gvpm.render_pass(
        scene, cfg_me, "bre", n_photons, 5, 1, 1.0, 1.0, r_vol_base,
        timings=timings)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    bre_launches = dict(fg.LAUNCHES)
    if bre_launches != dict(none, surface_me=1):
        raise AssertionError(f"gvpm bre: fused_gather launches "
                             f"{bre_launches}")
    if not all(bool(torch.isfinite(a).all()) for a in (p_bre, gx_bre, gy_bre)):
        raise AssertionError("gvpm bre: non-finite pass buffers")
    phase("bre", f"gvpm bre, 512x512, {n_photons} paths, default ME: one "
                 f"pass {secs:.4f} s, visits {int(st_bre['visits'])}, "
                 f"shift_ok {int(st_bre['shift_ok'])}, ME pairs "
                 f"{int(st_bre['me_pairs'])}; fused_gather launches "
                 f"{bre_launches}; phase split s " + json.dumps(
                     {k: round(v, 4) for k, v in timings.items()
                      if not k.startswith("me:")}))
    del scene, out, img, p_bre, gx_bre, gy_bre

    # ---- 5. golden bars ----
    ci = dict(surface_photons=1 << 15, volume_photons=1 << 15, max_depth=12,
              use_manifold=False, passes=12)
    gold_cfgs = [
        ("ci", "ME off", ci),
        ("ci", "ME on", dict(ci, use_manifold=True)),
        (".", "ME off", dict(GVPM_GOLD_KW, passes=10))]
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
    for sub, volume, passes in SPPM_BEAM_GOLD:
        gdir = os.path.normpath(os.path.join(ROOT, "goldens", sub))
        with open(os.path.join(gdir, "meta.json")) as f:
            meta = json.load(f)
        size = meta["size"]
        bar = meta["scenes"]["box-medium"]["thresholds"][f"sppm:{volume}"]
        t0 = time.perf_counter()
        res = sppm.render(scenes.box_medium(size, size), PhotonConfig(
            **(SPPM_GOLD[0][1] if sub == "ci" else BEAM_GOLD_KW)),
            volume=volume, seed=5, passes=passes)
        img = res["image"].cpu().numpy()
        if not np.isfinite(img).all():
            raise AssertionError(f"sppm:{volume} golden {size}: non-finite")
        r = imglib.relmse(img, imglib.read_pfm(
            os.path.join(gdir, "box-medium_ref.pfm")))
        phase("goldens", f"box-medium sppm:{volume} {size}^2 {passes} "
                         f"passes: relMSE {r:.5f} (bar {bar}) in "
                         f"{time.perf_counter() - t0:.2f} s")
        if not r <= bar:
            raise AssertionError(f"sppm:{volume} golden {size}: relMSE {r} "
                                 f"> {bar}")
    # gvpm:bre has no recorded bar: its relMSE is reported, the images
    # must be finite and the reconstruction's mean near the primal's
    kw = dict(gold_cfgs[2][2])
    passes = kw.pop("passes")
    t0 = time.perf_counter()
    res = gvpm.render(scenes.box_medium(128, 128), GradientConfig(**kw),
                      volume="bre", seed=5, passes=passes)
    for k in ("primal", "gx", "gy", "image"):
        if not bool(torch.isfinite(res[k]).all()):
            raise AssertionError(f"gvpm:bre 128: non-finite {k}")
    mp, mr = float(res["primal"].mean()), float(res["image"].mean())
    if not abs(mr / mp - 1.0) < 0.25:
        raise AssertionError(f"gvpm:bre 128: recon mean {mr} vs primal {mp}")
    r = imglib.relmse(res["image"].cpu().numpy(), imglib.read_pfm(
        os.path.join(ROOT, "goldens", "box-medium_ref.pfm")))
    phase("goldens", f"box-medium gvpm:bre 128^2 {passes} passes, ME off: "
                     f"relMSE {r:.5f} (no recorded bar), primal mean "
                     f"{mp:.5g}, recon mean {mr:.5g}, finite, in "
                     f"{time.perf_counter() - t0:.2f} s")
    # the gvpm beam volumes, ME off and on (no recorded bar): relMSE,
    # finite, the reconstruction's mean within 2% of the primal's, gx
    # against the golden's finite differences (tools/goldens.py:237-255)
    gref = imglib.read_pfm(os.path.join(ROOT, "goldens",
                                        "box-medium_ref.pfm"))
    fdx = gref[:, 1:] - gref[:, :-1]
    beam_gold = {}
    for label, cfg_ in (("ME off", gcfg), ("ME on", gcfg_me)):
        for volume, passes in GBEAM_GOLD_PASSES.items():
            t0 = time.perf_counter()
            res = gvpm.render(scenes.box_medium(128, 128), cfg_,
                              volume=volume, seed=5, passes=passes)
            for k in ("primal", "gx", "gy", "image"):
                if not bool(torch.isfinite(res[k]).all()):
                    raise AssertionError(f"gvpm:{volume} 128 {label}: "
                                         f"non-finite {k}")
            mp, mr = float(res["primal"].mean()), float(res["image"].mean())
            gx = res["gx"].cpu().numpy()
            corr = float(np.corrcoef(gx[:, :-1].ravel(), fdx.ravel())[0, 1])
            r = imglib.relmse(res["image"].cpu().numpy(), gref)
            beam_gold[(volume, label)] = r
            off = (f" (ME off {beam_gold[(volume, 'ME off')]:.5f})"
                   if label == "ME on" else "")
            phase("goldens", f"box-medium gvpm:{volume} 128^2 {passes} "
                             f"passes, {label}: relMSE {r:.5f}{off} (no "
                             f"recorded bar), primal mean {mp:.5g}, recon "
                             f"mean {mr:.5g} ({mr / mp - 1.0:+.2%}), "
                             f"gx~FD(golden) correlation {corr:.3f} (> "
                             f"0.5), finite, in "
                             f"{time.perf_counter() - t0:.2f} s")
            if not abs(mr / mp - 1.0) < 0.02:
                raise AssertionError(f"gvpm:{volume} 128 {label}: recon "
                                     f"mean {mr} vs primal {mp}")
            if not corr > 0.5:
                raise AssertionError(f"gvpm:{volume} 128 {label}: gx "
                                     f"correlation {corr}")
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
        for n, k in kernels.items()] + [
        dict(name=f"beam_sweep_{n}", route="cuda",
             source="gvpm_tpu_torch/csrc/beam_sweep.cu",
             replaces={**BEAM_REPLACES, **GBEAM_REPLACES,
                       **GBEAM_ME_REPLACES}[n],
             launches=main_launches[n],
             max_abs_err=k["max_abs_err"], ms=k["ms"],
             plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
             bound_by=k["bound_by"],
             # no PyTorch call computes a pairwise sweep with this body
             library_ms=None)
        for n, k in beam_kernels.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
