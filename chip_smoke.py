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
                kernel's bound (see `bound_ms`).
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
  5. goldens  — box-medium gvpm:distance relMSE against the committed
                goldens at the goldens/ci (32^2) and goldens (128^2)
                configs with ME off, and at 32^2 with ME on, under the
                bars recorded in their meta.json.

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

# Published peaks of one H100 SXM at its full 700 W power limit (NVIDIA's
# data sheet): device memory rate and float32 rate outside the tensor
# cores. The kernels' bounds are stated against these.
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
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


def read_pfm(path):
    """PFM reader (same format as gvpm_tpu/utils/image.py::write_pfm)."""
    with open(path, "rb") as f:
        assert f.readline().strip() == b"PF"
        W, H = (int(v) for v in f.readline().split())
        scale = float(f.readline())
        data = np.frombuffer(f.read(W * H * 12),
                             dtype="<f4" if scale < 0 else ">f4")
    return np.flipud(data.reshape(H, W, 3)).copy()


def relmse(img, ref, eps=1e-3):
    """mean((a-b)^2/(ref^2+eps)), the repo's golden metric."""
    a = np.asarray(img, np.float64)
    b = np.asarray(ref, np.float64)
    return float(np.mean((a - b) ** 2 / (b * b + eps)))


def cuda_ms(fn, reps):
    """Mean milliseconds of `fn` over `reps` runs, by CUDA events."""
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


def kernel_bound(ev, slots, plan, tbl, qrows, candidates, visits):
    """The least time the card could take for this launch: the larger of
    the bytes that must move over the memory rate (once each: the slots
    the eval reads, `slots` = fused_gather.slots_read, of each table row
    that some run covers and of each query row, not the rows' padded
    widths; the run bounds; the outputs) and the float operations these
    inputs need (every candidate's ball test, every visit's shift body)
    over the float32 rate. Returns (ms, "bytes" | "operations", detail)."""
    Q = qrows.shape[0]
    rows = covered_rows(plan, tbl.shape[1])
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
                  bytes_ms=t_bytes, operations_ms=t_ops)
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

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi, flush=True)
    phase("device", f"torch {torch.__version__} cuda {torch.version.cuda}, "
                    f"{torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    fg.build()
    phase("build", f"fused_gather kernels built in "
                   f"{time.perf_counter() - t0:.2f} s")

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
    evals = {"surface": (gradient_gather.SURFACE_EVAL, "surface_me"),
             "volume": (gradient_gather.VOLUME_EVAL, "volume_me"),
             "surface_me": (gradient_gather.SURFACE_ME_EVAL, "surface_me"),
             "volume_me": (gradient_gather.VOLUME_ME_EVAL, "volume_me")}
    kernels = {}
    for name, (ev, inputs) in evals.items():
        plan, tbl, qrows, r2, k3, md = args = captured[inputs]
        got, got_me = fg.fused_gather(ev, *args)
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
        err = float((got - want).abs().max())
        candidates = int((plan.r1 - plan.r0).sum())
        visits = int(want[:, 27].sum())
        bound_ms, bound_by, detail = kernel_bound(
            ev, fg.slots_read(ev, md), plan, tbl, qrows, candidates, visits)
        ms = cuda_ms(lambda: fg.fused_gather(ev, *args), 10)
        plain_ms = cuda_ms(lambda: fg.fused_gather_plain(ev, *args), 1)
        kernels[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by)
        phase("kernels", f"{name}: {qrows.shape[0]} queries x "
                         f"{tbl.shape[1]} rows, candidates {candidates}, "
                         f"visits {visits} equal, ME queries {me_queries}"
                         f"{' (row keys equal)' if ev.me else ''}, max|err| "
                         f"{err:.3g} (rtol 2e-4 atol 5e-6), kernel "
                         f"{ms:.3f} ms, plain {plain_ms:.1f} ms, bound "
                         f"{bound_ms:.4f} ms by {bound_by} "
                         f"{json.dumps(detail)}")
    del captured, args, plan, tbl, qrows, got, want, got_me, want_me

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
    del scene

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
        r = relmse(img, read_pfm(os.path.join(gdir,
                                              "box-medium_ref.pfm")))
        seen[(size, label)] = r
        phase("goldens", f"box-medium gvpm:distance {size}^2 {passes} "
                         f"passes, {label}: relMSE {r:.5f} (bar {bar}) in "
                         f"{time.perf_counter() - t0:.2f} s")
        if not r <= bar:
            raise AssertionError(f"golden {size} {label}: relMSE {r} > "
                                 f"{bar}")
    phase("goldens", "32^2 relMSE ME off / ME on: "
                     f"{seen[(32, 'ME off')]:.5f} / "
                     f"{seen[(32, 'ME on')]:.5f}")

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
