"""Smoke run of the PyTorch + CUDA port (gvpm_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the exit code is non-zero:

  1. device   — a CUDA card is required (never falls back to the CPU);
                prints its name and power limit from nvidia-smi.
  2. build    — compiles the fused-gather kernel from the sources in
                gvpm_tpu_torch/csrc into gvpm_tpu_torch/_build/.
  3. kernels  — captures the gather inputs of one headline pass and runs
                each eval (surface, volume) through the CUDA kernel and
                through its plain PyTorch version on the same tensors:
                visits and shift_ok must be equal, the sums agree at
                rtol 2e-4 / atol 5e-6; prints both times.
  4. main     — gvpm.render at the bench headline size (512^2 box_medium,
                2^18 light paths, bench.py:347-362 without the TPU
                knobs), 3 passes: per-pass seconds, visits/s, phase split
                and the kernel launch counts (1 surface + 2 volume per
                pass); primal, gx, gy and the reconstruction are finite and
                the reconstruction mean is within 25% of the primal mean.
  5. goldens  — box-medium gvpm:distance relMSE against the committed
                goldens at the goldens/ci (32^2) and goldens (128^2)
                configs, under the bars recorded in their meta.json.

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
    from gvpm_tpu_torch.integrators import gvpm, sppm
    from gvpm_tpu_torch.ops import fused_gather as fg

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(smi, flush=True)
    phase("device", f"torch {torch.__version__} cuda {torch.version.cuda}, "
                    f"{torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    fg.build()
    phase("build", f"fused_gather kernels built in "
                   f"{time.perf_counter() - t0:.2f} s")

    # ---- 3. kernel vs plain on one headline pass's inputs ----
    scene = scenes.box_medium(512, 512, device=dev)
    cfg = GradientConfig(**HEADLINE_KW)
    n_photons = max(cfg.surface_photons, cfg.volume_photons)
    r_vol_base = sppm.base_volume_radius(scene, cfg)
    captured = {}
    launch = fg.fused_gather

    def capture(ev, *args):
        captured.setdefault(ev.name, (ev,) + args)
        return launch(ev, *args)

    fg.fused_gather = capture
    try:
        gvpm.render_pass(scene, cfg, "distance", n_photons, 5, 0, 1.0, 1.0,
                         r_vol_base)
    finally:
        fg.fused_gather = launch
    kernels = {}
    for name in ("surface", "volume"):
        ev, plan, tbl, qrows, r2, k3, md = captured[name]
        got = fg.fused_gather(ev, plan, tbl, qrows, r2, k3, md)
        want = fg.fused_gather_plain(ev, plan, tbl, qrows, r2, k3, md)
        torch.cuda.synchronize()
        if not torch.equal(got[:, 27:29], want[:, 27:29]):
            raise AssertionError(f"{name}: visits/shift_ok differ from the "
                                 "plain version")
        torch.testing.assert_close(got, want, **TOL)
        err = float((got - want).abs().max())
        ms = cuda_ms(lambda: fg.fused_gather(ev, plan, tbl, qrows, r2, k3,
                                             md), 10)
        plain_ms = cuda_ms(lambda: fg.fused_gather_plain(
            ev, plan, tbl, qrows, r2, k3, md), 1)
        kernels[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             queries=qrows.shape[0], rows=tbl.shape[1],
                             visits=int(want[:, 27].sum()))
        phase("kernels", f"{name}: {qrows.shape[0]} queries x "
                         f"{tbl.shape[1]} rows, visits "
                         f"{kernels[name]['visits']} equal, max|err| "
                         f"{err:.3g} (rtol 2e-4 atol 5e-6), kernel "
                         f"{ms:.3f} ms, plain {plain_ms:.1f} ms")
    del captured

    # ---- 4. the main path at the headline size ----
    marks = []

    def on_pass(it, _img, stats):
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), int(stats["visits"])))

    timings = {}
    for k in fg.LAUNCHES:
        fg.LAUNCHES[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = gvpm.render(scene, cfg, volume="distance", seed=5, passes=3,
                      callback=on_pass, timings=timings)
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    launches = dict(fg.LAUNCHES)
    starts = [t0] + [m[0] for m in marks[:-1]]
    pass_s = [m[0] - s for m, s in zip(marks, starts)]
    visits = [m[1] for m in marks]
    phase("main", f"512x512, {n_photons} paths, 3 passes: pass s "
                  f"{[round(s, 4) for s in pass_s]}, visits/pass {visits}, "
                  f"visits/s (passes 2-3) "
                  f"{sum(visits[1:]) / sum(pass_s[1:]):.4g}, total "
                  f"{t_all:.2f} s incl. Poisson")
    phase("main", "phase split s (3 passes): " + json.dumps(
        {k: round(v, 4) for k, v in timings.items()}))
    phase("main", f"launches {launches}")
    if launches != {"surface": 3, "volume": 6}:
        raise AssertionError(f"kernel launch counts {launches}")
    for k in ("primal", "gx", "gy", "image"):
        if out[k].shape != (512, 512, 3) or out[k].dtype != torch.float32:
            raise AssertionError(f"{k}: {out[k].dtype} {tuple(out[k].shape)}")
        if not bool(torch.isfinite(out[k]).all()):
            raise AssertionError(f"non-finite {k}")
    mp, mr = float(out["primal"].mean()), float(out["image"].mean())
    if not abs(mr / mp - 1.0) < 0.25:
        raise AssertionError(f"recon mean {mr} vs primal mean {mp}")
    phase("main", f"finite; primal mean {mp:.5g}, recon mean {mr:.5g}")
    del out, scene

    # ---- 5. golden bars ----
    gold_cfgs = {
        "ci": dict(surface_photons=1 << 15, volume_photons=1 << 15,
                   max_depth=12, use_manifold=False, passes=12),
        ".": dict(max_depth=12, null_bounces=6, max_cam_depth=6,
                  surface_photons=1 << 16, volume_photons=1 << 16,
                  initial_scale_volume=0.5, volume_samples=2,
                  vol_segments_per_pixel=2, grid_dims=(64, 64, 64),
                  grid_surface_rows=1 << 19, grid_volume_rows=1 << 19,
                  use_manifold=False, passes=10)}
    for sub, kw in gold_cfgs.items():
        gdir = os.path.normpath(os.path.join(ROOT, "goldens", sub))
        with open(os.path.join(gdir, "meta.json")) as f:
            meta = json.load(f)
        size = meta["size"]
        bar = meta["scenes"]["box-medium"]["thresholds"]["gvpm:distance"]
        kw = dict(kw)
        passes = kw.pop("passes")
        t0 = time.perf_counter()
        res = gvpm.render(scenes.box_medium(size, size, device=dev),
                          GradientConfig(**kw), volume="distance", seed=5,
                          passes=passes)
        img = res["image"].cpu().numpy()
        if not np.isfinite(img).all():
            raise AssertionError(f"golden {size}: non-finite image")
        r = relmse(img, read_pfm(os.path.join(gdir,
                                              "box-medium_ref.pfm")))
        phase("goldens", f"box-medium gvpm:distance {size}^2 {passes} "
                         f"passes: relMSE {r:.5f} (bar {bar}) in "
                         f"{time.perf_counter() - t0:.2f} s")
        if not r <= bar:
            raise AssertionError(f"golden {size}: relMSE {r} > {bar}")

    src = "gvpm_tpu_torch/csrc/fused_gather.cu"
    print(json.dumps({"kernels": [
        dict(name=f"fused_gather_{n}", route="cuda", source=src,
             replaces="gvpm_tpu/ops/pallas_gather.py:262",
             launches=launches[n], max_abs_err=k["max_abs_err"],
             ms=k["ms"], plain_ms=k["plain_ms"])
        for n, k in kernels.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
