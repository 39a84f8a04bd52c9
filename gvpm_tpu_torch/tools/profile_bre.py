"""Profile one G-VPM `bre` pass at the bench headline size on one GPU.

    python3 gvpm_tpu_torch/tools/profile_bre.py

box_medium 512x512, 2^18 light paths, the default use_manifold=True
(chip_smoke.HEADLINE_ME_KW): a warm-up pass (the process's first ME
stage pays its first-call costs), one pass timed with its phase split
(`timings`), then one pass under torch.profiler (chip_smoke.profile_pass)
with gradient_gather.bre_gather wrapped in record_function: device
kernel launches, the device-busy share and the plain gradient BRE
gather's share of device kernel time. The profiler's post-processing of
a pass's ~600k launches takes minutes, which is why this is a tool and
not a phase of chip_smoke.py (whose `[bre]` phase times the pass).
"""

import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_bre: needs a CUDA device")
    sys.path.insert(0, ROOT)
    import chip_smoke
    from gvpm_tpu_torch import scenes
    from gvpm_tpu_torch.core.config import GradientConfig
    from gvpm_tpu_torch.integrators import gradient_gather, gvpm, sppm
    from gvpm_tpu_torch.ops import fused_gather as fg

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fg.build()
    scene = scenes.box_medium(512, 512)
    cfg = GradientConfig(**chip_smoke.HEADLINE_ME_KW)
    n_photons = max(cfg.surface_photons, cfg.volume_photons)
    r_vol_base = sppm.base_volume_radius(scene, cfg)
    gvpm.render_pass(scene, cfg, "bre", n_photons, 5, 0, 1.0, 1.0,
                     r_vol_base)
    timings = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gvpm.render_pass(scene, cfg, "bre", n_photons, 5, 1, 1.0, 1.0,
                     r_vol_base, timings=timings)
    torch.cuda.synchronize()
    print(f"[bre] one pass {time.perf_counter() - t0:.4f} s; phase split "
          "s " + json.dumps({k: round(v, 4) for k, v in timings.items()
                             if not k.startswith("me:")}), flush=True)
    bre_fn = gradient_gather.bre_gather

    def traced_bre(*a, **k):
        with torch.profiler.record_function("bre_gather"):
            return bre_fn(*a, **k)

    gradient_gather.bre_gather = traced_bre
    try:
        t0 = time.perf_counter()
        n_launch, busy, share, how, wall = chip_smoke.profile_pass(
            lambda: gvpm.render_pass(scene, cfg, "bre", n_photons, 5, 2,
                                     1.0, 1.0, r_vol_base), "bre_gather")
    finally:
        gradient_gather.bre_gather = bre_fn
    print(f"[bre] one profiled pass (torch.profiler, {wall:.4f} s, "
          f"{time.perf_counter() - t0:.0f} s with the profiler's "
          f"processing): {n_launch} device kernel launches, device busy "
          f"{busy:.1%} of the pass, the plain gradient bre_gather "
          + (f"{share:.1%} of device kernel time ({how})"
             if share is not None else "not measured (no device time "
             "attributed to it)"), flush=True)


if __name__ == "__main__":
    main()
