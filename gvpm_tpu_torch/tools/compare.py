"""Equal-time / equal-pass comparison harness of the port (mirrors
tools/compare.py; the reference's scripts/run.py, scripts/results/
run_mse.py, computeSpeedup.py): render a scene with each technique under
a shared wall-clock or pass budget, compute relMSE against a reference
image, and write a CSV + JSON summary.

    python3 gvpm_tpu_torch/tools/compare.py --scene box-medium \\
        --ref ref.pfm --techniques sppm:distance gvpm:distance \\
        --time-max 300 -o results/

Without --ref (or with a missing file) the reference is the port's
volpath run for --ref-seconds (at least one 8-spp render). --passes caps
every technique's passes (volpath and gpt: spp) besides the time budget.
A progressive technique stopped by the budget is scored on the image of
its passes so far (for gvpm and gpt the primal: the reconstruction runs
after the loop); the JAX tool has no image then and fails. Renders on
the CUDA card unless --device names another device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MANY = 100000       # passes of a technique held by the time budget alone


def render_reference(scene, seconds, seed=1234):
    """volpath renders of 8 spp, seed, seed + 1, ..., for `seconds` (at
    least one), averaged: the reference image [H,W,3] (numpy)."""
    from gvpm_tpu_torch.core.config import VolPathConfig
    from gvpm_tpu_torch.integrators import volpath
    img, it = 0.0, 0
    t0 = time.perf_counter()
    while it == 0 or time.perf_counter() - t0 < seconds:
        img = img + volpath.render(
            scene, VolPathConfig(spp=8, max_depth=12), seed=seed + it)
        it += 1
    return (img / it).cpu().numpy()


def run_technique(scene, tech, time_max, photons, seed, passes=None):
    """One technique under the time budget (None: none) and the pass cap
    (None: none): (output dict, wall seconds, per-pass seconds)."""
    from gvpm_tpu_torch.core.config import (GradientConfig, PhotonConfig,
                                            VolPathConfig)
    from gvpm_tpu_torch.integrators import gpt, gvpm, sppm, volpath
    integ, _, vol = tech.partition(":")
    t0 = time.perf_counter()
    times = []
    latest = {}
    n = passes or MANY

    class Budget(Exception):
        pass

    def cb(it, img, *_):
        times.append(time.perf_counter() - t0)
        latest["image"] = img
        if time_max and times[-1] > time_max:
            raise Budget

    try:
        if integ == "volpath":
            out = {"image": volpath.render(scene, VolPathConfig(
                spp=passes or 32, max_depth=12), seed=seed)}
        elif integ == "gpt":
            out = gpt.render(scene, VolPathConfig(spp=n, max_depth=12),
                             seed=seed, callback=cb)
        elif integ == "sppm":
            cfg = PhotonConfig(surface_photons=photons,
                               volume_photons=photons, max_passes=n)
            out = sppm.render(scene, cfg, volume=vol or "distance",
                              seed=seed, passes=n, callback=cb)
        elif integ == "gvpm":
            cfg = GradientConfig(surface_photons=photons,
                                 volume_photons=photons, max_passes=n)
            out = gvpm.render(scene, cfg, volume=vol or "distance",
                              seed=seed, passes=n, callback=cb)
        else:
            raise ValueError(f"unknown technique {tech}")
    except Budget:
        out = latest
    wall = time.perf_counter() - t0
    return out, wall, times


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="box-medium")
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--ref", default=None, help="reference PFM path")
    ap.add_argument("--ref-seconds", type=float, default=120.0)
    ap.add_argument("--techniques", nargs="+",
                    default=["sppm:distance", "sppm:bre", "sppm:beam1d",
                             "gvpm:distance"])
    ap.add_argument("--time-max", type=float, default=60.0)
    ap.add_argument("--passes", type=int, default=None,
                    help="pass cap of every technique (volpath, gpt: spp)")
    ap.add_argument("--photons", type=int, default=65536)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None)
    ap.add_argument("-o", "--output", default="results")
    args = ap.parse_args(argv)

    from gvpm_tpu_torch import scenes
    from gvpm_tpu_torch.utils import image as imglib

    os.makedirs(args.output, exist_ok=True)
    scene = scenes.get(args.scene, width=args.width, height=args.height,
                       device=args.device)

    if args.ref and os.path.exists(args.ref):
        ref = imglib.read_pfm(args.ref)
    else:
        print("rendering reference...", flush=True)
        ref = render_reference(scene, args.ref_seconds)
        imglib.write_pfm(os.path.join(args.output,
                                      f"{args.scene}_ref.pfm"), ref)

    rows = []
    for tech in args.techniques:
        print("technique", tech, flush=True)
        out, wall, times = run_technique(scene, tech, args.time_max,
                                         args.photons, args.seed,
                                         args.passes)
        img, _ = imglib.nan_scrub(out["image"].cpu().numpy())
        name = tech.replace(":", "_")
        imglib.write_pfm(os.path.join(args.output,
                                      f"{args.scene}_{name}.pfm"), img)
        imglib.write_png(os.path.join(args.output,
                                      f"{args.scene}_{name}.png"),
                         imglib.tonemap(img))
        row = dict(technique=tech, wall_s=round(wall, 2),
                   passes=len(times), relmse=imglib.relmse(img, ref),
                   mse=imglib.mse(img, ref))
        rows.append(row)
        print("  ", row, flush=True)

    with open(os.path.join(args.output, f"{args.scene}_summary.json"),
              "w") as f:
        json.dump(rows, f, indent=2)
    with open(os.path.join(args.output, f"{args.scene}_summary.csv"),
              "w") as f:
        f.write("technique,wall_s,passes,relmse,mse\n")
        for r in rows:
            f.write(f"{r['technique']},{r['wall_s']},{r['passes']},"
                    f"{r['relmse']:.6g},{r['mse']:.6g}\n")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
