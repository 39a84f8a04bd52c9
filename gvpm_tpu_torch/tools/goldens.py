"""Golden-image regression gate of the port (mirrors tools/goldens.py
`check`; the goldens themselves were generated by the JAX package).

    python3 gvpm_tpu_torch/tools/goldens.py check [GOLD_DIR] [SCENE ...]

renders each scene of GOLD_DIR/meta.json (default goldens/, the 128^2
artifact; goldens/ci is the 32^2 one) under every technique whose bar
the file records, at that artifact's size and check config, and holds
its relMSE against the committed golden under the bar; then holds the
correlation of a gvpm render's gx with the golden's finite differences
above 0.5 (the reference's computeGradientFinite, sppm.cpp:1144). Exit
code 1 if any check fails. Renders on the CUDA card unless --device
names another device.

The checks come from the thresholds each meta.json records: the JAX
tool's default list asks for gvpm:bre ... gvpm:plane0d, which
goldens/meta.json does not record (its lookup raises KeyError).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
GOLD = os.path.join(ROOT, "goldens")
# passes of a check (tools/goldens.py CHECKS): plane0d, 0D with no radius
# schedule, gets three times the budget
PASSES = 10
PLANE0D_FACTOR = 3
GX_BAR = 0.5


def _check_kw(size):
    """The check config of a technique at an artifact's size
    (tools/goldens.py::_check_kw) but its `beams`, which the JAX package
    reads nowhere and the port reads as a beam map: the goldens render
    every medium edge as a beam."""
    if size >= 128:
        return dict(max_depth=12, null_bounces=6, max_cam_depth=6,
                    surface_photons=1 << 16, volume_photons=1 << 16,
                    grid_hash_size=1 << 18,
                    initial_scale_volume=0.5, volume_samples=2,
                    vol_segments_per_pixel=2, grid_dims=(64, 64, 64))
    return dict(surface_photons=1 << 15, volume_photons=1 << 15,
                max_depth=12, grid_hash_size=1 << 15)


def plan(meta, scenes=None):
    """The checks of an artifact: [(scene, technique, passes, bar)] for
    every threshold meta.json records for each scene (all scenes, or
    those of `scenes` it holds), in the file's order."""
    names = tuple(meta["scenes"]) if scenes is None \
        else tuple(s for s in scenes if s in meta["scenes"])
    return [(name, tech,
             PASSES * (PLANE0D_FACTOR if tech.endswith("plane0d") else 1),
             bar)
            for name in names
            for tech, bar in meta["scenes"][name]["thresholds"].items()]


def run_check(name, tech, passes, size, gold_dir, device=None, seed=5):
    """relMSE of one technique's render against the golden."""
    from gvpm_tpu_torch import scenes
    from gvpm_tpu_torch.core.config import GradientConfig, PhotonConfig
    from gvpm_tpu_torch.integrators import gvpm, sppm
    from gvpm_tpu_torch.utils import image as imglib
    scene = scenes.get(name, width=size, height=size, device=device)
    ref = imglib.read_pfm(os.path.join(gold_dir, f"{name}_ref.pfm"))
    integ, _, vol = tech.partition(":")
    kw = _check_kw(size)
    if integ == "sppm":
        out = sppm.render(scene, PhotonConfig(**kw), volume=vol, seed=seed,
                          passes=passes)
    else:
        # ME off, as the bars were recorded
        gkw = dict(kw, use_manifold=False)
        if size >= 128:
            gkw.update(grid_surface_rows=1 << 19, grid_volume_rows=1 << 19)
        out = gvpm.render(scene, GradientConfig(**gkw), volume=vol,
                          seed=seed, passes=passes)
    img, _ = imglib.nan_scrub(out["image"].cpu().numpy())
    return imglib.relmse(img, ref)


def gradient_correlation(name, size, gold_dir, device=None):
    """Correlation of a gvpm:distance render's gx with the finite
    differences of the golden (tools/goldens.py:237-255)."""
    from gvpm_tpu_torch import scenes
    from gvpm_tpu_torch.core.config import GradientConfig
    from gvpm_tpu_torch.integrators import gvpm
    from gvpm_tpu_torch.utils import image as imglib
    scene = scenes.get(name, width=size, height=size, device=device)
    ref = imglib.read_pfm(os.path.join(gold_dir, f"{name}_ref.pfm"))
    out = gvpm.render(scene, GradientConfig(
        surface_photons=1 << 15, volume_photons=1 << 15, max_depth=12,
        grid_hash_size=1 << 15, use_manifold=False), volume="distance",
        seed=7, passes=10)
    gx = out["gx"].cpu().numpy()
    fdx = ref[:, 1:] - ref[:, :-1]
    return float(np.corrcoef(gx[:, :-1].ravel(), fdx.ravel())[0, 1])


def check(gold_dir=GOLD, scenes=None, device=None, out=sys.stdout):
    """relMSE regression gate against the committed goldens, then the gx
    correlation check of each scene checked; writes the table to `out`
    and returns 0 if every check passes, else 1."""
    with open(os.path.join(gold_dir, "meta.json")) as f:
        meta = json.load(f)
    size = meta["size"]
    checks = plan(meta, scenes)
    failed = []
    print(f"{'scene':<16}{'technique':<18}{'relMSE':>10}{'bar':>10}",
          file=out)
    for name, tech, n_passes, bar in checks:
        r = run_check(name, tech, n_passes, size, gold_dir, device)
        flag = "" if r <= bar else "  FAIL"
        print(f"{name:<16}{tech:<18}{r:>10.4f}{bar:>10.4f}{flag}", file=out,
              flush=True)
        if not r <= bar:
            failed.append((name, tech, r, bar))
    for name in dict.fromkeys(c[0] for c in checks):
        corr = gradient_correlation(name, size, gold_dir, device)
        flag = "" if corr > GX_BAR else "  FAIL"
        print(f"{name:<16}{'gvpm gx~FD(gold)':<18}{corr:>10.3f}"
              f"{GX_BAR:>10.2f}{flag}", file=out, flush=True)
        if not corr > GX_BAR:
            failed.append((name, "gx-corr", corr, GX_BAR))
    if failed:
        print("FAILED:", failed, file=out)
        return 1
    print("all parity checks pass", file=out)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("command", choices=["check"])
    ap.add_argument("gold_dir", nargs="?", default=GOLD)
    ap.add_argument("scenes", nargs="*", default=None)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    return check(args.gold_dir, scenes=args.scenes or None,
                 device=args.device)


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
