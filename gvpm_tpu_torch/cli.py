"""Command-line renderer: `python -m gvpm_tpu_torch.cli scene args...`
(mirrors gvpm_tpu/cli.py).

The `mitsuba` CLI analog (reference: src/mitsuba/mitsuba.cpp): loads a
scene (a built-in registry name or a Mitsuba XML file, with -D parameter
substitution), picks the integrator, runs the progressive loop with the
per-pass timing CSV (the equal-time protocol file `<dest>_time.csv`,
gvpm.cpp:243-248), and writes the PFM / EXR / PNG outputs, `_meta.json`
and checkpoints. It renders on the CUDA card unless `--device` names
another device (`--device cpu`); without a card and without `--device`
it raises.

    python -m gvpm_tpu_torch.cli box-medium -i gvpm --volume distance \\
        --width 128 --height 128 --passes 10 -o out/box
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

INTEGRATORS = ("volpath", "path", "direct", "ao", "ptracer", "bdpt",
               "gbdpt", "sppm", "ppm", "photonmapper", "vpl", "pssmlt",
               "erpt", "mlt", "gvpm", "gpt")


def build_argparser():
    p = argparse.ArgumentParser(
        prog="gvpm_tpu_torch",
        description="gradient-domain volumetric photon mapper on a CUDA "
                    "card (PyTorch)")
    p.add_argument("scene", help="builtin scene name or path to .xml")
    p.add_argument("-o", "--output", default="render")
    p.add_argument("-i", "--integrator", default="sppm", choices=INTEGRATORS)
    p.add_argument("--volume", default="distance",
                   choices=["none", "distance", "bre", "beam1d",
                            "beam3d", "plane0d"])
    p.add_argument("--shift", default="pathspace",
                   choices=["pathspace", "pss"],
                   help="G-PT shift: path-space reconnection machine "
                        "(gpt.cpp:502) or primary-sample-space identity")
    p.add_argument("--passes", type=int, default=16)
    p.add_argument("--spp", type=int, default=32)
    p.add_argument("--photons", type=int, default=65536)
    p.add_argument("--max-depth", type=int, default=12)
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--alpha", type=float, default=0.7,
                   help="APA radius reduction (reference alpha)")
    p.add_argument("--recon-alpha", type=float, default=0.2)
    p.add_argument("--l2", action="store_true",
                   help="L2 reconstruction instead of L1")
    p.add_argument("-D", action="append", default=[], metavar="k=v",
                   help="XML $parameter override")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--checkpoint-every", type=int, default=10)
    p.add_argument("--time-max", type=float, default=None,
                   help="wall-clock budget in seconds (equal-time runs)")
    p.add_argument("--mesh", type=int, default=0,
                   help="-i sppm on N ranks (0 = one process): gloo ranks "
                        "with --device cpu, else nccl ranks, one card "
                        "each; under torchrun the ranks it started")
    p.add_argument("--device", default=None,
                   help="torch device to render on (default: the CUDA "
                        "card; 'cpu' for the CPU)")
    return p


def load_scene(args):
    if args.scene.endswith(".xml"):
        from .scene import mitsuba
        defaults = dict(kv.split("=", 1) for kv in args.D)
        return mitsuba.load(args.scene, defaults, device=args.device)
    from . import scenes
    return scenes.get(args.scene, width=args.width, height=args.height,
                      device=args.device), {}


def _numpy(a):
    return a.detach().cpu().numpy() if hasattr(a, "detach") \
        else np.asarray(a)


def _sharded_sppm(args, scene, cfg):
    """parallel.dist.render on --mesh N ranks: under torchrun in the group
    it describes (the result on rank 0, None on the others), else on N
    ranks this process starts (gloo on the CPU, nccl one card a rank)."""
    from .parallel import dist
    from .parallel import mesh as meshmod
    from .parallel.launch import launch
    import torch.distributed as tdist
    kw = dict(volume=args.volume, seed=args.seed, passes=args.passes)
    joined = not tdist.is_initialized()
    if meshmod.maybe_init_distributed(args.device):
        mesh = meshmod.make_mesh(args.mesh, args.device)
        try:
            out = dist.render(mesh, scene.to(mesh.device), cfg, **kw)
        finally:
            if joined:                  # leave a caller's group alone
                tdist.destroy_process_group()
        return out if mesh.rank == 0 else None
    return launch(args.mesh, dist.render, scene, cfg, device=args.device,
                  **kw)


def main(argv=None):
    args = build_argparser().parse_args(argv)
    from .core.config import GradientConfig, PhotonConfig, VolPathConfig
    from .core.device import resolve_device
    from .core.logging import StatsCounter, Timer, log
    from .integrators import gpt, gvpm, sppm, volpath
    from .utils import exr as exrlib
    from .utils import image as imglib

    args.device = resolve_device(args.device)
    StatsCounter.reset_all()        # the counters of this run only
    scene, meta = load_scene(args)
    log.info("scene: %s (%d tris, %d spheres, %dx%d) on %s", args.scene,
             scene.n_tris, scene.n_spheres, scene.width, scene.height,
             args.device)

    timer = Timer()
    t_csv = []
    latest = {}
    t_start = time.perf_counter()

    def per_pass(it, img, *_):
        t_csv.append(time.perf_counter() - t_start)
        latest["image"] = img
        if args.time_max and t_csv[-1] > args.time_max:
            raise KeyboardInterrupt

    out = {}
    vcfg = VolPathConfig(spp=args.spp, max_depth=args.max_depth)
    try:
        if args.integrator in ("volpath", "path"):
            out["image"] = volpath.render(scene, vcfg, seed=args.seed)
        elif args.integrator == "direct":
            from .integrators import simple
            out["image"] = simple.render_direct(scene, spp=args.spp,
                                                seed=args.seed)
        elif args.integrator == "ao":
            from .integrators import simple
            out["image"] = simple.render_ao(scene, spp=args.spp,
                                            seed=args.seed)
        elif args.integrator == "ptracer":
            from .integrators import lighttrace
            cfg = PhotonConfig(max_depth=args.max_depth,
                               surface_photons=args.photons,
                               volume_photons=args.photons)
            out["image"] = lighttrace.render(scene, cfg, seed=args.seed,
                                             passes=args.passes)
        elif args.integrator == "bdpt":
            from .integrators import bdpt
            out["image"] = bdpt.render(scene, vcfg, seed=args.seed)
        elif args.integrator == "gbdpt":
            from .integrators import gbdpt
            out = gbdpt.render(scene, vcfg, seed=args.seed,
                               callback=per_pass,
                               recon_alpha=args.recon_alpha,
                               recon_l1=not args.l2)
        elif args.integrator in ("ppm", "photonmapper"):
            from .integrators import photonmapper
            cfg = PhotonConfig(max_depth=args.max_depth,
                               surface_photons=args.photons,
                               volume_photons=args.photons,
                               alpha=args.alpha)
            out = photonmapper.render(
                scene, cfg, seed=args.seed, passes=args.passes,
                progressive=args.integrator == "ppm", callback=per_pass)
        elif args.integrator == "vpl":
            from .integrators import vpl as vplmod
            out = vplmod.render(scene, PhotonConfig(max_depth=args.max_depth),
                                seed=args.seed, passes=args.passes,
                                callback=per_pass)
        elif args.integrator in ("pssmlt", "mlt", "erpt"):
            from .integrators import erpt, mlt, pssmlt
            mod = dict(pssmlt=pssmlt, mlt=mlt, erpt=erpt)[args.integrator]
            out["image"] = mod.render(scene, vcfg, seed=args.seed,
                                      n_mutations=max(8, args.spp))
        elif args.integrator == "gpt":
            mod = gpt
            if args.shift == "pathspace":
                from .integrators import gpt_shift as mod
            out = mod.render(scene, vcfg, seed=args.seed, callback=per_pass,
                             recon_alpha=args.recon_alpha,
                             recon_l1=not args.l2)
        elif args.integrator == "sppm":
            cfg = PhotonConfig(max_depth=args.max_depth,
                               surface_photons=args.photons,
                               volume_photons=args.photons,
                               alpha=args.alpha, max_passes=args.passes)
            if args.mesh:
                out = _sharded_sppm(args, scene, cfg)
                if out is None:
                    return 0            # not rank 0: it writes the outputs
            else:
                out = sppm.render(scene, cfg, volume=args.volume,
                                  seed=args.seed, passes=args.passes,
                                  callback=per_pass,
                                  checkpoint_path=args.checkpoint,
                                  checkpoint_every=args.checkpoint_every)
        elif args.integrator == "gvpm":
            cfg = GradientConfig(max_depth=args.max_depth,
                                 surface_photons=args.photons,
                                 volume_photons=args.photons,
                                 alpha=args.alpha, max_passes=args.passes,
                                 recon_alpha=args.recon_alpha,
                                 recon_l1=not args.l2)
            out = gvpm.render(scene, cfg, volume=args.volume,
                              seed=args.seed, passes=args.passes,
                              callback=per_pass,
                              checkpoint_path=args.checkpoint,
                              checkpoint_every=args.checkpoint_every)
    except KeyboardInterrupt:
        # a stopped progressive loop returns nothing: write the image of
        # the passes done so far (the JAX CLI writes no image then)
        log.info("stopped (time budget or interrupt) after %d passes",
                 len(t_csv))
        if "image" not in out and "image" in latest:
            out = {"image": latest["image"]}

    if StatsCounter.REGISTRY:
        log.info("statistics (Statistics::printStats analog):")
        StatsCounter.print_stats()

    dest = args.output
    img, n_bad = imglib.nan_scrub(_numpy(out["image"]))
    if n_bad:
        log.warning("scrubbed %d non-finite values", n_bad)
    imglib.write_pfm(dest + ".pfm", img)
    exrlib.write_exr(dest + ".exr", img)
    imglib.write_png(dest + ".png", imglib.tonemap(img))
    for extra in ("primal", "gx", "gy"):
        if extra in out:
            clean = imglib.nan_scrub(_numpy(out[extra]))[0]
            imglib.write_pfm(f"{dest}_{extra}.pfm", clean)
            exrlib.write_exr(f"{dest}_{extra}.exr", clean)
    with open(dest + "_time.csv", "w") as f:
        for i, t in enumerate(t_csv):
            f.write(f"{i},{t:.3f}\n")
    with open(dest + "_meta.json", "w") as f:
        json.dump({"scene": args.scene, "integrator": args.integrator,
                   "volume": args.volume, "device": str(args.device),
                   "wall_s": timer.elapsed(),
                   "meta": {k: str(v) for k, v in meta.items()}}, f)
    log.info("wrote %s.pfm/.png (%.1fs)", dest, timer.elapsed())
    return 0


if __name__ == "__main__":
    sys.exit(main())
