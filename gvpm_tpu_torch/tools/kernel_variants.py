"""Time source variants of the fused gather kernel on one GPU.

    python3 gvpm_tpu_torch/tools/kernel_variants.py [variant ...]

Captures the gather inputs of one headline pass with ME (the inputs
chip_smoke.py times the kernels on), then, for each variant, copies
csrc/ into _build/variants/<name>/ with the variant's text substitutions
applied, builds it through ops.fused_gather.build and times the four
instantiations through the same wrapper, with chip_smoke.cuda_ms. A
variant is a list of (old, new) source substitutions: each must match,
so a variant that the sources have outgrown fails loudly. Variants that
take part of the kernel out (`bodies_out`, `reductions_out`) compute
wrong sums on purpose: they say what that part costs. Every other
variant must agree with `base` (visits and shift_ok equal, sums at rtol
2e-4 / atol 5e-6) or the script raises. Prints one line per variant: ms
per launch, registers a thread and spill bytes per instantiation.
"""

import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SHAPE = "static constexpr int TQ = 8, SWEEP_U = 4, RING = 256, MIN_BLOCKS = 8;"
SHIFT = "    shift_batch<Eval, ME>(t, ring_lo, count, lane, tbl, row_w, r2, k3);\n"
REDUCE = ("      const float other = __shfl_down_sync(FULL, v, 1 << s);\n"
          "      if (same >> s & 1) v += other;\n")
LOOP = "    for (int i = 0; i < 4; ++i) {\n"


def shape(tq=8, u=4, ring=256, blocks=8):
    return [(SHAPE, f"static constexpr int TQ = {tq}, SWEEP_U = {u}, "
                    f"RING = {ring}, MIN_BLOCKS = {blocks};")]


VARIANTS = {
    "base": [],
    "tile_4": shape(tq=4),
    "tile_16": shape(tq=16),
    "tile_32": shape(tq=32),
    "sweep_2": shape(u=2, ring=128),
    "sweep_8": shape(u=8, ring=512),
    "regs_96": shape(blocks=10),
    "unrolled": [(LOOP, "#pragma unroll\n" + LOOP)],
    "bodies_out": [(SHIFT, "")],
    "reductions_out": [(REDUCE, "")],
}
WRONG_ON_PURPOSE = ("bodies_out", "reductions_out")


def main(names):
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: needs a CUDA device")
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
    scene = scenes.box_medium(512, 512)
    cfg = GradientConfig(**chip_smoke.HEADLINE_ME_KW)
    captured = {}
    launch = fg.fused_gather

    def capture(ev, *args):
        captured.setdefault(ev.name, args)
        return launch(ev, *args)

    fg.fused_gather = capture
    try:
        gvpm.render_pass(scene, cfg, "distance", cfg.surface_photons, 5, 0,
                         1.0, 1.0, sppm.base_volume_radius(scene, cfg))
    finally:
        fg.fused_gather = launch

    csrc, ref = fg._CSRC, {}
    for name in ["base"] + [n for n in names if n != "base"]:
        src_dir = os.path.join(fg._BUILD, "variants", name)
        os.makedirs(src_dir, exist_ok=True)
        subs = list(VARIANTS[name])
        for f in fg.SOURCES:
            with open(os.path.join(csrc, f)) as fh:
                text = fh.read()
            for old, new in list(subs):
                if old in text:
                    text = text.replace(old, new)
                    subs.remove((old, new))
            with open(os.path.join(src_dir, f), "w") as fh:
                fh.write(text)
        if subs:
            raise SystemExit(f"{name}: no source holds {subs[0][0]!r}")
        fg._CSRC = src_dir
        fg._LIB.clear()
        report = fg.build_report()
        cells = []
        for ev_name, ev in gradient_gather.EVALS.items():
            args = captured[ev_name if ev.me else ev_name + "_me"]
            out, _ = fg.fused_gather(ev, *args)
            torch.cuda.synchronize()
            if name == "base":
                ref[ev_name] = out
            elif name not in WRONG_ON_PURPOSE:
                if not torch.equal(out[:, 27:29], ref[ev_name][:, 27:29]):
                    raise AssertionError(f"{name} {ev_name}: visits differ")
                torch.testing.assert_close(out, ref[ev_name], rtol=2e-4,
                                           atol=5e-6)
            ms = chip_smoke.cuda_ms(lambda: fg.fused_gather(ev, *args), 20,
                                    warm=20)
            r = report[ev_name]
            cells.append(f"{ev_name} {ms:.3f} ms, {r['registers']} regs, "
                         f"{r['spill_stores']} B spilled")
        print(f"[{name}] " + "; ".join(cells), flush=True)
    fg._CSRC = csrc
    fg._LIB.clear()


if __name__ == "__main__":
    unknown = [n for n in sys.argv[1:] if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: "
                         f"{list(VARIANTS)}")
    main(sys.argv[1:] or list(VARIANTS))
