"""Time source variants of the gradient beam / plane sweep kernels on one
GPU.

    python3 gvpm_tpu_torch/tools/sweep_variants.py [variant ...]

Captures the gradient sweep inputs of one gvpm pass of each beam volume
at the goldens' 128^2 check config with ME off (the inputs chip_smoke.py
times the kernels on), then, for each variant, copies csrc/ into
_build/sweep_variants/<name>/ with the variant's text substitutions
applied, builds it through ops.beam_sweep.build and times the three
gradient instantiations (gbeam1d, gbeam3d, gplane0d) through the same
wrapper, with chip_smoke.cuda_ms. A variant is a list of (old, new)
source substitutions: each must match, so a variant that the sources
have outgrown fails loudly. `shifts_out` returns after the base term
(no tail load, no shifts): its S, W and shift_ok are wrong on purpose
and say what the shifts cost; `shifts_skipped` returns there at run
time only, so the kernel keeps the shifts' registers: it says what the
base loop costs at the gradient kernel's occupancy. Every other variant must agree with
`base` (visits and shift_ok equal, sums at rtol 2e-4 / atol 5e-6) or
the script raises. Prints one line per variant: ms per launch,
registers a thread and spill bytes per instantiation.
"""

import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TAIL = "    const Parent a = load_parent(tail);\n"
BOUNDS = "__global__ void __launch_bounds__(BLOCK)\n"

VARIANTS = {
    "base": [],
    # at most 128 / 85 registers a thread: 4 / 6 blocks of 128 an SM
    "regs_128": [(BOUNDS, "__global__ void __launch_bounds__(BLOCK, 4)\n")],
    "regs_85": [(BOUNDS, "__global__ void __launch_bounds__(BLOCK, 6)\n")],
    "shifts_out": [(TAIL, "    return;\n" + TAIL)],
    # the shifts compiled (and their registers allocated) but skipped at
    # run time: k is never -1
    "shifts_skipped": [(TAIL, "    if (p.k != -1.0f) return;\n" + TAIL)],
}
WRONG_ON_PURPOSE = ("shifts_out", "shifts_skipped")


def main(names):
    if not torch.cuda.is_available():
        raise SystemExit("sweep_variants: needs a CUDA device")
    sys.path.insert(0, ROOT)
    import chip_smoke
    from gvpm_tpu_torch import scenes
    from gvpm_tpu_torch.core.config import GradientConfig
    from gvpm_tpu_torch.integrators import sppm
    from gvpm_tpu_torch.ops import beam_sweep as bs

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    scene = scenes.box_medium(128, 128)
    cfg = GradientConfig(**chip_smoke.GVPM_GOLD_KW)
    captured = chip_smoke.capture_gsweeps(scene, cfg, dict(
        n_photons=max(cfg.surface_photons, cfg.volume_photons), seed=5,
        it=0, surf_scale=1.0, vol_scale=1.0,
        r_vol_base=sppm.base_volume_radius(scene, cfg)))

    csrc, ref = bs._CSRC, {}
    for name in ["base"] + [n for n in names if n != "base"]:
        src_dir = os.path.join(bs._BUILD, "sweep_variants", name)
        os.makedirs(src_dir, exist_ok=True)
        subs = list(VARIANTS[name])
        for f in bs.SOURCES:
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
        bs._CSRC = src_dir
        bs._LIB.clear()
        report = bs.build_report()
        cells = []
        for kind, args in captured.items():
            out = bs.gsweep(kind, *args)
            torch.cuda.synchronize()
            if name == "base":
                ref[kind] = out
            elif name not in WRONG_ON_PURPOSE:
                for g, w in zip(out[3:], ref[kind][3:]):
                    if not torch.equal(g, w):
                        raise AssertionError(f"{name} {kind}: counts differ")
                for g, w in zip(out[:3], ref[kind][:3]):
                    torch.testing.assert_close(g, w, rtol=2e-4, atol=5e-6)
            ms = chip_smoke.cuda_ms(lambda: bs.gsweep(kind, *args), 3)
            r = report[kind]
            cells.append(f"{kind} {ms:.3f} ms, {r['registers']} regs, "
                         f"{r['spill_stores']} B spilled")
        print(f"[{name}] " + "; ".join(cells), flush=True)
    bs._CSRC = csrc
    bs._LIB.clear()


if __name__ == "__main__":
    unknown = [n for n in sys.argv[1:] if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: "
                         f"{list(VARIANTS)}")
    main(sys.argv[1:] or list(VARIANTS))
