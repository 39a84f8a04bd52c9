"""Time source variants of the gradient beam / plane sweep kernels on one
GPU.

    python3 gvpm_tpu_torch/tools/sweep_variants.py [variant ...]

Captures the gradient sweep inputs of one gvpm pass of each beam volume
at the goldens' 128^2 check config with ME off (the inputs chip_smoke.py
times the kernels on), then, for each variant, copies csrc/ into
_build/sweep_variants/<name>/ with the variant's text substitutions
applied, builds it through ops.beam_sweep.build and times the three
gradient sweeps (gbeam1d, gbeam3d and gplane0d, all on csrc/gsweep.cu)
through the same wrapper, with chip_smoke.cuda_ms. A variant is a list
of (old, new) source substitutions: each must match, so a variant that
the sources have outgrown fails loudly.

gsweep.cu's knobs (its defaults: TQ 64, TILE_B 128, BATCH 8, SWEEP_U
2, RING 128, MIN_BLOCKS 4, tails read from device memory): `batch_32`
(32 pairs a batch, a pair's four offsets in one lane, against 8 pairs x
4 offsets), `carry` (the test's values ride in the ring instead of
being recomputed in the batch), the query tile (`tq_32`, `tq_128`),
the beam tile (`tile_b_256`, `tile_b_512`), the ring (`ring_256`), the
32-beam slots a lane tests a sweep step (`sweep_u_1`, `sweep_u_4`), the
register cap (`regs_168` / `regs_255`:
3 / 2 blocks of 128 threads an SM), `offsets_unrolled` (the shift loop
unrolled), `batch_noinline` (the batch a function of its own),
`chord_dense` (gbeam3d's test runs chord's clip on every pair, not
only where the query is within r of the beam's line), and
`shifts_out`, which returns before a batch's pair bodies (gbeam3d: also
before its chord sample's threefry word): its sums and counts are wrong
on purpose and say what the sweep, the queue and the batches' loads
cost alone. Every variant but the one wrong on purpose must agree with
`base` (visits and shift_ok equal, sums at rtol 2e-4 / atol 5e-6) or
the script raises. Prints one line per variant: ms per launch,
registers a thread and spill bytes per kernel.
"""

import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def shape(name, old, new, kind="int"):
    return (f"constexpr {kind} {name} = {old};",
            f"constexpr {kind} {name} = {new};")


VARIANTS = {
    "base": [],
    "batch_32": [shape("BATCH", 8, 32)],
    "carry": [shape("CARRY", "false", "true", "bool")],
    "tq_32": [shape("TQ", 64, 32)],
    "tq_128": [shape("TQ", 64, 128)],
    "tile_b_256": [shape("TILE_B", 128, 256)],
    "tile_b_512": [shape("TILE_B", 128, 512)],
    "ring_256": [shape("RING", 128, 256)],
    "sweep_u_1": [shape("SWEEP_U", 2, 1)],
    "sweep_u_4": [shape("SWEEP_U", 2, 4), shape("RING", 128, 256)],
    "regs_168": [shape("MIN_BLOCKS", 4, 3)],
    "regs_255": [shape("MIN_BLOCKS", 4, 2)],
    "offsets_unrolled": [("#pragma unroll 1\n  for (int k = 0; k < 4 / STRIDE",
                          "#pragma unroll\n  for (int k = 0; k < 4 / STRIDE")],
    "batch_noinline": [("__device__ __forceinline__ void shift_batch",
                        "__device__ __noinline__ void shift_batch")],
    "shifts_out": [("  beam::pair_body<F, STRIDE>(",
                    "  if (p.k != -1.0f) return;\n  beam::pair_body<F, STRIDE>(")],
    "chord_dense": [("    if (h.pp < p.r2) g.ch = chord_clip(",
                     "    g.ch = chord_clip(")],
}
WRONG_ON_PURPOSE = ("shifts_out",)


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
        for f in sorted(set(bs.SOURCES + bs.GSOURCES)):
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
