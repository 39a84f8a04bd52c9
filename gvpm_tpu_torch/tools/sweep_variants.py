"""Time source variants of the queued beam / plane sweep kernel
(csrc/gsweep.cu) on one GPU.

    python3 gvpm_tpu_torch/tools/sweep_variants.py [kind ...] [variant ...]

Captures the sweep inputs of one SPPM pass of beam1d and beam3d at the
goldens' 128^2 check config and the gradient sweep inputs of one gvpm
pass of each beam volume at the same config with ME off (the inputs
chip_smoke.py times the kernels on), then, for each variant, copies
csrc/ into _build/sweep_variants/<name>/ with the variant's text
substitutions applied, builds it through ops.beam_sweep.build and times
the queued sweeps (beam1d, beam3d, gbeam1d, gbeam3d and gplane0d, or the
kinds named on the command line) through the same wrapper, with
chip_smoke.cuda_ms. A variant is a list of (old, new) source
substitutions of gsweep.cu and its headers (variant_sources): each must
match one place, so a variant that the sources have outgrown fails
loudly.

gsweep.cu's knobs (its defaults: TQ 64, TILE_B 128, BATCH 8, SWEEP_U 2,
RING 128, MIN_BLOCKS 4, P_TQ 128, P_MIN_BLOCKS 6, P_SWEEP_U 4, P_RING
256, tails read from device memory): `batch_32` (32 gradient
pairs a batch, a pair's four offsets in one lane, against 8 pairs x 4
offsets), `carry` (the test's values ride in the ring instead of being
recomputed in the batch), the query tile (`tq_32`, `tq_128`; the primal
kinds' `p_tq_64`, `p_tq_256`), the beam tile (`tile_b_256`,
`tile_b_512`), the ring (`ring_256`), the 32-beam slots a lane tests a
sweep step (`sweep_u_1`, `sweep_u_4`), the gradient register cap
(`regs_168` / `regs_255`: 3 / 2 blocks of 128 threads an SM), the primal
one (`p_blocks_4` / `p_blocks_8`: 128 / 64 registers, 16 / 32 warps an
SM, against 6 blocks' 80 and 24), `offsets_unrolled` (the shift loop
unrolled), `batch_noinline` (the batch a function of its own), `inline`
(a primal pair's base in the lane that tested it, no queue: the lane's
sums of a query's pairs in a tile added by a fixed shuffle tree), the primal
sweep step (`p_sweep_u_1`, `p_sweep_u_2`), `margin_2r` (beam1d's
pre-test at (2 r)^2 instead of (1.1 r)^2), `pretest_off` (beam1d's test
is its exact closest-approach test on every pair, with its divisions),
`exact_in_test` (beam1d's exact test in the sweep behind its pre-test, a
branch, so that only accepted pairs are queued), `chord_dense` (beam3d's
and gbeam3d's test runs chord's clip on every pair, not only where the
query is within r of the beam's line), and `shifts_out`, which returns
before a batch's pair bodies (beam3d / gbeam3d: also before the chord
sample's threefry word; beam1d's exact-test batches still run): its sums and counts are wrong on purpose and
say what the sweep, the queue and the batches' loads cost alone. Every
other variant must agree with `base` (counts, visits and shift_ok equal,
sums at rtol 2e-4 / atol 5e-6) or the script raises. Prints one line per
variant: ms per launch, registers a thread and spill bytes per kernel.
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


# `inline`: gsweep_kernel's lines before the sweep loop, before its queue
# pushes and after the sweep loop (csrc/gsweep.cu)
SWEEP_LOOP = "      for (int u = 0; u < n; u += 32 * S::sweep_u) {\n"
PUSHES = ("#pragma unroll\n        for (int v = 0; v < S::sweep_u; ++v) {\n"
          "          const unsigned hit")
SWEEP_END = ("          lo += S::batch;\n        }\n      }\n"
             "    }\n  }\n#pragma unroll 1\n")
INLINE_BASE = """\
        if constexpr (F::PRIMAL) {
#pragma unroll
          for (int v = 0; v < S::sweep_u; ++v) {
            if (!pass[v]) continue;
            const long long j = t0 + u + 32 * v + lane;
            float rb[beam::BW];
            for (int c = 0; c < beam::BW / 4; ++c) {
              const float4 w = __ldg(brows + j * (beam::BW / 4) + c);
              rb[4 * c] = w.x, rb[4 * c + 1] = w.y, rb[4 * c + 2] = w.z,
              rb[4 * c + 3] = w.w;
            }
            int kr[4] = {0, 0, 0, 0};
            if constexpr (F::RANDOM) {
              const int4 kv = __ldg(keys + j);
              kr[0] = kv.x, kr[1] = kv.y, kr[2] = kv.z;
            }
            typename F::Base b;
            if (F::base(q, rb, kr, p, g[v], b)) {
              la[0] += b.c[0], la[1] += b.c[1], la[2] += b.c[2];
              ++ln;
            }
          }
          continue;
        }
"""
INLINE_TREE = """\
      if constexpr (F::PRIMAL) {   // a fixed tree: same bits
        for (int o = 16; o > 0; o >>= 1) {
          for (int c = 0; c < 3; ++c) la[c] += __shfl_xor_sync(FULL, la[c], o);
          ln += __shfl_xor_sync(FULL, ln, o);
        }
        if (lane == 0) {
          for (int c = 0; c < 3; ++c) t.acc[qi * 3 + c] += la[c];
          t.cnt[qi] += ln;
        }
      }
"""
# Beam1D::test's last line (csrc/beam_eval.cuh)
PRETEST = ("    return (b[B_MED] == q.med) & ((nn <= 1e-2f) | "
           "(s * s <= p.pre_r2 * nn));")
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
    "p_tq_64": [shape("P_TQ", 128, 64)],
    "p_tq_256": [shape("P_TQ", 128, 256)],
    "p_blocks_4": [shape("P_MIN_BLOCKS", 6, 4)],
    "p_blocks_8": [shape("P_MIN_BLOCKS", 6, 8)],
    "inline": [(SWEEP_LOOP, "      float la[3] = {0.0f, 0.0f, 0.0f};\n"
                            "      int ln = 0;\n" + SWEEP_LOOP),
               (PUSHES, INLINE_BASE + PUSHES),
               (SWEEP_END, SWEEP_END.replace("      }\n    }\n  }\n",
                                             "      }\n" + INLINE_TREE
                                             + "    }\n  }\n", 1))],
    "p_sweep_u_1": [shape("P_SWEEP_U", 4, 1), shape("P_RING", 256, 128)],
    "p_sweep_u_2": [shape("P_SWEEP_U", 4, 2), shape("P_RING", 256, 128)],
    "margin_2r": [("g * g <= r2 ? 1.21f * r2 : INFINITY;",
                   "g * g <= r2 ? 4.0f * r2 : INFINITY;")],
    "pretest_off": [(PRETEST, "    Closest h;\n"
                     "    return (b[B_MED] == q.med) & exact(q, b, p, h);")],
    "exact_in_test": [(PRETEST, "    Closest h;\n"
                       "    return (b[B_MED] == q.med) && ((nn <= 1e-2f) | "
                       "(s * s <= p.pre_r2 * nn)) && exact(q, b, p, h);")],
    "offsets_unrolled": [("#pragma unroll 1\n    for (int k = 0; k < 4 / STRIDE",
                          "#pragma unroll\n    for (int k = 0; k < 4 / STRIDE")],
    "batch_noinline": [("__device__ __forceinline__ void shift_batch",
                        "__device__ __noinline__ void shift_batch")],
    "shifts_out": [("  beam::pair_body<F, S::stride>(",
                    "  if (p.k != -1.0f) return;\n"
                    "  beam::pair_body<F, S::stride>(")],
    "chord_dense": [("  if (h.pp < p.r2) g.ch = chord_clip(",
                     "  g.ch = chord_clip(")],
}
WRONG_ON_PURPOSE = ("shifts_out",)


def variant_sources(name, csrc):
    """The kernel sources of csrc/ with variant `name`'s substitutions
    applied, by file name; raises unless each substitution's old text
    occurs in exactly one place of gsweep.cu and its headers
    (beam_sweep.cu, which plane0d alone runs, is copied as it is)."""
    from gvpm_tpu_torch.ops import beam_sweep as bs
    texts = {}
    for f in sorted(set(bs.SOURCES + bs.GSOURCES)):
        with open(os.path.join(csrc, f)) as fh:
            texts[f] = fh.read()
    for old, new in VARIANTS[name]:
        where = [f for f in bs.GSOURCES if old in texts[f]]
        if len(where) != 1 or texts[where[0]].count(old) != 1:
            raise SystemExit(f"{name}: {len(where)} sources hold "
                             f"{old!r}, not one, once")
        texts[where[0]] = texts[where[0]].replace(old, new)
    return texts


def main(kinds, names):
    if not torch.cuda.is_available():
        raise SystemExit("sweep_variants: needs a CUDA device")
    sys.path.insert(0, ROOT)
    import chip_smoke
    from gvpm_tpu_torch import scenes
    from gvpm_tpu_torch.core.config import GradientConfig, PhotonConfig
    from gvpm_tpu_torch.integrators import sppm
    from gvpm_tpu_torch.ops import beam_sweep as bs

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    scene = scenes.box_medium(128, 128)
    kinds = kinds or [k for k in bs.QUEUED if k in bs.KINDS + bs.GKINDS]
    captured = {}
    for config, capture, of in (
            (PhotonConfig(**chip_smoke.BEAM_GOLD_KW),
             chip_smoke.capture_sweeps, bs.KINDS),
            (GradientConfig(**chip_smoke.GVPM_GOLD_KW),
             chip_smoke.capture_gsweeps, bs.GKINDS)):
        if any(k in of for k in kinds):
            captured.update(capture(scene, config, dict(
                n_photons=max(config.surface_photons,
                              config.volume_photons),
                seed=5, it=0, surf_scale=1.0, vol_scale=1.0,
                r_vol_base=sppm.base_volume_radius(scene, config))))
    captured = {k: captured[k] for k in kinds}

    csrc, ref = bs._CSRC, {}
    for name in ["base"] + [n for n in names if n != "base"]:
        src_dir = os.path.join(bs._BUILD, "sweep_variants", name)
        os.makedirs(src_dir, exist_ok=True)
        for f, text in variant_sources(name, csrc).items():
            with open(os.path.join(src_dir, f), "w") as fh:
                fh.write(text)
        bs._CSRC = src_dir
        bs._LIB.clear()
        report = bs.build_report()
        cells = []
        for kind, args in captured.items():
            sweep = bs.sweep if kind in bs.KINDS else bs.gsweep
            out = sweep(kind, *args)
            torch.cuda.synchronize()
            n_sums = 1 if kind in bs.KINDS else 3
            if name == "base":
                ref[kind] = out
            elif name not in WRONG_ON_PURPOSE:
                for g, w in zip(out[n_sums:], ref[kind][n_sums:]):
                    if not torch.equal(g, w):
                        raise AssertionError(f"{name} {kind}: counts differ")
                for g, w in zip(out[:n_sums], ref[kind][:n_sums]):
                    torch.testing.assert_close(g, w, rtol=2e-4, atol=5e-6)
            ms = chip_smoke.cuda_ms(lambda: sweep(kind, *args), 3)
            r = report[kind]
            cells.append(f"{kind} {ms:.3f} ms, {r['registers']} regs, "
                         f"{r['spill_stores']} B spilled, "
                         f"{bs.warps_per_sm(kind)} warps an SM")
        print(f"[{name}] " + "; ".join(cells), flush=True)
    bs._CSRC = csrc
    bs._LIB.clear()


if __name__ == "__main__":
    QUEUED = ("beam1d", "beam3d", "gbeam1d", "gbeam3d", "gplane0d")
    kinds = [n for n in sys.argv[1:] if n in QUEUED]
    names = [n for n in sys.argv[1:] if n not in QUEUED]
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: "
                         f"{list(VARIANTS)}; kinds: {list(QUEUED)}")
    main(kinds, names or list(VARIANTS))
