"""Time source variants of the queued beam / plane sweep kernel
(csrc/gsweep.cu) on one GPU.

    python3 gvpm_tpu_torch/tools/sweep_variants.py [kind ...] [variant ...]

Captures the sweep inputs of one SPPM pass of beam1d, beam3d and plane0d
at the goldens' 128^2 check config and the gradient sweep inputs of one
gvpm pass of each beam volume at the same config with ME off (the inputs
chip_smoke.py times the kernel on), then, for each variant, copies
csrc/ into _build/sweep_variants/<name>/ with the variant's text
substitutions applied, builds it through ops.beam_sweep.build and times
the sweeps (beam1d, beam3d, plane0d, gbeam1d, gbeam3d and gplane0d, or
the kinds named on the command line) through the same wrapper, with
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
unrolled), `batch_noinline` (the batch a function of its own), the
primal sweep step (`p_sweep_u_1`, `p_sweep_u_2`), `margin_2r` (beam1d's
pre-test at (2 r)^2 instead of (1.1 r)^2), `pretest_off` (beam1d's test
is its exact closest-approach test on every pair, with its divisions),
`exact_in_test` (beam1d's exact test in the sweep behind its pre-test, a
branch, so that only accepted pairs are queued), `chord_dense` (beam3d's
and gbeam3d's test runs chord's clip on every pair, not only where the
query is within r of the beam's line), `plane_exact` (plane0d's test is
its exact test, plane_hit's division and the six range tests, on every
pair: the one-thread-a-query kernel's test on the queue), and variants
that take parts out, to say what each costs: `shifts_out` returns
before a batch's pair bodies (beam3d / gbeam3d: also before the chord
sample's threefry word; beam1d's exact-test batches still run), so it
times the sweep and the queue alone; `plane_contrib_out` returns from
plane0d's base after its exact test (the batches' loads, exact test and
sums stay, the contribution goes); `plane_exp_out` takes the nine
`expf` of plane0d's three channels out of the contribution;
`batch_sums_out` skips a primal batch's sums into the queries'
accumulators; `batch_row_0` has every pair of a batch read beam row 0
(one cached row in place of a row a lane from L2). Their sums are wrong
on purpose (and the counts of shifts_out, batch_sums_out and
batch_row_0). Every other variant must agree with `base` (counts,
visits and shift_ok equal, sums at rtol 2e-4 / atol 5e-6) or the script
raises. Prints one line per variant: ms per launch, registers a thread and spill bytes per kernel.
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


# the end of Plane0D::test, of its base's exact test and of its
# contribution (csrc/beam_eval.cuh)
PLANE_RETURN = ("    return (s[S_MED] == q.med) & (ad > 1e-7f) & (a >= -lo) & "
                "(a <= hi) &\n"
                "           (b >= -lo) & (b <= hi) & (c > PLANE_T0 * ad) &\n"
                "           (c < q.len * PLANE_HI * ad);")
PLANE_EXACT_RETURN = (
    "    const float inv_det = 1.0f / det;\n"
    "    return (s[S_MED] == q.med) & (ad > 1e-7f) & "
    "(sg * a * inv_det >= 0.0f) &\n"
    "           (sg * a * inv_det <= 1.0f) & (sg * b * inv_det >= 0.0f) &\n"
    "           (sg * b * inv_det <= 1.0f) & (sg * c * inv_det > 1e-5f) &\n"
    "           (sg * c * inv_det < q.len);")
PLANE_OK = "(t1 <= 1.0f) & (tcam > 1e-5f) & (tcam < q.len);\n"
PLANE_EXP = ("(expf(-q.st[ch] * tcam) * expf(-q.st[ch] * t0) *\n"
             "                 expf(-q.st[ch] * t1) * q.ss[ch]")
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
    "plane_exact": [(PLANE_RETURN, PLANE_EXACT_RETURN)],
    "plane_contrib_out": [(PLANE_OK, PLANE_OK + "    s.c[0] = t0, s.c[1] = t1, "
                           "s.c[2] = tcam;\n    return ok;\n")],
    "plane_exp_out": [(PLANE_EXP, "(tcam * t0 * t1 * q.ss[ch]")],
    "batch_sums_out": [("    primal_sums<F>(",
                        "    if (p.k == -1.0f) primal_sums<F>(")],
    "batch_row_0": [("  const int j = ring_j[e];",
                     "  const int j = ring_j[e] & 0;")],
}
WRONG_ON_PURPOSE = ("shifts_out", "plane_contrib_out", "plane_exp_out",
                    "batch_sums_out", "batch_row_0")


def variant_sources(name, csrc):
    """The kernel sources of csrc/ with variant `name`'s substitutions
    applied, by file name; raises unless each substitution's old text
    occurs in exactly one place of gsweep.cu and its headers."""
    from gvpm_tpu_torch.ops import beam_sweep as bs
    texts = {}
    for f in bs.SOURCES:
        with open(os.path.join(csrc, f)) as fh:
            texts[f] = fh.read()
    for old, new in VARIANTS[name]:
        where = [f for f in bs.SOURCES if old in texts[f]]
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
    kinds = kinds or list(bs.KINDS + bs.GKINDS)
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
    QUEUED = ("beam1d", "beam3d", "plane0d", "gbeam1d", "gbeam3d",
              "gplane0d")
    kinds = [n for n in sys.argv[1:] if n in QUEUED]
    names = [n for n in sys.argv[1:] if n not in QUEUED]
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: "
                         f"{list(VARIANTS)}; kinds: {list(QUEUED)}")
    main(kinds, names or list(VARIANTS))
