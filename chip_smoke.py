"""Smoke run of the PyTorch + CUDA port (gvpm_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the exit code is non-zero:

  1. device   — a CUDA card is required (never falls back to the CPU);
                prints its name and power limit from nvidia-smi.
  2. build    — compiles the fused-gather, the beam-sweep and the ME
                Newton kernels (fused_gather.cu, gsweep.cu, me_newton.cu)
                from the sources in gvpm_tpu_torch/csrc into
                gvpm_tpu_torch/_build/, one nvcc for each, started
                together.
  3. kernels  — captures the gather inputs of one headline pass with
                manifold (ME) shifts and runs each kernel variant
                (surface, volume, surface_me, volume_me) through the CUDA
                kernel and through its plain PyTorch version on the same
                tensors: visits and shift_ok must be equal, the sums
                agree at rtol 2e-4 / atol 5e-6, the ME row keys must be
                exactly equal with at least one ME query; prints
                candidates, visits, ME queries, both times and the
                kernel's bound (see `kernel_bound`), the time of the row
                heads each call first copies out of the table, whether two
                launches on the same inputs give the same bits (they
                must: the kernel's sums have a fixed order), and the lane
                use of a lane-per-row loop and of this kernel's batches
                on these inputs (`lane_use`).
  3a. me-newton — the ME Newton kernel on the same pass's largest
                volume and surface shift calls (16,384 lanes) against its
                plain version (`me_newton_phase`).
  3b. stress  — the four variants against their plain versions on a small
                seeded input the headline cannot give (`stress_inputs`):
                a query with more visits than a tile's ring holds, runs
                longer than 32 x a few and empty ones, a ragged last
                tile, invalid queries, a lowest ME row in a late run.
  3c. beams  — the beam / plane pair sweeps (ops/beam_sweep.py: beam1d,
                beam3d and plane0d on the queued sweep of gsweep.cu) on
                the inputs of one pass of each at the goldens' 128^2
                check config: the kernel twice and the plain version
                once, accepted-pair counts exactly equal, sums at rtol
                2e-4 / atol 5e-6, two launches bitwise equal; kernel and
                plain ms, the bound (`beam_bound`: the lesser of the
                kernel's operation count, BEAM_OPS, and one thread a
                query's, BEAM_OPS_THREAD; both printed) and the kernel's
                share of it, registers, spills, warps an SM, and the pairs past
                the kernel's test (sweep_plain's model of it, beam1d's
                guard included) and past the first stage.
                beams-stress: the three on `beam_stress_inputs` (a hot
                query over seven tiles and splits, beams within 1% of r,
                inside the pre-test's margin, near-parallel, grazing
                chords; planes within a few ulp of an edge, |det| across
                1e-7, parallel planes), and beam1d's moved by
                BEAM1D_FAR_SHIFTS (lines' scales just inside the
                pre-test's guard and past it), at the split plan and in
                one split, against the plain version, the same bar.
  3d. gbeams — the gradient sweeps of the gvpm beam volumes (gbeam1d,
                gbeam3d, gplane0d; use_manifold=False) on the inputs of
                one gvpm pass of each at the goldens' 128^2 check config:
                the kernel twice and the plain version once (its base
                test on dense planes, its shifts on the accepted pairs
                only), visits and shift_ok exactly equal, sums at rtol
                2e-4 / atol 5e-6, two launches bitwise equal; kernel and
                plain ms, the bound (`gbeam_bound`) and the kernel's share
                of it, its registers and spills; the lane use of their
                shift bodies in one thread a query (as the kernel before
                gsweep.cu ran them) and in the queued kernel of gsweep.cu
                (`gsweep_lane_use`); last, the unchanged kinds' ms as a
                control line (beam1d, beam3d and the six gradient
                sweeps).
  3e. gbeams-me — the same three sweeps' ME instantiations (gbeam1d_me,
                gbeam3d_me, gplane0d_me) on the inputs of one gvpm pass
                of each with the default use_manifold=True: the kernel
                twice on every query, the plain version once on the
                first quarter of the valid queries (a prefix, so beam3d's
                randoms keep their query index): visits,
                shift_ok, the ME key, the ME pair count and gbeam3d_me's
                chord point exactly equal on those rows, sums at rtol
                2e-4 / atol 5e-6, two launches bitwise equal; kernel and
                plain ms and the bound (its counts from a dense base test
                over every pair, `gsweep_stats`), registers and spills.
  3f. gbeams-stress — the six queued kinds (gbeam1d, gbeam3d, gplane0d
                and their ME kinds) on a small seeded input a render
                cannot give (`gsweep_stress_inputs`: a query accepting
                every beam of six tiles, ragged query and beam counts,
                invalid queries, a medium mismatch, reconnectable,
                identity and ME-eligible beams, gbeam3d's grazing beams
                whose chord samples base rejects), at the wrapper's split
                plan and in one split (the queue then lives across the
                beam tiles): counts, ME keys and gbeam3d_me's chord
                points exactly equal to the plain version's, sums at rtol
                2e-4 / atol 5e-6, two launches bitwise equal.
  4. main     — gvpm.render at the bench headline size (512^2 box_medium,
                2^18 light paths, bench.py:347-362 without the TPU knobs):
                first 3 passes with the default use_manifold=True
                (bench.py's distance_me; 1 surface_me + 2 volume_me
                launches per pass), then the use_manifold=False path
                (a warm-up pass and a timed one; 1 surface + 2 volume
                launches per pass). Per-pass seconds, visits/s, phase
                split (the ME stages as phases of their own, and their
                parts: compaction, chain walk, Newton solve, ratios,
                occlusion sweep), shift_ok, ME pairs taken / dropped and
                the launch counts; images finite, reconstruction mean
                within 25% of the primal mean, and shift_ok with ME above
                shift_ok without at the same seed and pass. Last, the
                device kernels of one pass of each kind (device trace).
  4b. sppm    — the SPPM primal pass (sppm.render_pass, `distance`) at
                the same size (SPPM_KW: bench.py's base_kw without its TPU
                knobs): a warm-up pass, then 3 timed passes with their
                phase split; both hash grids' occupancy (cell_histogram);
                one profiled pass: device kernel launches, device-busy
                share and the share of device time inside the hash-grid
                gather (gather_dense). The image must be finite with a
                mean above 0.
  4c. sppm-128 — one SPPM pass of bre, beam1d, beam3d and plane0d at the
                128^2 check config (after the warm-up of 3c): seconds,
                phase split, and the sweep launches (1, 2, 1 a pass),
                counted from 0.
  4e. gvpm-128 — one gvpm pass of beam1d, beam3d and plane0d at the
                128^2 check config, ME off: seconds, phase split and the
                gradient sweep launches (1, 2, 1 a pass), counted from 0;
                then one warm pass of each at bench.py's full beam config
                (bench.py:262-292: 128^2, 2^18 paths, 2 segments a pixel,
                2 chord samples, beam_seg_tile 8192: beam3d launches 4
                chunks x 2 samples), which the TPU never finished.
  4f. gvpm-128-me, gvpm-full-me — the same passes with the default
                use_manifold=True: the surface gather through K2-ME (1
                launch), the ME sweeps (one a segment chunk, beam3d's
                one a chunk and sample), the ME stage of each sweep as
                the volume_me phase with its me: parts, the beam ME pairs
                taken (> 0) and dropped, and the launch counts.
  4d. bre     — one gvpm `bre` pass at the headline size with the
                default ME (the surface through K2-ME, launches counted
                from 0): seconds and phase split. Its profile (the plain
                gradient bre_gather's share of device time) is
                gvpm_tpu_torch/tools/profile_bre.py: the profiler's
                processing of the pass's ~600k launches takes minutes.
  5. goldens  — box-medium gvpm:distance relMSE against the committed
                goldens at the goldens/ci (32^2) and goldens (128^2)
                configs with ME off, and at 32^2 with ME on, and
                sppm:distance at both (SPPM_GOLD), sppm:beam1d at 32^2
                and sppm:bre / beam1d / beam3d / plane0d at 128^2
                (SPPM_BEAM_GOLD), under the bars recorded in their
                meta.json; gvpm:bre at 128^2 (no bar: relMSE, finite,
                reconstruction mean within 25% of the primal's);
                gvpm:beam1d / beam3d / plane0d at 128^2 (10 / 10 / 30
                passes, ME off; no bar: relMSE, finite, reconstruction
                mean within 2% of the primal's, and the correlation of gx
                with the golden's finite differences above 0.5 as
                tools/goldens.py:237-255 holds gvpm:distance), and the
                same three with ME on at a third of the passes (3 / 3 /
                10;
                their relMSE beside ME off's, the same bars); the 32^2
                ME-off gvpm render once more with the gathers' plain
                version, to show how far a different order of the sums
                moves the relMSE.
  6. entry    — the port's entry() (one SPPM pass of a 32^2 tiny scene)
                on the card: a finite image.
     volpath  — volpath.render of box-medium at each golden's generation
                config (1024 spp, max_depth 12, seed 101; 32^2 and 128^2):
                seconds, and relMSE against the golden under the
                agreement bar it was accepted at (agree_relmse).
  7. scenes   — the kernels against their plain versions (the holds of
                3 / 3c) on inputs of the scenes the box-medium phases do
                not reach: K1-ME / K2-ME on one caustic-glass 128^2 ME
                pass (gather points and photons around a delta
                dielectric sphere), K2 on one pass of scenes.feature_box's
                materials box (plastic, phong and rough-conductor
                surfaces: gather points and visits on each lobe), beam1d
                / beam3d / plane0d on one laser 128^2 check-config pass;
                each kernel's ms beside its box-medium figure. Then the
                golden bars of laser and caustic-glass: at 128^2 sppm
                distance / bre / beam1d / beam3d / plane0d and
                gvpm:distance (ME off, tools/goldens.py's check configs,
                10 passes, plane0d 30, seed 5), at 32^2 sppm:distance /
                sppm:beam1d / gvpm:distance, gvpm:distance on
                caustic-glass at 32^2 with ME on (SCENE_ME_PASSES passes;
                no bar: finite, beside ME off), volpath at the 32^2 generation config within
                agree_relmse, and gx against the 128^2 golden's finite
                differences above 0.5; each relMSE beside its bar, with
                seconds.
     het, lights — one SPPM pass and one volpath render (FEATURE_SPP
                spp) at 128^2 of the heterogeneous-fog box, of the box lit
                by point, spot and directional lights and a constant
                environment, and of the box lit by an environment map:
                finite images with a positive mean, timed; gvpm.render on
                the heterogeneous box raises ValueError.
  8. paths   — the path-space integrators (no new kernel): G-PT with
                the primary-sample shift (gpt) and the path-space
                reconnection / half-vector shift (gpt_shift) on
                box-medium at 128^2, GPT_SPP spp each, seed 5: seconds
                per pass, one profiled pass (device kernel launches,
                device-busy share, the five kernels that took the most
                device time), the correlation of gx / gy with the 128^2
                golden's finite differences (above 0.5, as
                tools/goldens.py:237-255 holds gvpm; gpt_shift's on the
                pixel pairs that see no light straight from the camera,
                which its gradients leave to the -direct buffer), and the L1
                reconstruction's relMSE against the golden (no bar,
                printed beside gvpm:distance's). Then direct, ao, path,
                the light tracer (ptracer), the photon mapper, PPM, VPL,
                PSSMLT, MLT and ERPT on box-surface at 64^2, timed, each
                mean against a 256-spp volpath render under the JAX
                package's ratio bars (0.7-1.35; VPL 0.6-1.2; light tracer
                0.8-1.2); direct and ao finite with a positive mean;
                path equal to volpath.render at its config and seed.
  9. bidir   — BDPT and G-BDPT (no hand kernel on these paths): seconds a
                pass and one profiled pass of each (device kernel
                launches, device-busy share; BDPT's on box-surface). BDPT on box-surface at 64^2
                (max_depth 5, 8 spp) against the [paths] volpath
                reference and on box-medium at 128^2 (max_depth 12, 4
                spp) against the golden's mean, each in 0.7-1.35
                (tests/test_more_integrators.py:73-81), relMSE printed.
                G-BDPT at tests/test_gbdpt.py's config (12^2 surface box,
                6 spp) and on box-medium at 128^2 (4 spp): gx / gy
                against the finite differences of its own primal above
                0.35 on the pixel pairs that see no light straight from
                the camera (its gradients leave that light out; every
                pair's and the golden's printed), the L1 relMSE; the
                reconnection shift's per-sample gx variance over the PSS
                shift's at tests/test_gbdpt.py:35-53's config, within 1%
                of the JAX package's ratio (GBDPT_REF_AB_RATIO).
 10. cli     — the command-line renderer in-process (cli.main) on the
                card: gvpm distance (default ME) and sppm beam1d at 64^2,
                2 passes, under torch.profiler's device trace, which must
                show fused_gather_kernel's VolumeEval and SurfaceEval
                instantiations with the wrapper's K1-ME / K2-ME counts
                and gsweep_kernel<beam::Beam1D>; gbdpt at 64^2, 2 spp;
                tests/test_mitsuba_loader.py's XML (CLI_XML) under
                volpath: each exit 0 with the five outputs (.pfm, .exr,
                .png, _time.csv, _meta.json) and a finite image with a
                positive mean. Then `python -m gvpm_tpu_torch.cli` in a
                subprocess (32^2 volpath), and
                gvpm_tpu_torch/tools/goldens.py's check of goldens/ci's
                box-medium bars (every bar met).
 11. dist    — the multi-rank render (gvpm_tpu_torch/parallel/), each
                job's ranks started by parallel.launch: one nccl rank
                (the comparison passes below, the first of them cold;
                dist.gvpm_render with ME off and on and dist.render at
                the headline, DIST_PASSES passes each, finite), two gloo
                ranks sharing the card (the
                gradient pass at DIST_CMP_KW against the one-rank pass:
                ME off visits and shift_ok equal, images at rtol 1e-3 /
                atol 1e-6; ME on visits equal, primal at that bar, gx /
                gy correlation above 0.99; the ring pass against the
                all-gather pass, visits equal, rtol 2e-3 / atol 2e-5),
                and on a machine with two cards or more the same on two
                nccl ranks, a card each; each run's seconds a pass, all-gather and ring seconds,
                fused-gather launches from 0 (the path's variants each
                launched), every rank's peak memory, the fused-gather
                kernels of rank 0's device trace of the ME pass (both
                ME instantiations); then entry.dryrun_multichip(1) and
                `python -m gvpm_tpu_torch.cli box-medium -i sppm --mesh
                1` at the CLI's defaults, exit 0.

The line before the last is a JSON object describing each kernel; the
last line is {"ok": true, "device": {...}}.
"""

import dataclasses
import io
import json
import os
import subprocess
import sys
import threading
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
HEADLINE_ME_KW = dict(HEADLINE_KW, use_manifold=True, me_pair_budget=4096)
# the SPPM primal pass at the same size: bench.py:347-362's base_kw
# without its TPU knobs (the hash grid's budget and size are the JAX
# package's own)
SPPM_KW = dict(
    max_depth=12, null_bounces=6, max_cam_depth=6,
    surface_photons=1 << 18, volume_photons=1 << 18, volume_samples=2,
    initial_scale_volume=0.8, vol_segments_per_pixel=2,
    grid_max_photons_per_cell=32, grid_hash_size=1 << 20)
# the goldens' SPPM check configs (tools/goldens.py::_check_kw; the 128^2
# one without its beam count), passes as tests/test_goldens.py and
# tools/goldens.py run them
SPPM_GOLD = (
    ("ci", dict(surface_photons=1 << 15, volume_photons=1 << 15,
                max_depth=12, grid_hash_size=1 << 15), 12),
    (".", dict(max_depth=12, null_bounces=6, max_cam_depth=6,
               surface_photons=1 << 16, volume_photons=1 << 16,
               grid_hash_size=1 << 18, initial_scale_volume=0.5,
               volume_samples=2, vol_segments_per_pixel=2,
               grid_dims=(64, 64, 64)), 10))

# the gvpm goldens' 128^2 check config, ME off (tools/goldens.py::
# _run_check: _check_kw(128) with the gradient gather's row caps)
GVPM_GOLD_KW = dict(
    max_depth=12, null_bounces=6, max_cam_depth=6,
    surface_photons=1 << 16, volume_photons=1 << 16,
    initial_scale_volume=0.5, volume_samples=2, vol_segments_per_pixel=2,
    grid_dims=(64, 64, 64), grid_surface_rows=1 << 19,
    grid_volume_rows=1 << 19, use_manifold=False)
# bench.py's full beam config (bench.py:262-292, _beam_child without its
# TPU knobs): 128^2, 2^18 paths, 2 segments a pixel, 2 chord samples,
# segment chunks of 8192
GBEAM_FULL_KW = dict(
    max_depth=12, null_bounces=6, max_cam_depth=6,
    surface_photons=1 << 18, volume_photons=1 << 18, grid_hash_size=1 << 20,
    volume_samples=2, initial_scale_volume=0.8,
    grid_max_photons_per_cell=32, vol_segments_per_pixel=2,
    grid_dims=(64, 64, 64), grid_surface_rows=1 << 20,
    grid_volume_rows=1 << 20, beam_seg_tile=8192, use_manifold=False)

# the beam estimators' golden bars (tools/goldens.py CHECKS: 10 passes,
# 30 for plane0d; the 32^2 artifact records sppm:beam1d only)
SPPM_BEAM_GOLD = (("ci", "beam1d", 10), (".", "bre", 10), (".", "beam1d", 10),
                  (".", "beam3d", 10), (".", "plane0d", 30))

# Published peaks of one H100 SXM at its full 700 W power limit (NVIDIA's
# data sheet): device memory rate and float32 rate outside the tensor
# cores. The kernels' bounds are stated against these.
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
# The same units without fused multiply-adds (the kernels are built with
# -fmad=false and BODY_OPS counts an add and a multiply as one each):
# 132 SMs x 128 lanes x 1.98 GHz, one operation a lane a clock.
PEAK_FP32_UNFUSED_S = 132 * 128 * 1.98e9
# float operations per pair, counted from csrc/gather_eval.cuh on the path
# box_medium takes (diffuse parents and gather points; phase_params
# always evaluates its HG and Rayleigh branches), one operation per add,
# multiply, divide, compare, clamp, sqrtf and expf:
#   ball test  — volume: sub3 3, dot3 5, 3 compares; surface: the same
#                plus neg3 3, dot3 5 and 2 more compares.
#   shift body — per visit: base term and shift_caches (volume 46,
#                surface 51) plus 4 shifts of reconnect (parent_scatter
#                112, distances / transmittance / pdf ratios 86 volume,
#                104 surface) and the shifted phase or BSDF, MIS and the
#                27 accumulations (volume 49, surface 56).
# the beam / plane sweeps (ops/beam_sweep.py): their main path is the
# SPPM pass at the goldens' 128^2 check config (tools/goldens.py::
# _check_kw(128), every medium edge a beam as the goldens were rendered),
# one pass of each beam estimator; the 32^2 check config (_check_kw(32))
# for sppm:beam1d
BEAM_GOLD_KW = dict(SPPM_GOLD[1][1])
BEAM_REPLACES = {"beam1d": "gvpm_tpu/integrators/estimators.py:481",
                 "beam3d": "gvpm_tpu/integrators/estimators.py:262",
                 "plane0d": "gvpm_tpu/integrators/estimators.py:401"}
# launches of each sweep kernel per SPPM pass (beam3d: one per distance
# sample, volume_samples = 2)
BEAM_LAUNCHES = {"beam1d": 1, "beam3d": 2, "plane0d": 1}
# the kernel's operations per pair counted from csrc/beam_eval.cuh, one
# per add, multiply, divide, compare, select, clamp, sqrtf and expf; the
# bound takes the lesser of this count and BEAM_OPS_THREAD's (beam_bound):
# (every pair
# of a valid query and a beam in its medium; each pair past the kernel's
# test, sweep_plain's "pretest"; each pair of the second stage,
# "stage2"; each accepted pair, its accumulation included). beam1d
# (csrc/gsweep.cu, Beam1D): every pair its pre-test, 29 (w0 3, n = d x db
# 9, w0 . n 5, n . n 5, the square, the product, two compares and their
# or 5, the medium's compare and the and 2); the pairs past it the exact
# test, branch free, 62 (closest 31, the closest points and their
# distance 20, five compares, the parallel flag's not and five ands 11).
# beam3d (Beam3D): every pair the chord test's first half and compares,
# 21 (chord_perp 19, pp < r2, the medium's), as GBEAM_OPS["gbeam3d"]; the
# pairs within r of the line (pretest) chord's clip and its compare, 10;
# past the chord test the sample and its distance test, 17. plane0d
# (Plane0D): every pair its pre-test, 66 (pv = d x e1 9, det 5, tt 3,
# qq = tt x e0 9, a, b, c 15, |det| and the sign's compare and select 3,
# the three signed products 3, the four bounds' products 4, eight
# compares and their seven ands 15); the pairs past it the exact test,
# 65 (e0, e1 6, pv 9, det 5, |det| > 1e-7 2, the division, tt 3, a, b, c
# and their products 18, qq 9, six compares and their ands 12); each
# accepted pair its contribution, 95 (t0, t1 2, the phase and its cosine
# 18, surv1 2, jac 15, survival 12, sc 6, three channels' exponentials
# and products 36, the accumulation 4).
BEAM_OPS = {"beam1d": (29, 62, 0, 68), "beam3d": (21, 10, 17, 57),
            "plane0d": (66, 65, 0, 95)}
# the same count for one thread a query (the kernel before gsweep.cu),
# which ran beam1d's closest approach (with its divisions) and beam3d's
# whole chord on every pair: (36, -, 21 past the parameter-range tests,
# 68), (30, -, 17, 57), and plane0d's plane_hit, 23 every pair and 32
# past the determinant test (its division, the rest of Moller-Trumbore),
# 109 accepted (the six range tests and the contribution), as
# GBEAM_OPS["gplane0d"] counts the same test. It is the lesser count for
# plane0d, whose pre-test (66 a pair) buys no division and no branch with
# more operations than plane_hit needs, so plane0d's bound is this one
BEAM_OPS_THREAD = {"beam1d": (36, 0, 21, 68), "beam3d": (30, 0, 17, 57),
                   "plane0d": (23, 0, 32, 109)}
# beam3d's integer operations per drawn word: threefry2x32's 20 rounds of
# add, two shifts, or and xor, its 5 key injections of 3 adds, the key
# schedule's 2 xors and 2 adds, and the float conversion's 4
BEAM_INT_OPS = 20 * 5 + 5 * 3 + 4 + 4
# 132 SMs x 64 INT32 lanes x 1.98 GHz (the Hopper SM holds half as many
# INT32 as FP32 units; NVIDIA's Hopper architecture white paper)
PEAK_INT32_S = 132 * 64 * 1.98e9
# the gvpm beam volumes' gradient sweeps (ops/beam_sweep.GKINDS): their
# main path is the gvpm pass at the goldens' 128^2 check config with ME
# off (tools/goldens.py::_run_check's gradient config; gold_cfgs below)
GBEAM_VOLUMES = {"gbeam1d": "beam1d", "gbeam3d": "beam3d",
                 "gplane0d": "plane0d"}
GBEAM_REPLACES = {
    "gbeam1d": "gvpm_tpu/integrators/gradient_gather.py:1232",
    "gbeam3d": "gvpm_tpu/integrators/gradient_gather.py:1580",
    "gplane0d": "gvpm_tpu/integrators/gradient_gather.py:1960"}
# launches per gvpm pass at the check config (beam3d: one segment chunk
# x volume_samples = 2); the ME instantiations' the same
GBEAM_LAUNCHES = {"gbeam1d": 1, "gbeam3d": 2, "gplane0d": 1}
# the ME instantiations replace the ME pair collection of the same loops
GBEAM_ME_REPLACES = {
    "gbeam1d_me": "gvpm_tpu/integrators/gradient_gather.py:1346",
    "gbeam3d_me": "gvpm_tpu/integrators/gradient_gather.py:1710",
    "gplane0d_me": "gvpm_tpu/integrators/gradient_gather.py:2091"}
# the plain version checks the first 1 / PLAIN_EVERY of an ME sweep's
# valid queries
PLAIN_EVERY = 4
GBEAM_GOLD_PASSES = {"beam1d": 10, "beam3d": 10, "plane0d": 30}
# the same renders with ME on run a third of the passes (the script's
# time: their relMSE is printed beside ME off's, the reconstruction and gx
# checks are the same)
GBEAM_GOLD_ME_DIVISOR = 3
# operations counted from csrc/beam_eval.cuh's gradient functors, one
# per add, multiply, divide, compare, select, clamp, sqrtf and expf, on
# box_medium's path (diffuse and medium parents; parent_lobe 112 as in
# BODY_OPS; phase_params evaluates its HG and Rayleigh branches): (every
# pair of a valid query and a beam in its medium and the pairs of the
# second stage, as BEAM_OPS; each accepted pair's base term, its
# accumulation and the tail's load; each shift of an accepted pair on a
# reconnectable beam: the re-emitted beam, parent_lobe and the ratios,
# MIS and the six accumulations; each identity shift). gbeam3d's test
# runs chord's clip (9 and the chord compare) only where the sample is
# within r of the beam's line: every pair 21 (chord_perp 19, its compare
# and the medium's), the clip counted on the stage-2 pairs (17 + 10),
# the few pairs near the line whose chord misses the segment left out.
GBEAM_OPS = {"gbeam1d": (36, 21, 58, 241, 150),
             "gbeam3d": (21, 27, 50, 265, 120),
             "gplane0d": (23, 32, 110, 375, 165)}
# an ME sweep's accepted pair on an ME-eligible beam: the key and count
# (2), and per offset no shift, only the MIS weight and the six
# accumulations (ME_OPS_OFFSET)
ME_OPS_PAIR = 2
ME_OPS_OFFSET = 20
BALL_OPS = {"volume": 11, "surface": 20}
BODY_OPS = {"volume": 46 + 4 * (112 + 86 + 49),
            "surface": 51 + 4 * (112 + 104 + 56)}
ME_OPS = 4          # per visit: three mask terms and the integer min
# float operations of the ME Newton kernel, counted from
# csrc/me_newton.cuh as (a, b): a + b * n for n tangents (3 unknowns:
# volume, beam; 2: surface). Each add, multiply, divide or square root of
# a value counts one, and so does each on a tangent (a dual product is
# 1 + 3n); negations, compares, clamps, the Fresnel term, the frames and
# the last terms are left out, so the count is low. One evaluation is the
# anchor direction (w1), then per chain slot its hit (tri or sphere), its
# bounce (reflect, or a dielectric's refract) and the step to the hit
# (advance), then the residual (residual3; the surface's residual2 after
# its hit of the photon's primitive).
ME_NEWTON_OPS = dict(w1=(22, 30), tri=(32, 13), sphere=(33, 44),
                     reflect=(12, 24), refract=(41, 68), advance=(6, 12),
                     residual3=(9, 12), residual2=(19, 22))
# by unknowns: a determinant; the solve and the trust step of a step taken
ME_NEWTON_DET_OPS = {3: 14, 2: 3}
ME_NEWTON_STEP_OPS = {3: 45 + 12, 2: 8 + 10}


START = time.perf_counter()


def phase(name, msg):
    """One result line, with the seconds since the script started."""
    print(f"[{name}] (t={time.perf_counter() - START:.0f} s) {msg}",
          flush=True)


def profile_pass(run, name="gather_dense", ops=None):
    """One call of `run` under torch.profiler: returns
    (device kernel launches, device-busy share of the profiled wall
    time, share of device kernel time inside record_function ranges named
    `name` or None where none was attributed, how it was attributed,
    profiled wall seconds). Busy time is the union of the kernels'
    intervals; the profiler slows the host, so the busy share reads low
    against an unprofiled pass. A list `ops` receives the five device
    kernels that took the most time, as (name, share of device kernel
    time, launches). With `name` None only the device is traced (no
    attribution; the host's op events of a pass of ~150k launches take
    the profiler a minute to process), and the launches are the kernels
    the device ran."""
    act = torch.profiler.ProfilerActivity
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[act.CUDA] if name is None
                                else [act.CPU, act.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    if name is None:
        # the device events straight from the trace: building the
        # profiler's FunctionEvents takes ~0.2 ms an event (30 s for a
        # pass of 150k launches), these ~2 us
        events = None
        on_card = device_events(prof)
        launches = sum(1 for e in on_card
                       if not e[0].startswith(("Memcpy", "Memset")))
    else:
        events = prof.events()
        on_card = [(e.name, e.time_range.start, e.time_range.end,
                    getattr(e, "is_user_annotation", False))
                   for e in events if e.device_type == cuda]
        launches = sum(1 for e in events if e.name == "cudaLaunchKernel")
    # device-side ranges of the `name` annotation, where the profiler
    # reports them; every other device event is work
    ann = [(a, b) for n, a, b, _ in on_card if n == name]
    work = [(n, a, b) for n, a, b, user in on_card
            if n != name and not user]
    kernels = sorted((a, b) for _, a, b in work)
    total = sum(b - a for a, b in kernels)
    if ops is not None:
        per = {}
        for n, a, b in work:
            t, c = per.get(n, (0.0, 0))
            per[n] = (t + b - a, c + 1)
        ops.extend((k[:60], round(t / total, 4), c) for k, (t, c) in
                   sorted(per.items(), key=lambda kv: -kv[1][0])[:5])
    busy, lo, hi = 0.0, None, None
    for a, b in kernels:
        if hi is None or a > hi:
            busy += 0.0 if hi is None else hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    if hi is not None:
        busy += hi - lo
    if ann:
        in_gather = sum(max(0.0, min(b, d) - max(a, c))
                        for a, b in kernels for c, d in ann)
        how = "device annotation ranges"
    elif events is None:
        in_gather, how = None, "no attribution asked"
    else:
        in_gather = sum(e.device_time_total if hasattr(e, "device_time_total")
                        else e.cuda_time_total for e in events
                        if e.name == name and e.device_type != cuda)
        how = "kernels launched inside the host ranges"
    share = in_gather / total if total and in_gather else None
    return launches, busy * 1e-6 / wall, share, how, wall


def device_events(prof):
    """The device events of a finished torch.profiler trace as (name,
    start us, end us, user annotation), read from its kineto results."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.start_ns() * 1e-3, e.end_ns() * 1e-3,
             e.is_user_annotation())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda]


def cuda_ms(fn, reps, warm=1):
    """Mean milliseconds of `fn` over `reps` runs after `warm` untimed
    ones, by CUDA events."""
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def covered_rows(plan, n_rows):
    """Table rows that lie in at least one query's runs."""
    delta = torch.zeros(n_rows + 1, dtype=torch.int64, device=plan.r0.device)
    one = torch.ones(plan.r0.numel(), dtype=torch.int64,
                     device=plan.r0.device)
    delta.index_add_(0, plan.r0.reshape(-1).to(torch.int64), one)
    delta.index_add_(0, plan.r1.reshape(-1).to(torch.int64), -one)
    return int((torch.cumsum(delta, 0)[:n_rows] > 0).sum())


def stress_inputs(ev, seed=7, device="cpu"):
    """A small seeded input of the fused gather that a render cannot be
    relied on to give. ev: a GatherEval (its slot layouts are used).
    Returns (r0, r1, table, qrows, r2, k3, min_depth, hot): 777 sorted
    queries (not a multiple of a tile) over 4096 rows in a 0.25-wide
    cluster; nine disjoint runs a query, a third of them empty, some
    over 128 rows; a tenth of the queries invalid but with runs; query
    `hot` covers 3200 rows from the cluster's centre and visits hundreds
    of them (more than a tile's ring holds), its run 4 is empty and its
    lowest ME-eligible row lies in run 7; min_depth 3 cuts some pairs.
    Parents are emitters, surfaces (diffuse, Phong, plastic) and medium
    vertices; surface queries also carry rough conductors."""
    rng = np.random.default_rng(seed)
    surface = ev.name.startswith("surface")
    P, Q, side = 4096, 777, 0.25
    hot, hot_len, me_from = Q // 2, 400, 2800
    centre = np.full(3, side / 2)

    def unit(n):
        v = rng.normal(size=(n, 3))
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    def frame(n3):
        a = np.where(np.abs(n3[:, :1]) < 0.9, [[1.0, 0, 0]], [[0, 1.0, 0]])
        s_ax = np.cross(n3, a)
        s_ax /= np.linalg.norm(s_ax, axis=1, keepdims=True)
        return s_ax, np.cross(n3, s_ax)

    def upper(n):
        v = unit(n)
        v[:, 2] = np.abs(v[:, 2]) + 0.05
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    def fill(width, slots, fields):
        n = len(next(iter(fields.values())))
        a = np.zeros((n, width), np.float32)
        for name, v in fields.items():
            v = np.asarray(v, np.float32).reshape(n, -1)
            a[:, slots[name]:slots[name] + v.shape[1]] = v
        return a

    def gloss(btype, n):
        return np.where(btype == 6, rng.uniform(5, 40, n),
                        rng.uniform(0.1, 0.5, n))

    # ---- photon rows
    p = rng.uniform(0, side, (P, 3))
    me = (np.arange(P) >= me_from) & (rng.random(P) < 0.04)
    me_forced = me_from + 100
    me[me_forced] = True
    p[me_forced] = centre + 1e-3
    wi = unit(P)
    btype = rng.choice([0, 6, 7], P)
    rows = dict(
        p=p, wi=wi, alpha=rng.uniform(0.1, 1, (P, 3)),
        parent_p=p + unit(P) * rng.uniform(0.3, 1.0, (P, 1)),
        parent_wi=unit(P), parent_ns=unit(P),
        scatter_base=rng.uniform(0.05, 1, (P, 3))
        * (rng.random((P, 1)) > 0.05),
        ns=unit(P), st=rng.uniform(0.2, 2, (P, 3)),
        pm_alb=rng.uniform(0.2, 0.9, (P, 3)),
        pm_spec=rng.uniform(0.1, 0.5, (P, 3)),
        pm_eta3=rng.uniform(0.2, 1.5, (P, 3)),
        pm_sigs=rng.uniform(0.1, 1, (P, 3)),
        pdf_dir_base=rng.uniform(0.05, 1, P),
        parent_type=np.where(me, 1, rng.choice([0, 1, 2], P)),
        reconnectable=~me & (rng.random(P) < 0.85),
        vtype=np.where(rng.random(P) < 0.9, 1 if surface else 2, 0),
        depth=rng.integers(1, 5, P), pm_btype=btype,
        pm_alpha=gloss(btype, P), pm_eta1=np.full(P, 1.5),
        pm_g=rng.uniform(-0.6, 0.6, P), pm_ptype=rng.choice([0, 1, 2], P),
        pm_delta=me, own_delta=~me & (rng.random(P) < 0.05))
    rows["vtype"][me_forced] = 1 if surface else 2
    rows["depth"][me_forced] = 4

    # ---- queries
    x = rng.uniform(0, side, (Q, 3))
    x[hot] = centre
    valid = rng.random(Q) < 0.9
    valid[hot] = True
    depth = rng.integers(0, 3, Q)
    depth[hot] = 2
    flags = {f"{n}{i}": rng.random(Q) < pr for i in range(4)
             for n, pr in (("cam_ok" if not surface else "comp", 0.85),
                           ("border", 0.1))}
    ratios = {f"{'sens' if surface else 'prc'}{i}": rng.uniform(0.2, 3, Q)
              for i in range(4)}
    if surface:
        ns = unit(Q)
        ns[hot] = -wi[me_forced]          # the forced ME row faces it
        s_ax, t_ax = frame(ns)
        qb = rng.choice([0, 3, 6, 7], Q)
        r2q = rng.uniform(0.05, 0.09, Q) ** 2
        r2q[hot] = 0.11 ** 2
        q = dict(p=x, ns=ns, s=s_ax, t=t_ax, wo=upper(Q),
                 alb=rng.uniform(0.2, 0.9, (Q, 3)),
                 spec=rng.uniform(0.1, 0.5, (Q, 3)),
                 eta3=rng.uniform(0.2, 1.5, (Q, 3)), btype=qb,
                 alpha_b=gloss(qb, Q), eta1=np.full(Q, 1.5), r2=r2q,
                 valid=valid, depth=depth, **flags, **ratios)
        for i in range(4):
            ns_i = ns + 0.05 * unit(Q)
            ns_i /= np.linalg.norm(ns_i, axis=1, keepdims=True)
            s_i, t_i = frame(ns_i)
            q.update({f"p{i}": x + 0.01 * unit(Q), f"ns{i}": ns_i,
                      f"s{i}": s_i, f"t{i}": t_i, f"wo{i}": upper(Q)})
        r2, k3 = 0.0, 0.0
    else:
        d = unit(Q)
        q = dict(x=x, d=d, g=rng.uniform(-0.5, 0.5, Q),
                 pt=rng.choice([0, 1, 2], Q), sok=valid, depth=depth,
                 **flags, **ratios)
        for i in range(4):
            sd = d + 0.05 * unit(Q)
            q.update({f"xs{i}": x + 0.01 * unit(Q),
                      f"sd{i}": sd / np.linalg.norm(sd, axis=1,
                                                    keepdims=True)})
        r2 = 0.08 ** 2
        k3 = 3.0 / (4.0 * np.pi * 0.08 ** 3)

    # ---- runs: disjoint and ascending within a query
    lens = rng.integers(1, 41, (Q, 9))
    long_q = rng.random(Q) < 0.05
    lens[long_q] = rng.integers(100, 201, (int(long_q.sum()), 9))
    lens[rng.random((Q, 9)) < 0.35] = 0
    gaps = rng.integers(0, 8, (Q, 9))
    gaps[:, 0] = rng.integers(0, P - (lens + gaps).sum(1))
    r1 = np.cumsum(lens + gaps, axis=1)
    r0 = r1 - lens
    r0[hot] = np.arange(9) * hot_len
    r1[hot] = r0[hot] + hot_len
    r1[hot, 4] = r0[hot, 4]
    assert r0.min() >= 0 and r1.max() <= P and me_from == r0[hot, 7]

    def t(a, dtype):
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype,
                            device=device)
    return (t(r0, torch.int32), t(r1, torch.int32),
            t(fill(128, ev.row_slots, rows), torch.float32),
            t(fill(ev.q_width, ev.q_slots, q), torch.float32),
            r2, k3, 3, hot)


def gsweep_stress_inputs(kind, seed=11, device="cpu"):
    """A small seeded input of the queued gradient sweeps (beam_sweep.
    GKINDS, GKINDS_ME: gbeam1d, gbeam3d, gplane0d and their _me kinds)
    that a render cannot be relied on to give. Returns (q, qx, rows,
    tails, params, hot): 333 camera segments (gbeam3d: distance samples;
    not a multiple of a query tile) in the unit box, a tenth of them
    invalid and a tenth in another medium, against 1,077 beams or planes
    (not a multiple of a beam tile), a tenth in the other medium. Query
    `hot` runs along x through the box's middle (gbeam3d: sits at its
    centre) and accepts each of the 800 beams (planes) from 256 on:
    every beam of six of gsweep.cu's 128-row tiles (three at 256 rows),
    so its accepted pairs wrap a warp's 128-pair ring six times. Parents
    are emitters, surfaces of the four BSDF types and medium vertices;
    reconnectable and identity beams are mixed and, for an _me kind,
    ME-eligible ones (-1 in the tail's reconnectable slot, pack_tails), hot
    beams among them. gbeam3d's beams 100-163 graze the hot query's
    kernel sphere (closest approach r (1 - 10^-6.5 .. 10^-4.5)), so that
    some of their chord samples fall outside it by rounding: pairs the
    sweep queues and base rejects; its params carry beam_keys rows of
    kept beams spread over 2N slots in JAX tiles of 256."""
    from gvpm_tpu_torch.ops import beam_sweep as bs
    rng = np.random.default_rng(seed)
    plane = kind.startswith("gplane0d")
    point = kind.startswith("gbeam3d")
    M, N, hot, hot0, n_hot, r = 333, 1077, 130, 256, 800, 0.05

    def unit(n):
        v = rng.normal(size=(n, 3))
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    def fill(n, width, slots, fields):
        a = np.zeros((n, width), np.float32)
        for name, v in fields.items():
            v = np.asarray(v, np.float32).reshape(n, -1)
            a[:, slots[name]:slots[name] + v.shape[1]] = v
        return a

    # ---- camera segments and their offset rays
    o, d = rng.uniform(0, 1, (M, 3)), unit(M)
    length = rng.uniform(0.3, 1.5, M)
    o[hot], d[hot], length[hot] = (0.1, 0.5, 0.5), (1.0, 0.0, 0.0), 0.9
    if point:
        o[hot] = 0.5
    valid = rng.random(M) < 0.9
    med = (rng.random(M) < 0.1).astype(np.float32)
    valid[hot], med[hot] = True, 0.0
    q = fill(M, bs.QW, bs.QSLOT, dict(
        o=o, d=d, length=length, med=med, valid=valid,
        st=rng.uniform(0.2, 1.5, (M, 3)), ss=rng.uniform(0.1, 1.0, (M, 3)),
        w=rng.uniform(0.3, 1.0, M), g=rng.uniform(-0.5, 0.5, M),
        pt=rng.choice([0, 1, 2], M)))
    qx = np.zeros((M, bs.XW), np.float32)
    for i in range(4):
        sd = d + 0.05 * unit(M)
        qx[:, bs.XSTRIDE * i:bs.XSTRIDE * (i + 1)] = fill(
            M, bs.XSTRIDE, bs.XSLOT, dict(
                o=o + 0.01 * unit(M),
                d=sd / np.linalg.norm(sd, axis=1, keepdims=True),
                length=length * rng.uniform(0.9, 1.1, M),
                ok=rng.random(M) < 0.85, sens=rng.uniform(0.2, 3.0, M),
                border=rng.random(M) < 0.1))

    # ---- beams (planes: origin, w0 / l0 in d / length, w1 / l1, sig)
    ob, db = rng.uniform(0, 1, (N, 3)), unit(N)
    lb = rng.uniform(0.2, 1.0, N)
    w1 = np.cross(db, unit(N))
    w1 /= np.linalg.norm(w1, axis=1, keepdims=True)
    l1 = rng.uniform(0.1, 0.5, N)
    hb = slice(hot0, hot0 + n_hot)
    x = rng.uniform(0.15, 0.95, n_hot)
    if plane:
        lb[hb], l1[hb] = 0.4, 0.4
        ob[hb] = np.stack([x, 0.5 - rng.uniform(0.05, 0.35, n_hot),
                           0.5 - rng.uniform(0.05, 0.35, n_hot)], 1)
        db[hb], w1[hb] = (0.0, 1.0, 0.0), (0.0, 0.0, 1.0)
    elif point:
        # along y, at most 0.8 r from the hot sample
        lb[hb] = 0.6
        ang = rng.uniform(0.0, 2.0 * np.pi, n_hot)
        rad = 0.8 * r * np.sqrt(rng.random(n_hot))
        ob[hb] = np.stack([0.5 + rad * np.cos(ang), np.full(n_hot, 0.2),
                           0.5 + rad * np.sin(ang)], 1)
        db[hb] = (0.0, 1.0, 0.0)
        gz = slice(100, 164)
        gd = unit(64)
        gu = np.cross(gd, unit(64))
        gu /= np.linalg.norm(gu, axis=1, keepdims=True)
        rho = r * (1.0 - np.logspace(-6.5, -4.5, 64))
        ob[gz] = 0.5 + rho[:, None] * gu - 0.15 * gd
        db[gz], lb[gz] = gd, 0.3
    else:
        lb[hb] = 0.6
        ob[hb] = np.stack([x, np.full(n_hot, 0.2),
                           0.5 + rng.uniform(-0.8 * r, 0.8 * r, n_hot)], 1)
        db[hb] = (0.0, 1.0, 0.0)
    bmed = (rng.random(N) < 0.1).astype(np.float32)
    bmed[hb] = 0.0
    if point:
        bmed[gz] = 0.0
    rows = fill(N, bs.BW, bs.BSLOT, dict(
        o=ob, d=db, length=lb, med=bmed, alpha=rng.uniform(0.1, 1.0, (N, 3)),
        **(dict(w1=w1, l1=l1, sig=rng.uniform(0.2, 2.0, N)) if plane
           else {})))

    # ---- their parents (the gradient tails)
    reconn = (rng.random(N) < 0.6).astype(np.float32)
    elig = (reconn < 0.5) & (rng.random(N) < 0.3)
    if kind.endswith("_me"):
        reconn[elig] = -1.0
    btype = rng.choice([0, 3, 6, 7], N)
    tails = fill(N, bs.TW, bs.TSLOT, dict(
        parent_p=ob - db * rng.uniform(0.0, 0.3, (N, 1)),
        parent_wi=unit(N), parent_ns=unit(N),
        scatter_base=rng.uniform(0.05, 1, (N, 3))
        * (rng.random((N, 1)) > 0.05),
        bp_alb=rng.uniform(0.2, 0.9, (N, 3)),
        bp_spec=rng.uniform(0.1, 0.5, (N, 3)),
        bp_eta3=rng.uniform(0.2, 1.5, (N, 3)),
        bp_sigs=rng.uniform(0.1, 1.0, (N, 3)),
        pdf_dir_base=rng.uniform(0.05, 1.0, N),
        parent_type=rng.choice([0, 1, 2], N), reconnectable=reconn,
        bp_btype=btype,
        bp_alpha=np.where(btype == 6, rng.uniform(5, 40, N),
                          rng.uniform(0.1, 0.5, N)),
        bp_eta1=np.full(N, 1.5), bp_g=rng.uniform(-0.6, 0.6, N),
        bp_ptype=rng.choice([0, 1, 2], N)))

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=device)
    p = bs.Params(r2=float(np.float32(r * r)),
                  k=float(np.float32(1.0 / (2.0 * r))))
    if point:
        tile = 256
        orig = np.sort(rng.choice(2 * N, N, replace=False))
        tile_keys = rng.integers(0, 2 ** 32, (2 * N // tile + 1, 2))
        p = bs.Params(r2=p.r2, k=float(np.float32(3.0 / (4.0 * np.pi * r ** 3))),
                      keys=bs.beam_keys(torch.tensor(tile_keys, device=device),
                                        torch.tensor(orig, device=device),
                                        tile).contiguous(), tile=tile)
    return t(q), t(qx), t(rows), t(tails), p, hot


# translations of beam1d's stress input (beam_stress_inputs' shift): its
# lines' scales A (csrc/beam_eval.cuh line_scale, a query's and a beam
# tile's) then lie near 8,050 r, just inside the guard's 8,192 r, where
# the pre-test's rounding bound is tightest, and past it, where the guard
# sends every pair on to the exact test
BEAM1D_FAR_SHIFTS = (200.0, 210.0)


def beam_stress_inputs(kind, seed=11, device="cpu", shift=0.0):
    """A small seeded input of the primal queued sweeps (beam1d, beam3d,
    plane0d) that a render cannot be relied on to give:
    gsweep_stress_inputs' queries and beams (planes) for g<kind> (the hot
    query accepting the 800 beams 256-1055, over seven of gsweep.cu's beam
    tiles and, at the wrapper's split plan, seven splits; ragged counts,
    invalid queries, a medium mismatch; beam3d's grazing beams 100-163,
    whose chord samples base rejects by rounding), with beams placed
    against the hot query: 0-39 at a distance within 1% of r (either
    side), 40-79 between 1.02 r and 1.98 r (inside beam1d's pre-test
    margin, rejected by its exact test), and for beam1d 164-227 nearly
    parallel to it (1 - cos^2 from 1e-10 to 0.1: across the parallel
    test's 1e-8 and the pre-test's 1e-2), for beam3d short beams whose
    chords are clipped at an end. plane0d's planes are placed instead
    (plane_stress_rows): 0-39 across the hot query with u0 or u1 within
    5 ulp of 0 or of 1, either side; 40-59 across query `hot` + 1, made
    to run along x from the origin, at tcam within 5 ulp of 1e-5 or of its
    length; 164-195 tiny planes whose |det| crosses 1e-7; 196-227 planes
    that nearly hold the hot query's line (det from 0.16 sin 1e-9 to 0.16
    sin 0.1, four of them exactly parallel). Every query and beam origin
    is then moved by `shift` along each axis (BEAM1D_FAR_SHIFTS). Returns
    (q, rows, params, hot)."""
    from gvpm_tpu_torch.ops import beam_sweep as bs
    q, _, rows, _, p, hot = gsweep_stress_inputs("g" + kind, seed, device)
    rng = np.random.default_rng(seed + 1)
    rows = rows.cpu().numpy()
    r = 0.05
    o, d, lb = (bs.BSLOT[k] for k in ("o", "d", "length"))
    if kind == "plane0d":
        q = q.clone()
        plane_stress_rows(q, rows, hot)

    def put(sel, ob, db, length):
        n = len(range(*sel.indices(rows.shape[0])))
        rows[sel, o:o + 3] = ob
        rows[sel, d:d + 3] = db
        rows[sel, lb] = length
        rows[sel, bs.BSLOT["med"]] = 0.0
        assert np.asarray(ob).shape[0] == n

    def ring(n, rho, y):
        """beams along y at distance rho of the hot point (0.5, ., 0.5)"""
        ang = rng.uniform(0.0, 2.0 * np.pi, n)
        return np.stack([0.5 + rho * np.cos(ang), np.broadcast_to(y, (n,)),
                         0.5 + rho * np.sin(ang)], 1)

    sides = np.where(rng.random(40) < 0.5, -1.0, 1.0)
    near = r * (1.0 + 0.01 * rng.uniform(-1.0, 1.0, 40))
    margin = r * rng.uniform(1.02, 1.98, 40)
    along_y = np.tile([0.0, 1.0, 0.0], (40, 1))
    if kind == "beam1d":
        # the hot segment runs from (0.1, 0.5, 0.5) along x for 0.9
        for sel, dist in ((slice(0, 40), near), (slice(40, 80), margin)):
            x = rng.uniform(0.15, 0.95, 40)
            put(sel, np.stack([x, np.full(40, 0.2), 0.5 + sides * dist], 1),
                along_y, 0.6)
        eps = np.logspace(-5, np.log10(0.33), 64)
        db = np.stack([np.ones(64), eps, np.zeros(64)], 1)
        db /= np.linalg.norm(db, axis=1, keepdims=True)
        # crossing y = 0.5 about 0.3 along the beam, 0.5 r off the line
        ob = np.stack([np.full(64, 0.2), 0.5 - 0.3 * db[:, 1],
                       np.full(64, 0.5 + 0.5 * r)], 1)
        put(slice(164, 228), ob, db, 0.6)
    elif kind == "beam3d":
        # the hot sample sits at (0.5, 0.5, 0.5)
        put(slice(0, 40), ring(40, near, 0.2), along_y, 0.6)
        put(slice(40, 80), ring(40, margin, 0.2), along_y, 0.6)
        # ending or starting inside the sphere: the clip at s = 0 or lb
        start = 0.5 + r * rng.uniform(-1.5, 0.9, 64)
        put(slice(164, 228), ring(64, 0.5 * r * rng.random(64), start),
            np.tile([0.0, 1.0, 0.0], (64, 1)), rng.uniform(0.1, 1.5, 64) * r)
    if shift:
        rows[:, o:o + 3] += np.float32(shift)
        q = q.clone()
        q[:, bs.QSLOT["o"]:bs.QSLOT["o"] + 3] += shift
    return (q, torch.tensor(rows, device=device), p, hot)


def plane_stress_rows(q, rows, hot):
    """beam_stress_inputs' plane0d edits, in place: query hot + 1 from
    the origin along x for 0.7, and the planes described there (origin,
    w0, l0, w1, l1, medium 0). Edges are float32 steps (np.nextafter)
    from the edge value."""
    from gvpm_tpu_torch.ops import beam_sweep as bs
    f32 = np.float32
    qs, bsl = bs.QSLOT, bs.BSLOT
    edge = hot + 1
    q[edge, qs["o"]:qs["o"] + 3] = torch.tensor([0.0, 0.5, 0.5],
                                                device=q.device)
    q[edge, qs["d"]:qs["d"] + 3] = torch.tensor([1.0, 0.0, 0.0],
                                                device=q.device)
    q[edge, qs["length"]], q[edge, qs["valid"]] = 0.7, 1.0
    q[edge, qs["med"]] = 0.0

    def steps(v, n=5, stride=1):
        """n float32 values either side of v, `stride` ulp apart"""
        out, lo, hi = [], f32(v), f32(v)
        for _ in range(n):
            for _ in range(stride):
                lo, hi = np.nextafter(lo, f32(-1)), np.nextafter(hi, f32(2))
            out += [lo, hi]
        return np.array(out, f32)

    def put(j, po, w0, l0, w1, l1):
        rows[j, bsl["o"]:bsl["o"] + 3] = po
        rows[j, bsl["d"]:bsl["d"] + 3] = w0
        rows[j, bsl["length"]] = l0
        rows[j, bsl["w1"]:bsl["w1"] + 3] = w1
        rows[j, bsl["l1"]] = l1
        rows[j, bsl["med"]] = 0.0

    ey, ez = (0.0, 1.0, 0.0), (0.0, 0.0, 1.0)
    # across the hot ray (y = z = 0.5 along x from x = 0.1): u0 = (0.5 -
    # oy) / 0.4 near 0 and 1 (8 ulp of 0.1 move u0 by about one of 1),
    # then u1 the same through oz
    near1 = steps(f32(0.5) - f32(0.4), stride=8)
    for i, (oy, oz) in enumerate(
            [(v, 0.3) for v in steps(0.5)] + [(v, 0.3) for v in near1]
            + [(0.3, v) for v in steps(0.5)] + [(0.3, v) for v in near1]):
        put(i, (0.2 + 0.015 * i, oy, oz), ey, 0.4, ez, 0.4)
    # across the edge query: tcam = x near 1e-5 and near its length 0.7
    for i, x in enumerate(np.concatenate([steps(1e-5), steps(0.7)])):
        put(40 + i, (x, 0.3, 0.3), ey, 0.4, ez, 0.4)
    # tiny squares centred on the hot ray: |det| = l^2 across 1e-7
    for i, side in enumerate(np.sqrt(1e-7) * np.linspace(0.97, 1.03, 32)):
        put(164 + i, (0.3 + 0.01 * i, 0.5 - side / 2, 0.5 - side / 2), ey,
            side, ez, side)
    # planes spanned by z and a direction eps off x: det = 0.16 sin eps
    for i, eps in enumerate(np.concatenate([np.zeros(4),
                                            np.logspace(-9, -1, 28)])):
        put(196 + i, (0.3, 0.5 - 0.2 * np.sin(eps), 0.3), ez, 0.4,
            (np.cos(eps), np.sin(eps), 0.0), 0.4)


def lane_use(ev, plan, tbl, qrows, r2, k3, md):
    """Measured lane use on these inputs, in tensor code. A lane-per-row
    loop (one warp a query, 32 lanes striding over each run) makes
    `trips` = sum over queries and runs of ceil(len / 32) trips; those
    with a visit run the shift body with only the visiting lanes busy.
    The queued kernel runs the body in batches of 32 pairs per tile of
    fused_gather.TILE_Q queries, so `batches` = sum over tiles of
    ceil(visits / 32), and sweeps ceil(candidates of a tile / 32) slots
    a tile."""
    from gvpm_tpu_torch.ops import fused_gather as fg
    tile_q = fg.TILE_Q
    lens = (plan.r1 - plan.r0).to(torch.int64)
    trips = int(((lens + 31) // 32).sum())
    per_q = torch.zeros(qrows.shape[0], dtype=torch.int64,
                        device=qrows.device)
    trips_hit = 0
    for s, e, run, row in fg.candidate_chunks(plan):
        q = fg._Cols(qrows, s + run // fg.N_RUNS, ev.q_slots)
        r = fg._Cols(tbl, row, ev.row_slots)
        inside = ev.pair_fn(q, r, md, r2, k3, False)[27] > 0.5
        pos = row - plan.r0[s:e].reshape(-1).to(torch.int64)[run]
        trips_hit += int(torch.unique(
            (run * (1 << 26) + pos // 32)[inside]).numel())
        per_q[s:e].index_add_(0, run // fg.N_RUNS, inside.to(torch.int64))
    visits = int(per_q.sum())
    def per_tile(a):
        pad = (-a.numel()) % tile_q
        return torch.nn.functional.pad(a, (0, pad)).reshape(
            -1, tile_q).sum(1)
    batches = int(((per_tile(per_q) + 31) // 32).sum())
    slots = int(((per_tile(lens.sum(1)) + 31) // 32).sum())
    return dict(trips=trips, trips_with_visit=trips_hit,
                visits_per_such_trip=visits / max(trips_hit, 1),
                lanes_busy_in_such_trip=visits / max(trips_hit, 1) / 32,
                batches=batches,
                lanes_busy_in_batch=visits / max(batches, 1) / 32,
                sweep_slots=slots,
                lanes_busy_in_sweep=int(lens.sum()) / max(slots, 1) / 32)


def kernel_bound(ev, slots, plan, tbl, qrows, candidates, visits):
    """The least time the card could take for this launch: the larger of
    the bytes that must move over the memory rate (once each: the slots
    the eval reads, `slots` = fused_gather.slots_read, of each table row
    that some run covers and of each query row, not the rows' padded
    widths; the run bounds; the outputs) and the float operations these
    inputs need (every candidate's ball test, every visit's shift body)
    over the float32 rate (67 TFLOP/s, which counts a fused multiply-add
    as two; `operations_unfused_ms` in the detail is the same count over
    the rate the card reaches without fusing, the second reading).
    Returns (ms, "bytes" | "operations", detail)."""
    Q = qrows.shape[0]
    rows = covered_rows(plan, tbl.shape[0])
    row_slots, q_slots = (len(s) for s in slots)
    n_bytes = 4 * (rows * row_slots + Q * q_slots + 2 * plan.r0.numel()
                   + Q * ev.n_out + (Q if ev.me else 0))
    kind = ev.name.split("_")[0]
    ops = candidates * BALL_OPS[kind] \
        + visits * (BODY_OPS[kind] + (ME_OPS if ev.me else 0))
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_FP32_S * 1e3
    detail = dict(covered_rows=rows, row_slots=row_slots, q_slots=q_slots,
                  bytes=n_bytes, operations=ops,
                  bytes_ms=t_bytes, operations_ms=t_ops,
                  operations_unfused_ms=ops / PEAK_FP32_UNFUSED_S * 1e3)
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", detail)


def beam_bound(kind, q, rows, stats, accepted):
    """The least time the card could take for one sweep on these inputs:
    the larger of the bytes that must move over the memory rate (each
    query row, beam row, beam key and output once) and the operations
    these inputs need at the float32 rate, beam3d's threefry words at the
    INT32 rate. The operations are the lesser of two counts of the same
    work on this run's pairs (every pair of a valid query and a beam in
    its medium, the pairs past the kernel's test, the pairs of the second
    stage, the accepted pairs): the kernel's (BEAM_OPS) and one thread a
    query's (BEAM_OPS_THREAD). plane0d's pre-test costs more operations
    than plane_hit, so its bound is plane_hit's count. Returns (ms,
    "bytes" | "operations", detail); detail holds both counts."""
    from gvpm_tpu_torch.ops import beam_sweep as bs
    M, N = q.shape[0], rows.shape[0]
    valid = q[:, bs.QSLOT["valid"]] > 0.5
    q_med = q[valid, bs.QSLOT["med"]].to(torch.int64)
    b_med = rows[:, bs.BSLOT["med"]].to(torch.int64)
    n_med = int(max(q_med.max(), b_med.max())) + 1 if q_med.numel() else 1
    pairs = int(torch.bincount(b_med, minlength=n_med)[q_med].sum())
    n_bytes = 4 * (M * bs.QW + N * bs.BW + M * 4) \
        + (16 * N if kind == "beam3d" else 0)

    def count(ops):
        a, b, c, d = ops[kind]
        return pairs * a + stats.get("pretest", 0) * b \
            + stats["stage2"] * c + accepted * d

    kernel_ops, thread_ops = count(BEAM_OPS), count(BEAM_OPS_THREAD)
    fops = min(kernel_ops, thread_ops)
    iops = stats["stage2"] * BEAM_INT_OPS if kind == "beam3d" else 0
    t = dict(bytes=n_bytes / PEAK_BYTES_S * 1e3,
             operations=max(fops / PEAK_FP32_S, iops / PEAK_INT32_S) * 1e3)
    by = max(t, key=t.get)
    return t[by], by, dict(
        queries=M, valid_queries=int(valid.sum()), beams=N, pairs=pairs,
        pretest=stats.get("pretest"), stage2=stats["stage2"],
        accepted=accepted, bytes=n_bytes,
        float_ops=fops, int_ops=iops, float_ms=fops / PEAK_FP32_S * 1e3,
        int_ms=iops / PEAK_INT32_S * 1e3,
        float_unfused_ms=fops / PEAK_FP32_UNFUSED_S * 1e3,
        kernel_ops=kernel_ops, kernel_ops_ms=kernel_ops / PEAK_FP32_S * 1e3,
        thread_ops=thread_ops, thread_ops_ms=thread_ops / PEAK_FP32_S * 1e3)


def gbeam_bound(kind, q, rows, stats):
    """beam_bound for a gradient sweep (GBEAM_OPS): the bytes of the
    query, offset, beam, tail, key and output rows once; the operations
    of every pair, of the second stage, of the accepted pairs' base
    terms and of their four shifts by branch (an ME sweep's pairs on
    ME-eligible beams: ME_OPS_PAIR and ME_OPS_OFFSET). Returns (ms,
    "bytes" | "operations", detail)."""
    from gvpm_tpu_torch.ops import beam_sweep as bs
    M, N = q.shape[0], rows.shape[0]
    valid = q[:, bs.QSLOT["valid"]] > 0.5
    q_med = q[valid, bs.QSLOT["med"]].to(torch.int64)
    b_med = rows[:, bs.BSLOT["med"]].to(torch.int64)
    n_med = int(max(q_med.max(), b_med.max())) + 1 if q_med.numel() else 1
    pairs = int(torch.bincount(b_med, minlength=n_med)[q_med].sum())
    nf, nc = bs._widths(kind)
    base = kind.removesuffix("_me")
    n_bytes = 4 * (M * (bs.QW + bs.XW + nf + nc) + N * (bs.BW + bs.TW)) \
        + (16 * N if base == "gbeam3d" else 0)
    a, b, c, d, e = GBEAM_OPS[base]
    acc, rc, me = stats["accepted"], stats["reconn"], stats.get("me", 0)
    fops = pairs * a + stats["stage2"] * b + acc * c + me * ME_OPS_PAIR \
        + 4 * (rc * d + (acc - rc - me) * e + me * ME_OPS_OFFSET)
    iops = stats["stage2"] * BEAM_INT_OPS if base == "gbeam3d" else 0
    t = dict(bytes=n_bytes / PEAK_BYTES_S * 1e3,
             operations=max(fops / PEAK_FP32_S, iops / PEAK_INT32_S) * 1e3)
    by = max(t, key=t.get)
    return t[by], by, dict(
        queries=M, valid_queries=int(valid.sum()), beams=N, pairs=pairs,
        stage2=stats["stage2"], accepted=acc, reconnectable=rc,
        me_eligible=me, bytes=n_bytes, float_ops=fops, int_ops=iops,
        float_ms=fops / PEAK_FP32_S * 1e3, int_ms=iops / PEAK_INT32_S * 1e3,
        float_unfused_ms=fops / PEAK_FP32_UNFUSED_S * 1e3)


def capture_gsweeps(scene, cfg, passes_kw):
    """One gvpm pass of each beam volume on `scene`; returns {kind: the
    (q, qx, rows, tails, params) of its first gradient sweep call} (the
    _me kinds with cfg.use_manifold)."""
    from gvpm_tpu_torch.integrators import gvpm
    from gvpm_tpu_torch.ops import beam_sweep as bs
    calls, orig = {}, bs.gsweep

    def record(kind, *args):
        calls.setdefault(kind, args)
        return orig(kind, *args)

    bs.gsweep = record
    try:
        for volume in GBEAM_VOLUMES.values():
            gvpm.render_pass(scene, cfg, volume, **passes_kw)
    finally:
        bs.gsweep = orig
    return calls


def gbeams_against_plain(kind, args):
    """The gradient sweep kernel twice and its plain version once on the
    same inputs: visits and shift_ok exactly equal, sums within TOL, the
    two launches bitwise equal. Returns (plain outputs, plain stats, max
    abs error, plain ms by CUDA events)."""
    from gvpm_tpu_torch.ops import beam_sweep as bs
    got = bs.gsweep(kind, *args)
    again = bs.gsweep(kind, *args)
    stats = {}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = bs.gsweep_plain(kind, *args, stats=stats)
    end.record()
    torch.cuda.synchronize()
    for g, w, name in zip(got[3:], want[3:], ("visits", "shift_ok")):
        if g.dtype != torch.int32 or not torch.equal(g, w):
            raise AssertionError(f"beam_sweep_{kind}: {name} differ from "
                                 "the plain version")
    for g, w in zip(got[:3], want[:3]):
        torch.testing.assert_close(g, w, **TOL)
    if not all(torch.equal(g.view(torch.int32), a.view(torch.int32))
               for g, a in zip(got, again)):
        raise AssertionError(f"beam_sweep_{kind}: two launches on the same "
                             "inputs differ")
    err = max(float((g - w).abs().max()) for g, w in zip(got[:3], want[:3]))
    return want, stats, err, start.elapsed_time(end)


def gsweep_stats(kind, q, rows, tails, p):
    """gsweep_plain's stats (stage2, accepted, reconn, me) of every pair
    from its dense base test alone, without the shifts."""
    from gvpm_tpu_torch.ops import beam_sweep as bs
    M, N = q.shape[0], rows.shape[0]
    base_fn, _ = bs.GPAIRS[kind.removesuffix("_me")]
    tb = max(1, min(N, max(256, bs.PLAIN_MAX_PAIRS // max(M, 1))))
    mc = max(1, min(M, bs.PLAIN_MAX_PAIRS // tb))
    rc = tails[:, bs.TSLOT["reconnectable"]]
    stats = dict(stage2=0, accepted=0, reconn=0, me=0)
    for m0 in range(0, M, mc):
        qc = bs._Cols(q[m0:m0 + mc], bs.QSLOT, (-1, 1))
        for j0 in range(0, N, tb):
            pp = dataclasses.replace(p, keys=p.keys[j0:j0 + tb]) \
                if p.keys is not None else p
            okb, _, stage2 = base_fn(
                qc, bs._Cols(rows[j0:j0 + tb], bs.BSLOT, (1, -1)), pp, m0)
            r = rc[j0:j0 + tb][None]
            stats["stage2"] += int(stage2.sum())
            stats["accepted"] += int(okb.sum())
            stats["reconn"] += int((okb & (r > 0.5)).sum())
            stats["me"] += int((okb & (r < -0.5)).sum())
    return stats


def gsweep_stress_against_plain(kind):
    """The stress input (gsweep_stress_inputs) of a gradient sweep
    (beam_sweep.GKINDS, GKINDS_ME) on the card: the kernel twice at its
    split plan and twice in one split (whose ring then lives across many
    beam tiles) against the plain version once: visits, shift_ok and the ME
    keys and counts exactly equal, sums within TOL, each pair of
    launches bitwise equal; the hot query must keep its 800 beams.
    Returns (plain outputs, hot query, max abs error, beams)."""
    from gvpm_tpu_torch.ops import beam_sweep as bs
    *args, hot = gsweep_stress_inputs(kind, device="cuda")
    want = bs.gsweep_plain(kind, *args)
    target, err = bs.GTARGET_BLOCKS, 0.0
    try:
        for bs.GTARGET_BLOCKS in (target, 1):
            got, again = bs.gsweep(kind, *args), bs.gsweep(kind, *args)
            torch.cuda.synchronize()
            for k in range(3, min(len(want), 7)):
                if got[k].dtype != torch.int32 or not torch.equal(got[k],
                                                                  want[k]):
                    raise AssertionError(f"beam_sweep_{kind}: stress count "
                                         f"{k} differs from the plain "
                                         "version")
            if len(want) > 7 and want[7] is not None and not torch.equal(
                    got[7].view(torch.int32), want[7].view(torch.int32)):
                raise AssertionError(f"beam_sweep_{kind}: stress chord "
                                     "points differ from the plain version")
            for g, w in zip(got[:3], want[:3]):
                torch.testing.assert_close(g, w, **TOL)
            if not all(torch.equal(g.view(torch.int32), a.view(torch.int32))
                       for g, a in zip(got, again) if g is not None):
                raise AssertionError(f"beam_sweep_{kind}: two launches on "
                                     "the stress input differ")
            err = max([err] + [float((g - w).abs().max())
                               for g, w in zip(got[:3], want[:3])])
    finally:
        bs.GTARGET_BLOCKS = target
    if not int(want[3][hot]) >= 800:
        raise AssertionError(f"beam_sweep_{kind}: the hot query has "
                             f"{int(want[3][hot])} visits")
    return want, hot, err, args[2].shape[0]


def gsweep_lane_use(kind, q, rows, tails, p, shape, chunk):
    """Measured lane use of a gradient sweep's shift bodies on these
    inputs, in tensor code from the dense base-test planes that
    gsweep_stats builds.

    One thread a query (the kernel before gsweep.cu): a warp holds 32
    consecutive queries and visits the beams in order; in an iteration
    where some lane accepts its pair, the shift body runs with the
    accepting lanes busy (`iterations_with_accept`,
    `lanes_busy_in_such_iteration`), and its reconnection branch with
    the lanes whose accepted beam reconnects
    (`lanes_busy_in_reconnection_branch`, over the iterations with such
    a lane).

    The queued kernel (gsweep.cu; `shape` = beam_sweep.gsweep_shape(),
    `chunk` the beams of a split): a block owns a tile of `tq` queries,
    its warp w the queries w, w + warps, ...; the pairs a warp's queries
    accept in the block's beam split go into the warp's ring and run in
    batches of `batch` pairs (32 / batch lanes a pair), the last batch of
    the split partial, so `batches` = the sum over (query tile, warp,
    split) of ceil(accepted / batch) and `lanes_busy_in_batch` = accepted
    / (batches x batch); a batch runs both branches, the reconnection
    with `lanes_busy_in_batch_reconnection` of the lanes;
    gbeam3d queues the pairs past its chord test (`queued`), of which
    base rejects a few by rounding, and a rejected pair's lanes idle;
    `lanes_busy_if_flushed_per_tile`: the ring emptied at the end of
    every beam tile of `tile_b` (a kernel whose batches read the staged
    beam rows). `barrier_share`: the share of the pairs' shift time that
    a warp spends waiting at the block's tile barriers if shifts cost
    the same per pair (1 - sum over query and beam tiles of the warps'
    mean pairs / sum of their most)."""
    from gvpm_tpu_torch.ops import beam_sweep as bs
    M, N = q.shape[0], rows.shape[0]
    tq, warps, tile_b, batch = (shape[k] for k in ("tq", "warps", "tile_b",
                                                   "batch"))
    base_fn, _ = bs.GPAIRS[kind.removesuffix("_me")]
    rc_all = tails[:, bs.TSLOT["reconnectable"]] > 0.5
    lcm = 32 * tq // int(np.gcd(32, tq))
    mc = lcm * max(1, 1024 // lcm)
    tb = max(1, bs.PLAIN_MAX_PAIRS // mc // tile_b) * tile_b
    n_tiles = -(-N // tile_b)
    # accepted pairs a (query tile, warp, beam tile)
    per = torch.zeros((-(-M // mc) * mc // tq, warps, n_tiles),
                      dtype=torch.int64, device=q.device)
    accepted = n_queued = iters = iters_rc = n_rc = 0
    for m0 in range(0, M, mc):
        qc = bs._Cols(q[m0:m0 + mc], bs.QSLOT, (-1, 1))
        for j0 in range(0, N, tb):
            pp = dataclasses.replace(p, keys=p.keys[j0:j0 + tb]) \
                if p.keys is not None else p
            okb, _, stage2 = base_fn(
                qc, bs._Cols(rows[j0:j0 + tb], bs.BSLOT, (1, -1)), pp, m0)
            rc = rc_all[j0:j0 + tb][None]
            queued = stage2 if kind.startswith("gbeam3d") else okb
            # pad to whole warps of queries, query tiles and beam tiles
            pad = (0, (-okb.shape[1]) % tile_b, 0, (-okb.shape[0]) % mc)
            okb = torch.nn.functional.pad(okb, pad)
            queued = torch.nn.functional.pad(queued, pad)
            okr = torch.nn.functional.pad(okb[:, :rc.shape[1]] & rc,
                                          (0, okb.shape[1] - rc.shape[1]))
            accepted += int(okb.sum())
            n_queued += int(queued.sum())
            n_rc += int(okr.sum())
            iters += int(okb.reshape(-1, 32, okb.shape[1]).any(1).sum())
            iters_rc += int(okr.reshape(-1, 32, okb.shape[1]).any(1).sum())
            t0 = j0 // tile_b
            per[m0 // tq:(m0 + mc) // tq, :,
                t0:t0 + okb.shape[1] // tile_b] += queued.reshape(
                    mc // tq, tq // warps, warps, -1, tile_b).sum((1, 4))
    split = torch.arange(n_tiles, device=q.device) // (chunk // tile_b)
    per_split = torch.zeros((per.shape[0], warps, int(split[-1]) + 1),
                            dtype=torch.int64, device=q.device)
    per_split.index_add_(2, split, per)

    def n_batches(a):
        return int(((a + batch - 1) // batch).sum())
    batches = n_batches(per_split)
    most = per.max(1).values.sum()
    return dict(accepted=accepted, queued=n_queued,
                on_reconnectable_beams=n_rc,
                iterations_with_accept=iters,
                lanes_busy_in_such_iteration=accepted / max(iters, 1) / 32,
                lanes_busy_in_reconnection_branch=n_rc / max(iters_rc, 1)
                / 32,
                batch=batch, batches=batches,
                lanes_busy_in_batch=accepted / max(batches * batch, 1),
                lanes_busy_in_batch_reconnection=n_rc
                / max(batches * batch, 1),
                lanes_busy_if_flushed_per_tile=accepted
                / max(n_batches(per) * batch, 1),
                barrier_share=1.0 - float(per.sum()) / warps
                / max(float(most), 1.0))


def gbeams_me_against_plain(kind, args):
    """An ME sweep's kernel twice on every query and its plain version
    once on the first 1 / PLAIN_EVERY of the valid queries (the segment
    compaction puts the valid ones first; a prefix keeps beam3d's words,
    which are indexed by the query's row): visits, shift_ok, ME key, ME
    pairs and gbeam3d_me's chord point exactly equal on those rows, sums
    within TOL, the two launches bitwise equal. Returns (kernel outputs,
    plain ms, max abs error, rows compared, ME queries among them)."""
    from gvpm_tpu_torch.ops import beam_sweep as bs
    q, qx, rows, tails, p = args
    got = bs.gsweep(kind, *args)
    again = bs.gsweep(kind, *args)
    valid = q[:, bs.QSLOT["valid"]] > 0.5
    n = max(1, int(valid.sum()) // PLAIN_EVERY)
    if not bool(valid[:n].all()):
        raise AssertionError(f"beam_sweep_{kind}: the first {n} queries "
                             "are not all valid")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = bs.gsweep_plain(kind, q[:n], qx[:n], rows, tails, p)
    end.record()
    torch.cuda.synchronize()
    for k, name in ((3, "visits"), (4, "shift_ok"), (5, "ME key"),
                    (6, "ME pairs")):
        if got[k].dtype != torch.int32 or not torch.equal(got[k][:n],
                                                          want[k]):
            raise AssertionError(f"beam_sweep_{kind}: {name} differ from "
                                 "the plain version")
    if (got[7] is None) != (kind != "gbeam3d_me") or (
            got[7] is not None and not torch.equal(
                got[7][:n].view(torch.int32), want[7].view(torch.int32))):
        raise AssertionError(f"beam_sweep_{kind}: chord points differ from "
                             "the plain version")
    me_queries = int((want[5] != bs.ME_NONE).sum())
    if not me_queries > 0:
        raise AssertionError(f"beam_sweep_{kind}: no ME pair on the rows "
                             "compared")
    pairs = [(got[0][:n], want[0])] + [(got[k][:, :n], want[k])
                                       for k in (1, 2)]
    for g, w in pairs:
        torch.testing.assert_close(g, w, **TOL)
    if not all(torch.equal(g.view(torch.int32), a.view(torch.int32))
               for g, a in zip(got, again) if g is not None):
        raise AssertionError(f"beam_sweep_{kind}: two launches on the same "
                             "inputs differ")
    err = max(float((g - w).abs().max()) for g, w in pairs)
    return got, start.elapsed_time(end), err, n, me_queries


def gather_against_plain(name, ev, args):
    """The fused gather kernel twice and its plain version once on `args`:
    visits, shift_ok and ME keys equal, sums within TOL, the two
    launches bitwise equal. Returns (plain out, ME queries, err)."""
    from gvpm_tpu_torch.ops import fused_gather as fg
    got, got_me = fg.fused_gather(ev, *args)
    again, again_me = fg.fused_gather(ev, *args)
    want, want_me = fg.fused_gather_plain(ev, *args)
    torch.cuda.synchronize()
    if not torch.equal(got[:, 27:29], want[:, 27:29]):
        raise AssertionError(f"{name}: visits/shift_ok differ from the "
                             "plain version")
    torch.testing.assert_close(got, want, **TOL)
    me_queries = None
    if ev.me:
        if got_me.dtype != torch.int32 or not torch.equal(got_me,
                                                          want_me):
            raise AssertionError(f"{name}: ME row keys differ from the "
                                 "plain version")
        me_queries = int((got_me != fg.ME_NONE).sum())
        if not me_queries > 0:
            raise AssertionError(f"{name}: no query has an ME pair")
    elif got_me is not None or want_me is not None:
        raise AssertionError(f"{name}: unexpected ME output")
    # the sums' order is fixed (segmented warp reductions, no atomics)
    if not (torch.equal(got.view(torch.int32), again.view(torch.int32))
            and (not ev.me or torch.equal(got_me, again_me))):
        raise AssertionError(f"{name}: two launches on the same inputs "
                             "differ")
    return want, me_queries, float((got - want).abs().max())


# the ME Newton kernel against its plain version: u, the geometric terms,
# the chain's Fresnel terms and lengths, and the exit point and distance;
# the unit vectors (anchor direction, exit direction) at an absolute bar
# of ~17 float32 ulps of their length 1: the last Newton step carries the
# two versions' rounding (PyTorch's CPU reductions against the kernel's
# sums) through J^-1, and on a headline pass (16,384 lanes a call) one
# exit-direction component of 49,152 read 1.25e-6 apart; the first
# Jacobian against torch.func.jvp's
ME_NEWTON_TOL = dict(rtol=1e-4, atol=1e-6)
ME_NEWTON_DIR_TOL = dict(rtol=1e-4, atol=2e-6)
ME_NEWTON_J0_TOL = dict(rtol=1e-5, atol=1e-6)


def me_newton_plain(target, scene, ch, c_t, photon, n_iters, scale):
    """The plain Newton solve of an ME shift (manifold._newton3_plain, or
    _newton2_plain for the surface target) on the tensors as they are,
    with the Jacobians its determinants are taken of recorded. Returns
    (its outputs, the first Jacobian, the steps taken as int32 bits: bit
    i where step i's |det J| > 1e-18)."""
    from gvpm_tpu_torch.integrators import manifold
    name = "_det2" if target == "surface" else "_det3"
    det = getattr(manifold, name)
    seen = []
    setattr(manifold, name, lambda J: (seen.append(J), det(J))[1])
    try:
        if target == "surface":
            res = manifold._newton2_plain(scene, ch, *photon, c_t, n_iters,
                                          scale)
        else:
            res = manifold._newton3_plain(scene, ch, c_t, n_iters, scale,
                                          target)
    finally:
        setattr(manifold, name, det)
    steps = torch.zeros(c_t.shape[0], dtype=torch.int32, device=c_t.device)
    for i, J in enumerate(seen[:n_iters]):
        steps |= (torch.abs(det(J)) > 1e-18).to(torch.int32) << i
    return res, seen[0], steps


def me_newton_cpu(scene, ch, c_t, photon, scale):
    """CPU copies of a shift call's (scene, chain dict, targets, photon
    args, scale): the plain version's device."""
    return (scene.to("cpu"), {k: v.cpu() for k, v in ch.items()}, c_t.cpu(),
            None if photon is None else tuple(t.cpu() for t in photon),
            scale.cpu())


def me_newton_launch(inp, out):
    """One launch of the ME Newton kernel on its argument structs."""
    import ctypes

    from gvpm_tpu_torch.ops import me_newton
    err = me_newton.build().gvpm_me_newton(
        ctypes.byref(inp), ctypes.byref(out),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"me_newton launch failed: CUDA error {err}")


def me_newton_traced(run, target, scene, ch, c_t, photon, n_iters, scale):
    """The kernel's solve of the same inputs through `run(In, Out)` (a
    launch on the card, `me_newton_launch`, or a host build of
    csrc/me_newton.cuh) with its first Jacobian and steps: returns (its
    outputs as the plain version returns them, the first Jacobian, the
    steps taken as int32 bits)."""
    from gvpm_tpu_torch.ops import me_newton
    me_newton.check_inputs(target, scene, ch, c_t, photon)
    inp, res, out, _keep = me_newton.launch_args(
        target, scene, ch, c_t, n_iters, scale.reshape(1), photon,
        trace=True)
    run(inp, res)
    return me_newton.results(target, out), out["jac0"], out["steps"]


def me_newton_against_plain(target, got, want):
    """Raises unless `got` and `want` (each (outputs, first Jacobian,
    steps) of me_newton_traced / me_newton_plain) take the same
    decisions lane for lane (each step's guard, conv, ok_tr) and agree
    within ME_NEWTON_TOL (the unit vectors within ME_NEWTON_DIR_TOL, the
    first Jacobian within ME_NEWTON_J0_TOL).
    Returns {output: largest |difference|} and the converged lanes.
    Compared on the CPU: `want` may come from the plain version where the
    port runs it, on CPU copies of the card's inputs (`me_newton_cpu`)."""
    def on_cpu(res):
        (*outs, aux), j0, steps = res
        return (tuple(t.cpu() for t in outs) + (tuple(t.cpu() for t in aux),),
                j0.cpu(), steps.cpu())

    (g, g_j0, g_steps), (w, w_j0, w_steps) = on_cpu(got), on_cpu(want)
    if not torch.equal(g_steps, w_steps):
        raise AssertionError(f"me_newton {target}: the steps taken differ "
                             "from the plain version's")
    for name, a, b in (("conv", g[1], w[1]), ("ok_tr", g[4][0], w[4][0])):
        if not torch.equal(a, b):
            raise AssertionError(f"me_newton {target}: {name} differs from "
                                 "the plain version's")
    names = ["u", "rho_off", "rho_base", "F_off", "len_off", "w1_new"] + (
        ["exit_p"] if target == "beam" else ["t_end"]
        if target == "surface" else []) + ["exit_d"]
    pairs = list(zip(names, (g[0], g[2], g[3]) + tuple(g[4][1:]),
                     (w[0], w[2], w[3]) + tuple(w[4][1:])))
    if len(g[4]) != len(w[4]) or len(pairs) != len(names):
        raise AssertionError(f"me_newton {target}: outputs differ in kind")
    err, failed = {}, []
    for name, a, b in pairs + [("jac0", g_j0, w_j0)]:
        tol = ME_NEWTON_J0_TOL if name == "jac0" else ME_NEWTON_DIR_TOL \
            if name in ("w1_new", "exit_d") else ME_NEWTON_TOL
        d = (a - b).abs().flatten()
        d = d[~d.isnan()]
        err[name] = float(d.max()) if d.numel() else 0.0
        try:
            torch.testing.assert_close(a, b, equal_nan=True, **tol)
        except AssertionError as e:
            failed.append(f"{name}: {e}")
    if failed:
        raise AssertionError(f"me_newton {target}: largest |differences| "
                             f"{err}; " + "; ".join(failed))
    return err, int(w[1].sum())


def me_newton_ops(target, scene, ch, photon, n_iters, steps):
    """Float operations the ME Newton kernel does on these lanes
    (ME_NEWTON_OPS): n_iters + 1 evaluations of each lane's chain, the
    determinant of each Jacobian and of the first once more, and a solve
    and a trust step for each step taken (`steps`: me_newton_traced's
    bits)."""
    n = 2 if target == "surface" else 3
    c = {k: a + b * n for k, (a, b) in ME_NEWTON_OPS.items()}
    c_tri = c["tri"] if scene.n_tris else 0      # else the filler: no hit
    c_sph = c["sphere"] if scene.n_spheres else 0

    def hit(prim):
        tri = prim < scene.n_tris
        return tri * c_tri + ~tri * c_sph

    K = ch["prim"].shape[0]
    live = torch.arange(K, device=ch["k"].device)[:, None] < ch["k"][None]
    refract = ch["is_diel"] & ~ch["branch_refl"]
    bounce = refract * c["refract"] + ~refract * c["reflect"]
    per_eval = c["w1"] + ((hit(ch["prim"]) + bounce + c["advance"])
                          * live).sum(0)
    per_eval = per_eval + (c["residual2"] + hit(photon[0])
                           if target == "surface" else c["residual3"])
    taken = sum((steps >> i) & 1 for i in range(n_iters))
    return int(((n_iters + 1) * per_eval + (n_iters + 2)
                * ME_NEWTON_DET_OPS[n] + taken
                * ME_NEWTON_STEP_OPS[n]).sum())


def me_newton_same_bits(a, b):
    """Two solves' outputs (u, conv, rho_off, rho_base, aux) equal bit for
    bit, NaNs included."""
    def bits(t):
        return t.view(torch.int32) if t.is_floating_point() else t

    return all(torch.equal(bits(x), bits(y))
               for x, y in zip(a[:4] + a[4], b[:4] + b[4]))


def capture_me_shifts(run):
    """Call `run()` with integrators/manifold's volume and surface shifts
    recorded: returns their calls in order, each as (target, scene, chain
    dict, target points, photon args of the surface target or None,
    n_iters, scene_scale)."""
    from gvpm_tpu_torch.integrators import manifold
    calls = []
    shifts = {"volume": "me_shift_volume", "surface": "me_shift_surface"}
    orig = {t: getattr(manifold, f) for t, f in shifts.items()}

    def recorder(target):
        def rec(scene, ch, *args, n_iters=5, scene_scale=1.0, **kw):
            photon = tuple(args[:3]) if target == "surface" else None
            calls.append((target, scene, ch, args[-1], photon, n_iters,
                          scene_scale))
            return orig[target](scene, ch, *args, n_iters=n_iters,
                                scene_scale=scene_scale, **kw)
        return rec

    for t, f in shifts.items():
        setattr(manifold, f, recorder(t))
    try:
        run()
    finally:
        for t, f in shifts.items():
            setattr(manifold, f, orig[t])
    return calls


def me_newton_phase(calls):
    """[me-newton]: the ME Newton kernel (ops/me_newton.py) on the largest
    volume and surface shift call of `calls` (capture_me_shifts of a
    headline ME pass: 16,384 lanes at its full budget) through
    me_newton.solve, as the port calls it, against its plain version,
    which the port runs on the CPU, on CPU copies of the inputs at
    me_newton_against_plain's bars (the first Jacobian and the steps
    from a traced launch), two launches bitwise equal; the kernel's ms
    (20 launches after 5; and of a whole call through the wrapper, whose
    host work is longer), the plain version's on the card (one call on
    the card's tensors), the bound (the larger of the bytes the lanes
    read and write once at PEAK_BYTES_S and me_newton_ops at
    PEAK_FP32_S) and ptxas's registers and spills. Returns {target:
    numbers}."""
    from gvpm_tpu_torch.ops import me_newton
    report = me_newton.build_report()
    out = {}
    for target in ("volume", "surface"):
        c = max((c for c in calls if c[0] == target),
                key=lambda c: c[3].shape[0])
        _, scene, ch, c_t, photon, n_iters, scale = c
        scale = scale.reshape(1)
        s_cpu, ch_cpu, c_cpu, ph_cpu, sc_cpu = me_newton_cpu(
            scene, ch, c_t, photon, scale)
        want = me_newton_plain(target, s_cpu, ch_cpu, c_cpu, ph_cpu,
                               n_iters, sc_cpu)
        _, j0, steps = me_newton_traced(me_newton_launch, target, scene,
                                        ch, c_t, photon, n_iters, scale)

        def kernel():
            return me_newton.solve(target, scene, ch, c_t, n_iters, scale,
                                   photon)

        a = kernel()
        torch.cuda.synchronize()
        err, converged = me_newton_against_plain(target, (a, j0, steps),
                                                 want)
        if not me_newton_same_bits(a, kernel()):
            raise AssertionError(f"me_newton {target}: two launches on the "
                                 "same inputs differ")
        # the launch alone (its host side is shorter than the kernel) and
        # a whole call through the wrapper (checks, allocations, launch)
        inp, res, _, _keep = me_newton.launch_args(
            target, scene, ch, c_t, n_iters, scale, photon)
        ms = cuda_ms(lambda: me_newton_launch(inp, res), 20, warm=5)
        call_ms = cuda_ms(kernel, 20, warm=5)
        plain_ms = cuda_ms(lambda: me_newton_plain(
            target, scene, ch, c_t, photon, n_iters, scale), 1, warm=0)
        n_bytes = sum(t.nbytes for _, t, _, _ in me_newton.kernel_inputs(
            target, scene, ch, c_t, photon)) \
            + sum(t.nbytes for t in a[:4] + a[4]) + scale.nbytes
        ops = me_newton_ops(target, scene, ch, photon, n_iters, steps)
        t_bytes = n_bytes / PEAK_BYTES_S * 1e3
        t_ops = ops / PEAK_FP32_S * 1e3
        bound_ms = max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        r = report["surface" if target == "surface" else "volume"]
        out[target] = dict(lanes=c_t.shape[0], converged=converged,
                           max_abs_err=max(err.values()), ms=ms,
                           call_ms=call_ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=bound_by,
                           bytes=n_bytes, operations=ops, **r)
        phase("me-newton", f"{target}: {c_t.shape[0]} lanes, {converged} "
                           f"converged, decisions equal, max|err| "
                           f"{json.dumps(err)}, two launches bitwise equal, "
                           f"kernel {ms:.4f} ms (a call through the "
                           f"wrapper {call_ms:.4f} ms), plain "
                           f"{plain_ms:.1f} ms, "
                           f"bound {bound_ms:.3g} ms by {bound_by} "
                           f"({n_bytes} bytes, {ops} operations), "
                           f"{r['registers']} registers, spills "
                           f"{r['spill_stores']} / {r['spill_loads']} "
                           f"bytes, stack {r['stack']}")
    return out


# the scenes of the registry besides box-medium that the goldens hold
# bars for, and the feature scenes of [het] / [lights]
GOLD_SCENES = ("laser", "caustic-glass")
FEATURE_SPP = 4           # volpath spp of the [het] / [lights] renders
# passes of caustic-glass's 32^2 gvpm render with ME on in [scenes] (no
# bar: finite, beside ME off's 10; depth cut for the script's time)
SCENE_ME_PASSES = 5


def _gold_meta(sub):
    gdir = os.path.normpath(os.path.join(ROOT, "goldens", sub))
    with open(os.path.join(gdir, "meta.json")) as f:
        return gdir, json.load(f)


def scene_kernels(smi, base_ms):
    """The kernels against their plain versions on inputs of the scenes
    this slice added: K1-ME / K2-ME on one caustic-glass 128^2 ME pass
    (photons and gather points around a delta dielectric sphere), K2 on
    one pass of the materials box (plastic, phong and rough-conductor
    surfaces), and the primal sweeps on one laser 128^2 check-config
    pass (a dense anisotropic fog). Prints each kernel's ms beside the
    box-medium figure of the same kernel (`base_ms`)."""
    from gvpm_tpu_torch import scenes
    from gvpm_tpu_torch.core.config import GradientConfig, PhotonConfig
    from gvpm_tpu_torch.integrators import gradient_gather, gvpm, sppm
    from gvpm_tpu_torch.ops import beam_sweep as bs
    from gvpm_tpu_torch.ops import fused_gather as fg
    from gvpm_tpu_torch.scene.types import (BSDF_PHONG, BSDF_PLASTIC,
                                            BSDF_ROUGH_CONDUCTOR)

    def gathers(scene, cfg):
        captured, launch = {}, fg.fused_gather

        def capture(ev, *args):
            captured.setdefault(ev.name, args)
            return launch(ev, *args)

        fg.fused_gather = capture
        try:
            gvpm.render_pass(scene, cfg, "distance", cfg.volume_photons, 5,
                             0, 1.0, 1.0, sppm.base_volume_radius(scene, cfg))
        finally:
            fg.fused_gather = launch
        return captured

    def hold(label, name, args):
        ev = gradient_gather.EVALS[name]
        want, me_q, err = gather_against_plain(name, ev, args)
        ms = cuda_ms(lambda: fg.fused_gather(ev, *args), 10, warm=5)
        me = f", ME queries {me_q} (row keys equal)" if ev.me else ""
        phase("scenes", f"{label} {name}: {args[2].shape[0]} queries x "
                        f"{args[1].shape[0]} rows, visits "
                        f"{int(want[:, 27].sum())} and shift_ok "
                        f"{int(want[:, 28].sum())} equal{me}"
                        f", max|err| {err:.3g} (rtol 2e-4 atol 5e-6), two "
                        f"launches bitwise equal; kernel {ms:.3f} ms "
                        f"(box-medium headline {base_ms[name]:.3f} ms; "
                        f"{smi})")
        return want

    cfg_me = GradientConfig(**dict(GVPM_GOLD_KW, use_manifold=True))
    caught = gathers(scenes.caustic_glass(128, 128), cfg_me)
    for name in ("surface_me", "volume_me"):
        hold("caustic-glass 128^2 ME pass:", name, caught[name])
    caught = gathers(scenes.feature_scene("materials", 128, 128, seed=5),
                     GradientConfig(**GVPM_GOLD_KW))
    args = caught["surface"]
    ev = gradient_gather.EVALS["surface"]
    qbt = args[2][:, ev.q_slots["btype"]].round().long()
    want = hold("materials box 128^2 pass:", "surface", args)
    by_lobe = {}
    for lobe, bt in (("plastic", BSDF_PLASTIC), ("phong", BSDF_PHONG),
                     ("rough_conductor", BSDF_ROUGH_CONDUCTOR)):
        by_lobe[lobe] = (int((qbt == bt).sum()),
                         int(want[qbt == bt, 27].sum()))
        if not by_lobe[lobe][1] > 0:
            raise AssertionError(f"materials box: no photon visits a "
                                 f"{lobe} gather point")
    phase("scenes", "materials box: (gather points, visits) on each lobe "
                    + json.dumps(by_lobe))
    lscene = scenes.laser_beam(128, 128)
    bcfg = PhotonConfig(**BEAM_GOLD_KW)
    b_pass = dict(n_photons=max(bcfg.surface_photons, bcfg.volume_photons),
                  seed=5, it=0, surf_scale=1.0, vol_scale=1.0,
                  r_vol_base=sppm.base_volume_radius(lscene, bcfg))
    for kind, (q, rows, p) in capture_sweeps(lscene, bcfg, b_pass).items():
        _, n_acc, _, err = beams_against_plain(kind, q, rows, p)
        ms = cuda_ms(lambda: bs.sweep(kind, q, rows, p), 5)
        phase("scenes", f"laser 128^2 check-config pass: {kind} "
                        f"(gsweep.cu) {q.shape[0]} camera queries x "
                        f"{rows.shape[0]} beams, accepted pairs "
                        f"{int(n_acc.sum())} equal, max|err| {err:.3g} "
                        f"(rtol 2e-4 atol 5e-6), two launches bitwise "
                        f"equal; kernel {ms:.3f} ms (box-medium "
                        f"{base_ms[kind]:.3f} ms; {smi})")


def scene_goldens():
    """[scenes]: the golden bars of laser and caustic-glass. At 128^2
    (goldens/meta.json) sppm distance / bre / beam1d / beam3d / plane0d
    and gvpm:distance with ME off at tools/goldens.py's check configs
    (10 passes, plane0d 30, seed 5); at 32^2 (goldens/ci) sppm:distance,
    sppm:beam1d and gvpm:distance (10 passes), gvpm:distance once more
    with ME on (no bar: finite, printed beside ME off); volpath at the
    32^2 golden's generation config within agree_relmse; the gvpm gx
    against the 128^2 golden's finite differences above 0.5
    (tools/goldens.py:237-255: 2^15 paths, seed 7, 10 passes)."""
    from gvpm_tpu_torch import scenes
    from gvpm_tpu_torch.core.config import (GradientConfig, PhotonConfig,
                                            VolPathConfig)
    from gvpm_tpu_torch.integrators import gvpm, sppm, volpath
    from gvpm_tpu_torch.utils import image as imglib
    ci_kw = dict(surface_photons=1 << 15, volume_photons=1 << 15,
                 max_depth=12, grid_hash_size=1 << 15)
    for name in GOLD_SCENES:
        for sub in (".", "ci"):
            gdir, meta = _gold_meta(sub)
            size = meta["size"]
            bars = meta["scenes"][name]["thresholds"]
            ref = imglib.read_pfm(os.path.join(gdir, f"{name}_ref.pfm"))
            seen = {}
            for tech, bar in bars.items():
                integ, _, vol = tech.partition(":")
                passes = 30 if vol == "plane0d" else 10
                t0 = time.perf_counter()
                scene = scenes.get(name, width=size, height=size)
                if integ == "sppm":
                    out = sppm.render(scene, PhotonConfig(
                        **(BEAM_GOLD_KW if size >= 128 else ci_kw)),
                        volume=vol, seed=5, passes=passes)
                else:
                    out = gvpm.render(scene, GradientConfig(
                        **(GVPM_GOLD_KW if size >= 128 else dict(
                            ci_kw, use_manifold=False))),
                        volume=vol, seed=5, passes=passes)
                img = out["image"].cpu().numpy()
                if not np.isfinite(img).all():
                    raise AssertionError(f"{name} {tech} {size}: non-finite")
                r = imglib.relmse(img, ref)
                seen[tech] = r
                phase("scenes", f"{name} {tech} {size}^2 {passes} passes: "
                                f"relMSE {r:.5f} (bar {bar}) in "
                                f"{time.perf_counter() - t0:.2f} s")
                if not r <= bar:
                    raise AssertionError(f"{name} {tech} {size}: relMSE "
                                         f"{r} > {bar}")
            if sub == "ci" and name == "caustic-glass":
                t0 = time.perf_counter()
                out = gvpm.render(scenes.get(name, width=size, height=size),
                                  GradientConfig(**dict(
                                      ci_kw, use_manifold=True)),
                                  volume="distance", seed=5,
                                  passes=SCENE_ME_PASSES)
                img = out["image"].cpu().numpy()
                if not np.isfinite(img).all():
                    raise AssertionError(f"{name} ME on {size}: non-finite")
                phase("scenes", f"{name} gvpm:distance {size}^2 "
                                f"{SCENE_ME_PASSES} passes, "
                                f"ME on: relMSE {imglib.relmse(img, ref):.5f}"
                                f" (ME off {seen['gvpm:distance']:.5f}; no "
                                f"bar) in {time.perf_counter() - t0:.2f} s")
            if sub == "ci":
                agree = meta["scenes"][name]["agree_relmse"]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                img = volpath.render(scenes.get(name, width=size,
                                                height=size),
                                     VolPathConfig(spp=meta["gen_spp"],
                                                   max_depth=12), seed=101)
                torch.cuda.synchronize()
                img = img.cpu().numpy()
                r = imglib.relmse(img, ref)
                phase("scenes", f"{name} volpath {size}^2 "
                                f"{meta['gen_spp']} spp, max_depth 12, seed "
                                f"101: relMSE against the golden {r:.3g} "
                                f"(agree_relmse {agree}) in "
                                f"{time.perf_counter() - t0:.2f} s")
                if not (np.isfinite(img).all() and r < agree):
                    raise AssertionError(f"{name} volpath {size}: relMSE "
                                         f"{r} >= {agree}")
            else:
                t0 = time.perf_counter()
                out = gvpm.render(scenes.get(name, width=size, height=size),
                                  GradientConfig(**dict(
                                      ci_kw, use_manifold=False)),
                                  volume="distance", seed=7, passes=10)
                gx = out["gx"].cpu().numpy()
                fdx = ref[:, 1:] - ref[:, :-1]
                corr = float(np.corrcoef(gx[:, :-1].ravel(),
                                         fdx.ravel())[0, 1])
                phase("scenes", f"{name} gvpm gx~FD(golden) {size}^2: "
                                f"correlation {corr:.3f} (> 0.5) in "
                                f"{time.perf_counter() - t0:.2f} s")
                if not corr > 0.5:
                    raise AssertionError(f"{name}: gx correlation {corr}")


def feature_renders(smi):
    """[het] and [lights]: one SPPM pass (the 128^2 check config,
    `distance`) and one volpath render (FEATURE_SPP spp, max_depth 12) at
    128^2 on the heterogeneous box (a 32^3 density from seed 5), on the
    box lit by point + spot + directional lights and a constant
    environment, and on the box lit by an environment map: finite images
    with a positive mean, timed; gvpm.render on the heterogeneous box
    must raise the JAX package's ValueError."""
    from gvpm_tpu_torch import scenes
    from gvpm_tpu_torch.core.config import (GradientConfig, PhotonConfig,
                                            VolPathConfig)
    from gvpm_tpu_torch.integrators import gvpm, sppm, volpath
    cfg = PhotonConfig(**BEAM_GOLD_KW)
    for label, kind in (("het", "het"), ("lights", "lights"),
                        ("lights", "envmap")):
        scene = scenes.feature_scene(kind, 128, 128, seed=5)
        for what in ("sppm", "volpath"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if what == "sppm":
                img = sppm.render_pass(
                    scene, cfg, "distance", cfg.volume_photons, 5, 0, 1.0,
                    1.0, sppm.base_volume_radius(scene, cfg))
            else:
                img = volpath.render(scene, VolPathConfig(
                    spp=FEATURE_SPP, max_depth=12), seed=101)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            if not (img.shape == (128, 128, 3)
                    and bool(torch.isfinite(img).all())
                    and float(img.mean()) > 0):
                raise AssertionError(f"{kind} {what}: image not finite or "
                                     "dark")
            extra = (f"{cfg.volume_photons} paths" if what == "sppm" else
                     f"{FEATURE_SPP} spp, max_depth 12")
            phase(label, f"{kind} box 128^2 {what} ({extra}): "
                         f"{secs:.3f} s, image mean "
                         f"{float(img.mean()):.5g}, finite ({smi})")
        if kind == "het":
            try:
                gvpm.render(scene, GradientConfig(**GVPM_GOLD_KW),
                            volume="distance", seed=5, passes=1)
            except ValueError as e:
                phase(label, f"gvpm.render on the het box raises "
                             f"ValueError: {str(e)[:60]}...")
            else:
                raise AssertionError("gvpm.render accepted a "
                                     "heterogeneous medium")


# spp of each G-PT render in [paths]; depth, not width, is what the
# script's time limit cuts
GPT_SPP = 8
PATHS_SIZE = 64             # film of the primal integrators in [paths]
PATHS_REF_SPP = 256         # spp of their volpath reference
# each primal integrator of [paths]: (render call, ratio bar of its mean
# against volpath, or None: finite with a positive mean). The configs
# and bars are the JAX package's cross-checks:
# tests/test_more_integrators.py:47-114 (photon mapper, PPM, VPL, the
# Metropolis family) and tests/test_lighttrace.py:21 (light tracer)
PM_KW = dict(max_depth=5, null_bounces=2, max_cam_depth=5,
             surface_photons=1 << 16, volume_photons=1 << 16,
             grid_hash_size=1 << 16, grid_max_photons_per_cell=64)
MLT_KW = dict(spp=1, max_depth=5, null_bounces=2)
# the JAX tests' 2048 chains x 48 mutations (erpt 24) as 8192 x 12 (erpt
# 6): a mutation costs ~17k launches of f(u) whatever the chain count
MLT_CHAINS = dict(n_chains=8192, n_mutations=12)


def path_integrators(smi, gvpm_relmse):
    """[paths]: G-PT with both shifts on box-medium at 128^2 (GPT_SPP spp
    each, seed 5): pass seconds, one profiled pass (device launches,
    busy share, top kernels), gx / gy against the 128^2 golden's finite
    differences (correlation above 0.5) and the L1 reconstruction's
    relMSE against the golden beside gvpm:distance's (the path-space
    shift's gradients leave out the light seen straight from the camera,
    its -direct buffer, so they are held on the pixel pairs where neither
    pixel sees any); then the primal
    integrators on box-surface at 64^2, each mean against a 256-spp
    volpath render under the JAX package's ratio bars, `path` equal to
    volpath.render at its config and seed."""
    from gvpm_tpu_torch import scenes
    from gvpm_tpu_torch.core.config import PhotonConfig, VolPathConfig
    from gvpm_tpu_torch.integrators import (erpt, gpt, gpt_shift,
                                            lighttrace, mlt, photonmapper,
                                            pssmlt, simple, volpath, vpl)
    from gvpm_tpu_torch.utils import image as imglib
    ref = imglib.read_pfm(os.path.join(ROOT, "goldens",
                                       "box-medium_ref.pfm"))
    scene = scenes.box_medium(128, 128)
    cfg = VolPathConfig(spp=GPT_SPP, max_depth=12)
    for label, mod in (("pss", gpt), ("path-space", gpt_shift)):
        marks = []

        def on_pass(it, _img):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = mod.render(scene, cfg, seed=5, callback=on_pass)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        pass_s = [b - a for a, b in zip([t0] + marks[:-1], marks)]
        ops = []
        n_launch, busy, _, _, wall = profile_pass(
            lambda: mod.render_pass(scene, cfg, 5, GPT_SPP), name=None,
            ops=ops)
        gx, gy, img = (out[k].cpu().numpy() for k in ("gx", "gy", "image"))
        if not (np.isfinite(gx).all() and np.isfinite(gy).all()
                and np.isfinite(img).all()):
            raise AssertionError(f"gpt {label}: non-finite buffers")
        # the path-space shift keeps light seen straight from the camera
        # out of its gradients (the -direct buffer): hold it on the pixel
        # pairs where neither pixel sees such light
        lit = out["direct"].amax(-1).cpu().numpy() > 0 \
            if "direct" in out else np.zeros(gx.shape[:2], bool)
        mx = ~(lit[:, 1:] | lit[:, :-1])
        my = ~(lit[1:, :] | lit[:-1, :])
        cx = float(np.corrcoef(gx[:, :-1][mx].ravel(),
                               (ref[:, 1:] - ref[:, :-1])[mx].ravel())[0, 1])
        cy = float(np.corrcoef(gy[:-1, :][my].ravel(),
                               (ref[1:, :] - ref[:-1, :])[my].ravel())[0, 1])
        phase("paths", f"gpt {label} shift, box-medium 128^2, {GPT_SPP} spp,"
                       f" max_depth 12, seed 5: {total:.3f} s (pass s "
                       f"mean {np.mean(pass_s):.4f}, min {min(pass_s):.4f},"
                       f" max {max(pass_s):.4f}); gx~FD(golden) "
                       f"{cx:.3f}, gy~FD(golden) {cy:.3f} (> 0.5; over "
                       f"{int(mx.sum())} / {mx.size} x-pairs not lit "
                       f"directly); L1 "
                       f"reconstruction relMSE {imglib.relmse(img, ref):.5f}"
                       f" (no bar; gvpm:distance 10 passes "
                       f"{gvpm_relmse:.5f}) ({smi})")
        phase("paths", f"gpt {label} one profiled pass ({wall:.4f} s): "
                       f"{n_launch} device kernel launches, device busy "
                       f"{busy:.1%}; top kernels (name, share of device "
                       f"kernel time, launches): {json.dumps(ops)}")
        if not (cx > 0.5 and cy > 0.5):
            raise AssertionError(f"gpt {label}: gradient correlation "
                                 f"{cx}, {cy} not above 0.5")

    n = PATHS_SIZE
    scene = scenes.box_surface(n, n)
    vcfg = VolPathConfig(spp=PATHS_REF_SPP, max_depth=5, null_bounces=2)
    t0 = time.perf_counter()
    want = float(volpath.render(scene, vcfg, seed=1).mean())
    phase("paths", f"box-surface {n}^2 volpath reference ({PATHS_REF_SPP} "
                   f"spp, max_depth 5): mean {want:.5g} in "
                   f"{time.perf_counter() - t0:.2f} s")
    pcfg = PhotonConfig(**PM_KW)
    mcfg = VolPathConfig(**MLT_KW)
    path_cfg = VolPathConfig(spp=16, max_depth=5, null_bounces=2)
    runs = (
        ("direct", None, lambda: simple.render_direct(scene, spp=16)),
        ("ao", None, lambda: simple.render_ao(scene, spp=16)),
        ("path", None, lambda: simple.render_path(scene, path_cfg, seed=2)),
        ("ptracer", (0.8, 1.2), lambda: lighttrace.render(
            scene, PhotonConfig(max_depth=5, null_bounces=3,
                                surface_photons=1 << 16,
                                volume_photons=1 << 16), seed=22,
            passes=4)),
        ("photonmapper", (0.7, 1.35), lambda: photonmapper.render(
            scene, pcfg, seed=0, passes=4)["image"]),
        ("ppm", (0.7, 1.35), lambda: photonmapper.render_ppm(
            scene, pcfg, seed=0, passes=4)["image"]),
        ("vpl", (0.6, 1.2), lambda: vpl.render(
            scene, PhotonConfig(max_depth=4, null_bounces=2,
                                max_cam_depth=4), seed=0, passes=3,
            vpls_per_pass=64, clamp_dist=0.05)["image"]),
        ("pssmlt", (0.7, 1.35), lambda: pssmlt.render(
            scene, mcfg, seed=0, **MLT_CHAINS)),
        ("mlt", (0.7, 1.35), lambda: mlt.render(
            scene, mcfg, seed=0, **MLT_CHAINS)),
        ("erpt", (0.7, 1.35), lambda: erpt.render(
            scene, mcfg, seed=0, n_chains=MLT_CHAINS["n_chains"],
            n_mutations=MLT_CHAINS["n_mutations"] // 2)))
    for name, bar, run in runs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        m = float(img.mean())
        if not (img.shape == (n, n, 3) and bool(torch.isfinite(img).all())
                and m > 0):
            raise AssertionError(f"{name}: image not finite or dark")
        if name == "path":
            same = torch.equal(img, volpath.render(scene, path_cfg, seed=2))
            extra = f"equal to volpath.render at its config and seed: {same}"
            if not same:
                raise AssertionError("path differs from volpath.render")
        elif bar is None:
            extra = "finite, mean above 0"
        else:
            ratio = m / want
            extra = f"mean / volpath {ratio:.4f} (bar {bar[0]}-{bar[1]})"
            if not bar[0] < ratio < bar[1]:
                raise AssertionError(f"{name}: ratio {ratio} outside {bar}")
        phase("paths", f"{name} box-surface {n}^2: {secs:.3f} s, mean "
                       f"{m:.5g}, {extra} ({smi})")
    return want


BIDIR_SIZE = 128            # film of the box-medium BDPT / G-BDPT runs
BIDIR_SPP = 4               # their spp (max_depth 12, the golden's)
BIDIR_SURFACE_SPP = 8       # BDPT's spp on box-surface at PATHS_SIZE
# tests/test_gbdpt.py:35-53: the reconnection shift against the PSS shift
AB_SIZE, AB_PASSES = 12, 8
AB_CFG = dict(spp=1, max_depth=4, null_bounces=2)
# the JAX package's own reconnect / PSS per-sample gx variance ratio at
# that config, 1.5329, and its gx / gy correlations with its primal's
# differences at test_gbdpt_gradients_match_fd's, 0.036 / -0.061 over
# every pair (tests/torch_gbdpt_reference.py on the CPU): the JAX
# package fails both of its slow bars (< 0.9, > 0.35; ROADMAP queue 3).
# The port is held to the JAX package's ratio, and to the correlation
# bar on the pixel pairs that see no light straight from the camera
GBDPT_REF_AB_RATIO = 1.5329


def test_box(builder, w, h):
    """The surface-only box of tests/test_more_integrators.py::_box (the
    JAX package's G-BDPT tests' scene), on any builder with the JAX
    builder's methods."""
    b = builder
    white = b.diffuse([0.7] * 3)
    red = b.diffuse([0.7, 0.2, 0.2])
    light = b.area_light([20.0] * 3)
    b.rectangle([0, 0, 0], [0, 0, 1], [1, 0, 0], white)
    b.rectangle([0, 1, 0], [1, 0, 0], [0, 0, 1], white)
    b.rectangle([0, 0, 1], [0, 1, 0], [1, 0, 0], white)
    b.rectangle([0, 0, 0], [0, 1, 0], [0, 0, 1], red)
    b.rectangle([1, 0, 0], [0, 0, 1], [0, 1, 0], red)
    b.rectangle([0.35, 0.998, 0.35], [0.3, 0, 0], [0, 0, 0.3], white,
                emitter=light)
    b.camera(origin=[0.5, 0.5, -1.2], target=[0.5, 0.5, 0.5], fov=45)
    return b.build(width=w, height=h)


def _corr(a, b):
    return float(np.corrcoef(a.ravel(), b.ravel())[0, 1])


def bidir(smi, surface_ref):
    """[bidir]: BDPT and G-BDPT (no hand kernel on these paths): seconds
    a pass, one profiled pass each (device launches, busy share), and the
    JAX package's cross-check bars: BDPT's mean against volpath's
    (box-surface 64^2, the [paths] reference) and against the 128^2
    golden's, in 0.7-1.35 (tests/test_more_integrators.py:73-81); G-BDPT's
    gx / gy against the finite differences of its own primal above 0.35
    (tests/test_gbdpt.py:15-32); the reconnection shift's per-sample gx
    variance below 0.9x the PSS shift's (tests/test_gbdpt.py:35-53)."""
    from gvpm_tpu_torch import scenes
    from gvpm_tpu_torch.core.config import VolPathConfig
    from gvpm_tpu_torch.integrators import bdpt, gbdpt
    from gvpm_tpu_torch.ops import poisson
    from gvpm_tpu_torch.scene import SceneBuilder
    from gvpm_tpu_torch.utils import image as imglib

    def timed_passes(run, n):
        img, secs = 0.0, []
        for it in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img = img + run(it)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        return img / n, secs

    def profiled(run):
        n_launch, busy, _, _, wall = profile_pass(run, name=None)
        return (f"one profiled pass {wall:.3f} s, {n_launch} device kernel "
                f"launches, device busy {busy:.1%}")

    def fmt(secs):
        return (f"{sum(secs):.3f} s (pass s mean {np.mean(secs):.4f}, min "
                f"{min(secs):.4f}, max {max(secs):.4f})")

    gref = imglib.read_pfm(os.path.join(ROOT, "goldens",
                                        "box-medium_ref.pfm"))
    runs = (
        ("box-surface", PATHS_SIZE, BIDIR_SURFACE_SPP,
         VolPathConfig(max_depth=5, null_bounces=2), surface_ref, None),
        ("box-medium", BIDIR_SIZE, BIDIR_SPP, VolPathConfig(max_depth=12),
         float(gref.mean()), gref))
    for name, n, spp, cfg, want, ref in runs:
        scene = scenes.get(name, width=n, height=n)
        img, secs = timed_passes(
            lambda it: bdpt.render_pass(scene, cfg, 0, it), spp)
        m = float(img.mean())
        if not (bool(torch.isfinite(img).all()) and m > 0):
            raise AssertionError(f"bdpt {name}: image not finite or dark")
        ratio = m / want
        extra = "" if ref is None else (
            f", relMSE against the golden "
            f"{imglib.relmse(img.cpu().numpy(), ref):.5f} (no bar)")
        # one profiled pass, on box-surface: the profiler takes ~0.2 ms
        # to process a launch, 30 s for a 128^2 pass's
        prof = "" if ref is not None else profiled(
            lambda: bdpt.render_pass(scene, cfg, 0, spp)) + "; "
        phase("bidir", f"bdpt {name} {n}^2, {spp} spp, max_depth "
                       f"{cfg.max_depth}, null_bounces {cfg.null_bounces}: "
                       f"{fmt(secs)}; {prof}"
                       f"mean / reference {ratio:.4f} (bar 0.7-1.35; "
                       f"{'volpath 256 spp' if ref is None else 'golden'})"
                       f"{extra} ({smi})")
        if not 0.7 < ratio < 1.35:
            raise AssertionError(f"bdpt {name}: ratio {ratio}")

    def gbdpt_run(scene, cfg, seed, recon_iters=50):
        """gbdpt.render's passes one by one (timed, each pass's
        very-direct light kept), then its L1 solve: numpy primal, gx, gy,
        image, the pixels that saw light straight from the camera, the
        pass seconds and the last pass's stats."""
        acc, secs, lit = 0.0, [], 0.0
        for it in range(cfg.spp):
            st = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bufs = torch.stack(gbdpt.render_pass(scene, cfg, seed, it,
                                                 stats=st))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            acc, lit = acc + bufs, lit + st["very_direct"]
        primal, gx, gy = acc / cfg.spp
        img = poisson.solve(primal, gx, gy, iters=recon_iters)
        out = [a.cpu().numpy() for a in (primal, gx, gy, img)]
        if not (all(np.isfinite(a).all() for a in out)
                and out[0].mean() > 0):
            raise AssertionError("gbdpt: buffers not finite or dark")
        return (*out, lit.amax(-1).cpu().numpy() > 0, secs, st)

    def held_corr(gx, gy, lit, ref):
        """Correlations of gx / gy with the finite differences of `ref`
        over the pixel pairs that see no light straight from the camera
        (G-BDPT's gradients leave that light out, as gpt_shift's -direct
        buffer does), then over every pair."""
        mx, my = ~(lit[:, 1:] | lit[:, :-1]), ~(lit[1:, :] | lit[:-1, :])
        fx, fy = ref[:, 1:] - ref[:, :-1], ref[1:, :] - ref[:-1, :]
        return (_corr(gx[:, :-1][mx], fx[mx]), _corr(gy[:-1, :][my], fy[my]),
                _corr(gx[:, :-1], fx), _corr(gy[:-1, :], fy),
                f"{int(mx.sum())} / {mx.size}")

    # G-BDPT at the JAX test's config (tests/test_gbdpt.py:15-32: the
    # surface box at 12^2, 6 spp, max_depth 4, seed 2, 30 solver steps)
    t0 = time.perf_counter()
    primal, gx, gy, _, lit, _, _ = gbdpt_run(
        test_box(SceneBuilder(), AB_SIZE, AB_SIZE),
        VolPathConfig(spp=6, max_depth=4, null_bounces=2), 2, 30)
    cx, cy, ax, ay, pairs = held_corr(gx, gy, lit, primal)
    phase("bidir", f"gbdpt tests/test_gbdpt.py's box {AB_SIZE}^2, 6 spp, "
                   f"max_depth 4, seed 2, in "
                   f"{time.perf_counter() - t0:.2f} s: over the {pairs} "
                   f"x-pairs not lit directly gx~FD(primal) {cx:.3f}, "
                   f"gy~FD(primal) {cy:.3f} (> 0.35); over every pair "
                   f"{ax:.3f} / {ay:.3f} (the JAX test's bar, > 0.35, which "
                   f"the JAX package misses too: 0.036 / -0.061)")
    failed = [] if cx > 0.35 and cy > 0.35 else [("test box", cx, cy)]

    scene = test_box(SceneBuilder(), AB_SIZE, AB_SIZE)
    cfg = VolPathConfig(**AB_CFG)
    var, spent = {}, {}
    for shift in ("reconnect", "pss"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gs = [gbdpt.render_pass(scene, cfg, 5, it, shift=shift)[1]
              for it in range(AB_PASSES)]
        var[shift] = float(torch.stack(gs).var(0, correction=0).mean())
        spent[shift] = time.perf_counter() - t0
    ratio = var["reconnect"] / var["pss"]
    phase("bidir", f"gbdpt shift A/B, tests/test_gbdpt.py's box "
                   f"{AB_SIZE}^2, max_depth 4, null_bounces 2, "
                   f"{AB_PASSES} passes each: per-sample gx variance "
                   f"reconnect {var['reconnect']:.6g} vs pss "
                   f"{var['pss']:.6g}, ratio {ratio:.4f} (held within 1% "
                   f"of the JAX package's {GBDPT_REF_AB_RATIO}; the JAX "
                   f"test's bar < 0.9 fails there too) in "
                   f"{spent['reconnect']:.2f} / {spent['pss']:.2f} s")
    if not abs(ratio / GBDPT_REF_AB_RATIO - 1.0) < 0.01:
        failed.append(("shift A/B variance ratio", ratio))

    # G-BDPT on box-medium at 128^2, the golden's max_depth
    scene = scenes.box_medium(BIDIR_SIZE, BIDIR_SIZE)
    cfg = VolPathConfig(spp=BIDIR_SPP, max_depth=12)
    primal, gx, gy, img, lit, secs, st = gbdpt_run(scene, cfg, 5)
    prof = profiled(lambda: gbdpt.render_pass(scene, cfg, 5, BIDIR_SPP))
    cx, cy, ax, ay, pairs = held_corr(gx, gy, lit, primal)
    gcx, gcy, gax, gay, _ = held_corr(gx, gy, lit, gref)
    phase("bidir", f"gbdpt box-medium {BIDIR_SIZE}^2, {BIDIR_SPP} spp, "
                   f"max_depth 12, seed 5: {fmt(secs)}; {prof}; "
                   f"reconnecting lanes in its last pass "
                   f"{st['rc_ok'].tolist()} of {BIDIR_SIZE * BIDIR_SIZE}; "
                   f"over the {pairs} x-pairs not lit directly "
                   f"gx~FD(primal) {cx:.3f}, gy~FD(primal) {cy:.3f} (> "
                   f"0.35), against the golden's FD {gcx:.3f} / {gcy:.3f} "
                   f"(no bar); over every pair {ax:.3f} / {ay:.3f} "
                   f"(golden's {gax:.3f} / {gay:.3f}); L1 reconstruction "
                   f"relMSE {imglib.relmse(img, gref):.5f}, primal "
                   f"{imglib.relmse(primal, gref):.5f} (no bar) ({smi})")
    if not (cx > 0.35 and cy > 0.35):
        failed.append(("box-medium", cx, cy))
    if failed:
        raise AssertionError(f"gbdpt: bars failed {failed}")


# tests/test_mitsuba_loader.py's scene (this script imports nothing of
# the tests, which import the JAX package)
CLI_XML = """<?xml version="1.0"?>
<scene version="0.5.0">
    <default name="photons" value="10000"/>
    <integrator type="gvpm">
        <integer name="maxDepth" value="8"/>
        <integer name="volumePhotonCount" value="$photons"/>
        <float name="alpha" value="0.7"/>
        <string name="volTechnique" value="distance"/>
    </integrator>
    <sensor type="perspective">
        <float name="fov" value="45"/>
        <transform name="toWorld">
            <lookat origin="0.5, 0.5, -1.2" target="0.5, 0.5, 0.5"
                    up="0, 1, 0"/>
        </transform>
        <film type="hdrfilm">
            <integer name="width" value="64"/>
            <integer name="height" value="48"/>
        </film>
    </sensor>
    <bsdf type="diffuse" id="white">
        <rgb name="reflectance" value="0.7, 0.7, 0.7"/>
    </bsdf>
    <medium type="homogeneous" id="fog">
        <spectrum name="sigmaS" value="0.4"/>
        <spectrum name="sigmaA" value="0.05"/>
        <phase type="hg"><float name="g" value="0.3"/></phase>
    </medium>
    <shape type="rectangle">
        <transform name="toWorld">
            <scale value="0.5"/>
            <rotate x="1" angle="90"/>
            <translate x="0.5" y="0.0" z="0.5"/>
        </transform>
        <ref id="white"/>
    </shape>
    <shape type="sphere">
        <point name="center" value="0.5, 0.3, 0.5"/>
        <float name="radius" value="0.15"/>
        <bsdf type="conductor"/>
    </shape>
    <shape type="cube">
        <transform name="toWorld">
            <scale value="0.48"/>
            <translate x="0.5" y="0.5" z="0.5"/>
        </transform>
        <bsdf type="null"/>
        <ref name="interior" id="fog"/>
    </shape>
    <shape type="rectangle">
        <transform name="toWorld">
            <scale value="0.15"/>
            <rotate x="1" angle="90"/>
            <translate x="0.5" y="0.99" z="0.5"/>
        </transform>
        <emitter type="area">
            <spectrum name="radiance" value="15"/>
        </emitter>
    </shape>
</scene>
"""
CLI_OUTPUTS = (".pfm", ".exr", ".png", "_time.csv", "_meta.json")
CLI_SIZE = ["--width", "64", "--height", "64"]


def _device_kernels(run):
    """Run `run` under torch.profiler's device trace: (its result, the
    names of the device kernels it launched)."""
    act = torch.profiler.ProfilerActivity
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[act.CUDA]) as prof:
        res = run()
        torch.cuda.synchronize()
    return res, {e[0] for e in device_events(prof)}


def cli_phase(smi):
    """[cli]: the command-line renderer in-process on the card (gvpm
    distance with the default ME, sppm beam1d, gbdpt, an XML scene under
    volpath; the gvpm and sppm runs under the profiler's device trace,
    which must show the fused-gather kernel's ME instantiations and
    gsweep.cu's Beam1D sweep), one `python -m gvpm_tpu_torch.cli`
    subprocess, and the port's goldens.py check of goldens/ci's
    box-medium bars."""
    import tempfile
    from gvpm_tpu_torch import cli
    from gvpm_tpu_torch.ops import beam_sweep as bs
    from gvpm_tpu_torch.ops import fused_gather as fg
    from gvpm_tpu_torch.tools import goldens
    from gvpm_tpu_torch.utils import image as imglib

    def outputs_ok(dest, label):
        missing = [e for e in CLI_OUTPUTS if not os.path.exists(dest + e)]
        img = imglib.read_pfm(dest + ".pfm")
        if missing or not (np.isfinite(img).all() and img.mean() > 0):
            raise AssertionError(f"cli {label}: outputs {missing} missing "
                                 f"or image not finite / dark")
        return img

    with tempfile.TemporaryDirectory() as d:
        xml = os.path.join(d, "scene.xml")
        with open(xml, "w") as f:
            f.write(CLI_XML)
        runs = (
            ("gvpm", ["box-medium", "-i", "gvpm", "--volume", "distance",
                      "--passes", "2", *CLI_SIZE]),
            ("sppm", ["box-medium", "-i", "sppm", "--volume", "beam1d",
                      "--passes", "2", *CLI_SIZE]),
            ("gbdpt", ["box-medium", "-i", "gbdpt", "--spp", "2",
                       *CLI_SIZE]),
            ("xml", [xml, "-i", "volpath", "-D", "photons=5000"]))
        for label, argv in runs:
            dest = os.path.join(d, label)
            for k in fg.LAUNCHES:
                fg.LAUNCHES[k] = 0
            for k in bs.LAUNCHES:
                bs.LAUNCHES[k] = 0
            t0 = time.perf_counter()
            if label in ("gvpm", "sppm"):
                rc, names = _device_kernels(
                    lambda: cli.main(argv + ["-o", dest]))
            else:
                rc, names = cli.main(argv + ["-o", dest]), set()
            secs = time.perf_counter() - t0
            if rc != 0:
                raise AssertionError(f"cli {label}: exit code {rc}")
            img = outputs_ok(dest, label)
            kern = sorted(n[:60] for n in names
                          if "fused_gather_kernel" in n
                          or "gsweep_kernel" in n)
            launched = {k: v for k, v in {**fg.LAUNCHES,
                                          **bs.LAUNCHES}.items() if v}
            phase("cli", f"{' '.join(argv[:7])}: exit 0 in {secs:.2f} s"
                         f"{' (profiled)' if names else ''}, five outputs, "
                         f"image {img.shape[1]}x{img.shape[0]} mean "
                         f"{img.mean():.5g}; wrapper launches {launched}; "
                         f"device kernels {kern} ({smi})")
            if label == "gvpm":
                want = {"VolumeEval", "SurfaceEval"}
                seen = {e for e in want for n in names
                        if "fused_gather_kernel" in n and e in n}
                if seen != want or not (fg.LAUNCHES["volume_me"]
                                        and fg.LAUNCHES["surface_me"]):
                    raise AssertionError(f"cli gvpm: fused gather K1-ME / "
                                         f"K2-ME not launched: {kern}, "
                                         f"{fg.LAUNCHES}")
            if label == "sppm":
                if not (any("gsweep_kernel<beam::Beam1D>" in n
                            for n in names) and bs.LAUNCHES["beam1d"]):
                    raise AssertionError(f"cli sppm: Beam1D sweep not "
                                         f"launched: {kern}")
        dest = os.path.join(d, "sub")
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "gvpm_tpu_torch.cli", "box-medium", "-i",
             "volpath", "--spp", "8", "--width", "32", "--height", "32",
             "-o", dest], cwd=ROOT, capture_output=True, text=True,
            env=dict(os.environ, PYTHONPATH=ROOT), timeout=300)
        if res.returncode != 0:
            raise AssertionError(f"cli subprocess: {res.stderr[-2000:]}")
        img = outputs_ok(dest, "subprocess")
        phase("cli", f"python -m gvpm_tpu_torch.cli box-medium -i volpath "
                     f"--spp 8 32^2: exit 0 in "
                     f"{time.perf_counter() - t0:.2f} s, mean "
                     f"{img.mean():.5g}")
    t0 = time.perf_counter()
    lines = io.StringIO()
    rc = goldens.check(os.path.join(ROOT, "goldens", "ci"),
                       scenes=("box-medium",), out=lines)
    table = [ln.strip() for ln in lines.getvalue().splitlines()
             if ln.strip()]
    phase("cli", f"gvpm_tpu_torch/tools/goldens.py check goldens/ci "
                 f"box-medium: exit {rc} in {time.perf_counter() - t0:.2f} "
                 f"s: " + " | ".join(table))
    if rc != 0:
        raise AssertionError("goldens.py check: a bar failed")


# [dist]: the comparison passes' config, the headline's with a segment
# budget that holds every camera segment slot (the shard-local compaction
# would drop other segments at another rank count,
# tests/test_parallel.py:120-123) and no row cap on the cell grids (the
# ring's cap would apply to a partition, the all-gather's to the map)
DIST_CMP_KW = dict(HEADLINE_KW,
                   vol_segments_per_pixel=HEADLINE_KW["max_cam_depth"],
                   grid_surface_rows=0, grid_volume_rows=0)
DIST_CMP_ME_KW = dict(DIST_CMP_KW, use_manifold=True, me_pair_budget=4096)
DIST_SIZE = 512             # the film's side in [dist] (the headline's)
DIST_PASSES = 2             # passes of each progressive [dist] render
DIST_TIMEOUT = 900          # seconds a [dist] launch may take


def _dist_run(mesh, label, run, passes=1, profile=False):
    """One [dist] run of `passes` passes on this rank: seconds, phase
    split, the wrapper's launches counted from 0, every rank's peak device
    memory and, with `profile`, the device kernels of the run's trace."""
    import torch.distributed as tdist
    from gvpm_tpu_torch.ops import fused_gather as fg
    for k in fg.LAUNCHES:
        fg.LAUNCHES[k] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timings = {}
    t0 = time.perf_counter()
    if profile:
        out, names = _device_kernels(lambda: run(timings))
    else:
        out, names = run(timings), set()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peaks = [None] * mesh.size
    tdist.all_gather_object(peaks, (str(mesh.device),
                                    torch.cuda.max_memory_allocated()))
    return dict(label=label, out=out, secs=secs, passes=passes,
                timings=timings, launches=dict(fg.LAUNCHES), peaks=peaks,
                kernels=sorted(n[:70] for n in names
                               if "fused_gather_kernel" in n))


def dist_one_rank(mesh):
    """[dist] on one nccl rank: the comparison passes (ME off, ME on)
    that the two-rank run repeats, then dist.gvpm_render (ME off, ME on)
    and dist.render (SPPM) at the headline, DIST_PASSES passes each."""
    from gvpm_tpu_torch import scenes
    from gvpm_tpu_torch.core.config import GradientConfig, PhotonConfig
    from gvpm_tpu_torch.parallel import dist
    scene = scenes.box_medium(DIST_SIZE, DIST_SIZE, device=mesh.device)
    runs = dist_compared(mesh, scene)
    for label, kw in (("gvpm_render ME off", HEADLINE_KW),
                      ("gvpm_render ME on", HEADLINE_ME_KW)):
        runs.append(_dist_run(mesh, label, lambda t, kw=kw: dist.gvpm_render(
            mesh, scene, GradientConfig(**kw), passes=DIST_PASSES,
            timings=t), DIST_PASSES))
    runs.append(_dist_run(mesh, "render (SPPM)", lambda t: dist.render(
        mesh, scene, PhotonConfig(**SPPM_KW), passes=DIST_PASSES,
        timings=t), DIST_PASSES))
    return runs


def dist_compared(mesh, scene):
    """The passes [dist] holds across rank counts: the all-gather gradient
    pass at DIST_CMP_KW with ME off (the first of a fresh rank: its time
    includes the process group's first collectives and the kernels' first
    loads) and ME on, and, at more than one rank, the ring pass with ME
    off; at more than one rank the ME pass runs under the device trace."""
    from gvpm_tpu_torch.core.config import GradientConfig
    from gvpm_tpu_torch.integrators import sppm
    from gvpm_tpu_torch.parallel import dist
    n_photons = DIST_CMP_KW["surface_photons"]
    r_vol = sppm.base_volume_radius(scene, GradientConfig(**DIST_CMP_KW))
    plan = [("ME off", dist.gvpm_render_pass_sharded, DIST_CMP_KW, False),
            ("ME on", dist.gvpm_render_pass_sharded, DIST_CMP_ME_KW,
             mesh.size > 1)]
    if mesh.size > 1:
        plan.append(("ring ME off", dist.gvpm_render_pass_sharded_ring,
                     DIST_CMP_KW, False))
    return [_dist_run(mesh, label, lambda t, fn=fn, kw=kw: fn(
        mesh, scene, GradientConfig(**kw), "distance", n_photons, 5, 0, 1.0,
        1.0, r_vol, timings=t), profile=prof)
        for label, fn, kw, prof in plan]


def dist_phase(smi):
    """[dist]: the multi-rank render (gvpm_tpu_torch/parallel/) on the
    card. One nccl rank: dist.gvpm_render with ME off and on and
    dist.render (SPPM) at the headline, DIST_PASSES passes each, finite.
    Two gloo ranks sharing the card (collectives through host memory):
    the gradient pass at DIST_CMP_KW against the one-rank pass, ME off
    (visits and shift_ok equal, images at rtol 1e-3 / atol 1e-6, the JAX
    package's cross-layout bar, tests/test_parallel.py:138) and ME on
    (visits equal, primal at that bar, gx / gy correlation above 0.99:
    the lowest ME-eligible row of a query depends on the table's order),
    and the ring pass against the all-gather pass (visits equal, images
    at rtol 2e-3 / atol 2e-5, tests/test_parallel.py:168). Where the
    machine has two cards or more, two nccl ranks, a card each, run the
    same passes against the one-rank run at the same bars. Each run's
    seconds, all-gather seconds, fused-gather launches (each of the
    path's variants at least once) and every rank's peak memory; the
    fused-gather kernels of rank 0's trace of the ME pass (its ME
    instantiations must appear). Then entry.dryrun_multichip(1) and
    `python -m gvpm_tpu_torch.cli box-medium -i sppm --mesh 1` at the
    CLI's defaults."""
    import tempfile
    from gvpm_tpu_torch import entry
    from gvpm_tpu_torch.parallel.launch import launch
    from gvpm_tpu_torch.utils import image as imglib

    def report(ranks, r):
        t, n = r["timings"], r["passes"]
        solve = t.get("solve", 0.0)
        phase("dist", f"{ranks}, {r['label']}: {r['secs']:.3f} s"
                      f"{' (profiled)' if r['kernels'] else ''}, a pass "
                      f"{(r['secs'] - solve) / n:.4f} s, of it all-gather "
                      f"{t.get('allgather', 0.0) / n:.4f} s, ring hops "
                      f"{t.get('ring', 0.0) / n:.4f} s, film "
                      f"{t.get('film', 0.0) / n:.4f} s; solve {solve:.3f} s; "
                      f"fused_gather launches "
                      f"{ {k: v for k, v in r['launches'].items() if v} }; "
                      f"peak memory GiB a rank "
                      f"{[(d, round(b / 2 ** 30, 3)) for d, b in r['peaks']]} "
                      f"({smi})")
        need = (("surface_me", "volume_me") if r["label"].endswith("ME on")
                else ("surface", "volume") if r["label"].endswith("ME off")
                else ())
        if not all(r["launches"][k] for k in need):
            raise AssertionError(f"[dist] {ranks} {r['label']}: fused gather "
                                 f"{need} not launched: {r['launches']}")

    def finite(r, keys):
        for k in keys:
            a = r["out"][k]
            if a.shape != (DIST_SIZE, DIST_SIZE, 3) or not bool(
                    torch.isfinite(a).all()):
                raise AssertionError(f"[dist] {r['label']}: {k} "
                                     f"{tuple(a.shape)} not finite")

    t0 = time.perf_counter()
    one = launch(1, dist_one_rank, backend="nccl", timeout=DIST_TIMEOUT)
    phase("dist", f"one nccl rank: launch and runs in "
                  f"{time.perf_counter() - t0:.1f} s")
    for r in one:
        report("1 nccl rank", r)
    for r in one[2:4]:
        finite(r, ("image", "primal", "gx", "gy"))
        phase("dist", f"1 nccl rank, {r['label']}: finite, primal mean "
                      f"{float(r['out']['primal'].mean()):.5g}, recon mean "
                      f"{float(r['out']['image'].mean()):.5g}")
    finite(one[4], ("image",))
    phase("dist", f"1 nccl rank, {one[4]['label']}: finite, mean "
                  f"{float(one[4]['out']['image'].mean()):.5g}")
    one_cmp = {r["label"]: r for r in one[:2]}

    def hold(ranks, two):
        """The two-rank runs against the one-rank run, at the bars above."""
        for r in two:
            report(ranks, r)
        two_cmp = {r["label"]: r for r in two}
        for label, against, ref in (
                ("ME off", "1 nccl rank", one_cmp["ME off"]),
                ("ME on", "1 nccl rank", one_cmp["ME on"]),
                ("ring ME off", "the 2-rank all-gather pass",
                 two_cmp["ME off"])):
            r = two_cmp[label]
            a, b = r["out"], ref["out"]
            st = {k: int(v) for k, v in a[3].items()}
            stb = {k: int(v) for k, v in b[3].items()}
            err = [float((x - y).abs().max()) for x, y in zip(a[:3], b[:3])]
            corr = [_corr(x.numpy(), y.numpy())
                    for x, y in zip(a[1:3], b[1:3])]
            phase("dist", f"{ranks} {label} against {against}: visits "
                          f"{st['visits']} / {stb['visits']}, shift_ok "
                          f"{st['shift_ok']} / {stb['shift_ok']}, "
                          f"win_dropped {st['win_dropped']} / "
                          f"{stb['win_dropped']}, ME pairs "
                          f"{st['me_pairs']} / {stb['me_pairs']}, "
                          f"me_dropped {st['me_dropped']} / "
                          f"{stb['me_dropped']}; max|diff| primal / gx / gy "
                          f"{err}, gx / gy correlation {corr}"
                          + (f"; rank 0's device trace {r['kernels']}"
                             if r["kernels"] else ""))
            if not all(bool(torch.isfinite(x).all()) for x in a[:3]):
                raise AssertionError(f"[dist] {ranks} {label}: not finite")
            if st["visits"] != stb["visits"]:
                raise AssertionError(f"[dist] {ranks} {label}: visits "
                                     f"differ")
            tol = (dict(rtol=2e-3, atol=2e-5) if label.startswith("ring")
                   else dict(rtol=1e-3, atol=1e-6))
            for x, y in zip(a[:1] if label == "ME on" else a[:3], b):
                torch.testing.assert_close(x, y, **tol)
            if label != "ME on":
                if st["shift_ok"] != stb["shift_ok"]:
                    raise AssertionError(f"[dist] {ranks} {label}: shift_ok "
                                         f"differs")
                continue
            if min(corr) <= 0.99:
                raise AssertionError(f"[dist] {ranks} ME on: gx / gy "
                                     f"correlation {corr}")
            for ev in ("VolumeEval, true", "SurfaceEval, true"):
                if not any(ev in k for k in r["kernels"]):
                    raise AssertionError(
                        f"[dist] {ranks} ME on: fused_gather_kernel<{ev}> "
                        f"not in rank 0's device trace: {r['kernels']}")

    # two gloo ranks share the card; on a machine with two cards or more,
    # two nccl ranks also run, each on a card of its own
    pairs = [("gloo", "cuda:0", "two gloo ranks on one card")]
    if torch.cuda.device_count() >= 2:
        pairs.append(("nccl", None, "two nccl ranks on cards of their own"))
    for backend, device, what in pairs:
        t0 = time.perf_counter()
        two = launch(2, dist_compared_two, device=device, backend=backend,
                     timeout=DIST_TIMEOUT)
        phase("dist", f"{what}: launch and runs in "
                      f"{time.perf_counter() - t0:.1f} s")
        hold(f"2 {backend} ranks", two)
    t0 = time.perf_counter()
    dry = entry.dryrun_multichip(1)
    phase("dist", f"entry.dryrun_multichip(1) on the card: "
                  f"{time.perf_counter() - t0:.1f} s, primal mean "
                  f"{float(dry['primal'].mean()):.5g}, visits "
                  f"{int(dry['stats']['visits'])}")
    with tempfile.TemporaryDirectory() as d:
        dest = os.path.join(d, "mesh")
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "gvpm_tpu_torch.cli", "box-medium", "-i",
             "sppm", "--mesh", "1", "-o", dest], cwd=ROOT,
            capture_output=True, text=True,
            env=dict(os.environ, PYTHONPATH=ROOT), timeout=DIST_TIMEOUT)
        if res.returncode != 0:
            raise AssertionError(f"cli --mesh 1: {res.stderr[-2000:]}")
        img = imglib.read_pfm(dest + ".pfm")
        if not (np.isfinite(img).all() and img.mean() > 0):
            raise AssertionError("cli --mesh 1: image not finite / dark")
        phase("dist", f"python -m gvpm_tpu_torch.cli box-medium -i sppm "
                      f"--mesh 1 (256^2, 65536 paths, 16 passes): exit 0 in "
                      f"{time.perf_counter() - t0:.2f} s, image "
                      f"{img.shape[1]}x{img.shape[0]} mean {img.mean():.5g}")


def dist_compared_two(mesh):
    """[dist]'s two-rank job: dist_compared on box_medium."""
    from gvpm_tpu_torch import scenes
    return dist_compared(mesh, scenes.box_medium(DIST_SIZE, DIST_SIZE,
                                                 device=mesh.device))


def capture_sweeps(scene, cfg, passes_kw):
    """One SPPM pass of each beam estimator on `scene`; returns {kind:
    the (q, rows, params) of its first sweep call}."""
    from gvpm_tpu_torch.integrators import sppm
    from gvpm_tpu_torch.ops import beam_sweep as bs
    calls, orig = {}, bs.sweep

    def record(kind, *args):
        calls.setdefault(kind, args)
        return orig(kind, *args)

    bs.sweep = record
    try:
        for kind in bs.KINDS:
            sppm.render_pass(scene, cfg, kind, **passes_kw)
    finally:
        bs.sweep = orig
    return calls


def beams_against_plain(kind, q, rows, p):
    """The sweep kernel twice and its plain version once on the same
    inputs: accepted-pair counts exactly equal, sums within TOL, the two
    launches bitwise equal. Returns (plain sums, plain counts, plain
    stats, max abs error)."""
    from gvpm_tpu_torch.ops import beam_sweep as bs
    got, got_n = bs.sweep(kind, q, rows, p)
    again, again_n = bs.sweep(kind, q, rows, p)
    stats = {}
    want, want_n = bs.sweep_plain(kind, q, rows, p, stats=stats)
    torch.cuda.synchronize()
    if got_n.dtype != torch.int32 or not torch.equal(got_n, want_n):
        raise AssertionError(f"beam_sweep_{kind}: accepted-pair counts "
                             "differ from the plain version")
    torch.testing.assert_close(got, want, **TOL)
    if not (torch.equal(got.view(torch.int32), again.view(torch.int32))
            and torch.equal(got_n, again_n)):
        raise AssertionError(f"beam_sweep_{kind}: two launches on the same "
                             "inputs differ")
    return want, want_n, stats, float((got - want).abs().max())


def beams_stress_against_plain(kind, shift=0.0):
    """The primal stress input (beam_stress_inputs) of a queued sweep
    (beam1d, beam3d, plane0d), moved by `shift`, on the card: the kernel
    twice at its split plan and twice in one split (whose ring then lives across
    every beam tile) against the plain version once: accepted-pair
    counts exactly equal, sums within TOL, each pair of launches bitwise
    equal; the hot query must keep its 800 beams. Returns (plain sums,
    plain counts, plain stats, hot query, max abs error)."""
    from gvpm_tpu_torch.ops import beam_sweep as bs
    q, rows, p, hot = beam_stress_inputs(kind, device="cuda", shift=shift)
    stats = {}
    want, want_n = bs.sweep_plain(kind, q, rows, p, stats=stats)
    target, err = bs.GTARGET_BLOCKS, 0.0
    try:
        for bs.GTARGET_BLOCKS in (target, 1):
            got, got_n = bs.sweep(kind, q, rows, p)
            again, again_n = bs.sweep(kind, q, rows, p)
            torch.cuda.synchronize()
            if got_n.dtype != torch.int32 or not torch.equal(got_n, want_n):
                raise AssertionError(f"beam_sweep_{kind}: stress counts "
                                     "differ from the plain version")
            torch.testing.assert_close(got, want, **TOL)
            if not (torch.equal(got.view(torch.int32),
                                again.view(torch.int32))
                    and torch.equal(got_n, again_n)):
                raise AssertionError(f"beam_sweep_{kind}: two launches on "
                                     "the stress input differ")
            err = max(err, float((got - want).abs().max()))
    finally:
        bs.GTARGET_BLOCKS = target
    if not int(want_n[hot]) >= 800:
        raise AssertionError(f"beam_sweep_{kind}: the hot query has "
                             f"{int(want_n[hot])} accepted pairs")
    return want, want_n, stats, hot, err


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
    from gvpm_tpu_torch.core.config import GradientConfig, PhotonConfig
    from gvpm_tpu_torch.core.logging import StatsCounter
    from gvpm_tpu_torch.integrators import gradient_gather, gvpm, sppm
    from gvpm_tpu_torch.ops import fused_gather as fg
    from gvpm_tpu_torch.utils import image as imglib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi, flush=True)
    phase("device", f"torch {torch.__version__} cuda {torch.version.cuda}, "
                    f"{torch.cuda.device_count()} device(s)")

    from gvpm_tpu_torch.ops import beam_sweep as bs
    t0 = time.perf_counter()
    # one nvcc for each kernel source, started together
    errors = []

    def build(lib):
        try:
            lib.build()
        except Exception as e:              # noqa: BLE001 -- raised below
            errors.append(e)

    from gvpm_tpu_torch.ops import me_newton
    threads = [threading.Thread(target=build, args=(lib,))
               for lib in (fg, bs, me_newton)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    phase("build", f"fused_gather, beam_sweep (gsweep.cu) and me_newton "
                   f"kernels built in {time.perf_counter() - t0:.2f} s; "
                   f"ptxas per instantiation (registers a thread, bytes): "
                   f"{json.dumps(fg.build_report())}; beam_sweep "
                   f"{json.dumps(bs.build_report())}; me_newton "
                   f"{json.dumps(me_newton.build_report())}")

    # ---- 3. kernel vs plain on one headline ME pass's inputs ----
    scene = scenes.box_medium(512, 512)          # default device: the card
    cfg_me = GradientConfig(**HEADLINE_ME_KW)
    cfg = GradientConfig(**HEADLINE_KW)
    n_photons = max(cfg.surface_photons, cfg.volume_photons)
    r_vol_base = sppm.base_volume_radius(scene, cfg)
    captured = {}
    launch = fg.fused_gather

    def capture(ev, *args):
        captured.setdefault(ev.name, args)
        return launch(ev, *args)

    fg.fused_gather = capture
    try:
        me_calls = capture_me_shifts(lambda: gvpm.render_pass(
            scene, cfg_me, "distance", n_photons, 5, 0, 1.0, 1.0,
            r_vol_base))
    finally:
        fg.fused_gather = launch
    kernels = {}
    for name, ev in gradient_gather.EVALS.items():
        inputs = name if name.endswith("_me") else name + "_me"
        plan, tbl, qrows, r2, k3, md = args = captured[inputs]
        want, me_queries, err = gather_against_plain(name, ev, args)
        candidates = int((plan.r1 - plan.r0).sum())
        visits = int(want[:, 27].sum())
        bound_ms, bound_by, detail = kernel_bound(
            ev, fg.slots_read(ev, md), plan, tbl, qrows, candidates, visits)
        # with one warm-up run the first kernel timed read up to 10%
        # apart between calls (0.84 and 0.94 ms): warm up longer
        ms = cuda_ms(lambda: fg.fused_gather(ev, *args), 20, warm=20)
        # against_plain's call of the plain version was its warm-up
        plain_ms = cuda_ms(lambda: fg.fused_gather_plain(ev, *args), 1,
                           warm=0)
        head_ms = cuda_ms(lambda: fg.row_heads(ev, tbl), 10)
        kernels[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by)
        phase("kernels", f"{name}: {qrows.shape[0]} queries x "
                         f"{tbl.shape[0]} rows, candidates {candidates}, "
                         f"visits {visits} equal, ME queries {me_queries}"
                         f"{' (row keys equal)' if ev.me else ''}, max|err| "
                         f"{err:.3g} (rtol 2e-4 atol 5e-6), two launches "
                         f"bitwise equal, kernel {ms:.3f} ms (of which "
                         f"row heads {head_ms:.3f} ms), plain "
                         f"{plain_ms:.1f} ms, bound {bound_ms:.4f} ms by "
                         f"{bound_by} {json.dumps(detail)}")
        if not ev.me:
            phase("kernels", f"{name} lane use: "
                             f"{json.dumps(lane_use(ev, *args))}")
    del captured, args, plan, tbl, qrows, want
    me_kernels = me_newton_phase(me_calls)
    del me_calls

    # ---- 3b. the stress input ----
    for name, ev in gradient_gather.EVALS.items():
        r0, r1, *rest, hot = stress_inputs(ev, device="cuda")
        plan = fg.Plan(torch.arange(r0.shape[0], device="cuda"), r0, r1)
        want, me_queries, err = gather_against_plain(name, ev,
                                                     (plan, *rest))
        if not int(want[hot, 27]) > 256:
            raise AssertionError(f"{name}: the stress input's hot query "
                                 f"has {int(want[hot, 27])} visits")
        phase("stress", f"{name}: {r0.shape[0]} queries, candidates "
                        f"{int((r1 - r0).sum())}, visits "
                        f"{int(want[:, 27].sum())} equal ({int(want[hot, 27])}"
                        f" of them one query's), shift_ok "
                        f"{int(want[:, 28].sum())} equal, ME queries "
                        f"{me_queries}, max|err| {err:.3g}, two launches "
                        f"bitwise equal")

    # ---- 3c. the beam / plane sweeps on one 128^2 check-config pass ----
    bscene = scenes.box_medium(128, 128)
    bcfg = PhotonConfig(**BEAM_GOLD_KW)
    b_pass = dict(n_photons=max(bcfg.surface_photons, bcfg.volume_photons),
                  seed=5, it=0, surf_scale=1.0, vol_scale=1.0,
                  r_vol_base=sppm.base_volume_radius(bscene, bcfg))
    beam_kernels = {}
    regs = bs.build_report()
    for kind, (q, rows, p) in capture_sweeps(bscene, bcfg, b_pass).items():
        want, n_acc, st, err = beams_against_plain(kind, q, rows, p)
        accepted = int(n_acc.sum())
        bound_ms, bound_by, detail = beam_bound(kind, q, rows, st, accepted)
        ms = cuda_ms(lambda: bs.sweep(kind, q, rows, p), 5)
        plain_ms = cuda_ms(lambda: bs.sweep_plain(kind, q, rows, p), 1,
                           warm=0)
        beam_kernels[kind] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  bound_ms=bound_ms, bound_by=bound_by)
        r = regs[kind]
        old = (f" (operations at the float32 rate by the kernel's own "
               f"count: {detail['kernel_ops_ms']:.4f} ms, by one thread a "
               f"query's: {detail['thread_ops_ms']:.4f} ms); "
               f"{bs.warps_per_sm(kind)} warps an SM")
        phase("beams", f"{kind} (gsweep.cu): {q.shape[0]} camera queries x "
                       f"{rows.shape[0]} beams (valid of "
                       f"{bscene.width}^2 x {BEAM_GOLD_KW['surface_photons']}"
                       f" paths), accepted pairs {accepted} equal, max|err| "
                       f"{err:.3g} (rtol 2e-4 atol 5e-6), two launches "
                       f"bitwise equal, kernel {ms:.3f} ms, plain "
                       f"{plain_ms:.1f} ms, bound {bound_ms:.4f} ms by "
                       f"{bound_by} ({bound_ms / ms:.1%} of it){old}; "
                       f"{r['registers']} registers, {r['spill_stores']} B "
                       f"spilled; pairs past the kernel's test (pretest, "
                       f"sweep_plain's model of it, guard included) "
                       f"{st.get('pretest')}, past the first stage "
                       f"(stage2) {st['stage2']} {json.dumps(detail)}")
    del q, rows, p, want, n_acc

    # ---- 3c'. the queued primal sweeps on their stress input ----
    for kind, shift in (tuple((k, 0.0) for k in bs.KINDS)
                        + tuple(("beam1d", s) for s in BEAM1D_FAR_SHIFTS)):
        want, n_acc, st, hot, err = beams_stress_against_plain(kind, shift)
        phase("beams-stress", f"{kind} moved by {shift}: {want.shape[0]} "
                              f"queries, accepted "
                              f"pairs {int(n_acc.sum())} ({int(n_acc[hot])}"
                              f" of them one query's) equal at the split "
                              f"plan and in one split, pretest "
                              f"{st['pretest']}, stage2 {st['stage2']}, "
                              f"max|err| {err:.3g}, two launches bitwise "
                              f"equal")

    # ---- 3d. the gradient sweeps on one 128^2 check-config gvpm pass ----
    gcfg = GradientConfig(**GVPM_GOLD_KW)
    g_pass = dict(n_photons=max(gcfg.surface_photons, gcfg.volume_photons),
                  seed=5, it=0, surf_scale=1.0, vol_scale=1.0,
                  r_vol_base=sppm.base_volume_radius(bscene, gcfg))
    for kind, args in capture_gsweeps(bscene, gcfg, g_pass).items():
        q, qx, rows, tails, p = args
        want, st, err, plain_ms = gbeams_against_plain(kind, args)
        bound_ms, bound_by, detail = gbeam_bound(kind, q, rows, st)
        ms = cuda_ms(lambda: bs.gsweep(kind, *args), 3)
        beam_kernels[kind] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  bound_ms=bound_ms, bound_by=bound_by)
        r = regs[kind]
        phase("gbeams", f"{kind} (gsweep.cu): {q.shape[0]} camera queries x "
                        f"{rows.shape[0]} beams, visits "
                        f"{int(want[3].sum())} and shift_ok "
                        f"{int(want[4].sum())} equal, max|err| {err:.3g} "
                        f"(rtol 2e-4 atol 5e-6), two launches bitwise "
                        f"equal, kernel {ms:.3f} ms, plain {plain_ms:.1f} "
                        f"ms (shifts on the accepted pairs only), bound "
                        f"{bound_ms:.4f} ms by {bound_by} "
                        f"({bound_ms / ms:.1%} of it), {r['registers']} "
                        f"registers, {r['spill_stores']} B spilled "
                        f"{json.dumps(detail)}")
        shape = bs.gsweep_shape()
        chunk = bs.gsplit_plan(q.shape[0], rows.shape[0], kind)[1]
        lu = gsweep_lane_use(kind, q, rows, tails, p, shape, chunk)
        phase("gbeams", f"{kind} lane use, one thread a query "
                        f"(the kernel before) and queued (gsweep.cu "
                        f"{json.dumps(shape)}): {json.dumps(lu)}")
    del q, qx, rows, tails, p, args, want

    # ---- 3e. their ME instantiations on one 128^2 gvpm ME pass ----
    gcfg_me = GradientConfig(**dict(GVPM_GOLD_KW, use_manifold=True))
    for kind, args in capture_gsweeps(bscene, gcfg_me, g_pass).items():
        q, qx, rows, tails, p = args
        got, plain_ms, err, n_rows, me_q = gbeams_me_against_plain(kind,
                                                                   args)
        st = gsweep_stats(kind, q, rows, tails, p)
        if st["accepted"] != int(got[3].sum()):
            raise AssertionError(f"beam_sweep_{kind}: the dense base test "
                                 "counts other pairs than the kernel")
        bound_ms, bound_by, detail = gbeam_bound(kind, q, rows, st)
        ms = cuda_ms(lambda: bs.gsweep(kind, *args), 3)
        beam_kernels[kind] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  bound_ms=bound_ms, bound_by=bound_by)
        n_elig = int((tails[:, bs.TSLOT["reconnectable"]] < -0.5).sum())
        chords = " and chord points" if got[7] is not None else ""
        r = regs[kind]
        phase("gbeams-me", f"{kind} (gsweep.cu, {r['registers']} registers, "
                           f"{r['spill_stores']} B spilled, {bound_ms / ms:.1%}"
                           f" of bound): {q.shape[0]} camera queries x "
                           f"{rows.shape[0]} beams ({n_elig} ME-eligible), "
                           f"visits {int(got[3].sum())}, "
                           f"shift_ok {int(got[4].sum())}, ME queries "
                           f"{int((got[5] != bs.ME_NONE).sum())} with "
                           f"{int(got[6].sum())} ME pairs; on the first "
                           f"{n_rows} rows (1/{PLAIN_EVERY} of the valid "
                           f"queries, {me_q} with an ME pair) visits, "
                           f"shift_ok, ME keys, counts{chords} equal, "
                           f"max|err| {err:.3g} (rtol 2e-4 atol 5e-6), two "
                           f"launches bitwise equal, kernel "
                           f"{ms:.3f} ms, plain {plain_ms:.1f} ms on those "
                           f"rows, bound {bound_ms:.4f} ms by {bound_by} "
                           f"{json.dumps(detail)}")
    del q, qx, rows, tails, p, args, got

    # ---- 3f. the queued sweeps on their stress input ----
    for kind in bs.GKINDS + bs.GKINDS_ME:
        want, hot, err, n_beams = gsweep_stress_against_plain(kind)
        me = (f", ME queries {int((want[5] != bs.ME_NONE).sum())} with "
              f"{int(want[6].sum())} ME pairs" if len(want) > 5 else "")
        if kind.startswith("gbeam3d"):
            q, _, rows, tails, p, _ = gsweep_stress_inputs(kind,
                                                           device="cuda")
            st = gsweep_stats(kind, q, rows, tails, p)
            me += (f", {st['stage2'] - st['accepted']} queued pairs that "
                   "base rejects")
        phase("gbeams-stress", f"{kind}: {want[0].shape[0]} queries x "
                               f"{n_beams} beams, visits "
                               f"{int(want[3].sum())} "
                               f"({int(want[3][hot])} of them one query's),"
                               f" shift_ok {int(want[4].sum())}{me} equal at "
                               f"the split plan and in one split, max|err| "
                               f"{err:.3g}, two launches bitwise equal")
    phase("gbeams", "controls (beam1d, beam3d and the gradient sweeps, "
                    "unchanged), ms a launch: " + json.dumps(
                        {k: round(beam_kernels[k]["ms"], 3)
                         for k in ("beam1d", "beam3d") + bs.GKINDS
                         + bs.GKINDS_ME}))

    # ---- 4. the main paths at the headline size ----
    def drive(label, cfg, passes, expect):
        marks, timings = [], {}

        def on_pass(it, _img, stats):
            torch.cuda.synchronize()
            marks.append((time.perf_counter(),
                          {k: int(v) for k, v in stats.items()}))

        for k in fg.LAUNCHES:
            fg.LAUNCHES[k] = 0
        for k in me_newton.LAUNCHES:
            me_newton.LAUNCHES[k] = 0
        plain_lanes = StatsCounter.get("me/newton_plain_lanes")
        plain_before = plain_lanes.value()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = gvpm.render(scene, cfg, volume="distance", seed=5,
                          passes=passes, callback=on_pass, timings=timings)
        torch.cuda.synchronize()
        t_all = time.perf_counter() - t0
        launches = dict(fg.LAUNCHES)
        me_launches = dict(me_newton.LAUNCHES)
        plain = plain_lanes.value() - plain_before
        starts = [t0] + [m[0] for m in marks[:-1]]
        pass_s = [m[0] - s for m, s in zip(marks, starts)]
        stats = [m[1] for m in marks]
        visits = [s["visits"] for s in stats]
        phase(label, f"512x512, {n_photons} paths, {passes} passes: pass s "
                     f"{[round(s, 4) for s in pass_s]}, visits/pass "
                     f"{visits}, visits/s (after pass 1) "
                     f"{sum(visits[1:]) / sum(pass_s[1:]):.4g}, total "
                     f"{t_all:.2f} s incl. Poisson")
        phase(label, f"phase split s ({passes} passes): " + json.dumps(
            {k: round(v, 4) for k, v in timings.items()
             if not k.startswith("me:")}))
        if cfg.use_manifold:
            phase(label, "parts of surface_me + volume_me, s: " + json.dumps(
                {k[3:]: round(v, 4) for k, v in timings.items()
                 if k.startswith("me:")})
                + f"; {passes * 3} shift calls of "
                f"{cfg.max_manifold_iterations + 1} Jacobian evaluations "
                "each in newton")
        phase(label, "per pass: shift_ok "
                     f"{[s['shift_ok'] for s in stats]}, ME pairs taken "
                     f"{[s['me_pairs'] for s in stats]}, me_dropped "
                     f"{[s['me_dropped'] for s in stats]}")
        phase(label, f"launches {launches}; me_newton {me_launches}, "
                     f"lanes of the plain Newton solve {plain:g}")
        if launches != expect:
            raise AssertionError(f"kernel launch counts {launches}, "
                                 f"expected {expect}")
        # a pass's ME shifts: one surface call, one volume call a sample
        me_expect = dict.fromkeys(me_newton.LAUNCHES, 0)
        if cfg.use_manifold:
            me_expect.update(volume=passes * cfg.volume_samples,
                             surface=passes)
        if me_launches != me_expect or plain != 0:
            raise AssertionError(f"me_newton launch counts {me_launches}, "
                                 f"expected {me_expect}; plain Newton "
                                 f"lanes {plain}, expected 0")
        for k in ("primal", "gx", "gy", "image"):
            if out[k].shape != (512, 512, 3) or out[k].dtype != torch.float32:
                raise AssertionError(
                    f"{k}: {out[k].dtype} {tuple(out[k].shape)}")
            if not bool(torch.isfinite(out[k]).all()):
                raise AssertionError(f"non-finite {k}")
        mp, mr = float(out["primal"].mean()), float(out["image"].mean())
        if not abs(mr / mp - 1.0) < 0.25:
            raise AssertionError(f"recon mean {mr} vs primal mean {mp}")
        phase(label, f"finite; primal mean {mp:.5g}, recon mean {mr:.5g}")
        return launches, stats, me_launches

    none = dict.fromkeys(fg.LAUNCHES, 0)
    launches_me, stats_me, me_launches = drive(
        "main-me", cfg_me, 3, dict(none, surface_me=3, volume_me=6))
    launches, stats, _ = drive(
        "main", cfg, 2, dict(none, surface=2, volume=4))
    for it, (s_me, s) in enumerate(zip(stats_me, stats)):
        if s_me["visits"] != s["visits"]:
            raise AssertionError(f"pass {it}: visits with ME "
                                 f"{s_me['visits']} vs without {s['visits']}")
        if not s_me["shift_ok"] > s["shift_ok"]:
            raise AssertionError(f"pass {it}: shift_ok with ME "
                                 f"{s_me['shift_ok']} not above "
                                 f"{s['shift_ok']} without")
        if not s_me["me_pairs"] > 0 == s["me_pairs"]:
            raise AssertionError(f"pass {it}: ME pairs {s_me['me_pairs']} "
                                 f"/ {s['me_pairs']}")
    phase("main", "shift_ok with ME above shift_ok without, pass by pass: "
                  f"{[(a['shift_ok'], b['shift_ok']) for a, b in zip(stats_me, stats)]}")
    launches = {k: launches[k] + launches_me[k] for k in launches}

    # device kernels of one pass, with and without ME (the host launches
    # them one by one; printed, not asserted), read from the device trace
    # alone (the profiler's host events of ~70k launches take it tens of
    # seconds to process)
    def count_launches(c):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            gvpm.render_pass(scene, c, "distance", n_photons, 5, 0, 1.0, 1.0,
                             r_vol_base)
            torch.cuda.synchronize()
        return sum(1 for e in device_events(prof)
                   if not e[0].startswith(("Memcpy", "Memset")))
    phase("main", f"device kernels in one pass (torch.profiler's device "
                  f"trace): "
                  f"{count_launches(cfg_me)} with ME, "
                  f"{count_launches(cfg)} without")

    # ---- 4b. the SPPM primal pass at the headline size ----
    from gvpm_tpu_torch.ops import hashgrid
    scfg = PhotonConfig(**SPPM_KW)
    s_r_vol = sppm.base_volume_radius(scene, scfg)
    s_photons = max(scfg.surface_photons, scfg.volume_photons)
    grids, build = [], hashgrid.build

    def keep_build(*a, **k):
        grids.append(build(*a, **k))
        return grids[-1]

    hashgrid.build = keep_build
    try:                                            # the warm-up pass
        sppm.render_pass(scene, scfg, "distance", s_photons, 5, 0, 1.0, 1.0,
                         s_r_vol)
    finally:
        hashgrid.build = build
    hists = [hashgrid.cell_histogram(g) for g in grids]
    del grids
    phase("sppm", f"hash grids (max, mean nonzero) photons per bucket: "
                  f"surface {hists[0]}, volume {hists[1]} "
                  f"(grid_max_photons_per_cell {scfg.grid_max_photons_per_cell}"
                  f", budget {2 * scfg.grid_max_photons_per_cell} rows)")
    marks, timings = [], {}

    def on_sppm_pass(it, _img):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sppm.render(scene, scfg, volume="distance", seed=5, passes=3,
                      callback=on_sppm_pass, timings=timings)
    pass_s = [b - a for a, b in zip([t0] + marks[:-1], marks)]
    img = out["image"]
    if img.shape != (512, 512, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"sppm: image {tuple(img.shape)} not finite")
    if not float(img.mean()) > 0:
        raise AssertionError("sppm: image mean not above 0")
    phase("sppm", f"512x512, {s_photons} paths, 3 passes after a warm-up: "
                  f"pass s {[round(x, 4) for x in pass_s]}, image mean "
                  f"{float(img.mean()):.5g}, finite")
    phase("sppm", "phase split s per pass: " + json.dumps(
        {k: round(v / 3, 4) for k, v in timings.items()}))
    gd = hashgrid.gather_dense

    def traced_gather_dense(*a, **k):
        with torch.profiler.record_function("gather_dense"):
            return gd(*a, **k)

    hashgrid.gather_dense = traced_gather_dense
    try:
        n_launch, busy, gd_share, how, wall = profile_pass(
            lambda: sppm.render_pass(scene, scfg, "distance", s_photons, 5,
                                     3, 1.0, 1.0, s_r_vol))
    finally:
        hashgrid.gather_dense = gd
    phase("sppm", f"one profiled pass (torch.profiler, {wall:.4f} s): "
                  f"{n_launch} device kernel launches, device busy "
                  f"{busy:.1%} of the pass, gather_dense "
                  + (f"{gd_share:.1%} of device kernel time ({how})"
                     if gd_share is not None else "not measured (no device "
                     "time attributed to it)"))
    # ---- 4c. the SPPM pass of each new volume estimator at 128^2 ----
    main_launches = {}
    for volume in ("bre", "beam1d", "beam3d", "plane0d"):
        for k in bs.LAUNCHES:
            bs.LAUNCHES[k] = 0
        timings = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = sppm.render_pass(bscene, bcfg, volume, **dict(b_pass, it=1),
                               timings=timings)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        swept = dict(bs.LAUNCHES)
        expect = dict.fromkeys(bs.LAUNCHES, 0)
        expect.update({volume: BEAM_LAUNCHES[volume]}
                      if volume in BEAM_LAUNCHES else {})
        if swept != expect:
            raise AssertionError(f"sppm {volume}: beam_sweep launches "
                                 f"{swept}, expected {expect}")
        main_launches.update({volume: swept[volume]}
                             if volume in BEAM_LAUNCHES else {})
        if not (bool(torch.isfinite(img).all()) and float(img.mean()) > 0):
            raise AssertionError(f"sppm {volume}: image not finite / dark")
        phase("sppm-128", f"{volume}: one pass of 128x128, "
                          f"{b_pass['n_photons']} paths (after a warm-up "
                          f"pass) {secs:.4f} s, image mean "
                          f"{float(img.mean()):.5g}; phase split s "
                          + json.dumps({k: round(v, 4)
                                        for k, v in timings.items()})
                          + f"; beam_sweep launches {swept}")

    # ---- 4e. the gvpm beam volumes at 128^2 and at the bench's full
    # beam config ----
    def gvpm_beam_pass(volume, cfg_, pass_kw, label, expect):
        """One gvpm beam pass, its sweep launches (and with ME the
        surface gather's) counted from 0; with ME the beam ME pairs
        taken (counted where the beam gathers compact them) must be
        above 0."""
        beam_pairs, me_pairs = [0], gradient_gather._me_pairs

        def count_pairs(*a, **k):
            out = me_pairs(*a, **k)
            beam_pairs[0] += out[0].shape[0]
            return out

        for k in bs.LAUNCHES:
            bs.LAUNCHES[k] = 0
        for k in fg.LAUNCHES:
            fg.LAUNCHES[k] = 0
        timings = {}
        gradient_gather._me_pairs = count_pairs
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = gvpm.render_pass(bscene, cfg_, volume, **pass_kw,
                                   timings=timings)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            gradient_gather._me_pairs = me_pairs
        swept, gathered = dict(bs.LAUNCHES), dict(fg.LAUNCHES)
        if swept != dict(dict.fromkeys(bs.LAUNCHES, 0), **expect):
            raise AssertionError(f"gvpm {volume}: beam_sweep launches "
                                 f"{swept}, expected {expect}")
        surf = "surface_me" if cfg_.use_manifold else "surface"
        if gathered != dict(dict.fromkeys(fg.LAUNCHES, 0), **{surf: 1}):
            raise AssertionError(f"gvpm {volume}: fused_gather launches "
                                 f"{gathered}")
        if not all(bool(torch.isfinite(a).all()) for a in out[:3]):
            raise AssertionError(f"gvpm {volume}: non-finite pass buffers")
        if cfg_.use_manifold and not beam_pairs[0] > 0:
            raise AssertionError(f"gvpm {volume}: no beam ME pair taken")
        me = (f", ME pairs {int(out[3]['me_pairs'])} (of the beams "
              f"{beam_pairs[0]}), me_dropped {int(out[3]['me_dropped'])}"
              if cfg_.use_manifold else "")
        phase(label, f"gvpm {volume}: one pass {secs:.4f} s, visits "
                     f"{int(out[3]['visits'])}, shift_ok "
                     f"{int(out[3]['shift_ok'])}{me}; phase split s "
                     + json.dumps({k: round(v, 4)
                                   for k, v in timings.items()
                                   if not k.startswith("me:")})
                     + (("; me: parts s " + json.dumps(
                         {k[3:]: round(v, 4) for k, v in timings.items()
                          if k.startswith("me:")}))
                        if cfg_.use_manifold else "")
                     + f"; beam_sweep launches {swept}, fused_gather "
                       f"launches {gathered}")
        return swept

    for kind, volume in GBEAM_VOLUMES.items():
        swept = gvpm_beam_pass(volume, gcfg, dict(g_pass, it=1), "gvpm-128",
                               {kind: GBEAM_LAUNCHES[kind]})
        main_launches[kind] = swept[kind]
    fcfg = GradientConfig(**GBEAM_FULL_KW)
    f_pass = dict(n_photons=max(fcfg.surface_photons, fcfg.volume_photons),
                  seed=5, it=0, surf_scale=1.0, vol_scale=1.0,
                  r_vol_base=sppm.base_volume_radius(bscene, fcfg))
    n_seg = bscene.width * bscene.height * fcfg.vol_segments_per_pixel
    for kind, volume in GBEAM_VOLUMES.items():
        expect = {kind: (-(-n_seg // fcfg.beam_seg_tile)
                         * fcfg.volume_samples if kind == "gbeam3d" else 1)}
        gvpm_beam_pass(volume, fcfg, f_pass, "gvpm-full", expect)  # warm
        gvpm_beam_pass(volume, fcfg, dict(f_pass, it=1), "gvpm-full",
                       expect)
    # ---- 4f. the same with the default use_manifold=True ----
    for kind, volume in GBEAM_VOLUMES.items():
        swept = gvpm_beam_pass(volume, gcfg_me, dict(g_pass, it=1),
                               "gvpm-128-me",
                               {kind + "_me": GBEAM_LAUNCHES[kind]})
        main_launches[kind + "_me"] = swept[kind + "_me"]
    fcfg_me = GradientConfig(**dict(GBEAM_FULL_KW, use_manifold=True))
    n_chunks = -(-n_seg // fcfg_me.beam_seg_tile)
    for kind, volume in GBEAM_VOLUMES.items():
        expect = {kind + "_me": n_chunks * (fcfg_me.volume_samples
                                            if kind == "gbeam3d" else 1)}
        gvpm_beam_pass(volume, fcfg_me, f_pass, "gvpm-full-me", expect)
        gvpm_beam_pass(volume, fcfg_me, dict(f_pass, it=1), "gvpm-full-me",
                       expect)

    # ---- 4d. the G-VPM bre pass at the headline size (default ME) ----
    for k in fg.LAUNCHES:
        fg.LAUNCHES[k] = 0
    timings = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_bre, gx_bre, gy_bre, st_bre = gvpm.render_pass(
        scene, cfg_me, "bre", n_photons, 5, 1, 1.0, 1.0, r_vol_base,
        timings=timings)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    bre_launches = dict(fg.LAUNCHES)
    if bre_launches != dict(none, surface_me=1):
        raise AssertionError(f"gvpm bre: fused_gather launches "
                             f"{bre_launches}")
    if not all(bool(torch.isfinite(a).all()) for a in (p_bre, gx_bre, gy_bre)):
        raise AssertionError("gvpm bre: non-finite pass buffers")
    phase("bre", f"gvpm bre, 512x512, {n_photons} paths, default ME: one "
                 f"pass {secs:.4f} s, visits {int(st_bre['visits'])}, "
                 f"shift_ok {int(st_bre['shift_ok'])}, ME pairs "
                 f"{int(st_bre['me_pairs'])}; fused_gather launches "
                 f"{bre_launches}; phase split s " + json.dumps(
                     {k: round(v, 4) for k, v in timings.items()
                      if not k.startswith("me:")}))
    del scene, out, img, p_bre, gx_bre, gy_bre

    # ---- 5. golden bars ----
    ci = dict(surface_photons=1 << 15, volume_photons=1 << 15, max_depth=12,
              use_manifold=False, passes=12)
    gold_cfgs = [
        ("ci", "ME off", ci),
        ("ci", "ME on", dict(ci, use_manifold=True)),
        (".", "ME off", dict(GVPM_GOLD_KW, passes=10))]
    seen, kept = {}, {}
    for sub, label, kw in gold_cfgs:
        gdir = os.path.normpath(os.path.join(ROOT, "goldens", sub))
        with open(os.path.join(gdir, "meta.json")) as f:
            meta = json.load(f)
        size = meta["size"]
        bar = meta["scenes"]["box-medium"]["thresholds"]["gvpm:distance"]
        kw = dict(kw)
        passes = kw.pop("passes")
        t0 = time.perf_counter()
        res = gvpm.render(scenes.box_medium(size, size),
                          GradientConfig(**kw), volume="distance", seed=5,
                          passes=passes)
        img = res["image"].cpu().numpy()
        if not np.isfinite(img).all():
            raise AssertionError(f"golden {size} {label}: non-finite image")
        r = imglib.relmse(img, imglib.read_pfm(
            os.path.join(gdir, "box-medium_ref.pfm")))
        seen[(size, label)] = r
        kept[(size, label)] = res
        phase("goldens", f"box-medium gvpm:distance {size}^2 {passes} "
                         f"passes, {label}: relMSE {r:.5f} (bar {bar}) in "
                         f"{time.perf_counter() - t0:.2f} s")
        if not r <= bar:
            raise AssertionError(f"golden {size} {label}: relMSE {r} > "
                                 f"{bar}")
    for sub, kw, passes in SPPM_GOLD:
        gdir = os.path.normpath(os.path.join(ROOT, "goldens", sub))
        with open(os.path.join(gdir, "meta.json")) as f:
            meta = json.load(f)
        size = meta["size"]
        bar = meta["scenes"]["box-medium"]["thresholds"]["sppm:distance"]
        t0 = time.perf_counter()
        res = sppm.render(scenes.box_medium(size, size), PhotonConfig(**kw),
                          volume="distance", seed=5, passes=passes)
        img = res["image"].cpu().numpy()
        if not np.isfinite(img).all():
            raise AssertionError(f"sppm golden {size}: non-finite image")
        r = imglib.relmse(img, imglib.read_pfm(
            os.path.join(gdir, "box-medium_ref.pfm")))
        phase("goldens", f"box-medium sppm:distance {size}^2 {passes} "
                         f"passes: relMSE {r:.5f} (bar {bar}) in "
                         f"{time.perf_counter() - t0:.2f} s")
        if not r <= bar:
            raise AssertionError(f"sppm golden {size}: relMSE {r} > {bar}")
    for sub, volume, passes in SPPM_BEAM_GOLD:
        gdir = os.path.normpath(os.path.join(ROOT, "goldens", sub))
        with open(os.path.join(gdir, "meta.json")) as f:
            meta = json.load(f)
        size = meta["size"]
        bar = meta["scenes"]["box-medium"]["thresholds"][f"sppm:{volume}"]
        t0 = time.perf_counter()
        res = sppm.render(scenes.box_medium(size, size), PhotonConfig(
            **(SPPM_GOLD[0][1] if sub == "ci" else BEAM_GOLD_KW)),
            volume=volume, seed=5, passes=passes)
        img = res["image"].cpu().numpy()
        if not np.isfinite(img).all():
            raise AssertionError(f"sppm:{volume} golden {size}: non-finite")
        r = imglib.relmse(img, imglib.read_pfm(
            os.path.join(gdir, "box-medium_ref.pfm")))
        phase("goldens", f"box-medium sppm:{volume} {size}^2 {passes} "
                         f"passes: relMSE {r:.5f} (bar {bar}) in "
                         f"{time.perf_counter() - t0:.2f} s")
        if not r <= bar:
            raise AssertionError(f"sppm:{volume} golden {size}: relMSE {r} "
                                 f"> {bar}")
    # gvpm:bre has no recorded bar: its relMSE is reported, the images
    # must be finite and the reconstruction's mean near the primal's
    kw = dict(gold_cfgs[2][2])
    passes = kw.pop("passes")
    t0 = time.perf_counter()
    res = gvpm.render(scenes.box_medium(128, 128), GradientConfig(**kw),
                      volume="bre", seed=5, passes=passes)
    for k in ("primal", "gx", "gy", "image"):
        if not bool(torch.isfinite(res[k]).all()):
            raise AssertionError(f"gvpm:bre 128: non-finite {k}")
    mp, mr = float(res["primal"].mean()), float(res["image"].mean())
    if not abs(mr / mp - 1.0) < 0.25:
        raise AssertionError(f"gvpm:bre 128: recon mean {mr} vs primal {mp}")
    r = imglib.relmse(res["image"].cpu().numpy(), imglib.read_pfm(
        os.path.join(ROOT, "goldens", "box-medium_ref.pfm")))
    phase("goldens", f"box-medium gvpm:bre 128^2 {passes} passes, ME off: "
                     f"relMSE {r:.5f} (no recorded bar), primal mean "
                     f"{mp:.5g}, recon mean {mr:.5g}, finite, in "
                     f"{time.perf_counter() - t0:.2f} s")
    # the gvpm beam volumes, ME off and on (no recorded bar): relMSE,
    # finite, the reconstruction's mean within 2% of the primal's, gx
    # against the golden's finite differences (tools/goldens.py:237-255)
    gref = imglib.read_pfm(os.path.join(ROOT, "goldens",
                                        "box-medium_ref.pfm"))
    fdx = gref[:, 1:] - gref[:, :-1]
    beam_gold = {}
    for label, cfg_ in (("ME off", gcfg), ("ME on", gcfg_me)):
        for volume, passes in GBEAM_GOLD_PASSES.items():
            if label == "ME on":
                passes //= GBEAM_GOLD_ME_DIVISOR
            t0 = time.perf_counter()
            res = gvpm.render(scenes.box_medium(128, 128), cfg_,
                              volume=volume, seed=5, passes=passes)
            for k in ("primal", "gx", "gy", "image"):
                if not bool(torch.isfinite(res[k]).all()):
                    raise AssertionError(f"gvpm:{volume} 128 {label}: "
                                         f"non-finite {k}")
            mp, mr = float(res["primal"].mean()), float(res["image"].mean())
            gx = res["gx"].cpu().numpy()
            corr = float(np.corrcoef(gx[:, :-1].ravel(), fdx.ravel())[0, 1])
            r = imglib.relmse(res["image"].cpu().numpy(), gref)
            beam_gold[(volume, label)] = r
            off = (f" (ME off {beam_gold[(volume, 'ME off')]:.5f} at "
                   f"{GBEAM_GOLD_PASSES[volume]} passes)"
                   if label == "ME on" else "")
            phase("goldens", f"box-medium gvpm:{volume} 128^2 {passes} "
                             f"passes, {label}: relMSE {r:.5f}{off} (no "
                             f"recorded bar), primal mean {mp:.5g}, recon "
                             f"mean {mr:.5g} ({mr / mp - 1.0:+.2%}), "
                             f"gx~FD(golden) correlation {corr:.3f} (> "
                             f"0.5), finite, in "
                             f"{time.perf_counter() - t0:.2f} s")
            if not abs(mr / mp - 1.0) < 0.02:
                raise AssertionError(f"gvpm:{volume} 128 {label}: recon "
                                     f"mean {mr} vs primal {mp}")
            if not corr > 0.5:
                raise AssertionError(f"gvpm:{volume} 128 {label}: gx "
                                     f"correlation {corr}")
    phase("goldens", "32^2 relMSE ME off / ME on: "
                     f"{seen[(32, 'ME off')]:.5f} / "
                     f"{seen[(32, 'ME on')]:.5f}")
    # how far rounding alone moves a golden: the 32^2 ME-off render
    # again with the gathers' plain version (same pairs, sums in another
    # order)
    kw = dict(ci)
    passes = kw.pop("passes")
    kernel = kept[(32, "ME off")]
    del kept
    fg.fused_gather = fg.fused_gather_plain
    try:
        plain = gvpm.render(scenes.box_medium(32, 32), GradientConfig(**kw),
                            volume="distance", seed=5, passes=passes)
    finally:
        fg.fused_gather = launch
    ref = imglib.read_pfm(os.path.join(ROOT, "goldens", "ci",
                                       "box-medium_ref.pfm"))
    phase("goldens", "32^2 ME off, gathers through the plain version on the "
                     "card: relMSE "
                     f"{imglib.relmse(plain['image'].cpu().numpy(), ref):.5f} "
                     "against the kernel's "
                     f"{imglib.relmse(kernel['image'].cpu().numpy(), ref):.5f}; "
                     "kernel vs plain max relative difference, primal "
                     f"{float(((kernel['primal'] - plain['primal']).abs() / plain['primal'].abs().clamp(min=1e-3)).max()):.3g}"
                     ", reconstruction "
                     f"{float(((kernel['image'] - plain['image']).abs() / plain['image'].abs().clamp(min=1e-3)).max()):.3g}")

    # ---- 6. the single-device entry point, and the goldens' integrator ----
    from gvpm_tpu_torch import entry
    from gvpm_tpu_torch.core.config import VolPathConfig
    from gvpm_tpu_torch.integrators import volpath
    fn, args = entry.entry()                       # default device: the card
    t0 = time.perf_counter()
    img = fn(*args)
    torch.cuda.synchronize()
    if img.shape != (32, 32, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"entry: image {tuple(img.shape)} not finite")
    phase("entry", f"entry() fn on {img.device}: one SPPM pass of the "
                   f"32x32 tiny scene in {time.perf_counter() - t0:.3f} s, "
                   f"image mean {float(img.mean()):.5g}, finite")
    for sub in ("ci", "."):
        gdir = os.path.normpath(os.path.join(ROOT, "goldens", sub))
        with open(os.path.join(gdir, "meta.json")) as f:
            meta = json.load(f)
        size, spp = meta["size"], meta["gen_spp"]
        agree = meta["scenes"]["box-medium"]["agree_relmse"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = volpath.render(scenes.box_medium(size, size),
                             VolPathConfig(spp=spp, max_depth=12), seed=101)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        img = img.cpu().numpy()
        if not np.isfinite(img).all():
            raise AssertionError(f"volpath {size}: non-finite image")
        r = imglib.relmse(img, imglib.read_pfm(
            os.path.join(gdir, "box-medium_ref.pfm")))
        phase("volpath", f"box-medium {size}^2, {spp} spp, max_depth 12, "
                         f"seed 101 (the golden's generation config): "
                         f"{secs:.2f} s, relMSE against the golden {r:.5f} "
                         f"(agree_relmse {agree})")
        if not r < agree:
            raise AssertionError(f"volpath {size}: relMSE {r} >= {agree}")

    # ---- 7. the rest of the scene description ----
    base_ms = {n: k["ms"] for n, k in {**kernels, **beam_kernels}.items()}
    scene_kernels(smi, base_ms)
    scene_goldens()
    feature_renders(smi)

    # ---- 8. the path-space integrators ----
    surface_ref = path_integrators(smi, seen[(128, "ME off")])

    # ---- 9. BDPT and G-BDPT; 10. the command-line renderer ----
    bidir(smi, surface_ref)
    cli_phase(smi)

    # ---- 11. the multi-rank render ----
    dist_phase(smi)

    src = "gvpm_tpu_torch/csrc/fused_gather.cu"
    print(json.dumps({"kernels": [
        dict(name=f"fused_gather_{n}", route="cuda", source=src,
             replaces="gvpm_tpu/ops/pallas_gather.py:262",
             launches=launches[n], max_abs_err=k["max_abs_err"],
             ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
             bound_by=k["bound_by"],
             # no single PyTorch call computes a stencil-restricted
             # pairwise gather with the shift body
             library_ms=None)
        for n, k in kernels.items()] + [
        dict(name=f"beam_sweep_{n}", route="cuda",
             source="gvpm_tpu_torch/csrc/gsweep.cu",
             replaces={**BEAM_REPLACES, **GBEAM_REPLACES,
                       **GBEAM_ME_REPLACES}[n],
             launches=main_launches[n],
             max_abs_err=k["max_abs_err"], ms=k["ms"],
             plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
             bound_by=k["bound_by"],
             # no PyTorch call computes a pairwise sweep with this body
             library_ms=None)
        for n, k in beam_kernels.items()] + [
        # the 3-unknown instantiation also solves the beam target
        dict(name=f"me_newton_{t}", route="cuda",
             source="gvpm_tpu_torch/csrc/me_newton.cu",
             replaces="gvpm_tpu/integrators/manifold.py",
             launches=me_launches[t] + (me_launches["beam"]
                                        if t == "volume" else 0),
             max_abs_err=k["max_abs_err"], ms=k["ms"],
             plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
             bound_by=k["bound_by"],
             # no PyTorch call solves a lane's Newton iteration
             library_ms=None)
        for t, k in me_kernels.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
