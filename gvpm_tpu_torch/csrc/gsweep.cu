// The queued beam / plane sweeps for Hopper (sm_90a): the primal beam1d,
// beam3d and plane0d, and the gradient gbeam1d, gbeam3d and gplane0d,
// each of those with and without the manifold (ME) outputs
// (ops/beam_sweep.py kinds beam1d, beam3d, plane0d, the gsweep kinds
// gbeam1d, gbeam3d, gplane0d and their _me kinds; per-pair math in
// beam_eval.cuh's Beam1D / Beam3D / Plane0D and GBeam1DT / GBeam3DT /
// GPlane0DT, split into test, base and (gradient) shift parts).
//
// What it replaces: the XLA tile loops (lax.scan over every beam slot)
// of gvpm_tpu/integrators/estimators.py:481 beam_beam_gather, :262
// beam_point_gather and :401 plane_gather, of gradient_gather.py:1232
// beam_gradient_gather, :1580 beam3d_gradient_gather and :1960
// plane_gradient_gather, and with use_manifold=True their ME pair
// collection (:1346-1355, :1710-1720, :2091-2100). The TPU has no kernel
// for them; on this card they first ran on a kernel of one thread a
// query, which this one replaced.
//
// What it computes: every camera query (a row of pack_queries, and for
// a gradient kind its four offset rays, pack_offsets) against every
// packed beam or plane (pack_beams; a gradient kind's tail, pack_tails;
// beam3d's beam_keys row): the test; for the pairs that pass, the base
// term and (gradient) the four shifts with pairwise MIS. Per query: a
// primal kind's sum 3 and accepted pairs; a gradient kind's base 3, S 4 x
// 3, W 4 x 3, visits, shift_ok, and with ME the lowest packed index of an
// ME-eligible accepted beam (ME_NONE if none) and the count of such
// pairs; gbeam3d_me also that pair's chord point.
//
// What bounds it: operations (chip_smoke.py::beam_bound / gbeam_bound).
// On one 128^2 check-config pass (32,768 segment queries, 16,219 valid;
// 291,814 beams; 4.73e9 pairs in one medium) gbeam1d accepts 38.0 M pairs
// (0.80%), gbeam3d 1.87 M (0.04%) and gplane0d 224.3 M (4.7%); an
// accepted pair costs about 1,000 (gbeam1d), 600 (gbeam3d) or 1,600
// (gplane0d) counted float operations, a rejected one 36, 21 or 23
// (gbeam3d's chord test, its clip only near the beam's line; a pair past
// it also draws one threefry word, 123 integer operations). The primal
// kinds test 29 (beam1d's pre-test, no division), 21 (beam3d's chord
// test) or 66 (plane0d's pre-test, no division) operations a pair; the
// pairs past them, 3.17%, 0.06% and about 4.7%, take the exact test
// (beam1d: its two IEEE divisions; plane0d: one) and the contribution in
// a batch. One thread a query (before this kernel) ran the
// shifts inside its beam loop with 11.9% (gbeam1d), 3.8% (gbeam3d) and
// 35.8% (gplane0d) of the 32 lanes busy in the iterations where some
// lane accepted (chip_smoke.py::gsweep_lane_use), held 27 sums a thread
// in 148-168 registers (12 warps an SM), and took 165-167, 36.2 and
// 243-250 ms, 2-6% of the bound; this kernel takes 32.8, 15.1 and 85.5 ms
// (10.0%, 9.9% and 8.0%) (NVIDIA H100 80GB HBM3, 700 W; PERF.md, which
// also has the primal kinds' times).
//
// Design: test densely, queue, run the queued pairs a batch at a time.
//  * A block owns a tile of TQ queries; WARPS warps share it, warp w the
//    queries w, w + WARPS, .... The tile's query rows (gradient: and
//    offset rows; QW + XW floats, at an odd stride) and its accumulators
//    (27 float and 4 integer a query; primal 3 and 1) live in shared
//    memory: nothing accumulates in registers.
//  * Sweep: the beam rows stream through shared memory in tiles of
//    TILE_B (16 floats at an odd stride: the 32 lanes' consecutive rows
//    hit 32 banks). A warp takes one of its queries, holds it in
//    registers (the whole warp shares it), and its 32 lanes test 32 x
//    SWEEP_U beams a step (SWEEP_U independent tests a lane, written
//    without early returns, so that their latencies overlap) with the
//    functor's test alone: beam1d's and plane0d's pre-tests
//    (Beam1D::test, whose guard, the tile's line scale, comes from the
//    staging threads; Plane0D::test), beam3d's and gbeam3d's chord test
//    without its threefry word. A primal kind's tile holds the floats
//    its test reads (F::stage, once a tile: a line's o, d, length and
//    medium; a plane's origin, medium and edges e0 = w0 l0, e1 = w1 l1),
//    a thread a row. Invalid
//    queries cost nothing (the warp skips them; one thread a query kept
//    their lanes idle), and a block with no valid query stages no beam.
//  * Queue: passing pairs go into the warp's ring in shared memory
//    (ballot + popcount) as (query in tile, packed beam index). Whenever
//    the ring holds a batch the warp runs it: a gradient batch of 8
//    pairs, lane l taking pair l % 8 and offset l / 8 (BATCH 32: pair l
//    and its four offsets); a primal batch of 32 pairs, one a lane.
//    beam1d's ring holds the pairs past its pre-test (~3 in 100 tested,
//    of which ~1 is accepted): a batch of them first runs the exact
//    closest-approach test alone, a pair a lane (exact_batch), and
//    queues the accepted ones, in ring order, in a second ring, whose
//    batches run as the others do, so that the contribution and its sums
//    are paid for accepted pairs only. A lane recomputes its pair's test
//    from its beam row (CARRY: the test's values ride in the ring
//    instead), runs its base (beam1d: the exact test again, which its
//    queued pairs pass, then the contribution; beam3d / gbeam3d: the
//    chord sample's threefry word from the beam's key row, read through
//    L2 beside the row, and the sample's in-sphere test, which rejects a
//    queued pair only by rounding at a chord's end; plane0d: plane_hit
//    with its division and the six range tests, which reject the pairs
//    the pre-test's margin let through), and a gradient lane
//    loads the parent from the beam's gradient tail only in its
//    reconnection branch, from device memory through L2: the 30 parent
//    values are live in one shift, not across four. Because a batch
//    reads no staged beam, the ring lives on across beam tiles, and only
//    a block's last batch is partial (99.9% of the lanes busy in a
//    gradient batch on these inputs, against 82.6% (gbeam1d) and 96.5%
//    (gplane0d) if the ring were emptied at each tile's end, as a design
//    that staged the tails with the rows would have to).
//  * Reduction: each lane writes its pair's terms (base 3, S_i and W_i 6
//    an offset, visit, reconnections, ME pair and key; primal: 3 and the
//    visit) into the pair's row of the warp's term buffer; then lane c
//    adds column c of the batch's rows in ring order, one sum a run of
//    pairs of one query, into that query's accumulator in shared memory.
//    The ring is filled query by query, so runs are long; a query that
//    comes back later in the batch (from a later beam tile) opens a new
//    run. No atomics: every sum has a fixed order and two launches on
//    the same inputs give the same bits. Segmented shuffles, one
//    reduction a term as in fused_gather.cu, would cost 27 x 5 shuffles a
//    pair; here a lane spends about one shared load and three adds a
//    pair. A primal batch has 4 columns and 32 pairs, so there the column
//    loop's 32 steps in 4 lanes cost more than 4 x 5 shuffles in all 32
//    lanes: it sums its runs by a segmented scan (primal_sums).
//  * Filling the card: blocks of TQ queries, the beam range split into
//    whole tiles over blockIdx.y (ops/beam_sweep.gsplit_plan, about 4,000
//    blocks, a function of the shapes: the 128^2 pass's 32,768 queries in
//    512 x 8 blocks, about half of them holding valid queries), the
//    splits added in order by reduce_splits (splits.cuh); the ME key is
//    a min over the splits. The primal kinds use the same plan.
//  * gbeam3d_me's chord point: the term buffer has no room for three
//    more floats a pair, and the key is a min over runs and splits, so
//    after reduce_splits one thread a query recomputes the point of its
//    final key with the batch's own code (key_points, GBeam3DT::point):
//    bit-equal by construction. The beam keys are not staged with the
//    rows: the sweep's test does not read them, and a batch's pairs come
//    from any tile the ring has seen.
//  * Registers: __launch_bounds__(WARPS * 32, MIN_BLOCKS) caps a
//    gradient thread at 128 registers, 16 warps an SM; with 8 pairs x 4
//    offsets no instantiation spills (BATCH 32 spilled 40 bytes in
//    gplane0d, and ran gbeam1d slower). A primal base needs far fewer, so
//    the primal kinds have their own cap (P_MIN_BLOCKS blocks an SM).
//    ptxas's figures: chip_smoke.py [build].
//  * Shape and knobs (tools/sweep_variants.py times each): TQ, TILE_B,
//    SWEEP_U, RING, BATCH, CARRY, MIN_BLOCKS and the primal kinds' P_TQ,
//    P_MIN_BLOCKS, P_SWEEP_U, P_RING. Tried and dropped (PERF.md section
//    6): a batch's tails copied to shared memory first, the pairs on
//    reconnectable beams queued in a second ring, so that a batch takes
//    one branch, and a primal pair's base run in the lane that tested it,
//    with no queue; all three ran slower. For the primal kinds, two
//    queries tested a step against the same staged floats (plane0d 1.4%
//    faster, beam3d 4% slower), a shuffle tree for a batch whose pairs
//    are all one query's (no faster: such batches are few; primal_sums'
//    segmented scan serves every batch) and blocks of one or two warps
//    (slower).
//  * No wgmma and no TMA: the sweep has no matrix product, and the
//    accepted pairs are not rectangular tiles; staging a beam tile (8 KB)
//    is well under 1% of the work tested against it (TQ x TILE_B pairs),
//    so an asynchronous copy would hide next to nothing.
//
// Built with nvcc -fmad=false and without --use_fast_math, IEEE division
// and sqrtf, so the tests and the shifts decide as the plain PyTorch
// version does (exact counts, visits, shift_ok, ME keys).
#include <cuda_runtime.h>

#include "beam_eval.cuh"
#include "splits.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;

// launch shape (tools/sweep_variants.py substitutes these lines)
constexpr int WARPS = 4;         // warps a block
constexpr int TQ = 64;           // queries a block
constexpr int TILE_B = 128;      // beam rows a shared-memory tile
constexpr int BATCH = 8;         // pairs a shift batch: 8 or 32
constexpr int SWEEP_U = 2;       // 32-beam slots a sweep step
constexpr int RING = 128;        // a warp's queue, a power of two
constexpr int MIN_BLOCKS = 4;    // blocks an SM (__launch_bounds__)
constexpr bool CARRY = false;    // the base test's values ride in the ring
// the primal kinds' own (beam1d, beam3d, plane0d; their batch is 32
// pairs, one a lane): their query tile, register cap, sweep step and ring
constexpr int P_TQ = 128;        // queries a primal block
constexpr int P_MIN_BLOCKS = 6;  // primal blocks an SM (__launch_bounds__)
constexpr int P_SWEEP_U = 4;     // 32-beam slots a primal sweep step
constexpr int P_RING = 256;      // a primal warp's queue

static_assert(BATCH == 32 || BATCH == 8, "a batch is 32 or 8 pairs");

constexpr int BS = beam::BW + 1;              // staged beam row, odd

// a primal functor's staged floats a beam (a multiple of 4)
template <class F>
constexpr int staged_width() {
  if constexpr (F::PRIMAL)
    return F::SW;
  else
    return 4;
}

// A functor's shape: the gradient kinds' batch of BATCH pairs x 32 / BATCH
// lanes and their offset rows; a primal kind's batch of 32 pairs, one
// lane each, with no offsets and a query's 3 sums and 1 count.
template <class F>
struct Shape {
  static constexpr int tq = F::PRIMAL ? P_TQ : TQ;
  static constexpr int sw = staged_width<F>();
  static constexpr int batch = F::PRIMAL ? 32 : BATCH;
  static constexpr int sweep_u = F::PRIMAL ? P_SWEEP_U : SWEEP_U;
  static constexpr int ring = F::PRIMAL ? P_RING : RING;
  static constexpr int stride = 32 / batch;                // lanes a pair
  static constexpr int min_blocks = F::PRIMAL ? P_MIN_BLOCKS : MIN_BLOCKS;
  static constexpr int qs = beam::QW + (F::PRIMAL ? 0 : beam::XW) + 1;
  static constexpr int ncnt = F::PRIMAL ? 1 : 4;  // integer accumulators
  // a batch's terms: each pair's row, column c < NF_SUM the float sums,
  // then visits and (gradient) shift_ok, ME pairs, ME key as int bits
  static constexpr int t_visit = F::NF_SUM, t_rc = t_visit + 1,
                       t_mepairs = t_visit + 2, t_key = t_visit + 3;
  static constexpr int ncol = F::NF_SUM + ncnt;
  static constexpr int nt = ncol | 1;             // odd row stride
  static_assert((ring & (ring - 1)) == 0 &&
                    ring >= batch - 1 + 32 * sweep_u,
                "the ring holds a partial batch and one sweep step");
  static_assert(TILE_B % (32 * sweep_u) == 0, "whole sweep steps a tile");
  static_assert(tq <= 256 && tq % WARPS == 0, "a query in tile is a byte");
  static_assert(ncol <= 32, "a lane a column");
  static_assert(sw % 4 == 0, "whole float4s a staged row");
};

template <class F>
struct Tile {
  using S = Shape<F>;
  float q[S::tq * S::qs];      // query rows (gradient: then offset rows)
  // the beam tile: a gradient kind's rows; a primal kind's staged floats
  // (F::stage) in quarters of 4, read as 16-byte loads (consecutive
  // lanes, consecutive 16 bytes: no bank conflict)
  float b[F::PRIMAL ? 1 : TILE_B * BS];
  float4 b4[S::sw / 4][F::PRIMAL ? TILE_B : 1];
  float acc[S::tq * F::NF_SUM];
  int cnt[S::tq * S::ncnt];    // visits (gradient: shift_ok, ME key, pairs)
  float scale[WARPS][2];       // the tile's line scale (F::PRETEST)
  // a warp's ring: packed beam index, query in tile
  int ring_j[WARPS][S::ring];
  unsigned char ring_q[WARPS][S::ring];
  typename F::Geo ring_g[WARPS][CARRY ? S::ring : 1];
  // F::PRETEST: the queued pairs that passed the exact test (exact_batch)
  int ring2_j[WARPS][F::PRETEST ? S::ring : 1];
  unsigned char ring2_q[WARPS][F::PRETEST ? S::ring : 1];
  float terms[WARPS][32 * S::nt];   // a batch's terms
};

template <class F>
struct TermSink {
  using S = Shape<F>;
  float* row;    // this lane's pair's terms
  bool lead;     // the lane that writes its pair's base, visit and ME terms
  __device__ void base(int c, float v) {
    if (lead) row[c] = v;
  }
  __device__ void offset(int c, float v) { row[c] = v; }
  __device__ void visit(bool ok, bool me, int j) {
    if (!lead) return;
    row[S::t_visit] = __int_as_float(ok ? 1 : 0);
    if constexpr (F::ME) {
      row[S::t_mepairs] = __int_as_float(ok && me ? 1 : 0);
      row[S::t_key] = __int_as_float(ok && me ? j : beam::ME_NONE);
    }
  }
  __device__ void reconnected(int n) {
    if (S::stride > 1) {   // the pair's lanes: lane % batch, + batch, ...
      n += __shfl_xor_sync(FULL, n, 8);
      n += __shfl_xor_sync(FULL, n, 16);
    }
    if (lead) row[S::t_rc] = __int_as_float(n);
  }
};

// A primal batch's sums: pair k is lane k's (k < count). Each lane reads
// its pair's row; a segmented inclusive scan over the lanes (5 shuffle
// steps, a fixed tree order) sums each run of one query's pairs into the
// run's last lane, which adds it to that query's accumulators. A query
// that comes back later in the batch (from a later beam tile) has a run
// of its own; its runs are added in lane order, one a round. No atomics:
// two launches give the same bits. (The gradient kinds' column loop
// below, 4 lanes each adding 32 rows one after another, took 6 of
// plane0d's 25 ms; PERF.md section 6.)
template <class F>
__device__ __forceinline__ void primal_sums(Tile<F>& t, int lane,
                                            const float* terms,
                                            const unsigned char* ring_q,
                                            int first, int count) {
  using S = Shape<F>;
  const float* row = terms + lane * S::nt;
  const int qk = ring_q[(first + lane) & (S::ring - 1)];
  const int q_prev = __shfl_up_sync(FULL, qk, 1);
  const int q_next = __shfl_down_sync(FULL, qk, 1);
  int head = lane == 0 || q_prev != qk;   // a run starts at this lane
  bool pending = lane < count && (lane == count - 1 || q_next != qk);
  float x[F::NF_SUM];
  for (int c = 0; c < F::NF_SUM; ++c) x[c] = row[c];
  int n = __float_as_int(row[S::t_visit]);
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int h = __shfl_up_sync(FULL, head, d);
    const int m = __shfl_up_sync(FULL, n, d);
    float y[F::NF_SUM];
    for (int c = 0; c < F::NF_SUM; ++c) y[c] = __shfl_up_sync(FULL, x[c], d);
    if (lane >= d && !head) {
      for (int c = 0; c < F::NF_SUM; ++c) x[c] = y[c] + x[c];
      n += m;
      head = h;
    }
  }
  while (__any_sync(FULL, pending)) {
    // the lowest pending lane of each query adds its run this round
    const unsigned same = __match_any_sync(FULL, pending ? qk : 256 + lane);
    if (pending && (same & ((1u << lane) - 1)) == 0) {
      for (int c = 0; c < F::NF_SUM; ++c) t.acc[qk * F::NF_SUM + c] += x[c];
      t.cnt[qk * S::ncnt] += n;
      pending = false;
    }
  }
}

// The shifts of `count` (1..batch) pairs of the warp's ring from ring
// position `first`. Lane l takes pair l % batch and offsets l / batch,
// + stride, ... (a primal batch: pair l, its base alone); idle lanes of a
// partial batch repeat the first pair and write rows that nobody reads.
// Then a primal batch adds its runs (primal_sums); a gradient batch's
// lane c < ncol adds column c of the pairs' rows in order, one sum a run
// of pairs of one query, into that query's accumulator: a fixed order,
// no atomics, and a query that comes back later in the batch (from a
// later beam tile) simply opens a new run.
template <class F>
__device__ __forceinline__ void shift_batch(Tile<F>& t, int warp, int lane,
                                            const int* ring_j,
                                            const unsigned char* ring_q,
                                            int first, int count,
                                            const float4* __restrict__ brows,
                                            const int4* __restrict__ keys,
                                            const float4* __restrict__ tails,
                                            const beam::Params& p,
                                            long long q0) {
  using S = Shape<F>;
  const int k = lane % S::batch, grp = lane / S::batch;
  const int e = (first + (k < count ? k : 0)) & (S::ring - 1);
  const int j = ring_j[e];
  const int qi = ring_q[e];
  float* terms = t.terms[warp];
  TermSink<F> sink{terms + k * S::nt, grp == 0};
  // the pair's beam row (and beam3d's key row) to registers (16-byte
  // loads through L2); a gradient pair's tail is read where a shift uses
  // it
  float rb[beam::BW];
#pragma unroll
  for (int c = 0; c < beam::BW / 4; ++c) {
    const float4 v = __ldg(brows + (long long)j * (beam::BW / 4) + c);
    rb[4 * c] = v.x, rb[4 * c + 1] = v.y, rb[4 * c + 2] = v.z,
    rb[4 * c + 3] = v.w;
  }
  int kr[4] = {0, 0, 0, 0};
  if constexpr (F::RANDOM) {
    const int4 v = __ldg(keys + j);
    kr[0] = v.x, kr[1] = v.y, kr[2] = v.z;
  }
  const float* rt =
      F::PRIMAL ? nullptr
                : reinterpret_cast<const float*>(tails + (long long)j *
                                                             (beam::TW / 4));
  const float* qr = t.q + qi * S::qs;
  const beam::Query q = beam::load_query(qr, (uint32_t)(q0 + qi));
  typename F::Geo g;
  if constexpr (CARRY)
    g = t.ring_g[warp][e];
  else
    beam::test_row<F>(q, rb, p, g);   // true: the sweep queued this pair
  beam::pair_body<F, S::stride>(q, rb, kr, rt, qr + beam::QW, p, g, grp, j,
                                sink);
  __syncwarp();
  if constexpr (F::PRIMAL) {
    primal_sums<F>(t, lane, terms, ring_q, first, count);
  } else if (lane < S::ncol) {
    float sum = 0.0f;
    int n = 0, key = beam::ME_NONE;
    int cur = ring_q[first & (S::ring - 1)];
    auto add = [&](int qq) {
      int* c = t.cnt + qq * S::ncnt;
      if (lane < S::t_visit)
        t.acc[qq * F::NF_SUM + lane] += sum;
      else if (lane == S::t_visit || (!F::PRIMAL && lane == S::t_rc))
        c[lane - S::t_visit] += n;
      else if (F::ME && lane == S::t_mepairs)
        c[beam::C_ME] += n;
      else if (F::ME && key < c[beam::C_KEY])
        c[beam::C_KEY] = key;
    };
    for (int i = 0; i < count; ++i) {
      const int qq = ring_q[(first + i) & (S::ring - 1)];
      if (qq != cur) {
        add(cur);
        cur = qq, sum = 0.0f, n = 0, key = beam::ME_NONE;
      }
      const float v = terms[i * S::nt + lane];
      sum += v;
      n += __float_as_int(v);
      key = min(key, __float_as_int(v));
    }
    add(cur);
  }
  __syncwarp();
}

// F::PRETEST (beam1d): the exact test of `count` (1..32) pairs of the
// warp's ring from position `first`, a pair a lane (its beam row's test
// floats through L2); the pairs that pass go on, in ring order, into the
// warp's second ring at hi2, whose batches shift_batch runs. So a batch's
// contribution and its term-buffer sums are paid for the accepted pairs
// only, not for every pair the pre-test let through.
template <class F>
__device__ __forceinline__ void exact_batch(Tile<F>& t, int warp, int lane,
                                            int first, int count,
                                            const float4* __restrict__ brows,
                                            const beam::Params& p,
                                            long long q0, int& hi2) {
  using S = Shape<F>;
  const int e = (first + (lane < count ? lane : 0)) & (S::ring - 1);
  const int j = t.ring_j[warp][e];
  const int qi = t.ring_q[warp][e];
  float rb[8];   // o, d, length, medium
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const float4 v = __ldg(brows + (long long)j * (beam::BW / 4) + c);
    rb[4 * c] = v.x, rb[4 * c + 1] = v.y, rb[4 * c + 2] = v.z,
    rb[4 * c + 3] = v.w;
  }
  const beam::Query q =
      beam::load_query(t.q + qi * S::qs, (uint32_t)(q0 + qi));
  beam::Closest h;
  const bool ok = F::exact(q, rb, p, h) & (lane < count);
  const unsigned hit = __ballot_sync(FULL, ok);
  if (ok) {
    const int at = (hi2 + __popc(hit & ((1u << lane) - 1))) & (S::ring - 1);
    t.ring2_j[warp][at] = j;
    t.ring2_q[warp][at] = (unsigned char)qi;
  }
  hi2 += __popc(hit);
  __syncwarp();
}

template <class F>
__global__ void __launch_bounds__(WARPS * 32, Shape<F>::min_blocks)
    gsweep_kernel(const float* __restrict__ qrows, long long M,
                  const float4* __restrict__ brows,
                  const int4* __restrict__ keys,
                  const float4* __restrict__ tails,
                  const float* __restrict__ qext, long long N,
                  beam::Params p, long long chunk, float* __restrict__ part,
                  int* __restrict__ part_cnt) {
  using S = Shape<F>;
  constexpr int QX = S::qs - 1;   // a query's staged floats
  extern __shared__ float4 smem[];
  Tile<F>& t = *reinterpret_cast<Tile<F>*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long q0 = (long long)blockIdx.x * S::tq;
  const int nq = (int)min((long long)S::tq, M - q0);
  const long long s = blockIdx.y;
  const long long j0 = s * chunk, j1 = min(N, j0 + chunk);

  // ---- stage the query tile, zero its accumulators
  bool mine_valid = false;
  for (int i = threadIdx.x; i < S::tq * QX; i += blockDim.x) {
    const int qq = i / QX;
    const int c = i - qq * QX;
    float v = 0.0f;
    if (qq < nq)
      v = c < beam::QW ? qrows[(q0 + qq) * beam::QW + c]
                       : qext[(q0 + qq) * beam::XW + c - beam::QW];
    t.q[qq * S::qs + c] = v;
    mine_valid |= c == beam::Q_VALID && v > 0.5f;
  }
  for (int i = threadIdx.x; i < S::tq * F::NF_SUM; i += blockDim.x)
    t.acc[i] = 0.0f;
  for (int i = threadIdx.x; i < S::tq * S::ncnt; i += blockDim.x)
    t.cnt[i] = F::ME && (i & 3) == beam::C_KEY ? beam::ME_NONE : 0;
  const bool any_valid = __syncthreads_or(mine_valid);

  // ---- sweep the beam tiles, queue, shift
  int lo = 0, hi = 0;   // the warp's ring: [lo, hi)
  int lo2 = 0, hi2 = 0; // F::PRETEST: its second ring
  for (long long t0 = j0; any_valid && t0 < j1; t0 += TILE_B) {
    const int n = (int)min((long long)TILE_B, j1 - t0);
    __syncthreads();
    float so = 0.0f, sl = 0.0f;   // F::PRETEST: max |ob|_inf, max |lb|
    if constexpr (F::PRIMAL) {
      // a thread a row: its staged floats and its line scale
      for (int jj = threadIdx.x; jj < n; jj += blockDim.x) {
        float r[beam::BW], st[S::sw];
#pragma unroll
        for (int c = 0; c < beam::BW / 4; ++c) {
          const float4 v = brows[(t0 + jj) * (beam::BW / 4) + c];
          r[4 * c] = v.x, r[4 * c + 1] = v.y, r[4 * c + 2] = v.z,
          r[4 * c + 3] = v.w;
        }
        F::stage(r, st);
#pragma unroll
        for (int c = 0; c < S::sw / 4; ++c)
          t.b4[c][jj] = make_float4(st[4 * c], st[4 * c + 1], st[4 * c + 2],
                                    st[4 * c + 3]);
        if constexpr (F::PRETEST) {
          so = beam::maximum_(so,
                              beam::line_scale(beam::ld3(r, beam::B_O), 0.0f));
          sl = beam::maximum_(sl, fabsf(r[beam::B_LEN]));
        }
      }
    } else {
      for (int i = threadIdx.x; i < n * (beam::BW / 4); i += blockDim.x) {
        const float4 v = brows[t0 * (beam::BW / 4) + i];
        float* d = t.b + (i >> 2) * BS + 4 * (i & 3);
        d[0] = v.x, d[1] = v.y, d[2] = v.z, d[3] = v.w;
      }
    }
    if constexpr (F::PRETEST) {   // non-negative or NaN: max of the bits
      so = __uint_as_float(__reduce_max_sync(FULL, __float_as_uint(so)));
      sl = __uint_as_float(__reduce_max_sync(FULL, __float_as_uint(sl)));
      if (lane == 0) t.scale[warp][0] = so, t.scale[warp][1] = sl;
    }
    __syncthreads();
    float tile_scale = 0.0f;
    if constexpr (F::PRETEST) {
      so = sl = 0.0f;
      for (int w = 0; w < WARPS; ++w)
        so = beam::maximum_(so, t.scale[w][0]),
        sl = beam::maximum_(sl, t.scale[w][1]);
      tile_scale = so + sl;
    }
    for (int qi = warp; qi < nq; qi += WARPS) {
      const float* qr = t.q + qi * S::qs;
      if (!(qr[beam::Q_VALID] > 0.5f)) continue;   // uniform in the warp
      const beam::Query q = beam::load_query(qr, (uint32_t)(q0 + qi));
      beam::Params pq = p;
      if constexpr (F::PRETEST)
        pq.pre_r2 = beam::pre_r2(p.r2, beam::line_scale(q.o, q.len) +
                                           tile_scale);
      for (int u = 0; u < n; u += 32 * S::sweep_u) {
        // sweep_u independent tests a lane, then their queue entries in
        // beam order
        typename F::Geo g[S::sweep_u];
        bool pass[S::sweep_u];
        if constexpr (F::PRIMAL) {
          float rb[S::sweep_u][S::sw];
#pragma unroll
          for (int v = 0; v < S::sweep_u; ++v) {
            const int jj = min(u + 32 * v + lane, n - 1);
#pragma unroll
            for (int c = 0; c < S::sw / 4; ++c) {
              const float4 h = t.b4[c][jj];
              rb[v][4 * c] = h.x, rb[v][4 * c + 1] = h.y,
              rb[v][4 * c + 2] = h.z, rb[v][4 * c + 3] = h.w;
            }
          }
          F::template test_u<S::sweep_u>(q, rb, pq, g, pass);
        } else {
#pragma unroll
          for (int v = 0; v < S::sweep_u; ++v) {
            const int jj = min(u + 32 * v + lane, n - 1);
            pass[v] = F::test(q, t.b + jj * BS, pq, g[v]);
          }
        }
#pragma unroll
        for (int v = 0; v < S::sweep_u; ++v)
          pass[v] &= u + 32 * v + lane < n;
#pragma unroll
        for (int v = 0; v < S::sweep_u; ++v) {
          const unsigned hit = __ballot_sync(FULL, pass[v]);
          if (F::PRIMAL && hit == 0) continue;   // uniform: nothing to push
          if (pass[v]) {
            const int at =
                (hi + __popc(hit & ((1u << lane) - 1))) & (S::ring - 1);
            t.ring_j[warp][at] = (int)(t0 + u + 32 * v + lane);
            t.ring_q[warp][at] = (unsigned char)qi;
            if constexpr (CARRY) t.ring_g[warp][at] = g[v];
          }
          hi += __popc(hit);
        }
        __syncwarp();
#pragma unroll 1
        while (hi - lo >= S::batch) {
          if constexpr (F::PRETEST) {
            exact_batch<F>(t, warp, lane, lo, S::batch, brows, p, q0, hi2);
#pragma unroll 1
            while (hi2 - lo2 >= S::batch) {
              shift_batch<F>(t, warp, lane, t.ring2_j[warp], t.ring2_q[warp],
                             lo2, S::batch, brows, keys, tails, p, q0);
              lo2 += S::batch;
            }
          } else {
            shift_batch<F>(t, warp, lane, t.ring_j[warp], t.ring_q[warp], lo,
                           S::batch, brows, keys, tails, p, q0);
          }
          lo += S::batch;
        }
      }
    }
  }
#pragma unroll 1
  while (hi > lo) {    // the block's last, partial batch
    const int count = min(S::batch, hi - lo);
    if constexpr (F::PRETEST)
      exact_batch<F>(t, warp, lane, lo, count, brows, p, q0, hi2);
    else
      shift_batch<F>(t, warp, lane, t.ring_j[warp], t.ring_q[warp], lo,
                     count, brows, keys, tails, p, q0);
    lo += count;
  }
#pragma unroll 1
  while (hi2 > lo2) {  // F::PRETEST: the second ring's last batches
    const int count = min(S::batch, hi2 - lo2);
    shift_batch<F>(t, warp, lane, t.ring2_j[warp], t.ring2_q[warp], lo2,
                   count, brows, keys, tails, p, q0);
    lo2 += count;
  }
  __syncthreads();

  // ---- write the tile's partial sums of this split
  for (int i = threadIdx.x; i < nq * F::NF_SUM; i += blockDim.x)
    part[(s * M + q0) * F::NF_SUM + i] = t.acc[i];
  for (int i = threadIdx.x; i < nq * F::NC; i += blockDim.x) {
    const int qq = i / F::NC, c = i - qq * F::NC;
    part_cnt[(s * M + q0) * F::NC + i] = t.cnt[qq * S::ncnt + c];
  }
}

// gbeam3d_me's epilogue: one thread a query writes the chord point of
// its final ME key (zeros without one) into out[NF_SUM .. NF_SUM + 2]
template <class F>
__global__ void key_points(const float* __restrict__ qrows, long long M,
                           const float4* __restrict__ brows,
                           const int4* __restrict__ keys, beam::Params p,
                           float* __restrict__ out,
                           const int* __restrict__ cnt) {
  const long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const int j = cnt[m * F::NC + beam::C_KEY];
  beam::V3 y = {0.0f, 0.0f, 0.0f};
  if (j != beam::ME_NONE) {
    float rb[beam::BW];
    for (int c = 0; c < beam::BW / 4; ++c) {
      const float4 v = brows[(long long)j * (beam::BW / 4) + c];
      rb[4 * c] = v.x, rb[4 * c + 1] = v.y, rb[4 * c + 2] = v.z,
      rb[4 * c + 3] = v.w;
    }
    const int4 k = keys[j];
    const int key[4] = {k.x, k.y, k.z, k.w};
    y = F::point(beam::load_query(qrows + m * beam::QW, (uint32_t)m), rb,
                 key, p);
  }
  float* o = out + m * F::NF + F::NF_SUM;
  o[0] = y.x, o[1] = y.y, o[2] = y.z;
}

template <class F>
int launch(const float* q, long long M, const float* rows, const int* keys,
           const float* tails, const float* qext, long long N, int tile,
           float r2, float k, int splits, long long chunk, float* part,
           int* part_cnt, float* out, int* cnt, cudaStream_t stream) {
  static_assert(F::PRIMAL ? F::NF_SUM == 3 && F::NC == 1
                          : F::NF_SUM == beam::NF_GRAD && F::NC <= 4,
                "a primal or a gradient functor");
  const int smem = (int)sizeof(Tile<F>);
  cudaError_t err = cudaFuncSetAttribute(
      gsweep_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const beam::Params p{r2, k, (uint32_t)tile};
  constexpr int tq = Shape<F>::tq;
  const dim3 grid((unsigned)((M + tq - 1) / tq), (unsigned)splits);
  gsweep_kernel<F><<<grid, WARPS * 32, smem, stream>>>(
      q, M, reinterpret_cast<const float4*>(rows),
      reinterpret_cast<const int4*>(keys),
      reinterpret_cast<const float4*>(tails), qext, N, p, chunk, part,
      part_cnt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long items = M * (F::NF_SUM + F::NC);
  beam::reduce_splits<F><<<(unsigned)((items + 255) / 256), 256, 0, stream>>>(
      part, part_cnt, splits, M, out, cnt);
  if constexpr (F::NF > F::NF_SUM) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    key_points<F><<<(unsigned)((M + 127) / 128), 128, 0, stream>>>(
        q, M, reinterpret_cast<const float4*>(rows),
        reinterpret_cast<const int4*>(keys), p, out, cnt);
  }
  return (int)cudaGetLastError();
}

// blocks of the sweep kernel an SM holds at once (registers, shared
// memory and __launch_bounds__ together)
template <class F>
int blocks_per_sm(int* blocks) {
  const int smem = (int)sizeof(Tile<F>);
  cudaError_t err = cudaFuncSetAttribute(
      gsweep_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, gsweep_kernel<F>, WARPS * 32, smem);
}

}  // namespace

// the launch shape, for the wrapper's split plan and the lane-use tally
extern "C" void gvpm_gsweep_shape(int* out) {
  const int shape[] = {TQ,   WARPS,        TILE_B,    BATCH,
                       RING, MIN_BLOCKS,   CARRY,     SWEEP_U,
                       P_TQ, P_MIN_BLOCKS, P_SWEEP_U, P_RING};
  for (int i = 0; i < 12; ++i) out[i] = shape[i];
}

// each kind's entry (one C interface for all) and its blocks an SM
#define GSWEEP_ENTRY(NAME, F)                                                \
  extern "C" int gvpm_beam_sweep_##NAME(                                     \
      const float* q, long long M, const float* rows, const int* keys,       \
      const float* tails, const float* qext, long long N, int tile,          \
      float r2, float k, int splits, long long chunk, float* part,           \
      int* part_cnt, float* out, int* cnt, cudaStream_t stream) {            \
    return launch<F>(q, M, rows, keys, tails, qext, N, tile, r2, k, splits,  \
                     chunk, part, part_cnt, out, cnt, stream);               \
  }                                                                          \
  extern "C" int gvpm_gsweep_blocks_per_sm_##NAME(int* blocks) {             \
    return blocks_per_sm<F>(blocks);                                         \
  }

GSWEEP_ENTRY(beam1d, beam::Beam1D)
GSWEEP_ENTRY(beam3d, beam::Beam3D)
GSWEEP_ENTRY(plane0d, beam::Plane0D)
GSWEEP_ENTRY(gbeam1d, beam::GBeam1D)
GSWEEP_ENTRY(gbeam3d, beam::GBeam3D)
GSWEEP_ENTRY(gplane0d, beam::GPlane0D)
GSWEEP_ENTRY(gbeam1d_me, beam::GBeam1DME)
GSWEEP_ENTRY(gbeam3d_me, beam::GBeam3DME)
GSWEEP_ENTRY(gplane0d_me, beam::GPlane0DME)
