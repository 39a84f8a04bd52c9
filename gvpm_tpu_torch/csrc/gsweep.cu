// The queued gradient sweeps for Hopper (sm_90a): gbeam1d, gbeam3d and
// gplane0d, each with and without the manifold (ME) outputs
// (ops/beam_sweep.py gsweep kinds gbeam1d, gbeam3d, gplane0d and their
// _me kinds; per-pair math in beam_eval.cuh's GBeam1DT / GBeam3DT /
// GPlane0DT, split into test, base and shift parts).
//
// What it replaces: the XLA tile loops (lax.scan over every beam slot)
// of gvpm_tpu/integrators/gradient_gather.py:1232 beam_gradient_gather,
// :1580 beam3d_gradient_gather and :1960 plane_gradient_gather, and
// with use_manifold=True their ME pair collection (:1346-1355,
// :1710-1720, :2091-2100). The TPU has no kernel for them; on this card
// they first ran on beam_sweep.cu's one thread a query, which now serves
// the primal sweeps only.
//
// What it computes: every camera query (a row of pack_queries, and its
// four offset rays, pack_offsets) against every packed beam or plane
// (pack_beams, its gradient tail, pack_tails, and for gbeam3d its
// beam_keys row): the base test; for the pairs that pass, the base term
// and the four shifts with pairwise MIS. Per query: base 3, S 4 x 3, W
// 4 x 3, visits, shift_ok, and with ME the lowest packed index of an
// ME-eligible accepted beam (ME_NONE if none) and the count of such
// pairs; gbeam3d_me also that pair's chord point.
//
// What bounds it: operations (chip_smoke.py::gbeam_bound: 3.3 ms for
// gbeam1d, 1.5 for gbeam3d, 6.9 for gplane0d). On one gvpm 128^2
// check-config pass (32,768 segment queries, 16,219 valid; 291,814
// beams; 4.73e9 pairs in one medium) gbeam1d accepts 38.0 M pairs
// (0.80%), gbeam3d 1.87 M (0.04%) and gplane0d 224.3 M (4.7%); an
// accepted pair costs about 1,000 (gbeam1d), 600 (gbeam3d) or 1,600
// (gplane0d) counted float operations, a rejected one 36, 21 or 23
// (gbeam3d's chord test, its clip only near the beam's line; a pair past
// it also draws one threefry word, 123 integer operations). One thread a
// query (beam_sweep.cu, before this kernel) ran the shifts inside its
// beam loop with 11.9% (gbeam1d), 3.8% (gbeam3d) and 35.8% (gplane0d)
// of the 32 lanes busy in the iterations where some lane accepted
// (chip_smoke.py::gsweep_lane_use), held 27 sums a thread in 148-168
// registers (12 warps an SM), and took 165-167, 36.2 and 243-250 ms,
// 2-6% of the bound. This kernel takes 32.8, 15.1 and 85.5 ms (10.0%,
// 9.9% and 8.0%) (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
//
// Design: test densely, queue, shift 8 pairs x 4 offsets at a time.
//  * A block owns a tile of TQ queries; WARPS warps share it, warp w the
//    queries w, w + WARPS, .... The tile's query and offset rows (QW + XW
//    floats, at an odd stride), 27 float and 4 integer accumulators a
//    query live in shared memory: nothing accumulates in registers.
//  * Sweep: the beam rows stream through shared memory in tiles of
//    TILE_B (16 floats at an odd stride: the 32 lanes' consecutive rows
//    hit 32 banks). A warp takes one of its queries, holds it in
//    registers (the whole warp shares it), and its 32 lanes test 32 x
//    SWEEP_U beams a step (SWEEP_U independent tests a lane, written
//    without early returns, so that their latencies overlap) with the
//    functor's test alone (gbeam3d's: the chord test, without its
//    threefry word). Invalid queries cost nothing (the warp
//    skips them; one thread a query kept their lanes idle), and a block
//    with no valid query stages no beam.
//  * Queue: passing pairs go into the warp's ring in shared memory
//    (ballot + popcount) as (query in tile, packed beam index). Whenever
//    the ring holds BATCH pairs the warp runs them: lane l takes pair
//    l % 8 and offset l / 8 (BATCH 32: pair l and its four offsets),
//    recomputes the pair's test from its beam row (CARRY: the test's
//    values ride in the ring instead), runs its base (gbeam3d: the
//    chord sample's threefry word from the beam's key row, read through
//    L2 beside the row; the sample's in-sphere test, which rejects a
//    queued pair only by rounding at a chord's end), and loads the parent
//    from the beam's gradient tail only in its reconnection branch, from
//    device memory through L2: the 30 parent values are live in one
//    shift, not across four. Because a batch reads no staged beam, the
//    ring lives on across beam tiles, and only a block's last batch is
//    partial (99.9% of the lanes busy in a batch on these inputs, against
//    82.6% (gbeam1d) and 96.5% (gplane0d) if the ring were emptied at
//    each tile's end, as a design that staged the tails with the rows
//    would have to).
//  * Reduction: each lane writes its pair's terms (base 3, S_i and W_i 6
//    an offset, visit, reconnections, ME pair and key) into the pair's
//    row of the warp's term buffer; then lane c adds column c of the
//    batch's rows in ring order, one sum a run of pairs of one query,
//    into that query's accumulator in shared memory. The ring is filled
//    query by query, so runs are long; a query that comes back later in
//    the batch (from a later beam tile) opens a new run. No atomics:
//    every sum has a fixed order and two launches on the same inputs
//    give the same bits. Segmented shuffles, one reduction a term as in
//    fused_gather.cu, would cost 27 x 5 shuffles a pair; here a lane
//    spends about one shared load and three adds a pair.
//  * Filling the card: blocks of TQ queries, the beam range split into
//    whole tiles over blockIdx.y (ops/beam_sweep.gsplit_plan, about 4,000
//    blocks, a function of the shapes), the splits added in order by
//    reduce_splits (splits.cuh); the ME key is a min over the splits.
//  * gbeam3d_me's chord point: the term buffer has no room for three
//    more floats a pair, and the key is a min over runs and splits, so
//    after reduce_splits one thread a query recomputes the point of its
//    final key with the batch's own code (key_points, GBeam3DT::point):
//    bit-equal by construction. The beam keys are not staged with the
//    rows: the sweep's test does not read them, and a batch's pairs come
//    from any tile the ring has seen.
//  * Registers: __launch_bounds__(WARPS * 32, MIN_BLOCKS) caps a thread
//    at 128 registers, 16 warps an SM; with 8 pairs x 4 offsets no
//    instantiation spills (BATCH 32 spilled 40 bytes in gplane0d, and
//    ran gbeam1d slower). ptxas's figures: chip_smoke.py [build].
//  * Shape and knobs (tools/sweep_variants.py times each): TQ, TILE_B,
//    SWEEP_U, RING, BATCH, CARRY, MIN_BLOCKS. Tried and dropped (PERF.md
//    section 6): a batch's tails copied to shared memory first, and the
//    pairs on reconnectable beams queued in a second ring, so that a
//    batch takes one branch; both ran slower.
//  * No wgmma and no TMA: no matrix product, and the accepted pairs are
//    not rectangular tiles.
//
// Built with nvcc -fmad=false and without --use_fast_math, IEEE division
// and sqrtf, so the base test and the shifts decide as the plain PyTorch
// version does (exact visits, shift_ok, ME keys and counts).
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

constexpr int QS = beam::QW + beam::XW + 1;   // staged query row, odd
constexpr int BS = beam::BW + 1;              // staged beam row, odd
constexpr int STRIDE = 32 / BATCH;            // lanes a pair
static_assert(BATCH == 32 || BATCH == 8, "a batch is 32 or 8 pairs");
static_assert((RING & (RING - 1)) == 0 && RING >= BATCH - 1 + 32 * SWEEP_U,
              "the ring holds a partial batch and one sweep step");
static_assert(TQ <= 256 && TILE_B % (32 * SWEEP_U) == 0 && TQ % WARPS == 0,
              "a query in tile is a byte");

template <class F>
struct Tile {
  float q[TQ * QS];            // query rows, then their offset rows
  float b[TILE_B * BS];        // the beam tile's rows
  float acc[TQ * beam::NF_GRAD];
  int cnt[TQ * 4];             // visits, shift_ok, ME key, ME pairs
  // a warp's ring: packed beam index, query in tile
  int ring_j[WARPS][RING];
  unsigned char ring_q[WARPS][RING];
  typename F::Geo ring_g[WARPS][CARRY ? RING : 1];
  float terms[WARPS][32 * (beam::NF_GRAD + 4)];   // a batch's terms
};

// A batch's terms: each pair's NT values in its row of the warp's term
// buffer, written by the lanes that compute them (column c < 27 the
// float sums, then visits, shift_ok, ME pairs and ME key as int bits).
constexpr int T_VISIT = beam::NF_GRAD, T_RC = T_VISIT + 1,
              T_MEPAIRS = T_VISIT + 2, T_KEY = T_VISIT + 3, NT = T_VISIT + 4;
static_assert(NT % 2 == 1 && NT <= 32, "odd row stride: no bank conflicts");

struct TermSink {
  float* row;    // this lane's pair's terms
  bool lead;     // the lane that writes its pair's base, visit and ME terms
  __device__ void base(int c, float v) {
    if (lead) row[c] = v;
  }
  __device__ void offset(int c, float v) { row[c] = v; }
  __device__ void visit(bool ok, bool me, int j) {
    if (!lead) return;
    row[T_VISIT] = __int_as_float(ok ? 1 : 0);
    row[T_MEPAIRS] = __int_as_float(ok && me ? 1 : 0);
    row[T_KEY] = __int_as_float(ok && me ? j : beam::ME_NONE);
  }
  __device__ void reconnected(int n) {
    if (STRIDE > 1) {   // the pair's lanes: lane % BATCH, + BATCH, ...
      n += __shfl_xor_sync(FULL, n, 8);
      n += __shfl_xor_sync(FULL, n, 16);
    }
    if (lead) row[T_RC] = __int_as_float(n);
  }
};

// The shifts of `count` (1..BATCH) pairs of the warp's ring from ring
// position `first`. Lane l takes pair l % BATCH and offsets l / BATCH,
// + STRIDE, ...; idle lanes of a partial batch repeat the first pair and
// write rows that nobody reads. Then lane c < NT adds column c of the
// pairs' rows in order, one sum a run of pairs of one query, into that
// query's accumulator: a fixed order, no atomics, and a query that comes
// back later in the batch (from a later beam tile) simply opens a new
// run.
template <class F>
__device__ __forceinline__ void shift_batch(Tile<F>& t, int warp, int lane,
                                            int first, int count,
                                            const float4* __restrict__ brows,
                                            const int4* __restrict__ keys,
                                            const float4* __restrict__ tails,
                                            const beam::Params& p,
                                            long long q0) {
  const int k = lane % BATCH, grp = lane / BATCH;
  const int e = (first + (k < count ? k : 0)) & (RING - 1);
  const int j = t.ring_j[warp][e];
  const int qi = t.ring_q[warp][e];
  float* terms = t.terms[warp];
  TermSink sink{terms + k * NT, grp == 0};
  // the pair's beam row (and gbeam3d's key row) to registers (16-byte
  // loads through L2); its tail is read where a shift uses it
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
      reinterpret_cast<const float*>(tails + (long long)j * (beam::TW / 4));
  const float* qr = t.q + qi * QS;
  const beam::Query q = beam::load_query(qr, (uint32_t)(q0 + qi));
  typename F::Geo g;
  if constexpr (CARRY)
    g = t.ring_g[warp][e];
  else
    F::test(q, rb, p, g);   // true: the sweep queued this pair
  beam::pair_body<F, STRIDE>(q, rb, kr, rt, qr + beam::QW, p, g, grp, j,
                             sink);
  __syncwarp();
  if (lane < NT) {
    float sum = 0.0f;
    int n = 0, key = beam::ME_NONE;
    int cur = t.ring_q[warp][first & (RING - 1)];
    auto add = [&](int qq) {
      if (lane < T_VISIT)
        t.acc[qq * beam::NF_GRAD + lane] += sum;
      else if (lane == T_VISIT || lane == T_RC)
        t.cnt[qq * 4 + lane - T_VISIT] += n;
      else if (F::ME && lane == T_MEPAIRS)
        t.cnt[qq * 4 + beam::C_ME] += n;
      else if (F::ME && key < t.cnt[qq * 4 + beam::C_KEY])
        t.cnt[qq * 4 + beam::C_KEY] = key;
    };
    for (int i = 0; i < count; ++i) {
      const int qq = t.ring_q[warp][(first + i) & (RING - 1)];
      if (qq != cur) {
        add(cur);
        cur = qq, sum = 0.0f, n = 0, key = beam::ME_NONE;
      }
      const float v = terms[i * NT + lane];
      sum += v;
      n += __float_as_int(v);
      key = min(key, __float_as_int(v));
    }
    add(cur);
  }
  __syncwarp();
}

template <class F>
__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS)
    gsweep_kernel(const float* __restrict__ qrows, long long M,
                  const float4* __restrict__ brows,
                  const int4* __restrict__ keys,
                  const float4* __restrict__ tails,
                  const float* __restrict__ qext, long long N,
                  beam::Params p, long long chunk, float* __restrict__ part,
                  int* __restrict__ part_cnt) {
  extern __shared__ float4 smem[];
  Tile<F>& t = *reinterpret_cast<Tile<F>*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long q0 = (long long)blockIdx.x * TQ;
  const int nq = (int)min((long long)TQ, M - q0);
  const long long s = blockIdx.y;
  const long long j0 = s * chunk, j1 = min(N, j0 + chunk);

  // ---- stage the query tile, zero its accumulators
  bool mine_valid = false;
  for (int i = threadIdx.x; i < TQ * (beam::QW + beam::XW);
       i += blockDim.x) {
    const int qq = i / (beam::QW + beam::XW);
    const int c = i - qq * (beam::QW + beam::XW);
    float v = 0.0f;
    if (qq < nq)
      v = c < beam::QW ? qrows[(q0 + qq) * beam::QW + c]
                       : qext[(q0 + qq) * beam::XW + c - beam::QW];
    t.q[qq * QS + c] = v;
    mine_valid |= c == beam::Q_VALID && v > 0.5f;
  }
  for (int i = threadIdx.x; i < TQ * beam::NF_GRAD; i += blockDim.x)
    t.acc[i] = 0.0f;
  for (int i = threadIdx.x; i < TQ * 4; i += blockDim.x)
    t.cnt[i] = F::ME && (i & 3) == beam::C_KEY ? beam::ME_NONE : 0;
  const bool any_valid = __syncthreads_or(mine_valid);

  // ---- sweep the beam tiles, queue, shift
  int lo = 0, hi = 0;   // the warp's ring: [lo, hi)
  for (long long t0 = j0; any_valid && t0 < j1; t0 += TILE_B) {
    const int n = (int)min((long long)TILE_B, j1 - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < n * (beam::BW / 4); i += blockDim.x) {
      const float4 v = brows[t0 * (beam::BW / 4) + i];
      float* d = t.b + (i >> 2) * BS + 4 * (i & 3);
      d[0] = v.x, d[1] = v.y, d[2] = v.z, d[3] = v.w;
    }
    __syncthreads();
    for (int qi = warp; qi < nq; qi += WARPS) {
      const float* qr = t.q + qi * QS;
      if (!(qr[beam::Q_VALID] > 0.5f)) continue;   // uniform in the warp
      const beam::Query q = beam::load_query(qr, (uint32_t)(q0 + qi));
      for (int u = 0; u < n; u += 32 * SWEEP_U) {
        // SWEEP_U independent tests a lane, then their queue entries in
        // beam order
        typename F::Geo g[SWEEP_U];
        bool pass[SWEEP_U];
#pragma unroll
        for (int v = 0; v < SWEEP_U; ++v) {
          const int jj = min(u + 32 * v + lane, n - 1);
          pass[v] = F::test(q, t.b + jj * BS, p, g[v]) &
                    (u + 32 * v + lane < n);
        }
#pragma unroll
        for (int v = 0; v < SWEEP_U; ++v) {
          const unsigned hit = __ballot_sync(FULL, pass[v]);
          if (pass[v]) {
            const int at = (hi + __popc(hit & ((1u << lane) - 1))) & (RING - 1);
            t.ring_j[warp][at] = (int)(t0 + u + 32 * v + lane);
            t.ring_q[warp][at] = (unsigned char)qi;
            if constexpr (CARRY) t.ring_g[warp][at] = g[v];
          }
          hi += __popc(hit);
        }
        __syncwarp();
#pragma unroll 1
        while (hi - lo >= BATCH) {
          shift_batch<F>(t, warp, lane, lo, BATCH, brows, keys, tails, p,
                         q0);
          lo += BATCH;
        }
      }
    }
  }
#pragma unroll 1
  while (hi > lo) {    // the block's last, partial batch
    const int count = min(BATCH, hi - lo);
    shift_batch<F>(t, warp, lane, lo, count, brows, keys, tails, p, q0);
    lo += count;
  }
  __syncthreads();

  // ---- write the tile's partial sums of this split
  for (int i = threadIdx.x; i < nq * F::NF_SUM; i += blockDim.x)
    part[(s * M + q0) * F::NF_SUM + i] = t.acc[i];
  for (int i = threadIdx.x; i < nq * F::NC; i += blockDim.x) {
    const int qq = i / F::NC, c = i - qq * F::NC;
    part_cnt[(s * M + q0) * F::NC + i] = t.cnt[qq * 4 + c];
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
  static_assert(F::NF_SUM == beam::NF_GRAD && F::NC <= 4,
                "a gradient functor");
  const int smem = (int)sizeof(Tile<F>);
  cudaError_t err = cudaFuncSetAttribute(
      gsweep_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const beam::Params p{r2, k, (uint32_t)tile};
  const dim3 grid((unsigned)((M + TQ - 1) / TQ), (unsigned)splits);
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

}  // namespace

// the launch shape, for the wrapper's split plan and the lane-use tally
extern "C" void gvpm_gsweep_shape(int* out) {
  const int shape[] = {TQ, WARPS, TILE_B, BATCH, RING, MIN_BLOCKS, CARRY,
                       SWEEP_U};
  for (int i = 0; i < 8; ++i) out[i] = shape[i];
}

// the same C interface as beam_sweep.cu's entries
#define GSWEEP_ENTRY(NAME, F)                                                \
  extern "C" int gvpm_beam_sweep_##NAME(                                     \
      const float* q, long long M, const float* rows, const int* keys,       \
      const float* tails, const float* qext, long long N, int tile,          \
      float r2, float k, int splits, long long chunk, float* part,           \
      int* part_cnt, float* out, int* cnt, cudaStream_t stream) {            \
    return launch<F>(q, M, rows, keys, tails, qext, N, tile, r2, k, splits,  \
                     chunk, part, part_cnt, out, cnt, stream);               \
  }

GSWEEP_ENTRY(gbeam1d, beam::GBeam1D)
GSWEEP_ENTRY(gbeam3d, beam::GBeam3D)
GSWEEP_ENTRY(gplane0d, beam::GPlane0D)
GSWEEP_ENTRY(gbeam1d_me, beam::GBeam1DME)
GSWEEP_ENTRY(gbeam3d_me, beam::GBeam3DME)
GSWEEP_ENTRY(gplane0d_me, beam::GPlane0DME)
