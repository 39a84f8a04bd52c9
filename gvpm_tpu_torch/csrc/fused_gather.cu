// Fused photon gather for Hopper (sm_90a): the CUDA counterpart of the
// TPU kernel gvpm_tpu/ops/pallas_gather.py::_kernel with its two eval
// bodies, gvpm_tpu/integrators/gradient_gather.py::_volume_eval_pallas
// (VolumeEval) and ::_surface_eval_pallas (SurfaceEval), each with and
// without the manifold (ME) outputs (`me=True` / `me=False` there).
//
// What it computes: for each query (a camera-medium distance sample or
// a surface gather point), sorted by 27-stencil anchor cell, every photon
// row in its nine exact cell runs [r0, r1) goes through the ball test,
// the base kernel term and four diffuse-reconnection shifts with
// pairwise MIS (gather_eval.cuh). Output per query, in sorted order:
// primal 3, S 4x3, W 4x3, visits, shift_ok, dropped (always 0: the runs
// are exact, there is no window to clip).
//
// The ME instantiations also report, per query, the lowest absolute row
// of an ME-eligible pair inside the ball (the pair the host then shifts
// with a Newton manifold solve), as an int32 key in a tensor of its own:
// ME_NONE where the query has no such pair. The TPU kernel packs that
// key as an f32 column, exact only below 2^24 rows; an int key has no
// such limit. The TPU kernel's second ME column, the window scale of
// that pair, is identically 1 with exact runs, so the host uses 1 and no
// such output exists here. The no-ME instantiations contain none of
// this (the ME code is under `if constexpr`).
//
// What bounds it: instruction rate and cache traffic, not device-memory
// bytes (bound 0.07-0.09 ms, chip_smoke.py::kernel_bound). On the bench
// headline (512^2 box_medium, 2^18 light paths; chip_smoke.py prints the
// counts; NVIDIA H100 80GB HBM3, 700 W) a volume launch has 524,288
// queries and 26.6 M candidates (5.6 rows a run) of which 15% pass the
// ball test; a surface launch 262,144 queries and 89.3 M candidates (38
// rows a run) of which 1.1% pass. A pair that passes costs 1,034
// (volume) or 1,139 (surface) counted float operations, each its own
// instruction without FMA contraction (and the divisions, square roots
// and exponentials among them expand to many more), and 55 row slots;
// a pair that fails costs 11 or 20. A kernel that runs the
// shift body in the lane that found the pair runs it with 3.5 (volume)
// or 2.2 (surface) of 32 lanes busy (measured: chip_smoke.py::lane_use),
// and took 5.08 and 3.29 ms.
//
// Design: test many, shift few, shift densely.
//  * One warp owns a tile of TQ neighbouring sorted queries; warps are
//    independent (no block-wide barrier), WARPS of them share a block.
//    The tile's query rows (the QUSED floats the evals read, at an odd
//    stride so that lanes holding different queries hit different
//    banks), its run bounds, 29 float accumulators and an ME key per
//    query live in shared memory.
//  * Sweep: the candidates of the tile, query by query and run by run,
//    are one index range (prefix sums of the run lengths, made when the
//    tile is staged) that is taken 32 x SWEEP_U at a time, one candidate
//    a lane: a lane finds its query by halving over the tile's prefix
//    and its run by eight compares, so short runs and short queries
//    (volume: 5.6 rows a run, 51 a query) fill the lanes as long ones
//    do, and every load of a step is started before the first test. The
//    test reads a head of each row, not the 512-byte row: two planes of
//    four floats a row, (position, vertex type) and (direction, depth),
//    that row_heads_kernel copies out of the table before each gather
//    (0.07 ms for 2^20 rows). A lane's candidate costs one 16-byte load
//    a plane, a warp's 32 neighbouring rows 512 contiguous bytes; the
//    volume test reads the second plane only when min_depth is set.
//    Fetching the second plane only for pairs that pass the first was
//    tried and ran slower (a second dependent round trip in nearly
//    every step).
//  * Queue: pairs that pass are appended (ballot + popcount) to a ring in
//    shared memory as (query in tile, row). Whenever it holds 32, the 32
//    lanes take one pair each, load their own row with 16-byte loads
//    (rows are row-major; no feature-major copy of the table exists any
//    more) and run the shift body together. The flush is the loop's
//    other half, not an overflow case: the sweep runs only while the
//    ring holds fewer than 32, so a query with any number of visits
//    works, and only a tile's last batch can be partial.
//  * Reduction: pairs leave the ring grouped by query in sweep order, so
//    each of the pair's 29 terms goes through a segmented warp reduction
//    keyed on the query (5 shuffle steps) and the segment's first lane
//    adds the sum to the query's accumulator in shared memory. No
//    atomics: the order of every sum is fixed, and two launches on the
//    same inputs give the same bits. The ME key is a segmented min.
//  * Registers and occupancy: the accumulators live in shared memory;
//    the body holds its row (R_LOAD floats) and the shift cache.
//    __launch_bounds__(64, 8) caps a thread at 128 registers, 16 warps
//    an SM: the volume bodies take 114-118 and the surface body 128
//    without spills, the surface ME body 128 with 20 bytes spilled
//    (build() keeps ptxas's report; chip_smoke.py prints it). Left at
//    its 133 registers that instantiation spills nothing but loses a
//    block an SM and ran 0.965 ms against 0.861. The shift loop stays
//    rolled: unrolled it ran 1.4-1.5x slower (four copies of a
//    600-instruction shift no longer fit the instruction cache).
//  * Small tiles: TQ = 8. Shared memory is carved out of the SM's L1,
//    which is what serves the re-reads of a row's head and body by the
//    neighbouring queries; at TQ = 32 the tiles leave ~40 KB of L1 and
//    the same kernel takes 1.41 (volume) and 1.15 ms (surface), at
//    TQ = 16 1.12 and 0.87, at TQ = 8 0.98 and 0.84, at TQ = 4 1.06 and
//    0.90: a smaller tile ends in a partial batch more often
//    (tools/kernel_variants.py times these variants).
//  * What it still pays: a batch runs at about half the schedulers'
//    rate (16 warps of dependent float arithmetic, special-function
//    units for every division), and the surface sweep re-reads 89.3 M
//    heads of 32 bytes, 2.9 GB a launch, through L1 and L2: with the
//    shift bodies taken out the sweeps alone take 0.26 (volume) and
//    0.53 ms (surface). A cell sized by each query's radius would cut
//    the surface candidates; sharing one staged copy of the heads among
//    a tile's queries would cut the re-reads.
//  * No wgmma and no TMA: the work holds no matrix product, and rows
//    reached through per-query runs are not rectangular tiles.
//
// Built with nvcc -fmad=false and without --use_fast_math so the ball
// tests and shift-validity tests decide as the plain PyTorch version
// does (exact `visits`, `shift_ok` and ME rows).

#include <cuda_runtime.h>

#include "gather_eval.cuh"

namespace gvpm {

constexpr int WARPS = 2;          // independent warps (tiles) per block
constexpr unsigned FULL = 0xffffffffu;

// launch shape of each eval: TQ queries per warp tile (TILE_Q in
// ops/fused_gather.py); SWEEP_U 32-wide candidate slots per sweep step;
// RING the ring's capacity, a power of two that holds the fewer than 32
// pairs before a sweep step and the 32 * SWEEP_U it may append;
// MIN_BLOCKS the blocks per SM that the body's registers leave room for
// (for __launch_bounds__)
template <class Eval>
struct Shape;
template <>
struct Shape<VolumeEval> {
  static constexpr int TQ = 8, SWEEP_U = 4, RING = 256, MIN_BLOCKS = 8;
};
template <>
struct Shape<SurfaceEval> {
  static constexpr int TQ = 8, SWEEP_U = 4, RING = 256, MIN_BLOCKS = 8;
};

template <class Eval>
struct WarpTile {
  static constexpr int TQ = Shape<Eval>::TQ;
  static constexpr int QSTRIDE = Eval::QUSED | 1;   // odd: no bank conflicts
  static constexpr int RING = Shape<Eval>::RING;
  static_assert(31 + 32 * Shape<Eval>::SWEEP_U <= RING && (RING & (RING - 1)) == 0,
                "ring too small or not a power of two");
  static_assert(TQ <= 32 && (TQ & (TQ - 1)) == 0, "one lane a query, searched by halving");
  float qs[TQ * QSTRIDE];      // staged query rows
  float acc[TQ * N_ACC];       // per-query sums (N_ACC is odd)
  int me[TQ];                  // per-query ME key
  // the tile's candidates as one index range: query qq owns
  // [q_end[qq-1], q_end[qq]); within it, run k ends at run_end[qq*9+k]
  // and index i of that run is table row i + to_row[qq*9+k]
  int q_end[TQ];
  int run_end[TQ * N_RUNS];
  int to_row[TQ * N_RUNS];
  int ring_row[RING];          // queued pairs: table row
  unsigned char ring_q[RING];  //               query in tile
};

// Segmented reduction over the lanes of one batch: lanes that hold pairs
// of the same query are neighbours; the first lane of each segment ends
// up with the segment's sum, added in a fixed order.
struct SegSink {
  unsigned same;   // bit s: lane + 2^s holds a pair of this lane's query
  bool first;      // first lane of a live segment
  float* acc;      // this lane's query's accumulators

  __device__ SegSink(int key, int lane, float* acc_) : same(0), acc(acc_) {
#pragma unroll
    for (int s = 0; s < 5; ++s) {
      const int other = __shfl_down_sync(FULL, key, 1 << s);
      if (lane + (1 << s) < 32 && other == key) same |= 1u << s;
    }
    const int prev = __shfl_up_sync(FULL, key, 1);
    first = key >= 0 && (lane == 0 || prev != key);
  }
  __device__ void add(int c, float v) {
#pragma unroll
    for (int s = 0; s < 5; ++s) {
      const float other = __shfl_down_sync(FULL, v, 1 << s);
      if (same >> s & 1) v += other;
    }
    if (first) acc[c] += v;
  }
  __device__ void min_into(int* dst, int v) {
#pragma unroll
    for (int s = 0; s < 5; ++s) {
      const int other = __shfl_down_sync(FULL, v, 1 << s);
      if ((same >> s & 1) && other < v) v = other;
    }
    if (first && v < *dst) *dst = v;
  }
};

// The shift bodies of `count` (1..32) queued pairs starting at ring
// position `first`, one pair a lane. Idle lanes of a partial batch
// repeat the first pair under a key of their own, so every lane runs
// the same shuffles; their sums are dropped.
template <class Eval, bool ME>
__device__ __forceinline__ void shift_batch(WarpTile<Eval>& t, int first, int count,
                                            int lane, const float* __restrict__ tbl,
                                            long long row_w, float r2, float k3) {
  const bool live = lane < count;
  const int e = (first + (live ? lane : 0)) & (WarpTile<Eval>::RING - 1);
  const int row = t.ring_row[e];
  const int qi = t.ring_q[e];
  float rw[R_LOAD];
  const float4* src = reinterpret_cast<const float4*>(tbl + (long long)row * row_w);
#pragma unroll
  for (int k = 0; k < R_LOAD / 4; ++k) {
    const float4 v = __ldg(src + k);
    rw[4 * k] = v.x;
    rw[4 * k + 1] = v.y;
    rw[4 * k + 2] = v.z;
    rw[4 * k + 3] = v.w;
  }
  SegSink sink(live ? qi : -1, lane, t.acc + qi * N_ACC);
  const bool me = Eval::template body<ME>(t.qs + qi * WarpTile<Eval>::QSTRIDE,
                                          RowRef{rw}, r2, k3, sink);
  if constexpr (ME) sink.min_into(t.me + qi, (live && me) ? row : ME_NONE);
  __syncwarp();
}

template <class Eval, bool ME>
__global__ void __launch_bounds__(WARPS * 32, Shape<Eval>::MIN_BLOCKS)
fused_gather_kernel(const float* __restrict__ tbl, const float* __restrict__ head,
                    long long n_rows, long long row_w, const float* __restrict__ qrows,
                    const int* __restrict__ r0, const int* __restrict__ r1,
                    long long Q, float r2, float k3, int min_depth,
                    float* __restrict__ out, int* __restrict__ me_row) {
  using Tile = WarpTile<Eval>;
  constexpr int TQ = Tile::TQ;
  constexpr int U = Shape<Eval>::SWEEP_U;
  __shared__ Tile tiles[WARPS];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  Tile& t = tiles[warp];
  const long long q0 = ((long long)blockIdx.x * WARPS + warp) * TQ;
  if (q0 >= Q) return;  // uniform per warp; warps share no barrier
  const int nq = (int)(Q - q0 < TQ ? Q - q0 : TQ);

  // ---- stage the tile
  for (int i = lane; i < nq * Eval::QUSED; i += 32) {
    const int qq = i / Eval::QUSED, k = i - qq * Eval::QUSED;
    t.qs[qq * Tile::QSTRIDE + k] = qrows[(q0 + qq) * Eval::QW + k];
  }
  for (int i = lane; i < nq * N_ACC; i += 32) t.acc[i] = 0.0f;
  int n_mine = 0;             // lane qq: the candidates of query qq
  if (lane < nq) {
    t.me[lane] = ME_NONE;
    const int* a = r0 + (q0 + lane) * N_RUNS;
    const int* b = r1 + (q0 + lane) * N_RUNS;
#pragma unroll
    for (int k = 0; k < N_RUNS; ++k) {
      const int len = b[k] > a[k] ? b[k] - a[k] : 0;
      t.to_row[lane * N_RUNS + k] = a[k] - n_mine;
      n_mine += len;
      t.run_end[lane * N_RUNS + k] = n_mine;
    }
  }
  int n_upto = n_mine;        // inclusive scan over the tile's queries
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int other = __shfl_up_sync(FULL, n_upto, s);
    if (lane >= s) n_upto += other;
  }
  if (lane < TQ) t.q_end[lane] = n_upto;   // lanes past nq repeat the total
  const int n_tile = __shfl_sync(FULL, n_upto, 31);
  __syncwarp();

  // ---- sweep until the ring holds a warp's worth, shift it, repeat
  const bool head2 = Eval::HEAD_FLOATS > 4 || min_depth > 0;
  const float4* head_a = reinterpret_cast<const float4*>(head);
  const float4* head_b = head_a + n_rows;
  int base = 0;               // the sweep's place in the tile's candidates
  int ring_lo = 0, ring_hi = 0;
  for (;;) {
    while (ring_hi - ring_lo < 32 && base < n_tile) {
      int row[U], qq[U];
      float h[U][H_WIDTH];
      bool live[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int f = base + u * 32 + lane;
        const int fc = f < n_tile ? f : n_tile - 1;
        int q = 0;            // the first query whose range ends past fc
#pragma unroll
        for (int s = TQ / 2; s > 0; s >>= 1)
          if (t.q_end[q + s - 1] <= fc) q += s;
        const int i = fc - (q > 0 ? t.q_end[q - 1] : 0);
        int run = 0;
#pragma unroll
        for (int k = 0; k < N_RUNS - 1; ++k) run += i >= t.run_end[q * N_RUNS + k];
        qq[u] = q;
        row[u] = i + t.to_row[q * N_RUNS + run];
        live[u] = f < n_tile;
        const float4 zero = {0.0f, 0.0f, 0.0f, 0.0f};
        const float4 v = live[u] ? __ldg(head_a + row[u]) : zero;
        const float4 w = live[u] && head2 ? __ldg(head_b + row[u]) : zero;
        h[u][0] = v.x, h[u][1] = v.y, h[u][2] = v.z, h[u][3] = v.w;
        h[u][4] = w.x, h[u][5] = w.y, h[u][6] = w.z, h[u][7] = w.w;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const bool pass = live[u] && Eval::inside(t.qs + qq[u] * Tile::QSTRIDE, h[u],
                                                  min_depth, r2);
        const unsigned hit = __ballot_sync(FULL, pass);
        if (pass) {
          const int at = (ring_hi + __popc(hit & ((1u << lane) - 1))) & (Tile::RING - 1);
          t.ring_row[at] = row[u];
          t.ring_q[at] = (unsigned char)qq[u];
        }
        ring_hi += __popc(hit);
      }
      base += 32 * U;
      __syncwarp();
    }
    const int count = ring_hi - ring_lo < 32 ? ring_hi - ring_lo : 32;
    if (count == 0) break;    // swept every candidate and the ring is empty
    shift_batch<Eval, ME>(t, ring_lo, count, lane, tbl, row_w, r2, k3);
    ring_lo += count;
  }

  // ---- write the tile's rows
  float* o = out + q0 * Eval::N_OUT;
  for (int i = lane; i < nq * Eval::N_OUT; i += 32) {
    const int qq = i / Eval::N_OUT, c = i - qq * Eval::N_OUT;
    o[i] = c < N_ACC ? t.acc[qq * N_ACC + c] : 0.0f;  // dropped rows: none
  }
  if constexpr (ME) {
    if (lane < nq) me_row[q0 + lane] = t.me[lane];
  }
}

// The heads of the table's rows, [2, P, 4]: plane 0 holds (position,
// vertex type), plane 1 (incoming direction, depth), bit for bit the
// rows' slots. One thread a row.
__global__ void __launch_bounds__(256)
row_heads_kernel(const float* __restrict__ tbl, long long n_rows, long long row_w,
                 float4* __restrict__ head) {
  static_assert(R_P == 0 && R_WI == 3 && R_VTYPE == 44 && R_DEPTH == 47,
                "the three float4 loads below assume these slots");
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n_rows) return;
  const float4* src = reinterpret_cast<const float4*>(tbl + row * row_w);
  const float4 a = __ldg(src), b = __ldg(src + 1), c = __ldg(src + R_VTYPE / 4);
  head[row] = float4{a.x, a.y, a.z, c.x};
  head[n_rows + row] = float4{a.w, b.x, b.y, c.w};
}

int launch_row_heads(const float* tbl, float* head, long long n_rows, long long row_w,
                     void* stream) {
  if (n_rows == 0) return 0;
  row_heads_kernel<<<(unsigned)((n_rows + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      tbl, n_rows, row_w, reinterpret_cast<float4*>(head));
  return (int)cudaGetLastError();
}

// Fills `head` ([2, P, 4] scratch) from the table, then gathers.
template <class Eval, bool ME>
int launch(const float* tbl, float* head, long long n_rows, long long row_w,
           const float* qrows, const int* r0, const int* r1, long long Q, float r2,
           float k3, int min_depth, float* out, int* me_row, void* stream) {
  const int err = launch_row_heads(tbl, head, n_rows, row_w, stream);
  if (err != 0) return err;
  constexpr long long per_block = (long long)WARPS * Shape<Eval>::TQ;
  const long long blocks = (Q + per_block - 1) / per_block;
  fused_gather_kernel<Eval, ME><<<(unsigned)blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
      tbl, head, n_rows, row_w, qrows, r0, r1, Q, r2, k3, min_depth, out, me_row);
  return (int)cudaGetLastError();
}

}  // namespace gvpm

extern "C" int gvpm_row_heads(const float* tbl, float* head, long long n_rows,
                              long long row_w, void* stream) {
  return gvpm::launch_row_heads(tbl, head, n_rows, row_w, stream);
}

#define GVPM_ENTRY(NAME, EVAL)                                                        \
  extern "C" int gvpm_fused_gather_##NAME(                                            \
      const float* tbl, float* head, long long n_rows, long long row_w,               \
      const float* qrows, const int* r0, const int* r1, long long Q, float r2,        \
      float k3, int min_depth, float* out, void* stream) {                            \
    return gvpm::launch<gvpm::EVAL, false>(tbl, head, n_rows, row_w, qrows, r0, r1,   \
                                           Q, r2, k3, min_depth, out, nullptr,        \
                                           stream);                                   \
  }                                                                                   \
  extern "C" int gvpm_fused_gather_##NAME##_me(                                       \
      const float* tbl, float* head, long long n_rows, long long row_w,               \
      const float* qrows, const int* r0, const int* r1, long long Q, float r2,        \
      float k3, int min_depth, float* out, int* me_row, void* stream) {               \
    return gvpm::launch<gvpm::EVAL, true>(tbl, head, n_rows, row_w, qrows, r0, r1, Q, \
                                          r2, k3, min_depth, out, me_row, stream);    \
  }

GVPM_ENTRY(volume, VolumeEval)
GVPM_ENTRY(surface, SurfaceEval)
