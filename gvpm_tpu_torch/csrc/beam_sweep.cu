// The photon-plane pair sweep (ops/beam_sweep.py kind plane0d): every
// camera query against every photon plane, per-pair math in
// beam_eval.cuh's Plane0D.
//
// Replaces the XLA tile loop (lax.scan over all plane slots in tiles of
// beam_tile) of gvpm_tpu/integrators/estimators.py:401 plane_gather. The
// TPU has no kernel for it. The primal beam sweeps (beam1d, beam3d) and
// the gradient sweeps run on the queued kernel of gsweep.cu.
//
// What bounds it: operations. Each pair reads one plane row from shared
// memory and does ~23-160 float operations; the planes are read from
// device memory once per block of queries.
//
// Design (simple first): one thread per camera query, BLOCK threads a
// block; the 16-float plane rows stream through shared memory in tiles of
// TILE_B rows. Each thread keeps its query in registers and adds its
// accepted pairs into 3 float and 1 integer registers in plane order. To
// fill the card when queries are few, the plane range is split into
// `splits` chunks of whole tiles (blockIdx.y); each (split, query)
// writes its partial sums and counts, and a second kernel adds the
// splits in order (splits.cuh). No atomics: two launches on the same
// inputs give the same bits.
#include <cuda_runtime.h>

#include "beam_eval.cuh"
#include "splits.cuh"

namespace {

constexpr int BLOCK = 128;   // ops/beam_sweep.BLOCK
constexpr int TILE_B = 128;  // ops/beam_sweep.TILE_B

template <class F>
__global__ void __launch_bounds__(BLOCK)
    sweep_kernel(const float* __restrict__ qrows, long long M,
                 const float4* __restrict__ brows, long long N,
                 beam::Params p, long long chunk, float* __restrict__ part,
                 int* __restrict__ part_cnt) {
  __shared__ float4 sb[TILE_B * beam::BW / 4];
  const long long m = (long long)blockIdx.x * BLOCK + threadIdx.x;
  const long long s = blockIdx.y;
  const long long j0 = s * chunk;
  const long long j1 = min(N, j0 + chunk);
  beam::Query q{};
  bool live = false;
  if (m < M) {
    q = beam::load_query(qrows + m * beam::QW, (uint32_t)m);
    live = q.valid;
  }
  float acc[F::NF];
  int cnt[F::NC];
#pragma unroll
  for (int f = 0; f < F::NF; ++f) acc[f] = 0.0f;
#pragma unroll
  for (int c = 0; c < F::NC; ++c) cnt[c] = 0;
  for (long long t0 = j0; t0 < j1; t0 += TILE_B) {
    const int n = (int)min((long long)TILE_B, j1 - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < n * (beam::BW / 4); i += BLOCK)
      sb[i] = brows[t0 * (beam::BW / 4) + i];
    __syncthreads();
    if (!live) continue;
    for (int jj = 0; jj < n; ++jj) {
      const float* b = reinterpret_cast<const float*>(&sb[jj * (beam::BW / 4)]);
      F::visit(q, b, nullptr, p, acc, cnt);
    }
  }
  if (m < M) {
    float* o = part + (s * M + m) * F::NF;
#pragma unroll
    for (int f = 0; f < F::NF; ++f) o[f] = acc[f];
    int* oc = part_cnt + (s * M + m) * F::NC;
#pragma unroll
    for (int c = 0; c < F::NC; ++c) oc[c] = cnt[c];
  }
}

template <class F>
int launch(const float* q, long long M, const float* rows, long long N,
           int tile, float r2, float k, int splits, long long chunk,
           float* part, int* part_cnt, float* out, int* cnt,
           cudaStream_t stream) {
  const dim3 grid((unsigned)((M + BLOCK - 1) / BLOCK), (unsigned)splits);
  sweep_kernel<F><<<grid, BLOCK, 0, stream>>>(
      q, M, reinterpret_cast<const float4*>(rows), N,
      beam::Params{r2, k, (uint32_t)tile}, chunk, part, part_cnt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long items = M * (F::NF + F::NC);
  beam::reduce_splits<F><<<(unsigned)((items + 255) / 256), 256, 0, stream>>>(
      part, part_cnt, splits, M, out, cnt);
  return (int)cudaGetLastError();
}

}  // namespace

// the C interface gsweep.cu's entries share (keys, tails and qext unused
// here)
extern "C" int gvpm_beam_sweep_plane0d(
    const float* q, long long M, const float* rows, const int* /*keys*/,
    const float* /*tails*/, const float* /*qext*/, long long N, int tile,
    float r2, float k, int splits, long long chunk, float* part,
    int* part_cnt, float* out, int* cnt, cudaStream_t stream) {
  return launch<beam::Primal<beam::Plane0D>>(q, M, rows, N, tile, r2, k,
                                             splits, chunk, part, part_cnt,
                                             out, cnt, stream);
}
