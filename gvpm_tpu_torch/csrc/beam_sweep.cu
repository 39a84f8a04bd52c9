// The pair sweeps of the photon-beam and photon-plane estimators
// (ops/beam_sweep.py): every camera query against every photon beam or
// plane, per-pair math in beam_eval.cuh.
//
// Replaces the XLA tile loops (lax.scan over all beam slots in tiles of
// beam_tile) of gvpm_tpu/integrators/estimators.py: beam_beam_gather
// (:481, beam1d), beam_point_gather (:262, beam3d) and plane_gather
// (:401, plane0d). The TPU has no kernel for them.
//
// What bounds it: operations. Each pair reads one beam row from shared
// memory and does ~50-200 float (beam3d: plus ~110 integer, threefry for
// the pairs inside the chord test) operations; the beams are read from
// device memory once per block of queries.
//
// Design (simple first): one thread per camera query, BLOCK threads a
// block; the beams stream through shared memory in tiles of TILE_B rows.
// Each thread keeps its query in registers and adds its accepted pairs
// into registers in beam order. To fill the card when queries are few,
// the beam range is split into `splits` chunks of whole tiles
// (blockIdx.y); each (split, query) writes its partial sums and count,
// and a second kernel adds the splits in order. No atomics: two
// launches on the same inputs give the same bits.
#include <cuda_runtime.h>

#include "beam_eval.cuh"

namespace {

constexpr int BLOCK = 128;   // ops/beam_sweep.BLOCK
constexpr int TILE_B = 128;  // ops/beam_sweep.TILE_B

template <class F>
__global__ void __launch_bounds__(BLOCK)
    sweep_kernel(const float* __restrict__ qrows, long long M,
                 const float4* __restrict__ brows,
                 const int4* __restrict__ keys, long long N,
                 beam::Params p, long long chunk, float* __restrict__ part,
                 int* __restrict__ part_cnt) {
  __shared__ float4 sb[TILE_B * beam::BW / 4];
  __shared__ int4 sk[F::RANDOM ? TILE_B : 1];
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
  float acc[3] = {0.0f, 0.0f, 0.0f};
  int cnt = 0;
  for (long long t0 = j0; t0 < j1; t0 += TILE_B) {
    const int n = (int)min((long long)TILE_B, j1 - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < n * (beam::BW / 4); i += BLOCK)
      sb[i] = brows[t0 * (beam::BW / 4) + i];
    if (F::RANDOM)
      for (int i = threadIdx.x; i < n; i += BLOCK) sk[i] = keys[t0 + i];
    __syncthreads();
    if (!live) continue;
    for (int jj = 0; jj < n; ++jj) {
      float c[3];
      const float* b = reinterpret_cast<const float*>(&sb[jj * (beam::BW / 4)]);
      const int* k = F::RANDOM ? reinterpret_cast<const int*>(&sk[jj]) : nullptr;
      if (F::pair(q, b, k, p, c)) {
        acc[0] += c[0];
        acc[1] += c[1];
        acc[2] += c[2];
        ++cnt;
      }
    }
  }
  if (m < M) {
    float* o = part + (s * M + m) * 3;
    o[0] = acc[0];
    o[1] = acc[1];
    o[2] = acc[2];
    part_cnt[s * M + m] = cnt;
  }
}

__global__ void reduce_splits(const float* __restrict__ part,
                              const int* __restrict__ part_cnt, int splits,
                              long long M, float* __restrict__ out,
                              int* __restrict__ cnt) {
  const long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
  int n = 0;
  for (int s = 0; s < splits; ++s) {
    const float* o = part + (s * M + m) * 3;
    a0 += o[0];
    a1 += o[1];
    a2 += o[2];
    n += part_cnt[s * M + m];
  }
  out[m * 3] = a0;
  out[m * 3 + 1] = a1;
  out[m * 3 + 2] = a2;
  cnt[m] = n;
}

template <class F>
int launch(const float* q, long long M, const float* rows, const int* keys,
           long long N, int tile, float r2, float k, int splits,
           long long chunk, float* part, int* part_cnt, float* out, int* cnt,
           cudaStream_t stream) {
  const dim3 grid((unsigned)((M + BLOCK - 1) / BLOCK), (unsigned)splits);
  sweep_kernel<F><<<grid, BLOCK, 0, stream>>>(
      q, M, reinterpret_cast<const float4*>(rows),
      reinterpret_cast<const int4*>(keys), N,
      beam::Params{r2, k, (uint32_t)tile}, chunk, part, part_cnt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_splits<<<(unsigned)((M + 255) / 256), 256, 0, stream>>>(
      part, part_cnt, splits, M, out, cnt);
  return (int)cudaGetLastError();
}

}  // namespace

#define SWEEP_ENTRY(NAME, F)                                                \
  extern "C" int gvpm_beam_sweep_##NAME(                                    \
      const float* q, long long M, const float* rows, const int* keys,      \
      long long N, int tile, float r2, float k, int splits,                 \
      long long chunk, float* part, int* part_cnt, float* out, int* cnt,    \
      cudaStream_t stream) {                                                \
    return launch<F>(q, M, rows, keys, N, tile, r2, k, splits, chunk, part, \
                     part_cnt, out, cnt, stream);                           \
  }

SWEEP_ENTRY(beam1d, beam::Beam1D)
SWEEP_ENTRY(beam3d, beam::Beam3D)
SWEEP_ENTRY(plane0d, beam::Plane0D)
