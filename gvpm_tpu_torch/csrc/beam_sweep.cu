// The pair sweeps of the photon-beam and photon-plane estimators
// (ops/beam_sweep.py): every camera query against every photon beam or
// plane, per-pair math in beam_eval.cuh.
//
// Replaces the XLA tile loops (lax.scan over all beam slots in tiles of
// beam_tile) of gvpm_tpu/integrators/estimators.py: beam_beam_gather
// (:481, beam1d), beam_point_gather (:262, beam3d) and plane_gather
// (:401, plane0d), and of gvpm_tpu/integrators/gradient_gather.py with
// use_manifold=False: beam_gradient_gather (:1232, gbeam1d),
// beam3d_gradient_gather (:1580, gbeam3d) and plane_gradient_gather
// (:1960, gplane0d), and their use_manifold=True instantiations
// (gbeam1d_me, gbeam3d_me, gplane0d_me), which also collect each query's
// first ME-eligible accepted beam for the host's ME stage
// (integrators/gradient_gather.py). The TPU has no kernel for them.
//
// What bounds it: operations. Each pair reads one beam row from shared
// memory and does ~50-200 float (beam3d: plus ~110 integer, threefry for
// the pairs inside the chord test) operations; the beams are read from
// device memory once per block of queries. A gradient pair that passes
// the base test also reads the beam's 32-float gradient tail and the
// query's 40-float offset rays from device memory and runs four shifts.
//
// Design (simple first): one thread per camera query, BLOCK threads a
// block; the 16-float beam rows stream through shared memory in tiles of
// TILE_B rows. Each thread keeps its query in registers and adds its
// accepted pairs into NF float and NC integer registers (3 and 1 for a
// primal sweep; 27 and 2 for a gradient one: base, S and W of the four
// offsets, visits and shift_ok) in beam order. To fill the card when
// queries are few, the beam range is split into `splits` chunks of whole
// tiles (blockIdx.y); each (split, query) writes its partial sums and
// counts, and a second kernel adds the splits in order. An ME
// instantiation's key (the lowest packed index of an ME-eligible accepted
// beam, ME_NONE for none) is reduced by min over the splits instead, and
// gbeam3d_me's chord point comes from the split that holds the key. No
// atomics: two launches on the same inputs give the same bits.
#include <cuda_runtime.h>

#include "beam_eval.cuh"

namespace {

constexpr int BLOCK = 128;   // ops/beam_sweep.BLOCK
constexpr int TILE_B = 128;  // ops/beam_sweep.TILE_B

template <class F>
__global__ void __launch_bounds__(BLOCK)
    sweep_kernel(const float* __restrict__ qrows, long long M,
                 const float4* __restrict__ brows,
                 const int4* __restrict__ keys,
                 const float* __restrict__ tails,
                 const float* __restrict__ qext, long long N,
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
  float acc[F::NF];
  int cnt[F::NC];
#pragma unroll
  for (int f = 0; f < F::NF; ++f) acc[f] = 0.0f;
#pragma unroll
  for (int c = 0; c < F::NC; ++c) cnt[c] = 0;
  if constexpr (F::ME) cnt[beam::C_KEY] = beam::ME_NONE;
  const float* qx = F::GRAD && m < M ? qext + m * beam::XW : nullptr;
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
      const float* b = reinterpret_cast<const float*>(&sb[jj * (beam::BW / 4)]);
      const int* k = F::RANDOM ? reinterpret_cast<const int*>(&sk[jj]) : nullptr;
      const float* tail = F::GRAD ? tails + (t0 + jj) * beam::TW : nullptr;
      F::visit(q, b, k, tail, qx, p, acc, cnt, (int)(t0 + jj));
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

// one thread per (query, accumulator): the splits in order
template <class F>
__global__ void reduce_splits(const float* __restrict__ part,
                              const int* __restrict__ part_cnt, int splits,
                              long long M, float* __restrict__ out,
                              int* __restrict__ cnt) {
  constexpr int NF = F::NF, NC = F::NC;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * (NF + NC)) return;
  const long long m = i / (NF + NC);
  const int f = (int)(i % (NF + NC));
  if (F::ME && ((f >= F::NF_SUM && f < NF) || f == NF + beam::C_KEY)) {
    // the lowest key, and the chord point of the split that holds it
    int key = beam::ME_NONE;
    float a = 0.0f;
    for (int s = 0; s < splits; ++s) {
      const int k = part_cnt[(s * M + m) * NC + beam::C_KEY];
      if (k < key) {
        key = k;
        if (f < NF) a = part[(s * M + m) * NF + f];
      }
    }
    if (f < NF)
      out[m * NF + f] = a;
    else
      cnt[m * NC + beam::C_KEY] = key;
  } else if (f < NF) {
    float a = 0.0f;
    for (int s = 0; s < splits; ++s) a += part[(s * M + m) * NF + f];
    out[m * NF + f] = a;
  } else {
    int n = 0;
    for (int s = 0; s < splits; ++s) n += part_cnt[(s * M + m) * NC + f - NF];
    cnt[m * NC + f - NF] = n;
  }
}

template <class F>
int launch(const float* q, long long M, const float* rows, const int* keys,
           const float* tails, const float* qext, long long N, int tile,
           float r2, float k, int splits, long long chunk, float* part,
           int* part_cnt, float* out, int* cnt, cudaStream_t stream) {
  const dim3 grid((unsigned)((M + BLOCK - 1) / BLOCK), (unsigned)splits);
  sweep_kernel<F><<<grid, BLOCK, 0, stream>>>(
      q, M, reinterpret_cast<const float4*>(rows),
      reinterpret_cast<const int4*>(keys), tails, qext, N,
      beam::Params{r2, k, (uint32_t)tile}, chunk, part, part_cnt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long items = M * (F::NF + F::NC);
  reduce_splits<F><<<(unsigned)((items + 255) / 256), 256, 0, stream>>>(
      part, part_cnt, splits, M, out, cnt);
  return (int)cudaGetLastError();
}

}  // namespace

#define SWEEP_ENTRY(NAME, F)                                                 \
  extern "C" int gvpm_beam_sweep_##NAME(                                     \
      const float* q, long long M, const float* rows, const int* keys,       \
      const float* tails, const float* qext, long long N, int tile,          \
      float r2, float k, int splits, long long chunk, float* part,           \
      int* part_cnt, float* out, int* cnt, cudaStream_t stream) {            \
    return launch<F>(q, M, rows, keys, tails, qext, N, tile, r2, k, splits,  \
                     chunk, part, part_cnt, out, cnt, stream);               \
  }

SWEEP_ENTRY(beam1d, beam::Primal<beam::Beam1D>)
SWEEP_ENTRY(beam3d, beam::Primal<beam::Beam3D>)
SWEEP_ENTRY(plane0d, beam::Primal<beam::Plane0D>)
SWEEP_ENTRY(gbeam1d, beam::GBeam1D)
SWEEP_ENTRY(gbeam3d, beam::GBeam3D)
SWEEP_ENTRY(gplane0d, beam::GPlane0D)
SWEEP_ENTRY(gbeam1d_me, beam::GBeam1DME)
SWEEP_ENTRY(gbeam3d_me, beam::GBeam3DME)
SWEEP_ENTRY(gplane0d_me, beam::GPlane0DME)
