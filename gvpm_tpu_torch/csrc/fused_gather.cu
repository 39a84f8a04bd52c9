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
// What bounds it: the ~600 flops of shift math per candidate pair that
// passes the ball test (about one in six of the stencil candidates), on
// rows of 55 useful floats. Neighbouring sorted queries share most of
// their stencil cells, so a row is fetched from device memory about
// once and then re-read through L2 by the queries around it. The ME key
// adds two slot loads and an integer min per visited pair.
//
// Design (a first, simple kernel): one warp per sorted query; the 32
// lanes stride over the rows of each run; the table stays feature-major
// [F, P] so the lanes' loads of one slot are consecutive addresses
// (coalesced); the query row is staged once in shared memory and read
// by broadcast; each lane keeps 29 float accumulators (and an int row
// minimum) and the warp reduces them with __shfl_xor_sync; lane 0 writes
// the row. Pairs that fail the ball test return before the shift math.
//
// Built with nvcc -fmad=false and without --use_fast_math so the ball
// tests and shift-validity tests decide as the plain PyTorch version
// does (exact `visits`, `shift_ok` and ME rows).

#include <cuda_runtime.h>

#include "gather_eval.cuh"

namespace gvpm {

constexpr int WARPS = 4;  // warps (queries) per block

template <class Eval, bool ME>
__global__ void __launch_bounds__(WARPS * 32)
fused_gather_kernel(const float* __restrict__ tbl, long long P,
                    const float* __restrict__ qrows,
                    const int* __restrict__ r0, const int* __restrict__ r1,
                    long long Q, float r2, float k3, int min_depth,
                    float* __restrict__ out, int* __restrict__ me_row) {
  __shared__ float qs[WARPS][Eval::QW];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long q = (long long)blockIdx.x * WARPS + warp;
  if (q >= Q) return;  // uniform per warp
  for (int k = lane; k < Eval::QW; k += 32) qs[warp][k] = qrows[q * Eval::QW + k];
  __syncwarp();

  float acc[N_ACC];
#pragma unroll
  for (int c = 0; c < N_ACC; ++c) acc[c] = 0.0f;
  int me_min = ME_NONE;
  for (int run = 0; run < N_RUNS; ++run) {
    const int a = r0[q * N_RUNS + run];
    const int b = r1[q * N_RUNS + run];
    for (int row = a + lane; row < b; row += 32) {
      const bool me = Eval::template pair<ME>(qs[warp], RowRef{tbl, P, row}, min_depth,
                                              r2, k3, acc);
      if constexpr (ME) {
        if (me && row < me_min) me_min = row;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < N_ACC; ++c) {
    float v = acc[c];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    acc[c] = v;
  }
  if constexpr (ME) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int other = __shfl_xor_sync(0xffffffffu, me_min, off);
      me_min = other < me_min ? other : me_min;
    }
  }
  if (lane == 0) {
    float* o = out + q * Eval::N_OUT;
#pragma unroll
    for (int c = 0; c < N_ACC; ++c) o[c] = acc[c];
    o[N_ACC] = 0.0f;  // dropped rows: none with exact runs
    if constexpr (ME) me_row[q] = me_min;
  }
}

template <class Eval, bool ME>
int launch(const float* tbl, long long P, const float* qrows, const int* r0,
           const int* r1, long long Q, float r2, float k3, int min_depth,
           float* out, int* me_row, void* stream) {
  const long long blocks = (Q + WARPS - 1) / WARPS;
  fused_gather_kernel<Eval, ME><<<(unsigned)blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
      tbl, P, qrows, r0, r1, Q, r2, k3, min_depth, out, me_row);
  return (int)cudaGetLastError();
}

}  // namespace gvpm

#define GVPM_ENTRY(NAME, EVAL)                                                         \
  extern "C" int gvpm_fused_gather_##NAME(                                             \
      const float* tbl, long long P, const float* qrows, const int* r0, const int* r1, \
      long long Q, float r2, float k3, int min_depth, float* out, void* stream) {      \
    return gvpm::launch<gvpm::EVAL, false>(tbl, P, qrows, r0, r1, Q, r2, k3,           \
                                           min_depth, out, nullptr, stream);           \
  }                                                                                    \
  extern "C" int gvpm_fused_gather_##NAME##_me(                                        \
      const float* tbl, long long P, const float* qrows, const int* r0, const int* r1, \
      long long Q, float r2, float k3, int min_depth, float* out, int* me_row,         \
      void* stream) {                                                                  \
    return gvpm::launch<gvpm::EVAL, true>(tbl, P, qrows, r0, r1, Q, r2, k3, min_depth, \
                                          out, me_row, stream);                        \
  }

GVPM_ENTRY(volume, VolumeEval)
GVPM_ENTRY(surface, SurfaceEval)
