// The second kernel of the beam / plane sweeps (gsweep.cu): each (beam
// split, query) wrote its partial sums and counts
// into part / part_cnt ([splits, M, NF_SUM] and [splits, M, NC]); one
// thread a (query, accumulator) adds the splits in order, so two
// launches on the same inputs give the same bits. An ME instantiation's
// key (the lowest packed index of an ME-eligible accepted beam) is
// reduced by min instead. out has NF floats a query; the ones past
// NF_SUM (gbeam3d_me's chord point) are gsweep.cu's key_points'.
#pragma once

#include "beam_eval.cuh"

namespace beam {

template <class F>
__global__ void reduce_splits(const float* __restrict__ part,
                              const int* __restrict__ part_cnt, int splits,
                              long long M, float* __restrict__ out,
                              int* __restrict__ cnt) {
  constexpr int NS = F::NF_SUM, NC = F::NC;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * (NS + NC)) return;
  const long long m = i / (NS + NC);
  const int f = (int)(i % (NS + NC));
  if (f < NS) {
    float a = 0.0f;
    for (int s = 0; s < splits; ++s) a += part[(s * M + m) * NS + f];
    out[m * F::NF + f] = a;
  } else if (F::ME && f == NS + C_KEY) {
    int key = ME_NONE;
    for (int s = 0; s < splits; ++s)
      key = min(key, part_cnt[(s * M + m) * NC + C_KEY]);
    cnt[m * NC + C_KEY] = key;
  } else {
    int n = 0;
    for (int s = 0; s < splits; ++s) n += part_cnt[(s * M + m) * NC + f - NS];
    cnt[m * NC + f - NS] = n;
  }
}

}  // namespace beam
