// The second kernel of the beam / plane sweeps (beam_sweep.cu,
// gsweep.cu): each (beam split, query) wrote its partial sums and counts
// into part / part_cnt ([splits, M, NF] and [splits, M, NC]); one thread
// a (query, accumulator) adds the splits in order, so two launches on
// the same inputs give the same bits. An ME instantiation's key (the
// lowest packed index of an ME-eligible accepted beam) is reduced by min
// instead, and gbeam3d_me's chord point comes from the split that holds
// it.
#pragma once

#include "beam_eval.cuh"

namespace beam {

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
  if (F::ME && ((f >= F::NF_SUM && f < NF) || f == NF + C_KEY)) {
    // the lowest key, and the chord point of the split that holds it
    int key = ME_NONE;
    float a = 0.0f;
    for (int s = 0; s < splits; ++s) {
      const int k = part_cnt[(s * M + m) * NC + C_KEY];
      if (k < key) {
        key = k;
        if (f < NF) a = part[(s * M + m) * NF + f];
      }
    }
    if (f < NF)
      out[m * NF + f] = a;
    else
      cnt[m * NC + C_KEY] = key;
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

}  // namespace beam
