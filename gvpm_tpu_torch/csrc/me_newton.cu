// The Newton solve of the manifold (ME) shifts on the card: one launch a
// shift call, one thread a lane, for integrators/manifold.py's volume and
// beam targets (3 unknowns) and its surface target (2). The body is
// me_newton.cuh's solve_lane, whose forward-mode dual numbers carry the
// lane's Jacobian in registers; the plain version takes it with
// torch.func.jvp, about 1,100 small kernels a Jacobian and 6 Jacobians a
// call.
//
// It replaces no TPU kernel: the JAX package leaves the solve to XLA, a
// vmapped `solve_one` over jax.jacfwd of each target's residual
// (gvpm_tpu/integrators/manifold.py me_shift_volume, me_shift_beam,
// me_shift_surface). On the card the plain version's launches made it the
// largest idle gap of an ME pass, which is why it has a kernel.
//
// What bounds it: a lane reads ~110 bytes (its chain's slots, anchor,
// base direction and target) and writes ~60-70, so 16,384 lanes move
// 2.7-3.0 MB, under a microsecond at 3.35 TB/s, and do ~3 * 10^3 float
// operations each on a one-slot chain (chip_smoke.py ME_NEWTON_OPS, a
// low count), about as long at 67 TFLOP/s. A launch of 16,384 lanes
// takes ~0.02 ms on an H100 (chip_smoke.py [me-newton]): one thread's
// serial chain of six
// evaluations, with divisions and square roots, at 127-137 registers.
// That is far below the host time of the launches it replaces and of the
// wrapper's own call, so it is left untuned. No atomics and no shared
// state: the same inputs give the same bits.
#include "me_newton.cuh"

namespace {

constexpr int THREADS = 128;

template <int N>
__global__ void __launch_bounds__(THREADS)
me_newton_kernel(const gvpm::me::In in, const gvpm::me::Out out) {
  const long long l = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (l < in.L) gvpm::me::solve_lane<N>(in, out, l);
}

}  // namespace

// Launches the solve of in->L lanes on `stream`; returns the CUDA error
// of the launch (0: none).
extern "C" int gvpm_me_newton(const gvpm::me::In* in, const gvpm::me::Out* out,
                              void* stream) {
  if (in->L == 0) return 0;
  const unsigned blocks = (unsigned)((in->L + THREADS - 1) / THREADS);
  if (in->target == gvpm::me::TARGET_SURFACE)
    me_newton_kernel<2><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(*in, *out);
  else
    me_newton_kernel<3><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(*in, *out);
  return (int)cudaGetLastError();
}
