"""The CUDA kernel's own per-pair math (gvpm_tpu_torch/csrc/
gather_eval.cuh), compiled as host C++ with g++ and driven pair by pair
from ctypes, against the plain PyTorch version of the fused gather on
the inputs of a 16x16 pass (the config of tests/test_torch_gather.py).
This is the only way the CUDA source's math runs before it reaches the
card. Bar: visits and shift_ok exact, sums at rtol 2e-4 / atol 5e-6."""

import ctypes
import os
import shutil
import subprocess

import pytest
import torch

from gvpm_tpu_torch.integrators import gvpm, sppm
from gvpm_tpu_torch.ops import fused_gather as fg
from tests.test_torch_common import N_PHOTONS, SIDE, TORCH_CFG

CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "gvpm_tpu_torch", "csrc")

HOST_CPP = r"""
#define __host__
#define __device__
#include "gather_eval.cuh"
template <class E>
static void run(const float* tbl, long long P, const float* qrows,
                const int* r0, const int* r1, long long Q, float r2,
                float k3, int md, float* out) {
  for (long long q = 0; q < Q; ++q) {
    float acc[gvpm::N_ACC] = {0};
    const float* qr = qrows + q * E::QW;
    for (int run = 0; run < gvpm::N_RUNS; ++run)
      for (int row = r0[q * gvpm::N_RUNS + run];
           row < r1[q * gvpm::N_RUNS + run]; ++row)
        E::pair(qr, gvpm::RowRef{tbl, P, row}, md, r2, k3, acc);
    for (int c = 0; c < gvpm::N_ACC; ++c) out[q * E::N_OUT + c] = acc[c];
    out[q * E::N_OUT + gvpm::N_ACC] = 0.0f;
  }
}
extern "C" void host_gather(int surface, const float* tbl, long long P,
                            const float* qrows, const int* r0,
                            const int* r1, long long Q, float r2, float k3,
                            int md, float* out) {
  if (surface)
    run<gvpm::SurfaceEval>(tbl, P, qrows, r0, r1, Q, r2, k3, md, out);
  else
    run<gvpm::VolumeEval>(tbl, P, qrows, r0, r1, Q, r2, k3, md, out);
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("gather_eval_host")
    src = d / "host.cpp"
    src.write_text(HOST_CPP)
    so = d / "libhost.so"
    subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off",
                    "-fPIC", "-shared", "-I", CSRC, str(src), "-o",
                    str(so)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    vp = ctypes.c_void_p
    lib.host_gather.argtypes = [ctypes.c_int, vp, ctypes.c_longlong, vp,
                                vp, vp, ctypes.c_longlong, ctypes.c_float,
                                ctypes.c_float, ctypes.c_int, vp]
    lib.host_gather.restype = None
    return lib


@pytest.fixture(scope="module")
def kernel_inputs():
    """The fused gather's inputs of one port pass, by eval name."""
    from gvpm_tpu_torch import scenes
    calls = {}
    orig = fg.fused_gather

    def record(ev, *args):
        calls.setdefault(ev.name, (ev,) + args)
        return orig(ev, *args)

    fg.fused_gather = record
    try:
        scene = scenes.box_medium(SIDE, SIDE)
        gvpm.render_pass(scene, TORCH_CFG, "distance", N_PHOTONS, 0, 1,
                         1.0, 1.0, sppm.base_volume_radius(scene, TORCH_CFG))
    finally:
        fg.fused_gather = orig
    return calls


@pytest.mark.parametrize("which", ["surface", "volume"])
def test_host_compiled_kernel_math_matches_plain(host_lib, kernel_inputs,
                                                 which):
    ev, plan, tbl, qrows, r2, k3, md = kernel_inputs[which]
    ref = fg.fused_gather_plain(ev, plan, tbl, qrows, r2, k3, md)
    out = torch.empty_like(ref)
    host_lib.host_gather(int(which == "surface"), tbl.data_ptr(),
                         tbl.shape[1], qrows.data_ptr(), plan.r0.data_ptr(),
                         plan.r1.data_ptr(), qrows.shape[0], r2, k3, md,
                         out.data_ptr())
    assert float(ref[:, 27].sum()) > 0
    assert torch.equal(out[:, 27:29], ref[:, 27:29])     # visits, shift_ok
    torch.testing.assert_close(out, ref, rtol=2e-4, atol=5e-6)


def test_cpu_tensors_take_the_plain_version(kernel_inputs):
    """The wrapper routes by device: CPU tensors run the plain version
    and count no kernel launch."""
    ev, plan, tbl, qrows, r2, k3, md = kernel_inputs["volume"]
    before = dict(fg.LAUNCHES)
    got = fg.fused_gather(ev, plan, tbl, qrows, r2, k3, md)
    assert fg.LAUNCHES == before
    assert torch.equal(got, fg.fused_gather_plain(ev, plan, tbl, qrows, r2,
                                                  k3, md))


def test_kernel_launch_refuses_cpu_tensors(kernel_inputs):
    ev, plan, tbl, qrows, r2, k3, md = kernel_inputs["surface"]
    with pytest.raises(ValueError, match="CUDA"):
        fg.launch_kernel(ev, plan, tbl, qrows, r2, k3, md)
