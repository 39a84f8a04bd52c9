"""The gradient beam / plane functors of the sweep kernel
(gvpm_tpu_torch/csrc/beam_eval.cuh: GBeam1D, GBeam3D, GPlane0D),
compiled as host C++ with g++ and driven from ctypes, against the plain
PyTorch version of ops/beam_sweep.py (gsweep_plain) on the sweep inputs
of one 16x16 gvpm pass of each beam volume (tests/test_torch_common.py's
config, use_manifold=False). The host loop visits the pairs as one
kernel thread does: each query against every beam in order. This is the
only way the CUDA source's gradient math runs before it reaches the
card. Bar: visits and shift_ok exactly equal; sums at rtol 2e-4 / atol
5e-6 (the order of the sums and the rounding of expf differ)."""

import ctypes
import os
import shutil
import subprocess

import pytest
import torch

from gvpm_tpu_torch import scenes
from gvpm_tpu_torch.integrators import gvpm, sppm
from gvpm_tpu_torch.ops import beam_sweep as bs
from tests.test_torch_common import (torch_threads,  # noqa: F401
                                     IT, N_PHOTONS, SEED, SIDE, TORCH_CFG)

CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "gvpm_tpu_torch", "csrc")
VOLUMES = dict(gbeam1d="beam1d", gbeam3d="beam3d", gplane0d="plane0d")

HOST_CPP = r"""
#define __host__
#define __device__
#include "beam_eval.cuh"
template <class F>
static void run(const float* q, long long M, const float* rows,
                const int* keys, const float* tails, const float* qx,
                long long N, beam::Params p, float* out, int* cnt) {
  for (long long m = 0; m < M; ++m) {
    beam::Query qq = beam::load_query(q + m * beam::QW, (uint32_t)m);
    float acc[F::NF] = {};
    int c[F::NC] = {};
    if (qq.valid)
      for (long long j = 0; j < N; ++j)
        F::visit(qq, rows + j * beam::BW, keys ? keys + 4 * j : nullptr,
                 tails + j * beam::TW, qx + m * beam::XW, p, acc, c);
    for (int f = 0; f < F::NF; ++f) out[m * F::NF + f] = acc[f];
    for (int k = 0; k < F::NC; ++k) cnt[m * F::NC + k] = c[k];
  }
}
extern "C" void host_gsweep(int kind, const float* q, long long M,
                            const float* rows, const int* keys,
                            const float* tails, const float* qx,
                            long long N, int tile, float r2, float k,
                            float* out, int* cnt) {
  beam::Params p{r2, k, (uint32_t)tile};
  if (kind == 0)
    run<beam::GBeam1D>(q, M, rows, keys, tails, qx, N, p, out, cnt);
  else if (kind == 1)
    run<beam::GBeam3D>(q, M, rows, keys, tails, qx, N, p, out, cnt);
  else
    run<beam::GPlane0D>(q, M, rows, keys, tails, qx, N, p, out, cnt);
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("gbeam_eval_host")
    src = d / "host.cpp"
    src.write_text(HOST_CPP)
    so = d / "libhost.so"
    subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off",
                    "-fPIC", "-shared", "-I", CSRC, str(src), "-o",
                    str(so)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    vp, i64, f32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
    lib.host_gsweep.argtypes = [ctypes.c_int, vp, i64, vp, vp, vp, vp, i64,
                                ctypes.c_int, f32, f32, vp, vp]
    lib.host_gsweep.restype = None
    return lib


@pytest.fixture(scope="module")
def gsweep_inputs():
    """The first gradient sweep call of one port gvpm pass of each beam
    volume (beam3d: its first chunk and distance sample), by kind."""
    scene = scenes.box_medium(SIDE, SIDE, device="cpu")
    calls = {}
    orig = bs.gsweep

    def record(kind, *args):
        calls.setdefault(kind, args)
        return orig(kind, *args)

    bs.gsweep = record
    try:
        for volume in VOLUMES.values():
            gvpm.render_pass(scene, TORCH_CFG, volume, N_PHOTONS, SEED, IT,
                             1.0, 1.0,
                             sppm.base_volume_radius(scene, TORCH_CFG))
    finally:
        bs.gsweep = orig
    return calls


@pytest.mark.parametrize("kind", bs.GKINDS)
def test_host_compiled_gradient_math_matches_plain(host_lib, gsweep_inputs,
                                                   kind):
    q, qx, rows, tails, p = gsweep_inputs[kind]
    M, N = q.shape[0], rows.shape[0]
    for a, w in ((q, bs.QW), (qx, bs.XW), (rows, bs.BW), (tails, bs.TW)):
        assert a.is_contiguous() and a.shape[1] == w
    out = torch.empty((M, bs.NF_GRAD))
    cnt = torch.empty((M, 2), dtype=torch.int32)
    keys = p.keys.contiguous() if p.keys is not None else None
    host_lib.host_gsweep(bs.GKINDS.index(kind), q.data_ptr(), M,
                         rows.data_ptr(),
                         keys.data_ptr() if keys is not None else None,
                         tails.data_ptr(), qx.data_ptr(), N, int(p.tile),
                         float(p.r2), float(p.k), out.data_ptr(),
                         cnt.data_ptr())
    got = bs._grad_out(out, cnt)
    want = bs.gsweep_plain(kind, q, qx, rows, tails, p)
    assert int(want[3].sum()) > 50 and int(want[4].sum()) > 50
    assert torch.equal(got[3], want[3]), "visits"
    assert torch.equal(got[4], want[4]), "shift_ok"
    for g, w, name in zip(got[:3], want[:3], ("primal", "S", "W")):
        torch.testing.assert_close(g, w, rtol=2e-4, atol=5e-6, msg=name)


def test_cpu_tensors_take_the_gradient_plain_version(gsweep_inputs):
    q, qx, rows, tails, p = gsweep_inputs["gbeam1d"]
    before = dict(bs.LAUNCHES)
    got = bs.gsweep("gbeam1d", q, qx, rows, tails, p)
    assert bs.LAUNCHES == before
    want = bs.gsweep_plain("gbeam1d", q, qx, rows, tails, p)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="CUDA"):
        bs.launch_kernel("gbeam1d", q, rows, p, qx=qx, tails=tails)
    with pytest.raises(ValueError, match="gradient pair function"):
        bs.gsweep("beam1d", q, qx, rows, tails, p)
