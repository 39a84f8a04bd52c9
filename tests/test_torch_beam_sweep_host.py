"""The beam/plane sweep kernel's own per-pair math (gvpm_tpu_torch/csrc/
beam_eval.cuh), compiled as host C++ with g++ and driven from ctypes,
against the plain PyTorch version of ops/beam_sweep.py on the sweep
inputs of one 16x16 SPPM pass of each estimator (tests/
test_torch_common.py's config), and its threefry against
core/rng.uniform bit for bit. The host loop visits the pairs as one
kernel thread does: each query against every beam in order. This is the
only way the CUDA source's math runs before it reaches the card. Bar:
accepted-pair counts exactly equal; sums at rtol 2e-4 / atol 5e-6 (the
order of the sums and the rounding of expf differ)."""

import ctypes
import os
import shutil
import subprocess

import pytest
import torch

from gvpm_tpu_torch import scenes
from gvpm_tpu_torch.core import rng
from gvpm_tpu_torch.core.config import PhotonConfig
from gvpm_tpu_torch.integrators import sppm
from gvpm_tpu_torch.ops import beam_sweep as bs
from tests.test_torch_common import (torch_threads,  # noqa: F401
                                     N_PHOTONS, SIDE, SPPM_KW)

CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "gvpm_tpu_torch", "csrc")

HOST_CPP = r"""
#define __host__
#define __device__
#include "beam_eval.cuh"
template <class F>
static void run(const float* q, long long M, const float* rows,
                const int* keys, long long N, beam::Params p, float* out,
                int* cnt) {
  for (long long m = 0; m < M; ++m) {
    beam::Query qq = beam::load_query(q + m * beam::QW, (uint32_t)m);
    float acc[3] = {0.0f, 0.0f, 0.0f};
    int n = 0;
    if (qq.valid)
      for (long long j = 0; j < N; ++j) {
        float c[3];
        if (F::pair(qq, rows + j * beam::BW, keys ? keys + 4 * j : nullptr,
                    p, c)) {
          for (int ch = 0; ch < 3; ++ch) acc[ch] += c[ch];
          ++n;
        }
      }
    for (int ch = 0; ch < 3; ++ch) out[m * 3 + ch] = acc[ch];
    cnt[m] = n;
  }
}
extern "C" void host_sweep(int kind, const float* q, long long M,
                           const float* rows, const int* keys, long long N,
                           int tile, float r2, float k, float* out,
                           int* cnt) {
  beam::Params p{r2, k, (uint32_t)tile};
  if (kind == 0) run<beam::Beam1D>(q, M, rows, keys, N, p, out, cnt);
  else if (kind == 1) run<beam::Beam3D>(q, M, rows, keys, N, p, out, cnt);
  else run<beam::Plane0D>(q, M, rows, keys, N, p, out, cnt);
}
extern "C" void host_uniform(unsigned k0, unsigned k1, long long n,
                             float* out) {
  for (long long i = 0; i < n; ++i)
    out[i] = beam::counter_uniform(k0, k1, (uint32_t)i);
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("beam_eval_host")
    src = d / "host.cpp"
    src.write_text(HOST_CPP)
    so = d / "libhost.so"
    subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off",
                    "-fPIC", "-shared", "-I", CSRC, str(src), "-o",
                    str(so)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    vp, i64 = ctypes.c_void_p, ctypes.c_longlong
    lib.host_sweep.argtypes = [ctypes.c_int, vp, i64, vp, vp, i64,
                               ctypes.c_int, ctypes.c_float, ctypes.c_float,
                               vp, vp]
    lib.host_sweep.restype = None
    lib.host_uniform.argtypes = [ctypes.c_uint, ctypes.c_uint, i64, vp]
    lib.host_uniform.restype = None
    return lib


@pytest.fixture(scope="module")
def sweep_inputs():
    """The sweep calls of one port SPPM pass of each beam estimator (the
    first of beam3d's two distance samples), by kind."""
    scene = scenes.box_medium(SIDE, SIDE, device="cpu")
    cfg = PhotonConfig(**dict(SPPM_KW, volume_samples=2))
    calls = {}
    orig = bs.sweep

    def record(kind, *args):
        calls.setdefault(kind, args)
        return orig(kind, *args)

    bs.sweep = record
    try:
        for volume in bs.KINDS:
            sppm.render_pass(scene, cfg, volume, N_PHOTONS, 0, 1, 1.0, 1.0,
                             sppm.base_volume_radius(scene, cfg))
    finally:
        bs.sweep = orig
    return calls


def _host_sweep(lib, kind, q, rows, p):
    M, N = q.shape[0], rows.shape[0]
    out = torch.empty((M, 3))
    cnt = torch.empty((M,), dtype=torch.int32)
    keys = p.keys.contiguous() if p.keys is not None else None
    lib.host_sweep(bs.KINDS.index(kind), q.data_ptr(), M, rows.data_ptr(),
                   keys.data_ptr() if keys is not None else None, N,
                   int(p.tile), float(p.r2), float(p.k), out.data_ptr(),
                   cnt.data_ptr())
    return out, cnt


@pytest.mark.parametrize("kind", bs.KINDS)
def test_host_compiled_pair_math_matches_plain(host_lib, sweep_inputs, kind):
    q, rows, p = sweep_inputs[kind]
    assert q.is_contiguous() and rows.is_contiguous()
    stats = {}
    want, want_cnt = bs.sweep_plain(kind, q, rows, p, stats=stats)
    got, cnt = _host_sweep(host_lib, kind, q, rows, p)
    assert int(want_cnt.sum()) > 50
    assert torch.equal(cnt, want_cnt)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=5e-6)
    # the second stage (beam3d: the threefry words) runs for a small
    # share of the pairs
    assert int(want_cnt.sum()) <= stats["stage2"] < q.shape[0] * rows.shape[0]


def test_host_threefry_matches_rng_uniform(host_lib):
    """counter_uniform of the header at positions 0..n-1 is
    rng.uniform(key, (n,)), bit for bit, for keys that fold_in and split
    make (words above 2^31 included)."""
    keys = torch.cat([rng.split(rng.key(7), 3),
                      rng.fold_in(rng.key(123), torch.arange(3))])
    assert int(keys.max()) >= 2 ** 31
    n = 4096
    for k in keys:
        out = torch.empty((n,))
        host_lib.host_uniform(int(k[0]), int(k[1]), n, out.data_ptr())
        want = rng.uniform(k, (n,))
        assert torch.equal(out.view(torch.int32), want.view(torch.int32))
    m, tile = 3, 256
    k = keys[0]
    want = rng.uniform(k, (m, tile))
    got = rng.counter_uniform(k[0], k[1], torch.arange(m)[:, None] * tile
                              + torch.arange(tile)[None, :])
    assert torch.equal(got, want)


def test_beam_keys_and_split_plan():
    """beam_keys: each kept beam's tile key and lane as int32 bits;
    split_plan: whole tiles per split, every beam covered once."""
    tile_keys = torch.tensor([[1, 2 ** 32 - 1], [2 ** 31, 5]])
    orig = torch.tensor([0, 3, 255, 256, 300])
    keys = bs.beam_keys(tile_keys, orig, 256)
    assert keys.dtype == torch.int32
    assert keys[:, 2].tolist() == [0, 3, 255, 0, 44]
    assert (keys[:, :2].to(torch.int64) & rng.M32).tolist() == \
        [[1, 2 ** 32 - 1]] * 3 + [[2 ** 31, 5]] * 2
    for M, N in ((32768, 1_000_000), (512, 3000), (1, 1), (5000, 129)):
        splits, chunk = bs.split_plan(M, N)
        assert chunk % bs.TILE_B == 0 and 1 <= splits
        assert (splits - 1) * chunk < N <= splits * chunk


def test_sweep_scalars_are_host_floats(sweep_inputs):
    """The estimators hand r2 and k to the wrapper as Python floats, read
    once a call: a device scalar would synchronize at every launch."""
    for kind in bs.KINDS:
        p = sweep_inputs[kind][2]
        assert isinstance(p.r2, float) and isinstance(p.k, float), kind
    assert sweep_inputs["beam1d"][2].r2 > 0.0


def test_cpu_tensors_take_the_plain_version(sweep_inputs):
    q, rows, p = sweep_inputs["beam1d"]
    before = dict(bs.LAUNCHES)
    got = bs.sweep("beam1d", q, rows, p)
    assert bs.LAUNCHES == before
    want = bs.sweep_plain("beam1d", q, rows, p)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="CUDA"):
        bs.launch_kernel("beam1d", q, rows, p)
    with pytest.raises(ValueError, match="pair function"):
        bs.sweep("beam2d", q, rows, p)
