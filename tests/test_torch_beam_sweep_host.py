"""The beam/plane sweep kernel's own per-pair math (gvpm_tpu_torch/csrc/
beam_eval.cuh), compiled as host C++ with g++ and driven from ctypes,
against the plain PyTorch version of ops/beam_sweep.py on the sweep
inputs of one 16x16 SPPM pass of each estimator (tests/
test_torch_common.py's config), and its threefry against
core/rng.uniform bit for bit. The host loop visits each query against
every beam in order through the functor's test and base parts; the
three kinds also run in csrc/gsweep.cu's queued order
(test_torch_common.QUEUED_HOST_CPP), on those inputs and on
chip_smoke.beam_stress_inputs (beam1d's also moved far from the origin,
where its pre-test's guard is just held and where it is exceeded). The
text variants of tools/sweep_variants.py are checked against the
sources. This is the only way the CUDA source's
math runs before it reaches the card. Bar: accepted-pair counts exactly
equal; sums at rtol 2e-4 / atol 5e-6 (the order of the sums and the
rounding of expf differ)."""

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
from chip_smoke import BEAM1D_FAR_SHIFTS, beam_stress_inputs
from tests.test_torch_common import (torch_threads,  # noqa: F401
                                     N_PHOTONS, QUEUED_HOST_CPP, SIDE,
                                     SPPM_KW, build_host_library,
                                     gsweep_source_shape,
                                     queued_against_plain)

CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "gvpm_tpu_torch", "csrc")

HOST_CPP = r"""
#define __host__
#define __device__
#include "beam_eval.cuh"
// a test / base functor's pair (Beam1D, Beam3D, Plane0D): its test
// (Beam1D's pre-test guarded by the query's and the beam's line scales),
// then its base
template <class F>
struct Parts {
  static bool pair(const beam::Query& q, const float* b, const int* key,
                   const beam::Params& p, float c[3]) {
    beam::Params g = p;
    g.pre_r2 = beam::pre_r2(p.r2, beam::line_scale(q.o, q.len) +
                                      beam::line_scale(beam::ld3(b, beam::B_O),
                                                       b[beam::B_LEN]));
    typename F::Geo geo;
    typename F::Base s;
    if (!beam::test_row<F>(q, b, g, geo) || !F::base(q, b, key, p, geo, s))
      return false;
    for (int ch = 0; ch < 3; ++ch) c[ch] = s.c[ch];
    return true;
  }
};
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
  if (kind == 0) run<Parts<beam::Beam1D>>(q, M, rows, keys, N, p, out, cnt);
  else if (kind == 1)
    run<Parts<beam::Beam3D>>(q, M, rows, keys, N, p, out, cnt);
  else run<Parts<beam::Plane0D>>(q, M, rows, keys, N, p, out, cnt);
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
    # the kernel's test lets through every accepted pair and few others
    assert int(want_cnt.sum()) <= stats["pretest"] \
        < q.shape[0] * rows.shape[0] // 4


@pytest.fixture(scope="module")
def queued_lib(tmp_path_factory):
    return build_host_library(tmp_path_factory, QUEUED_HOST_CPP)


@pytest.mark.parametrize("kind", ("beam1d", "beam3d", "plane0d"))
def test_queued_order_matches_plain(queued_lib, sweep_inputs, kind):
    """csrc/gsweep.cu's order (a warp's 32 lanes testing a query against
    32 x SWEEP_U beams, the ring, batches of a pair a lane) at the
    source's shape, in one split and in splits of one beam tile."""
    assert kind in bs.QUEUED
    want = queued_against_plain(queued_lib, kind, sweep_inputs[kind])
    assert int(want[1].sum()) > 50


# the stress inputs: each kind's, and beam1d's moved far from the origin
STRESS = [pytest.param(kind, 0.0, id=kind) for kind in bs.KINDS] \
    + [pytest.param("beam1d", s, id=f"beam1d-moved-{s:g}")
       for s in BEAM1D_FAR_SHIFTS]


@pytest.mark.parametrize("kind, shift", STRESS)
def test_queued_order_on_stress_input(queued_lib, kind, shift):
    """A hot query accepting 800 beams over seven beam tiles (its pairs
    wrap the ring many times and straddle the splits), beams within 1% of
    r, beams inside the pre-test's margin that the exact test rejects,
    near-parallel and parallel beams (beam1d), grazing beams whose chord
    samples base rejects (beam3d), planes with u0, u1 or tcam within a few
    ulp of an edge, |det| across 1e-7 and planes (nearly) parallel to the
    query (plane0d), ragged counts, invalid queries and a medium
    mismatch. beam1d's input moved by `shift` along each axis puts
    its lines' scales A (a query's and a beam tile's, csrc/beam_eval.cuh
    line_scale) just inside the pre-test's guard (A < 8,192 r, where the
    pre-test's rounding bound is tightest) or all past it (the pre-test
    radius is +inf: every pair goes on to the exact test)."""
    q, rows, p, hot = beam_stress_inputs(kind, shift=shift)
    stats = {}
    want = queued_against_plain(queued_lib, kind, (q, rows, p), stats=stats)
    shape = gsweep_source_shape()
    assert int(want[1][hot]) >= 800 > 3 * shape["tile_b"]
    assert q.shape[0] % shape["tq"] != 0
    assert rows.shape[0] % shape["tile_b"] != 0
    assert int(want[1][q[:, bs.QSLOT["valid"]] < 0.5].sum()) == 0
    # pairs the kernel's test passes on and base rejects: beam1d's margin
    # (and its near-parallel beams), beam3d's grazing chords, plane0d's
    # margin at the edges
    accepted = int(want[1].sum())
    assert stats["pretest"] > accepted + (10 if kind == "plane0d" else 40)
    if kind == "beam3d":
        assert stats["stage2"] > accepted
    if shift:
        assert shape["tile_b"] == bs.TILE_B
        o, r = bs.QSLOT["o"], p.r2 ** 0.5
        valid = q[:, bs.QSLOT["valid"]] > 0.5
        scale = (q[valid, o:o + 3].abs().amax(1)
                 + q[valid, bs.QSLOT["length"]].abs())[:, None] \
            + bs._tile_scales(rows)[None, :]
        same = int((valid[:, None] & (q[:, bs.QSLOT["med"]][:, None]
                                      == rows[:, bs.BSLOT["med"]])).sum())
        if shift == min(BEAM1D_FAR_SHIFTS):
            assert 7900 * r < float(scale.min()) \
                <= float(scale.max()) < 8192 * r
            assert stats["pretest"] < same // 4
        else:
            assert float(scale.min()) > 8192 * r
            assert stats["pretest"] == same


def test_sweep_variants_apply_to_the_sources():
    """Each text variant of tools/sweep_variants.py matches one place of
    csrc/gsweep.cu and its headers, so that none is timed as a silent
    copy of the base."""
    from gvpm_tpu_torch.tools import sweep_variants as sv
    for name in sv.VARIANTS:
        texts = sv.variant_sources(name, CSRC)
        assert (name == "base") == all(
            texts[f] == open(os.path.join(CSRC, f)).read() for f in texts)


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
    shape = gsweep_source_shape()
    for M, N in ((32768, 1_000_000), (512, 3000), (1, 1), (5000, 129)):
        splits, chunk = bs.split_plan(M, N, shape["p_tq"], shape["tile_b"],
                                      bs.GTARGET_BLOCKS)
        assert chunk % shape["tile_b"] == 0 and 1 <= splits
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
