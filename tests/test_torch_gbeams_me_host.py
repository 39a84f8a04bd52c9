"""The ME instantiations of the gradient beam / plane functors
(gvpm_tpu_torch/csrc/beam_eval.cuh: GBeam1DME, GBeam3DME, GPlane0DME),
compiled as host C++ with g++ and driven from ctypes, against the plain
PyTorch version of ops/beam_sweep.py (gsweep_plain with the _me kinds)
on the sweep inputs of one 16x16 gvpm pass of each beam volume with
manifold shifts (tests/test_torch_common.py's BEAM_ME_KW in box_medium,
where beams leave the mirror sphere). The host loop visits the pairs as
one kernel thread does, each query against every beam in order, its ME
key starting at ME_NONE.

Bar: visits, shift_ok, the ME key (the lowest packed index of an
ME-eligible accepted beam), the ME pair count and gbeam3d_me's chord
point bit-equal; sums at rtol 2e-4 / atol 5e-6 (the order of the sums
and the rounding of expf differ)."""

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
                                     BEAM_ME_TORCH_CFG, IT, N_PHOTONS, SEED,
                                     SIDE)

CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "gvpm_tpu_torch", "csrc")
VOLUMES = dict(gbeam1d_me="beam1d", gbeam3d_me="beam3d",
               gplane0d_me="plane0d")

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
    c[beam::C_KEY] = beam::ME_NONE;
    if (qq.valid)
      for (long long j = 0; j < N; ++j)
        F::visit(qq, rows + j * beam::BW, keys ? keys + 4 * j : nullptr,
                 tails + j * beam::TW, qx + m * beam::XW, p, acc, c, (int)j);
    for (int f = 0; f < F::NF; ++f) out[m * F::NF + f] = acc[f];
    for (int k = 0; k < F::NC; ++k) cnt[m * F::NC + k] = c[k];
  }
}
extern "C" void host_gsweep_me(int kind, const float* q, long long M,
                               const float* rows, const int* keys,
                               const float* tails, const float* qx,
                               long long N, int tile, float r2, float k,
                               float* out, int* cnt) {
  beam::Params p{r2, k, (uint32_t)tile};
  if (kind == 0)
    run<beam::GBeam1DME>(q, M, rows, keys, tails, qx, N, p, out, cnt);
  else if (kind == 1)
    run<beam::GBeam3DME>(q, M, rows, keys, tails, qx, N, p, out, cnt);
  else
    run<beam::GPlane0DME>(q, M, rows, keys, tails, qx, N, p, out, cnt);
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("gbeam_me_eval_host")
    src = d / "host.cpp"
    src.write_text(HOST_CPP)
    so = d / "libhost.so"
    subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off",
                    "-fPIC", "-shared", "-I", CSRC, str(src), "-o",
                    str(so)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    vp, i64, f32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
    lib.host_gsweep_me.argtypes = [ctypes.c_int, vp, i64, vp, vp, vp, vp,
                                   i64, ctypes.c_int, f32, f32, vp, vp]
    lib.host_gsweep_me.restype = None
    return lib


@pytest.fixture(scope="module")
def gsweep_inputs():
    """The first ME sweep call of one port gvpm pass of each beam volume
    (its first segment chunk; beam3d's first distance sample), by kind."""
    scene = scenes.box_medium(SIDE, SIDE, device="cpu")
    calls = {}
    orig = bs.gsweep

    def record(kind, *args):
        calls.setdefault(kind, args)
        return orig(kind, *args)

    bs.gsweep = record
    try:
        for volume in VOLUMES.values():
            gvpm.render_pass(scene, BEAM_ME_TORCH_CFG, volume, N_PHOTONS,
                             SEED, IT, 1.0, 1.0,
                             sppm.base_volume_radius(scene,
                                                     BEAM_ME_TORCH_CFG))
    finally:
        bs.gsweep = orig
    return calls


@pytest.mark.parametrize("kind", bs.GKINDS_ME)
def test_host_compiled_me_functors_match_plain(host_lib, gsweep_inputs,
                                               kind):
    q, qx, rows, tails, p = gsweep_inputs[kind]
    M, N = q.shape[0], rows.shape[0]
    nf = bs.NF_GRAD + (3 if kind == "gbeam3d_me" else 0)
    out = torch.empty((M, nf))
    cnt = torch.empty((M, 4), dtype=torch.int32)
    keys = p.keys.contiguous() if p.keys is not None else None
    host_lib.host_gsweep_me(bs.GKINDS_ME.index(kind), q.data_ptr(), M,
                            rows.data_ptr(),
                            keys.data_ptr() if keys is not None else None,
                            tails.data_ptr(), qx.data_ptr(), N, int(p.tile),
                            float(p.r2), float(p.k), out.data_ptr(),
                            cnt.data_ptr())
    got = bs._grad_out(out, cnt)
    want = bs.gsweep_plain(kind, q, qx, rows, tails, p)
    assert len(got) == len(want) == 8
    assert int(want[3].sum()) > 50 and int(want[4].sum()) > 50
    me_queries = int((want[5] != bs.ME_NONE).sum())
    assert me_queries > 0 and int(want[6].sum()) > me_queries
    for k, name in ((3, "visits"), (4, "shift_ok"), (5, "ME key"),
                    (6, "ME pairs")):
        assert torch.equal(got[k], want[k]), name
    if kind == "gbeam3d_me":
        assert torch.equal(got[7].view(torch.int32),
                           want[7].view(torch.int32)), "chord point"
        assert bool((want[7][want[5] != bs.ME_NONE] != 0).any(dim=1).all())
    else:
        assert got[7] is None and want[7] is None
    for g, w, name in zip(got[:3], want[:3], ("primal", "S", "W")):
        torch.testing.assert_close(g, w, rtol=2e-4, atol=5e-6, msg=name)


@pytest.mark.parametrize("kind", bs.GKINDS_ME)
def test_plain_me_sweep_in_blocks(gsweep_inputs, kind, monkeypatch):
    """The plain version's ME outputs do not depend on its blocking: with
    blocks of 256 beams and 64 queries (as on the card, where the pairs
    of a 128^2 pass need dozens of blocks) the keys, counts and chord
    points are those of one block, the sums within rounding."""
    args = gsweep_inputs[kind]
    one = bs.gsweep_plain(kind, *args)
    monkeypatch.setattr(bs, "PLAIN_MAX_PAIRS", 1 << 14)
    blocks = bs.gsweep_plain(kind, *args)
    assert args[2].shape[0] > 4 * 256 and args[0].shape[0] > 2 * 64
    for k in (3, 4, 5, 6):
        assert torch.equal(blocks[k], one[k]), k
    if kind == "gbeam3d_me":
        assert torch.equal(blocks[7], one[7])
        assert bool((one[7] != 0).any())
    for k in range(3):
        torch.testing.assert_close(blocks[k], one[k], rtol=1e-6, atol=1e-9)


def test_me_sweep_without_eligible_beams_is_the_sweep(gsweep_inputs):
    """An ME sweep whose tails mark no beam returns the ME-off sweep's
    outputs bit for bit, no key and no ME pair; with the marks, the
    marked beams' pairs lose their identity shifts only."""
    q, qx, rows, tails, p = gsweep_inputs["gbeam1d_me"]
    marked = tails[:, bs.TSLOT["reconnectable"]] < -0.5
    assert bool(marked.any())
    plain = tails.clone()
    plain[marked, bs.TSLOT["reconnectable"]] = 0.0
    off = bs.gsweep("gbeam1d", q, qx, rows, plain, p)
    me = bs.gsweep("gbeam1d_me", q, qx, rows, plain, p)
    for a, b in zip(off, me[:5]):
        assert torch.equal(a, b)
    assert bool((me[5] == bs.ME_NONE).all()) and int(me[6].sum()) == 0
    marked_sweep = bs.gsweep("gbeam1d_me", q, qx, rows, tails, p)
    assert torch.equal(marked_sweep[0], off[0])          # the base terms
    assert torch.equal(marked_sweep[3], off[3])          # visits
    assert torch.equal(marked_sweep[4], off[4])          # reconnections


def test_cpu_tensors_take_the_me_plain_version(gsweep_inputs):
    q, qx, rows, tails, p = gsweep_inputs["gplane0d_me"]
    before = dict(bs.LAUNCHES)
    got = bs.gsweep("gplane0d_me", q, qx, rows, tails, p)
    assert bs.LAUNCHES == before
    want = bs.gsweep_plain("gplane0d_me", q, qx, rows, tails, p)
    assert all(torch.equal(g, w) for g, w in zip(got[:7], want[:7]))
    with pytest.raises(ValueError, match="CUDA"):
        bs.launch_kernel("gplane0d_me", q, rows, p, qx=qx, tails=tails)
