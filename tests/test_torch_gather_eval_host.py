"""The CUDA kernel's own per-pair math (gvpm_tpu_torch/csrc/
gather_eval.cuh), compiled as host C++ with g++ and driven pair by pair
from ctypes, against the plain PyTorch version of the fused gather on
the inputs of a 16x16 pass (the config of tests/test_torch_gather.py;
for the ME variants the mirror-wall pass of tests/test_torch_gather_me.py,
where ME-eligible pairs exist), and on the stress input that
chip_smoke.py runs on the card. The host loop calls the split functions as
the kernel does: `inside` on the row's head, then `body` on the row for
the pairs that pass. This is the only way the CUDA source's math runs
before it reaches the card. Bar: visits and shift_ok exact, sums at rtol
2e-4 / atol 5e-6; the ME row key (the minimum row over the pairs whose
`body<true>` returns the ME mask) exactly equal. The surface gather also
runs on a pass of scenes.feature_box's "materials" box, whose photons
land on plastic, phong and rough-conductor surfaces, and shift_math.cuh's
eval_bsdf_pdf is held against render/bsdf.eval_bsdf_pdf_params lobe by
lobe on random directions (rtol 1e-4 / atol 1e-7: host libm's expf /
powf against PyTorch's, a few ulp apart, which the Beckmann term's
exp(-tan^2 / alpha^2) scales by its argument, up to ~40: 5 of 12,288
rough-conductor values sit 1.3e-5 apart)."""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from chip_smoke import stress_inputs
from gvpm_tpu_torch.integrators import gradient_gather, gvpm, sppm
from gvpm_tpu_torch.ops import fused_gather as fg
from gvpm_tpu_torch.render.bsdf import eval_bsdf_pdf_params
from gvpm_tpu_torch.scene.types import (BSDF_DIFFUSE, BSDF_PHONG,
                                        BSDF_PLASTIC, BSDF_ROUGH_CONDUCTOR)
from tests.test_torch_common import (torch_threads,  # noqa: F401
                                     ME_TORCH_CFG, N_PHOTONS, SIDE,
                                     TORCH_CFG, jax_mirror_scene,
                                     port_scene_from_jax)

CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "gvpm_tpu_torch", "csrc")

HOST_CPP = r"""
#define __host__
#define __device__
#include "gather_eval.cuh"
template <class E, bool ME>
static void run(const float* tbl, const float* head, long long P,
                long long row_w,
                const float* qrows, const int* r0, const int* r1,
                long long Q, float r2, float k3, int md, float* out,
                int* me_row) {
  for (long long q = 0; q < Q; ++q) {
    float acc[gvpm::N_ACC] = {0};
    gvpm::AccSink sink{acc};
    int me_min = gvpm::ME_NONE;
    const float* qr = qrows + q * E::QW;
    for (int run = 0; run < gvpm::N_RUNS; ++run)
      for (long long row = r0[q * gvpm::N_RUNS + run];
           row < r1[q * gvpm::N_RUNS + run]; ++row) {
        float h[gvpm::H_WIDTH];
        for (int k = 0; k < 4; ++k) {
          h[k] = head[row * 4 + k];
          h[4 + k] = head[(P + row) * 4 + k];
        }
        if (!E::inside(qr, h, md, r2)) continue;
        bool me = E::template body<ME>(
            qr, gvpm::RowRef{tbl + row * row_w}, r2, k3, sink);
        if (ME && me && row < me_min) me_min = (int)row;
      }
    for (int c = 0; c < gvpm::N_ACC; ++c) out[q * E::N_OUT + c] = acc[c];
    out[q * E::N_OUT + gvpm::N_ACC] = 0.0f;
    if (ME) me_row[q] = me_min;
  }
}
extern "C" void host_eval_bsdf(long long n, const int* btype,
                               const float* par, const float* wi,
                               const float* wo, float* f, float* pdf) {
  for (long long i = 0; i < n; ++i) {
    const float* p = par + i * 11;
    gvpm::BsdfParams bp{btype[i], {p[0], p[1], p[2]}, {p[3], p[4], p[5]},
                        {p[6], p[7], p[8]}, p[9], p[10]};
    gvpm::eval_bsdf_pdf(bp, {wi[3 * i], wi[3 * i + 1], wi[3 * i + 2]},
                        {wo[3 * i], wo[3 * i + 1], wo[3 * i + 2]},
                        f + 3 * i, pdf[i]);
  }
}
extern "C" void host_gather(int surface, int me, const float* tbl,
                            const float* head, long long P, long long row_w,
                            const float* qrows, const int* r0,
                            const int* r1, long long Q, float r2, float k3,
                            int md, float* out, int* me_row) {
#define RUN(E, M) run<gvpm::E, M>(tbl, head, P, row_w, qrows, r0, r1, Q, \
                                  r2, k3, md, out, me_row)
  if (surface && me) RUN(SurfaceEval, true);
  else if (surface) RUN(SurfaceEval, false);
  else if (me) RUN(VolumeEval, true);
  else RUN(VolumeEval, false);
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
    lib.host_gather.argtypes = [ctypes.c_int, ctypes.c_int, vp, vp,
                                ctypes.c_longlong, ctypes.c_longlong, vp,
                                vp, vp,
                                ctypes.c_longlong, ctypes.c_float,
                                ctypes.c_float, ctypes.c_int, vp, vp]
    lib.host_gather.restype = None
    lib.host_eval_bsdf.argtypes = [ctypes.c_longlong] + [vp] * 6
    lib.host_eval_bsdf.restype = None
    return lib


@pytest.fixture(scope="module")
def kernel_inputs():
    """The fused gather's inputs of one port pass without ME (the box)
    and one with ME (the mirror-wall box), by eval name, and of a pass
    of the materials box ("surface:materials")."""
    from gvpm_tpu_torch import scenes
    calls = {}
    orig = fg.fused_gather

    def record(ev, *args):
        calls.setdefault(ev.name, (ev,) + args)
        return orig(ev, *args)

    fg.fused_gather = record
    try:
        for scene, cfg in (
                (scenes.box_medium(SIDE, SIDE, device="cpu"), TORCH_CFG),
                (port_scene_from_jax(jax_mirror_scene()), ME_TORCH_CFG)):
            gvpm.render_pass(scene, cfg, "distance", N_PHOTONS, 0, 1, 1.0,
                             1.0, sppm.base_volume_radius(scene, cfg))
        mat = {}
        fg.fused_gather = lambda ev, *a: (mat.setdefault(ev.name, (ev,) + a),
                                          orig(ev, *a))[1]
        gvpm.render_pass(scenes.feature_scene("materials", SIDE, SIDE,
                                              device="cpu"),
                         TORCH_CFG, "distance", N_PHOTONS, 0, 1, 1.0, 1.0,
                         sppm.base_volume_radius(scene, TORCH_CFG))
        calls["surface:materials"] = mat["surface"]
    finally:
        fg.fused_gather = orig
    return calls


def _host_gather(host_lib, ev, plan, tbl, qrows, r2, k3, md):
    out = torch.empty((qrows.shape[0], ev.n_out))
    me_row = torch.empty((qrows.shape[0],), dtype=torch.int32)
    head = fg.row_heads(ev, tbl)
    assert tbl.is_contiguous() and qrows.is_contiguous()
    host_lib.host_gather(int(ev.name.startswith("surface")), int(ev.me),
                         tbl.data_ptr(), head.data_ptr(), *tbl.shape,
                         qrows.data_ptr(),
                         plan.r0.data_ptr(), plan.r1.data_ptr(),
                         qrows.shape[0], r2, k3, md, out.data_ptr(),
                         me_row.data_ptr())
    return out, me_row


EVALS = ["surface", "volume", "surface_me", "volume_me"]


@pytest.mark.parametrize("which", EVALS + ["surface:materials"])
def test_host_compiled_kernel_math_matches_plain(host_lib, kernel_inputs,
                                                 which):
    ev, plan, tbl, qrows, r2, k3, md = kernel_inputs[which]
    ref, ref_me = fg.fused_gather_plain(ev, plan, tbl, qrows, r2, k3, md)
    out, me_row = _host_gather(host_lib, ev, plan, tbl, qrows, r2, k3, md)
    assert float(ref[:, 27].sum()) > 0
    assert torch.equal(out[:, 27:29], ref[:, 27:29])     # visits, shift_ok
    torch.testing.assert_close(out, ref, rtol=2e-4, atol=5e-6)
    assert (ref_me is not None) == ev.me
    if ev.me:
        assert int((ref_me != fg.ME_NONE).sum()) > 0
        assert torch.equal(me_row, ref_me)


@pytest.mark.parametrize("which", EVALS)
def test_kernel_source_reads_only_the_slots_counted(host_lib, kernel_inputs,
                                                    which):
    """`slots_read` (what the kernel's bound counts as bytes that must
    move) covers every slot csrc/gather_eval.cuh reads: with NaN in every
    other slot of the photon table and of the query rows, the padding
    included, the host-compiled source returns the same bits. It counts
    fewer slots than the rows hold, and more with the min_depth test."""
    ev, plan, tbl, qrows, r2, k3, _md = kernel_inputs[which]
    for md in (0, 1):
        row_slots, q_slots = fg.slots_read(ev, md)
        assert len(row_slots) < gradient_gather.N_SLOTS
        assert len(q_slots) < ev.q_width
        tbl_nan = torch.full_like(tbl, torch.nan)
        tbl_nan[:, row_slots] = tbl[:, row_slots]
        q_nan = torch.full_like(qrows, torch.nan)
        q_nan[:, q_slots] = qrows[:, q_slots]
        want, want_me = _host_gather(host_lib, ev, plan, tbl, qrows, r2, k3,
                                     md)
        got, got_me = _host_gather(host_lib, ev, plan, tbl_nan, q_nan, r2,
                                   k3, md)
        assert float(want[:, 27].sum()) > 0
        assert torch.equal(got, want)
        assert not ev.me or torch.equal(got_me, want_me)
    assert len(fg.slots_read(ev, 1)[0]) == len(fg.slots_read(ev, 0)[0]) + 1


@pytest.mark.parametrize("which", EVALS)
def test_stress_input_host_source_matches_plain(host_lib, which):
    """The stress input of chip_smoke.py (one query with hundreds of
    visits, long and empty runs, a ragged last tile, invalid queries, a
    lowest ME row in a late run) through the plain version and the
    host-compiled source."""
    ev = gradient_gather.EVALS[which]
    r0, r1, tbl, qrows, r2, k3, md, hot = stress_inputs(ev)
    plan = fg.Plan(torch.arange(r0.shape[0]), r0, r1)
    ref, ref_me = fg.fused_gather_plain(ev, plan, tbl, qrows, r2, k3, md)
    out, me_row = _host_gather(host_lib, ev, plan, tbl, qrows, r2, k3, md)
    lens = plan.r1 - plan.r0
    assert qrows.shape[0] % 64 and int(lens.max()) > 128
    assert int((lens == 0).sum()) > 0 and int(ref[hot, 27]) > 256
    valid = qrows[:, ev.q_slots["valid" if "valid" in ev.q_slots
                                else "sok"]] > 0.5
    assert 0 < int(valid.sum()) < valid.numel()
    assert float(ref[~valid].abs().sum()) == 0.0
    assert torch.equal(out[:, 27:29], ref[:, 27:29])
    assert int(ref[:, 28].sum()) > 0
    torch.testing.assert_close(out, ref, rtol=2e-4, atol=5e-6)
    if ev.me:
        assert torch.equal(me_row, ref_me)
        assert int((ref_me != fg.ME_NONE).sum()) > 0
        # the hot query's lowest ME row lies in one of its last runs
        assert int(plan.r0[hot, 7]) <= int(ref_me[hot]) < fg.ME_NONE


@pytest.mark.parametrize("btype", [BSDF_DIFFUSE, BSDF_ROUGH_CONDUCTOR,
                                   BSDF_PHONG, BSDF_PLASTIC])
def test_host_eval_bsdf_pdf_matches_plain(host_lib, btype):
    """shift_math.cuh::eval_bsdf_pdf, the kernel's baked-parameter BSDF
    at the base and the shifted points, on each reconnectable lobe with
    randomized parameters (rough conductor alpha 0.05-0.6, phong
    exponents 1-60, plastic IOR 1.3-1.8) and random directions."""
    rs = np.random.default_rng(btype)
    n = 4096
    par = np.concatenate([
        rs.uniform(0.05, 0.95, (n, 3)),           # albedo
        rs.uniform(0.0, 4.0, (n, 3)) if btype == BSDF_ROUGH_CONDUCTOR
        else rs.uniform(0.0, 0.5, (n, 3)),        # k / phong specular
        rs.uniform(0.2, 1.5, (n, 3)),             # conductor eta
        rs.uniform(0.05, 0.6, (n, 1)) if btype != BSDF_PHONG
        else rs.uniform(1.0, 60.0, (n, 1)),       # alpha / exponent
        rs.uniform(1.3, 1.8, (n, 1))], axis=1).astype(np.float32)
    wi, wo = (rs.normal(size=(n, 3)).astype(np.float32) for _ in range(2))
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    wi[:, 2] = np.abs(wi[:, 2])                   # the upper side
    wo[: n // 2, 2] = np.abs(wo[: n // 2, 2])
    bt = np.full(n, btype, np.int32)
    f = np.zeros((n, 3), np.float32)
    pdf = np.zeros(n, np.float32)
    host_lib.host_eval_bsdf(n, *(a.ctypes.data for a in (bt, par, wi, wo,
                                                         f, pdf)))
    t = torch.from_numpy(par)
    params = dict(btype=torch.from_numpy(bt.astype(np.int64)),
                  alb=t[:, 0:3].unbind(-1), spec=t[:, 3:6].unbind(-1),
                  eta3=t[:, 6:9].unbind(-1), alpha=t[:, 9], eta1=t[:, 10])
    fr, fg_, fb, pdf_ref = eval_bsdf_pdf_params(
        params, torch.from_numpy(wi).unbind(-1),
        torch.from_numpy(wo).unbind(-1))
    ref = torch.stack([fr, fg_, fb], dim=-1).numpy()
    assert (pdf_ref > 0).float().mean() > 0.3
    np.testing.assert_allclose(f, ref, rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(pdf, pdf_ref.numpy(), rtol=1e-4, atol=1e-7)


def test_cpu_tensors_take_the_plain_version(kernel_inputs):
    """The wrapper routes by device: CPU tensors run the plain version
    and count no kernel launch."""
    ev, plan, tbl, qrows, r2, k3, md = kernel_inputs["volume"]
    before = dict(fg.LAUNCHES)
    got, me_row = fg.fused_gather(ev, plan, tbl, qrows, r2, k3, md)
    assert fg.LAUNCHES == before and me_row is None
    assert torch.equal(got, fg.fused_gather_plain(ev, plan, tbl, qrows, r2,
                                                  k3, md)[0])


def test_kernel_launch_refuses_cpu_tensors(kernel_inputs):
    ev, plan, tbl, qrows, r2, k3, md = kernel_inputs["surface"]
    with pytest.raises(ValueError, match="CUDA"):
        fg.launch_kernel(ev, plan, tbl, qrows, r2, k3, md)
