"""The ME Newton kernel's own math (gvpm_tpu_torch/csrc/me_newton.cuh),
compiled as host C++ with g++ and driven lane by lane through ctypes with
the argument structs of ops/me_newton.py, against the plain PyTorch
solve (`manifold._newton3_plain` / `_newton2_plain`) on the same inputs.

Inputs: the three scenes of tests/test_torch_manifold.py's `me_case`
(the mirror-wall box, box_medium's mirror sphere, caustic_glass's
dielectric sphere) at its path counts, 128 ME-eligible photons of each
vertex type shot by the port's own light pass, and the beam case of
tests/test_torch_beam_me_shift.py (ME-eligible beams of box_medium, a
virtual photon at a seeded point of each); targets the photon (or beam
point) plus a seeded offset of a pixel footprint's size, and of ten,
where steps meet the trust region and lanes end unconverged; scene
scale 1.7. The volume and beam targets take the 3-unknown solve, the surface
target the 2-unknown one.

Bars (chip_smoke.me_newton_against_plain, which the card's tests and
chip_smoke.py hold the kernel to): the decisions lane for lane (`conv`,
`ok_tr` and each step's |det J| > 1e-18 guard); u, rho_off, rho_base,
the Fresnel terms, the segment lengths and the beam's exit point or the
surface's t_end at rtol 1e-4 / atol 1e-6; the anchor and exit
directions at rtol 1e-4 / atol 2e-6 (unit vectors: the last Newton step
carries the two versions' rounding through J^-1, and on a headline pass
1 exit-direction component of 49,152 read 1.25e-6 apart); the first
Jacobian against torch.func.jvp's at rtol 1e-5 / atol 1e-6. Reached
here: bit for bit off triangles, ~1e-7 relative through the spheres.
The header's constants equal manifold.py's, rounded to float."""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from chip_smoke import (me_newton_against_plain, me_newton_plain,
                        me_newton_traced)
from gvpm_tpu_torch import scenes
from gvpm_tpu_torch.core import rng
from gvpm_tpu_torch.core.config import GradientConfig
from gvpm_tpu_torch.integrators import gradient_gather, manifold, sppm
from gvpm_tpu_torch.ops import me_newton
from gvpm_tpu_torch.scene import SceneBuilder
from gvpm_tpu_torch.scene import types as st
from tests.test_torch_common import torch_threads  # noqa: F401
CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "gvpm_tpu_torch", "csrc")

LANES = 128
# target offsets: ~ one pixel's footprint in these unit boxes (`near`),
# and ten of them (`far`), where steps meet the trust region and lanes
# end unconverged
FOOTPRINTS = {"near": 0.01, "far": 0.1}
SCALE = 1.7
N_ITERS = 5
BEAM_PATHS = 1 << 11

HOST_CPP = r"""
#define __host__
#define __device__
#include "me_newton.cuh"
extern "C" void host_me_newton(const gvpm::me::In* in,
                               const gvpm::me::Out* out) {
  for (long long l = 0; l < in->L; ++l) {
    if (in->target == gvpm::me::TARGET_SURFACE)
      gvpm::me::solve_lane<2>(*in, *out, l);
    else
      gvpm::me::solve_lane<3>(*in, *out, l);
  }
}
extern "C" void host_constants(double* c) {
  c[0] = gvpm::me::K_MAX;
  c[1] = gvpm::me::NEWTON_EPS;
  c[2] = gvpm::me::MAX_STEP;
  c[3] = gvpm::me::MAX_DEV;
  c[4] = gvpm::me::DET_EPS;
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("me_newton_host")
    src = d / "host.cpp"
    src.write_text(HOST_CPP)
    so = d / "libhost.so"
    subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off",
                    "-fPIC", "-shared", "-I", CSRC, str(src), "-o",
                    str(so)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.host_me_newton.argtypes = [ctypes.POINTER(me_newton.In),
                                   ctypes.POINTER(me_newton.Out)]
    lib.host_me_newton.restype = None
    lib.host_constants.argtypes = [ctypes.c_void_p]
    lib.host_constants.restype = None
    return lib


def mirror_wall(side=8):
    """tests/test_torch_common.jax_mirror_scene, on the port's builder."""
    b = SceneBuilder()
    white = b.diffuse([0.7] * 3)
    mirror = b.conductor()
    light = b.area_light([30.0] * 3)
    b.rectangle([0, 0, 0], [0, 0, 1], [1, 0, 0], white)
    b.rectangle([0, 0, 1], [0, 1, 0], [1, 0, 0], mirror)
    b.rectangle([0.35, 0.998, 0.35], [0.3, 0, 0], [0, 0, 0.3], white,
                emitter=light)
    m = b.homogeneous(sigma_a=[0.05] * 3, sigma_s=[0.3] * 3, g=0.0)
    b.medium_box([0.02] * 3, [0.98] * 3, m)
    b.camera(origin=[0.5, 0.5, -1.2], target=[0.5, 0.5, 0.5], fov=42)
    return b.build(width=side, height=side, device="cpu")


# me_case's scenes and light paths
SCENES = {"wall": (mirror_wall, 1 << 12),
          "sphere": (lambda: scenes.box_medium(8, 8, device="cpu"), 1 << 14),
          "glass": (lambda: scenes.caustic_glass(8, 8, device="cpu"),
                    1 << 16)}
CASES = [(s, t, f) for s in SCENES for t in ("volume", "surface")
         for f in FOOTPRINTS] + [("sphere", "beam", f) for f in FOOTPRINTS]


def _eligible(scene, ph, vtype):
    """ME-eligible photons of one vertex type (test_torch_manifold)."""
    bty = scene.bsdf_type
    pb = bty[torch.clamp(ph["parent_bsdf"], 0, len(bty) - 1)]
    delta = (pb == st.BSDF_CONDUCTOR) | (pb == st.BSDF_DIELECTRIC)
    m = (ph["vtype"] == vtype) & ~ph["reconnectable"] \
        & (ph["parent_type"] == 1) & delta
    if vtype == 1:
        ob = bty[torch.clamp(ph["bsdf"], 0, len(bty) - 1)]
        m &= ~((ob == st.BSDF_CONDUCTOR) | (ob == st.BSDF_DIELECTRIC)
               | (ob == st.BSDF_NULL))
    return m


def _targets(rs, at):
    """{footprint name: at [n, 3] moved by a seeded offset of its size}."""
    off = rs.uniform(-1.0, 1.0, (at.shape[0], 3))
    return {f: at + torch.tensor(size * off, dtype=torch.float32)
            for f, size in FOOTPRINTS.items()}


@pytest.fixture(scope="module")
def inputs():
    """{(scene, target, footprint): (scene, chain dict, c_target, photon
    args)}."""
    out = {}
    for name, (make, n_paths) in SCENES.items():
        scene = make()
        cfg = GradientConfig(max_depth=5, surface_photons=n_paths,
                             volume_photons=n_paths)
        ph, beams = sppm.shoot_photons(
            scene, cfg, n_paths, rng.pass_key(2, 0, rng.STREAM_LIGHT),
            with_beams=False)
        rs = np.random.RandomState(7)
        for target, vtype in (("volume", 2), ("surface", 1)):
            idx = torch.nonzero(_eligible(scene, ph, vtype))[:LANES, 0]
            assert len(idx) >= 64, (name, target, len(idx))
            ch = manifold.pull_chains(scene, ph, idx)
            c_t = _targets(rs, ph["p"][idx])
            photon = None
            if target == "surface":
                ns = ph["ns"][idx]
                photon = (ph["prim"][idx], ns,
                          (ph["wi"][idx] * ns).sum(-1) < 0.0)
            for f in FOOTPRINTS:
                out[name, target, f] = (scene, ch, c_t[f], photon)
    scene = SCENES["sphere"][0]()
    cfg = GradientConfig(max_depth=5, surface_photons=BEAM_PATHS,
                         volume_photons=BEAM_PATHS)
    ph, beams = sppm.shoot_photons(scene, cfg, BEAM_PATHS,
                                   rng.pass_key(2, 0, rng.STREAM_LIGHT))
    idx = torch.nonzero(gradient_gather._beam_me_elig(scene, beams))[
        :LANES, 0]
    assert len(idx) >= 64, len(idx)
    rs = np.random.RandomState(11)
    frac = torch.tensor(rs.uniform(0.1, 0.9, len(idx)), dtype=torch.float32)
    y = beams["o"][idx] + beams["d"][idx] * (frac * beams["length"][idx])[
        :, None]
    virt = dict(p=y, seg_med=beams["med"][idx],
                parent_idx=beams["parent_idx"][idx],
                reconnectable=torch.zeros(len(idx), dtype=torch.bool),
                parent_type=beams["parent_type"][idx],
                parent_bsdf=beams["parent_bsdf"][idx])
    ch = manifold.pull_chains(scene, ph, virt=virt)
    for f, c_t in _targets(rs, y).items():
        out["sphere", "beam", f] = (scene, ch, c_t, None)
    return out


def test_constants_match_manifold(host_lib):
    c = np.zeros(5)
    host_lib.host_constants(c.ctypes.data)
    assert c[0] == manifold.K_MAX == me_newton.K_MAX
    for got, want in zip(c[1:], (manifold.NEWTON_EPS, manifold.MAX_STEP,
                                 manifold.MAX_DEV, 1e-18)):
        assert got == np.float32(want), (got, want)


@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
def test_host_solve_matches_plain(host_lib, inputs, case):
    target = case[1]
    scene, ch, c_t, photon = inputs[case]
    scale = torch.tensor([SCALE])
    want = me_newton_plain(target, scene, ch, c_t, photon, N_ITERS, scale)
    got = me_newton_traced(
        lambda inp, out: host_lib.host_me_newton(ctypes.byref(inp),
                                                 ctypes.byref(out)),
        target, scene, ch, c_t, photon, N_ITERS, scale)
    _, converged = me_newton_against_plain(target, got, want)
    assert converged >= LANES // 2
