"""The ME Newton kernel on the card (csrc/me_newton.cu through
ops/me_newton.py): built from gvpm_tpu_torch/csrc and launched once a
shift call of a gvpm pass with ME (never the plain version:
`me/newton_plain_lanes` stays 0); ops/me_newton.solve, as the port calls
it, equal to the plain version, which the port runs on the CPU, on CPU
copies of every shift call's inputs of that pass, at
chip_smoke.me_newton_against_plain's bars (the decisions lane
for lane; u, the geometric terms, the chain terms and the exit point or
distance at rtol 1e-4 / atol 1e-6, the anchor and exit directions at
atol 2e-6; the first Jacobian at rtol 1e-5 / atol 1e-6); two launches
bitwise equal; CPU tensors refused. The pass: tests/test_torch_gvpm_me.py's
configuration (one more bounce than the gvpm tests, a wide volume
radius, a pair budget of 16) in box_medium (the mirror sphere) and
caustic_glass (the dielectric sphere) at 32^2 and 2^12 light paths.

Needs a CUDA card and skips without one. It imports no JAX:

    python -m pytest --noconftest -o addopts="" -m gpu \\
        tests/test_torch_cuda_me_newton.py
"""

import pytest
import torch

from chip_smoke import (capture_me_shifts, me_newton_against_plain,
                        me_newton_cpu, me_newton_launch, me_newton_plain,
                        me_newton_same_bits, me_newton_traced)
from gvpm_tpu_torch import scenes
from gvpm_tpu_torch.core.config import GradientConfig
from gvpm_tpu_torch.core.logging import StatsCounter
from gvpm_tpu_torch.integrators import gvpm, manifold, sppm
from gvpm_tpu_torch.ops import me_newton

pytestmark = pytest.mark.gpu

N_PATHS = 1 << 12
CFG = GradientConfig(max_depth=5, null_bounces=2, max_cam_depth=4,
                     surface_photons=N_PATHS, volume_photons=N_PATHS,
                     volume_samples=1, vol_segments_per_pixel=2,
                     grid_dims=(16, 16, 16), grid_surface_rows=1024,
                     grid_volume_rows=1024, initial_scale_volume=4.0,
                     use_manifold=True, me_pair_budget=16)


@pytest.fixture(scope="module", params=["box_medium", "caustic_glass"])
def captured(request):
    """The pass's shift calls (chip_smoke.capture_me_shifts), and the
    kernel launches, lanes and plain lanes it counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    scene = getattr(scenes, request.param)(32, 32)   # default device: the card
    plain = StatsCounter.get("me/newton_plain_lanes")
    lanes = StatsCounter.get("me/newton_lanes")
    before = (dict(me_newton.LAUNCHES), lanes.value(), plain.value())
    calls = capture_me_shifts(lambda: gvpm.render_pass(
        scene, CFG, "distance", N_PATHS, 0, 1, 1.0, 1.0,
        sppm.base_volume_radius(scene, CFG)))
    torch.cuda.synchronize()
    counted = ({k: v - before[0][k] for k, v in me_newton.LAUNCHES.items()},
               lanes.value() - before[1], plain.value() - before[2])
    return calls, counted


def test_each_shift_call_launches_the_kernel(captured):
    calls, (launches, lanes, plain_lanes) = captured
    assert {c[0] for c in calls} == {"volume", "surface"}
    assert launches == {t: sum(c[0] == t for c in calls)
                        for t in me_newton.TARGETS}
    assert lanes == sum(c[3].shape[0] for c in calls) > 0
    assert plain_lanes == 0


def test_kernel_matches_plain(captured):
    calls, _ = captured
    for target, scene, ch, c_t, photon, n_iters, scale in calls:
        assert c_t.is_cuda and torch.is_tensor(scale) and scale.is_cuda
        scale = scale.reshape(1)
        s_cpu, ch_cpu, c_cpu, ph_cpu, sc_cpu = me_newton_cpu(
            scene, ch, c_t, photon, scale)
        want = me_newton_plain(target, s_cpu, ch_cpu, c_cpu, ph_cpu,
                               n_iters, sc_cpu)
        # the first Jacobian and the steps from a traced launch
        _, j0, steps = me_newton_traced(me_newton_launch, target, scene, ch,
                                        c_t, photon, n_iters, scale)
        got = me_newton.solve(target, scene, ch, c_t, n_iters, scale, photon)
        torch.cuda.synchronize()
        _, converged = me_newton_against_plain(target, (got, j0, steps),
                                               want)
        assert converged > 0


def test_two_launches_give_the_same_bits(captured):
    calls, _ = captured
    for target, scene, ch, c_t, photon, n_iters, scale in calls:
        assert me_newton_same_bits(*(
            me_newton.solve(target, scene, ch, c_t, n_iters, scale, photon)
            for _ in range(2)))


def test_cpu_tensors_never_reach_the_kernel(captured):
    calls, _ = captured
    target, scene, ch, c_t, photon, n_iters, scale = calls[0]
    scene, ch, c_t, photon, scale = me_newton_cpu(scene, ch, c_t, photon,
                                                  scale)
    with pytest.raises(ValueError, match="CUDA tensors"):
        me_newton.solve(target, scene, ch, c_t, n_iters, scale, photon)
    # the shift itself takes the plain version for them
    launches = dict(me_newton.LAUNCHES)
    plain = StatsCounter.get("me/newton_plain_lanes")
    before = plain.value()
    if target == "surface":
        manifold.me_shift_surface(scene, ch, *photon, c_t, n_iters=n_iters,
                                  scene_scale=scale)
    else:
        manifold.me_shift_volume(scene, ch, c_t, n_iters=n_iters,
                                 scene_scale=scale)
    assert me_newton.LAUNCHES == launches
    assert plain.value() - before == c_t.shape[0]
