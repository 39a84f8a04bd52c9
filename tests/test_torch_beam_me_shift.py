"""The port's beam manifold (ME) shift against gvpm_tpu's on the CPU:
chains that start at a virtual photon (`pull_chains(..., virt=)`) and
the Newton-solved beam shift (`me_shift_beam`).

Inputs: beams shot by the JAX package in box_medium, carried over
through gvpm_tpu_torch.interop. The ME-eligible ones (gradient_gather.
_beam_me_elig: the beam leaves a delta surface vertex it cannot
reconnect, here the mirror sphere inside the fog) each get a virtual
photon at a seeded point along the beam, whose parent is the beam's
origin vertex, as the beam ME stages build them; the shift targets are
those points plus a seeded offset of a pixel footprint's size.

Bars (tests/test_torch_manifold.py's): every discrete chain field equal,
chain floats at rtol 1e-5 / atol 1e-6; `ok` of the shift equal lane for
lane; the new origin, direction and beam parameter, alpha_ratio and
pdf_ratio at rtol 1e-3 / atol 1e-5 on lanes both sides accept."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvpm_tpu import scenes as jscenes
from gvpm_tpu.core import rng as jrng
from gvpm_tpu.core.config import GradientConfig as JaxConfig
from gvpm_tpu.integrators import gradient_gather as jgg
from gvpm_tpu.integrators import manifold as jmanifold
from gvpm_tpu.integrators import sppm as jsppm
from gvpm_tpu_torch import interop
from gvpm_tpu_torch.integrators import gradient_gather, manifold
from tests.test_torch_common import port_scene_from_jax
from tests.test_torch_common import torch_threads  # noqa: F401

LANES = 128
N_PATHS = 1 << 11
FOOTPRINT = 0.01     # ~ one pixel's footprint in this unit box
SCALE = 1.7
IDENTITY_ATOL = 1e-2  # off the mirror sphere (test_torch_manifold.py)


def _virt(beams, idx, frac, mod):
    """The virtual photons of beams idx at fraction frac of their length
    (numpy beams, `mod` the array constructor of one side)."""
    p = beams["o"][idx] + beams["d"][idx] * (frac * beams["length"][idx])[
        :, None]
    return p, dict(p=mod(p.astype(np.float32)),
                   seg_med=mod(beams["med"][idx]),
                   parent_idx=mod(beams["parent_idx"][idx]),
                   reconnectable=mod(np.zeros(len(idx), bool)),
                   parent_type=mod(beams["parent_type"][idx]),
                   parent_bsdf=mod(beams["parent_bsdf"][idx]))


@pytest.fixture(scope="module")
def case():
    js = jscenes.box_medium(8, 8)
    cfg = JaxConfig(max_depth=5, surface_photons=N_PATHS,
                    volume_photons=N_PATHS)
    jph, jbeams = jsppm.shoot_photons(js, cfg, N_PATHS,
                                      jrng.pass_key(2, 0, jrng.STREAM_LIGHT))
    elig = np.asarray(jgg._beam_me_elig(js, jbeams))
    beams = {k: np.asarray(v) for k, v in jbeams.items()}
    ph = {k: np.asarray(v) for k, v in jph.items()}
    scene = port_scene_from_jax(js)
    tph = interop.tensors_from_arrays(ph, device="cpu")
    tbeams = interop.tensors_from_arrays(beams, device="cpu")
    # the port's eligibility is the JAX package's
    np.testing.assert_array_equal(
        gradient_gather._beam_me_elig(scene, tbeams).numpy(), elig)
    idx = np.nonzero(elig)[0][:LANES]
    assert len(idx) >= 64, len(idx)
    rs = np.random.RandomState(11)
    frac = rs.uniform(0.1, 0.9, len(idx)).astype(np.float32)
    y, jvirt = _virt(beams, idx, frac, jnp.asarray)
    _, tvirt = _virt({k: v for k, v in beams.items()}, idx, frac,
                     lambda a: interop.tensors_from_arrays(
                         {"a": a}, device="cpu")["a"])
    off = rs.uniform(-1.0, 1.0, (len(idx), 3)).astype(np.float32)
    return dict(js=js, scene=scene, beams=beams, idx=idx, y=y.astype(
        np.float32), target=(y + FOOTPRINT * off).astype(np.float32),
        jch=jmanifold.pull_chains(js, jph, virt=jvirt),
        tch=manifold.pull_chains(scene, tph, virt=tvirt))


def test_virtual_chains_match_jax(case):
    jch, tch = case["jch"], case["tch"]
    assert set(jch) == set(tch)
    assert int(tch["ok"].sum()) >= 64
    for name, ref in jch.items():
        ref, got = np.asarray(ref), tch[name].numpy()
        assert got.shape == ref.shape, name
        if ref.dtype.kind in "biu":
            np.testing.assert_array_equal(got, ref, err_msg=name)
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6,
                                       err_msg=name)


def test_me_shift_beam_matches_jax(case):
    ref = [np.asarray(a) for a in jmanifold.me_shift_beam(
        case["js"], case["jch"], jnp.asarray(case["target"]),
        scene_scale=SCALE)]
    got = [a.numpy() for a in manifold.me_shift_beam(
        case["scene"], case["tch"], torch.tensor(case["target"]),
        scene_scale=SCALE)]
    np.testing.assert_array_equal(got[5], ref[5])        # ok, lane by lane
    both = ref[5] & got[5]
    assert int(both.sum()) >= 32
    for k, name in enumerate(("origin_new", "dir_new", "t_new",
                              "alpha_ratio", "pdf_ratio")):
        np.testing.assert_allclose(got[k][both], ref[k][both], rtol=1e-3,
                                   atol=1e-5, err_msg=name)
    # rejected lanes carry zero ratios
    assert not got[3][~got[5]].any() and not got[4][~got[5]].any()


def test_me_shift_beam_identity(case):
    """Shifting a beam to its own point converges near u = 0: the beam's
    own origin, direction and parameter, and every ratio 1 at the sphere
    case's atol of tests/test_torch_manifold.py. The retrace meets the
    mirror sphere analytically, the light pass's stored origin is its
    intersection routine's: 2.6e-4 apart at most on these lanes, which
    turns the direction through a point ~0.1 away by up to 2.5e-3."""
    b, idx = case["beams"], case["idx"]
    org, dirn, t_new, ar, pr, ok = (a.numpy() for a in manifold.me_shift_beam(
        case["scene"], case["tch"], torch.tensor(case["y"]),
        scene_scale=SCALE))
    assert ok.mean() > 0.9
    np.testing.assert_allclose(org[ok], b["o"][idx][ok], atol=1e-3)
    np.testing.assert_allclose(dirn[ok], b["d"][idx][ok], atol=1e-2)
    np.testing.assert_allclose(
        t_new[ok], np.linalg.norm(case["y"] - b["o"][idx], axis=-1)[ok],
        atol=1e-3)
    np.testing.assert_allclose(ar[ok], 1.0, atol=IDENTITY_ATOL)
    np.testing.assert_allclose(pr[ok], 1.0, atol=IDENTITY_ATOL)
