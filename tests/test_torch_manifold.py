"""The port's manifold (ME) shift module against gvpm_tpu's on the CPU:
chain extraction, the Newton-solved volume and surface shifts, the
identity property and the occlusion sweep.

Inputs: photons shot by the JAX package, carried over through
gvpm_tpu_torch.interop, in three scenes: the mirror-wall box of
tests/test_manifold.py ("wall": a mirror back wall makes ME-eligible
photons plentiful; every chain prim is a triangle), the package's
box_medium ("sphere": chains off its mirror sphere, the scene of the
headline and golden runs, which takes the sphere roots of `_prim_hit`)
and its caustic_glass ("glass": chains through a dielectric sphere, which
takes the refraction and Fresnel branches). Shift targets are the photon
positions plus a seeded numpy offset of a pixel footprint's size.

Bars: every discrete chain field equal, chain floats at rtol 1e-5 /
atol 1e-6; `ok` of the shifts equal lane for lane (no lane flips on
these inputs; the bound allowed is 2% of lanes); alpha_ratio, pdf_ratio
and wi_new at rtol 1e-3 / atol 1e-5 on lanes both sides accept (reached:
about 1e-6 relative — the Jacobians come from forward-mode products on
both sides and Newton is self-correcting, so the LU solve there and the
adjugate solve here end at the same root)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvpm_tpu import scenes as jscenes
from gvpm_tpu.core import rng as jrng
from gvpm_tpu.core.config import GradientConfig as JaxConfig
from gvpm_tpu.integrators import manifold as jmanifold
from gvpm_tpu.integrators import sppm as jsppm
from gvpm_tpu_torch import interop
from gvpm_tpu_torch.integrators import manifold
from gvpm_tpu_torch.scene import SceneBuilder
from gvpm_tpu_torch.scene import types as st
from tests.test_torch_common import jax_mirror_scene, port_scene_from_jax
from tests.test_torch_common import torch_threads  # noqa: F401

LANES = 128
FOOTPRINT = 0.01     # ~ one pixel's footprint in this unit box
SCALE = 1.7
MAX_FLIPS = 0.02
IDENTITY_ATOL = {"wall": 2e-3, "sphere": 1e-2, "glass": 2e-2}


def _eligible(scene, ph, vtype):
    """ME-eligible photons of one vertex type (numpy mask), as the
    gather kernels select them."""
    bty = scene.bsdf_type.numpy()
    pb = bty[np.clip(ph["parent_bsdf"], 0, len(bty) - 1)]
    m = ((ph["vtype"] == vtype) & ~ph["reconnectable"]
         & (ph["parent_type"] == 1)
         & ((pb == st.BSDF_CONDUCTOR) | (pb == st.BSDF_DIELECTRIC)))
    if vtype == 1:
        ob = bty[np.clip(ph["bsdf"], 0, len(bty) - 1)]
        m &= ~((ob == st.BSDF_CONDUCTOR) | (ob == st.BSDF_DIELECTRIC)
               | (ob == st.BSDF_NULL))
    return m


# scene, light paths (enough for >= 64 eligible photons of each kind),
# the world diagonal the gathers pass as scene_scale
CASES = {"wall": (lambda: jax_mirror_scene(8), 1 << 12),
         "sphere": (lambda: jscenes.box_medium(8, 8), 1 << 14),
         "glass": (lambda: jscenes.caustic_glass(8, 8), 1 << 16)}


@pytest.fixture(scope="module", params=list(CASES))
def me_case(request):
    make, n_photons = CASES[request.param]
    js = make()
    cfg = JaxConfig(max_depth=5, surface_photons=n_photons,
                    volume_photons=n_photons)
    jph, _ = jsppm.shoot_photons(js, cfg, n_photons,
                                 jrng.pass_key(2, 0, jrng.STREAM_LIGHT))
    ph = {k: np.asarray(v) for k, v in jph.items()}
    scene = port_scene_from_jax(js)
    tph = interop.tensors_from_arrays(ph, device="cpu")
    rs = np.random.RandomState(7)
    case = dict(name=request.param, js=js, jph=jph, scene=scene, tph=tph)
    for name, vtype in (("volume", 2), ("surface", 1)):
        idx = np.nonzero(_eligible(scene, ph, vtype))[0][:LANES]
        assert len(idx) >= 64, (name, len(idx))
        off = rs.uniform(-1.0, 1.0, (len(idx), 3)).astype(np.float32)
        case[name] = dict(
            idx=idx, target=ph["p"][idx] + FOOTPRINT * off,
            jch=jmanifold.pull_chains(js, jph, jnp.asarray(idx)),
            tch=manifold.pull_chains(scene, tph, torch.tensor(idx)))
    return case


def _shift(case, which, side, target):
    """Run one side's ME shift on `target` ([L,3] numpy) -> numpy tuple
    (alpha_ratio, pdf_ratio, ok, wi_new)."""
    c = case[which]
    idx = c["idx"]
    if side == "jax":
        ph, ch, arr = case["jph"], c["jch"], jnp.asarray
        mod, scene = jmanifold, case["js"]
    else:
        ph, ch, arr = case["tph"], c["tch"], torch.tensor
        mod, scene = manifold, case["scene"]
    if which == "volume":
        out = mod.me_shift_volume(scene, ch, arr(target), scene_scale=SCALE)
    else:
        ns = np.asarray(ph["ns"])[idx]
        enter = (np.asarray(ph["wi"])[idx] * ns).sum(-1) < 0.0
        out = mod.me_shift_surface(
            scene, ch, arr(np.asarray(ph["prim"])[idx]), arr(ns),
            arr(enter), arr(target), scene_scale=SCALE)
    return tuple(np.asarray(a) for a in out)


@pytest.mark.parametrize("which", ["volume", "surface"])
def test_pull_chains_match_jax(me_case, which):
    jch, tch = me_case[which]["jch"], me_case[which]["tch"]
    assert set(jch) == set(tch)
    assert int(tch["ok"].sum()) == len(me_case[which]["idx"])
    for name, ref in jch.items():
        ref, got = np.asarray(ref), tch[name].numpy()
        assert got.shape == ref.shape, name
        if ref.dtype.kind in "biu":
            np.testing.assert_array_equal(got, ref, err_msg=name)
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6,
                                       err_msg=name)


@pytest.mark.parametrize("which", ["volume", "surface"])
def test_me_shift_matches_jax(me_case, which):
    target = me_case[which]["target"]
    ref = _shift(me_case, which, "jax", target)
    got = _shift(me_case, which, "port", target)
    flips = int((ref[2] != got[2]).sum())
    assert flips <= MAX_FLIPS * len(target), flips
    assert flips == 0      # none on these inputs (ROADMAP section 3)
    both = ref[2] & got[2]
    assert int(both.sum()) >= 32
    for k, name in ((0, "alpha_ratio"), (1, "pdf_ratio"), (3, "wi_new")):
        np.testing.assert_allclose(got[k][both], ref[k][both], rtol=1e-3,
                                   atol=1e-5, err_msg=name)
    # rejected lanes carry zero ratios
    assert not got[0][~got[2]].any() and not got[1][~got[2]].any()


@pytest.mark.parametrize("which", ["volume", "surface"])
def test_me_shift_identity(me_case, which):
    """Shifting a photon to its own position converges to u = 0 and
    every ratio cancels: alpha_ratio == pdf_ratio == 1, on the 64 lanes
    and at the atol of tests/test_manifold.py (float32 noise in the two
    Jacobian determinants reaches 3.5e-3 on three of the later lanes, in
    the JAX module and here alike). Off the curved prims of the two
    sphere scenes that noise is larger (6.6e-3 off the mirror sphere,
    1.5e-2 through the focusing glass sphere), so they are held at
    IDENTITY_ATOL."""
    own = me_case["tph"]["p"][torch.tensor(me_case[which]["idx"])].numpy()
    ar, pr, ok, _ = (a[:64] for a in _shift(me_case, which, "port", own))
    atol = IDENTITY_ATOL[me_case["name"]]
    assert ok.mean() > 0.9
    np.testing.assert_allclose(ar[ok], 1.0, atol=atol)
    np.testing.assert_allclose(pr[ok], 1.0, atol=atol)


def test_chain_occlusion_blocker():
    """A shifted chain whose anchor->vertex segment passes through a
    blocker is rejected; a clear one passes (the hand-made case of
    tests/test_manifold.py::test_chain_occlusion_blocker)."""
    b = SceneBuilder()
    white = b.diffuse([0.7] * 3)
    mirror = b.conductor()
    light = b.area_light([10.0] * 3)
    b.rectangle([0, 0, 1], [0, 1, 0], [1, 0, 0], mirror)      # tris 0,1
    b.rectangle([0.33, 0.45, 0.5], [0, 0.1, 0], [0.09, 0, 0],
                white)                                        # blocker
    b.rectangle([0.4, 0.998, 0.4], [0.2, 0, 0], [0, 0, 0.2], white,
                emitter=light)
    b.camera(origin=[0.5, 0.5, -1.2], target=[0.5, 0.5, 0.5], fov=42)
    scene = b.build(width=4, height=4, device="cpu")

    anchors = np.array([[0.25, 0.5, 0.0],    # crosses the blocker
                        [0.75, 0.5, 0.0]])   # clear
    hitp = np.array([0.5, 0.5, 1.0])
    w1 = hitp[None] - anchors
    w1 = w1 / np.linalg.norm(w1, axis=-1, keepdims=True)
    n = np.array([0.0, 0.0, -1.0])
    refl = w1 - 2.0 * (w1 @ n)[:, None] * n[None]
    end_p = hitp[None] + 0.3 * refl

    K, L = manifold.K_MAX, 2
    prim = torch.full((K, L), -1, dtype=torch.int64)
    prim[0] = 0
    ch = dict(
        k=torch.ones((L,), dtype=torch.int64), prim=prim,
        enter=torch.ones((K, L), dtype=torch.bool),
        branch_refl=torch.ones((K, L), dtype=torch.bool),
        eta=torch.ones((K, L)),
        is_diel=torch.zeros((K, L), dtype=torch.bool),
        seg_med=torch.full((K + 1, L), -1, dtype=torch.int64),
        anchor_p=torch.tensor(anchors, dtype=torch.float32))
    blocked = manifold.chain_occluded(
        scene, ch, torch.tensor(w1, dtype=torch.float32),
        torch.tensor(end_p, dtype=torch.float32))
    assert blocked.tolist() == [True, False]


def test_beam_variant_is_not_ported(me_case):
    with pytest.raises(NotImplementedError, match="item 14"):
        manifold.me_shift_beam(me_case["scene"], {}, None)
    with pytest.raises(NotImplementedError, match="item 14"):
        manifold.pull_chains(me_case["scene"], me_case["tph"],
                             torch.zeros(1, dtype=torch.int64), virt={})
