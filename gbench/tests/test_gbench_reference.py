"""The reference's own pieces against hand counts: the random stream's
known answer, a ray against the scene, a mirror bounce, and a chain
shifted to where it already lands."""

import math

import pytest
import torch

from gbench.reference import light, me, rng
from gbench.reference import scene as rs

SCENE = dict(name="box_medium", width=8, height=8)


def test_threefry_known_answer():
    # Random123's known-answer vector for Threefry-2x32, 20 rounds
    x0, x1 = rng.threefry(torch.tensor(0x13198A2E), torch.tensor(0x03707344),
                          torch.tensor(0x243F6A88), torch.tensor(0x85A308D3))
    assert (int(x0), int(x1)) == (0xC4923A9C, 0x483DF7A0)


def test_rows_are_positions_of_one_draw():
    k = rng.split(rng.key(7), 2)[1]
    flat = rng.at(k, torch.arange(12))
    assert torch.equal(rng.rows(k, torch.tensor([1, 3]), 3),
                       flat.reshape(4, 3)[[1, 3]])
    u = rng.rows(k, torch.arange(1000), 1)
    assert 0.0 <= float(u.min()) and float(u.max()) < 1.0


def test_ray_hits_the_floor_and_the_sphere():
    sc = rs.build(SCENE)
    o = torch.tensor([[0.8, 0.5, 0.5], [0.32, 0.9, 0.62]], dtype=torch.float64)
    d = torch.tensor([[0.0, -1.0, 0.0], [0.0, -1.0, 0.0]],
                     dtype=torch.float64)
    hit = rs.intersect(sc, o, d)
    # the fog box's top face at y 0.98 lies above the floor: the first ray
    # meets its bottom face (null) at y 0.02
    assert hit["t"][0].item() == pytest.approx(0.48)
    assert sc["mat_kind"][hit["mat"][0]] == rs.NULL
    # the second meets the mirror sphere (centre y 0.2, radius 0.2) on top
    assert hit["t"][1].item() == pytest.approx(0.9 - 0.4)
    assert hit["prim"][1].item() == sc["n_tris"]
    assert torch.allclose(hit["ng"][1], torch.tensor(
        [0.0, 1.0, 0.0], dtype=torch.float64))


def test_mirror_reflects_and_diffuse_keeps_its_side():
    sc = rs.build(SCENE)
    mirror = int(sc["sph_mat"][0])
    n = torch.tensor([[0.0, 1.0, 0.0]], dtype=torch.float64)
    d = torch.tensor([[1.0, -1.0, 0.0]], dtype=torch.float64) / math.sqrt(2)
    wo, w, pdf, ok, delta = light.sample_surface(
        sc, torch.tensor([mirror]), n, d, torch.zeros(1, 3,
                                                      dtype=torch.float64))
    assert torch.allclose(wo, torch.tensor([[1.0, 1.0, 0.0]],
                                           dtype=torch.float64) / math.sqrt(2))
    assert bool(delta[0]) and pdf.item() == 0.0 and 0 < w.min() < 1
    u = torch.rand(64, 3, dtype=torch.float64)
    wo, w, pdf, ok, delta = light.sample_surface(
        sc, torch.zeros(64, dtype=torch.int64), n.expand(64, 3),
        d.expand(64, 3), u)
    assert bool((wo[:, 1] > 0).all()) and bool(ok.all())
    assert torch.allclose(pdf, wo[:, 1] / math.pi)


def test_chain_shifted_to_its_own_photon_is_unmoved():
    sc = rs.build(SCENE)
    # anchor above the sphere's top, straight down: the mirror sends the
    # ray straight back up; the photon sits 0.1 above the anchor
    T = sc["n_tris"]
    ch = dict(ok=torch.tensor([True]), k=torch.tensor([1]),
              prim=torch.tensor([[T, -1, -1]]),
              enter=torch.tensor([[True, False, False]]),
              seg_med=torch.tensor([[0, 0, -1, 0]]),
              anchor_p=torch.tensor([[0.32, 0.7, 0.62]], dtype=torch.float64),
              anchor_ns=torch.tensor([[0.0, -1.0, 0.0]], dtype=torch.float64),
              anchor_wi=torch.tensor([[0.0, 1.0, 0.0]], dtype=torch.float64),
              anchor_type=torch.tensor([2]), anchor_bsdf=torch.tensor([-1]),
              anchor_med=torch.tensor([0]),
              sc_base=torch.full((1, 3), 0.4 / (4 * math.pi),
                                 dtype=torch.float64),
              pdf_dir_base=torch.tensor([1 / (4 * math.pi)],
                                        dtype=torch.float64),
              w1_base=torch.tensor([[0.0, -1.0, 0.0]], dtype=torch.float64),
              t_last=torch.tensor([0.4], dtype=torch.float64))
    target = torch.tensor([[0.32, 0.8, 0.62]], dtype=torch.float64)
    ar, pr, ok, wi = me.shift(sc, ch, target, "volume")
    assert bool(ok[0])
    assert torch.allclose(ar, torch.ones_like(ar), atol=1e-6)
    assert pr.item() == pytest.approx(1.0, abs=1e-6)
    assert torch.allclose(wi, torch.tensor([[0.0, 1.0, 0.0]],
                                           dtype=torch.float64))


@pytest.mark.parametrize("rr_depth", [1, 10])
def test_light_reference_follows_the_port(rr_depth):
    """The port's light pass and the reference's trace of a sample of its
    paths, with Russian roulette from the first bounce and from the
    tenth (past the paths' depth here)."""
    from gvpm_tpu_torch import scenes
    from gvpm_tpu_torch.core import rng as prng
    from gvpm_tpu_torch.core.config import GradientConfig
    from gvpm_tpu_torch.integrators import sppm
    cfg = dict(max_depth=6, null_bounces=3, rr_depth_photon=rr_depth,
               rr_clamp=0.95)
    seed, it, n = 2 ** 31 + 77, 3, 1024
    ph, _ = sppm.shoot_photons(
        scenes.box_medium(width=8, height=8, device="cpu"),
        GradientConfig(**cfg), n,
        prng.pass_key(seed, it, prng.STREAM_LIGHT), with_beams=False)
    lanes = torch.randperm(n, generator=torch.Generator().manual_seed(1))
    ref = light.trace(rs.build(SCENE), cfg, seed, it, n, lanes[:256])
    prog = {k: v.reshape((9, n) + v.shape[1:])[:, lanes[:256]]
            for k, v in ph.items() if k in ref}
    err, miss = light.compare(prog, ref, only=light.read_masks(ref))
    assert miss == 0.0 and err < 1e-5
    assert int((ref["vtype"] != light.VERT_NONE).sum()) > 256
