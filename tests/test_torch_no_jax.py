"""gvpm_tpu_torch imports no JAX and nothing of the JAX package: a fresh
interpreter with jax, flax and gvpm_tpu made unimportable imports every
module of the port, renders with the default manifold shifts, renders
SPPM (every volume estimator, and a pass of every built-in and feature
scene), gvpm `bre`, volpath and a 4x4 path-space-shift G-PT render,
round-trips a
PFM, and saves and resumes a checkpoint of both progressive loops, and
imports the command-line renderer, the Mitsuba loader, BDPT and G-BDPT
and renders a 4x4 G-BDPT image through `cli.main(... --device cpu)`; and
no source file of the port, nor chip_smoke.py, holds an import of them."""

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "flax", "gvpm_tpu")

SCRIPT = r"""
import os, sys, tempfile
sys.modules["jax"] = None
sys.modules["flax"] = None
sys.modules["gvpm_tpu"] = None
import torch
import gvpm_tpu_torch
from gvpm_tpu_torch import scenes
from gvpm_tpu_torch.core.config import GradientConfig
from gvpm_tpu_torch.integrators import gvpm, sppm
scene = scenes.box_medium(8, 8, device="cpu")
cfg = GradientConfig(max_depth=4, null_bounces=2, max_cam_depth=4,
                     surface_photons=1 << 8, volume_photons=1 << 8,
                     volume_samples=1, grid_dims=(8, 8, 8))
assert cfg.use_manifold
with tempfile.TemporaryDirectory() as d:
    ck = os.path.join(d, "ck.npz")
    gvpm.render(scene, cfg, passes=1, checkpoint_path=ck)       # save
    assert os.path.exists(ck)
    seen = []
    out = gvpm.render(scene, cfg, passes=2, checkpoint_path=ck,
                      callback=lambda it, img, st: seen.append(it))
    assert seen == [1], seen                                    # resumed
assert torch.isfinite(out["image"]).all()
import pkgutil, importlib
for m in pkgutil.walk_packages(gvpm_tpu_torch.__path__, "gvpm_tpu_torch."):
    importlib.import_module(m.name)
from gvpm_tpu_torch import entry
from gvpm_tpu_torch.core.config import PhotonConfig, VolPathConfig
from gvpm_tpu_torch.integrators import volpath
from gvpm_tpu_torch.utils import image
pcfg = PhotonConfig(max_depth=4, null_bounces=2, max_cam_depth=4,
                    surface_photons=1 << 8, volume_photons=1 << 8,
                    volume_samples=1, grid_hash_size=1 << 10)
with tempfile.TemporaryDirectory() as d:
    ck = os.path.join(d, "ck.npz")
    sppm.render(scene, pcfg, passes=1, checkpoint_path=ck)
    seen = []
    res = sppm.render(scene, pcfg, passes=2, checkpoint_path=ck,
                      callback=lambda it, img: seen.append(it))
    assert seen == [1], seen
    img = volpath.render(scene, VolPathConfig(spp=1, max_depth=4))
    pfm = os.path.join(d, "v.pfm")
    image.write_pfm(pfm, img.numpy())
    assert (image.read_pfm(pfm) == img.numpy()).all()
assert torch.isfinite(res["image"]).all() and torch.isfinite(img).all()
# every SPPM volume estimator (the beam sweeps' plain version) and the
# gvpm bre pass
for v in ("bre", "beam1d", "beam3d", "plane0d"):
    assert torch.isfinite(sppm.render_pass(
        scene, pcfg, v, 1 << 8, 0, 0, 1.0, 1.0,
        sppm.base_volume_radius(scene, pcfg))).all(), v
assert torch.isfinite(gvpm.render(scene, cfg, volume="bre",
                                  passes=1)["image"]).all()
# the path-space-shift G-PT (reconnection, replay, L1 solve) at 4x4
from gvpm_tpu_torch.integrators import gpt_shift
g = gpt_shift.render(scenes.box_medium(4, 4, device="cpu"),
                     VolPathConfig(spp=1, max_depth=4))
assert all(torch.isfinite(v).all() for v in g.values())
# every registry scene and feature scene (dielectrics, every lobe,
# delta / env lights, heterogeneous fog, triangle-free) through SPPM
for sc in ([scenes.get(n, width=8, height=8, device="cpu")
            for n in scenes.REGISTRY]
           + [scenes.feature_scene(k, 8, 8, grid=4, device="cpu")
              for k in scenes.FEATURES]):
    assert torch.isfinite(sppm.render_pass(
        sc, pcfg, "distance", 1 << 8, 0, 0, 1.0, 1.0,
        sppm.base_volume_radius(sc, pcfg))).all()
assert callable(entry.entry)
# the command-line renderer (G-BDPT: BDPT's wavefront, the shifts and the
# L1 solve) and the Mitsuba loader
from gvpm_tpu_torch import cli
from gvpm_tpu_torch.integrators import bdpt, gbdpt
from gvpm_tpu_torch.scene import mitsuba
assert callable(mitsuba.load) and callable(bdpt.render)
with tempfile.TemporaryDirectory() as d:
    assert cli.main(["box-medium", "-i", "gbdpt", "--spp", "1",
                     "--max-depth", "3", "--width", "4", "--height", "4",
                     "--device", "cpu", "-o", os.path.join(d, "g")]) == 0
    assert image.read_pfm(os.path.join(d, "g_gx.pfm")).shape == (4, 4, 3)
loaded = [m for m in sys.modules
          if m.split(".")[0] in ("jax", "jaxlib", "flax", "gvpm_tpu")
          and sys.modules[m] is not None]
print("LOADED", loaded)
assert not loaded, loaded
"""


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "LOADED []" in res.stdout


def test_port_sources_import_no_jax_package():
    """No `import` / `from` of jax, flax or gvpm_tpu (whole word, so
    gvpm_tpu_torch does not match) in any file of the port."""
    pat = re.compile(
        r"^\s*(?:import|from)\s+(?:[\w.]+\s*,\s*)*(?:%s)(?![\w])"
        % "|".join(BLOCKED), re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "gvpm_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    bad = [(os.path.relpath(f, ROOT), m.group(0).strip())
           for f in files for m in pat.finditer(open(f).read())]
    assert not bad, bad
    assert pat.search("from gvpm_tpu.utils import checkpoint")
    assert pat.search("import os, jax")
    assert not pat.search("from gvpm_tpu_torch import scenes")


def test_entry_points_default_to_the_card():
    """Without a device argument the scene and interop entry points
    build on the CUDA card; with no card they raise instead of carrying
    on on the CPU."""
    import pytest
    import torch

    from gvpm_tpu_torch import entry, interop, scenes
    from gvpm_tpu_torch.scene import SceneBuilder
    calls = (lambda: scenes.box_medium(8, 8),
             lambda: entry.entry(),
             lambda: entry.tiny_scene(),
             *(lambda n=n: scenes.get(n, width=8, height=8)
               for n in scenes.REGISTRY),
             lambda: scenes.feature_scene("het", 8, 8, grid=4),
             lambda: SceneBuilder().build(),
             lambda: interop.tensors_from_arrays({"a": [1.0]}),
             lambda: interop.gather_points_from_arrays({}),
             lambda: interop.scene_from_arrays({}, 8, 8))
    if torch.cuda.is_available():
        assert scenes.box_medium(8, 8).device.type == "cuda"
        assert interop.tensors_from_arrays({"a": [1.0]})["a"].is_cuda
        return
    for call in calls:
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            call()
    assert scenes.box_medium(8, 8, device="cpu").device.type == "cpu"
