"""gvpm_tpu_torch imports no JAX: a fresh interpreter with jax and flax
made unimportable imports the port and renders one small pass."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import sys
sys.modules["jax"] = None
sys.modules["flax"] = None
import torch
import gvpm_tpu_torch
from gvpm_tpu_torch import scenes
from gvpm_tpu_torch.core.config import GradientConfig
from gvpm_tpu_torch.integrators import gvpm, sppm
scene = scenes.box_medium(8, 8)
cfg = GradientConfig(max_depth=4, null_bounces=2, max_cam_depth=4,
                     surface_photons=1 << 8, volume_photons=1 << 8,
                     volume_samples=1, grid_dims=(8, 8, 8),
                     use_manifold=False)
out = gvpm.render(scene, cfg, passes=1)
assert torch.isfinite(out["image"]).all()
loaded = [m for m in sys.modules
          if m.split(".")[0] in ("jax", "jaxlib", "flax")
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
