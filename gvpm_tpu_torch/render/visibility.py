"""Medium transitions across null boundaries
(mirrors gvpm_tpu/render/visibility.py::medium_transition)."""

from __future__ import annotations

import torch

from ..core.math import dot
from ..scene.types import Scene


def medium_transition(scene: Scene, prim, ng, d):
    """Medium index after crossing `prim` along direction d."""
    entering = dot(d, ng) < 0.0
    return torch.where(entering, scene.prim_med_in(prim),
                       scene.prim_med_out(prim))
