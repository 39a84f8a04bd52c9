"""Carry state from the JAX package into the port.

Everything crosses as numpy arrays, so this module imports no JAX:
the caller hands over `np.asarray` of each field. The Scene tables are
this system's weights; the stage buffers (photon SoA, gather points,
camera segments) let a test feed each port stage the JAX stage's own
inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from .integrators.gatherpoint import GatherPoints
from .scene.builder import scene_from_numpy


def _tensor(a, device):
    a = np.asarray(a)
    if a.dtype == np.bool_:
        dt = torch.bool
    elif np.issubdtype(a.dtype, np.floating):
        dt = torch.float32
    else:
        dt = torch.int64
    return torch.tensor(a, dtype=dt, device=device)


def scene_from_arrays(arrays, width, height, cam_aperture=0.0,
                      cam_focus=1.0, het_medium=-1, device="cpu"):
    """The port's Scene from the JAX Scene's tensor fields (numpy) and
    its static fields."""
    return scene_from_numpy(arrays, device, width=width, height=height,
                            cam_aperture=cam_aperture, cam_focus=cam_focus,
                            het_medium=het_medium)


def tensors_from_arrays(arrays, device="cpu"):
    """dict of numpy arrays -> dict of tensors (float32 / int64 / bool);
    the photon SoA and the camera-segment dicts use this directly."""
    return {k: _tensor(v, device) for k, v in arrays.items()}


def gather_points_from_arrays(arrays, device="cpu") -> GatherPoints:
    return GatherPoints(**tensors_from_arrays(arrays, device))

