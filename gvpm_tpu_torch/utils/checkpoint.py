"""Progressive-render checkpoint/resume (the port's own copy of
gvpm_tpu/utils/checkpoint.py; numpy only).

The whole progressive state is a handful of arrays, so a checkpoint is a
single NPZ: accumulation buffers + radius scales + pass counter. Atomic
write (tmp+rename) so a mid-write kill never corrupts the previous
checkpoint.
"""

from __future__ import annotations

import os

import numpy as np


def save(path, it, buffers, scalars):
    """buffers: dict[str, array]; scalars: dict[str, float|int]."""
    tmp = path + ".tmp"
    np.savez(tmp, __it=it,
             **{f"b_{k}": np.asarray(v) for k, v in buffers.items()},
             **{f"s_{k}": np.asarray(v) for k, v in scalars.items()})
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)


def load(path):
    """Returns (it, buffers, scalars) or None if no checkpoint."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        it = int(z["__it"])
        buffers = {k[2:]: z[k] for k in z.files if k.startswith("b_")}
        scalars = {k[2:]: z[k].item() for k in z.files
                   if k.startswith("s_")}
    return it, buffers, scalars
