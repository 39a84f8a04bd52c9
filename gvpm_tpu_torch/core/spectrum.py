"""RGB spectrum helpers (mirrors gvpm_tpu/core/spectrum.py)."""

from __future__ import annotations

N_CHANNELS = 3


def luminance(s):
    """ITU-R Rec. BT.709 luminance; works on numpy arrays and tensors."""
    return s[..., 0] * 0.212671 + s[..., 1] * 0.715160 + s[..., 2] * 0.072169
