"""Per-pixel sample generation (mirrors gvpm_tpu/core/qmc.py::pixel_samples,
trimmed to the independent sampler; the stratified, low-discrepancy,
Sobol', Halton and Hammersley samplers come with ROADMAP queue 1 item
16)."""

from __future__ import annotations

from . import rng

SAMPLERS = ("independent", "stratified", "ld", "sobol", "halton",
            "hammersley")


def pixel_samples(sampler: str, key, pixel_index, sample_index, spp):
    """Per-pixel 2D sample in [0,1)^2 for each lane -> [N,2]."""
    if sampler == "independent":
        return rng.uniform(key, tuple(pixel_index.shape) + (2,))
    if sampler in SAMPLERS:
        raise NotImplementedError(
            f"pixel sampler {sampler!r}: ROADMAP queue 1 item 16")
    raise ValueError(f"unknown sampler '{sampler}'")
