"""gvpm_tpu_torch — the PyTorch + CUDA port of gvpm_tpu.

The G-VPM `distance` gradient pass and its screened-Poisson
reconstruction, with the photon gathers as a hand-written CUDA kernel
for Hopper (csrc/); the SPPM primal pass over a hash grid, the
volumetric path tracer and the single-device entry point (entry.py), in
plain PyTorch. The JAX package gvpm_tpu is the reference it is held
against; this package imports no JAX.
"""

__version__ = "0.1.0"
