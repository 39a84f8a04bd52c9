"""gvpm_tpu_torch — the PyTorch + CUDA port of gvpm_tpu.

The G-VPM gradient passes and their screened-Poisson reconstruction,
with the photon gathers and the beam / plane sweeps as hand-written CUDA
kernels for Hopper (csrc/); the SPPM primal pass, every other integrator
of the JAX package (volpath, G-PT, BDPT / G-BDPT, the photon mappers,
VPL, the Metropolis family), the Mitsuba XML loader and the
command-line renderer (`python -m gvpm_tpu_torch.cli`), in plain
PyTorch. The JAX package gvpm_tpu is the reference it is held against;
this package imports no JAX.
"""

__version__ = "0.1.0"
