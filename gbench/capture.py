"""Recorders around the program's calls, installed by the benchmark for
the passes it checks or profiles and removed after them: each keeps the
arguments and results of the calls it wraps (references, no copies), so
that the reference can judge what the timed path produced. `spans`
wraps calls in profiler ranges named after their layer instead.

The program is imported lazily: this module is imported by tests that
run without it on the path.
"""

from __future__ import annotations

import contextlib
import importlib

# the calls every estimator's pass makes: {kind: (module of
# gvpm_tpu_torch, function)}; an estimator's own are its check module's
# TARGETS (gbench/checks)
SHARED = dict(light=("integrators.sppm", "shoot_photons"),
              camera=("integrators.gatherpoint", "trace"),
              surface_gather=("integrators.gradient_gather",
                              "surface_gather"),
              gather=("ops.fused_gather", "fused_gather"),
              me_chains=("integrators.manifold", "pull_chains"),
              me_volume=("integrators.manifold", "me_shift_volume"),
              me_surface=("integrators.manifold", "me_shift_surface"),
              buffers=("integrators.gvpm", "pass_buffers"),
              film=("integrators.gvpm", "assemble_gradients"))


@contextlib.contextmanager
def patched(patches):
    """Set module attributes for the duration: patches is a list of
    (module, attribute, replacement)."""
    old = [(m, a, getattr(m, a)) for m, a, _ in patches]
    try:
        for m, a, f in patches:
            setattr(m, a, f)
        yield
    finally:
        for m, a, f in old:
            setattr(m, a, f)


@contextlib.contextmanager
def recording(log, targets):
    """Append (kind, args, kwargs, result) to `log` for every call of the
    shared stages (SHARED: the light pass, the camera pass, the surface
    gather, the gathers' kernel, the ME chain walks and shifts, the pass
    buffers and the gradient assembly) and of the estimator's own
    `targets` (its check module's TARGETS)."""
    def wrap(kind, fn):
        def rec(*args, **kwargs):
            out = fn(*args, **kwargs)
            log.append((kind, args, kwargs, out))
            return out
        return rec

    patches = []
    for kind, (mod, attr) in {**SHARED, **targets}.items():
        m = importlib.import_module("gvpm_tpu_torch." + mod)
        patches.append((m, attr, wrap(kind, getattr(m, attr))))
    with patched(patches):
        yield


# the program's layers as the traced breakdown names them
SPANS = (("integrators.sppm", "shoot_photons", "light_trace"),
         ("integrators.gatherpoint", "trace", "camera_trace"),
         ("ops.cellgrid", "build_cells", "grid"),
         ("integrators.gradient_gather", "pack_photons", "grid"),
         ("ops.fused_gather", "fused_gather", "gather_kernel"),
         ("ops.beam_sweep", "gsweep", "sweep_kernel"),
         ("integrators.manifold", "me_shift_volume", "me"),
         ("integrators.manifold", "me_shift_surface", "me"),
         ("integrators.gvpm", "assemble_gradients", "splat"),
         ("parallel.dist", "all_gather_rows", "allgather"),
         ("ops.poisson", "solve", "solve"))


@contextlib.contextmanager
def spans():
    """Every call in SPANS inside a torch.profiler range of its layer's
    name."""
    import torch

    def wrap(name, fn):
        def rec(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return rec

    patches = []
    for mod, attr, name in SPANS:
        m = importlib.import_module("gvpm_tpu_torch." + mod)
        patches.append((m, attr, wrap(name, getattr(m, attr))))
    with patched(patches):
        yield
