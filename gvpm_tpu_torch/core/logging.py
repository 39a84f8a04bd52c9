"""Logger, statistics counters, the wall clock of the command-line
renderer, and the port's spans: named ranges that a torch.profiler run
records and that a pass's `timings` dict times (mirrors
gvpm_tpu/core/logging.py).

Counters are host-side: the pass returns metric tensors that `render`
feeds into counters between passes (shift success percentages, the
reference's behavioral regression signal, shift_volume_photon.cpp:40-47).
"""

from __future__ import annotations

import contextlib
import logging
import time

import torch

log = logging.getLogger("gvpm_tpu_torch")
if not log.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname).1s [%(name)s] %(message)s", "%H:%M:%S"))
    log.addHandler(_h)
    log.setLevel(logging.INFO)


class StatsCounter:
    """Named counter; kinds: value, percentage, average. `add` takes
    numbers or device tensors: a tensor is summed where it lives and read
    back only by value(), so that counting inside a pass adds no
    synchronization."""

    REGISTRY = {}

    def __init__(self, name, kind="value"):
        self.name = name
        self.kind = kind
        self.num = 0.0
        self.den = 0.0
        StatsCounter.REGISTRY[name] = self

    @classmethod
    def get(cls, name, kind="value"):
        """The registered counter of this name, created on first use."""
        return cls.REGISTRY.get(name) or cls(name, kind)

    def add(self, n, d=1.0):
        if isinstance(n, torch.Tensor):
            self.num = n.detach().double() + self.num
        else:
            self.num += float(n)
        self.den += float(d)

    def value(self):
        num = float(self.num)
        if self.kind == "value":
            return num
        if self.den == 0:
            return 0.0
        if self.kind == "percentage":
            return 100.0 * num / self.den
        return num / self.den

    @classmethod
    def print_stats(cls, logger=log):
        """Statistics::printStats analog."""
        suffix = {"percentage": "%", "average": " avg", "value": ""}
        for name, c in sorted(cls.REGISTRY.items()):
            logger.info("  %-40s %12.4g%s", name, c.value(), suffix[c.kind])

    @classmethod
    def reset_all(cls):
        for c in cls.REGISTRY.values():
            c.num = c.den = 0.0


class Timer:
    """Wall-clock seconds since the renderer started (timer.h:37)."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def elapsed(self):
        return time.perf_counter() - self.t0


_OFF = contextlib.nullcontext()


def span(name):
    """A `torch.profiler.record_function(name)` range while a profiler
    records, so that the range lands in the profile beside the kernels
    launched inside it, on the trace's clock; else a shared context that
    does nothing. The port's spans: `pass` around a progressive pass
    (gvpm / sppm render_pass and the sharded passes of parallel.dist);
    inside it light_trace (one light_step a step of ptracer.shoot),
    camera_trace, surface_grid, surface_gather, surface_me, volume_grid,
    volume_gather, volume_me (an ME stage holds me:compact, me:chains,
    me:newton, me:ratios and me:occlusion), splat and film, with
    gather_kernel (ops.fused_gather) and sweep_kernel (ops.beam_sweep)
    inside the gathers; and, wherever they run, solve (ops.poisson) and
    build (a kernel library compiled or found on disk)."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


class PhaseClock:
    """The spans of a pass that `timings` times: `span(name)` opens the
    module's `span(name)` and, when a timings dict was given, adds the
    seconds from entering to leaving it, after a device synchronize, to
    timings[name] (summed over calls; a span nested in another is
    counted inside its parent). With no timings dict and no profiler it
    does nothing: no clock read, no synchronize."""

    def __init__(self, device, timings):
        self.device, self.timings = device, timings

    def span(self, name):
        if self.timings is None:
            return span(name)
        return self._timed(name)

    @contextlib.contextmanager
    def _timed(self, name):
        with span(name):
            t0 = time.perf_counter()
            yield
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.timings[name] = (self.timings.get(name, 0.0)
                                  + time.perf_counter() - t0)


def count_build(compiled, seconds):
    """One kernel library made ready: build/loads += 1, build/compiles
    += 1 where it was compiled (not found on disk), build/seconds +=
    the seconds it took. print_stats shows them."""
    StatsCounter.get("build/loads").add(1)
    StatsCounter.get("build/compiles").add(int(compiled))
    StatsCounter.get("build/seconds").add(seconds)
