"""Logger, statistics counters, the phase timer of the command-line
renderer and the per-phase clock of the passes (mirrors
gvpm_tpu/core/logging.py).

Counters are host-side: the pass returns metric tensors that `render`
feeds into counters between passes (shift success percentages, the
reference's behavioral regression signal, shift_volume_photon.cpp:40-47).
"""

from __future__ import annotations

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
    """Named counter; kinds: value, percentage, average."""

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
        self.num += float(n)
        self.den += float(d)

    def value(self):
        if self.kind == "value":
            return self.num
        if self.den == 0:
            return 0.0
        if self.kind == "percentage":
            return 100.0 * self.num / self.den
        return self.num / self.den

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
    """Phase timer (timer.h:37); also records per-pass rows for the
    `<dest>_time.csv` equal-time protocol."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.rows = []

    def reset(self):
        self.t0 = time.perf_counter()

    def elapsed(self):
        return time.perf_counter() - self.t0

    def lap(self, label=""):
        dt = self.elapsed()
        self.rows.append((label, dt))
        self.reset()
        return dt

    def write_csv(self, path):
        with open(path, "w") as f:
            for label, dt in self.rows:
                f.write(f"{label},{dt:.6f}\n")


class PhaseClock:
    """Host wall-clock per phase, each ending in a device synchronize;
    a no-op when no timings dict is asked for. `lap(name)` closes the
    running phase; `lap(name, part=True)` records a part of it (the time
    since the last lap of either kind) and leaves the phase running, so
    a phase's seconds include its parts'."""

    def __init__(self, device, timings):
        self.device, self.timings = device, timings
        self.t0 = self.t_part = time.perf_counter()

    def lap(self, name, part=False):
        if self.timings is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t = time.perf_counter()
        since = self.t_part if part else self.t0
        self.timings[name] = self.timings.get(name, 0.0) + t - since
        self.t_part = t
        if not part:
            self.t0 = t
