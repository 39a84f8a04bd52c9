"""Logger and statistics counters (mirrors gvpm_tpu/core/logging.py).

Counters are host-side: the pass returns metric tensors that `render`
feeds into counters between passes (shift success percentages, the
reference's behavioral regression signal, shift_volume_photon.cpp:40-47).
"""

from __future__ import annotations

import logging

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
