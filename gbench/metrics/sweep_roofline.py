"""Share of the least time the card could take for a plane pass's
gradient plane sweep (gbench/roofline/sweep.py, from the program's
StatsCounters sweep/hits, sweep/reconnections, sweep/rows and
sweep/segments: their mean a pass over the run's plane passes) in the
device time of the profiled pass's sweep kernels (csrc/gsweep.cu:
gsweep_kernel), %. None where the program keeps no such counters or no
sweep kernel ran."""

import sys

from ..roofline import sweep
from . import kernel_s

NAMES = ("sweep/hits", "sweep/reconnections", "sweep/rows",
         "sweep/segments")


def read(rec):
    logging = sys.modules.get("gvpm_tpu_torch.core.logging")
    counters = getattr(getattr(logging, "StatsCounter", None), "REGISTRY",
                       {})
    t = kernel_s(rec, "gsweep_kernel")
    if not t or not all(n in counters for n in NAMES):
        return None
    return 100.0 * sweep.least_seconds(
        *(counters[n].value() for n in NAMES)) / t
