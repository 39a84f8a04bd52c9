"""Seconds the run spent making its kernel libraries ready, compiled or
found built on disk: the program's build/seconds statistics counter
(gvpm_tpu_torch.core.logging.count_build), read in this process. Every
library is made ready at its first call, in set-up. None where the
program keeps no such counter."""

import sys


def read(rec):
    logging = sys.modules.get("gvpm_tpu_torch.core.logging")
    counters = getattr(getattr(logging, "StatsCounter", None), "REGISTRY",
                       {})
    c = counters.get("build/seconds")
    return None if c is None else c.value()
