"""Share of the profiled passes' wall time in which no kernel ran on the
device (1 - union of kernel intervals / wall), %. The profiler slows
the host, so this reads higher than in an unprofiled pass."""


def read(rec):
    prof = rec.get("profile")
    if not prof:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["wall_s"])
