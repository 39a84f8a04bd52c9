"""One reader a metric, found by the metric's name in BENCHMARK.json:
gbench/metrics/<name>.py defines read(record) -> number or None (None:
nothing to read in this run, and the metric is left out of the line).
The record is what harness.run_cell returns: window_s, passes, setup_s,
peak_bytes, and in a traced run timings (each phase's seconds summed over
the window's passes), solves (seconds of each reconstruction), profile
(the profiled passes' device kernels, busy and wall seconds) and work
(the reference's counts of the profiled passes)."""


def phase_s(rec, *names):
    """Seconds a pass of the named timing laps, or None where the run
    has none of them."""
    t = rec.get("timings") or {}
    if not any(n in t for n in names):
        return None
    return sum(t.get(n, 0.0) for n in names) / rec["passes"]


def kernel_s(rec, *names):
    """Device seconds of the kernels whose names hold one of `names`,
    over the profiled passes, or None where none ran."""
    prof = rec.get("profile")
    if not prof:
        return None
    ks = [b - a for n, a, b in prof["kernels"] if any(s in n for s in names)]
    return sum(ks) * 1e-6 if ks else None
