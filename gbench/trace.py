"""The device trace of profiled passes, reduced to what the per-layer
metrics and the result's breakdown read: the device kernels with their
intervals, the busy time as the union of those intervals, and the idle
gaps between them named by the span (capture.SPANS) that was open on the
device when each gap began."""

from __future__ import annotations

import time

import torch

COPIES = ("Memcpy", "Memset")


def device_events(prof):
    """(name, start us, end us, user annotation) of every device event
    of a finished profile, read from its kineto results (building the
    profiler's FunctionEvents would take ~0.2 ms an event)."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.start_ns() * 1e-3, e.end_ns() * 1e-3,
             e.is_user_annotation())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda]


def profile(run, spans=False):
    """run() under torch.profiler, device activity only, or with host
    activity and the benchmark's spans when `spans` (which slows the
    host more). Returns dict(wall_s, kernels [(name, start, end)],
    annotations [(name, start, end)])."""
    act = torch.profiler.ProfilerActivity
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (
        lambda: None)
    sync()
    if not torch.cuda.is_available():       # a rehearsal on the CPU
        acts = [act.CPU]
    else:
        acts = [act.CPU, act.CUDA] if spans else [act.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        sync()
        wall = time.perf_counter() - t0
    ev = device_events(prof)
    return dict(wall_s=wall,
                kernels=sorted((n, a, b) for n, a, b, u in ev if not u),
                annotations=[(n, a, b) for n, a, b, u in ev if u])


def busy_us(kernels):
    """Length of the union of the kernels' intervals."""
    busy, lo, hi = 0.0, None, None
    for _, a, b in sorted(kernels, key=lambda k: k[1]):
        if hi is None or a > hi:
            busy += 0.0 if hi is None else hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    return busy + (0.0 if hi is None else hi - lo)


def compute_kernels(kernels):
    """The kernels that compute (copies and fills left out)."""
    return [k for k in kernels if not k[0].startswith(COPIES)]


def top_ops(kernels, n=10):
    """[[name, seconds]] of the n device operations that took most time,
    summed by name."""
    per = {}
    for name, a, b in kernels:
        per[name] = per.get(name, 0.0) + (b - a) * 1e-6
    return [[k[:120], v] for k, v in
            sorted(per.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(kernels, annotations, n=10):
    """[[span, seconds]]: the idle time between kernels summed by the
    innermost benchmark span open on the device where each gap begins
    ("outside spans" where none is), the n largest."""
    ks = sorted(kernels, key=lambda k: k[1])
    ann = sorted(annotations, key=lambda a: a[2] - a[1])
    per, hi = {}, None
    for _, a, b in ks:
        if hi is not None and a > hi:
            name = next((s for s, lo_s, hi_s in ann if lo_s <= hi < hi_s),
                        "outside spans")
            per[name] = per.get(name, 0.0) + (a - hi) * 1e-6
        hi = b if hi is None else max(hi, b)
    return [[k, v] for k, v in sorted(per.items(), key=lambda kv: -kv[1])[:n]]
