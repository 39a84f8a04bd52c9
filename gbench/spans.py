"""The program's own spans (gvpm_tpu_torch.core.logging.span) in a profiled
pass: for each span name, the compute kernels launched while a range of
that name was open on the host (copies and fills left out, as
device_kernels_per_pass counts them), the union of their device
intervals, the union of the name's host ranges, and the idle seconds of
the device whose gap began while that range was the innermost one open
on the host. Host ranges and device activity are read from one kineto
trace, on one clock.

Run as a tool on a card,

    python -m gbench.spans --workload <cell> --seed <n> [--passes 4]

it makes a cell's set-up with its cold pass timed span by span, runs
`--passes` window passes, and prints to standard error: the cold pass's
timings, the kernel-library build counters after set-up, the light
lanes' use over the window, the span table of one pass profiled with
host and device activity (the `spans:` line), what a span costs with no
profiler recording, and the wall time of a pass profiled with device
activity only with the program's ranges on and off. The last line of
standard output is the same as one JSON object.
"""

from __future__ import annotations

import bisect
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import timeit  # noqa: E402

import torch  # noqa: E402

from . import trace  # noqa: E402

OUTSIDE = "outside spans"


def events(prof):
    """(ranges, device, launches) of a finished profile: the host ranges
    [(name, start us, end us)], the device activity [(name, start us,
    end us, correlation)] and the host launch times {correlation: us} of
    the CUDA API calls (`cudaLaunchKernel`, `cuLaunchKernel`, ...) that
    the device activity answers (a device event's correlation is its own id
    where a call has it, else its linked one)."""
    cuda = torch.autograd.DeviceType.CUDA
    evs = prof.profiler.kineto_results.events()
    launches = {e.correlation_id(): e.start_ns() * 1e-3 for e in evs
                if e.device_type() != cuda and not e.is_user_annotation()
                and e.name().startswith("cu")}
    ranges, device = [], []
    for e in evs:
        a, b = e.start_ns() * 1e-3, e.end_ns() * 1e-3
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                c = e.correlation_id()
                device.append((e.name(), a, b, c if c in launches
                               else e.linked_correlation_id()))
        elif e.is_user_annotation():
            ranges.append((e.name(), a, b))
    return ranges, device, launches


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _covers(merged, starts, t):
    """Whether t lies in one of the merged intervals (starts: theirs)."""
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= merged[i][1]


def _innermost(ranges, t):
    """The name of the innermost range that holds t (the latest opened,
    of those opened together the first closed), or OUTSIDE."""
    best = max(((a, -b, name) for name, a, b in ranges if a <= t <= b),
               default=None)
    return OUTSIDE if best is None else best[2]


def table(ranges, device, launches):
    """{span: dict(kernels, device_s, host_s, idle_s)} over the names of
    `ranges`, and OUTSIDE for the kernels launched and the gaps begun
    outside every range (events() gives the arguments). A kernel counts
    in every name that has a range open at its launch; a gap counts once,
    in the innermost range open where it begins. A kernel whose launch
    the trace does not hold counts in OUTSIDE."""
    names = sorted({r[0] for r in ranges})
    merged = {n: _union([(a, b) for m, a, b in ranges if m == n])
              for n in names}
    starts = {n: [a for a, _ in merged[n]] for n in names}
    rows = {n: dict(kernels=0, device_s=0.0, host_s=sum(
        b - a for a, b in merged.get(n, [])) * 1e-6, idle_s=0.0)
        for n in names + [OUTSIDE]}
    per = {n: [] for n in rows}
    for name, a, b, corr in device:
        if name.startswith(trace.COPIES):
            continue
        t = launches.get(corr)
        inside = [] if t is None else [
            n for n in names if _covers(merged[n], starts[n], t)]
        for n in inside or [OUTSIDE]:
            rows[n]["kernels"] += 1
            per[n].append((a, b))
    for n, iv in per.items():
        rows[n]["device_s"] = sum(b - a for a, b in _union(iv)) * 1e-6
    busy = _union([(a, b) for _, a, b, _ in device])
    for (_, hi), (lo, _) in zip(busy, busy[1:]):
        rows[_innermost(ranges, hi)]["idle_s"] += (lo - hi) * 1e-6
    return rows


def line(rows):
    """The table as one line, the spans in order of their idle time."""
    order = sorted(rows, key=lambda n: -rows[n]["idle_s"])
    return "spans: " + "; ".join(
        f"{n} kernels {r['kernels']} device {r['device_s']:.6f} s host "
        f"{r['host_s']:.6f} s idle {r['idle_s']:.6f} s"
        for n in order for r in [rows[n]])


def _profiled(run, host):
    """run() under torch.profiler (device activity, and host activity
    when `host`): (wall seconds, profile)."""
    act = torch.profiler.ProfilerActivity
    torch.cuda.synchronize()
    acts = [act.CPU, act.CUDA] if host else [act.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return wall, prof


def _off_cost():
    """Seconds of one span's enter and exit with no profiler recording,
    and of a PhaseClock span without a timings dict."""
    from gvpm_tpu_torch.core.logging import PhaseClock, span

    def bare():
        with span("x"):
            pass

    clock = PhaseClock(torch.device("cuda"), None)

    def clocked():
        with clock.span("x"):
            pass

    n = 200000
    return (min(timeit.repeat(bare, number=n, repeat=5)) / n,
            min(timeit.repeat(clocked, number=n, repeat=5)) / n)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--passes", type=int, default=4)
    ap.add_argument("--on-off", type=int, default=3,
                    help="profiled passes with the ranges on, and off")
    a = ap.parse_args(argv)

    from gbench import harness, run
    if not torch.cuda.is_available():
        sys.exit("gbench.spans needs a CUDA card")
    run.pin_host()
    cell = harness.load_cell(a.workload)
    if cell["traffic"]["ranks"] != 1:
        sys.exit("gbench.spans runs one-rank cells")
    from gvpm_tpu_torch.core.logging import StatsCounter
    out = dict(workload=a.workload, seed=a.seed)
    p = harness.Pass(cell, a.seed, torch.device("cuda", 0))
    out["imports_scene_s"] = time.perf_counter() - T_START
    cold = {}
    t0 = time.perf_counter()
    img = p(0, cold)
    out["cold_pass_s"] = time.perf_counter() - t0
    out["setup_timings"] = cold
    out["setup_me_s"] = cold.get("surface_me", 0.0) \
        + cold.get("volume_me", 0.0)
    p(1)
    p.solve(*img[:3])
    torch.cuda.synchronize()
    out["build"] = {k: c.value() for k, c in StatsCounter.REGISTRY.items()
                    if k.startswith("build/")}
    live = lanes = 0
    pass_s = []
    for it in range(2, 2 + a.passes):
        t0 = time.perf_counter()
        st = p(it)[3]
        live += int(st.get("light_lanes_live", 0))
        lanes += int(st.get("light_lanes", 0))
        pass_s.append(time.perf_counter() - t0)
    out["pass_s"] = statistics.median(pass_s)
    out["light_lane_use"] = 100.0 * live / lanes if lanes else None
    it = 2 + a.passes
    wall, prof = _profiled(lambda: p(it), host=True)
    ranges, device, launches = events(prof)
    rows = table(ranges, device, launches)
    print(line(rows), file=sys.stderr)
    compute = [d for d in device if not d[0].startswith(trace.COPIES)]
    matched = sum(d[3] in launches for d in compute)
    out.update(spans=rows, spans_wall_s=wall, spans_per_pass=len(ranges),
               kernels=len(compute), kernels_matched=matched)

    def of(*names):
        return [sum(rows.get(n, {}).get(k, 0) for n in names)
                for k in ("kernels", "device_s")]

    out["light_kernels_per_pass"], out["light_device_s"] = of("light_trace")
    out["me_kernels_per_pass"], out["me_device_s"] = of("surface_me",
                                                        "volume_me")
    bare, clocked = _off_cost()
    out.update(span_off_s=bare, clock_span_off_s=clocked,
               spans_off_share=100.0 * len(ranges) * clocked
               / out["pass_s"])
    on, off = [], []
    rf = torch.profiler.record_function
    for k in range(a.on_off):
        on.append(_profiled(lambda: p(it + 1 + 2 * k), host=False)[0])
        torch.profiler.record_function = \
            lambda name: contextlib.nullcontext()
        try:
            off.append(_profiled(lambda: p(it + 2 + 2 * k), host=False)[0])
        finally:
            torch.profiler.record_function = rf
    out.update(window_on_s=on, window_off_s=off)
    for k, v in out.items():
        if k != "spans":
            print(f"{k}: {v}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
