"""Run one cell of the benchmark once:

    python -m gbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout with an NVIDIA GPU. Prints, as the last line
of standard output, one JSON object: correct, attempted, failed, metrics
(the cell's end-to-end metrics, or with --trace 1 its per-layer ones),
device, breakdown (traced) and, last, checks (each number compared with
its limit); the checks are also the last lines of standard error. Exits
non-zero, printing no result, without a card, with fewer cards than the
cell asks for, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

# top-level module names that the process measured must never load
FORBIDDEN = ("jax", "jaxlib", "flax", "gvpm_tpu", "bench", "chip_smoke")


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name (before the first dot) is
    forbidden, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def power_limit():
    """The card's power limit in W as nvidia-smi reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def ranks_forbidden(mesh):
    """The forbidden top-level names that any rank has loaded, agreed on
    by every rank (a flag each, reduced by its maximum)."""
    import torch
    import torch.distributed as tdist
    mine = forbidden_modules()
    flags = torch.tensor([int(n in mine) for n in FORBIDDEN],
                         device=mesh.device)
    tdist.all_reduce(flags, op=tdist.ReduceOp.MAX)
    return [n for n, f in zip(FORBIDDEN, flags.tolist()) if f]


def rank_main(mesh, name, seed, seconds, trace_on, t_start):
    """One rank of a multi-rank cell (parallel.launch): rank 0 returns
    the record, the numbers and the forbidden modules any rank loaded;
    the others None."""
    from gbench import harness
    pin_host(mesh.rank)
    out = harness.run_cell(harness.load_cell(name), seed, seconds,
                           trace_on, t_start, mesh=mesh, device=mesh.device)
    bad = ranks_forbidden(mesh)
    return out + (bad,) if mesh.rank == 0 else None


HOST_THREADS = 4


def pin_host(rank=0):
    """Hold this process to HOST_THREADS of the cores it may use (the
    block of rank `rank`, wrapping round) and to as many torch threads,
    so that its host work does not move between cores and runs alike
    from run to run."""
    import torch
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) > HOST_THREADS:
        start = (rank * HOST_THREADS) % len(cores)
        os.sched_setaffinity(0, (cores * 2)[start:start + HOST_THREADS])
    torch.set_num_threads(HOST_THREADS)


def result(cell, rec, nums):
    """The result's line (a dict, `checks` last) and the check rows."""
    import torch

    from gbench import check, harness
    ok, rows = check.judge(nums, cell["limits"])
    metrics = {}
    wanted = cell["per_layer"] if rec["trace"] else cell["end_to_end"]
    for m in wanted:
        v = harness.metric_reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    ranks = cell["traffic"]["ranks"]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": ranks, "memory_peak_bytes": rec["peak_bytes"],
              "power_limit_w": power_limit()}
    line = {"correct": ok, "attempted": rec["passes"],
            "failed": 0 if ok else 1, "metrics": metrics, "device": device}
    if rec["trace"]:
        device.update(busy_s=rec["device_busy_s"],
                      window_s=rec["device_window_s"])
        line["breakdown"] = {"device_ops": rec.get("top_ops", []),
                             "idle_gaps": rec.get("idle_gaps", [])}
    line["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return line, rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    import torch

    from gbench import harness
    cell = harness.load_cell(a.workload)
    ranks = cell["traffic"]["ranks"]
    if ranks != cell["chips"]:
        sys.exit(f"{a.workload}: {ranks} ranks on {cell['chips']} chips")
    if not torch.cuda.is_available() or torch.cuda.device_count() < ranks:
        sys.exit(f"{a.workload} needs {ranks} CUDA card(s); found "
                 f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    if ranks == 1:
        pin_host()
        rec, nums = harness.run_cell(cell, a.seed, a.seconds, bool(a.trace),
                                     T_START)
        bad = forbidden_modules()
    else:
        from gvpm_tpu_torch.parallel.launch import launch
        # the ranks' NCCL talks over NVLink and sockets, not through a
        # shared-memory segment of its own
        os.environ["NCCL_SHM_DISABLE"] = "1"
        rec, nums, bad = launch(ranks, rank_main, a.workload, a.seed,
                                a.seconds, bool(a.trace), T_START)
        bad = sorted(set(bad) | set(forbidden_modules()))
    if bad:
        sys.exit(f"the measured process loaded {', '.join(bad)}")
    line, rows = result(cell, rec, nums)
    print(json.dumps(line), flush=True)
    for k, v, lim in rows:
        print(f"check {k} {v!r} limit {lim!r} "
              f"{'ok' if v is not None and lim is not None and v <= lim else 'FAIL'}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
