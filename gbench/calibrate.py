"""Readings that the limits of gbench/limits/<cell>.json are set from:
in one process, one cold set-up of the cell, then for each seed the
check of pass 2 (the window's first) as a run makes it, and for the
control seeds the same numbers with the reference computed in bfloat16
in the program's place, and the solve's on that pass's images. Prints
one JSON line a seed; not part of a benchmark run:

    python -m gbench.calibrate --workload <cell> --seeds 12 \
        --control 3 [--first <seed>]
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from gbench import check, harness


def readings(run, seed, dtype):
    run.seed = seed
    log = []
    stats = harness.rerun(run, 2, log)
    nums = harness.pass_numbers(run, log, 2, dtype=dtype)
    out = next(o for k, _, _, o in log if k == "film")
    img = run.solve(*out)
    nums["solve_err"] = check.solve_numbers(
        out, img, run.cfg, torch.float64 if dtype == torch.float32
        else dtype)
    if dtype == torch.float32:
        nums["repeat_err"] = float(sum(
            stats[k] != v for k, v in harness.rerun(run, 2, []).items()))
    return nums


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--first", type=int, default=2 ** 31 + 101)
    a = ap.parse_args(argv)
    cell = harness.load_cell(a.workload)
    if cell["traffic"]["ranks"] != 1:
        sys.exit("calibrate runs one-rank cells")
    run = harness.Pass(cell, a.first, torch.device("cuda", 0))
    for it in (0, 1):
        run(it)
    seeds = [a.first + 7919 * i for i in range(a.seeds)]
    for seed in seeds:
        print(json.dumps(dict(seed=seed, program=readings(
            run, seed, torch.float32))), flush=True)
    for seed in seeds[:a.control]:
        try:
            row = dict(seed=seed, control=readings(run, seed,
                                                   torch.bfloat16))
        except RuntimeError as e:    # a control that gives no number
            row = dict(seed=seed, control_failed=str(e)[:300])
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
