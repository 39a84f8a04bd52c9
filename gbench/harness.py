"""One run of one cell: set-up, the measured window, the check of what
the timed path produced against the plain reference, and in a traced run
the profiled passes. Everything that belongs to a configuration, a
traffic mix, a cell's limits or a metric is data found by name:

  BENCHMARK.json            the cell's configuration, traffic mix and
                            chips; its metrics
  gbench/configs/<c>.json   scene, film, estimator, GradientConfig keys
  gbench/traffic/<t>.json   use_manifold, me_pair_budget, ranks,
                            dump_every, scales
  gbench/limits/<cell>.json the limit of each number compared
  gbench/metrics/<m>.py     read(record) of each metric

The program (gvpm_tpu_torch) is imported inside the functions that run
it, never when this module is imported.
"""

from __future__ import annotations

import importlib
import json
import os
import random
import sys
import time

import torch

from . import capture, check, trace
from .reference import scene as rscene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "gbench")


def _json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_cell(name, root=ROOT):
    """The cell `name` of BENCHMARK.json with its configuration, traffic
    mix, limits and metrics."""
    bench = _json(root, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    here = os.path.join(root, "gbench")

    def mine(m):
        return name in m.get("workloads", [name])

    return dict(name=name, chips=w["chips"],
                config=_json(here, "configs", w["config"] + ".json"),
                traffic=_json(here, "traffic", w["traffic"] + ".json"),
                limits=_json(here, "limits", name + ".json"),
                end_to_end=[m for m in bench["end_to_end"] if mine(m)],
                per_layer=[m for m in bench["per_layer"] if mine(m)])


def metric_reader(name):
    """read(record) of metric `name`: gbench/metrics/<name>.py."""
    return importlib.import_module(f"gbench.metrics.{name}").read


def gradient_config(cell):
    from gvpm_tpu_torch.core.config import GradientConfig
    kw = dict(cell["config"]["gradient_config"])
    kw["grid_dims"] = tuple(kw["grid_dims"])
    t = cell["traffic"]
    kw.update(use_manifold=t["use_manifold"],
              me_pair_budget=t["me_pair_budget"])
    return GradientConfig(**kw)


def build_scene(cell, device):
    from gvpm_tpu_torch import scenes
    sc = dict(cell["config"]["scene"])
    return getattr(scenes, sc.pop("name"))(device=device, **sc)


def check_passes(seed, trace_on):
    """The window passes (counted from 1) that are run again and checked:
    one drawn from the seed among the first four, and the next in a
    traced run."""
    k = random.Random(seed).randint(1, 4)
    return [k, k + 1] if trace_on else [k]


class Pass:
    """The cell's timed call: one progressive gradient pass at fixed
    radius scales on one rank (gvpm.render_pass) or on every rank
    (dist.gvpm_render_pass_sharded)."""

    def __init__(self, cell, seed, device, mesh=None):
        from gvpm_tpu_torch.integrators import sppm
        self.cell, self.seed, self.mesh = cell, seed, mesh
        self.device = torch.device(device)
        self.scene = build_scene(cell, device)
        self.cfg = gradient_config(cell)
        self.volume = cell["config"]["volume"]
        self.n_photons = max(self.cfg.volume_photons,
                             self.cfg.surface_photons)
        self.r_vol = sppm.base_volume_radius(self.scene, self.cfg)
        self.scales = tuple(cell["traffic"]["scales"])
        self._ref_scenes = {}

    def ref_scene(self, dtype=torch.float64):
        """The reference's own scene in `dtype`, built at its first use
        (after the window, never in set-up)."""
        if dtype not in self._ref_scenes:
            self._ref_scenes[dtype] = rscene.build(
                self.cell["config"]["scene"], self.device, dtype)
        return self._ref_scenes[dtype]

    def __call__(self, it, timings=None):
        from gvpm_tpu_torch.integrators import gvpm
        from gvpm_tpu_torch.parallel import dist
        args = (self.scene, self.cfg, self.volume, self.n_photons, self.seed,
                it) + self.scales + (self.r_vol,)
        if self.mesh is None:
            return gvpm.render_pass(*args, timings=timings)
        return dist.gvpm_render_pass_sharded(self.mesh, *args,
                                             timings=timings)

    def solve(self, primal, gx, gy):
        from gvpm_tpu_torch.ops import poisson
        c = self.cfg
        return poisson.solve(primal, gx, gy, alpha=c.recon_alpha,
                             iters=c.recon_iters,
                             irls_iters=c.recon_irls_iters, l1=c.recon_l1)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _stop(mesh, flag):
    """Rank 0's decision, agreed on by every rank."""
    if mesh is None:
        return flag
    import torch.distributed as tdist
    t = torch.tensor([1 if flag else 0], device=mesh.device)
    tdist.broadcast(t, src=0)
    return bool(t.item())


def window(run, seconds, trace_on, check_its):
    """Passes from pass index 2 on (0 and 1 ran in set-up), a
    reconstruction of the running mean every dump_every passes, until
    `seconds` have passed on rank 0's clock, the passes to be checked
    have run and a reconstruction has. Returns the record's
    window part and the stats of the passes in check_its."""
    dump = run.cell["traffic"]["dump_every"]
    timings = {} if trace_on else None
    acc, passes, solves, last_solve, stats = None, 0, [], None, {}
    t0 = t_pass = time.perf_counter()
    pass_times = []
    while True:
        it = 2 + passes
        p, gx, gy, st = run(it, timings)
        acc = [p, gx, gy] if acc is None else \
            [a + b for a, b in zip(acc, (p, gx, gy))]
        passes += 1
        if it in check_its:
            stats[it] = check.stats_of(st)
        if passes % dump == 0:
            mean = [a / passes for a in acc]
            if trace_on:
                _sync(run.device)
                ts = time.perf_counter()
            img = run.solve(*mean)
            if trace_on:
                _sync(run.device)
                solves.append(time.perf_counter() - ts)
            last_solve = (mean, img)
        _sync(run.device)
        pass_times.append(-t_pass + (t_pass := time.perf_counter()))
        if _stop(run.mesh, time.perf_counter() - t0 >= seconds
                 and it >= max(check_its) and last_solve is not None):
            break
    rec = dict(window_s=time.perf_counter() - t0, passes=passes,
               timings=timings, solves=solves if trace_on else None,
               pass_times=pass_times)
    return rec, stats, last_solve


def _all_ranks(mesh, t, dim=0):
    """`t` of every rank concatenated along `dim` in rank order (the
    benchmark's own collective, not the program's)."""
    if mesh is None:
        return t
    import torch.distributed as tdist
    src = t.movedim(dim, 0).contiguous()
    wire = src.to(torch.uint8) if src.dtype == torch.bool else src
    out = torch.empty((mesh.size * wire.shape[0],) + wire.shape[1:],
                      dtype=wire.dtype, device=wire.device)
    tdist.all_gather_into_tensor(out, wire)
    return out.to(src.dtype).movedim(0, dim)


def _rank_max(mesh, numbers):
    if mesh is None:
        return numbers
    import torch.distributed as tdist
    keys = sorted(numbers)
    t = torch.tensor([numbers[k] for k in keys], dtype=torch.float64,
                     device=mesh.device)
    tdist.all_reduce(t, op=tdist.ReduceOp.MAX)
    return dict(zip(keys, t.tolist()))


def expected_calls(cell, me_calls):
    """The calls a pass makes of each recorded stage: one light pass,
    camera pass, set of buffers, film and surface gather (with one
    kernel call); for the distance estimator a volume gather with one
    kernel call a volume sample; with ME one
    chain walk and one shift for each gather in which the reference finds
    an ME pair (`me_calls`: {kind: count})."""
    cfg = cell["config"]["gradient_config"]
    out = dict(light=1, camera=1, buffers=1, film=1, surface_gather=1)
    if cell["config"]["volume"] == "distance":
        out["gather"] = 1 + cfg["volume_samples"]
        out["volume_gather"] = 1
    if cell["traffic"]["use_manifold"]:
        out.update(me_calls)
    return out


def pass_numbers(run, log, it, work=None, dtype=torch.float32):
    """The numbers of one pass run again with its calls recorded. With a
    `dtype` below float32, the control: the reference computed in that
    precision put in the program's place (for the numbers that have
    one)."""
    mesh, cfg, cell = run.mesh, run.cfg, run.cell
    control = dtype != torch.float32
    nums, me_queries, me_prog, per_call = check.gather_numbers(
        log, dtype, work=work)
    if any(kind == "sweep" for kind, *_ in log):
        nums.update(check.sweep_numbers(log, run.seed + it, dtype))
    gen = torch.Generator().manual_seed((run.seed * 1009 + it) % (2 ** 63))
    low = run.ref_scene(torch.bfloat16) if control else None
    gcfg = cell["config"]["gradient_config"]
    nums.update(check.light_numbers(log, run.ref_scene(), gcfg, run.seed,
                                    it, gen, low))
    nums.update(check.camera_numbers(log, run.ref_scene(), gcfg, run.seed,
                                     it, gen, low, whole_film=mesh is None))
    lights = [out[0] for kind, _, _, out in log if kind == "light"]
    light = {k: _all_ranks(mesh, v) for k, v in lights[0].items()} \
        if lights else None
    if light is not None and cell["config"]["volume"] == "distance":
        nums.update(check.stage_numbers(log, run.ref_scene(), cell,
                                        run.seed, it, light, low))
    H, W = run.scene.height, run.scene.width
    nums["film_err"] = check.film_numbers(
        log, H, W, torch.float64 if not control else dtype)
    bufs = [out for kind, _, _, out in log if kind == "buffers"]
    if cfg.use_manifold:
        taken = me_prog if control else (
            int(bufs[0][3]["me_pairs"]) + int(bufs[0][3]["me_dropped"])
            if bufs else None)
        nums["me_count_err"] = check.MISSING if taken is None else \
            abs(taken - me_queries) / max(me_queries, 1)
        nums.update(check.me_numbers(log, run.ref_scene(), gen, low))
        me_calls = {}
        for kind, q in per_call:
            if q:
                k = "me_" + kind
                me_calls[k] = me_calls.get(k, 0) + 1
                me_calls["me_chains"] = me_calls.get("me_chains", 0) + 1
    else:
        del nums["me_key_err"]
        me_calls = {}
    nums["stage_calls"] = check.stage_calls(log, expected_calls(cell,
                                                                me_calls))
    if control:
        return nums
    nums["table_err"] = check.MISSING
    if light is not None:
        nums["table_err"] = check.table_numbers(
            log, run.scene, light, dict(surface=cfg.grid_surface_rows,
                                        volume=cfg.grid_volume_rows))
    if mesh is not None and bufs:
        p, S, W_, _ = bufs[0]
        nums["film_gather_err"] = check.film_gather_numbers(
            log, (_all_ranks(mesh, p), _all_ranks(mesh, S, 1),
                  _all_ranks(mesh, W_, 1)))
    return nums


def rerun(run, it, log):
    """Pass `it` again with its calls recorded; returns its stats."""
    with capture.recording(log):
        out = run(it)
    _sync(run.device)
    return check.stats_of(out[3])


def run_cell(cell, seed, seconds, trace_on, t_start, mesh=None,
             device=None):
    """Set-up, window, check and (traced) profile of one run on this
    rank. Returns the run's record (rank 0's is the result's) and the
    numbers compared, each the largest over the ranks."""
    device = device or torch.device("cuda", 0)
    laps = [("imports", time.perf_counter())]
    run = Pass(cell, seed, device, mesh)
    laps.append(("scene", time.perf_counter()))
    # set-up: a cold and a warm pass and one reconstruction at the cell's
    # own shapes
    for it in (0, 1):
        p, gx, gy, _ = run(it)
        _sync(run.device)
        laps.append((f"pass {it}", time.perf_counter()))
    run.solve(p, gx, gy)
    _sync(run.device)
    laps.append(("solve", time.perf_counter()))
    if mesh is None or mesh.rank == 0:
        t = [t_start] + [b for _, b in laps]
        print("set-up: " + ", ".join(f"{n} {t[i + 1] - t[i]:.3f} s"
                                     for i, (n, _) in enumerate(laps)),
              file=sys.stderr)
    cuda = run.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(run.device)
    check_its = [1 + k for k in check_passes(seed, trace_on)]
    setup_s = time.perf_counter() - t_start
    rec, stats, last_solve = window(run, seconds, trace_on, check_its)
    peak = torch.cuda.max_memory_allocated(run.device) if cuda else 0
    if mesh is None or mesh.rank == 0:
        pt = sorted(rec["pass_times"])
        print(f"window: {rec['passes']} passes in {rec['window_s']:.3f} s, "
              f"pass seconds min {pt[0]:.4f} median {pt[len(pt) // 2]:.4f} "
              f"max {pt[-1]:.4f}; in order "
              + " ".join(f"{t:.3f}" for t in rec["pass_times"]),
              file=sys.stderr)
    if mesh is not None:
        import torch.distributed as tdist
        t = torch.tensor([peak], dtype=torch.int64, device=device)
        tdist.all_reduce(t, op=tdist.ReduceOp.MAX)
        peak = int(t.item())
    rec.update(setup_s=setup_s, peak_bytes=peak, trace=trace_on)
    nums = {}
    (mean, img) = last_solve if last_solve else (None, None)
    if mean is not None:
        nums["solve_err"] = check.solve_numbers(mean, img, run.cfg)
    del last_solve, mean, img
    if cuda:
        torch.cuda.empty_cache()

    repeat_bad = 0
    for j, it in enumerate(check_its):
        log = []
        holder = []

        def again():
            holder.append(rerun(run, it, log))

        if trace_on and j == 0:
            work = []
            prof = trace.profile(again)
            kern = trace.compute_kernels(prof["kernels"])
            rec["profile"] = dict(
                passes=1, wall_s=prof["wall_s"],
                busy_s=trace.busy_us(prof["kernels"]) * 1e-6,
                n_kernels=len(kern), kernels=kern)
            rec["top_ops"] = trace.top_ops(prof["kernels"])
        elif trace_on:
            work = None
            with capture.spans():
                prof = trace.profile(again, spans=True)
            rec["idle_gaps"] = trace.idle_gaps(prof["kernels"],
                                               prof["annotations"])
        else:
            work = None
            again()
        stats_it = holder[0]
        repeat_bad += sum(stats_it[k] != stats[it][k] for k in stats_it)
        for k, v in pass_numbers(run, log, it, work).items():
            nums[k] = max(nums.get(k, 0.0), v)
        if work is not None:
            rec["work"] = dict(gather=work)
        del log
        if cuda:
            torch.cuda.empty_cache()
    nums["repeat_err"] = float(repeat_bad)
    if trace_on:
        busy = [rec["profile"]["busy_s"], rec["profile"]["wall_s"]]
        if mesh is not None:
            import torch.distributed as tdist
            t = torch.tensor(busy, dtype=torch.float64, device=device)
            tdist.all_reduce(t)
            busy = (t / mesh.size).tolist()
        rec["device_busy_s"], rec["device_window_s"] = busy
    return rec, _rank_max(mesh, nums)
