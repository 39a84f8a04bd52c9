"""The photon planes' (Plane(0D)) checks at a beam map of the
configuration's `beams` (the program's integrators.sppm.select_beams):
the plane sweep's numbers of checks/plane0d.py (`sweep_err`,
`sweep_count_err`) and

  beam_select_err  the beams that reach make_planes against the
                   reference's beam map of the pass's light records
                   (reference/beams.py): the share of the kept beams'
                   values that differ, 1 where their count does; exact
  plane_err        make_planes' planes of those beams (w1, l1, and which
                   are degenerate) against the reference's, drawn from
                   the pass's gather key: a mean relative error a row
  vscale_err       plane_gradient_gather's returns against its recorded
                   sweeps' sums times the camera throughputs, over the
                   reference's kept paths: a mean relative error a
                   segment (with ME its primal only: the ME terms are
                   added to S and W after the sweep)

and, as checks/distance.py holds them for the distance estimator, the
surface gather as a whole function (`sgather_err`, `sgather_miss`) and
the pass buffers from the gathers' returns (`buffers_err`).

The program has to read `beams`: a program without select_beams is
refused when this module is imported, before any pass.
"""

from __future__ import annotations

import importlib

import torch

from ..check import MISSING, rel_err
from ..reference import beams as ref_beams
from ..reference import rng as ref_rng
from ..reference import stages as ref_stages
from . import plane0d
from .distance import _counts_rel

if not hasattr(importlib.import_module("gvpm_tpu_torch.integrators.sppm"),
               "select_beams"):
    raise ImportError("gvpm_tpu_torch reads no beam map "
                      "(integrators.sppm.select_beams): a Plane(0D) pass at "
                      "the configuration's `beams` cannot run")

TARGETS = dict(plane0d.TARGETS,
               make_planes=("integrators.estimators", "make_planes"),
               plane_gather=("integrators.gradient_gather",
                             "plane_gradient_gather"))
NEW = ("beam_select_err", "plane_err", "vscale_err")


def expected_calls(cell, me_calls):
    """One make_planes and one plane gather a pass, and the surface
    gather's kernel call."""
    return dict(make_planes=1, plane_gather=1, gather=1)


def _of(log, kind):
    return [(a, o) for k, a, _, o in log if k == kind]


def _differ(prog, ref):
    """The share of the rows' values that differ (1 where the row counts
    do)."""
    n = next(iter(ref.values())).shape[0]
    if next(iter(prog.values())).shape[0] != n:
        return 1.0
    bad = total = 0
    for k, v in ref.items():
        bad += int((prog[k] != v).sum())
        total += v.numel()
    return bad / max(total, 1)


def _plane_rows(w1, l1, ok):
    ok = ok.to(torch.float64)[:, None]
    return torch.cat([w1.double(), l1.double()[:, None]], 1) * ok


def _volume_numbers(log, sc, cell, seed, it, low):
    out = dict.fromkeys(NEW, MISSING)
    shots, made = _of(log, "light"), _of(log, "make_planes")
    if len(shots) != 1 or len(made) != 1 or shots[0][1][1] is None:
        return out
    (args, (_, beams)), (mk_args, mk_out) = shots[0], made[0]
    n_paths = int(args[2])
    budget = cell["config"]["gradient_config"]["beams"]
    idx, n_ref = ref_beams.select(beams["valid"], n_paths, budget)
    ref = {k: v[idx] for k, v in beams.items()}
    lb = mk_args[1]
    keep = lb["valid"]
    if low is None:
        prog = {k: lb[k][keep] for k in ref}
    else:
        cidx, n_prog = ref_beams.select(beams["valid"], n_paths, budget, low)
        prog = {k: v[cidx] for k, v in beams.items()}
    out["beam_select_err"] = _differ(prog, ref)

    key = ref_rng.pass_key(seed, it, ref_rng.STREAM_GATHER)
    r_rows = _plane_rows(*ref_beams.planes(sc, ref["d"], key))
    if low is not None:
        p_rows = _plane_rows(*ref_beams.planes(sc, ref["d"].to(low), key,
                                               low))
    elif int(keep.sum()) == idx.shape[0]:
        p_rows = _plane_rows(mk_out["w1"][keep], mk_out["l1"][keep],
                             mk_out["valid"][keep])
    else:
        p_rows = None
    out["plane_err"] = MISSING if p_rows is None else rel_err(p_rows,
                                                              r_rows)

    gathers = _of(log, "plane_gather")
    sweeps = [o for a, o in _of(log, "sweep") if a[0] in plane0d.KINDS]
    if len(gathers) != 1 or not sweeps:
        return out
    (g_args, g_out) = gathers[0]
    cb, scb = g_args[1], g_args[2]
    pr = torch.cat([o[0] for o in sweeps])
    S = torch.cat([o[1] for o in sweeps], 1)
    W = torch.cat([o[2] for o in sweeps], 1)

    def scaled(n, dtype=torch.float64):
        thr, pr_, S_, W_ = (a.to(dtype) for a in (cb["thr"], pr, S, W))
        return [thr * pr_ / n] + [scb[i]["thr"].to(dtype) * S_[i] / n
                                  for i in range(4)] \
            + [W_[i] * thr / n for i in range(4)]
    ref_v = scaled(n_ref)
    prog_v = scaled(n_prog, low) if low is not None else \
        [g_out[0]] + list(g_out[1]) + list(g_out[2])
    if cell["traffic"]["use_manifold"]:
        ref_v, prog_v = ref_v[:1], prog_v[:1]
    if prog_v[0].shape != ref_v[0].shape:
        return out
    out["vscale_err"] = rel_err(torch.cat(prog_v, 1), torch.cat(ref_v, 1))
    return out


def _surface_numbers(log, sc, cell, light, control):
    """sgather_err / sgather_miss and buffers_err, as checks/distance.py
    reads them, with the plane gather's returns as the volume's."""
    out = dict(sgather_err=MISSING, sgather_miss=MISSING,
               buffers_err=MISSING)
    cam, surf = _of(log, "camera"), _of(log, "surface_gather")
    vol = _of(log, "plane_gather")
    bufs = [o for _, o in _of(log, "buffers")]
    if light is None or len(cam) != 1 or len(surf) != 1 or len(vol) != 1 \
            or len(bufs) != 1:
        return out
    cfg, traffic = cell["config"]["gradient_config"], cell["traffic"]
    (px5, py5), (gp5, cbs) = cam[0][0][3:5], cam[0][1]
    W, H = sc["width"], sc["height"]
    n = px5.shape[0] // 5
    px, py = px5[:n].to(torch.int64), py5[:n].to(torch.int64)
    border = torch.stack([px == W - 1, px == 0, py == H - 1, py == 0])
    low = None if control is None else control["tri_p0"].dtype

    def part(g):
        return gp5.map(lambda a: a[g * n:(g + 1) * n])
    base = part(0)
    base = base.replace(radius=base.radius * traffic["scales"][0])
    sargs, sout = surf[0]

    def surface(scene, dtype=torch.float64):
        return ref_stages.surface_gather(
            scene, base, [part(g) for g in range(1, 5)], sargs[4],
            sargs[3].sorted_idx, light, border=border, dtype=dtype,
            n_emitted=max(cfg["surface_photons"], cfg["volume_photons"]),
            min_depth=cfg.get("min_depth", 0), me=traffic["use_manifold"],
            budget=traffic["me_pair_budget"])
    s_prog = sout if control is None else surface(control, low)
    out["sgather_err"], out["sgather_miss"] = _counts_rel(s_prog,
                                                          surface(sc))

    _, _, lane = ref_stages.segments(cbs, py * W + px, W, H,
                                     cfg["vol_segments_per_pixel"])
    v_prog = vol[0][1]
    if v_prog[0].shape[0] != lane.shape[0]:
        return out
    prog = bufs[0][:3] if control is None else ref_stages.buffers(
        n, gp5, s_prog, v_prog, lane, border, low)
    ref = ref_stages.buffers(n, gp5, s_prog, v_prog, lane, border)
    out["buffers_err"] = max(
        rel_err(a.reshape(-1, 3), b.reshape(-1, 3)) for a, b in zip(
            [prog[0], *prog[1], *prog[2]], [ref[0], *ref[1], *ref[2]]))
    return out


def numbers(log, sc, cell, seed, it, light, control=None):
    """plane0d's sweep numbers, beam_select_err, plane_err, vscale_err,
    sgather_err, sgather_miss and buffers_err of the recorded pass
    (`control`: the scene in a lower precision, whose reference takes the
    program's place)."""
    out = plane0d.numbers(log, sc, cell, seed, it, light, control)
    low = None if control is None else control["tri_p0"].dtype
    out.update(_volume_numbers(log, sc, cell, seed, it, low))
    out.update(_surface_numbers(log, sc, cell, light, control))
    return out
