"""The VPM distance estimator's checks: the camera segments cut to the
pass's budget (`segment_err`), the surface and the volume gather as whole
functions from the camera pass's output, the photon table and the light
records (their query rows, the per-pair sums, the scaling into estimates
and the ME pairs' terms: `sgather_*`, `vgather_*`), and the pass buffers
from the gathers' returns (`buffers_err`), against reference/stages.py."""

from __future__ import annotations

import torch

from ..check import MISSING, rel_err
from ..reference import rng as ref_rng
from ..reference import stages as ref_stages

TARGETS = dict(volume_gather=("integrators.gradient_gather",
                              "volume_gather"))


def expected_calls(cell, me_calls):
    """A volume gather, and a kernel call for the surface gather and one
    a volume sample."""
    cfg = cell["config"]["gradient_config"]
    return dict(gather=1 + cfg["volume_samples"], volume_gather=1)


def _counts_rel(prog, ref):
    """(mean relative error of primal, S and W over the queries whose
    visits and shift_ok agree, share of queries whose counts differ) of
    two gather returns (primal [M, 3], S [4, M, 3], W [4, M, 3], visits,
    shift_ok, ...)."""
    cp = torch.stack([prog[3].to(torch.int64), prog[4].to(torch.int64)], 1)
    cr = torch.stack([ref[3].to(torch.int64), ref[4].to(torch.int64)], 1)
    live = (cp != 0).any(1) | (cr != 0).any(1)
    miss = (cp != cr).any(1)

    def flat(r):
        return torch.cat([r[0], r[1].permute(1, 0, 2).reshape(-1, 12),
                          r[2].permute(1, 0, 2).reshape(-1, 12)], 1)
    keep = ~miss
    err = rel_err(flat(prog)[keep], flat(ref)[keep]) if bool(keep.any()) \
        else 0.0
    return err, float(miss[live].double().mean()) if bool(live.any()) \
        else 0.0


def numbers(log, sc, cell, seed, it, light, control=None):
    """segment_err, sgather_err / sgather_miss, vgather_err / vgather_miss,
    buffers_err: the camera segments compacted to the pass's budget
    against the volume gather's (exact share of differing values); each
    gather as a whole function (reference/stages.py) from the camera
    pass's output, the photon table and the light records `light`; the
    pass buffers from the gathers' returns. `control`: the scene in a
    lower precision whose stages take the program's place."""
    cfg = cell["config"]["gradient_config"]
    traffic = cell["traffic"]
    out = dict(segment_err=MISSING, sgather_err=MISSING,
               sgather_miss=MISSING, vgather_err=MISSING,
               vgather_miss=MISSING, buffers_err=MISSING)
    cam = [(a, o) for k, a, _, o in log if k == "camera"]
    surf = [(a, o) for k, a, _, o in log if k == "surface_gather"]
    vol = [(a, o) for k, a, _, o in log if k == "volume_gather"]
    bufs = [o for k, _, _, o in log if k == "buffers"]
    if light is None or len(cam) != 1 or len(surf) != 1 or len(vol) != 1 \
            or len(bufs) != 1:
        return out
    (px5, py5), (gp5, cbs) = cam[0][0][3:5], cam[0][1]
    W, H = sc["width"], sc["height"]
    n = px5.shape[0] // 5
    px, py = px5[:n].to(torch.int64), py5[:n].to(torch.int64)
    border = torch.stack([px == W - 1, px == 0, py == H - 1, py == 0])
    low = None if control is None else control["tri_p0"].dtype
    scales = traffic["scales"]
    kw = dict(n_emitted=max(cfg["surface_photons"], cfg["volume_photons"]),
              min_depth=cfg.get("min_depth", 0),
              me=traffic["use_manifold"], budget=traffic["me_pair_budget"])

    def part(g):
        return gp5.map(lambda a: a[g * n:(g + 1) * n])
    base = part(0)
    base = base.replace(radius=base.radius * scales[0])
    sgps = [part(g) for g in range(1, 5)]
    sargs, sout = surf[0]

    def surface(scene, dtype=torch.float64):
        return ref_stages.surface_gather(
            scene, base, sgps, sargs[4], sargs[3].sorted_idx, light,
            border=border, dtype=dtype, **kw)
    s_prog = sout if control is None else surface(control, low)
    out["sgather_err"], out["sgather_miss"] = _counts_rel(s_prog,
                                                          surface(sc))

    vargs, vout = vol[0]
    cb, scb, lane = ref_stages.segments(cbs, py * W + px, W, H,
                                        cfg["vol_segments_per_pixel"])
    lane_b = torch.stack([border[i][lane] for i in range(4)])
    diff = int((lane_b != vargs[8]).sum())
    total = lane_b.numel()
    for mine, theirs in zip([cb] + scb, [vargs[1]] + list(vargs[2])):
        for k in ref_stages.CAMERA_FIELDS + ("gid",):
            diff += int((mine[k] != theirs[k]).sum())
            total += mine[k].numel()
    out["segment_err"] = diff / max(total, 1)
    ext = (sc["medium_hi"] - sc["medium_lo"]).double()
    r_vol = 0.02 * float(torch.linalg.vector_norm(ext)) \
        * cfg["initial_scale_volume"] * scales[1]
    key = ref_rng.pass_key(seed, it, ref_rng.STREAM_GATHER)

    def volume(scene, dtype=torch.float64):
        return ref_stages.volume_gather(
            scene, cb, scb, vargs[4], vargs[3].sorted_idx, light, r_vol=r_vol,
            key=key, border=lane_b, n_samples=cfg["volume_samples"],
            dtype=dtype, **kw)
    v_prog = vout if control is None else volume(control, low)
    out["vgather_err"], out["vgather_miss"] = _counts_rel(v_prog, volume(sc))

    prog = bufs[0][:3] if control is None else ref_stages.buffers(
        n, gp5, s_prog, v_prog, lane, border, low)
    ref = ref_stages.buffers(n, gp5, s_prog, v_prog, lane, border)
    out["buffers_err"] = max(
        rel_err(a.reshape(-1, 3), b.reshape(-1, 3)) for a, b in zip(
            [prog[0], *prog[1], *prog[2]], [ref[0], *ref[1], *ref[2]]))
    return out
