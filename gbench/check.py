"""What decides `correct`: the numbers that compare what the timed path
produced with the plain reference (gbench/reference), and their limits.

The light pass and the camera pass are worked out again from the scene,
the seed and the pass index alone, for a sample of paths and pixels
drawn from the seed (`light_*`, `camera_*`). The surface and volume
gathers are worked out again as whole functions from the camera pass's
output, the photon table and the light records: their query rows, the
per-pair sums, the scaling into estimates and the ME pairs' terms
(`sgather_*`, `vgather_*`), and the pass buffers from the gathers'
returns (`buffers_err`). Each stage's input from an earlier one is
checked by itself: the camera segments cut to the pass's budget
(`segment_err`), the gathers' photon rows against the light records
(`table_err`), the ME shifts from the records' chains (`me_shift_*`),
the kernels on the program's own rows (`gather_err`, `count_err`), a
rank's film against every rank's buffers (`film_gather_err`). The film
and the solve are followed from the buffers and the running mean. A
stage that recorded fewer calls than the pass makes, or more, counts in
`stage_calls`, and a number whose stage was never called reads inf.
Each number is 0 for a perfect match; the limits are data
(gbench/limits/<cell>.json).
"""

from __future__ import annotations

import torch

from .reference import camera as ref_camera
from .reference import film as ref_film
from .reference import gather as ref_gather
from .reference import light as ref_light
from .reference import me as ref_me
from .reference import poisson as ref_poisson
from .reference import rng as ref_rng
from .reference import stages as ref_stages
from .reference import sweep as ref_sweep

SWEEP_SAMPLE = 512   # camera segments of a sweep call that are compared
LIGHT_SAMPLE = 1024  # light paths of the pass that are traced again
CAMERA_SAMPLE = 512  # pixels (each with its four offset paths)
ME_SAMPLE = 512      # lanes of each ME shift call
MISSING = float("inf")


def _worst(values):
    """The largest of the values, inf where there is none."""
    return max(values) if values else MISSING


def _sample(n, k, gen, device):
    return torch.randperm(n, generator=gen)[:k].to(device)


def _rel(a, b):
    """The mean over rows, where either side is not all zero, of
    |a - b|_1 / (|b|_1 + m), m the median |b|_1 of those rows: a relative
    error that no single row's magnitude can hide (a pass may hold a
    query or pixel many orders above the rest)."""
    a = a.double().reshape(a.shape[0], -1)
    b = b.double().reshape(b.shape[0], -1)
    d = (a - b).abs().sum(1)
    mag = b.abs().sum(1)
    live = (mag > 0) | (a.abs().sum(1) > 0)
    if not bool(live.any()):
        return 0.0
    m = mag[live].median()
    return float((d[live] / (mag[live] + m).clamp_min(1e-300)).mean())


def _miss(a, b):
    """Share of rows, where either side is not all zero, whose integer
    counts differ."""
    a, b = a.to(torch.int64), b.to(torch.int64)
    live = (a != 0).any(1) | (b != 0).any(1)
    if not bool(live.any()):
        return 0.0
    return float((a != b).any(1)[live].double().mean())


def gather_calls(log):
    """(kind, me, table, qrows, r2, k3, min_depth, out, me_row) of each
    photon gather of a recorded pass."""
    for kind, args, _, out in log:
        if kind == "gather":
            ev, _plan, table, qrows, r2, k3, min_depth = args
            yield ("surface" if ev.name.startswith("surface") else "volume",
                   ev.me, table, qrows, r2, k3, min_depth) + tuple(out)


def compare_gather(prog, prog_key, ref, ref_key, me):
    """Numbers of one gather call: (value error, share of queries whose
    counts differ, share of the queries with an ME pair whose ME key
    differs). prog [Q, >=29] (primal, S, W, visits, shift_ok), ref the
    reference's [Q, 29]."""
    vals = _rel(prog[:, :27], ref[:, :27])
    cnt = _miss(prog[:, 27:29], ref[:, 27:29])
    if not me:
        return vals, cnt, 0.0
    has = int((ref_key != ref_gather.ME_NONE).sum())
    bad = int((prog_key.to(torch.int64) != ref_key).sum())
    return vals, cnt, bad / max(has, 1)


def gather_numbers(log, dtype=torch.float32, work=None):
    """gather_err, count_err, me_key_err over the pass's photon gathers,
    the ME pairs (queries with an ME key) that the reference and the
    program (or the control in its place) find, and each call's kind
    with the reference's ME pairs.
    `work`, a list, receives each call's work counts for the roofline."""
    found = dict(gather_err=[], count_err=[], me_key_err=[])
    me_queries = me_prog = 0
    per_call = []
    for kind, me, table, qrows, r2, k3, md, prog, prog_key in \
            gather_calls(log):
        ref, key, rows_hit = ref_gather.gather(kind, table, qrows, r2,
                                                    k3, md, torch.float32)
        if dtype != torch.float32:      # the control in the program's place
            prog, prog_key, _ = ref_gather.gather(
                kind, table, qrows, r2, k3, md, dtype)
        v, c, m = compare_gather(prog, prog_key, ref, key, me)
        found["gather_err"].append(v)
        found["count_err"].append(c)
        found["me_key_err"].append(m)
        per_call.append((kind, int((key != ref_gather.ME_NONE).sum())
                         if me else 0))
        if me:
            me_queries += per_call[-1][1]
            me_prog += int((prog_key.to(torch.int64)
                            != ref_gather.ME_NONE).sum())
        if work is not None:
            qs = ref_gather.SUR_QSLOT if kind == "surface" \
                else ref_gather.VOL_QSLOT
            qv = qs["valid"] if kind == "surface" else qs["sok"]
            work.append(dict(kind=kind, me=me, visits=float(ref[:, 27].sum()),
                             rows=rows_hit,
                             queries=int((qrows[:, qv] > 0.5).sum())))
    out = {k: _worst(v) for k, v in found.items()}
    return out, me_queries, me_prog, per_call


def _row_hashes(rows):
    """A 63-bit hash of the bits of each row's slots."""
    b = rows.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    g = torch.Generator().manual_seed(20180812)
    mult = torch.randint(1, 2 ** 62, (rows.shape[1],), generator=g) | 1
    return (b * mult.to(b.device)).sum(1) & 0x7FFFFFFFFFFFFFFF


def table_numbers(log, scene, light, caps):
    """table_err: every photon gather's rows of its vertex type against
    the light pass's records of that type packed again (`light`: the
    photon dict of all ranks' light passes), compared as multisets of
    whole rows, as a share of the records: rows of the table that are no
    record, and the rows missing beyond the row cap `caps[kind]` (0 for
    none); and each gather's row j against the record its grid names
    for it (`sorted_idx[j]`), as a share of the rows that differ."""
    expect = ref_gather.pack_rows(scene, light)
    vt = ref_gather.ROW_SLOT["vtype"]
    n = ref_gather.N_ROW_SLOTS
    worst = []
    for kind, _, table, *_ in gather_calls(log):
        v = 1.0 if kind == "surface" else 2.0
        he = _row_hashes(expect[expect[:, vt] == v][:, :n])
        ht = _row_hashes(table[table[:, vt] == v][:, :n])
        cap = caps.get(kind) or he.shape[0]
        u, inv = torch.unique(torch.cat([he, ht]), return_inverse=True)
        ce = torch.bincount(inv[:he.shape[0]], minlength=u.shape[0])
        ct = torch.bincount(inv[he.shape[0]:], minlength=u.shape[0])
        bad = int(torch.clamp(ct - ce, min=0).sum()) \
            + abs(ht.shape[0] - min(he.shape[0], cap))
        worst.append(bad / max(he.shape[0], 1))
    for kind, args, _, _ in log:
        if kind in ("surface_gather", "volume_gather"):
            grid, table = args[3], args[4]
            mine = expect[grid.sorted_idx][:, :n]
            diff = (mine.view(torch.int32) != table[:, :n].view(
                torch.int32)).any(1)
            worst.append(float(diff.double().mean()) if diff.numel()
                         else 0.0)
    return _worst(worst)


def sweep_numbers(log, seed, dtype=torch.float32):
    """sweep_err and sweep_count_err of the pass's gradient sweeps on
    SWEEP_SAMPLE camera segments drawn from `seed`."""
    res = dict(sweep_err=[], sweep_count_err=[])
    gen = torch.Generator().manual_seed(seed % (2 ** 63))
    for kind, args, _, out in log:
        if kind != "sweep":
            continue
        _, q, qx, rows, tails, _params = args
        valid = torch.nonzero(q[:, ref_sweep.QSLOT["valid"]] > 0.5)[:, 0]
        pick = torch.randperm(valid.shape[0], generator=gen)[:SWEEP_SAMPLE]
        sample = valid[pick.to(valid.device)]
        ref, vis, ok = ref_sweep.sweep(q, qx, rows, tails, sample)
        if dtype != torch.float32:
            p27, pv, pok = ref_sweep.sweep(q, qx, rows, tails, sample, dtype)
        else:
            pr, S, W, pv, pok = out[:5]
            M = pr.shape[0]
            p27 = torch.cat([pr, S.permute(1, 0, 2).reshape(M, 12),
                             W.permute(1, 0, 2).reshape(M, 12)], 1)[sample]
            pv, pok = pv[sample], pok[sample]
        res["sweep_err"].append(_rel(p27, ref))
        res["sweep_count_err"].append(_miss(
            torch.stack([pv, pok], 1), torch.stack([vis, ok], 1)))
    return {k: _worst(v) for k, v in res.items()}


def film_numbers(log, height, width, dtype=torch.float64):
    """film_err: the assembled primal and gradients against the
    reference's assembly of the same buffers."""
    worst = []
    for kind, args, _, out in log:
        if kind != "film":
            continue
        p, S, W = (a.to(torch.float64) for a in args[:3])
        ref = ref_film.assemble(p, S, W, height, width)
        prog = out if dtype == torch.float64 else ref_film.assemble(
            *(a.to(dtype) for a in args[:3]), height, width)
        worst.append(max(_rel(a.reshape(-1, 3), b.reshape(-1, 3))
                         for a, b in zip(prog, ref)))
    return _worst(worst)


def film_gather_numbers(log, rank_buffers):
    """film_gather_err: share of the film's buffer elements that differ
    from every rank's own buffers concatenated in rank order."""
    p, S, W = rank_buffers
    worst = []
    for kind, args, _, _ in log:
        if kind != "film":
            continue
        bad = sum(int((a != b).sum()) for a, b in
                  zip(args[:3], (p, S, W)))
        worst.append(bad / (p.numel() + S.numel() + W.numel()))
    return _worst(worst)


def solve_numbers(inputs, output, cfg, dtype=torch.float64):
    """solve_err: the program's reconstruction against the reference's
    in float64 (or, as the control, the reference in `dtype`)."""
    primal, gx, gy = inputs
    kw = dict(alpha=cfg.recon_alpha, iters=cfg.recon_iters,
              irls_iters=cfg.recon_irls_iters, l1=cfg.recon_l1)
    ref = ref_poisson.solve(primal.double(), gx.double(), gy.double(), **kw)
    if dtype != torch.float64:
        output = ref_poisson.solve(primal.to(dtype), gx.to(dtype),
                                   gy.to(dtype), **kw)
    return _rel(output.reshape(-1, output.shape[-1]),
                ref.reshape(-1, ref.shape[-1]))


def light_numbers(log, sc, cfg, seed, it, gen, control=None):
    """light_err, light_miss: the light pass's records of LIGHT_SAMPLE
    paths against the reference's trace of them (`control`: the scene in
    a precision below float32, whose trace takes the program's place).
    A call whose records are not one a step and path misses every
    path."""
    found = dict(light_err=[], light_miss=[])
    for kind, args, kwargs, out in log:
        if kind != "light":
            continue
        n = int(args[2])
        steps = cfg["max_depth"] + cfg["null_bounces"]
        dev = out[0]["p"].device
        lanes = _sample(n, LIGHT_SAMPLE, gen, dev)
        off = kwargs.get("path_offset")
        ref = ref_light.trace(sc, cfg, seed, it, n, lanes, off)
        if control is not None:
            prog = ref_light.trace(control, cfg, seed, it, n, lanes, off,
                                   control["tri_p0"].dtype)
        elif out[0]["p"].shape[0] != steps * n:
            found["light_err"].append(MISSING)
            found["light_miss"].append(1.0)
            continue
        else:
            prog = {k: v.reshape((steps, n) + v.shape[1:])[:, lanes]
                    for k, v in out[0].items() if k in ref}
        e, m = ref_light.compare(prog, ref, only=ref_light.read_masks(ref))
        found["light_err"].append(e)
        found["light_miss"].append(m)
    return {k: _worst(v) for k, v in found.items()}


def camera_numbers(log, sc, cfg, seed, it, gen, control=None,
                   whole_film=True):
    """camera_err, camera_miss: the gather points and medium segments of
    CAMERA_SAMPLE pixels' base and offset paths against the reference's
    (`control` as in light_numbers). With `whole_film` (one rank) the
    call's base pixels must be the film's in row-major order, else
    every path misses."""
    found = dict(camera_err=[], camera_miss=[])
    H, W = sc["height"], sc["width"]
    for kind, args, _, out in log:
        if kind != "camera":
            continue
        px5, py5 = args[3], args[4]
        n = px5.shape[0] // 5
        dev = px5.device
        i = _sample(n, CAMERA_SAMPLE, gen, dev)
        pixels = (py5[i] * W + px5[i]).to(torch.int64)
        gr, sr = ref_camera.trace(sc, cfg, seed, it, pixels)
        if control is not None:
            gp, sg = ref_camera.trace(control, cfg, seed, it, pixels,
                                      control["tri_p0"].dtype)
        else:
            lanes = ref_camera.lanes_of(i, n)
            gp = {k: getattr(out[0], k)[lanes] for k in gr}
            sg = {k: getattr(out[1], k)[:, lanes] for k in sr}
        e, m = ref_camera.compare(gp, gr, sg, sr)
        if whole_film:
            grid = torch.arange(H * W, device=dev)
            if n != H * W or bool(((py5[:n] * W + px5[:n]).to(torch.int64)
                                   != grid).any()):
                e, m = MISSING, 1.0
        found["camera_err"].append(e)
        found["camera_miss"].append(m)
    return {k: _worst(v) for k, v in found.items()}


def me_numbers(log, sc, gen, control=None):
    """me_shift_err, me_shift_miss: ME_SAMPLE lanes of each ME shift call
    against the reference's shift of the same photons (their chains
    walked up from the call's records) to the same targets (`control` as
    in light_numbers). Each shift call pairs with the chain walk that
    precedes it."""
    found = dict(me_shift_err=[], me_shift_miss=[])
    pulls = [args for kind, args, _, _ in log if kind == "me_chains"]
    shifts = [(kind, args, out) for kind, args, _, out in log
              if kind in ("me_volume", "me_surface")]
    for (_, pv, idx), (kind, args, out) in zip(pulls, shifts):
        B = idx.shape[0]
        target = args[2] if kind == "me_volume" else args[5]
        dev = target.device
        lanes = _sample(target.shape[0], ME_SAMPLE, gen, dev)
        photon = idx[lanes % B]
        ch = ref_me.pull(sc, pv, photon)
        extra = None
        if kind == "me_surface":
            ns = pv["ns"][photon].double()
            extra = dict(prim=pv["prim"][photon], ns=ns,
                         enter=(pv["wi"][photon].double() * ns).sum(-1) < 0)
        what = "volume" if kind == "me_volume" else "surface"
        ref = ref_me.shift(sc, ch, target[lanes].double(), what, extra)
        if control is not None:
            low = control["tri_p0"].dtype

            def cast(d):
                return d and {k: v.to(low) if v.is_floating_point() else v
                              for k, v in d.items()}
            prog = ref_me.shift(control, cast(ch), target[lanes].to(low),
                                what, cast(extra))
        else:
            prog = tuple(o[lanes] for o in out)
        e, m = ref_me.compare(prog, ref)
        found["me_shift_err"].append(e)
        found["me_shift_miss"].append(m)
    return {k: _worst(v) for k, v in found.items()}


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
    err = _rel(flat(prog)[keep], flat(ref)[keep]) if bool(keep.any()) \
        else 0.0
    return err, float(miss[live].double().mean()) if bool(live.any()) \
        else 0.0


def stage_numbers(log, sc, cell, seed, it, light, control=None):
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
    if len(cam) != 1 or len(surf) != 1 or len(vol) != 1 or len(bufs) != 1:
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
        _rel(a.reshape(-1, 3), b.reshape(-1, 3)) for a, b in zip(
            [prog[0], *prog[1], *prog[2]], [ref[0], *ref[1], *ref[2]]))
    return out


def stage_calls(log, expected):
    """How many calls of each stage the pass made beyond or short of
    `expected` ({kind: calls}), summed."""
    made = {}
    for kind, *_ in log:
        made[kind] = made.get(kind, 0) + 1
    return float(sum(abs(made.get(k, 0) - v) for k, v in expected.items()))


STATS = ("visits", "shift_ok", "win_dropped", "me_dropped", "me_pairs")


def stats_of(stats):
    return {k: int(stats[k]) for k in STATS}


def judge(numbers, limits):
    """(correct, [(name, value, limit)]): every number at or under its
    limit; a number without a limit, or a limit without its number,
    fails."""
    rows = [(k, numbers.get(k), limits.get(k))
            for k in sorted(set(numbers) | set(limits))]
    ok = all(v is not None and lim is not None and v <= lim
             for _, v, lim in rows)
    return ok, rows
