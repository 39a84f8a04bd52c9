"""The photon planes' (Plane(0D)) checks: the gradient plane sweep on a
sample of camera segments against reference/sweep.py (`sweep_err`,
`sweep_count_err`). Only sweeps of the plane's kinds are compared: a
recorded sweep of another kind has no reference here and reads MISSING,
as do the numbers of a pass that recorded no sweep."""

from __future__ import annotations

import torch

from ..check import MISSING, miss_share, rel_err, worst_of
from ..reference import sweep as ref_sweep

TARGETS = dict(sweep=("ops.beam_sweep", "gsweep"))
KINDS = ("gplane0d", "gplane0d_me")   # the ME kind sums the same pairs
SWEEP_SAMPLE = 512   # camera segments of a sweep call that are compared


def expected_calls(cell, me_calls):
    """None counted: a pass makes a sweep call a chunk of camera
    segments, and one with no plane sweep reads MISSING in numbers."""
    return {}


def numbers(log, sc, cell, seed, it, light, control=None):
    """sweep_err and sweep_count_err of the pass's plane sweeps on
    SWEEP_SAMPLE camera segments drawn from the seed and the pass index
    (`control`: the scene in a lower precision, in which the reference's
    sweep takes the program's place)."""
    dtype = torch.float32 if control is None else control["tri_p0"].dtype
    res = dict(sweep_err=[], sweep_count_err=[])
    gen = torch.Generator().manual_seed((seed + it) % (2 ** 63))
    for kind, args, _, out in log:
        if kind != "sweep":
            continue
        if args[0] not in KINDS:
            res["sweep_err"].append(MISSING)
            res["sweep_count_err"].append(MISSING)
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
        res["sweep_err"].append(rel_err(p27, ref))
        res["sweep_count_err"].append(miss_share(
            torch.stack([pv, pok], 1), torch.stack([vis, ok], 1)))
    return {k: worst_of(v) for k, v in res.items()}
