"""Work of a gradient photon gather call (the program's K1 / K2 and
their ME instantiations), from the reference's count of the pairs within
the kernel radius:

  bytes       each photon row that some pair reads, in the slots the
              estimator's formulas read, each valid query row in its
              slots, and each valid query's output (29 sums, and the ME
              row key where ME is on), four bytes a value, once each
  operations  per pair within the radius, the base term and the four
              shifts of the estimator: volume 46 + 4 x (112 + 86 + 49),
              surface 51 + 4 x (112 + 104 + 56) float operations (an add
              and a multiply one each: the shift's reconnection, its
              parent-lobe ratio and its MIS weight and accumulation), and
              4 more with ME (three mask terms and the key's minimum)
"""

from __future__ import annotations

import torch

from . import peaks

PAIR_OPS = {"volume": 46 + 4 * (112 + 86 + 49),
            "surface": 51 + 4 * (112 + 104 + 56)}
ME_OPS = 4
N_OUT = 29


def slots_read(kind, me):
    """(photon-row slots, query-row slots) that the reference's formulas
    read for this estimator, found by running them on one pair."""
    from ..reference import gather as g

    class Seen(g.Cols):
        def col(self, k):
            self.seen.add(k)
            return super().col(k)

    one = torch.zeros((1,), dtype=torch.int64)
    qs = g.SUR_QSLOT if kind == "surface" else g.VOL_QSLOT
    q = Seen(torch.zeros((1, 128)), one, qs)
    r = Seen(torch.zeros((1, g.ROW_F)), one, g.ROW_SLOT)
    q.seen, r.seen = set(), set()
    fn = g.surface_pairs if kind == "surface" else g.volume_pairs
    fn(q, r, 0, 1.0, 1.0)
    if not me:      # the ME eligibility's own inputs
        r.seen -= {g.ROW_SLOT["pm_delta"], g.ROW_SLOT["own_delta"]}
    return len(r.seen), len(q.seen)


def least_seconds(work):
    """work: dict(kind, me, visits, rows, queries) of one call."""
    kind, me = work["kind"], work["me"]
    row_slots, q_slots = slots_read(kind, me)
    n_bytes = 4 * (work["rows"] * row_slots + work["queries"] * q_slots
                   + work["queries"] * (N_OUT + (1 if me else 0)))
    flops = work["visits"] * (PAIR_OPS[kind] + (ME_OPS if me else 0))
    return peaks.least_seconds(n_bytes, flops)
