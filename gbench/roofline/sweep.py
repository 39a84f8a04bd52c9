"""Work of a plane pass's gradient photon-plane sweep (the program's
gplane0d, ME off), from counts that read the same whatever implements
the sweep:

  bytes       each plane row and each valid camera segment once, in the
              slots that reference/sweep.py's formulas read (a plane's
              row and its gradient tail; a segment's query row and its
              four offset rays), and each segment's 27 sums, four bytes a
              value
  operations  per hit (a plane-segment intersection that the sweep's
              visits count), the base term and the four offsets' shifts
              on the branch each takes, counted by hand from the formulas
              of reference/sweep.py's pair_terms (csrc/beam_eval.cuh's
              GPlane0DT evaluates the same ones) as roofline/gather.py
              counts its pairs: an add, subtract, multiply, divide,
              compare, select, clamp, abs, square root or exp one each,
              sign flips and loads none

The count of a hit, in the parts below:

  base term         BASE_PARTS      120  t0 and t1; the two survivals;
                                         the Jacobian |w0 . (w1 x d)|;
                                         the phase and its cosine (HG
                                         and Rayleigh both evaluated);
                                         the kernel's quotient; three
                                         channels of transmittance; the
                                         base point's direction from the
                                         plane's origin; the base sums
                                         and the visit
  identity shift    IDENTITY_PARTS  193  the same plane against the offset
                                         ray (Moller-Trumbore, the range
                                         tests), its terms, MIS and the
                                         six sums
  rotation shift    ROTATION_PARTS  389  the plane rotated about its origin
                                         onto the offset point (Rodrigues
                                         of w0 and w1), the parent lobe's
                                         ratio (parent_lobe 112, as in
                                         roofline/gather.py's shifts), the
                                         pdf ratio, its terms, MIS and
                                         the six sums

A hit takes the base term and, at each of its four offsets, the identity
shift, or the rotation shift where the plane's origin is reconnectable.
The program counts the offsets whose rotation succeeded (shift_ok), not
those that ran it, so each offset whose rotation failed is counted at
the identity shift's cost:

  operations = hits (BASE + 4 IDENTITY) + reconnections (ROTATION - IDENTITY)
             = 892 hits + 196 reconnections

which is at most the operations the hits take: the least time is low,
never high. The test of every segment against every plane in its medium
(23 operations a pair before the hit is known) is left out, as the
gather's roofline leaves out the pairs outside the radius: the count is
of the hits alone. With ME on, the planes that the ME stage resolves run
no shift in the sweep, and the count is not a bound there.

The counts come from the program's StatsCounters sweep/hits,
sweep/reconnections, sweep/rows and sweep/segments
(gvpm_tpu_torch.integrators.gradient_gather.plane_gradient_gather).
"""

from __future__ import annotations

import torch

from . import peaks

BASE_PARTS = dict(t0_t1=2, survival=12, survival_plane=2, jacobian=15,
                  phase_and_cosine=24, quotient=6, channels=36,
                  base_direction=19, sums_and_visit=4)
IDENTITY_PARTS = dict(branch=1, edges=6, plane_hit=47, range_tests=14,
                      t0_t1=2, jacobian=15, quotient=44, channels=39,
                      mis=10, sums=15)
ROTATION_PARTS = dict(offset_direction=19, cos_r=5, axis=21, rodrigues=68,
                      scale=3, geometry_tests=6, lobe_ratio=126, cosine=5,
                      survivals=14, jacobian=15, shift_tests=7, quotient=25,
                      channels=36, pdf_ratio=13, branch=1, mis=10, sums=15)
BASE_OPS = sum(BASE_PARTS.values())
IDENTITY_OPS = sum(IDENTITY_PARTS.values())
ROTATION_OPS = sum(ROTATION_PARTS.values())
N_OUT = 27


def _one_pair():
    """A query, offset, plane and tail row of one pair, zeros but the
    unit directions."""
    from ..reference import sweep as rs
    q = torch.zeros((1, max(rs.QSLOT.values()) + 3))
    q[0, rs.QSLOT["d"] + 2] = 1.0
    x = torch.zeros((1, 4 * rs.XSTRIDE))
    for i in range(4):
        x[0, i * rs.XSTRIDE + 5] = 1.0
    b = torch.zeros((1, max(rs.BSLOT.values()) + 3))
    b[0, rs.BSLOT["d"]] = b[0, rs.BSLOT["w1"] + 1] = 1.0
    t = torch.zeros((1, max(rs.TSLOT.values()) + 1))
    return q, x, b, t


def slots_read():
    """(plane slots: row and tail, segment slots: query row and offset
    rays) that the reference's base test and pair terms read."""
    from ..reference import sweep as rs

    class Seen(rs.Cols):
        def f1(self, name):
            self.seen.add(self.slots[name])
            return super().f1(name)

        def f3(self, name):
            self.seen.update(self.slots[name] + c for c in range(3))
            return super().f3(name)

    q, x, b, t = _one_pair()
    cq, cb, ct = (Seen(r, s, (-1,)) for r, s in
                  ((q, rs.QSLOT), (b, rs.BSLOT), (t, rs.TSLOT)))
    for c in (cq, cb, ct):
        c.seen = set()
    rs.base_test(cq, cb)
    rs.pair_terms(cq, cb, ct, x)
    return len(cb.seen) + len(ct.seen), len(cq.seen) + x.shape[1]


def operations(hits, reconnections):
    """The float operations of `hits` intersections of which
    `reconnections` offsets' rotation shifts succeeded."""
    return hits * (BASE_OPS + 4 * IDENTITY_OPS) \
        + reconnections * (ROTATION_OPS - IDENTITY_OPS)


def least_seconds(hits, reconnections, rows, segments):
    """The least time of one plane pass's sweep: `hits` intersections,
    `reconnections` successful rotation shifts, `rows` plane rows and
    `segments` valid camera segments."""
    plane_slots, seg_slots = slots_read()
    n_bytes = 4 * (rows * plane_slots + segments * (seg_slots + N_OUT))
    return peaks.least_seconds(n_bytes, operations(hits, reconnections))
