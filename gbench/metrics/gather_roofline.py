"""Share of the least time the card could take for the photon gathers
(gbench/roofline/gather.py, from the reference's pair counts of the
profiled passes) in the device time of the gather kernels
(csrc/fused_gather.cu: fused_gather_kernel and its row_heads_kernel) of
those passes, %."""

from ..roofline import gather
from . import kernel_s


def read(rec):
    t = kernel_s(rec, "fused_gather_kernel", "row_heads_kernel")
    work = (rec.get("work") or {}).get("gather")
    if not t or not work:
        return None
    return 100.0 * sum(gather.least_seconds(w) for w in work) / t
