"""Device milliseconds of one staged merge (one tick in 8): the kernels
launched inside the port's `vap.merge` spans of the traced stretch, over
the number of those spans.  The merge's tick sets the open loop's p95."""

from vapbench.program import device_s_within, profiled


def read(ctx, name):
    summ = ctx.get("summary") or {}
    if "program" not in summ:
        return None
    merges = profiled(summ, ("vap.merge",))
    if not merges:
        return None
    return 1e3 * device_s_within(summ, ("vap.merge",)) / len(merges)
