"""K2's share of its roofline: the launches' byte bound (`counts/
attend_pair.py` at the cell's B, T and stage S, at 3.35 TB/s) times
every launch among the profiled stretch's device ops, over their device
time: count and time from the same launches (one launch a call)."""

from vapbench.common import log
from vapbench.counts import attend_pair
from vapbench.trace import kernel_calls

PATTERN = "attend_pair_kernel"


def read(ctx, name):
    summ = ctx.get("summary")
    if not summ:
        return None
    calls, t = kernel_calls(summ["ops"], PATTERN)
    log("trace: attend_pair calls timed", calls, "counter",
        ctx.get("counters", {}).get("attend_pair.launches"))
    if not calls:
        return None
    bound = attend_pair.bound_s(ctx["streams"], ctx["T"], ctx["stage"],
                                ctx["peaks"], ctx["model"]["dim"])
    return 100.0 * bound * calls / t
