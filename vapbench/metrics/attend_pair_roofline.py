"""K2's share of its roofline: the launches' byte bound (`counts/
attend_pair.py` at the cell's B, T and stage S, at 3.35 TB/s) over their
measured device time, over the traced ticks."""

from vapbench.counts import attend_pair
from vapbench.trace import traced_spans

PATTERN = "attend_pair_kernel"


def read(ctx, name):
    summ = ctx.get("summary")
    if not summ:
        return None
    spans = traced_spans(ctx)
    durs = [op["e"] - op["s"] for op in summ["ops"]
            if PATTERN in op["name"]
            and any(a <= op["s"] < b for a, b in spans)]
    if not durs:
        return None
    bound = attend_pair.bound_s(ctx["streams"], ctx["T"], ctx["stage"],
                                ctx["peaks"], ctx["model"]["dim"])
    return 100.0 * bound * len(durs) / sum(durs)
