"""Device milliseconds per tick in the trunk's kernels: every kernel of
the tick that is neither the encoder's nor the attend's (LayerNorms,
linears, cache and stage writes, the staged merge, the heads), over
every op the profiled stretch launched, divided by the ticks it
dispatched."""

from vapbench.trace import device_time, dispatched


def read(ctx, name):
    if not ctx.get("summary"):
        return None
    n = dispatched(ctx)
    t = device_time(ctx["summary"]["ops"], "trunk")
    return 1e3 * t / n if n and t > 0 else None
