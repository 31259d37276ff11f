"""Device milliseconds per tick in the trunk's kernels: every kernel of
the tick that is neither the encoder's nor the attend's (LayerNorms,
linears, cache and stage writes, the staged merge, the heads), over the
traced ticks."""

from vapbench.trace import device_time, traced_spans


def read(ctx, name):
    if not ctx.get("summary") or not ctx["n_traced"]:
        return None
    t = device_time(ctx["summary"]["ops"], traced_spans(ctx), "trunk")
    return 1e3 * t / ctx["n_traced"] if t > 0 else None
