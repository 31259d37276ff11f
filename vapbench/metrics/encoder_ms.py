"""Device milliseconds per tick in the encoder's kernels: those launched
inside the port's streaming encoder (`kernel_layers.json` "spans": the
conv stack on K7, the serving LSTM, the downsample) or matching its
encoder patterns, over every op the profiled stretch launched, divided
by the ticks it dispatched."""

from vapbench.trace import device_time, dispatched


def read(ctx, name):
    if not ctx.get("summary"):
        return None
    n = dispatched(ctx)
    t = device_time(ctx["summary"]["ops"], "encoder")
    return 1e3 * t / n if n and t > 0 else None
