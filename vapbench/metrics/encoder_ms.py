"""Device milliseconds per tick in the encoder's kernels: those launched
inside the port's streaming encoder (`kernel_layers.json` "spans": the
conv stack on K7, the serving LSTM, the downsample) or matching its
encoder patterns, over the traced ticks."""

from vapbench.trace import device_time, traced_spans


def read(ctx, name):
    if not ctx.get("summary") or not ctx["n_traced"]:
        return None
    t = device_time(ctx["summary"]["ops"], traced_spans(ctx), "encoder")
    return 1e3 * t / ctx["n_traced"] if t > 0 else None
