"""Device milliseconds per tick of the encoder layer's kernels that are
not K7's: the serving LSTM's steps, the downsample, the casts and the
carries' selects (every op of the `encoder` layer that the profiled
stretch launched, less the `conv0_kernel` / `conv_layer_kernel`
launches), over the ticks it dispatched."""

from vapbench.metrics.conv_stack_frame_roofline import PATTERN
from vapbench.trace import dispatched


def read(ctx, name):
    summ = ctx.get("summary")
    if not summ:
        return None
    n = dispatched(ctx)
    t = sum(op["e"] - op["s"] for op in summ["ops"]
            if op["layer"] == "encoder" and op["launched"]
            and not PATTERN.search(op["name"]))
    return 1e3 * t / n if n and t > 0 else None
