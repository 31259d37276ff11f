"""Device milliseconds a train step in the encoder: the kernels launched
inside the port's `vap.encode` span (the frozen conv stack, K5's
sequence body, the downsample), over the steps that started inside the
traced stretch."""

from vapbench.program import device_s_within, profiled


def read(ctx, name):
    summ = ctx.get("summary") or {}
    if "program" not in summ:
        return None
    steps = profiled(summ, ("vap.train.step",))
    if not steps:
        return None
    return 1e3 * device_s_within(summ, ("vap.encode",)) / len(steps)
