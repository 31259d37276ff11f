"""The share of the traced busy spans in which no kernel runs: each
tick's span (dispatch to results on the host; an open loop's pacing wait
is outside it), or the whole traced stretch where ticks or steps run
back to back, less the union of the kernel intervals inside it."""

from vapbench.trace import covered, kernels, length, traced_spans


def read(ctx, name):
    if not ctx.get("summary"):
        return None
    spans = traced_spans(ctx)
    total = length(spans)
    if total <= 0:
        return None
    return 100.0 * (1.0 - covered(kernels(ctx), spans) / total)
