"""K7's share of its roofline: each call's operations (`counts/
conv_stack_fused.py` over the tick's 2 N channel-streams of fresh
samples, bf16 at 989 TFLOP/s) over the device time of its launches
(conv0 and the four GEMM layers), over the traced ticks."""

import re

from vapbench.counts import conv_stack_fused
from vapbench.trace import traced_spans

PATTERN = re.compile(r"\bconv0_kernel\b|\bconv_layer_kernel\b")


def read(ctx, name):
    summ = ctx.get("summary")
    calls = ctx.get("counters", {}).get("conv_stack_fused.calls", 0)
    if not summ or not calls:
        return None
    spans = traced_spans(ctx)
    t = sum(op["e"] - op["s"] for op in summ["ops"]
            if PATTERN.search(op["name"])
            and any(a <= op["s"] < b for a, b in spans))
    if t <= 0:
        return None
    bound = conv_stack_fused.bound_s(2 * ctx["streams"], ctx["frame_shift"],
                                     ctx["peaks"], ctx["model"]["encoder_dim"])
    return 100.0 * bound * calls / t
