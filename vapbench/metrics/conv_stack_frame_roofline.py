"""K7's share of its roofline counted by the tick: the operations of a
tick's conv stacks (`counts/conv_stack_fused.py` over the 2 N
channel-streams' `frame_shift` fresh samples, bf16 at 989 TFLOP/s) times
the ticks the profiled stretch dispatched, over the device time of every
`conv0_kernel` and `conv_layer_kernel` launch the stretch made.  It reads
the same however many body calls or launches a frame takes (a 5 Hz
frame runs as four 800-sample calls, `ops/cuda/encoder.py`), where
`conv_stack_fused_roofline` counts whole calls at one frame's bound."""

import re

from vapbench.common import log
from vapbench.counts import conv_stack_fused
from vapbench.trace import dispatched

PATTERN = re.compile(r"\bconv0_kernel\b|\bconv_layer_kernel\b")


def k7_seconds(ops) -> float:
    """Summed device seconds of K7's bf16 launches that the profiled
    stretch made (their launch is among its runtime calls)."""
    return sum(op["e"] - op["s"] for op in ops
               if op["launched"] and PATTERN.search(op["name"]))


def read(ctx, name):
    summ = ctx.get("summary")
    if not summ:
        return None
    ticks = dispatched(ctx)
    t = k7_seconds(summ["ops"])
    counters = ctx.get("counters", {})
    log("trace: conv_stack_fused ticks", ticks, "device s", t,
        "body calls counted", counters.get("conv_stack_fused.calls"))
    if not ticks or t <= 0:
        return None
    bound = conv_stack_fused.bound_s(2 * ctx["streams"], ctx["frame_shift"],
                                     ctx["peaks"], ctx["model"]["encoder_dim"])
    return 100.0 * bound * ticks / t
