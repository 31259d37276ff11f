"""K7's share of its roofline: each call's operations (`counts/
conv_stack_fused.py` over the tick's 2 N channel-streams of fresh
samples, bf16 at 989 TFLOP/s) times the whole calls among the profiled
stretch's device ops, over those calls' device time.  A call is the bf16
body's five launches (`csrc/conv_stack_fused.cu`): `conv0_kernel`, then
the four `conv_layer_kernel` GEMM layers after it on the device's
timeline.  Count and time come from the same launches; the port's call
counter is logged beside them as a cross-check and is no factor."""

from vapbench.common import log
from vapbench.counts import conv_stack_fused
from vapbench.trace import kernel_calls

FIRST = r"\bconv0_kernel\b"
THEN = r"\bconv_layer_kernel\b"
LAUNCHES = 5


def read(ctx, name):
    summ = ctx.get("summary")
    if not summ:
        return None
    calls, t = kernel_calls(summ["ops"], FIRST, THEN, LAUNCHES)
    log("trace: conv_stack_fused calls timed", calls, "counter",
        ctx.get("counters", {}).get("conv_stack_fused.calls"))
    if not calls:
        return None
    bound = conv_stack_fused.bound_s(2 * ctx["streams"], ctx["frame_shift"],
                                     ctx["peaks"], ctx["model"]["encoder_dim"])
    return 100.0 * bound * calls / t
