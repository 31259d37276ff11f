"""K5's share of its roofline in training: the sequence body's 3xTF32
operations (`counts/lstm_scan.py` at 2 x batch channel-streams and the
clip's trimmed CPC frames, at 495 TFLOP/s) times every launch among the
profiled stretch's device ops, over their device time: count and time
from the same launches (one launch a call)."""

from vapbench.common import log
from vapbench.counts import lstm_scan
from vapbench.trace import kernel_calls

PATTERN = "lstm_seq_kernel"


def read(ctx, name):
    summ = ctx.get("summary")
    if not summ:
        return None
    calls, t = kernel_calls(summ["ops"], PATTERN)
    log("trace: lstm_scan calls timed", calls, "counter",
        ctx.get("counters", {}).get("lstm_scan.sequence_launches"))
    if not calls:
        return None
    bound = lstm_scan.bound_s(2 * ctx["batch"], ctx["lstm_steps"],
                              ctx["peaks"], ctx["model"]["encoder_dim"])
    return 100.0 * bound * calls / t
