"""K5's share of its roofline in training: the sequence body's 3xTF32
operations (`counts/lstm_scan.py` at 2 x batch channel-streams and the
clip's trimmed CPC frames, at 495 TFLOP/s) over its launches' device
time, over the traced steps."""

from vapbench.counts import lstm_scan
from vapbench.trace import traced_spans

PATTERN = "lstm_seq_kernel"


def read(ctx, name):
    summ = ctx.get("summary")
    if not summ:
        return None
    spans = traced_spans(ctx)
    durs = [op["e"] - op["s"] for op in summ["ops"]
            if PATTERN in op["name"]
            and any(a <= op["s"] < b for a, b in spans)]
    if not durs:
        return None
    bound = lstm_scan.bound_s(2 * ctx["batch"], ctx["lstm_steps"],
                              ctx["peaks"], ctx["model"]["encoder_dim"])
    return 100.0 * bound * len(durs) / sum(durs)
