"""The whole serving tick's share of the card's bf16 peak: the model
FLOPs of one tick (`counts/model.py`, from the shapes) times the untraced
ticks of the traced run, over the union of their host-clock spans
(dispatch to results on the host) times 989 TFLOP/s.  Bounds every
kernel's roofline in the serving cells."""

from vapbench.counts.model import tick_flops
from vapbench.trace import length


def read(ctx, name):
    spans = ctx["host"].get("tick", [])
    if not spans:
        return None
    flops = tick_flops(ctx["model"], ctx["streams"]) * len(spans)
    return 100.0 * flops / (length(spans) * ctx["peaks"]["bf16_flops"])
