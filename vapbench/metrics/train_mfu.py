"""The training step's share of the card's float32 peak (67 TFLOP/s, the
precision of the configuration's training and of most of its FLOPs: the
frozen cuDNN conv stack, the trunk and its backward, with TF32 off): the
model FLOPs of a step (`counts/model.py`) times the untraced steps of the
traced run, over their host-clock time."""

from vapbench.counts.model import train_step_flops
from vapbench.trace import length


def read(ctx, name):
    spans = ctx["host"].get("step", [])
    if not spans:
        return None
    flops = train_step_flops(ctx["model"], ctx["batch"], ctx["samples"])
    return 100.0 * flops * len(spans) / (length(spans)
                                         * ctx["peaks"]["fp32_flops"])
