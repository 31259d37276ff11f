"""Mean host milliseconds a tick inside the port's `vap.probs` span (the
head logits to the served probabilities, where the step's blocking
syncs run), over the spans that started in the untraced ticks of the
traced run (the harness's host-clock tick spans, the same clock)."""

from vapbench.program import host_self_s


def read(ctx, name):
    summ = ctx.get("summary") or {}
    ticks = ctx["host"].get("tick", [])
    if "program" not in summ or not ticks:
        return None
    d = host_self_s(summ, ticks).get("vap.probs")
    return 1e3 * d[1] / len(ticks) if d else None
