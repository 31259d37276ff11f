"""Blocking host syncs a tick (or a train step) inside the port's spans:
the `cudaStreamSynchronize` / `cudaDeviceSynchronize` runtime calls of
the traced stretch whose innermost span is a program span
(`summary["syncs_by_span"]`, `vapbench/program.py`), over the ticks or
steps that started inside the stretch.  Each one makes the host wait for
the device before it dispatches the rest of the tick."""

from vapbench.program import ROOTS, profiled


def read(ctx, name):
    summ = ctx.get("summary") or {}
    if "program" not in summ:
        return None
    roots = profiled(summ, ROOTS)
    if not roots:
        return None
    n = sum(c for span, (c, _) in summ["syncs_by_span"].items()
            if span != "none")
    return n / len(roots)
