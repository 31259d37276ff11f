"""Closed loop at capacity: every stream active, ticks back to back, one
tick in flight behind the one being dispatched (as the native server's
tick ships the previous tick's results after dispatching the next).
The window runs from the first dispatch to the results of the last tick
dispatched before `seconds` had passed; its rate is the frames whose
results reached the host over that whole time."""

from __future__ import annotations

import time

from vapbench.serving import Serving, serving_result, traced_ticks


def quarter_rates(ends, t0, per):
    """Work per second in each quarter of the window (drift shows)."""
    import numpy as np

    e = np.asarray(ends) - t0
    edges = np.linspace(0, e[-1], 5)
    return [float(per * ((e > a) & (e <= b)).sum() / (b - a))
            for a, b in zip(edges[:-1], edges[1:])]


def run(ctx):
    import torch

    wl = ctx["workload"]
    sv = Serving(wl, ctx["config"], ctx["seed"], ctx["device"],
                 ctx.get("streams"), ctx.get("control"),
                 ctx.get("fault"))
    hz = sv.vcfg.frame_hz
    est = max(1, int(ctx["seconds"] * 30))      # a bound on the ticks run
    prof, p0, p1 = traced_ticks(ctx, sv, est)
    sv.frozen_ticks(3)
    sv.prepare(0)
    setup_s = time.time() - ctx["t_proc"]
    spans = {"arena": [], "tick": []}
    starts = []
    ends = []
    t0 = time.perf_counter()
    end = t0 + ctx["seconds"]
    prev = None
    k = 0
    done = t0
    least = ctx.get("min_ticks", 0)      # tests on a slow CPU
    while True:
        stop = time.perf_counter() >= end and k >= least
        if not stop:
            if prof is not None and k == p0:
                prof.start()
            sv.frames_ready()
            sv.prepare(k + 1)            # tick k - 2, its last user, is in
            with torch.profiler.record_function("vapbench.dispatch"):
                starts.append(time.perf_counter())
                cur = sv.dispatch(k, spans if not p0 <= k < p1 else None)
        if prev is not None:
            with torch.profiler.record_function("vapbench.collect"):
                sv.collect(*prev)
            done = time.perf_counter()
            ends.append(done)
            j = k - 1
            if not p0 <= j < p1:
                spans["tick"].append((starts[j], done))
            if prof is not None and j == p1 - 1:
                prof.stop()
        if stop:
            break
        prev = cur
        k += 1
    K = k
    window = done - t0
    e2e = {"stream_frames_per_s": K * sv.N / window, "setup_s": setup_s}
    if prof is not None and K < p1:
        raise SystemExit(f"the window ran {K} ticks, fewer than the "
                         f"traced stretch's end {p1}")
    return serving_result(ctx, sv, K, e2e, spans, prof, p1 - p0,
                          ("vapbench.dispatch", "vapbench.collect"),
                          {"ticks": K, "window_s": window,
                           "quarter_rates": quarter_rates(ends, t0, sv.N),
                           "hz_equivalent_streams": K * sv.N / window / hz})
