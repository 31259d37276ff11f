"""Open loop: every stream's frame is due once a frame period, all at
once (the arena's tick), due times fixed from the window's start.  A
frame's latency runs from its due time to the moment its result fields
are in host memory; a late tick never moves a later due time, so a stall
counts in every frame it delays.  Ticks are dispatched at their due time
or, when late, as soon as the previous tick's results are in."""

from __future__ import annotations

import time

from vapbench.common import nearest_rank
from vapbench.serving import Serving, serving_result, traced_ticks


def _wait_until(t: float) -> None:
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        time.sleep(left - 0.001 if left > 0.002 else 0)


def run(ctx):
    import torch

    wl = ctx["workload"]
    sv = Serving(wl, ctx["config"], ctx["seed"], ctx["device"],
                 ctx.get("streams"), ctx.get("control"),
                 ctx.get("fault"))
    hz = sv.vcfg.frame_hz
    K = max(1, int(round(ctx["seconds"] * hz)))
    prof, p0, p1 = traced_ticks(ctx, sv, K)
    sv.frozen_ticks(3)
    sv.prepare(0)
    setup_s = time.time() - ctx["t_proc"]
    spans = {"arena": [], "tick": []}
    lat = []
    t0 = time.perf_counter() + 0.005
    for k in range(K):
        if prof is not None and k == p0:
            prof.start()
        due = t0 + k / hz
        with torch.profiler.record_function("vapbench.pace"):
            _wait_until(due)
            sv.frames_ready()
        with torch.profiler.record_function("vapbench.tick"):
            ts = time.perf_counter()
            host, ev = sv.dispatch(k, spans if not p0 <= k < p1 else None)
            if k + 1 < K:
                sv.prepare(k + 1)
            sv.collect(host, ev)
            done = time.perf_counter()
        if prof is not None and k == p1 - 1:
            prof.stop()
        lat.append(done - due)
        if not p0 <= k < p1:
            spans["tick"].append((ts, done))
    e2e = {"frame_latency_p95_ms": 1e3 * nearest_rank(lat, 0.95),
           "frame_latency_p50_ms": 1e3 * nearest_rank(lat, 0.50),
           "setup_s": setup_s}
    late = sum(1 for x in lat if x > 1.0 / hz)
    return serving_result(ctx, sv, K, e2e, spans, prof, p1 - p0,
                          ("vapbench.tick",), {"ticks": K, "late_ticks": late,
                           "lat_max_ms": 1e3 * max(lat)})
