"""The knee sweep: the largest batch B (a multiple of 1024) whose tick
p95 stays under the frame period, for one serving configuration.

A tick here is the serving cells' tick (frames from host memory,
`step_device_batch`, the result fields copied to the host) with every
stream active, run back to back with nothing in flight behind it, so
its time is what a frame due at the tick's start would wait.  The sweep
steps B by `--coarse` until a tick p95 passes the period (or the card's
memory runs out), then by 1024 between the last B under and the first
over.  Each B builds its own arena in this process and frees it.

Run on the card, from the checkout's root:

    python3 -m vapbench.knee --workload vap20-fast-open \
        [--start 8192] [--coarse 4096] [--ticks 60] [--out knee.json]

Prints one JSON line per B (ms p50 / p95 / max, peak memory) and a last
line with the knee.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from vapbench.common import (
    gpu_line, load_config, load_workload, log, nearest_rank, setup_env,
)


def measure(wl, cfg, B: int, ticks: int, seed: int) -> dict:
    import torch

    from vapbench.serving import Serving

    torch.cuda.empty_cache()
    sv = None
    try:
        sv = Serving(wl, cfg, seed, "cuda", streams=B)
        sv.frozen_ticks(3)
        times = []
        for k in range(ticks + 5):
            sv.audio.fill(k, sv.frames[k % 3])
            t = time.perf_counter()
            host, ev = sv.dispatch(k)
            ev.synchronize()
            times.append(time.perf_counter() - t)
        times = times[5:]
        mem = torch.cuda.max_memory_allocated()
    except torch.cuda.OutOfMemoryError as e:
        return {"B": B, "oom": str(e)[:200]}
    finally:
        if sv is not None:
            sv.free()
        sv = None
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return {"B": B, "p50_ms": 1e3 * nearest_rank(times, 0.5),
            "p95_ms": 1e3 * nearest_rank(times, 0.95),
            "max_ms": 1e3 * max(times), "mean_ms": 1e3 * float(np.mean(times)),
            "memory_peak_bytes": int(mem)}


def main(argv=None) -> dict:
    setup_env()
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--start", type=int, default=8192)
    ap.add_argument("--coarse", type=int, default=4096)
    ap.add_argument("--stop", type=int, default=131072)
    ap.add_argument("--ticks", type=int, default=60)
    ap.add_argument("--seed", type=int, default=20261017)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    wl = load_workload(args.workload)
    cfg = load_config(wl["config"])
    period_ms = 1e3 / cfg["model"]["frame_hz"]
    log("card:", gpu_line())
    rows = []

    def ok(r):
        return "oom" not in r and r["p95_ms"] < period_ms

    B, last_ok, first_bad = args.start, None, None
    while B <= args.stop:
        r = measure(wl, cfg, B, args.ticks, args.seed)
        rows.append(r)
        print(json.dumps(r), flush=True)
        if not ok(r):
            first_bad = B
            break
        last_ok = B
        B += args.coarse
    if last_ok is not None and first_bad is not None:
        for B in range(last_ok + 1024, first_bad, 1024):
            r = measure(wl, cfg, B, args.ticks, args.seed)
            rows.append(r)
            print(json.dumps(r), flush=True)
            if not ok(r):
                break
            last_ok = B
    res = {"workload": args.workload, "period_ms": period_ms,
           "knee": last_ok, "card": gpu_line(), "rows": rows}
    if last_ok is not None:
        res["open_streams"] = int(0.8 * last_ok) // 1024 * 1024
    print(json.dumps({k: v for k, v in res.items() if k != "rows"}),
          flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
